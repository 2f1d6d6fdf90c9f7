"""Weak-scaling record: photons/s and algorithmic work vs device count.

Runs the bench-like broken-cloud radiance workload over 1/2/4/8 virtual CPU
devices for both distribution strategies:

* ``photon``  — replicated scene, sharded photon streams (dist/photon.py);
* ``decomp``  — x-slab domain decomposition with ppermute photon migration
  (dist/decomp.py).

Two efficiency numbers per point:

* wall-clock photons/s (weak scaling: photons = n_dev * base).  CAVEAT: this
  host has 2 physical cores, so wall-clock efficiency beyond 2 virtual
  devices measures core oversubscription, not the algorithm — it is reported
  for completeness only.
* algorithmic work/photon = (total kernel iterations summed over devices) *
  (lanes per device) / photons launched — since round 5 measured as true
  lane-iterations (Tallies.lane_iters; drain compaction shrinks the drain
  batch, so steps*batch would overcount).  On real chips wall time is
  steps * ms/step(B) with ms/step set by B, so the
  work/photon ratio n=1 vs n=N IS the hardware-independent weak-scaling
  efficiency: it captures migration rounds, frozen-lane idling and drain
  tails — everything but the interconnect transfer itself (not measured
  here).

Usage: python scripts/cpu_scaling_bench.py [--base-photons 150000]
Slab-width study (VERDICT r4 task 2 — production-width slabs):
    python scripts/cpu_scaling_bench.py --nx 768 --ny 48 \
        --strategies decomp --devices 1,2,4,8 --base-photons 40000
    => 768/384/192/96-column slabs at n=1/2/4/8.
"""

import argparse
import json
import os
import sys
import time

os.environ['JAX_PLATFORMS'] = 'cpu'
flags = os.environ.get('XLA_FLAGS', '')
if 'host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = flags + ' --xla_force_host_platform_device_count=8'

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_scene_mid(nx=96, ny=96, trunc=20.0):
    from er3t_tpu.pre.atm import atm_atmmod
    from er3t_tpu.pre.abs import abs_synthetic
    from er3t_tpu.pre.cld import cld_gen_hem
    from er3t_tpu.pre.pha import pha_mie_wc
    from er3t_tpu.rtm.scene import build_scene

    levels = np.concatenate([np.arange(0, 3.0, 0.5), np.arange(3.0, 20.1, 1.0)])
    atm = atm_atmmod(levels)
    ab = abs_synthetic(650.0, atm)
    cld = cld_gen_hem(nx=nx, ny=ny, nz=4, dx=0.1, dy=0.1, dz=0.5,
                      cloud_frac_tgt=0.25, radii=(0.5, 1.0, 2.0),
                      cot_scale=15.0, cloud_base=0.5, seed=7)
    pha = pha_mie_wc(650.0)
    scene, st = build_scene(atm, ab, cld=cld, pha=pha, surface=0.03,
                            solar_zenith_angle=30.0, solar_azimuth_angle=45.0,
                            forward_trunc_deg=trunc)
    return ab, scene, st


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--base-photons', type=int, default=150_000)
    ap.add_argument('--batch', type=int, default=1 << 12)
    ap.add_argument('--reps', type=int, default=2)
    ap.add_argument('--nx', type=int, default=96)
    ap.add_argument('--ny', type=int, default=96)
    ap.add_argument('--strategies', default='photon,decomp')
    ap.add_argument('--devices', default='1,2,4,8')
    args = ap.parse_args()

    import jax
    jax.config.update('jax_platforms', 'cpu')
    from er3t_tpu.dist.mesh import make_mesh
    from er3t_tpu.dist.photon import transport_photon_parallel
    from er3t_tpu.dist.decomp import transport_decomp
    from er3t_tpu.rtm.mc import SolverConfig
    from er3t_tpu.rtm.out import spectral_factors

    ab, scene, st = build_scene_mid(nx=args.nx, ny=args.ny)
    factors, _ = spectral_factors(ab, nz_out=1)
    rad_w = factors[0]
    cfg = SolverConfig(target='radiance', batch=args.batch, n_scat_max=600,
                       tile_size=8)

    results = {}
    for strat in args.strategies.split(','):
        rows = []
        for n in [int(v) for v in args.devices.split(',')]:
            mesh = make_mesh(n, decomp=(n if strat == 'decomp' else 1))
            n_ph = args.base_photons * n
            best_dt, tal = None, None
            for rep in range(args.reps + 1):      # rep 0 = compile
                t0 = time.time()
                if strat == 'photon':
                    tal = transport_photon_parallel(scene, st, cfg, n_ph,
                                                    mesh, seed=3 + rep,
                                                    rad_w=rad_w)
                else:
                    tal = transport_decomp(scene, st, cfg, n_ph, mesh,
                                           seed=3 + rep, rad_w=rad_w)
                n_l = int(tal.n_launched)
                _ = np.asarray(tal.rad)
                dt = time.time() - t0
                if rep > 0:
                    best_dt = dt if best_dt is None else min(best_dt, dt)
            steps_total = int(tal.n_steps)        # summed over devices
            # true lane-iteration work (drain compaction shrinks the
            # batch in the tail; steps*batch would overcount it)
            work = int(tal.lane_iters) / max(n_l, 1)
            rows.append({'n_dev': n, 'photons': n_ph, 'launched': n_l,
                         'wall_s': round(best_dt, 2),
                         'photons_per_s': round(n_l / best_dt, 1),
                         'steps_total': steps_total,
                         'slab_cols': st.nx // n if strat == 'decomp' else st.nx,
                         'work_per_photon': round(work, 2)})
            print(f'# {strat} n={n}: {n_l} ph in {best_dt:.1f}s '
                  f'({n_l / best_dt / 1e3:.1f}k ph/s), '
                  f'work/photon {work:.1f} lane-iters', flush=True)
        w0 = rows[0]['work_per_photon']
        r0 = rows[0]['photons_per_s']
        for r in rows:
            r['alg_efficiency'] = round(w0 / r['work_per_photon'], 3)
            r['wallclock_efficiency'] = round(
                r['photons_per_s'] / (r0 * r['n_dev']), 3)
        results[strat] = rows
    print(json.dumps(results, indent=1))


if __name__ == '__main__':
    main()
