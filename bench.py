"""Benchmark: LES-like 480x480 Mie nadir-radiance scene, photons/sec/chip.

Twin of the reference's headline workload (examples/00_er3t_mca.py
example_05: 480x480 LES scene, 650 nm nadir radiance, Mie phase, 16 g-points;
45 s for 3e8 single-g photons on 24 CPUs => 6.7e6 photons/s — BASELINE.md).
The LES netCDF is not redistributable, so an equivalent broken-cloud field
(480x480, 25% cover, COT<=30, reff 10 um) is generated in-framework.

Metrics (the reference's accuracy band is Nrun-repeat per-pixel std,
mcarats.py:134 / mca_out.py:394-397):

* raw physical photons/s per chip (median over timed chunks);
* g-samples/s (each photon carries all 16 correlated g-point weights —
  the reference launches one photon per g);
* the measured correlated-vs-independent noise discount: per-photon pixel
  variance of the spectrally-integrated radiance under the correlated
  protocol vs the reference's independent per-g protocol, at matched
  budgets;
* noise-matched photons/s = photons/s x (var_indep / var_corr): the photon
  rate an independent-protocol solver would need to reach the same
  per-pixel std in the same wall time — the honest number against the
  6.7e6 ph/s baseline.

Runs on the GPU only (exits non-zero on any other backend); a failing chunk
fails the run.  Prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline", ...extras, "device"}.
"""

import json
import sys
import time

import numpy as np


BASELINE_PHOTONS_PER_S = 6.7e6  # reference, 24 CPUs (BASELINE.md)


def inputs():
    """(atm, abs_coef, cld, pha) of the example_05 twin scene."""
    from er3t_tpu.pre.atm import atm_atmmod
    from er3t_tpu.pre.abs import abs_synthetic
    from er3t_tpu.pre.cld import cld_gen_hem
    from er3t_tpu.pre.pha import pha_mie_wc

    levels = np.concatenate([np.arange(0, 3.0, 0.5), np.arange(3.0, 20.1, 1.0)])
    atm = atm_atmmod(levels)
    ab = abs_synthetic(650.0, atm)
    cld = cld_gen_hem(nx=480, ny=480, nz=4, dx=0.1, dy=0.1, dz=0.5,
                      cloud_frac_tgt=0.25, radii=(0.5, 1.0, 2.0),
                      cot_scale=15.0, cloud_base=0.5, seed=7)
    return atm, ab, cld, pha_mie_wc(650.0)


def build():
    from er3t_tpu.rtm.scene import build_scene

    atm, ab, cld, pha = inputs()
    # 25 deg forward truncation with TMS (first-order exact).  MCARaTS's own
    # default is 20 deg (Sca_qtfmax); t25 shifts the domain mean by -0.32%
    # against t20 (seed sd of the mean ~0.08%) — disclosed, well inside the
    # reference's own Nrun noise protocol (~1% per-pixel) and the 2.5%
    # cross-solver anchor.  t30/t35 were rejected (-0.9%/-1.3% shifts).
    scene, st = build_scene(atm, ab, cld=cld, pha=pha, surface=0.03,
                            solar_zenith_angle=30.0, solar_azimuth_angle=45.0,
                            forward_trunc_deg=25.0)
    return ab, scene, st


def _pixel_var_per_photon(images, n_per_run):
    """Mean-over-pixels per-photon variance from repeat images.

    var(run mean) = var_per_photon / N  =>  var_per_photon = N * var(runs).
    Cloudy pixels dominate; use the pixel-mean variance (the reference's
    std fields are per-pixel, mca_out.py:394-397).
    """
    imgs = np.stack(images)                    # (K, nx, ny)
    v = imgs.var(axis=0, ddof=1)               # per-pixel var of run means
    return float(v.mean()) * n_per_run


def main():
    import jax
    from er3t_tpu.common import setup_compile_cache
    setup_compile_cache()
    if jax.default_backend() != 'gpu':
        print(f'bench.py measures the GPU; JAX found {jax.default_backend()!r}',
              file=sys.stderr)
        sys.exit(1)
    from er3t_tpu.rtm.mc import SolverConfig
    from er3t_tpu.rtm.mc_flight import run_transport_flight
    from er3t_tpu.rtm.out import spectral_factors

    ab, scene, st = build()
    # production config: per-tile majorants + 25-deg truncation (TMS, set
    # in build() above) + in-kernel spectral contraction of image deposits
    # (rad_w) + stratified-jitter launch (qmc_launch: unbiased, -2% pixel
    # variance on this scene); n_scat_max=600 bounds pathological walks
    # (negligible energy there).  Every other variance knob measured on
    # this scene was a net loss (pfpeak30 no-op under truncation,
    # cf_dtau=0.5 net -3%, split_wmax/rr_value large losses).
    cfg = SolverConfig(target='radiance', batch=1 << 17, n_scat_max=600,
                       tile_size=16, qmc_launch=True)
    # reference-protocol config for the independent-sampling noise phase:
    # the same kernel minus the framework-only variance knob (MCARaTS
    # launches uniformly), mirroring the baseline estimator
    cfg_ref = SolverConfig(target='radiance', batch=1 << 17, n_scat_max=600,
                           tile_size=16)
    factors, _ = spectral_factors(ab, nz_out=1)
    rad_w = factors[0]

    def run(n, seed, c=None):
        tal = run_transport_flight(scene, st, c or cfg, n, seed=seed,
                                   rad_w=rad_w)
        img = np.asarray(tal.rad)[:, :, 0]     # forces completion
        return img, int(tal.n_launched)

    # ---------------- phase 0: warm-up (compile) ----------------
    t0 = time.time()
    run(100_000, seed=0)
    compile_s = time.time() - t0

    # ---------------- phase 1: throughput ----------------
    chunk = 8_000_000
    target_seconds = 110.0
    chunk_rates = []
    t_used, i = 0.0, 0
    while (t_used < target_seconds or len(chunk_rates) < 3) and i < 32:
        t0 = time.time()
        _, n_l = run(chunk, seed=2 + i)
        dt = time.time() - t0
        chunk_rates.append(n_l / dt)
        t_used += dt
        i += 1
        if dt < 25.0 and chunk < 32_000_000:
            chunk *= 2
        elif dt > 90.0 and chunk > 4_000_000:
            chunk //= 2
    photons_per_s = float(np.median(chunk_rates))
    g_samples_per_s = photons_per_s * ab.ng

    # ---------------- phase 2: noise protocol ----------------
    # per-pixel std from Nrun repeats (the reference's protocol) under the
    # correlated spectral sampling, and under the reference's independent
    # per-g protocol at the same photon budget.  The variance ratio is
    # estimated from 8 repeats per protocol (a 2-sample variance has
    # chi^2_1 spread).  Independent-protocol repeats use 2M photons each
    # (variance per photon is budget-independent).
    n_noise = 4_000_000
    imgs_c = []
    for k in range(8):
        img, n_l = run(n_noise, seed=101 + k)
        imgs_c.append(img / max(n_l, 1))
    var_c = _pixel_var_per_photon(imgs_c, n_noise)

    import dataclasses as _dc
    from er3t_tpu.rtm.solver import distribute_photon
    n_ind = 2_000_000
    dist = distribute_photon(n_ind, ab.weight)
    imgs_i = []
    for k in range(8):
        acc = np.zeros((st.nx, st.ny))
        for g in range(ab.ng):
            scene_g = scene._replace(kabs=scene.kabs[:, g:g + 1])
            st_g = _dc.replace(st, ng=1)
            tg = run_transport_flight(scene_g, st_g, cfg_ref, int(dist[g]),
                                      seed=301 + 16 * k + g)
            acc += (np.asarray(tg.rad)[:, :, 0]
                    / max(int(tg.n_launched), 1)) * factors[0][g]
        imgs_i.append(acc)
    var_i = _pixel_var_per_photon(imgs_i, n_ind)

    noise_ratio = var_i / var_c
    noise_matched = photons_per_s * noise_ratio
    dev = jax.devices()[0]
    print(json.dumps({
        'metric': 'noise_matched_photons_per_sec_per_chip',
        'value': round(noise_matched, 1),
        'unit': '1/s',
        'vs_baseline': round(noise_matched / BASELINE_PHOTONS_PER_S, 3),
        'photons_per_sec': round(photons_per_s, 1),
        'g_samples_per_sec': round(g_samples_per_s, 1),
        'chunk_rates': [round(r, 1) for r in chunk_rates],
        'best': round(max(chunk_rates), 1),
        'compile_s': round(compile_s, 1),
        'noise_var_ratio_indep_over_corr': round(noise_ratio, 3),
        'pixel_std_at_budget': round(float(np.sqrt(var_c / 4e6)), 8),
        'device': {'platform': dev.platform, 'kind': dev.device_kind,
                   'count': len(jax.devices())},
    }))


if __name__ == '__main__':
    main()
