"""On-chip smoke test: ``solve()`` end to end on the GPU at full size.

Runs the two production targets through the user entry point
(:func:`er3t_tpu.rtm.solver.solve`) on the example_05 twin scene of
``bench.py`` (480x480 broken cloud, 16 correlated g-points) and checks them
against the independent C++ Monte Carlo solver (``native/mc_ref.cpp``, run
on the host in the same process):

* (R) nadir radiance, Mie phase, 25-deg truncation + TMS, SZA 30 / SAA 45,
  per-tile majorants, stratified launch, in-kernel spectral contraction:
  domain, cloudy-column and clear-column means of the radiance;
* (F) per-column 3D flux (the example_02 twin): the deterministic TOA
  down-direct flux (exactly one crossing per launched photon) and the
  domain-mean down-direct and up flux profiles.

Usage::

    python chip_smoke.py           # (R) and (F) on one GPU
    python chip_smoke.py --four    # (R) over four GPUs, photon-parallel and
                                   # x-slab decomposed, vs one GPU; (F) TOA
                                   # exactness through the decomposition

Prints the card's name and power limit, compile seconds and photons/s of
each phase, and every comparison beside its tolerance; the last line is one
JSON object ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
such line, when JAX finds no GPU or any check fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np

# (R) vs the C++ solver, relative: the tolerances tests/test_cross_native.py
# gives the same physics (domain mean 2.5%, each half 3%)
R_TOL = {'domain': 0.025, 'cloudy': 0.03, 'clear': 0.03}
# (F) vs the C++ solver, relative (tests/test_cross_native.py flux test):
# level profiles where the flux exceeds 1e-3 of the TOA input, surface
# down-diffuse
F_TOL = {'down-direct': 0.05, 'up': 0.05, 'sfc down-diffuse': 0.08}
# deterministic TOA down-direct flux: f32 rounding only
TOA_TOL = 1e-5
# run-to-run standard error of the (R) domain mean, relative
NOISE_MAX = 0.005
# several GPUs vs one, relative: ~5x the expected MC noise of the difference
FOUR_TOL = {'domain': 0.015, 'cloudy': 0.03, 'clear': 0.03}
# photons per run of each solve() and of each C++ reference run: the (R)
# domain mean then carries ~0.2% MC noise per solver
PHOTONS = {'R': 8_000_000, 'R ref': 8_000_000, 'F': 4_000_000,
           'F ref': 4_000_000, 'warm-up': 100_000}

R_KW = dict(target='radiance', surface=0.03, solar_zenith_angle=30.0,
            solar_azimuth_angle=45.0, forward_trunc_deg=25.0, tile_size=16,
            qmc_launch=True, n_scat_max=600)
F_KW = dict(target='flux', surface=0.03, solar_zenith_angle=30.0,
            tile_size=16)


def require_gpu():
    """Stop unless JAX's default backend is the GPU (never run on the CPU)."""
    import jax
    backend = jax.default_backend()
    if backend != 'gpu':
        raise SystemExit(f'chip_smoke: needs a GPU; JAX backend is '
                         f'{backend!r}')
    return jax.devices()


def card_info() -> str:
    """``name, power.limit`` of every visible card, as nvidia-smi reports."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def rel(a, b) -> float:
    return float(abs(a - b) / abs(b))


def cloudy_columns(cld) -> np.ndarray:
    """(nx, ny) mask of columns holding any cloud — fixed by the scene, so
    it selects the same pixels in both solvers independently of noise."""
    return np.asarray(cld.extinction).sum(axis=-1) > 0


def radiance_checks(rad, rad_ref, cloudy, tol=R_TOL):
    """[(name, relative difference, tolerance)] of the domain, cloudy and
    clear means of two (nx, ny) radiance images."""
    masks = {'domain': np.ones_like(cloudy), 'cloudy': cloudy,
             'clear': ~cloudy}
    return [(k, rel(rad[m].mean(), rad_ref[m].mean()), tol[k])
            for k, m in masks.items()]


def flux_checks(prof, prof_ref, toa_in, tol=F_TOL):
    """[(name, relative difference, tolerance)] of domain-mean flux
    profiles (dicts of (nlev,) arrays): worst level of the down-direct and
    up profiles where the reference exceeds 1e-3 of ``toa_in``, and the
    surface down-diffuse flux."""
    out = []
    for name, key in (('down-direct', 'f_down_direct'), ('up', 'f_up')):
        a, b = np.asarray(prof[key]), np.asarray(prof_ref[key])
        sel = b > 1e-3 * toa_in
        out.append((name, float(np.max(np.abs(a[sel] - b[sel]) / b[sel])),
                    tol[name]))
    out.append(('sfc down-diffuse', rel(prof['f_down_diffuse'][0],
                                        prof_ref['f_down_diffuse'][0]),
                tol['sfc down-diffuse']))
    return out


def toa_direct_error(f_down_direct, mu0, toa) -> float:
    """Worst relative deviation of the TOA down-direct flux of every column
    from the solar input mu0 * toa."""
    top = np.asarray(f_down_direct)[..., -1]
    return float(np.max(np.abs(top / (mu0 * toa) - 1.0)))


def domain_profiles(res) -> dict:
    """Domain-mean (nlev,) flux profiles of a per-column flux Result."""
    return {k: np.asarray(res[k]).reshape(-1, np.shape(res[k])[-1]).mean(0)
            for k in ('f_down_direct', 'f_down_diffuse', 'f_up')}


def reference_radiance(scene, st, ab, kw, n_photon, seed):
    """The C++ solver's physical radiance image for a scene."""
    from er3t_tpu.native import mc_ref_run
    from er3t_tpu.rtm.out import reduce_radiance
    rad, _, n = mc_ref_run(scene, st, albedo=kw['surface'],
                           sza_deg=kw['solar_zenith_angle'],
                           saa_deg=kw.get('solar_azimuth_angle', 0.0),
                           n_photon=n_photon, seed=seed)
    mu0 = np.cos(np.deg2rad(kw['solar_zenith_angle']))
    return reduce_radiance(rad, n, ab, mu0)['rad']


def reference_flux(scene, st, ab, kw, n_photon, seed):
    """The C++ solver's physical domain-mean flux profiles for a scene."""
    from er3t_tpu.native import mc_ref_run
    from er3t_tpu.rtm.out import reduce_flux
    _, flux, n = mc_ref_run(scene, st, albedo=kw['surface'],
                            sza_deg=kw['solar_zenith_angle'],
                            saa_deg=kw.get('solar_azimuth_angle', 0.0),
                            n_photon=n_photon, seed=seed, do_radiance=False)
    mu0 = np.cos(np.deg2rad(kw['solar_zenith_angle']))
    red = reduce_flux(flux[None, None], n, ab, mu0)
    return {k: red[k][0, 0] for k in ('f_down_direct', 'f_down_diffuse',
                                      'f_up')}


def scene_for(atm, ab, cld, pha, kw):
    """The (SceneArrays, SceneStatic) pair solve() builds for ``kw``."""
    from er3t_tpu.rtm.scene import build_scene
    return build_scene(atm, ab, cld=cld, pha=pha, surface=kw['surface'],
                       solar_zenith_angle=kw['solar_zenith_angle'],
                       solar_azimuth_angle=kw.get('solar_azimuth_angle', 0.0),
                       forward_trunc_deg=kw.get('forward_trunc_deg'))


def run_solve(atm, ab, cld, pha, kw, photons, n_run, seed, mesh=None):
    """solve() with a photon-deficit check; returns (Result, seconds)."""
    from er3t_tpu.rtm.solver import solve
    t0 = time.time()
    res = solve(atm=atm, abs_coef=ab, cld=cld, pha=pha, photons=photons,
                n_run=n_run, seed=seed, mesh=mesh, mode='all', **kw)
    dt = time.time() - t0
    if res.n_photon_effective < int(photons) * n_run:
        raise RuntimeError(
            f'photon deficit: {res.n_photon_effective:g} launched of '
            f'{int(photons) * n_run:g}')
    return res, dt


class Report:
    """Collects (phase, check, value, tolerance) lines and prints each."""

    def __init__(self):
        self.failed = []

    def check(self, phase, name, value, tol):
        ok = bool(np.isfinite(value) and value <= tol)
        print(f'check {phase} {name}: {value:.6g} (tolerance {tol:g}) '
              f'{"ok" if ok else "FAIL"}', flush=True)
        if not ok:
            self.failed.append(f'{phase} {name}')

    def require(self, phase, name, ok):
        print(f'check {phase} {name}: {"ok" if ok else "FAIL"}', flush=True)
        if not ok:
            self.failed.append(f'{phase} {name}')

    def timing(self, phase, photons, seconds, compile_s=None):
        c = '' if compile_s is None else f'compile {compile_s:.1f} s, '
        print(f'{phase}: {c}{photons:.4g} photons in {seconds:.2f} s = '
              f'{photons / seconds:.4g} photons/s', flush=True)


def run_one_card(rep, inputs):
    atm, ab, cld, pha = inputs
    cloudy = cloudy_columns(cld)
    mu0 = np.cos(np.deg2rad(30.0))

    # ---- (R) radiance ----
    n_r, runs_r = PHOTONS['R'], 3
    _, c_s = run_solve(atm, ab, cld, pha, R_KW, PHOTONS['warm-up'], 1,
                       seed=1)
    res, dt = run_solve(atm, ab, cld, pha, R_KW, n_r, runs_r, seed=11)
    rep.timing('R', n_r * runs_r, dt, c_s)
    rad = np.asarray(res['rad'])
    rep.require('R', 'image shape and finite values',
                rad.shape == cloudy.shape and bool(np.all(np.isfinite(rad))))
    means = [np.asarray(r['rad']).mean() for r in res.runs]
    rep.check('R', 'MC noise of the domain mean',
              np.std(means, ddof=1) / np.sqrt(runs_r) / rad.mean(),
              NOISE_MAX)
    scene, st = scene_for(atm, ab, cld, pha, R_KW)
    t0 = time.time()
    rad_ref = reference_radiance(scene, st, ab, R_KW, PHOTONS['R ref'],
                                 seed=5)
    print(f'R reference: C++ solver {time.time() - t0:.1f} s', flush=True)
    for name, d, tol in radiance_checks(rad, rad_ref, cloudy):
        rep.check('R', f'{name} mean vs C++', d, tol)

    # ---- (F) per-column flux ----
    n_f, runs_f = PHOTONS['F'], 3
    _, c_s = run_solve(atm, ab, cld, None, F_KW, PHOTONS['warm-up'], 1,
                       seed=2)
    res, dt = run_solve(atm, ab, cld, None, F_KW, n_f, runs_f, seed=13)
    rep.timing('F', n_f * runs_f, dt, c_s)
    rep.require('F', 'per-column shape and finite values',
                all(np.shape(res[k]) == cloudy.shape + (atm.nz + 1,)
                    and bool(np.all(np.isfinite(res[k])))
                    for k in ('f_down_direct', 'f_down_diffuse', 'f_up')))
    rep.check('F', 'TOA down-direct vs mu0*toa',
              toa_direct_error(res['f_down_direct'], mu0, res.toa), TOA_TOL)
    scene, st = scene_for(atm, ab, cld, None, F_KW)
    t0 = time.time()
    prof_ref = reference_flux(scene, st, ab, F_KW, PHOTONS['F ref'], seed=7)
    print(f'F reference: C++ solver {time.time() - t0:.1f} s', flush=True)
    for name, d, tol in flux_checks(domain_profiles(res), prof_ref,
                                    mu0 * res.toa):
        rep.check('F', f'{name} vs C++', d, tol)


def run_four_cards(rep, inputs):
    from er3t_tpu.dist.mesh import make_mesh
    atm, ab, cld, pha = inputs
    cloudy = cloudy_columns(cld)
    mu0 = np.cos(np.deg2rad(30.0))
    n_r, runs = PHOTONS['R'], 2

    def timed(tag, kw, pha_, photons, n_run, seed, mesh=None):
        _, c_s = run_solve(atm, ab, cld, pha_, kw, PHOTONS['warm-up'], 1,
                           seed=seed + 1, mesh=mesh)
        res, dt = run_solve(atm, ab, cld, pha_, kw, photons, n_run, seed,
                            mesh=mesh)
        rep.timing(tag, photons * n_run, dt, c_s)
        return res

    one = timed('R one card', R_KW, pha, n_r, runs, 11)
    for decomp, tag in ((1, 'photon-parallel'), (4, 'x-slab decomposition')):
        mesh = make_mesh(4, decomp=decomp)
        ids = [d.id for d in mesh.devices[:, 0]]
        print(f'{tag}: mesh {dict(mesh.shape)}, x slabs on devices {ids}',
              flush=True)
        if decomp > 1 and len(set(ids)) != decomp:
            rep.failed.append(f'{tag} slab placement')
        res = timed(f'R {tag}', R_KW, pha, n_r, runs, 21, mesh)
        for name, d, tol in radiance_checks(np.asarray(res['rad']),
                                            np.asarray(one['rad']), cloudy,
                                            FOUR_TOL):
            rep.check(f'R {tag}', f'{name} mean vs one card', d, tol)
    res = timed('F x-slab decomposition', F_KW, None, PHOTONS['F'], 1, 13,
                make_mesh(4, decomp=4))
    rep.check('F x-slab decomposition', 'TOA down-direct vs mu0*toa',
              toa_direct_error(res['f_down_direct'], mu0, res.toa), TOA_TOL)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--four', action='store_true',
                    help='run (R) over four GPUs (photon-parallel and x-slab '
                         'decomposition) against one GPU, and (F) TOA '
                         'exactness through the decomposition')
    args = ap.parse_args(argv)
    devices = require_gpu()
    n_cards = 4 if args.four else 1
    if len(devices) < n_cards:
        raise SystemExit(f'chip_smoke: needs {n_cards} GPUs, found '
                         f'{len(devices)}')
    from er3t_tpu.common import setup_compile_cache
    print(f'compile cache: {setup_compile_cache()}')
    print(f'card: {card_info()}', flush=True)

    import bench
    inputs = bench.inputs()
    rep = Report()
    if args.four:
        run_four_cards(rep, inputs)
    else:
        run_one_card(rep, inputs)
    if rep.failed:
        raise SystemExit(f'chip_smoke: failed: {", ".join(rep.failed)}')
    dev = devices[0]
    print(json.dumps({'ok': True, 'device': {
        'platform': dev.platform, 'kind': dev.device_kind,
        'count': len(devices)}}))


if __name__ == '__main__':
    main()
