"""Cross-validation: JAX kernels vs the independent native C++ MC solver.

This is the framework's equivalent of the reference's MCARaTS-vs-libRadtran
benchmark (examples/00_er3t_bmk.py): two solvers implemented independently
must agree within Monte Carlo noise on fluxes and radiances.
"""

import numpy as np
import pytest

from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.cld import cld_gen_hom
from er3t_tpu.rtm.scene import build_scene
from er3t_tpu.rtm.mc import SolverConfig, run_transport
from er3t_tpu.rtm.mc_flight import run_transport_flight
from er3t_tpu.native import mc_ref_run


@pytest.fixture(scope='module')
def scene():
    atm = atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_synthetic(650.0, atm)
    cld = cld_gen_hom(nx=4, ny=4, nz=2, dx=1.0, dy=1.0, cot0=6.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    cld.extinction[2:] = 0.0   # half cloudy, half clear
    cld.cer[2:] = 0.0
    scn, st = build_scene(atm, ab, cld=cld, surface=0.15,
                          solar_zenith_angle=30.0)
    return ab, scn, st


def test_native_builds():
    from er3t_tpu.native import ensure_built
    assert ensure_built().endswith('.so')


def test_flux_cross_validation(scene):
    ab, scn, st = scene
    n = 60000
    cfg = SolverConfig(target='flux', batch=1 << 12, flux_per_column=False)
    t = run_transport(scn, st, cfg, n, seed=21)
    flux_jax = np.asarray(t.flux)[0, 0] / int(t.n_launched)
    _, flux_nat, n_nat = mc_ref_run(scn, st, albedo=0.15, sza_deg=30.0,
                                    saa_deg=0.0, n_photon=n, seed=77,
                                    do_radiance=False)
    flux_nat /= n_nat
    w = ab.weight
    for ch, name in [(0, 'down-direct'), (2, 'up')]:
        a = flux_jax[:, ch, :] @ w
        b = flux_nat[:, ch, :] @ w
        sel = a > 1e-3
        np.testing.assert_allclose(a[sel], b[sel], rtol=0.05,
                                   err_msg=f'{name} mismatch')
    # down-diffuse at surface
    a = flux_jax[0, 1, :] @ w
    b = flux_nat[0, 1, :] @ w
    assert a == pytest.approx(b, rel=0.08)


def test_radiance_cross_validation(scene):
    ab, scn, st = scene
    n = 80000
    cfg = SolverConfig(target='radiance', batch=1 << 12)
    t = run_transport_flight(scn, st, cfg, n, seed=31)
    rad_jax = (np.asarray(t.rad) @ ab.weight) / int(t.n_launched)
    rad_nat, _, n_nat = mc_ref_run(scn, st, albedo=0.15, sza_deg=30.0,
                                   saa_deg=0.0, n_photon=n, seed=99)
    rad_nat = (rad_nat @ ab.weight) / n_nat
    # domain means and cloudy/clear halves agree within MC noise
    assert rad_jax.mean() == pytest.approx(rad_nat.mean(), rel=0.04)
    assert rad_jax[:2].mean() == pytest.approx(rad_nat[:2].mean(), rel=0.06)
    assert rad_jax[2:].mean() == pytest.approx(rad_nat[2:].mean(), rel=0.06)


@pytest.mark.slow
def test_radiance_cross_validation_production(scene_production):
    """Slow-tier anchor at ~2.5-3% tolerance with the PRODUCTION kernel
    knobs (VERDICT r4 item 6): 16x16 Mie scene, 20-deg delta truncation
    with TMS, per-tile majorants — against the independent C++ solver
    running the same truncated tables with the same TMS first-order
    estimator (native/mc_ref.cpp phase_eval).  Accuracy-affecting kernel
    optimizations (truncation depth, table resolution, majorant clamping)
    are gated here at a tolerance that can actually see ~3% bias.
    Reference protocol:
    examples/00_er3t_bmk.py:470-579."""
    ab, scn, st = scene_production
    n_jax, n_nat = 1_200_000, 2_400_000
    cfg = SolverConfig(target='radiance', batch=1 << 13, tile_size=16,
                       qmc_launch=True, n_scat_max=600)
    t = run_transport_flight(scn, st, cfg, n_jax, seed=61)
    rad_jax = (np.asarray(t.rad) @ ab.weight) / int(t.n_launched)
    rad_nat, _, n_n = mc_ref_run(scn, st, albedo=0.15, sza_deg=30.0,
                                 saa_deg=45.0, n_photon=n_nat, seed=88)
    rad_nat = (rad_nat @ ab.weight) / n_n
    cloudy = rad_jax > np.median(rad_jax)      # same mask for both halves
    assert rad_jax.mean() == pytest.approx(rad_nat.mean(), rel=0.025)
    assert rad_jax[cloudy].mean() == pytest.approx(rad_nat[cloudy].mean(),
                                                   rel=0.03)
    assert rad_jax[~cloudy].mean() == pytest.approx(rad_nat[~cloudy].mean(),
                                                    rel=0.03)


@pytest.fixture(scope='module')
def scene_production():
    """Bigger cross-check scene at the production configuration: Mie phase
    (650 nm), 20-deg truncation + TMS, broken cloud over 16x16 columns."""
    from er3t_tpu.pre.pha import pha_mie_wc
    atm = atm_atmmod(np.concatenate([np.arange(0, 5.0, 0.5),
                                     np.arange(5.0, 20.1, 1.0)]))
    ab = abs_synthetic(650.0, atm)
    cld = cld_gen_hom(nx=16, ny=16, nz=4, dx=0.5, dy=0.5, cot0=10.0,
                      cer0=10.0, cloud_base=1.0, cloud_top=3.0)
    # broken field: clear out a diagonal half for cloudy/clear contrast
    ii, jj = np.meshgrid(np.arange(16), np.arange(16), indexing='ij')
    clear = ii + jj >= 16
    cld.extinction[clear] = 0.0
    cld.cer[clear] = 0.0
    pha = pha_mie_wc(650.0)
    scn, st = build_scene(atm, ab, cld=cld, pha=pha, surface=0.15,
                          solar_zenith_angle=30.0, solar_azimuth_angle=45.0,
                          forward_trunc_deg=20.0)
    return ab, scn, st


def test_per_g_spectral_agreement(scene):
    """Per-g-point fluxes (not just the weighted sum) must agree."""
    ab, scn, st = scene
    n = 60000
    cfg = SolverConfig(target='flux', batch=1 << 12, flux_per_column=False)
    t = run_transport(scn, st, cfg, n, seed=41)
    f_jax = np.asarray(t.flux)[0, 0, 0, 0, :] / int(t.n_launched)  # sfc direct
    _, flux_nat, n_nat = mc_ref_run(scn, st, albedo=0.15, sza_deg=30.0,
                                    saa_deg=0.0, n_photon=n, seed=55,
                                    do_radiance=False)
    f_nat = flux_nat[0, 0, :] / n_nat
    np.testing.assert_allclose(f_jax, f_nat, rtol=0.05)
