"""Delta-truncation + TMS correction consistency.

The reference solver's counterpart is MCARaTS's phase-function truncation
(Sca_nchi/qtfmax, /root/reference/er3t/rtm/mca/mca_inp.py:52-54), which it
applies by default at 20 deg.  Here truncation is delta-scaled into the
scene (similarity relations) and first-order local estimates use the TMS
rows (Nakajima & Tanaka 1988) so single scattering stays exact.
"""

import numpy as np
import pytest

from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.cld import cld_gen_hem
from er3t_tpu.pre.pha import pha_mie_wc, build_phase_table
from er3t_tpu.rtm.scene import build_scene
from er3t_tpu.rtm.mc import SolverConfig
from er3t_tpu.rtm.mc_flight import run_transport_flight


@pytest.fixture(scope='module')
def mie():
    return pha_mie_wc(650.0)


def test_table_normalizations(mie):
    """Working rows integrate to 2; TMS rows to 2/(1-f); f grows with the
    truncation angle."""
    t20 = build_phase_table(mie, forward_trunc_deg=20.0)
    t5 = build_phase_table(mie, forward_trunc_deg=5.0)
    mu = np.linspace(-1.0, 1.0, t20.p_eval.shape[1])
    i = 10  # a mid-reff row
    assert t20.trunc_f[i] > t5.trunc_f[i] > 0.2
    np.testing.assert_allclose(np.trapezoid(t20.p_eval[i], mu), 2.0, rtol=2e-3)
    np.testing.assert_allclose(np.trapezoid(t20.p_tms[i], mu),
                               2.0 / (1.0 - t20.trunc_f[i]), rtol=2e-2)
    # TMS row equals the working row where f = 0 (Rayleigh slot)
    np.testing.assert_allclose(t20.p_tms[0], t20.p_eval[0])


def test_eval_rows_bin_averaged(mie):
    """The eval grid must not return the diffraction-peak maximum for every
    near-forward angle: the last bin holds the bin average, well below the
    point value at mu=1."""
    t = build_phase_table(mie)
    ang = np.asarray(mie.data['ang'])
    p_src = np.asarray(mie.data['pha'])[:, 10]
    peak_point = p_src[np.argmin(ang)]
    assert t.p_eval[11, -1] < 0.7 * peak_point


@pytest.mark.slow
def test_truncated_radiance_matches_mild_truncation(mie):
    """20-deg truncation + TMS agrees with 5-deg truncation within MC noise
    on a broken-cloud Mie radiance scene (both are low-variance estimators;
    the untruncated estimator is heavy-tailed)."""
    atm = atm_atmmod(np.concatenate([np.arange(0, 3.0, 0.5),
                                     np.arange(3.0, 20.1, 2.0)]))
    ab = abs_synthetic(650.0, atm)
    cld = cld_gen_hem(nx=48, ny=48, nz=4, dx=0.1, dy=0.1, dz=0.5,
                      cloud_frac_tgt=0.25, radii=(0.5, 1.0), cot_scale=15.0,
                      cloud_base=0.5, seed=7)
    means = {}
    for td in (5.0, 20.0):
        scene, st = build_scene(atm, ab, cld=cld, pha=mie, surface=0.03,
                                solar_zenith_angle=30.0,
                                solar_azimuth_angle=45.0,
                                forward_trunc_deg=td)
        cfg = SolverConfig(target='radiance', batch=1 << 14, n_scat_max=500,
                           tile_size=16)
        t = run_transport_flight(scene, st, cfg, 250_000, seed=9,
                                 rng_impl='threefry2x32')
        means[td] = float(((np.asarray(t.rad) @ ab.weight)
                           / int(t.n_launched)).mean())
    assert means[20.0] == pytest.approx(means[5.0], rel=0.03)


def test_pfpeak_clamps_and_renormalizes(mie):
    """pfpeak (MCARaTS Pho_pfpeak) clamps the WORKING eval rows at the peak
    (plus the tiny uniform redistribution) and keeps them normalized; TMS
    rows and sampling rows are untouched."""
    atm = atm_atmmod(np.concatenate([np.arange(0, 3.0, 0.5),
                                     np.arange(3.0, 20.1, 2.0)]))
    ab = abs_synthetic(650.0, atm)
    cld = cld_gen_hem(nx=8, ny=8, nz=2, dx=0.5, dy=0.5, dz=0.5,
                      cloud_frac_tgt=0.4, radii=(0.5,), cot_scale=10.0,
                      cloud_base=0.5, seed=3)
    kw = dict(cld=cld, pha=mie, surface=0.03, solar_zenith_angle=30.0)
    s0, st0 = build_scene(atm, ab, **kw)                 # untruncated: peaky
    sc, stc = build_scene(atm, ab, pfpeak=30.0, **kw)
    n_pf = np.asarray(sc.pt_mu).shape[0]
    p0 = np.asarray(s0.pt_p)
    pc = np.asarray(sc.pt_p)
    # untruncated Mie working rows carry a >> 30 diffraction peak
    assert p0[1:n_pf].max() > 300.0
    resid = pc[1:n_pf].min(axis=1)                       # uniform floor >= add-back
    assert pc[1:n_pf].max() <= 30.0 + resid.max() + 1e-3
    mu = np.linspace(-1.0, 1.0, pc.shape[1])
    norms = np.trapezoid(pc[1:n_pf], mu, axis=1)
    np.testing.assert_allclose(norms, 2.0, rtol=5e-3)
    # TMS half (first-order estimates) and sampling rows are exact/unchanged
    np.testing.assert_allclose(pc[n_pf:], p0[n_pf:])
    np.testing.assert_allclose(np.asarray(sc.pt_mu), np.asarray(s0.pt_mu))


@pytest.mark.slow
def test_pfpeak_small_bias(mie):
    """The pfpeak truncation-approximation moves only the clipped peak
    energy: radiance means with/without the clamp agree within MC noise on
    the truncated production table (where the clamp removes almost
    nothing), and within a few percent on the untruncated table."""
    atm = atm_atmmod(np.concatenate([np.arange(0, 3.0, 0.5),
                                     np.arange(3.0, 20.1, 2.0)]))
    ab = abs_synthetic(650.0, atm)
    cld = cld_gen_hem(nx=48, ny=48, nz=4, dx=0.1, dy=0.1, dz=0.5,
                      cloud_frac_tgt=0.25, radii=(0.5, 1.0), cot_scale=15.0,
                      cloud_base=0.5, seed=7)
    cfg = SolverConfig(target='radiance', batch=1 << 14, n_scat_max=500,
                       tile_size=16)
    means = {}
    for pk in (None, 30.0):
        scene, st = build_scene(atm, ab, cld=cld, pha=mie, surface=0.03,
                                solar_zenith_angle=30.0,
                                solar_azimuth_angle=45.0,
                                forward_trunc_deg=20.0, pfpeak=pk)
        t = run_transport_flight(scene, st, cfg, 250_000, seed=11,
                                 rng_impl='threefry2x32')
        means[pk] = float(((np.asarray(t.rad) @ ab.weight)
                           / int(t.n_launched)).mean())
    assert means[30.0] == pytest.approx(means[None], rel=0.02)
