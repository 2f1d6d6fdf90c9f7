"""chip_smoke.py: its device gate and its comparison helpers.

The on-chip phases themselves run only on the GPU (``python
chip_smoke.py``); here the helpers are checked on the CPU, on a tiny scene
through the same solve() and C++ reference calls.
"""

import numpy as np
import pytest

import chip_smoke


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu()
    assert e.value.code != 0 and 'GPU' in str(e.value.code)


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code != 0
    assert '"ok"' not in capsys.readouterr().out


def test_helpers_on_synthetic_values():
    rng = np.random.default_rng(0)
    rad = rng.uniform(1.0, 2.0, (6, 6))
    cloudy = np.zeros((6, 6), bool)
    cloudy[:3] = True
    scaled = rad.copy()
    scaled[cloudy] *= 1.1
    got = {k: (d, t) for k, d, t in chip_smoke.radiance_checks(scaled, rad,
                                                               cloudy)}
    assert got['cloudy'][0] == pytest.approx(0.1)
    assert got['clear'][0] == pytest.approx(0.0, abs=1e-12)
    assert 0.0 < got['domain'][0] < 0.1
    assert got['domain'][1] == chip_smoke.R_TOL['domain']
    top = np.full((3, 3, 5), 2.0)
    top[..., -1] = 0.5 * 3.0 * (1 + 2e-6)
    assert chip_smoke.toa_direct_error(top, 0.5, 3.0) == pytest.approx(
        2e-6, rel=1e-3)


def test_comparisons_on_tiny_scene():
    """(R) and (F) of solve() against the C++ solver, through the helpers
    chip_smoke uses, on a 12x12 broken-cloud scene at small photon
    counts (tolerances of tests/test_cross_native.py for that noise)."""
    from er3t_tpu.pre.atm import atm_atmmod
    from er3t_tpu.pre.abs import abs_synthetic
    from er3t_tpu.pre.cld import cld_gen_hem
    levels = np.concatenate([np.arange(0, 3.0, 0.5),
                             np.arange(3.0, 20.1, 2.0)])
    atm = atm_atmmod(levels)
    ab = abs_synthetic(650.0, atm, ng=4)
    cld = cld_gen_hem(nx=12, ny=12, nz=4, dx=0.2, dy=0.2, dz=0.5,
                      cloud_frac_tgt=0.3, radii=(0.5,), cot_scale=10.0,
                      cloud_base=0.5, seed=3)
    cloudy = chip_smoke.cloudy_columns(cld)
    assert cloudy.any() and not cloudy.all()
    kw_r = dict(chip_smoke.R_KW, forward_trunc_deg=None)
    res, _ = chip_smoke.run_solve(atm, ab, cld, None, kw_r, 40_000, 2,
                                  seed=3)
    scene, st = chip_smoke.scene_for(atm, ab, cld, None, kw_r)
    ref = chip_smoke.reference_radiance(scene, st, ab, kw_r, 80_000, seed=4)
    tol = {'domain': 0.04, 'cloudy': 0.06, 'clear': 0.06}
    for name, d, t in chip_smoke.radiance_checks(np.asarray(res['rad']),
                                                 ref, cloudy, tol):
        assert d <= t, (name, d)

    res, _ = chip_smoke.run_solve(atm, ab, cld, None, chip_smoke.F_KW,
                                  40_000, 1, seed=5)
    mu0 = np.cos(np.deg2rad(30.0))
    assert chip_smoke.toa_direct_error(res['f_down_direct'], mu0,
                                       res.toa) <= chip_smoke.TOA_TOL
    scene, st = chip_smoke.scene_for(atm, ab, cld, None, chip_smoke.F_KW)
    prof_ref = chip_smoke.reference_flux(scene, st, ab, chip_smoke.F_KW,
                                         60_000, seed=6)
    for name, d, t in chip_smoke.flux_checks(
            chip_smoke.domain_profiles(res), prof_ref, mu0 * res.toa):
        assert d <= t, (name, d)
