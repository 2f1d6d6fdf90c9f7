"""The flight kernel's phase-LUT lookups against a numpy nearest-bin
reference: evaluation rows (working and TMS halves) and inverse-CDF
sample rows, for bin counts on and off a power-of-two grid."""

import numpy as np
import pytest

import jax.numpy as jnp

from er3t_tpu.rtm.mc_flight import phase_lookup_eval, phase_lookup_sample


@pytest.mark.parametrize('n_m, n_u', [(2048, 2048), (300, 500)])
def test_phase_lookup_matches_nearest_bin(n_m, n_u):
    rng = np.random.default_rng(n_m)
    npf, b = 5, 4096
    pt_p = rng.uniform(0.1, 10.0, size=(2 * npf, n_m)).astype(np.float32)
    pt_mu = rng.uniform(-1, 1, size=(npf, n_u)).astype(np.float32)
    apf = rng.integers(0, npf, b).astype(np.int32)
    first = rng.integers(0, 2, b).astype(bool)
    mu = rng.uniform(-1, 1, b).astype(np.float32)
    mu[:4] = [-1.0, 1.0, 0.0, -1.0 + 1e-7]          # bin edges and ends
    u = rng.uniform(0, 1, b).astype(np.float32)
    u[:2] = [1e-7, 1.0 - 1e-7]

    pe = np.asarray(phase_lookup_eval(jnp.asarray(pt_p), jnp.asarray(apf),
                                      jnp.asarray(mu), jnp.asarray(first)))
    mn = np.asarray(phase_lookup_sample(jnp.asarray(pt_mu),
                                        jnp.asarray(apf), jnp.asarray(u)))

    ib = np.clip(((mu + 1.0) * 0.5 * (n_m - 1) + 0.5).astype(np.int32),
                 0, n_m - 1)
    iu = np.clip((u * (n_u - 1) + 0.5).astype(np.int32), 0, n_u - 1)
    tab = apf > 0                                    # row 0: Rayleigh
    np.testing.assert_array_equal(
        pe[tab], pt_p[apf + np.where(first, npf, 0), ib][tab])
    np.testing.assert_allclose(pe[~tab], 0.75 * (1.0 + mu * mu)[~tab],
                               rtol=1e-6)
    np.testing.assert_array_equal(mn, pt_mu[apf, iu])
    # the TMS half is selected exactly where the photon is unscattered
    assert np.all(pe[tab & first] == pt_p[apf + npf, ib][tab & first])
    assert np.all(pe[tab & ~first] == pt_p[apf, ib][tab & ~first])
