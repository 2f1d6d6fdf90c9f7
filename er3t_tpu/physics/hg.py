"""Henyey-Greenstein phase function: evaluation and analytic sampling.

Physics parity with the reference's ``pha_hg``
(/root/reference/er3t/pre/pha/pha_hg.py:10-66); the sampler is the standard
closed-form inverse CDF, which the transport kernel uses directly instead
of a tabulated lookup when a scene is HG-only.
"""

from __future__ import annotations

import numpy as np

__all__ = ['hg_phase', 'sample_hg_mu']


def hg_phase(g, mu):
    """HG phase function P(mu), normalized so that integral over mu is 2
    (i.e. integral over solid angle of P/(4 pi) is 1 — the framework-wide
    convention; the reference's tabulation carries an extra 1/2,
    pha_hg.py:10-27, which its solver renormalizes away)."""
    g = np.asarray(g, dtype=np.float64)
    return (1.0 - g * g) / (1.0 - 2.0 * g * mu + g * g) ** 1.5


def sample_hg_mu(g, u):
    """Analytic inverse-CDF sample of the HG scattering cosine.

    Works elementwise under numpy or jax.numpy; ``u`` uniform in [0, 1).
    Handles |g| ~ 0 with the isotropic limit.
    """
    import jax.numpy as jnp
    g = jnp.asarray(g)
    u = jnp.asarray(u)
    safe_g = jnp.where(jnp.abs(g) < 1e-4, 1e-4, g)
    frac = (1.0 - safe_g * safe_g) / (1.0 - safe_g + 2.0 * safe_g * u)
    mu_aniso = (1.0 + safe_g * safe_g - frac * frac) / (2.0 * safe_g)
    mu_iso = 2.0 * u - 1.0
    return jnp.where(jnp.abs(g) < 1e-4, mu_iso, jnp.clip(mu_aniso, -1.0, 1.0))
