"""Phase-function objects and the transport kernels' sampling tables.

Capability parity with the reference's ``pha_mie_wc`` and ``pha_hg``
(/root/reference/er3t/pre/pha/pha_mie.py:72-228, pha_hg.py:10-66), re-designed
for an in-framework solver:

* ``pha_mie_wc`` computes its tables with the bundled Mie code
  (er3t_tpu.physics.mie) instead of reading an external netCDF LUT
  (a libRadtran-format ``wc.sol.mie.cdf`` is still accepted when present).
* Every phase object can be compiled to a :class:`PhaseTable` — the SoA
  structure the transport kernels consume: an inverse-CDF sampling LUT
  (uniform-in-u) and an evaluation LUT (uniform-in-mu), both fixed-shape
  gathers on device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..physics import hg as hg_mod
from ..physics import mie as mie_mod

__all__ = ['PhaseTable', 'pha_hg', 'pha_mie_wc', 'build_phase_table']


@dataclasses.dataclass
class PhaseTable:
    """Compiled phase-function set for the transport kernel.

    Index 0 is reserved for Rayleigh (sampled analytically in the kernel);
    tabulated entries start at index 1, matching the reference solver's
    convention of apf>=1 for table rows and apf=-1 for Rayleigh
    (er3t/rtm/mca/mca_atm.py:260-301).

    Attributes
    ----------
    mu_sample : (Npf, Nu) float32 — inverse CDF: scattering cosine at
        uniform deviate u = i/(Nu-1)
    p_eval : (Npf, Nm) float32 — P(mu) on the uniform mu grid
        mu = -1 + 2*j/(Nm-1), normalized so integral P dmu = 2
    asy : (Npf,) asymmetry parameters
    ssa : (Npf,) single-scattering albedos of the generating entries
    reff : (Npf,) effective radii [um] (0 where not applicable)
    trunc_f : (Npf,) delta-truncated forward-peak fraction (0 = exact);
        the scene builder rescales extinction/ssa accordingly
        (similarity relations: ext' = ext (1 - ssa f),
        ssa' = ssa (1-f)/(1 - ssa f))
    p_tms : (Npf, Nm) TMS-corrected eval rows, P_full(mu)/(1-f): with the
        delta-scaled scattering coefficient sigma_s' = sigma_s (1-f), a
        first-order local estimate evaluated with P_full/(1-f) reproduces the
        exact Nakajima-Tanaka single-scatter integrand under scaled
        transmissions — this is what lets the solver run MCARaTS's default
        20-deg truncation (Sca_qtfmax, mca_inp.py:52-54) at radiance-grade
        accuracy.  Equal to p_eval where trunc_f = 0.
    """
    mu_sample: np.ndarray
    p_eval: np.ndarray
    asy: np.ndarray
    ssa: np.ndarray
    reff: np.ndarray
    trunc_f: np.ndarray | None = None
    p_tms: np.ndarray | None = None

    @property
    def n_pf(self) -> int:
        return self.mu_sample.shape[0]

    def take_rows(self, rows: np.ndarray) -> 'PhaseTable':
        """Return a table holding only ``rows`` (in order), slicing EVERY
        array field whose leading dim is the row count.  A future field that
        is neither row-indexed nor None fails loudly here instead of being
        silently dropped by an explicit field list."""
        n = self.n_pf
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                kw[f.name] = None
            elif isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n:
                kw[f.name] = v[rows]
            else:
                raise TypeError(
                    f'PhaseTable.take_rows: field {f.name!r} is not '
                    f'row-indexed (shape {getattr(v, "shape", None)}); '
                    'teach take_rows how to slice it')
        return PhaseTable(**kw)


def _invert_cdf(ang_deg: np.ndarray, pha: np.ndarray, n_u: int) -> np.ndarray:
    """Inverse CDF of a tabulated phase function -> mu at uniform u grid."""
    mu = np.cos(np.deg2rad(ang_deg))        # decreasing from 1 to -1
    order = np.argsort(mu)
    mu_s, p_s = mu[order], pha[order]
    # CDF(mu) = int_{-1}^{mu} P dmu' / 2, trapezoidal
    dmu = np.diff(mu_s)
    seg = 0.5 * (p_s[1:] + p_s[:-1]) * dmu
    cdf = np.concatenate([[0.0], np.cumsum(seg)])
    cdf /= cdf[-1]
    u = np.linspace(0.0, 1.0, n_u)
    # cdf is monotone in mu_s
    return np.interp(u, cdf, mu_s)


def _eval_grid(ang_deg: np.ndarray, pha: np.ndarray, n_m: int) -> np.ndarray:
    """Bin-averaged P on the uniform mu grid used by nearest-bin lookup.

    Bin averages (rather than point samples) keep the kernel's nearest-bin
    local estimates unbiased when the row has sub-bin structure — a point
    sample at mu = 1 would return the Mie diffraction-peak *maximum* for
    every scattering angle within half a bin of forward, a ~10% radiance
    overestimate for reff ~ 10 um clouds.  Normalization (int P dmu = 2)
    uses the source grid, which is fine near 0/180 deg.
    """
    mu = np.cos(np.deg2rad(ang_deg))
    order = np.argsort(mu)
    mu_s, p_s = mu[order], pha[order]
    norm = np.trapezoid(p_s, mu_s)
    mu_grid = np.linspace(-1.0, 1.0, n_m)
    edges = np.empty(n_m + 1)
    edges[1:-1] = 0.5 * (mu_grid[1:] + mu_grid[:-1])
    edges[0], edges[-1] = -1.0, 1.0
    seg = 0.5 * (p_s[1:] + p_s[:-1]) * np.diff(mu_s)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    cum_e = np.interp(edges, mu_s, cum)
    p = np.diff(cum_e) / np.diff(edges)
    return 2.0 * p / norm


class pha_hg:
    """Henyey-Greenstein phase-function set (reference: pha_hg.py:30-66)."""

    ID = 'HG'

    def __init__(self, asy_params=(-0.85, 0.85), angles=None):
        if angles is None:
            angles = np.linspace(0.0, 180.0, 1801)
        angles = np.asarray(angles, dtype=np.float64)
        asy = np.asarray(asy_params, dtype=np.float64)
        mu = np.cos(np.deg2rad(angles))
        pha = np.stack([hg_mod.hg_phase(g, mu) for g in asy], axis=1)
        self.data = {
            'id': 'HG',
            'ang': angles,
            'asy': asy,
            'ssa': np.ones_like(asy),
            'ref': np.zeros_like(asy),
            'pha': pha,
        }


class pha_mie_wc:
    """Water-cloud Mie phase functions at a wavelength, per effective radius.

    Computes tables with the in-framework Mie code over a standard r_eff grid
    (1..25 um, the range of the reference LUT).  ``data`` mirrors the
    reference object's fields (pha_mie.py:205-218): ang/pha/ssa/asy/ref.
    """

    ID = 'Mie'

    def __init__(self, wavelength=650.0, reff_grid=None, veff=0.1,
                 angles=None, n_quad=32):
        if reff_grid is None:
            reff_grid = np.concatenate([np.arange(1.0, 15.0, 1.0),
                                        np.arange(15.0, 25.01, 2.5)])
        out = mie_mod.mie_gamma_dist(wavelength, reff_grid, veff=veff,
                                     angles_deg=angles, n_quad=n_quad)
        self.wvl = float(wavelength)
        self.data = {
            'id': 'Mie',
            'wvl0': float(wavelength),
            'wvl': float(wavelength),
            'ang': out['ang'],
            'pha': out['pha'],
            'ssa': out['ssa'],
            'asy': out['asy'],
            'ref': out['ref'],
            'qe': out['qe'],
        }


def build_phase_table(pha_obj=None, n_u: int = 2048, n_m: int = 2048,
                      forward_trunc_deg: float | None = None) -> PhaseTable:
    """Compile a phase object into the kernel's :class:`PhaseTable`.

    With ``pha_obj=None`` returns a table whose single tabulated entry is
    HG(g=0.85) — the reference's fallback when no phase set is supplied
    (er3t/rtm/mca/mca_atm.py:260-262).

    Resolution: ``n_u`` inverse-CDF quantiles for sampling and ``n_m``
    uniform-mu bins for the (bin-averaged) evaluation rows.  2048/2048
    resolves the post-truncation Mie structure (rainbow/glory widths are
    1-2 deg >= the 0.06-deg worst-case bin) and is validated by the
    cross-solver and truncation closure tests.

    ``forward_trunc_deg`` enables delta-truncation: scattering within that
    angle of forward is treated as unscattered.  The returned ``trunc_f``
    fractions let the scene builder apply the similarity scaling; the
    sampling/evaluation LUTs are renormalized over the truncated range.
    This is the counterpart of MCARaTS's phase-function truncation
    (Sca_nchi/qtfmax, mca_inp.py:52-54) — essential for efficient transport
    and low-variance local estimation through strongly forward-peaked Mie
    phase functions.
    """
    if pha_obj is None:
        pha_obj = pha_hg(asy_params=(0.85,))

    ang = np.asarray(pha_obj.data['ang'], dtype=np.float64)
    pha = np.asarray(pha_obj.data['pha'], dtype=np.float64)
    asy = np.atleast_1d(pha_obj.data['asy'])
    ssa = np.atleast_1d(pha_obj.data.get('ssa', np.ones_like(asy)))
    ref = np.atleast_1d(pha_obj.data.get('ref', np.zeros_like(asy)))
    n_pf = pha.shape[1]

    mu_sample = np.zeros((n_pf + 1, n_u), dtype=np.float32)
    p_eval = np.zeros((n_pf + 1, n_m), dtype=np.float32)
    p_tms = np.zeros((n_pf + 1, n_m), dtype=np.float32)
    trunc_f = np.zeros(n_pf + 1, dtype=np.float32)

    # slot 0: Rayleigh placeholder (kernel samples Rayleigh analytically but
    # may still evaluate it from the table for uniformity)
    mu_grid = np.linspace(-1.0, 1.0, n_m)
    p_eval[0] = 0.75 * (1.0 + mu_grid ** 2)
    u = np.linspace(0.0, 1.0, n_u)
    from ..physics.rayleigh import sample_rayleigh_mu
    mu_sample[0] = np.asarray(sample_rayleigh_mu(np.clip(u, 1e-7, 1 - 1e-7)))

    for i in range(n_pf):
        ang_i, pha_i = ang, pha[:, i]
        f_i = 0.0
        if forward_trunc_deg is not None and forward_trunc_deg > 0:
            mu = np.cos(np.deg2rad(ang_i))
            order = np.argsort(mu)
            mu_s, p_s = mu[order], pha_i[order]
            mu_t = np.cos(np.deg2rad(forward_trunc_deg))
            # energy fraction scattered within the forward cone
            peak = mu_s >= mu_t
            f = np.trapezoid(np.where(peak, p_s, 0.0), mu_s) / 2.0
            trunc_f[i + 1] = f
            f_i = f
            # remove the peak, renormalize over the remaining range
            p_cut = np.where(peak, 0.0, p_s) / max(1.0 - f, 1e-6)
            ang_i = np.rad2deg(np.arccos(np.clip(mu_s[::-1], -1, 1)))
            pha_i = p_cut[::-1]
        mu_i = _invert_cdf(ang_i, pha_i, n_u)
        if f_i > 0:
            # np.interp resolves the truncated CDF's plateau at 1.0 to the
            # LAST mu (=1.0, inside the removed cone); the inverse of the
            # truncated distribution can never exceed mu_t
            mu_i = np.minimum(mu_i, np.cos(np.deg2rad(forward_trunc_deg)))
        mu_sample[i + 1] = mu_i
        p_eval[i + 1] = _eval_grid(ang_i, pha_i, n_m)
        # TMS row: full phase / (1-f) (Nakajima & Tanaka 1988); equals the
        # working row when f = 0
        p_tms[i + 1] = (_eval_grid(ang, pha[:, i], n_m) / max(1.0 - f_i, 1e-6)
                        if f_i > 0 else p_eval[i + 1])

    p_tms[0] = p_eval[0]
    return PhaseTable(
        mu_sample=mu_sample,
        p_eval=p_eval,
        asy=np.concatenate([[0.0], asy]).astype(np.float32),
        ssa=np.concatenate([[1.0], ssa]).astype(np.float32),
        reff=np.concatenate([[0.0], ref]).astype(np.float32),
        trunc_f=trunc_f,
        p_tms=p_tms,
    )
