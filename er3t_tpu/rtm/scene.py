"""Scene assembly: preprocessing objects -> device-resident transport structs.

This replaces the reference's file-interchange layer (``mca_atm_1d``,
``mca_atm_3d``, ``mca_sca``, ``mca_sfc_2d`` writing Fortran namelists and
binaries, /root/reference/er3t/rtm/mca/mca_atm.py, mca_sca.py, mca_sfc.py)
with typed pytrees of JAX arrays.

Physical model (matching the solver semantics of MCARaTS as driven by the
reference):

* a plane-parallel 1D background: Rayleigh scattering ``sig_ray(z)`` with the
  analytic Rayleigh phase, gas absorption ``kabs(z, g)`` applied continuously
  along photon paths (the reference's Atm_ext1d/Atm_abs1d split,
  mca_atm.py:85-102);
* optional extra 1D constituents (aerosol layers) with scalar ssa/asy
  (mca_atm.py:105-139);
* an optional 3D particulate region spanning atmosphere layers
  [iz3l, iz3l+nz3): per-voxel extinction, single-scattering albedo and
  phase-table row (cloud + optional 3D aerosol; mca_atm.py:144-300);
* a 2D surface with per-pixel BRDF type/params (mca_sfc.py:89-133);
* a collimated solar source.

The per-layer *scattering majorant* ``sig_maj`` drives null-collision
free-path sampling in the transport kernel.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..pre.pha import PhaseTable, build_phase_table
from ..pre.sfc import SFC_LAMBERTIAN, Surface, sfc_lambertian
from ..physics.rayleigh import rayleigh_od
from ..util.grid import get_lay_index

__all__ = ['SceneArrays', 'SceneStatic', 'build_scene']


class SceneArrays(NamedTuple):
    """Device arrays of a scene (a JAX pytree)."""
    z_lev: jnp.ndarray        # (Nz+1,) level altitudes [m], surface first
    sig_ray: jnp.ndarray      # (Nz,) Rayleigh scattering extinction [1/m]
    kabs: jnp.ndarray         # (Nz, Ng) gas absorption [1/m]
    sig_maj: jnp.ndarray      # (Nz,) scattering majorant [1/m]
    sig_aer: jnp.ndarray      # (Nz, Na) per-constituent 1D aerosol
    #                           extinction [1/m] (Na >= 1; zero if none) —
    #                           each added 1D constituent keeps its own
    #                           ssa/phase like the reference's
    #                           add_mca_1d_atm (mca_atm.py:105-139)
    aer_ssa: jnp.ndarray      # (Na,) per-constituent single-scattering albedo
    aer_apf: jnp.ndarray      # (Na,) int32 per-constituent phase-table row
    ext3d: jnp.ndarray        # (Nx, Ny, Nz3) TOTAL extinction over all 3D
    #                           constituents [1/m] (Nz3 >= 1)
    ssa3d: jnp.ndarray        # (Nx, Ny, Nz3, Ns) per-constituent ssa
    apf3d: jnp.ndarray        # (Nx, Ny, Nz3, Ns) int32 per-constituent
    #                           phase rows
    cf3d: jnp.ndarray         # (Nx, Ny, Nz3, Ns) cumulative extinction-
    #                           fraction upper boundaries (last slot = 1):
    #                           at a 3D collision the constituent is chosen
    #                           by extinction share (reference: every 3D
    #                           constituent carries its own omg/apf per
    #                           voxel, mca_atm.py:340-370)
    pt_mu: jnp.ndarray        # (Npf, Nu) inverse-CDF sampling LUT
    pt_p: jnp.ndarray         # (2*Npf, Nm) P(mu) eval LUT: working rows,
    #                           then TMS rows (first-order local estimates)
    jsfc: jnp.ndarray         # (Nxs, Nys) int32 surface type
    psfc: jnp.ndarray         # (Nxs, Nys, 5) surface params
    mu0: jnp.ndarray          # () cosine of solar zenith angle
    phi0: jnp.ndarray         # () solar azimuth [rad] (direction of travel)


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Hashable static configuration accompanying :class:`SceneArrays`."""
    nz: int
    ng: int
    nx: int
    ny: int
    nz3: int
    iz3l: int                 # first atmosphere layer of the 3D region
    nxs: int
    nys: int
    dx: float                 # m
    dy: float                 # m
    has_3d: bool
    has_aer1d: bool
    ipa: bool = False         # independent-pixel mode (no horizontal transport)
    ns3: int = 1              # number of 3D constituents (cloud + 3D aerosols)
    sfc_lambertian: bool = False  # every surface cell is Lambertian
    #                               (informational: the kernels keep the
    #                               generic BRDF calls)


def _cloud_to_grids(cld, pha, atm):
    """Map a Cloud3D onto atmosphere layers; derive ssa/apf per voxel.

    Mirrors mca_atm_3d.pre_mca_3d_atm (mca_atm.py:233-301): nearest-layer
    mapping of cloud layers into the atmosphere grid; Mie ssa/phase-row by
    effective radius, HG(0.85) fallback without a phase object.
    """
    lay_index = get_lay_index(cld.altitude, atm.lay.altitude)
    iz3l = int(lay_index[0])
    nz3 = int(lay_index.size)
    if np.any(np.diff(lay_index) != 1):
        raise ValueError('cloud layers must map to contiguous atmosphere layers; '
                         'choose atmosphere levels that resolve the cloud grid')

    ext = np.asarray(cld.extinction, dtype=np.float32)
    cloudy = ext > 0.0
    ssa = np.ones_like(ext, dtype=np.float32)
    apf = np.zeros(ext.shape, dtype=np.int32)

    if pha is None:
        # HG g=0.85 (table row 1 of the default table)
        apf[cloudy] = 1
    else:
        ref = np.asarray(pha.data['ref'])
        ssa_t = np.asarray(pha.data['ssa'])
        cer = np.asarray(cld.cer)
        # nearest effective-radius row via searchsorted (rows offset by 1:
        # row 0 = Rayleigh)
        mid = 0.5 * (ref[1:] + ref[:-1])
        idx = np.searchsorted(mid, cer).astype(np.int32)
        apf[cloudy] = (idx + 1)[cloudy]
        ssa[cloudy] = np.interp(cer[cloudy], ref, ssa_t).astype(np.float32)
    return iz3l, nz3, ext, ssa, apf


def build_scene(atm, abs_coef, cld=None, pha=None, aer_1ds=(), aer_3ds=(),
                surface=0.03, solar_zenith_angle=30.0, solar_azimuth_angle=0.0,
                ipa=False, forward_trunc_deg=None, pfpeak=None,
                phase_bins=None):
    """Assemble a scene for the transport kernel.

    Parameters mirror the reference's ``mcarats_ng`` front door
    (mcarats.py:62-231): atmosphere + absorption objects, optional cloud and
    phase set, aerosol lists, surface (scalar albedo or :class:`Surface`),
    solar geometry.

    ``pfpeak`` (MCARaTS ``Pho_pfpeak``, mca_inp.py:199,494, default 30.0
    there): clamp the *working* phase-function evaluation rows used by
    multiple-scattering local estimates at this peak value and redistribute
    the clipped energy uniformly over mu, so no single radiance deposit can
    spike by more than ~pfpeak/P_typ above the mean.  Sampling rows and the
    TMS rows (first-order estimates — exact single scattering) are left
    untouched, so the clamp only smooths the order>=2 estimator, which is
    MCARaTS's truncation-approximation semantics.  The redistribution keeps
    the eval rows normalized (integral P dmu = 2); the residual moved is the
    energy above the clamp — tiny once ``forward_trunc_deg`` has already
    removed the diffraction peak.  None/0 disables (exact estimator).
    """
    nz = atm.nz
    ng = abs_coef.ng
    dz_m = atm.lay.thickness * 1000.0

    # Rayleigh scattering per layer [1/m] (mca_atm.py:85-88)
    tau_ray = rayleigh_od(abs_coef.wvl, atm.lev.pressure, lat_deg=atm.lat)
    sig_ray = (tau_ray / dz_m).astype(np.float32)

    # gas absorption [1/m] (mca_atm.py:90-91)
    kabs = (abs_coef.abso_coef / dz_m[:, None]).astype(np.float32)

    # 1D aerosol channels: one per constituent, each with its own ssa and
    # phase row (reference role: add_mca_1d_atm appends extra 1D constituents
    # with individual omg/apf and z-windowing, mca_atm.py:105-139)
    aer_1ds = tuple(aer_1ds)
    aer_3ds = tuple(aer_3ds)
    na = max(len(aer_1ds), 1)
    sig_aer = np.zeros((nz, na), dtype=np.float32)
    for j, a in enumerate(aer_1ds):
        sig_aer[:, j] = a.extinction_profile(
            atm.lay.altitude, atm.lay.thickness).astype(np.float32)
    aer_ssa = np.array([a.ssa for a in aer_1ds] or [1.0], dtype=np.float32)
    # one HG phase row per constituent (1D then 3D aerosols)
    extra_asy = [a.asy for a in aer_1ds] + [a.asy for a in aer_3ds]

    # phase table: default HG(0.85) for clouds + aerosol HG rows appended.
    # ``phase_bins`` overrides the 2048/2048 LUT resolution (n_u and n_m
    # together) — a rate/accuracy knob.
    pb = {} if phase_bins is None else {'n_u': int(phase_bins),
                                        'n_m': int(phase_bins)}
    if pha is None:
        from ..pre.pha import pha_hg
        asy_rows = [0.85] + extra_asy
        table = build_phase_table(pha_hg(asy_params=tuple(asy_rows)),
                                  forward_trunc_deg=forward_trunc_deg, **pb)
    else:
        table = build_phase_table(pha, forward_trunc_deg=forward_trunc_deg,
                                  **pb)
        if extra_asy:
            from ..pre.pha import pha_hg
            aer_tab = build_phase_table(pha_hg(asy_params=tuple(extra_asy)),
                                        **pb)
            table = PhaseTable(
                mu_sample=np.concatenate([table.mu_sample, aer_tab.mu_sample[1:]], axis=0),
                p_eval=np.concatenate([table.p_eval, aer_tab.p_eval[1:]], axis=0),
                asy=np.concatenate([table.asy, aer_tab.asy[1:]]),
                ssa=np.concatenate([table.ssa, aer_tab.ssa[1:]]),
                reff=np.concatenate([table.reff, aer_tab.reff[1:]]),
                trunc_f=np.concatenate([table.trunc_f, aer_tab.trunc_f[1:]]),
                p_tms=np.concatenate([table.p_tms, aer_tab.p_tms[1:]], axis=0),
            )
    first_extra = table.n_pf - len(extra_asy)
    aer_apf = np.array([first_extra + j for j in range(len(aer_1ds))] or [0],
                       dtype=np.int32)
    aer3d_rows = [first_extra + len(aer_1ds) + j for j in range(len(aer_3ds))]

    # 3D region: one slot per constituent (cloud + each 3D aerosol).  Every
    # constituent keeps its own ssa and phase row per voxel, selected at
    # collision time by extinction share — the exact counterpart of the
    # reference writing per-constituent omg/apf blocks into mca_atm_3d.bin
    # (mca_atm.py:340-370); wherever cloud and aerosol overlap, each event
    # scatters with the selected constituent's own phase function.
    if cld is not None:
        iz3l, nz3, ext_c, ssa_c, apf_c = _cloud_to_grids(cld, pha, atm)
        nx, ny = cld.nx, cld.ny
        dx, dy = cld.dx * 1000.0, cld.dy * 1000.0
        exts = [ext_c]
        ssas = [ssa_c]
        apfs = [apf_c]
        for j, a in enumerate(aer_3ds):
            exts.append(np.asarray(a.extinction, dtype=np.float32))
            ssas.append(np.full_like(exts[-1], np.float32(a.ssa)))
            apfs.append(np.full(exts[-1].shape, aer3d_rows[j], dtype=np.int32))
        if table.trunc_f is not None and np.any(table.trunc_f > 0):
            # delta-truncation similarity scaling per constituent (peak
            # energy continues unscattered): ext' = ext(1 - ssa f),
            # ssa' = ssa(1-f)/(1-ssa f), with f of that constituent's row
            for s in range(len(exts)):
                f_vox = table.trunc_f[apfs[s]]
                sf = 1.0 - ssas[s] * f_vox
                ssas[s] = (ssas[s] * (1.0 - f_vox)
                           / np.maximum(sf, 1e-9)).astype(np.float32)
                exts[s] = (exts[s] * sf).astype(np.float32)
        ext3d = np.sum(exts, axis=0).astype(np.float32)
        ssa3d = np.stack(ssas, axis=-1)
        apf3d = np.stack(apfs, axis=-1)
        with np.errstate(invalid='ignore', divide='ignore'):
            cf3d = np.cumsum(np.stack(exts, axis=-1), axis=-1) \
                / np.maximum(ext3d[..., None], 1e-30)
        cf3d[..., -1] = 1.0
        cf3d = np.where(ext3d[..., None] > 0, cf3d, 1.0).astype(np.float32)
        has_3d = True
    else:
        if aer_3ds:
            raise ValueError(
                '3D aerosols ride the cloud grid (Aerosol3D carries no '
                'geometry of its own); pass cld= to define the 3D region — '
                'a zero-extinction carrier (e.g. cld_gen_hom(..., cot0=0)) '
                'works for aerosol-only scenes')
        iz3l, nz3 = 0, 1
        nx = ny = 1
        dx = dy = 1000.0
        ext3d = np.zeros((1, 1, 1), dtype=np.float32)
        ssa3d = np.ones((1, 1, 1, 1), dtype=np.float32)
        apf3d = np.zeros((1, 1, 1, 1), dtype=np.int32)
        cf3d = np.ones((1, 1, 1, 1), dtype=np.float32)
        has_3d = False

    # Phase-row compaction: keep only the table rows this scene references
    # (row 0 = Rayleigh always; big Mie tables carry ~20 reff rows of which
    # a scene typically uses a fraction).  Exactly zero physics change —
    # unused rows contribute nothing — and the tables the kernel gathers
    # from shrink.  apf indices are remapped onto the compacted table.
    used = np.unique(np.concatenate([[0], apf3d.ravel(), aer_apf.ravel()]))
    if used.size < table.n_pf:
        remap = np.zeros(table.n_pf, dtype=np.int32)
        remap[used] = np.arange(used.size, dtype=np.int32)
        table = table.take_rows(used)
        apf3d = remap[apf3d]
        aer_apf = remap[aer_apf]

    if pfpeak is not None and pfpeak > 0:
        # Pho_pfpeak counterpart: clamp working eval rows (1..) at pfpeak and
        # redistribute the clipped energy uniformly (keeps int P dmu = 2).
        # Row 0 (Rayleigh, max 1.5) and TMS rows are untouched.
        pe = np.array(table.p_eval, dtype=np.float64)
        n_m = pe.shape[1]
        edges = np.empty(n_m + 1)
        mu_grid = np.linspace(-1.0, 1.0, n_m)
        edges[1:-1] = 0.5 * (mu_grid[1:] + mu_grid[:-1])
        edges[0], edges[-1] = -1.0, 1.0
        widths = np.diff(edges)                                # (Nm,)
        clipped = np.maximum(pe[1:] - pfpeak, 0.0)
        resid = clipped @ widths                               # (Npf-1,)
        pe[1:] = np.minimum(pe[1:], pfpeak) + resid[:, None] / 2.0
        table = dataclasses.replace(table, p_eval=pe.astype(np.float32))

    # scattering majorant per layer
    sig_maj = sig_ray + sig_aer.sum(axis=1)
    if has_3d:
        ext_max = np.max(ext3d, axis=(0, 1))  # (nz3,)
        sig_maj = sig_maj.copy()
        sig_maj[iz3l:iz3l + nz3] += ext_max
    sig_maj = np.maximum(sig_maj, 1e-12).astype(np.float32)

    # surface
    if isinstance(surface, Surface):
        sfc = surface
    else:
        sfc = sfc_lambertian(float(surface))

    sza = np.deg2rad(solar_zenith_angle)
    # photon azimuth of travel: the reference's convention converts a
    # sun-position azimuth (0=N, clockwise) to the direction photons move
    # (mcarats.py:527-549); we store the travel azimuth directly in radians,
    # measured from +x (east), counterclockwise.
    phi_travel = np.deg2rad(270.0 - solar_azimuth_angle)

    arrays = SceneArrays(
        z_lev=jnp.asarray(atm.lev.altitude * 1000.0, dtype=jnp.float32),
        sig_ray=jnp.asarray(sig_ray),
        kabs=jnp.asarray(kabs),
        sig_maj=jnp.asarray(sig_maj),
        sig_aer=jnp.asarray(sig_aer),
        aer_ssa=jnp.asarray(aer_ssa, dtype=jnp.float32),
        aer_apf=jnp.asarray(aer_apf, dtype=jnp.int32),
        ext3d=jnp.asarray(ext3d),
        ssa3d=jnp.asarray(ssa3d),
        apf3d=jnp.asarray(apf3d),
        cf3d=jnp.asarray(cf3d),
        pt_mu=jnp.asarray(table.mu_sample),
        # rows [0, Npf) = working (possibly truncated) eval rows;
        # rows [Npf, 2 Npf) = TMS rows for first-order local estimates
        pt_p=jnp.asarray(np.concatenate(
            [table.p_eval,
             table.p_tms if table.p_tms is not None else table.p_eval],
            axis=0)),
        jsfc=jnp.asarray(sfc.jsfc, dtype=jnp.int32),
        psfc=jnp.asarray(sfc.psfc, dtype=jnp.float32),
        mu0=jnp.asarray(np.cos(sza), dtype=jnp.float32),
        phi0=jnp.asarray(phi_travel, dtype=jnp.float32),
    )
    static = SceneStatic(
        nz=nz, ng=ng, nx=nx, ny=ny, nz3=nz3, iz3l=iz3l,
        nxs=sfc.nx, nys=sfc.ny, dx=float(dx), dy=float(dy),
        has_3d=has_3d, has_aer1d=bool(aer_1ds), ipa=bool(ipa),
        ns3=int(ssa3d.shape[-1]),
        sfc_lambertian=bool(np.all(np.asarray(sfc.jsfc) == SFC_LAMBERTIAN)),
    )
    return arrays, static


def camera_rotation(phi_deg, the_deg, psi_deg):
    """Camera-frame -> world rotation, Z-Y-Z Euler (MCARaTS
    Rad_phi/the/psi).  Shared by the MC flight kernel (transposed:
    world -> camera) and the quasi renderer so their pixel mappings can
    never desynchronize."""
    cp, ct, cs = (np.deg2rad(phi_deg), np.deg2rad(the_deg),
                  np.deg2rad(psi_deg))

    def rz(a):
        return np.array([[np.cos(a), -np.sin(a), 0.0],
                         [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]])

    def ry(a):
        return np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                         [-np.sin(a), 0.0, np.cos(a)]])

    return (rz(cp) @ ry(ct) @ rz(cs)).astype(np.float32)
