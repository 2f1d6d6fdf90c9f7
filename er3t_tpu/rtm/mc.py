"""Event-marching Monte Carlo photon transport (the plain flux reference).

This module is the in-framework replacement for the external MCARaTS Fortran
solver that the reference drives through process fan-out
(/root/reference/er3t/rtm/mca/mca_run.py, mcarats.py).  Design notes:

* **SoA photon batch.** A fixed batch of B photons is advanced in lock-step
  by a ``lax.while_loop``; dead lanes respawn from the remaining photon
  budget ("persistent threads"), so utilization stays high.

* **Null-collision (maximal cross-section) free paths.** Scattering free
  paths are sampled against a per-layer majorant; tentative collisions are
  accepted with sigma_real/sigma_majorant.  This is the SIMD-friendly
  counterpart of MCARaTS's max-cross-section super-voxels
  (mca_inp.py:236-239) — no data-dependent DDA loop, one voxel gather per
  tentative collision.

* **Spectrally-correlated g-points.** One trajectory carries all Ng
  correlated-k weights: gas absorption is accumulated as a per-layer
  pathlength vector S (one-hot FMA per step) and materialized as
  exp(-S @ kabs) — an (B,Nz)x(Nz,Ng) matmul — only at tally events.
  Each trajectory therefore yields Ng correlated spectral samples, where the
  reference launches Ng independent solver processes (mcarats.py:159-196).
  Per-g estimates remain unbiased.  Set ``ng=1`` slices for the reference's
  independent-g protocol.

* **Local estimation** for radiance: every scattering/surface event deposits
  an attenuated contribution into the image, equivalent to MCARaTS's
  radiance targets (Wld_mtarget=2, mca_inp.py:404-407).

* **Event-driven layer marching.** Each loop iteration advances a photon to
  the nearer of (tentative collision, layer boundary); boundary crossings
  tally fluxes.  All control flow is masked arithmetic — no per-lane
  branching.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .scene import SceneArrays, SceneStatic

__all__ = ['SolverConfig', 'Tallies', 'transport', 'run_transport']

_F = jnp.float32
# optical-depth contractions run at full f32 (Hopper's default is TF32)
_HI = jax.lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static solver configuration (hashable; a jit static arg)."""
    target: str = 'radiance'           # 'radiance' | 'flux' | 'heating_rate'
    batch: int = 1 << 17               # photon lanes per device
    sensor_zenith: float = 0.0         # deg
    sensor_azimuth: float = 0.0        # deg
    flux_per_column: bool = False      # tally fluxes per (x, y) column
    max_events: int = 0                # 0 -> auto bound
    rr_wmin: float = 0.1               # Russian-roulette threshold
    rr_value: float = 0.0              # >0: sensor-importance roulette
    #                                     (flight kernel, satellite radiance
    #                                     only): photons whose estimated
    #                                     future contribution wmax/(1+tau_v)
    #                                     — tau_v the vertical scattering OD
    #                                     between the photon and the sensor,
    #                                     1/(1+tau) ~ the Milne escape
    #                                     probability of a conservative
    #                                     slab — falls below this threshold
    #                                     are rouletted with survival
    #                                     p = value/rr_value (floored at
    #                                     0.05; the same p reweights
    #                                     survivors, so any floor stays
    #                                     unbiased).  Cuts the deep-cloud
    #                                     random-walk iterations that
    #                                     dominate cloudy-scene cost while
    #                                     their deposits are attenuated
    #                                     away; no MCARaTS counterpart
    #                                     (its Pho_wmin kills on weight
    #                                     only, which never triggers in
    #                                     conservative 650 nm clouds)
    n_scat_max: int = 2000
    p3d_order: int = 0                 # >0: partial-3D — pin the column after
    #                                     this scattering order (MCARaTS
    #                                     solver=1 spirit: full 3D for low
    #                                     orders, columnar for high orders)
    pathlength: bool = False           # tally mean photon pathlength per
    #                                     pixel (MCARaTS Rad_mplen,
    #                                     mca_inp.py:148-152)
    sensor_type: str = 'satellite'     # 'satellite' | 'camera' (ground-based
    #                                     upward fisheye, MCARaTS Rad_mrkind=1)
    cf_dtau: float = 0.0               # >0: collision forcing for flights
    #                                     with majorant OD below this
    #                                     threshold (MCARaTS Rad_cf_*,
    #                                     Flx_cf_dtau, mca_inp.py:129,317):
    #                                     the flight collides from a
    #                                     truncated-exponential with weight
    #                                     1-exp(-OD); exact for radiance
    #                                     (escapes contribute nothing)
    flux_engine: str = 'flight'        # 'flight' (level crossings tallied in
    #                                     bulk per analytic flight) |
    #                                     'marching' (event-marching kernel,
    #                                     one crossing per iteration — the
    #                                     bitwise reference path)
    flux_kcross: int = 4               # per-column flux (flight engine):
    #                                     clamp each flight at its k-th level
    #                                     crossing so the tally scatter is
    #                                     bounded to k rows/lane/iteration
    #                                     (exact by memorylessness); 0 = one
    #                                     (B, Nz+1) scatter per iteration
    #                                     (the round-1 bottleneck path)
    tile_size: int = 0                 # >0: per-tile scattering majorants in
    #                                     the flight kernel (tile_size^2
    #                                     columns per tile) — the counterpart
    #                                     of MCARaTS's max-cross-section
    #                                     super-voxels (Atm_mcs_*,
    #                                     mca_inp.py:236-239); cuts null
    #                                     collisions in broken-cloud scenes
    split_wmax: float = 0.0            # >0: photon splitting / weight window
    #                                     (MCARaTS Pho_wmax/wfac,
    #                                     mca_inp.py:193-199): lanes whose
    #                                     best-case weight exceeds this split
    #                                     in two (the copy fills a dead lane,
    #                                     total weight preserved — unbiased);
    #                                     repeated splits give higher factors
    cam_xpos: float = 0.5              # camera position, domain fractions
    cam_ypos: float = 0.5              # (MCARaTS Rad_xpos/ypos)
    cam_zloc: float = 0.0              # camera altitude [m] (Rad_zloc);
    #                                     keep outside the 3D deck z-range
    cam_phi: float = 0.0               # Z-Y-Z Euler camera pointing [deg]
    cam_the: float = 0.0               # (MCARaTS Rad_phi/the/psi); the=0 is
    cam_psi: float = 0.0               # up-looking, the=180 nadir-down
    cam_qmax: float = 89.0             # fisheye half-angle [deg]
    cam_npix: int = 64                 # image is (cam_npix, cam_npix)
    cam_rmin: float = 50.0             # point-estimator distance clamp [m]
    cam_apsize: float = 0.0            # aperture radius [m] (MCARaTS
    #                                     Rad_apsize, mca_inp.py:338): each
    #                                     local estimate targets a uniform
    #                                     sample point on the horizontal
    #                                     aperture disk instead of the
    #                                     pinhole — the image becomes the
    #                                     aperture-averaged radiance
    #                                     (unbiased Monte Carlo over the
    #                                     aperture area); 0 = point aperture
    qmc_launch: bool = False           # flight kernel: stratified-jitter
    #                                     launch — photon index -> shuffled
    #                                     grid cell + in-cell jitter, so
    #                                     per-pixel launch counts are +-1
    #                                     instead of Poisson (the dominant
    #                                     clear-pixel noise term under local
    #                                     estimation); unbiased (random cell
    #                                     offset per run).  Off by default:
    #                                     measured neutral for satellite
    #                                     radiance (slant drift to the first
    #                                     event re-randomizes the deposit
    #                                     pixel)
    launch_coherent: bool = False      # flight kernel: stratified launch with
    #                                     a LINEAR index->cell map (cell =
    #                                     (idx+offset) mod ncell) instead of
    #                                     qmc_launch's multiplicative shuffle:
    #                                     the same +-1 per-block stratification
    #                                     guarantee (any bijection per block
    #                                     works), but consecutive lanes spawn
    #                                     in adjacent columns, so the voxel/
    #                                     majorant/surface gathers and image
    #                                     deposits of neighboring lanes hit
    #                                     neighboring rows.  Overrides
    #                                     qmc_launch's map.
    cam_importance_sigma: float = 0.0  # camera radiance only: >0 launches
    #                                     photons from a 50/50 mixture of
    #                                     uniform and a wrapped Gaussian of
    #                                     this std [km] centered on the
    #                                     camera column, with exact
    #                                     importance weights (launch weight
    #                                     = uniform pdf / mixture pdf <= 2).
    #                                     MEASURED DEAD END on broken-cloud
    #                                     sky scenes (r5, scripts/
    #                                     cam_importance_ab.py): ~1.9x
    #                                     pixel-variance LOSS at both 85-
    #                                     and 30-deg FOV, sigma 1-4 km —
    #                                     deposits decorrelate from the
    #                                     launch column, so the weight
    #                                     dispersion (E[w^2] -> 2) is pure
    #                                     cost (same physics as the r4
    #                                     firstdep finding).  Unbiased
    #                                     opt-in; single-device path only
    drain_compact: bool = True         # flight kernel: once the launch
    #                                     quota is exhausted and survivors
    #                                     fit, compact lanes into an 8x
    #                                     (then 64x) smaller batch for the
    #                                     drain tail (stragglers random-
    #                                     walking in thick clouds).  Exact
    #                                     (states permuted, fresh RNG
    #                                     substreams); cuts the 200-7000
    #                                     step tail's cost ~8-64x since
    #                                     ms/step is linear in batch.
    #                                     Ignored with sort_every>0 or
    #                                     batch<2048 (one B/8>=256 stage
    #                                     needed; see transport_flight)
    sort_every: int = 0                # >0: every N steps re-sort the photon
    #                                     lanes by their current voxel column
    #                                     so spatial coherence (see
    #                                     launch_coherent) survives photon
    #                                     diffusion.  A lane permutation
    #                                     re-pairs photons with future RNG
    #                                     draws (different realization, same
    #                                     distribution — unbiased)
    ablate: str = ''                   # profiling-only: comma-joined subset of
    #                                     {'vox','phase','deposit','firstdep'}
    #                                     replaces that gather/scatter with a
    #                                     constant (firstdep: drops first-
    #                                     order radiance deposits — variance-
    #                                     budget diagnostic); NEVER use for
    #                                     physics


class Tallies(NamedTuple):
    rad: jnp.ndarray        # (Nxr, Nyr, Ng)
    flux: jnp.ndarray       # (Nxf, Nyf, Nz+1, 3, Ng): down-dir, down-dif, up
    n_launched: jnp.ndarray  # () int32
    # scalar python defaults (valid pytree leaves) — eager jnp defaults here
    # would initialize the XLA backend at import time, which breaks
    # jax.distributed.initialize() in multi-process runs (must run first)
    n_steps: jnp.ndarray = 0        # while-loop iterations
    rad_plen: jnp.ndarray = 0.0     # (Nxr, Nyr, Ng) pathlength-weighted
    #                                 radiance (mean path = rad_plen/rad)
    lane_iters: jnp.ndarray = 0     # total lane-iterations (sum over loop
    #                                 steps of the ACTIVE batch width —
    #                                 drain compaction shrinks the batch,
    #                                 so steps*batch would overcount; this
    #                                 is the hardware-independent work
    #                                 metric of the weak-scaling record)
    absorbed: jnp.ndarray = 0.0     # (Nz, Ng) per-layer absorbed energy
    #                                 (flight kernel, domain-average flux
    #                                 runs — the direct heating-rate tally)


class _State(NamedTuple):
    # photon SoA
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray
    l: jnp.ndarray          # current layer (int32)
    ux: jnp.ndarray
    uy: jnp.ndarray
    uz: jnp.ndarray
    wsc: jnp.ndarray        # (B,) scattering/roulette weight factor
    S: jnp.ndarray          # (B, Nz) per-layer pathlength [m]
    tau: jnp.ndarray        # (B,) remaining majorant optical depth target
    nscat: jnp.ndarray      # (B,) int32
    direct: jnp.ndarray     # (B,) bool — never scattered/reflected
    alive: jnp.ndarray
    ix0: jnp.ndarray        # (B,) birth column (IPA gathers / tallies)
    iy0: jnp.ndarray
    # bookkeeping
    launched: jnp.ndarray   # () int32
    step: jnp.ndarray       # () int32
    rad: jnp.ndarray
    flux: jnp.ndarray


def _sensor_dir(cfg: SolverConfig):
    """Unit vector of radiation travelling TOWARD the sensor (upward)."""
    th = np.deg2rad(cfg.sensor_zenith)
    # sensor azimuth: position angle of the sensor from the target
    # (0 = north = +y), so travel direction components:
    ph = np.deg2rad(270.0 - cfg.sensor_azimuth)
    mu_s = float(np.cos(th))
    sx = float(np.sin(th) * np.cos(ph))
    sy = float(np.sin(th) * np.sin(ph))
    return sx, sy, mu_s


def transport(scene: SceneArrays, st: SceneStatic, cfg: SolverConfig,
              n_photon: int, key: jax.Array) -> Tallies:
    """Run the photon budget through the scene; returns raw tallies.

    Tallies are in *photon-weight* units: divide by ``n_launched`` and apply
    the spectral factors in :mod:`er3t_tpu.rtm.out` to obtain physical
    radiance/irradiance.
    """
    B = cfg.batch
    nz, ng = st.nz, st.ng
    nlev = nz + 1
    radiance = cfg.target == 'radiance'

    nxf, nyf = (st.nx, st.ny) if cfg.flux_per_column else (1, 1)
    nxr, nyr = (st.nx, st.ny)

    lx = st.nx * st.dx
    ly = st.ny * st.dy

    dz_lay = scene.z_lev[1:] - scene.z_lev[:-1]                    # (Nz,)
    # cumulative 1D profiles above each level, for sensor-path attenuation
    n_aer = scene.sig_aer.shape[1]
    sig_aer_tot = jnp.sum(scene.sig_aer, axis=1)
    sig_1d = scene.sig_ray + sig_aer_tot
    cum_sig = jnp.concatenate([jnp.cumsum((sig_1d * dz_lay)[::-1])[::-1],
                               jnp.zeros(1, _F)])                  # (Nz+1,)
    cum_abs = jnp.concatenate([jnp.cumsum((scene.kabs * dz_lay[:, None])[::-1], axis=0)[::-1],
                               jnp.zeros((1, ng), _F)])            # (Nz+1, Ng)
    # per-column cumulative 3D extinction above each 3D level (nadir path)
    dz3 = dz_lay[st.iz3l:st.iz3l + st.nz3]
    cum3d = jnp.concatenate(
        [jnp.cumsum((scene.ext3d * dz3[None, None, :])[..., ::-1], axis=-1)[..., ::-1],
         jnp.zeros((st.nx, st.ny, 1), _F)], axis=-1)               # (Nx, Ny, Nz3+1)

    ext3d_flat = scene.ext3d.reshape(-1)
    cum3d_flat = cum3d.reshape(-1)

    # packed per-layer and per-voxel tables: one wide row-fetch replaces
    # several scalar fetches; columns 4..4+Na
    # carry the per-constituent aerosol extinctions
    lay_tab = jnp.concatenate(
        [jnp.stack([scene.z_lev[:-1], scene.z_lev[1:], scene.sig_maj,
                    scene.sig_ray], axis=1), scene.sig_aer], axis=1)  # (Nz, 4+Na)
    # [ext_tot, then per 3D constituent slot s: (cf_s, ssa_s, apf_s)] — the
    # constituent driving a collision is chosen by extinction share
    # (reference: per-constituent omg/apf blocks, mca_atm.py:340-370)
    ns3 = st.ns3
    vox3 = jnp.concatenate(
        [ext3d_flat[:, None],
         jnp.stack([scene.cf3d.reshape(-1, ns3), scene.ssa3d.reshape(-1, ns3),
                    scene.apf3d.reshape(-1, ns3).astype(_F)],
                   axis=2).reshape(-1, 3 * ns3)], axis=1)  # (Nvox, 1 + 3 Ns)

    kabs_min = jnp.min(scene.kabs, axis=1)                         # (Nz,)
    n_u = scene.pt_mu.shape[1]
    n_m = scene.pt_p.shape[1]

    sx, sy, mu_s = _sensor_dir(cfg)
    nadir = abs(cfg.sensor_zenith) < 1e-3

    sin0 = jnp.sqrt(jnp.maximum(1.0 - scene.mu0 ** 2, 0.0))
    u0x = sin0 * jnp.cos(scene.phi0)
    u0y = sin0 * jnp.sin(scene.phi0)
    u0z = -scene.mu0

    z_top = scene.z_lev[-1]

    if cfg.max_events:
        max_steps = cfg.max_events
    else:
        # generous bound: budget/batch refills x events per photon
        max_steps = int(np.ceil(n_photon / B + 1) * 4 * (nz + 40))

    def col_index(x, y, ix0, iy0):
        """(ix, iy) of the 3D grid column; IPA mode pins the birth column."""
        if st.ipa:
            return ix0, iy0
        ix = jnp.floor(x / st.dx).astype(jnp.int32) % st.nx
        iy = jnp.floor(y / st.dy).astype(jnp.int32) % st.ny
        return ix, iy

    def gather3d(flat, ix, iy, l):
        k = jnp.clip(l - st.iz3l, 0, st.nz3 - 1)
        idx = (ix * st.ny + iy) * st.nz3 + k
        return jnp.take(flat, idx)

    def sfc_index(x, y):
        sxi = jnp.floor(x / lx * st.nxs).astype(jnp.int32) % st.nxs
        syi = jnp.floor(y / ly * st.nys).astype(jnp.int32) % st.nys
        return sxi, syi

    def w_full(wsc, S):
        """(B, Ng) physical weights: scattering factor x gas transmission."""
        labs = -jnp.dot(S, scene.kabs, precision=_HI,
                        preferred_element_type=_F)
        return wsc[:, None] * jnp.exp(labs)

    def sensor_trans(x, y, z, l, ix, iy, S):
        """(B, Ng) attenuation from event to TOA along the sensor direction,
        multiplied by the photon's own accumulated gas transmission."""
        zl_up = jnp.take(scene.z_lev, l + 1)
        part_sig = jnp.take(sig_1d, l) * (zl_up - z)
        part_abs = jnp.take(scene.kabs, l, axis=0) * (zl_up - z)[:, None]
        tau_sig = jnp.take(cum_sig, l + 1) + part_sig
        tau_abs = jnp.take(cum_abs, l + 1, axis=0) + part_abs
        if nadir:
            k = jnp.clip(l - st.iz3l, 0, st.nz3 - 1)
            in3 = (l >= st.iz3l) & (l < st.iz3l + st.nz3)
            z_k = jnp.take(scene.z_lev, jnp.clip(l + 1, 0, nz))
            idx_up = (ix * st.ny + iy) * (st.nz3 + 1) + k + 1
            part3 = gather3d(ext3d_flat, ix, iy, l) * (z_k - z)
            tau3 = jnp.where(in3, jnp.take(cum3d_flat, idx_up) + part3,
                             jnp.where(l >= st.iz3l + st.nz3, 0.0,
                                       jnp.take(cum3d_flat, (ix * st.ny + iy) * (st.nz3 + 1))))
        else:
            # slant path: midpoint-sampled column per 3D layer above the event
            tau3 = jnp.zeros_like(x)
            for k3 in range(st.nz3):
                lk = st.iz3l + k3
                z_lo = scene.z_lev[lk]
                z_hi = scene.z_lev[lk + 1]
                z_mid = 0.5 * (z_lo + z_hi)
                seg = jnp.clip(z_hi - jnp.maximum(z, z_lo), 0.0, z_hi - z_lo)
                xm = x + sx / mu_s * (z_mid - z)
                ym = y + sy / mu_s * (z_mid - z)
                ixm, iym = col_index(xm % lx, ym % ly, ix, iy)
                idx = (ixm * st.ny + iym) * st.nz3 + k3
                tau3 = tau3 + jnp.where(seg > 0, jnp.take(ext3d_flat, idx) * seg, 0.0)
        labs = -jnp.dot(S, scene.kabs, precision=_HI,
                        preferred_element_type=_F)
        tau_tot = (tau_sig + tau3)[:, None] / mu_s + tau_abs / mu_s
        return jnp.exp(labs - tau_tot)

    def rad_pixel(x, y, z, ix0, iy0):
        """Image pixel of an event, projected along the view ray to z=0."""
        if st.ipa:
            return ix0 * nyr + iy0
        xp = (x - sx / mu_s * z) % lx
        yp = (y - sy / mu_s * z) % ly
        ix = jnp.floor(xp / st.dx).astype(jnp.int32) % nxr
        iy = jnp.floor(yp / st.dy).astype(jnp.int32) % nyr
        return ix * nyr + iy

    def phase_eval(apf, mu, first=None):
        """P(mu) for phase row ``apf`` (0 = Rayleigh, analytic);
        nearest-bin lookup (one gather).  ``first`` selects the TMS half of
        the eval table (exact single scattering under delta-truncation)."""
        n_pf_ = scene.pt_mu.shape[0]
        row = apf if first is None else apf + jnp.where(first, n_pf_, 0)
        i0 = jnp.clip((((mu + 1.0) * 0.5 * (n_m - 1)) + 0.5).astype(jnp.int32),
                      0, n_m - 1)
        p_tab = jnp.take(scene.pt_p.reshape(-1), row * n_m + i0)
        return jnp.where(apf == 0, 0.75 * (1.0 + mu * mu), p_tab)

    def phase_sample(apf, u):
        i0 = jnp.clip((u * (n_u - 1) + 0.5).astype(jnp.int32), 0, n_u - 1)
        return jnp.take(scene.pt_mu.reshape(-1), apf * n_u + i0)

    def rotate(ux, uy, uz, mu, psi):
        """New direction at scattering cosine ``mu``, azimuth ``psi``."""
        sin_t = jnp.sqrt(jnp.maximum(1.0 - mu * mu, 0.0))
        cp, sp = jnp.cos(psi), jnp.sin(psi)
        denom = jnp.sqrt(jnp.maximum(1.0 - uz * uz, 1e-12))
        straight = jnp.abs(uz) > 0.99999
        nx_ = sin_t * (ux * uz * cp - uy * sp) / denom + ux * mu
        ny_ = sin_t * (uy * uz * cp + ux * sp) / denom + uy * mu
        nz_ = -sin_t * cp * denom + uz * mu
        # degenerate vertical incidence
        nxs_ = sin_t * cp
        nys_ = sin_t * sp
        nzs_ = mu * jnp.sign(uz)
        ux_n = jnp.where(straight, nxs_, nx_)
        uy_n = jnp.where(straight, nys_, ny_)
        uz_n = jnp.where(straight, nzs_, nz_)
        norm = jax.lax.rsqrt(ux_n ** 2 + uy_n ** 2 + uz_n ** 2)
        return ux_n * norm, uy_n * norm, uz_n * norm

    def body(state: _State) -> _State:
        k_iter = jax.random.fold_in(key, state.step)
        u = jax.random.uniform(k_iter, (B, 9), dtype=_F,
                               minval=1e-7, maxval=1.0 - 1e-7)

        # ---------------- respawn dead lanes from the budget ----------------
        dead = ~state.alive
        quota = n_photon - state.launched
        order = jnp.cumsum(dead.astype(jnp.int32))
        spawn = dead & (order <= quota)
        n_sp = jnp.sum(spawn.astype(jnp.int32))

        xs = u[:, 0] * lx
        ys = u[:, 1] * ly
        x = jnp.where(spawn, xs, state.x)
        y = jnp.where(spawn, ys, state.y)
        z = jnp.where(spawn, z_top, state.z)
        l = jnp.where(spawn, nz - 1, state.l)
        ux = jnp.where(spawn, u0x, state.ux)
        uy = jnp.where(spawn, u0y, state.uy)
        uz = jnp.where(spawn, u0z, state.uz)
        wsc = jnp.where(spawn, 1.0, state.wsc)
        S = jnp.where(spawn[:, None], 0.0, state.S)
        tau = jnp.where(spawn, -jnp.log(u[:, 2]), state.tau)
        nscat = jnp.where(spawn, 0, state.nscat)
        direct = jnp.where(spawn, True, state.direct)
        alive = state.alive | spawn
        ix0 = jnp.where(spawn, jnp.floor(x / st.dx).astype(jnp.int32) % st.nx, state.ix0)
        iy0 = jnp.where(spawn, jnp.floor(y / st.dy).astype(jnp.int32) % st.ny, state.iy0)
        launched = state.launched + n_sp

        flux = state.flux
        rad = state.rad
        # (the deterministic TOA down-direct deposit for launched photons is
        # added once after the loop — it is exactly 1 per photon)

        # ---------------- advance to next event ----------------
        lt = lay_tab[jnp.clip(l, 0, nz - 1)]          # one packed row gather
        zl_lo, zl_hi = lt[:, 0], lt[:, 1]
        sig_m = lt[:, 2]
        s_col = tau / sig_m
        going_up = uz > 0.0
        uz_safe = jnp.where(jnp.abs(uz) < 1e-7, jnp.where(going_up, 1e-7, -1e-7), uz)
        s_bound = jnp.where(going_up, (zl_hi - z) / uz_safe, (zl_lo - z) / uz_safe)
        s_bound = jnp.maximum(s_bound, 0.0)
        is_col = s_col < s_bound
        s = jnp.where(is_col, s_col, s_bound)
        s = jnp.where(alive, s, 0.0)

        x = jnp.where(st.ipa, x, (x + ux * s) % lx)
        y = jnp.where(st.ipa, y, (y + uy * s) % ly)
        z = jnp.clip(z + uz * s, 0.0, z_top)
        # pathlength bookkeeping (gas absorption): one-hot FMA into S
        S = S + jax.nn.one_hot(l, nz, dtype=_F) * s[:, None]
        tau = jnp.where(is_col, tau, tau - sig_m * s)

        ix, iy = col_index(x, y, ix0, iy0)

        # ---------------- collision handling ----------------
        in3 = (l >= st.iz3l) & (l < st.iz3l + st.nz3) & jnp.asarray(st.has_3d)
        k3 = jnp.clip(l - st.iz3l, 0, st.nz3 - 1)
        vr = vox3[(ix * st.ny + iy) * st.nz3 + k3]    # one packed row gather
        ext_c = jnp.where(in3, vr[:, 0], 0.0)
        sig_r = lt[:, 3]
        sig_ac = lt[:, 4:4 + n_aer]                   # (B, Na) per constituent
        sig_a = jnp.sum(sig_ac, axis=1)
        sig_real = sig_r + sig_a + ext_c
        accept = alive & is_col & (u[:, 3] * sig_m < sig_real)

        # channel selection: rayleigh | aerosol constituents | 3D particulate
        pick = u[:, 4] * sig_real
        ch_ray = accept & (pick < sig_r)
        ch_aer = accept & ~ch_ray & (pick < sig_r + sig_a)
        ch_cld = accept & ~ch_ray & ~ch_aer
        c_aer = jnp.clip(jnp.sum((jnp.cumsum(sig_ac, axis=1)
                                  < (pick - sig_r)[:, None]).astype(jnp.int32),
                                 axis=1), 0, n_aer - 1)
        oh_a = jax.nn.one_hot(c_aer, n_aer, dtype=_F)
        apf_a = jnp.sum(oh_a * scene.aer_apf.astype(_F)[None, :],
                        axis=1).astype(jnp.int32)
        ssa_a = jnp.sum(oh_a * scene.aer_ssa[None, :], axis=1)

        # 3D-constituent slot by extinction share: given ch_cld,
        # (pick - sig_r - sig_a)/ext_c is a fresh U[0,1) deviate
        u_c = jnp.clip((pick - sig_r - sig_a)
                       / jnp.maximum(ext_c, 1e-30), 0.0, 1.0 - 1e-7)
        slot = jnp.zeros(B, jnp.int32)
        for s_ in range(ns3 - 1):
            slot = slot + (u_c >= vr[:, 1 + 3 * s_]).astype(jnp.int32)
        ssa_sel = vr[:, 2]
        apf_sel = vr[:, 3]
        for s_ in range(1, ns3):
            m_ = slot == s_
            ssa_sel = jnp.where(m_, vr[:, 2 + 3 * s_], ssa_sel)
            apf_sel = jnp.where(m_, vr[:, 3 + 3 * s_], apf_sel)
        ssa_c = jnp.where(in3, ssa_sel, 1.0)
        apf_c = jnp.where(in3, apf_sel, 0.0).astype(jnp.int32)
        apf = jnp.where(ch_cld, apf_c, jnp.where(ch_aer, apf_a, 0))
        ssa_ev = jnp.where(ch_cld, ssa_c, jnp.where(ch_aer, ssa_a, 1.0))

        # ---------------- radiance local estimate ----------------
        if radiance:
            mu_sc = ux * sx + uy * sy + uz * mu_s
            pval = phase_eval(apf, mu_sc, first=direct)
            tsens = sensor_trans(x, y, z, l, ix, iy, S)
            contrib = (wsc * ssa_ev * pval / (4.0 * jnp.pi * mu_s))[:, None] * tsens
            pidx = rad_pixel(x, y, z, ix0, iy0)
            rad = rad.at[pidx].add(jnp.where(accept[:, None], contrib, 0.0))

        # ---------------- scattering update ----------------
        mu_new = phase_sample(apf, u[:, 5])
        psi = u[:, 6] * (2.0 * jnp.pi)
        ux_s, uy_s, uz_s = rotate(ux, uy, uz, mu_new, psi)
        ux = jnp.where(accept, ux_s, ux)
        uy = jnp.where(accept, uy_s, uy)
        uz = jnp.where(accept, uz_s, uz)
        wsc = jnp.where(accept, wsc * ssa_ev, wsc)
        nscat = nscat + accept.astype(jnp.int32)
        direct = direct & ~accept
        tau = jnp.where(is_col, -jnp.log(u[:, 7]), tau)

        # ---------------- boundary crossing ----------------
        crossed = alive & ~is_col
        l_new = jnp.where(crossed, l + jnp.where(going_up, 1, -1), l)
        hit_sfc = crossed & (l_new < 0)
        exit_toa = crossed & (l_new >= nz)

        if cfg.target != 'radiance':
            lev = jnp.clip(jnp.where(going_up, l + 1, l), 0, nz)
            ch = jnp.where(going_up, 2, jnp.where(direct, 0, 1))
            fix = ix if cfg.flux_per_column else jnp.zeros_like(ix)
            fiy = iy if cfg.flux_per_column else jnp.zeros_like(iy)
            fidx = ((fix * nyf + fiy) * nlev + lev) * 3 + ch
            wf = w_full(wsc, S)
            # tallies are packed 8 logical rows per physical 8*Ng-wide
            # row; row scatter stays row scatter
            sub = jax.nn.one_hot(fidx % 8, 8, dtype=_F)
            upd = (sub[:, :, None]
                   * jnp.where(crossed[:, None], wf, 0.0)[:, None, :])
            flux = flux.at[fidx // 8].add(upd.reshape(B, 8 * ng))

        # ---------------- surface interaction (Lambertian v1; typed BRDFs
        # handled in rtm.brdf and dispatched here) ----------------
        from .brdf import brdf_eval, brdf_sample_dir_weight
        sxi, syi = sfc_index(x, y)
        jsfc_l = scene.jsfc[sxi, syi]
        psfc_l = scene.psfc[sxi, syi]
        if radiance:
            rho_s = brdf_eval(jsfc_l, psfc_l, ux, uy, uz, sx, sy, mu_s)
            tsens_s = sensor_trans(x, y, jnp.zeros_like(z), jnp.zeros_like(l), ix, iy, S)
            c_sfc = (wsc * rho_s)[:, None] * tsens_s
            pidx_s = rad_pixel(x, y, jnp.zeros_like(z), ix0, iy0)
            rad = rad.at[pidx_s].add(jnp.where(hit_sfc[:, None], c_sfc, 0.0))

        # typed BRDF reflection (Lambertian / LSRT / Cox-Munk)
        bxd, byd, bzd, bwd = brdf_sample_dir_weight(
            jsfc_l, psfc_l, ux, uy, uz, u[:, 5], u[:, 6], u[:, 2], u[:, 4])
        ux = jnp.where(hit_sfc, bxd, ux)
        uy = jnp.where(hit_sfc, byd, uy)
        uz = jnp.where(hit_sfc, bzd, uz)
        wsc = jnp.where(hit_sfc, wsc * bwd, wsc)
        direct = direct & ~hit_sfc
        z = jnp.where(hit_sfc, 0.0, z)
        tau = jnp.where(hit_sfc, -jnp.log(u[:, 7]), tau)
        l = jnp.where(hit_sfc, 0, jnp.where(exit_toa, l, l_new))

        if cfg.target != 'radiance':
            # upward crossing AT the surface level for reflected photons:
            # the next marching step from l=0 going up first tallies level
            # 1, silently dropping the surface up-flux (f_up[0] was 0 for
            # any reflecting surface — round-4 energy-closure find); tally
            # it here with the post-reflection weight
            fidx0 = ((fix * nyf + fiy) * nlev + 0) * 3 + 2
            wf0 = w_full(wsc, S)
            sub0 = jax.nn.one_hot(fidx0 % 8, 8, dtype=_F)
            upd0 = (sub0[:, :, None]
                    * jnp.where(hit_sfc[:, None], wf0, 0.0)[:, None, :])
            flux = flux.at[fidx0 // 8].add(upd0.reshape(B, 8 * ng))

        # ---------------- termination & Russian roulette ----------------
        alive = alive & ~exit_toa & (nscat < cfg.n_scat_max) & (wsc > 0.0)
        # roulette on the best-case (least-absorbed) weight
        labs_max = -jnp.sum(S * kabs_min[None, :], axis=1)
        wmax = wsc * jnp.exp(labs_max)
        need_rr = alive & (wmax < cfg.rr_wmin)
        p_surv = jnp.clip(wmax / cfg.rr_wmin, 0.0, 1.0)
        die = need_rr & (u[:, 8] > p_surv)
        wsc = jnp.where(need_rr & ~die, wsc / jnp.maximum(p_surv, 1e-12), wsc)
        alive = alive & ~die

        return _State(x=x, y=y, z=z, l=l, ux=ux, uy=uy, uz=uz, wsc=wsc, S=S,
                      tau=tau, nscat=nscat, direct=direct, alive=alive,
                      ix0=ix0, iy0=iy0, launched=launched,
                      step=state.step + 1, rad=rad, flux=flux)

    def cond(state: _State):
        more_budget = state.launched < n_photon
        return (jnp.any(state.alive) | more_budget) & (state.step < max_steps)

    zerosB = jnp.zeros(B, _F)
    state0 = _State(
        x=zerosB, y=zerosB, z=zerosB, l=jnp.zeros(B, jnp.int32),
        ux=zerosB, uy=zerosB, uz=zerosB, wsc=zerosB,
        S=jnp.zeros((B, nz), _F), tau=zerosB,
        nscat=jnp.zeros(B, jnp.int32),
        direct=jnp.zeros(B, bool), alive=jnp.zeros(B, bool),
        ix0=jnp.zeros(B, jnp.int32), iy0=jnp.zeros(B, jnp.int32),
        launched=jnp.zeros((), jnp.int32), step=jnp.zeros((), jnp.int32),
        rad=jnp.zeros((nxr * nyr, ng), _F),
        flux=jnp.zeros((-(-(nxf * nyf * nlev * 3) // 8), 8 * ng), _F),
    )
    out = jax.lax.while_loop(cond, body, state0)
    n_rows = nxf * nyf * nlev * 3
    flux = out.flux.reshape(-1, ng)[:n_rows].reshape(nxf, nyf, nlev, 3, ng)
    if cfg.target != 'radiance':
        # TOA down-direct entry: exactly one crossing per launched photon,
        # deposited deterministically (uniform spawn ⇒ uniform expectation)
        per_col = out.launched.astype(_F) / (nxf * nyf)
        flux = flux.at[:, :, nz, 0, :].add(per_col)
    return Tallies(rad=out.rad.reshape(nxr, nyr, ng),
                   flux=flux,
                   n_launched=out.launched, n_steps=out.step,
                   lane_iters=out.step.astype(_F) * cfg.batch)


def run_transport(scene, static, cfg, n_photon, seed=0):
    """Jitted entry point."""
    fn = jax.jit(transport, static_argnums=(1, 2, 3))
    return fn(scene, static, cfg, int(n_photon), jax.random.key(seed))
