"""High-level solver driver — the ``mcarats_ng`` equivalent.

The reference's front door (/root/reference/er3t/rtm/mca/mcarats.py:62-231)
builds Nrun x Ng input files and fans processes over CPUs; here a single
:func:`solve` call builds a device scene, runs Nrun independent transport
passes (differing only by RNG stream), and reduces tallies to physical units
with mean/std over runs — the reference's MC-noise protocol
(mcarats.py:134, mca_out.py:394-397).

Spectral integration is *correlated* by default: each trajectory carries all
Ng g-point weights (see er3t_tpu.rtm.mc).  ``spectral='independent'``
reproduces the reference's per-g independent sampling (Ng separate passes
with photons distributed by g weight, mcarats.py:553-565).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from . import mc, out
from .scene import build_scene

__all__ = ['solve', 'Result', 'distribute_photon']


def distribute_photon(n_photon, weights, base_ratio=0.05):
    """Photon split over g-points by k-distribution weight with a floor
    (reference: mcarats.py:553-565)."""
    weights = np.asarray(weights, dtype=np.float64)
    nd = weights.size
    dist = (n_photon * (1 - base_ratio) * weights).astype(np.int64) \
        + int(n_photon * base_ratio / nd)
    if n_photon >= nd:
        # integer truncation of the 5% floor can zero out weak g-points at
        # small budgets; a 0-photon pass has no estimate at all (its
        # g-weight would multiply a silent zero), so guarantee >=1 each,
        # funded by the heaviest bins
        while (dist == 0).any():
            dist[dist == 0] = 1
            excess = int(dist.sum() - n_photon)
            for _ in range(max(excess, 0)):
                dist[np.argmax(dist)] -= 1
    diff = int(n_photon - dist.sum())
    if diff >= 0:
        dist[np.argmin(weights)] += diff
    else:
        dist[np.argmax(weights)] += diff
    return dist


@dataclasses.dataclass
class Result:
    """Physical outputs with per-run statistics.

    ``runs`` holds every run's reduced fields when solve(mode='all') was
    requested (the reference's ``mca_out_ng(mode='all')``,
    mca_out.py:136-233) — post-hoc noise analysis (bootstrap, convergence
    studies) can then be re-done from a saved artifact; empty under the
    default mode='mean'."""
    target: str
    data: dict                  # mean fields
    std: dict                   # std fields
    toa: float
    n_photon: float
    n_run: int
    n_photon_effective: float = 0.0   # photons actually launched (can fall
    #                                   short of n_photon*n_run when chunks
    #                                   fail and are skipped — see
    #                                   _single_run's fault handling; fields
    #                                   are normalized by the effective count)
    runs: list = dataclasses.field(default_factory=list)  # per-run fields
    #                                   (mode='all'), one dict per run

    def __getitem__(self, k):
        return self.data[k]

    def save_h5(self, fname, compression='gzip'):
        """Dump results to HDF5 (the reference's mca_out_ng output format:
        gzip'd datasets per field + run metadata, mca_out.py:209-233).
        Per-run fields (mode='all') round-trip via ``run_NN/`` groups."""
        import h5py
        with h5py.File(fname, 'w') as f:
            for group, fields in (('', self.data), ('', self.std)):
                for k, v in fields.items():
                    arr = np.asarray(v)
                    if arr.ndim > 0:
                        f.create_dataset(k, data=arr, compression=compression)
                    else:
                        f[k] = arr
            for r, fields in enumerate(self.runs):
                grp = f.create_group(f'run_{r:02d}')
                for k, v in fields.items():
                    arr = np.asarray(v)
                    if arr.ndim > 0:
                        grp.create_dataset(k, data=arr,
                                           compression=compression)
                    else:
                        grp[k] = arr
            f.attrs['target'] = self.target
            f.attrs['toa'] = self.toa
            f.attrs['n_photon'] = self.n_photon
            f.attrs['n_run'] = self.n_run
            f.attrs['n_photon_effective'] = self.n_photon_effective

    @classmethod
    def load_h5(cls, fname):
        import h5py
        with h5py.File(fname, 'r') as f:
            data = {k: f[k][...] for k in f
                    if not k.endswith('_std') and not k.startswith('run_')}
            std = {k: f[k][...] for k in f if k.endswith('_std')}
            runs = [{k: f[name][k][...] for k in f[name]}
                    for name in sorted(f) if name.startswith('run_')]
            return cls(target=str(f.attrs['target']), data=data, std=std,
                       toa=float(f.attrs['toa']),
                       n_photon=float(f.attrs['n_photon']),
                       n_run=int(f.attrs['n_run']),
                       n_photon_effective=float(
                           f.attrs.get('n_photon_effective', 0.0)),
                       runs=runs)


def _single_run(scene, static, cfg, n_photon, seed, chunk=4_000_000,
                mesh=None, flux_w=None, rad_w=None):
    """One independent MC pass, split into bounded device calls.

    Chunking keeps each jitted while-loop execution short (tens of seconds)
    and gives natural progress granularity; chunks differ only by RNG
    stream.
    Both targets default to the flight kernel (er3t_tpu.rtm.mc_flight);
    SolverConfig.flux_engine='marching' selects the event-marching kernel
    (the bitwise reference path).

    ``mesh``: a jax.sharding.Mesh with ('x', 'b') axes routes the run to the
    dist layer — x-slab domain decomposition with photon migration when the
    'x' axis is >1 and the config supports it (er3t_tpu.dist.decomp), pure
    photon parallelism otherwise (er3t_tpu.dist.photon; scene replication is
    exactly the reference's MPI semantics, mca_run.py:110-113 — every
    process holds the full mca_atm_3d.bin).

    Fault handling (the reference's process model loses one output file per
    crashed run and run_check reports it, mcarats.py:471-483): each chunk is
    retried once with a fresh RNG stream; a chunk that fails twice is
    skipped and its photons recorded as a deficit.  Tallies stay unbiased —
    the caller normalizes by the returned *actually launched* count.
    """
    from .mc_flight import run_transport_flight
    use_flight = cfg.target == 'radiance' or cfg.flux_engine == 'flight'
    if mesh is not None:
        if dict(mesh.shape).get('x', 1) > 1:
            from ..dist.decomp import transport_decomp

            def runner(scene, static, cfg, n_c, seed):
                return transport_decomp(scene, static, cfg, n_c, mesh,
                                        seed=seed, flux_w=flux_w,
                                        rad_w=rad_w)
        else:
            from ..dist.photon import transport_photon_parallel

            def runner(scene, static, cfg, n_c, seed):
                return transport_photon_parallel(scene, static, cfg, n_c,
                                                 mesh, seed=seed,
                                                 flux_w=flux_w, rad_w=rad_w)
    elif use_flight:
        def runner(scene, static, cfg, n_c, seed):
            return run_transport_flight(scene, static, cfg, n_c, seed=seed,
                                        flux_w=flux_w, rad_w=rad_w)
    else:
        runner = mc.run_transport
    rad = flux = rad_pl = absd = None
    n_total = 0
    n_failed = 0
    remaining = int(n_photon)
    i = 0
    while remaining > 0:
        n_c = min(remaining, chunk)
        tal = None
        for attempt in range(2):
            try:
                tal = runner(scene, static, cfg, n_c,
                             seed=seed + 7919 * i + 104729 * attempt)
                # materialize INSIDE the try: a device fault often
                # surfaces at fetch time, not dispatch time
                tal = tal._replace(rad=np.asarray(tal.rad),
                                   flux=np.asarray(tal.flux),
                                   rad_plen=np.asarray(tal.rad_plen),
                                   absorbed=np.asarray(tal.absorbed),
                                   n_launched=int(tal.n_launched))
                break
            except Exception as e:
                from ..util.logger import get_logger
                get_logger().warning(
                    'solve: chunk %d (%.3g photons) attempt %d failed: %s',
                    i, n_c, attempt, e)
                tal = None
        if tal is None:
            n_failed += n_c
        else:
            rad = tal.rad if rad is None else rad + tal.rad
            flux = tal.flux if flux is None else flux + tal.flux
            absd = tal.absorbed if absd is None else absd + tal.absorbed
            if cfg.pathlength:
                rad_pl = tal.rad_plen if rad_pl is None \
                    else rad_pl + tal.rad_plen
            n_total += tal.n_launched
        remaining -= n_c
        i += 1
    if rad is None:
        raise RuntimeError(
            f'every chunk of the run failed ({n_failed:g} photons lost)')
    if n_failed:
        from ..util.logger import get_logger
        get_logger().warning(
            'solve: run completed with a deficit of %.3g photons '
            '(%.3g launched); results are normalized by the launched count',
            n_failed, n_total)
    return rad, flux, n_total, rad_pl, absd


def solve(atm=None, abs_coef=None, cld=None, pha=None, aer_1ds=(), aer_3ds=(),
          surface=0.03, target='radiance', solver='3d', p3d_order=1,
          solar_zenith_angle=30.0, solar_azimuth_angle=0.0,
          sensor_zenith_angle=0.0, sensor_azimuth_angle=0.0,
          sensor_type='satellite', camera=None,
          photons=1e6, n_run=3, date=None, seed=0, batch=None,
          spectral='correlated', flux_per_column=None, chunk=4_000_000,
          forward_trunc_deg=None, tile_size=0, flux_engine='flight',
          flux_kcross=4, cf_dtau=0.0, pathlength=False, split_wmax=0.0,
          rr_wmin=0.1, n_scat_max=2000, mesh=None, diffusion=0,
          qmc_launch=False, pfpeak=None, mode='mean'):
    """Run a full radiative-transfer simulation — the single front door.

    Parameters mirror ``mcarats_ng`` (reference mcarats.py:62-231).  Every
    MCARaTS namelist knob maps to a parameter here or a stated non-goal:

    ============================  =======================================
    MCARaTS namelist              solve() parameter
    ============================  =======================================
    Wld_mtarget=1 (flux/HR)       target='flux' | 'heating_rate'
    Wld_mtarget=2 (radiance)      target='radiance'
    Wld_mtarget=3 (quasi-rad)     er3t_tpu.rtm.quasi.quasi_radiance
    solver 0/1/2 (3D/P3D/IPA)     solver='3d' | 'p3d' | 'ipa'
    (P-3D low-order count)        p3d_order (scatters before column pinning)
    Src_the/phi                   solar_zenith_angle/solar_azimuth_angle
    Rad_the/phi (satellite)       sensor_zenith_angle/sensor_azimuth_angle
    Rad_mrkind=1 + Rad_*          sensor_type='camera', camera=dict(
                                  xpos, ypos, zloc, phi, the, psi, qmax,
                                  npix, apsize) — fisheye; apsize>0 =
                                  finite aperture (disk-averaged radiance)
    Rad_mplen                     pathlength=True (adds 'plen' output)
    Rad_cf_* / Flx_cf_dtau        cf_dtau (collision forcing threshold)
    Atm_mcs_* (super-voxels)      tile_size (per-tile majorants)
    Pho_wmin                      rr_wmin (Russian-roulette window)
    Pho_wmax/wfac                 split_wmax (weight-window splitting)
    Pho_pfpeak                    pfpeak (clamp multiple-scattering local-
                                  estimate phase values at this peak, clipped
                                  energy redistributed — see build_scene)
    Sca_nchi/qtfmax               forward_trunc_deg (delta truncation + TMS)
    Flx_nxb/nyb                   flux_per_column (per-column vs average)
    Flx_diff0/1, Rad_difr0/1      er3t_tpu.rtm.out smoothing (diffusion=)
    (no MCARaTS counterpart)      qmc_launch=True — stratified-jitter launch
                                  (per-pixel launch counts +-1; large win for
                                  surface-dominated nadir scenes, neutral for
                                  slant-sun scenes)
    Nrun statistics               n_run (per-run mean/std)
    photon fan-out / MPI          mesh= (jax.sharding.Mesh with ('x','b')
                                  axes: 'x'>1 = x-slab domain decomposition
                                  with photon migration, else photon-
                                  parallel psum)
    g-point fan-out               spectral='correlated' (all g per photon)
                                  | 'independent' (reference protocol)
    ============================  =======================================

    Returns a :class:`Result`.  ``mode='all'`` additionally retains every
    run's reduced fields on ``Result.runs`` (mca_out_ng mode='all' twin).
    """
    if mode not in ('mean', 'all'):
        raise ValueError(f"mode must be 'mean' or 'all'; got {mode!r}")
    if atm is None or abs_coef is None:
        raise ValueError('atm and abs_coef are required')
    target = {'f': 'flux', 'flux': 'flux', 'irradiance': 'flux',
              'rad': 'radiance', 'radiance': 'radiance',
              'hr': 'heating_rate', 'heating rate': 'heating_rate',
              'heating_rate': 'heating_rate'}[target.lower()]
    solver = solver.lower()
    if solver not in ('3d', 'p3d', 'ipa', '1d'):
        raise ValueError(f"solver must be '3d', 'p3d' or 'ipa'; got {solver!r}")
    ipa = solver in ('ipa', '1d')

    scene, static = build_scene(
        atm, abs_coef, cld=cld, pha=pha, aer_1ds=aer_1ds, aer_3ds=aer_3ds,
        surface=surface, solar_zenith_angle=solar_zenith_angle,
        solar_azimuth_angle=solar_azimuth_angle, ipa=ipa,
        forward_trunc_deg=forward_trunc_deg, pfpeak=pfpeak)

    if batch is None:
        batch = 1 << 17 if jax.default_backend() != 'cpu' else 1 << 14
    if flux_per_column is None:
        # per-column tallies by default on 3D scenes — except heating rate,
        # whose direct absorbed-energy tally is domain-average
        flux_per_column = static.has_3d and target != 'heating_rate'
    cam = dict(xpos=0.5, ypos=0.5, zloc=0.0, phi=0.0, the=0.0, psi=0.0,
               qmax=89.0, npix=64, apsize=0.0)
    if camera:
        unknown = set(camera) - set(cam)
        if unknown:
            raise ValueError(f'unknown camera parameter(s) {sorted(unknown)}; '
                             f'valid keys: {sorted(cam)}')
        cam.update(camera)
        sensor_type = 'camera'
    cfg = mc.SolverConfig(
        target='radiance' if target == 'radiance' else 'flux',
        batch=int(batch),
        sensor_zenith=float(sensor_zenith_angle),
        sensor_azimuth=float(sensor_azimuth_angle),
        flux_per_column=bool(flux_per_column),
        tile_size=int(tile_size),
        p3d_order=int(p3d_order) if solver == 'p3d' else 0,
        cf_dtau=float(cf_dtau),
        pathlength=bool(pathlength),
        sensor_type=sensor_type,
        flux_engine=flux_engine,
        flux_kcross=int(flux_kcross),
        split_wmax=float(split_wmax),
        rr_wmin=float(rr_wmin),
        n_scat_max=int(n_scat_max),
        cam_xpos=float(cam['xpos']), cam_ypos=float(cam['ypos']),
        cam_zloc=float(cam['zloc']), cam_phi=float(cam['phi']),
        cam_the=float(cam['the']), cam_psi=float(cam['psi']),
        cam_qmax=float(cam['qmax']), cam_npix=int(cam['npix']),
        cam_apsize=float(cam['apsize']),
        qmc_launch=bool(qmc_launch),
    )

    mu0 = float(np.cos(np.deg2rad(solar_zenith_angle)))
    n_photon = int(photons)

    # per-column flux tallies are spectrally contracted IN-KERNEL (one
    # scalar per crossing instead of an (Ng,)-wide row) — exactly equal to
    # the post-hoc contraction (out.spectral_factors chain)
    flux_w_arr = None
    if (target != 'radiance' and flux_per_column and flux_kcross > 0
            and flux_engine == 'flight'):
        flux_w_arr, _ = out.spectral_factors(abs_coef, date=date,
                                             nz_out=static.nz + 1)
    # radiance image deposits are likewise contracted in-kernel (scalar
    # scatters instead of (Ng,)-row scatters) whenever the per-g
    # image is not needed downstream (pathlength ratios use a different
    # contraction)
    rad_w_arr = None
    if target == 'radiance' and not pathlength and spectral == 'correlated':
        f, _ = out.spectral_factors(abs_coef, date=date, nz_out=1)
        rad_w_arr = f[0]

    if qmc_launch and target != 'radiance' and flux_engine == 'marching':
        import warnings
        warnings.warn('qmc_launch only affects the flight kernel; '
                      "flux_engine='marching' launches uniformly",
                      stacklevel=2)

    per_run = []
    n_eff = 0
    for r in range(n_run):
        if spectral == 'correlated':
            rad_t, flux_t, n_l, rad_pl, absd = _single_run(
                scene, static, cfg, n_photon, seed + 1000003 * r,
                chunk=chunk, mesh=mesh, flux_w=flux_w_arr, rad_w=rad_w_arr)
            n_eff += n_l
            if target == 'radiance' and sensor_type == 'camera':
                area = (static.nx * static.dx) * (static.ny * static.dy)
                red = out.reduce_camera_radiance(
                    rad_t, n_l, abs_coef, mu0, domain_area_m2=area,
                    qmax_deg=cfg.cam_qmax, date=date,
                    precontracted=rad_w_arr is not None)
                red.pop('solid_angle', None)
            elif target == 'radiance':
                red = out.reduce_radiance(rad_t, n_l, abs_coef, mu0, date=date,
                                          precontracted=rad_w_arr is not None)
            else:
                red = out.reduce_flux(flux_t, n_l, abs_coef, mu0, date=date,
                                      precontracted=flux_w_arr is not None)
                if (target == 'heating_rate' and absd is not None
                        and np.ndim(absd) == 2 and np.asarray(absd).size > 1):
                    # direct absorbed-energy estimator (Flx_mhrt role) —
                    # exact by construction; noise parity with the flight
                    # engine's analytic flux differencing
                    red['hr'] = out.heating_rate_from_absorbed(
                        absd, n_l, abs_coef, mu0, atm, date=date)
            if pathlength and target == 'radiance':
                with np.errstate(invalid='ignore', divide='ignore'):
                    w = abs_coef.weight
                    red['plen'] = np.where(rad_t @ w > 0,
                                           (rad_pl @ w) / np.maximum(
                                               rad_t @ w, 1e-30), 0.0)
        elif spectral == 'independent':
            red, n_l = _independent_g_run(scene, static, cfg, atm, abs_coef,
                                          target, n_photon, mu0, date,
                                          seed + 1000 * r, chunk=chunk,
                                          mesh=mesh)
            n_eff += n_l
        else:
            raise ValueError(spectral)
        per_run.append(red)

    if target == 'heating_rate':
        # flux-divergence fallback (marching engine / independent
        # protocol): derive hr PER RUN so std and mode='all' carry
        # 'hr'/'hr_std' exactly like the direct-tally path does
        for p in per_run:
            if 'hr' not in p:
                p['hr'] = out.heating_rate(p, atm)

    keys = [k for k in per_run[0] if k != 'toa']
    data = {k: np.mean([p[k] for p in per_run], axis=0) for k in keys}
    std = {k + '_std': np.std([p[k] for p in per_run], axis=0) for k in keys}
    toa = per_run[0]['toa']

    if diffusion > 0:
        # numerical-diffusion smoothing of per-column fields (MCARaTS
        # Flx_diff0/1 / Rad_difr0/1 role)
        for k in list(data):
            arr = np.asarray(data[k])
            if arr.ndim >= 2 and arr.shape[0] > 1 and arr.shape[1] > 1:
                data[k] = out.smooth_diffusion(arr, diffusion)

    return Result(target=target, data=data, std=std, toa=toa,
                  n_photon=photons, n_run=n_run, n_photon_effective=n_eff,
                  runs=(per_run if mode == 'all' else []))


def _independent_g_run(scene, static, cfg, atm, abs_coef, target,
                       n_photon, mu0, date, seed, chunk=4_000_000, mesh=None):
    """Reference-protocol spectral sampling: one pass per g-point with the
    photon budget distributed by g weight.  ``mesh``/``chunk`` thread through
    to _single_run so the reference-protocol mode scales out and bounds
    device-call length exactly like the correlated mode.

    Per-g passes run ng=1, so the in-kernel scalar contraction (unit
    weights) is trivially exact and halves the deposit-scatter cost the
    correlated path already avoids (VERDICT r4 item 8): a (B, 1) tally row
    pads to 128 lanes while the contracted scalar does not.  Pathlength
    statistics (``cfg.pathlength``) are carried per g exactly like the
    correlated mode (rad_w is incompatible with pathlength in-kernel, so
    those runs keep the 1-wide rows)."""
    import dataclasses as _dc
    ng = abs_coef.ng
    dist = distribute_photon(n_photon, abs_coef.weight)
    if (dist <= 0).any():
        raise ValueError(
            f'independent-protocol runs need photons >= ng ({ng}) so every '
            f'g-point gets a non-empty pass; got {n_photon}')
    # unit-weight in-kernel contraction: exact for ng=1 (tally unchanged,
    # deposit becomes a scalar scatter)
    rad_w1 = (np.ones(1, np.float32)
              if target == 'radiance' and not cfg.pathlength else None)
    flux_w1 = (np.ones((static.nz + 1, 1), np.float32)
               if (target != 'radiance' and cfg.flux_per_column
                   and cfg.flux_kcross > 0 and cfg.flux_engine == 'flight')
               else None)
    acc_rad = None
    acc_flux = None
    acc_pl = None
    n_total = 0
    for g in range(ng):
        scene_g = scene._replace(kabs=scene.kabs[:, g:g + 1])
        static_g = _dc.replace(static, ng=1)
        rad_t, flux_t, n_l, rad_pl, _ = _single_run(
            scene_g, static_g, cfg, int(dist[g]), seed + g,
            chunk=chunk, mesh=mesh, flux_w=flux_w1, rad_w=rad_w1)
        n_total += n_l
        # scale per-g tallies to the common budget normalization
        wsc = 1.0 / max(n_l, 1)
        if acc_rad is None:
            acc_rad = np.zeros(rad_t.shape[:2] + (ng,), np.float64)
            acc_flux = np.zeros(flux_t.shape[:4] + (ng,), np.float64)
        acc_rad[..., g] = rad_t[..., 0] * wsc
        acc_flux[..., g] = flux_t[..., 0] * wsc
        if cfg.pathlength and target == 'radiance':
            if acc_pl is None:
                acc_pl = np.zeros_like(acc_rad)
            acc_pl[..., g] = rad_pl[..., 0] * wsc
    if target == 'radiance':
        if cfg.sensor_type == 'camera':
            # camera images need the camera normalization (domain area +
            # per-pixel solid angle + FOV mask), exactly as the correlated
            # path applies it — the satellite reduction would be wrong by
            # nx*ny with no 1/dOmega factor
            area = (static.nx * static.dx) * (static.ny * static.dy)
            red = out.reduce_camera_radiance(
                acc_rad, 1, abs_coef, mu0, domain_area_m2=area,
                qmax_deg=cfg.cam_qmax, date=date)
            red.pop('solid_angle', None)
        else:
            red = out.reduce_radiance(acc_rad, 1, abs_coef, mu0, date=date)
        if cfg.pathlength:
            w = abs_coef.weight
            with np.errstate(invalid='ignore', divide='ignore'):
                red['plen'] = np.where(acc_rad @ w > 0,
                                       (acc_pl @ w) / np.maximum(
                                           acc_rad @ w, 1e-30), 0.0)
        return red, n_total
    return out.reduce_flux(acc_flux, 1, abs_coef, mu0, date=date), n_total
