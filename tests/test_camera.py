"""All-sky (ground fisheye) camera sensor tests."""

import numpy as np
import pytest

from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.rtm.scene import build_scene
from er3t_tpu.rtm.mc import SolverConfig
from er3t_tpu.rtm.mc_flight import run_transport_flight
from er3t_tpu.rtm.out import reduce_camera_radiance


def test_camera_clear_sky_radiance():
    atm = atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_synthetic(650.0, atm)
    ab.abso_coef[:] = 0.0
    sza = 40.0
    scn, st = build_scene(atm, ab, surface=0.1, solar_zenith_angle=sza)
    cfg = SolverConfig(target='radiance', batch=1 << 12,
                       sensor_type='camera', cam_npix=16, cam_qmax=85.0)
    tal = run_transport_flight(scn, st, cfg, 150000, seed=21)
    out = reduce_camera_radiance(np.asarray(tal.rad), int(tal.n_launched),
                                 ab, np.cos(np.deg2rad(sza)),
                                 st.nx * st.dx * st.ny * st.dy, 85.0)
    rad = out['rad']
    assert rad.shape == (16, 16)
    # zenith Rayleigh sky brightness: order S * P/(4pi) * tau ~ 3e-3..1e-2
    zen = rad[8, 8]
    assert 1e-3 < zen < 2e-2
    # corners (outside the fisheye circle) are masked
    assert np.isnan(rad[0, 0])
    assert np.isfinite(rad[np.isfinite(rad)]).all()


def test_airborne_nadir_camera_sees_cloud():
    """Euler-pointed airborne camera (MCARaTS Rad_phi/the/psi + Rad_zloc):
    a down-looking camera above a half-cloudy deck sees brighter pixels on
    the cloudy side; the up-looking ground default is unchanged."""
    from er3t_tpu.pre.cld import cld_gen_hom

    atm = atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_synthetic(650.0, atm)
    cld = cld_gen_hom(nx=8, ny=8, nz=2, dx=0.5, dy=0.5, cot0=10.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    cld.extinction[4:] = 0.0   # x >= half: clear
    cld.cer[4:] = 0.0
    scn, st = build_scene(atm, ab, cld=cld, surface=0.03,
                          solar_zenith_angle=30.0)
    cfg = SolverConfig(target='radiance', batch=1 << 12,
                       sensor_type='camera', cam_npix=16, cam_qmax=60.0,
                       cam_zloc=8000.0, cam_the=180.0, cam_rmin=100.0)
    tal = run_transport_flight(scn, st, cfg, 200000, seed=4,
                               rng_impl='threefry2x32')
    img = np.asarray(tal.rad) @ ab.weight / int(tal.n_launched)
    img = img.reshape(16, 16)
    assert img.sum() > 0
    # with cam_the=180 (pointing down), the cloudy half (x < 2 km, camera at
    # domain center x=2km) maps to one half of the image; brightness contrast
    half_a, half_b = img[:8].mean(), img[8:].mean()
    assert max(half_a, half_b) > 2.0 * max(min(half_a, half_b), 1e-12)


def test_camera_fov_mask():
    """Events outside the fisheye FOV must not deposit (no edge pileup)."""
    atm = atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_synthetic(650.0, atm)
    scn, st = build_scene(atm, ab, surface=0.1, solar_zenith_angle=30.0)
    cfg = SolverConfig(target='radiance', batch=1 << 12,
                       sensor_type='camera', cam_npix=16, cam_qmax=20.0)
    tal = run_transport_flight(scn, st, cfg, 100000, seed=9,
                               rng_impl='threefry2x32')
    img = np.asarray(tal.rad) @ ab.weight / int(tal.n_launched)
    img = img.reshape(16, 16)
    # narrow-FOV zenith camera: corner pixels (outside the image circle)
    # stay empty, and the edge ring is not brighter than the center
    assert img[0, 0] == 0 and img[-1, -1] == 0
    edge = np.concatenate([img[0], img[-1], img[:, 0], img[:, -1]])
    assert edge.mean() <= img[6:10, 6:10].mean() * 2.0 + 1e-12


def test_finite_aperture():
    """Rad_apsize counterpart: a finite aperture reproduces the pinhole
    image in the mean (aperture << pixel footprint) and runs end-to-end."""
    import numpy as np
    from er3t_tpu.pre.atm import atm_atmmod
    from er3t_tpu.pre.abs import abs_synthetic
    from er3t_tpu.pre.cld import cld_gen_hom
    from er3t_tpu.rtm.scene import build_scene
    from er3t_tpu.rtm.mc import SolverConfig
    from er3t_tpu.rtm.mc_flight import run_transport_flight
    atm = atm_atmmod(np.concatenate([np.arange(0, 5.0, 0.5),
                                     np.arange(5.0, 20.1, 1.0)]))
    ab = abs_synthetic(650.0, atm, ng=2)
    cld = cld_gen_hom(nx=8, ny=8, nz=2, dx=0.5, dy=0.5, cot0=5.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=2.0)
    scn, st = build_scene(atm, ab, cld=cld, surface=0.1,
                          solar_zenith_angle=30.0)
    kw = dict(target='radiance', sensor_type='camera', cam_npix=8,
              cam_qmax=60.0, batch=1 << 12, n_scat_max=150)
    t0 = run_transport_flight(scn, st, SolverConfig(**kw), 80000, seed=3)
    t1 = run_transport_flight(scn, st, SolverConfig(**kw, cam_apsize=50.0),
                              80000, seed=3)
    m0 = float(np.asarray(t0.rad).sum() / int(t0.n_launched))
    m1 = float(np.asarray(t1.rad).sum() / int(t1.n_launched))
    assert m1 == pytest.approx(m0, rel=0.05)


def test_camera_importance_launch_unbiased():
    """cam_importance_sigma (measured variance dead end, kept as an
    exact opt-in): the 50/50 mixture launch with importance
    weights must reproduce the uniform-launch image mean within MC noise,
    and the launch weights must average to ~1."""
    from er3t_tpu.pre.cld import cld_gen_hom

    atm = atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_synthetic(650.0, atm)
    cld = cld_gen_hom(nx=8, ny=8, nz=2, dx=0.5, dy=0.5, cot0=6.0, cer0=10.0,
                      cloud_base=1.0, cloud_top=3.0)
    scn, st = build_scene(atm, ab, cld=cld, surface=0.1,
                          solar_zenith_angle=30.0)
    kw = dict(target='radiance', batch=1 << 12, sensor_type='camera',
              cam_npix=8, cam_qmax=80.0, n_scat_max=300)
    means = {}
    for sig in (0.0, 1.0):
        acc, n = 0.0, 0
        for s in range(3):
            cfg = SolverConfig(cam_importance_sigma=sig, **kw)
            tal = run_transport_flight(scn, st, cfg, 120000, seed=50 + s)
            acc += float((np.asarray(tal.rad) @ ab.weight).sum())
            n += int(tal.n_launched)
        means[sig] = acc / n
    assert means[1.0] == pytest.approx(means[0.0], rel=0.06)


def test_airborne_camera_surface_reflection():
    """A down-looking camera over a bright Lambertian surface must tally
    the direct surface-reflected signal (regression: the camera branch had
    no surface local-estimate term, so clear-pixel radiance came only from
    higher-order volume scatters).  Nadir pixel ~ alb*mu0*E/pi."""
    atm = atm_atmmod(np.linspace(0, 20, 21))
    ab = abs_synthetic(650.0, atm)
    ab.abso_coef[:] = 0.0
    alb, sza = 0.5, 30.0
    scn, st = build_scene(atm, ab, surface=alb, solar_zenith_angle=sza)
    # camera low enough that the central pixels' ground footprint stays
    # inside the 1-km periodic domain (theta<7.5 deg at 1 km -> 132 m)
    cfg = SolverConfig(target='radiance', batch=1 << 12,
                       sensor_type='camera', cam_npix=16, cam_qmax=60.0,
                       cam_zloc=1000.0, cam_the=180.0, cam_rmin=50.0)
    tal = run_transport_flight(scn, st, cfg, 200_000, seed=12)
    mu0 = np.cos(np.deg2rad(sza))
    out = reduce_camera_radiance(np.asarray(tal.rad), int(tal.n_launched),
                                 ab, mu0, st.nx * st.dx * st.ny * st.dy,
                                 60.0)
    rad = out['rad']
    toa = out['toa']
    # analytic Lambertian ground radiance (Rayleigh adds a small haze term)
    expect = alb * mu0 * toa / np.pi
    nadir = np.nanmean(rad[7:9, 7:9])
    assert nadir == pytest.approx(expect, rel=0.3)
    assert nadir > 0.5 * expect     # was ~0 without the surface term
