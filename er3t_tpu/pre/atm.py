"""1D atmospheric profiles.

Re-design of the reference's ``atm_atmmod``
(/root/reference/er3t/pre/atm/atm_atmmod.py:17-240): build level/layer profiles
of pressure, temperature and gas number densities on a user altitude grid.

Differences from the reference:

* The base profile is *generated in-framework* from the analytic
  U.S. Standard Atmosphere 1976 plus published trace-gas climatology —
  no ``afglus.dat`` download is required.  An AFGL-format ``.dat`` file
  (9 columns: z, p, T, air, o3, o2, h2o, co2, no2 — the format read at
  /root/reference/er3t/pre/atm/atm_atmmod.py:158-178) is still accepted.
* Output is a lightweight :class:`Atmosphere` dataclass of numpy arrays
  (converted to JAX arrays at scene-build time), not a pickle-backed object.
* Pressure interpolation to user levels uses the barometric relation per
  sub-layer (reference: er3t/pre/atm/util.py:124-219), implemented directly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..physics import constants as c

__all__ = ['Atmosphere', 'us_standard_profile', 'atm_atmmod']

GASES = ('o3', 'o2', 'h2o', 'co2', 'no2', 'ch4')


# ----------------------------------------------------------------------------
# U.S. Standard Atmosphere 1976 (analytic up to 86 km; tabulated above)
# ----------------------------------------------------------------------------

# (base geopotential altitude [km'], lapse rate [K/km'])
_USSA_LAYERS = [
    (0.0, -6.5),
    (11.0, 0.0),
    (20.0, 1.0),
    (32.0, 2.8),
    (47.0, 0.0),
    (51.0, -2.8),
    (71.0, -2.0),
    (84.852, 0.0),
]
_R_EARTH = 6356.766       # km, USSA76 convention
_G0 = 9.80665             # m/s^2
_M_AIR = 28.9644e-3       # kg/mol, USSA76 value
_GMR = _G0 * _M_AIR / 8.31432 * 1e3  # K/km'


def _ussa_pt(z_km: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pressure [hPa] and temperature [K] of USSA76 at geometric altitude."""
    z = np.asarray(z_km, dtype=np.float64)
    h = z * _R_EARTH / (_R_EARTH + z)  # geopotential altitude

    # precompute layer-base T and p
    t_base = [288.15]
    p_base = [1013.25]
    for i in range(1, len(_USSA_LAYERS)):
        h0, lr = _USSA_LAYERS[i - 1]
        h1 = _USSA_LAYERS[i][0]
        t0, p0 = t_base[-1], p_base[-1]
        t1 = t0 + lr * (h1 - h0)
        if abs(lr) < 1e-12:
            p1 = p0 * np.exp(-_GMR * (h1 - h0) / t0)
        else:
            p1 = p0 * (t0 / t1) ** (_GMR / lr)
        t_base.append(t1)
        p_base.append(p1)

    temp = np.empty_like(h)
    pres = np.empty_like(h)
    for i, (h0, lr) in enumerate(_USSA_LAYERS):
        h1 = _USSA_LAYERS[i + 1][0] if i + 1 < len(_USSA_LAYERS) else 1e9
        sel = (h >= h0) & (h < h1)
        if not sel.any():
            continue
        t0, p0 = t_base[i], p_base[i]
        dh = h[sel] - h0
        temp[sel] = t0 + lr * dh
        if abs(lr) < 1e-12:
            pres[sel] = p0 * np.exp(-_GMR * dh / t0)
        else:
            pres[sel] = p0 * (t0 / temp[sel]) ** (_GMR / lr)
    return pres, temp


# upper atmosphere (86-120 km geometric), USSA76 tabulated values
_UPPER_Z = np.array([86.0, 90.0, 95.0, 100.0, 110.0, 120.0])
_UPPER_T = np.array([186.87, 186.87, 188.42, 195.08, 240.00, 360.00])
_UPPER_P = np.array([3.7338e-3, 1.8359e-3, 7.5966e-4, 3.2011e-4, 7.1042e-5, 2.5382e-5])


# ----------------------------------------------------------------------------
# trace-gas climatology (midlatitude / U.S. standard; published values)
# ----------------------------------------------------------------------------

# ozone number density [cm^-3] vs altitude [km]; midlatitude profile with a
# ~22 km peak, normalized below to a 345 DU column (U.S. standard).
_O3_Z = np.array([0, 2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26, 28, 30,
                  32, 34, 36, 38, 40, 45, 50, 55, 60, 70, 80, 100, 120], dtype=np.float64)
_O3_N = np.array([6.8e11, 6.3e11, 5.8e11, 5.7e11, 6.5e11, 1.1e12, 1.7e12, 2.4e12,
                  3.2e12, 4.0e12, 4.5e12, 4.7e12, 4.5e12, 4.0e12, 3.3e12, 2.6e12,
                  2.0e12, 1.5e12, 1.1e12, 7.6e11, 5.3e11, 2.2e11, 8.6e10, 3.1e10,
                  1.2e10, 1.5e9, 1.5e8, 1.0e6, 1.0e4], dtype=np.float64)
_O3_COLUMN_DU = 345.0
_DU = 2.6867811e16  # molecules / cm^2 per Dobson unit

# water vapor volume mixing ratio: exponential troposphere (scale height 2 km)
# with a 4 ppmv stratospheric floor; surface value tuned to ~1.4 cm
# precipitable water (U.S. standard).
_H2O_VMR0 = 9.4e-3
_H2O_SCALE_KM = 2.0
_H2O_STRAT_VMR = 4.0e-6

# NO2: small stratospheric layer (peak ~3e9 cm^-3 near 27 km)
_NO2_Z = np.array([0, 5, 10, 15, 20, 25, 27, 30, 35, 40, 50, 120], dtype=np.float64)
_NO2_N = np.array([1.0e9, 4.0e8, 1.5e8, 2.0e8, 1.0e9, 2.6e9, 3.0e9, 2.5e9,
                   1.2e9, 4.0e8, 4.0e7, 1.0e2], dtype=np.float64)

# CH4 volume mixing ratio: 1.70 ppmv well-mixed troposphere, declining above
# (cf. the tabulated AFGL profile used at /root/reference/er3t/pre/atm/util.py:219-259)
_CH4_Z = np.array([0, 6, 10, 15, 20, 25, 30, 35, 40, 45, 60, 120], dtype=np.float64)
_CH4_VMR = np.array([1.70e-6, 1.70e-6, 1.68e-6, 1.60e-6, 1.42e-6, 1.06e-6,
                     1.02e-6, 8.5e-7, 7.9e-7, 6.0e-7, 1.5e-7, 0.0], dtype=np.float64)

_CO2_VMR = 330.0e-6   # AFGL-era value, for parity with the reference database
_O2_VMR = 0.2095


def us_standard_profile(z_km: np.ndarray) -> dict[str, np.ndarray]:
    """Generate the base atmosphere (AFGL-US-standard equivalent) at ``z_km``.

    Returns a dict with keys altitude [km], pressure [hPa], temperature [K],
    air [cm^-3], and gas number densities [cm^-3] for o3/o2/h2o/co2/no2/ch4.
    """
    z = np.asarray(z_km, dtype=np.float64)
    lo = z < 86.0
    pres = np.empty_like(z)
    temp = np.empty_like(z)
    if lo.any():
        pres[lo], temp[lo] = _ussa_pt(z[lo])
    if (~lo).any():
        temp[~lo] = np.interp(z[~lo], _UPPER_Z, _UPPER_T)
        pres[~lo] = np.exp(np.interp(z[~lo], _UPPER_Z, np.log(_UPPER_P)))

    air = c.ND_FACTOR * pres / temp  # cm^-3

    # ozone, normalized to the standard column
    o3 = np.exp(np.interp(z, _O3_Z, np.log(_O3_N)))
    zf = np.linspace(0.0, 120.0, 4801)
    o3f = np.exp(np.interp(zf, _O3_Z, np.log(_O3_N)))
    col = np.trapezoid(o3f, zf * 1e5)  # cm^-2
    o3 *= _O3_COLUMN_DU * _DU / col

    h2o_vmr = np.maximum(_H2O_VMR0 * np.exp(-z / _H2O_SCALE_KM), _H2O_STRAT_VMR)
    h2o = h2o_vmr * air

    no2 = np.exp(np.interp(z, _NO2_Z, np.log(_NO2_N)))
    ch4 = np.interp(z, _CH4_Z, _CH4_VMR) * air

    return {
        'altitude': z,
        'pressure': pres,
        'temperature': temp,
        'air': air,
        'o3': o3,
        'o2': _O2_VMR * air,
        'h2o': h2o,
        'co2': _CO2_VMR * air,
        'no2': no2,
        'ch4': ch4,
    }


# ----------------------------------------------------------------------------
# barometric pressure interpolation
# (reference behaviour: er3t/pre/atm/util.py:124-180 — local exponential fit)
# ----------------------------------------------------------------------------

def interp_pres_from_alt_temp(pres, alt, temp, alt_new, temp_new):
    """Interpolate pressure to new altitudes with the barometric relation.

    For each target altitude, find the nearest source level and extrapolate
    with p = p_ref * exp(-a * (z - z_ref) / T), where the decay coefficient
    ``a`` is estimated from the local source-profile slope.
    """
    order = np.argsort(alt)
    h, p, t = (np.asarray(v, dtype=np.float64)[order] for v in (alt, pres, temp))
    hn = np.asarray(alt_new, dtype=np.float64)
    tn = np.asarray(temp_new, dtype=np.float64)

    a_mid = 0.5 * (t[1:] + t[:-1]) / (h[:-1] - h[1:]) * np.log(p[1:] / p[:-1])
    z_mid = 0.5 * (h[1:] + h[:-1])
    an = np.interp(hn, z_mid, a_mid)

    idx = np.abs(hn[:, None] - h[None, :]).argmin(axis=1)
    return p[idx] * np.exp(-an * (hn - h[idx]) / tn)


# ----------------------------------------------------------------------------
# Atmosphere object
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class _Profile:
    """Per-level or per-layer profile arrays (numpy, float64)."""
    altitude: np.ndarray          # km
    pressure: np.ndarray          # hPa
    temperature: np.ndarray       # K
    o3: np.ndarray                # cm^-3
    o2: np.ndarray
    h2o: np.ndarray
    co2: np.ndarray
    no2: np.ndarray
    ch4: np.ndarray
    factor: np.ndarray            # air number density [cm^-3]
    thickness: np.ndarray | None = None  # km (layers only)

    def gas(self, name: str) -> np.ndarray:
        return getattr(self, name)


@dataclasses.dataclass
class Atmosphere:
    """1D atmosphere on a user level grid: ``lev`` (edges) and ``lay`` (centres)."""
    lev: _Profile
    lay: _Profile
    lat: float = 30.0

    @property
    def nz(self) -> int:
        return self.lay.altitude.size


def atm_atmmod(levels: np.ndarray, fname_atmmod: str | None = None,
               lat: float = 30.0) -> Atmosphere:
    """Build an :class:`Atmosphere` on altitude ``levels`` [km].

    Mirrors the lifecycle of the reference class (profile -> sort -> mixing
    ratio -> interpolate to levels/layers -> number density;
    /root/reference/er3t/pre/atm/atm_atmmod.py:115-240) without pickle caching:
    the computation is cheap enough to repeat.
    """
    levels = np.asarray(levels, dtype=np.float64)
    if levels.ndim != 1 or levels.size < 2 or np.any(np.diff(levels) <= 0):
        raise ValueError('levels must be a 1D strictly-increasing array [km]')
    layers = 0.5 * (levels[1:] + levels[:-1])

    if fname_atmmod is None:
        # analytic base on a fine grid covering the requested range
        zmax = min(max(float(levels.max()) + 10.0, 50.0), 120.0)
        z_base = np.unique(np.concatenate([
            np.arange(0.0, min(zmax, 25.0) + 1e-9, 1.0),
            np.arange(25.0, min(zmax, 50.0) + 1e-9, 2.5),
            np.arange(50.0, zmax + 1e-9, 5.0),
        ]))
        base = us_standard_profile(z_base)
    else:
        data = np.genfromtxt(fname_atmmod)
        names = ['altitude', 'pressure', 'temperature', 'air', 'o3', 'o2', 'h2o', 'co2', 'no2']
        base = {n: data[:, i] for i, n in enumerate(names)}
        order = np.argsort(base['altitude'])
        base = {k: v[order] for k, v in base.items()}
        base['ch4'] = np.interp(base['altitude'], _CH4_Z, _CH4_VMR) * base['air']

    if levels.min() < base['altitude'].min() - 1e-9 or levels.max() > base['altitude'].max() + 1e-9:
        raise ValueError('requested levels outside the base profile altitude range')

    def build(z_new: np.ndarray, thickness: np.ndarray | None) -> _Profile:
        temp = np.interp(z_new, base['altitude'], base['temperature'])
        pres = interp_pres_from_alt_temp(base['pressure'], base['altitude'],
                                         base['temperature'], z_new, temp)
        factor = c.ND_FACTOR * pres / temp
        kw = {}
        for g in GASES:
            vmr = np.interp(z_new, base['altitude'], base[g] / base['air'])
            kw[g] = vmr * factor
        return _Profile(altitude=z_new, pressure=pres, temperature=temp,
                        factor=factor, thickness=thickness, **kw)

    lev = build(levels, None)
    lay = build(layers, levels[1:] - levels[:-1])
    return Atmosphere(lev=lev, lay=lay, lat=lat)
