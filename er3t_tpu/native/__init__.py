"""ctypes bridge to the native C++ reference Monte Carlo solver.

Builds ``native/mc_ref.cpp`` on demand with g++ (no pybind11 dependency —
plain C ABI + ctypes).  The native solver plays the role MCARaTS plays for
the reference toolbox: an independent implementation to cross-validate the
JAX transport kernels against (see tests/test_cross_native.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

__all__ = ['mc_ref_run', 'ensure_built']

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(os.path.dirname(_HERE))
_SRC = os.path.join(_REPO, 'native', 'mc_ref.cpp')
_SO = os.path.join(_REPO, 'native', 'libmc_ref.so')

_lib = None


def ensure_built() -> str:
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        cmd = ['g++', '-O3', '-march=native', '-shared', '-fPIC',
               '-std=c++17', '-fopenmp', _SRC, '-o', _SO]
        try:
            subprocess.run(cmd, check=True)
        except subprocess.CalledProcessError:
            # toolchains without OpenMP: build serial
            cmd.remove('-fopenmp')
            subprocess.run(cmd, check=True)
    return _SO


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(ensure_built())
        lib.mc_ref_run.restype = None
        _lib = lib
    return _lib


def mc_ref_run(scene, st, albedo, sza_deg, saa_deg, n_photon, seed=1,
               do_radiance=True, rr_wmin=0.1):
    """Run the native reference solver on a (SceneArrays, SceneStatic) pair.

    Returns (rad (nx, ny, ng), flux (nz+1, 3, ng), n_photon) in the same raw
    photon-weight units as the JAX kernels' tallies.
    """
    lib = _load()
    f64 = lambda a: np.ascontiguousarray(np.asarray(a), dtype=np.float64)
    i32 = lambda a: np.ascontiguousarray(np.asarray(a), dtype=np.int32)

    z_lev = f64(scene.z_lev)
    sig_ray = f64(scene.sig_ray)
    # the C++ cross-check models one CONSERVATIVE aerosol channel using the
    # LAST phase row (mc_ref.cpp); guard the assumptions loudly so a future
    # cross-validation scene with absorbing or multi-constituent aerosol
    # cannot silently validate against wrong reference physics (the ns3
    # guard below does the same for the 3D region)
    aer_ext = np.asarray(scene.sig_aer)
    if aer_ext.any():
        if aer_ext.shape[1] > 1 and (aer_ext != 0).any(axis=0).sum() > 1:
            raise NotImplementedError(
                'the native cross-check solver models a single aerosol '
                'constituent (last phase row)')
        if (np.asarray(scene.aer_ssa) < 1.0).any():
            raise NotImplementedError(
                'the native cross-check solver treats aerosol as '
                'conservative (ssa=1); absorbing aerosol scenes are '
                'cross-validated flight-vs-marching instead')
    sig_aer = f64(aer_ext.sum(axis=1))
    kabs = f64(scene.kabs)
    sig_maj = f64(scene.sig_maj)
    if getattr(st, 'ns3', 1) != 1:
        raise NotImplementedError(
            'the native cross-check solver models a single 3D constituent; '
            'per-constituent scenes are cross-validated flight-vs-marching')
    ext3d = f64(scene.ext3d)
    ssa3d = f64(np.asarray(scene.ssa3d)[..., 0])
    apf3d = i32(np.asarray(scene.apf3d)[..., 0])
    pt_mu = f64(scene.pt_mu)
    pt_p = f64(scene.pt_p)

    npf, nu = pt_mu.shape
    nm = pt_p.shape[1]
    rad = np.zeros((st.nx, st.ny, st.ng), dtype=np.float64)
    flux = np.zeros((st.nz + 1, 3, st.ng), dtype=np.float64)

    c = ctypes
    ptr = lambda a: a.ctypes.data_as(c.POINTER(c.c_double))
    iptr = lambda a: a.ctypes.data_as(c.POINTER(c.c_int))

    lib.mc_ref_run(
        c.c_int(st.nz), c.c_int(st.ng), c.c_int(st.nx), c.c_int(st.ny),
        c.c_int(st.nz3 if st.has_3d else 0), c.c_int(st.iz3l),
        c.c_int(npf), c.c_int(nu), c.c_int(nm),
        ptr(z_lev), ptr(sig_ray), ptr(sig_aer), ptr(kabs), ptr(sig_maj),
        ptr(ext3d), ptr(ssa3d), iptr(apf3d), ptr(pt_mu), ptr(pt_p),
        c.c_double(st.dx), c.c_double(st.dy), c.c_double(albedo),
        c.c_double(sza_deg), c.c_double(saa_deg),
        c.c_longlong(int(n_photon)), c.c_uint64(seed),
        c.c_int(1 if do_radiance else 0), c.c_double(rr_wmin),
        ptr(rad), ptr(flux))
    return rad, flux, int(n_photon)
