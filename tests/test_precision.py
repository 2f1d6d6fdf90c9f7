"""Every contraction of the transport kernels runs at full float32.

On Hopper a float32 dot defaults to TF32 (~10 mantissa bits), which would
put ~1e-3 relative error on one-hot-selected level heights and on optical
depths.  The kernels pin ``precision=HIGHEST`` per call site; this walks
the traced programs and checks every ``dot_general`` in them.
"""

import numpy as np
import pytest

import jax
from jax.extend import core as jex_core

from er3t_tpu.pre.atm import atm_atmmod
from er3t_tpu.pre.abs import abs_synthetic
from er3t_tpu.pre.cld import cld_gen_hom
from er3t_tpu.rtm.mc import SolverConfig, transport
from er3t_tpu.rtm.mc_flight import transport_flight
from er3t_tpu.rtm.scene import build_scene

_HI = jax.lax.Precision.HIGHEST


@pytest.fixture(scope='module')
def scene():
    atm = atm_atmmod(np.linspace(0, 20, 11))
    ab = abs_synthetic(650.0, atm, ng=4)
    cld = cld_gen_hom(nx=4, ny=4, nz=2, dx=1.0, dy=1.0, cot0=6.0, cer0=10.0,
                      cloud_base=2.0, cloud_top=6.0)
    return build_scene(atm, ab, cld=cld, surface=0.1,
                       solar_zenith_angle=30.0)


def _dot_precisions(jaxpr):
    """Precision params of every dot_general, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == 'dot_general':
            out.append(eqn.params['precision'])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jex_core.ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, jex_core.Jaxpr):
                    out += _dot_precisions(sub)
    return out


def _assert_all_highest(closed):
    precs = _dot_precisions(closed.jaxpr)
    assert precs, 'no contraction found: the walk is broken'
    bad = [p for p in precs if p != (_HI, _HI)]
    assert not bad, f'{len(bad)} of {len(precs)} dots below HIGHEST: {bad}'


@pytest.mark.parametrize('case', ['radiance', 'flux_column', 'flux_domain'])
def test_flight_kernel_dots_highest(scene, case):
    scn, st = scene
    fw = rw = None
    if case == 'radiance':
        cfg = SolverConfig(target='radiance', batch=256, tile_size=2)
        rw = np.ones(st.ng, np.float32)
    else:
        cfg = SolverConfig(target='flux', batch=256,
                           flux_per_column=case == 'flux_column',
                           cf_dtau=0.5)
        if case == 'flux_column':
            fw = np.ones((st.nz + 1, st.ng), np.float32)
    closed = jax.make_jaxpr(transport_flight, static_argnums=(1, 2))(
        scn, st, cfg, 1000, jax.random.key(0), fw, rw)
    _assert_all_highest(closed)


def test_marching_kernel_dots_highest(scene):
    scn, st = scene
    cfg = SolverConfig(target='flux', batch=256, flux_engine='marching')
    closed = jax.make_jaxpr(transport, static_argnums=(1, 2, 3))(
        scn, st, cfg, 1000, jax.random.key(0))
    _assert_all_highest(closed)
