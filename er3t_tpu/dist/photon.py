"""Photon-parallel transport: replicated scene, sharded photon streams.

The direct counterpart of the reference's embarrassingly-parallel run
fan-out (Nrun x Ng MCARaTS processes over CPUs, mcarats.py:192-196 +
mca_run.py:144-159): every device transports an independent photon stream
through a replicated scene; tallies are reduced with a single ``psum`` over
the mesh (replacing the reference's file-based reduction,
mca_out.py:344-366).  Scaling is near-perfect because the only communication
is the final reduction.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..rtm.mc import SolverConfig, Tallies
from ..rtm.mc_flight import transport_flight

__all__ = ['transport_photon_parallel']


@functools.lru_cache(maxsize=64)
def _launch_fn(mesh, st, cfg, axis_names, use_fw, use_rw):
    """One compiled executable per (mesh, scene-statics, config).

    ``seed`` and the per-device photon counts are TRACED inputs — a
    per-call closure would bake them into the HLO and recompile every
    chunk (the recompile class the traced-n_photon design removed;
    solver._single_run calls this once per 4M-photon chunk with a fresh
    seed)."""

    def worker(scene, fw_loc, rw_loc, n_per, rem, seed):
        # per-device RNG stream from the mesh coordinates (no sharded
        # seed input: this keeps the entry multi-process friendly —
        # every input is replicated, so host-local arrays work under
        # jax.distributed multi-controller execution too)
        me = jnp.zeros((), jnp.uint32)
        for a in axis_names:
            me = me * jnp.uint32(mesh.shape[a]) \
                + jax.lax.axis_index(a).astype(jnp.uint32)
        key = jax.random.fold_in(jax.random.key(seed), me)
        # first `rem` devices take one extra photon so the requested
        # budget is delivered exactly (solver.distribute_photon's
        # rounding-residue care, applied to the device split)
        n_me = n_per + (me < rem).astype(jnp.int32)
        tal = transport_flight(scene, st, cfg, n_me, key,
                               flux_w=fw_loc if use_fw else None,
                               rad_w=rw_loc if use_rw else None)
        rad, flux, n = tal.rad, tal.flux, tal.n_launched
        n_s, rpl, ab = tal.n_steps, tal.rad_plen, tal.absorbed
        li = tal.lane_iters
        for a in axis_names:
            rad = jax.lax.psum(rad, a)
            flux = jax.lax.psum(flux, a)
            n = jax.lax.psum(n, a)
            n_s = jax.lax.psum(n_s, a)
            rpl = jax.lax.psum(rpl, a)
            ab = jax.lax.psum(ab, a)
            li = jax.lax.psum(li, a)
        return Tallies(rad=rad, flux=flux, n_launched=n, n_steps=n_s,
                       rad_plen=rpl, lane_iters=li, absorbed=ab)

    def launch(scene, fw, rw, n_per, rem, seed):
        return jax.shard_map(
            worker, mesh=mesh,
            in_specs=(P(), P(), P(), P(), P(), P()),
            out_specs=Tallies(rad=P(), flux=P(), n_launched=P(), n_steps=P(),
                              rad_plen=P(), lane_iters=P(), absorbed=P()),
            check_vma=False,
        )(scene, fw, rw, n_per, rem, seed)

    return jax.jit(launch)


def transport_photon_parallel(scene, st, cfg: SolverConfig, n_photon: int,
                              mesh, seed: int = 0, axes=('x', 'b'),
                              flux_w=None, rad_w=None):
    """Run the flight kernel data-parallel over every device of ``mesh``.

    Returns globally-reduced tallies (same structure as a single-device run).
    """
    n_dev = mesh.size
    axis_names = tuple(axes)
    use_fw = flux_w is not None
    fw = jnp.asarray(flux_w, jnp.float32) if use_fw \
        else jnp.zeros((st.nz + 1, st.ng), jnp.float32)
    use_rw = rad_w is not None
    rw = jnp.asarray(rad_w, jnp.float32) if use_rw \
        else jnp.zeros((st.ng,), jnp.float32)
    fn = _launch_fn(mesh, st, cfg, axis_names, use_fw, use_rw)
    return fn(scene, fw, rw,
              jnp.asarray(int(n_photon) // n_dev, jnp.int32),
              jnp.asarray(int(n_photon) % n_dev, jnp.uint32),
              jnp.asarray(int(seed), jnp.int32))
