"""Domain-decomposed transport: x-slab sharded scene + photon migration.

The reference replicates the full 3D field into every solver process
(shared mca_atm_3d.bin; SURVEY §5.7 notes decomposition has no counterpart
there).  Here the voxel grid is split into x-slabs across the mesh's 'x'
axis; each device transports photons only while they are inside its slab.
Flights clamp at slab faces (er3t_tpu.rtm.mc_flight), the lane freezes, and
a migration exchange moves it to the neighbor over NVLink.

Migration is a *capacity-backpressured prefix swap*: each device stably
partitions its lanes (dead first, then outgoing, then the rest), exchanges
scalar capacities along the ring (two fixed-point rounds: a receiver's
capacity is its dead slots plus the rows it vacates by shipping in the same
swap), then ships exactly ``n_ship = min(outgoing, window, neighbor
capacity)`` real rows via ``lax.ppermute`` — the window's remaining rows are
zeroed sentinels.  Receivers host the incoming prefix in their dead/vacated
rows.  No photon can be lost or duplicated (each shipped row is vacated at
the source and guaranteed a free slot at the destination), and — unlike a
wholesale window swap — no *active in-slab* lane is ever exported: a
wholesale swap freezes up to ``2 (M - outgoing - dead)`` productive lanes
per direction per superstep, which measured as a 38x work-per-photon
explosion on a 2-slab broken-cloud run.  Emigrants beyond the shipped
prefix stay frozen and retry next superstep (backpressure).  The transport
kernel additionally reserves a few dead lanes per iteration from respawn
(``spawn_reserve``) so migration capacity never starves against the launch
quota.

Per superstep: K inner transport iterations, then a right-swap and a
left-swap.  Per-column level-crossing flux tallies partition with the slabs
and concatenate on exit; domain-average flux takes one psum.  Radiance
images are GLOBAL per device and psum-reduced: the kernel's local estimates
need only the event's own voxel column for 3D sensor attenuation (the
tilted-column evaluation of rtm/mc_flight.py — identical to the
single-device estimator), so slant satellite sensors (MCARaTS Rad_the,
mca_inp.py:324-338), IPA pinning and fisheye cameras all decompose; the
only cross-slab coupling is which image pixel receives the deposit.  The
reference runs both radiance and flux workloads under its MPI fan-out
(er3t/rtm/mca/mca_run.py:110-113) — this path covers the same target set.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..rtm.mc import SolverConfig, Tallies
from ..rtm.mc_flight import (FlightCarry, SlabSpec, lane_matrix,
                             lanes_from_matrix, make_flight_kernel)
from ..rtm.scene import SceneArrays

__all__ = ['transport_decomp']

_F = jnp.float32


def transport_decomp(scene, st, cfg: SolverConfig, n_photon: int, mesh,
                     seed: int = 0, k_super: int = 16, window: int | None = None,
                     max_rounds: int | None = None, flux_w=None,
                     rad_w=None, spawn_reserve: int | None = None) -> Tallies:
    """Run transport with the scene x-decomposed over mesh axis 'x'.

    ``scene``/``st`` describe the *global* scene; arrays are sharded here.
    Supports radiance (nadir or slant satellite sensors and fisheye
    cameras — images are global and psum-reduced), flux and heating-rate
    targets — per-column flux tallies partition with the slabs; the
    domain-average flux takes one psum.  Returns global tallies (image /
    per-column flux gathered across slabs).

    The photon count, seed and round cap are traced inputs: one compiled
    executable serves every chunk of a given (mesh, scene statics, config).
    """
    n_dev = mesh.shape['x']
    if 'b' not in mesh.shape:
        # the worker psums over 'b' unconditionally; a 1-D ('x',) mesh
        # would fail at trace time with an opaque unbound-axis error.
        # make_mesh() always builds ('x', 'b'); add a size-1 'b' axis.
        raise ValueError(
            "transport_decomp needs a mesh with ('x', 'b') axes (use "
            "dist.mesh.make_mesh, which adds a size-1 'b' axis)")
    if st.nx % n_dev:
        raise ValueError('nx must divide the decomposition axis')
    radiance = cfg.target == 'radiance'
    B = cfg.batch
    # migration packs int lane state (nscat, ix0, iy0) into float32 rows —
    # exact only below 2^24
    assert st.nx * st.ny < 2 ** 24 and cfg.n_scat_max < 2 ** 24, \
        'photon migration packs int lane state into float32 (exact < 2^24)'
    M = window or max(B // 4, 1)
    if spawn_reserve is None:
        # landing capacity per swap that respawn may not consume; only
        # needed on true multi-slab rings (see migrate_dir backpressure)
        spawn_reserve = min(M // 2, B // 8) if n_dev > 1 else 0
    n_per = int(n_photon) // n_dev
    if max_rounds is None:
        max_rounds = int(np.ceil(n_per / B + 1) * max(1600 // k_super, 8)) + 32
    n_per = n_per // mesh.shape.get('b', 1)

    scalar_flux = (not radiance and cfg.flux_per_column
                   and cfg.flux_kcross > 0 and flux_w is not None)
    scalar_rad = radiance and rad_w is not None
    fw = jnp.asarray(flux_w, _F) if flux_w is not None \
        else jnp.zeros((st.nz + 1, st.ng), _F)    # placeholder (unused)
    rw = jnp.asarray(rad_w, _F) if rad_w is not None \
        else jnp.zeros((st.ng,), _F)              # placeholder (unused)
    fn = _decomp_fn(mesh, st, cfg, k_super, M, spawn_reserve, scalar_flux,
                    scalar_rad)
    return fn(scene, fw, rw, jnp.asarray(n_per, jnp.int32),
              jnp.asarray(max_rounds, jnp.int32),
              jnp.asarray(int(seed), jnp.int32))


@functools.lru_cache(maxsize=64)
def _decomp_fn(mesh, st, cfg, k_super, M, spawn_reserve, scalar_flux,
               scalar_rad):
    """One jitted shard_map executable per (mesh, statics, config)."""
    n_dev = mesh.shape['x']
    radiance = cfg.target == 'radiance'
    camera = cfg.sensor_type == 'camera'
    nx_loc = st.nx // n_dev
    st_loc = dataclasses.replace(st, nx=nx_loc)
    slab = SlabSpec(nx_global=st.nx, nx_local=nx_loc)
    B = cfg.batch

    ring_r = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    ring_l = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    # shard 3D fields along x, replicate the rest
    specs3d = {'ext3d', 'ssa3d', 'apf3d', 'cf3d'}
    sfc_sharded = st.nxs == st.nx  # per-column surface maps follow the slabs
    in_specs = SceneArrays(*[
        P('x') if (f in specs3d or (sfc_sharded and f in ('jsfc', 'psfc')))
        else P()
        for f in SceneArrays._fields])
    st_loc = dataclasses.replace(st_loc, nxs=(st.nxs // n_dev if sfc_sharded else st.nxs))

    n_b = mesh.shape.get('b', 1)

    def worker(scene_loc, fw_loc, rw_loc, n_per, max_rounds, seed):
        me = jax.lax.axis_index('x')
        bi = jax.lax.axis_index('b') if n_b > 1 else 0
        x_off = (me * nx_loc * st.dx).astype(_F)
        key = jax.random.fold_in(jax.random.key(seed), me * 4096 + bi)
        body, _, carry0 = make_flight_kernel(
            scene_loc, st_loc, cfg, n_per, key, slab=slab, x_off=x_off,
            flux_w=fw_loc if scalar_flux else None,
            rad_w=rw_loc if scalar_rad else None,
            spawn_reserve=spawn_reserve)
        lx_loc = nx_loc * st.dx

        # above the deck top, lanes roam across slabs (1D data is
        # replicated) and must NOT be shipped — only frozen lanes (at/below
        # deck top out of slab) migrate.  Per-column flux disables roaming
        # (see mc_flight.roam_above_deck), so everything out-of-slab ships.
        roam = radiance or not cfg.flux_per_column
        zd_top = scene_loc.z_lev[st.iz3l + st.nz3]

        def migrate_dir(c: FlightCarry, ring_fwd, ring_rev, go_right):
            # relay routing: a frozen lane may be SEVERAL slabs from home
            # (roaming lanes clamp at their remote deck entry, which can be
            # anywhere) — ship it one hop along the shorter ring direction;
            # still-remote arrivals re-freeze and relay next superstep.
            # (Matching only the immediate neighbor left multi-hop lanes
            # stranded forever once roaming landed — n>=4 rings pinned at
            # max_rounds.)
            t_slab = jnp.floor(c.x / lx_loc).astype(jnp.int32) % n_dev
            d_r = (t_slab - me) % n_dev          # hops to the right
            frozen = c.alive & (d_r != 0)
            if roam:
                frozen = frozen & (c.z <= zd_top)
            # halfway targets are eligible BOTH ways (a lane ships at most
            # once per swap — the first shipment vacates it), so capacity
            # left over after the right swap is usable in the same
            # superstep; one-directional eligibility measured a 14x drain
            # slowdown on 2-slab rings (half the bandwidth, spiraling)
            if go_right:
                emig = frozen & (d_r <= n_dev // 2)
            else:
                emig = frozen & (d_r >= (n_dev + 1) // 2)
            dead = ~c.alive
            # dead first, emigrants second, active-in-slab last — active
            # lanes can then never be exported by construction
            k = jnp.where(dead, 0, jnp.where(emig, 1, 2)).astype(jnp.int32)
            perm = jnp.argsort(k, stable=True)
            n_dead = jnp.sum(dead.astype(jnp.int32))
            n_emig = jnp.sum(emig.astype(jnp.int32))
            # capacity fixed point (2 rounds): my capacity = dead slots +
            # rows I vacate by shipping this same swap; ship = min(emig,
            # window, receiver capacity).  Converges from below, so any
            # truncation is safe backpressure.
            cap = n_dead
            ship = jnp.minimum(n_emig, M)
            for _ in range(2):
                cap_nb = jax.lax.ppermute(cap, axis_name='x', perm=ring_rev)
                ship = jnp.minimum(jnp.minimum(n_emig, M), cap_nb)
                cap = n_dead + ship
            m, spec = lane_matrix(c)
            alive_col = spec['alive'][0]
            j = jnp.arange(M)
            src = perm[jnp.clip(n_dead + j, 0, B - 1)]
            out_win = jnp.where((j < ship)[:, None], m[src], 0.0)
            in_win = jax.lax.ppermute(out_win, axis_name='x', perm=ring_fwd)
            n_in = jax.lax.ppermute(ship, axis_name='x', perm=ring_fwd)
            # Vacate shipped rows, then host the incoming prefix in the
            # dead/vacated region perm[0 : n_dead + ship] (n_in is bounded
            # by the capacity we advertised, so every row fits).  Inactive
            # window slots are routed to a DUMP row (index B) so every
            # scatter index writes one constant value: masking them with
            # stale gathered values instead made the clipped duplicate
            # indices (clip hits perm[B-1] whenever n_dead + j >= B, i.e.
            # throughout the drain phase) race the genuine vacate write —
            # last-writer-wins could resurrect a shipped lane, CLONING the
            # photon (observed as a self-sustaining zombie population and
            # a +1-2% energy bias).
            pad = jnp.zeros((1, m.shape[1]), m.dtype)
            m2 = jnp.concatenate([m, pad])
            src_w = jnp.where(j < ship, src, B)
            m2 = m2.at[src_w, alive_col].set(0.0)
            dst_w = jnp.where(j < n_in, perm[jnp.clip(j, 0, B - 1)], B)
            m2 = m2.at[dst_w].set(
                jnp.where((j < n_in)[:, None], in_win, 0.0))
            return lanes_from_matrix(m2[:B], c, spec)

        def superstep(state):
            c, r = state
            c = jax.lax.fori_loop(0, k_super, lambda i, cc: body(cc), c)
            if n_dev > 1:      # a 1-slab ring would only reshuffle lanes
                c = migrate_dir(c, ring_r, ring_l, go_right=True)
                c = migrate_dir(c, ring_l, ring_r, go_right=False)
            return (c, r + 1)

        def cond(state):
            c, r = state
            more = jnp.any(c.alive) | (c.launched < n_per)
            more = jax.lax.psum(jax.lax.psum(more.astype(jnp.int32), 'x'), 'b') > 0
            return more & (r < max_rounds)

        c, rounds = jax.lax.while_loop(cond, superstep, (carry0, jnp.zeros((), jnp.int32)))
        launched = jax.lax.psum(jax.lax.psum(c.launched, 'x'), 'b')
        steps = jax.lax.psum(jax.lax.psum(c.step, 'x'), 'b')
        if radiance:
            # the kernel deposits into the GLOBAL image under a slab (slant
            # sensors / IPA / cameras project deposits across slab faces);
            # one psum over both axes replaces the x-concatenation — the
            # image is a few hundred KB against ms-scale supersteps
            nxr, nyr = (cfg.cam_npix,) * 2 if camera else (st.nx, st.ny)
            rad = jax.lax.psum(jax.lax.psum(c.rad, 'x'), 'b').reshape(
                nxr, nyr, 1 if scalar_rad else st.ng)
        else:
            rad = jax.lax.psum(c.rad, 'b').reshape(
                nx_loc, st.ny, 1 if scalar_rad else st.ng)
        nlev = st.nz + 1
        if radiance:
            flux = jnp.zeros((1, 1, nlev, 3, st.ng), _F)
        elif cfg.flux_per_column:
            # level-crossing tallies are slab-local (crossings are indexed by
            # the local column at the crossing point); reduce only over the
            # photon-stream axis and gather slabs via the output sharding
            ng_f = 1 if scalar_flux else st.ng
            n_rows = nx_loc * st.ny * nlev * 3
            flux = c.flux.reshape(-1, ng_f)[:n_rows].reshape(
                nx_loc, st.ny, nlev, 3, ng_f)
            # deterministic TOA down-direct entry: photons spawn uniformly in
            # the local slab, one crossing per local launch
            toa1 = jnp.sum(fw_loc[st.nz]) if scalar_flux else jnp.ones((), _F)
            flux = flux.at[:, :, st.nz, 0, :].add(
                c.launched.astype(_F) * toa1 / (nx_loc * st.ny))
            flux = jax.lax.psum(flux, 'b')
        else:
            flux = c.flux.reshape(-1, st.ng)[:nlev * 3].reshape(
                1, 1, nlev, 3, st.ng)
            flux = jax.lax.psum(jax.lax.psum(flux, 'x'), 'b')
            flux = flux.at[:, :, st.nz, 0, :].add(launched.astype(_F))
        ab = jax.lax.psum(jax.lax.psum(c.absorbed, 'x'), 'b')
        if radiance and cfg.pathlength:
            # pathlength-weighted image: global like rad (the per-lane
            # `plen` odometer rides the migration pack automatically via
            # lane_matrix; deposits land in the global image) — one psum
            nxr, nyr = (cfg.cam_npix,) * 2 if camera else (st.nx, st.ny)
            rad_pl = jax.lax.psum(jax.lax.psum(c.rad_pl, 'x'), 'b').reshape(
                nxr, nyr, st.ng)
        else:
            rad_pl = jnp.zeros(())
        return Tallies(rad=rad, flux=flux, n_launched=launched,
                       n_steps=steps, rad_plen=rad_pl,
                       lane_iters=steps.astype(_F) * B, absorbed=ab)

    flux_spec = P('x') if (not radiance and cfg.flux_per_column) else P()
    out_specs = Tallies(rad=P() if radiance else P('x'), flux=flux_spec,
                        n_launched=P(), n_steps=P(), rad_plen=P(),
                        lane_iters=P(), absorbed=P())
    return jax.jit(jax.shard_map(
        worker, mesh=mesh, in_specs=(in_specs, P(), P(), P(), P(), P()),
        out_specs=out_specs, check_vma=False))
