"""Device-mesh construction for multi-chip runs.

The reference's only scaling mechanism is process fan-out over CPUs / MPI
ranks (er3t/rtm/mca/mca_run.py:101-181).  This framework scales over a
``jax.sharding.Mesh`` with two axes:

* ``'x'``  — spatial domain decomposition: the 3D optical-property grid is
  split into x-slabs, photons migrate between neighbor devices (NVLink
  between the cards of one host);
* ``'b'``  — photon parallelism: independent photon streams over replicated
  scenes, tallies psum-reduced.

Multi-host: initialize with ``jax.distributed.initialize()`` before building
the mesh; the same code then spans hosts (slab migration stays on NVLink
within a host where neighbors share one, the final tally reduction crosses
the network once).  The cards of one host are joined all to all, so the
mesh follows device order: slab ``i`` lives on ``jax.devices()[i]``.
"""

from __future__ import annotations

import numpy as np

import jax

__all__ = ['make_mesh', 'init_distributed']


def init_distributed(**kwargs):
    """Multi-host initialization.

    With no arguments this is a best-effort auto-detect that is a safe
    no-op on a single process (cluster detection failing or the backend
    already being initialized are both benign there).  With explicit
    coordinator parameters, only double-initialization is swallowed —
    anything else (bad coordinator address, rank mismatch, backend already
    initialized before the call) must surface: silently falling back to
    single-process would corrupt a genuinely multi-host run.
    """
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError) as e:
        if not kwargs:
            return
        if isinstance(e, RuntimeError) and 'already' in str(e).lower():
            return
        raise


def make_mesh(n_devices: int | None = None, decomp: int | None = None):
    """Build a ('x', 'b') mesh over the first ``n_devices`` devices.

    ``decomp`` fixes the size of the domain-decomposition axis 'x'
    (default: all devices on 'x', i.e. pure domain decomposition; pass
    ``decomp=1`` for pure photon parallelism).
    """
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(
            f'requested {n} devices, only {len(devs)} available')
    devs = devs[:n]
    if decomp is None:
        decomp = n
    if n % decomp:
        raise ValueError(f'{n} devices not divisible into decomp={decomp}')
    arr = np.array(devs).reshape(decomp, n // decomp)
    return jax.sharding.Mesh(arr, ('x', 'b'))
