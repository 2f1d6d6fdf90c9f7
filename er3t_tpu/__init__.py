"""er3t_tpu — a JAX 3D Monte Carlo radiative transfer framework (GPU).

Capabilities of EaR3T (hong-chen/er3t) with an in-framework JAX photon
transport engine replacing the external MCARaTS / libRadtran solvers.
"""

from . import common  # noqa: F401

__version__ = '0.1.0'
