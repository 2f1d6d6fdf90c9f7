"""Test configuration: force CPU with 8 virtual devices.

Tests run on a virtual 8-device CPU mesh, so sharding paths are exercised
without hardware, even on a machine with a GPU (the GPU path is checked by
``python chip_smoke.py``).  Must run before jax initializes a backend.
"""

import os

os.environ['JAX_PLATFORMS'] = 'cpu'
flags = os.environ.get('XLA_FLAGS', '')
if 'host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = flags + ' --xla_force_host_platform_device_count=8'

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')


def pytest_configure(config):
    config.addinivalue_line(
        'markers',
        'slow: long-running statistical tests (full matrix: run without '
        "-m 'not slow'; fast core: pytest -m 'not slow')")
