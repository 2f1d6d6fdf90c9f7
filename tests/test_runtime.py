"""Run-time wiring: compile-cache placement and the RNG implementation."""

import os

import pytest

import jax

from er3t_tpu import common


@pytest.mark.parametrize('env_set', [True, False])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
            assert common.setup_compile_cache() == str(tmp_path)
            # the variable is JAX's own: no other directory is set
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
            path = common.setup_compile_cache()
            repo = os.path.dirname(os.path.dirname(os.path.abspath(
                common.__file__)))
            assert path == os.path.join(repo, '.jax_cache')
            assert jax.config.jax_compilation_cache_dir == path
            with open(os.path.join(repo, '.gitignore')) as f:
                assert '.jax_cache/' in f.read().split()
    finally:
        jax.config.update('jax_compilation_cache_dir', before)


def test_unknown_rng_impl_raises():
    from er3t_tpu.rtm.mc import SolverConfig
    from er3t_tpu.rtm.mc_flight import run_transport_flight
    cfg = SolverConfig(target='radiance', batch=64)
    with pytest.raises(ValueError, match='PRNG'):
        run_transport_flight(None, None, cfg, 10, rng_impl='no_such_rng')
