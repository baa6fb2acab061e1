"""A module-scoped fixture that releases JAX's compiled executables when
a test module ends.

Each executable XLA:CPU compiles keeps memory mappings of its own until
JAX's caches drop it. A test worker runs many modules in one process, and
the kernel's limit on the mappings a process may hold
(``vm.max_map_count``, 65,530 by default) is shared by all of them:
``tests/test_cluster_env.py`` alone reaches about 63,000, so any module
before it in the same process that leaves its executables cached can push
the worker past the limit, where XLA's compiler crashes. The port's test
modules that run JAX import this fixture, so each leaves the process with
the mappings it found.
"""
import gc

import jax
import pytest


@pytest.fixture(scope="module", autouse=True)
def release_jax_executables():
    yield
    jax.clear_caches()
    gc.collect()
