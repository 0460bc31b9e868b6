"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests must see the single real
CPU device; only launch/dryrun.py (run as a subprocess) forces 512 devices."""
import random
import zlib

import jax
import numpy as np
import pytest


def pytest_configure(config):
    # Belt-and-braces with pytest.ini: the marker stays registered even when
    # pytest runs from a cwd where pytest.ini is not picked up.
    config.addinivalue_line(
        "markers",
        'slow: long-running end-to-end tests (deselect with -m "not slow")')
    config.addinivalue_line(
        "markers",
        "adversarial: byzantine-attack / DP scenario tests "
        "(tests/test_attacks.py)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card; skips without one (tests/test_torch_cuda.py)")


@pytest.fixture(autouse=True)
def _seed_isolation(request):
    """Pin every global PRNG to a per-test deterministic seed.

    Seeded from the test's nodeid, so (a) a test that forgets to pass an
    explicit seed is still reproducible in isolation AND under any -k / -p
    subset or execution order, and (b) no test can leak global-RNG state
    into the next one.  jax.random needs no reset — it is keyed explicitly.
    """
    seed = zlib.crc32(request.node.nodeid.encode())
    np.random.seed(seed & 0x7FFFFFFF)
    random.seed(seed)


@pytest.fixture(scope="session")
def key():
    return jax.random.key(0)
