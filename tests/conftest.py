# NOTE: deliberately no XLA_FLAGS here — smoke tests and benches must see the
# real single CPU device; only launch/dryrun.py forces 512 host devices.
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))   # make _hypothesis_compat importable

from _hypothesis_compat import HAS_HYPOTHESIS, settings

if HAS_HYPOTHESIS:
    settings.register_profile("ci", max_examples=25, deadline=None,
                              derandomize=True)
    settings.load_profile("ci")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (a CUDA kernel has no CPU "
        "mode); skips without one")


@pytest.fixture(scope="session")
def rng_key():
    import jax
    return jax.random.key(0)
