"""Test configuration: run JAX on a virtual 8-device CPU mesh unless the
caller chose a platform (the `gpu` tests run with JAX_PLATFORMS=cuda).

Must set XLA flags before jax is imported anywhere.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def pore6():
    from sigmap_tpu.io.pore_model import make_synthetic_pore_model

    return make_synthetic_pore_model(k=6, seed=0)


@pytest.fixture(scope="session")
def tiny_genome():
    from sigmap_tpu.synth import random_genome

    return random_genome(length=100_000, seed=7)
