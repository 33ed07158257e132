"""Test configuration: virtual 8-device CPU mesh, deterministic seeding.

Must set platform env vars before anything imports jax (tests exercise
multi-device sharding on a virtual CPU mesh). Tests run on the CPU; the GPU
path is ``python chip_smoke.py`` and ``python bench.py`` on the machine
with the card.
"""

import os
import random

os.environ["JAX_PLATFORMS"] = "cpu"  # force: tests never touch an accelerator
# Don't compile the second (adaptive half-res) light executable in every
# engine the suite constructs (~17 s each on CPU); the adaptive tests in
# test_engine_light.py opt back in explicitly via adaptive_half_res=True.
os.environ.setdefault("THOR_SLAM_TPU_ADAPTIVE_HALF", "0")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# An explicit config update before backend initialization also holds where
# an accelerator plugin registers itself.
import jax

jax.config.update("jax_platforms", "cpu")

import pytest


@pytest.fixture(autouse=True)
def _seed_everything():
    random.seed(1337)
    import numpy as np

    np.random.seed(1337)
    yield


def pytest_collection_modifyitems(items):
    """Run slow-marked tests last."""
    items.sort(key=lambda item: 1 if item.get_closest_marker("slow") else 0)
