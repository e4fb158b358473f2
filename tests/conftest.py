"""Test configuration: run everything on a virtual 8-device CPU mesh in f64.

The suite is CPU-only, whatever accelerator the machine has: the platform
is forced via jax.config (which works even after import), and x64 is on
so CPU tests match the f64 reference semantics exactly.  The GPU checks
live in chip_smoke.py.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(seed=17)


@pytest.fixture(autouse=True)
def _seed_global():
    import ppca_rs_tpu

    ppca_rs_tpu.seed(1234)
