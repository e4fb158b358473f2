"""CPU smoke runs of every example script (VERDICT round 2 weak #7).

Each example is assert-bearing, so a subprocess exit code of 0 is a real
end-to-end check of the public API it drives.  The two heavyweight examples
honor PPCA_EXAMPLE_SMOKE (tiny N, few iters) so the whole sweep stays
CI-sized; everything runs on the virtual 8-device CPU backend in f64 (the
same configuration as the rest of the suite).
"""

import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

EXAMPLES = [
    "toy_model.py",
    "big_toy_model.py",
    "ppca_mixture.py",
    "priors.py",
    "pickling.py",
    "empty_dimensions.py",
    "streaming_out_of_core.py",
    "sharded_training.py",
    "structured_missingness.py",
]


def test_example_list_is_complete():
    on_disk = sorted(
        f for f in os.listdir(os.path.join(REPO, "examples")) if f.endswith(".py")
    )
    assert on_disk == sorted(EXAMPLES), "new example? add it to EXAMPLES"


@pytest.mark.parametrize("example", EXAMPLES)
def test_example_smoke(example):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_ENABLE_X64"] = "true"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PPCA_EXAMPLE_SMOKE"] = "1"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", example)],
        env=env,
        capture_output=True,
        text=True,
        timeout=900,
    )
    assert proc.returncode == 0, (
        f"{example} failed:\nSTDOUT:\n{proc.stdout[-4000:]}\n"
        f"STDERR:\n{proc.stderr[-4000:]}"
    )
