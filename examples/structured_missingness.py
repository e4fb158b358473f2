"""Structured missingness: mask-pattern deduplication in action.

Real-world missing data is rarely random — a handful of instrument
configurations, survey versions or join shapes produce P distinct mask
patterns with P << N.  The framework detects this automatically at first
use (`Dataset.pattern_info`) and switches every verb to a pattern-table
fast path: factorizations collapse from N per EM pass to P.  Mixtures use
M x P tables
the same way (a fully-observed dataset is the P=1 case).
"""

import os
import time

import jax
import numpy as np

from ppca_rs_tpu import Dataset, PPCAMixTrainer, PPCAModel, PPCATrainer
from ppca_rs_tpu.config import config
from ppca_rs_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

rng = np.random.default_rng(99)
N, D, K = 100_000, 256, 16
if os.environ.get("PPCA_EXAMPLE_SMOKE"):  # CPU CI smoke (tests/test_examples.py)
    N, D = 6_000, 64

# Three "instrument versions", each observing a different fixed subset of
# the D channels.
versions = np.ones((3, D), dtype=bool)
versions[0, 160:] = False         # v0 misses the last 96 channels
versions[1, ::3] = False          # v1 misses every third channel
versions[2, :40] = False          # v2 misses the first 40

truth = PPCAModel(
    transform=rng.normal(size=(D, K)),
    isotropic_noise=0.3,
    mean=rng.normal(size=D),
)
full = truth.sample(N, mask_prob=0.0, key=jax.random.PRNGKey(99)).numpy()
version_of_row = rng.integers(0, 3, size=N)
values = np.where(versions[version_of_row], full, np.nan)
dataset = Dataset(values)

info = dataset.pattern_info()
assert info is not None, "three fixed masks => detection must trigger"
print(f"detected {info[1].shape[0]} distinct mask patterns across {N:,} rows")
assert info[1].shape[0] == 3

def timed_train(ds, label):
    # warm-up call so the timing measures compute, not compilation
    PPCATrainer(ds).train(state_size=K, n_iters=1, key=jax.random.PRNGKey(1), quiet=True)
    t0 = time.perf_counter()
    model = PPCATrainer(ds).train(
        state_size=K, n_iters=15, key=jax.random.PRNGKey(1), quiet=True
    )
    print(f"{label}: {time.perf_counter() - t0:.2f}s "
          f"(llk/sample {float(model.llk(ds)) / N:.3f})")
    return model


# At this demo size both paths are dominated by per-iteration dispatch; the
# pattern path's advantage grows with D and k (bench_suite.py measures it
# at D=1024, k=64, N=1M).
model = timed_train(dataset, "pattern-path training (15 iters)")

# The fast path must agree with the general path to f32 tolerance: retrain
# with dedup disabled and compare.
config.use_pattern_dedup = False
try:
    dataset_slow = Dataset(values)
    assert dataset_slow.pattern_info() is None
    model_slow = timed_train(dataset_slow, "general-path training (15 iters)")
finally:
    config.use_pattern_dedup = True

rel = abs(model.llk(dataset) - model_slow.llk(dataset)) / abs(model_slow.llk(dataset))
print(f"final llk relative difference: {rel:.2e}")
assert rel < 1e-4

# Mixtures share the machinery (M x P tables; dense data is the P=1 case).
mix = PPCAMixTrainer(dataset).train(
    n_models=2, state_size=K, n_iters=8, key=jax.random.PRNGKey(2), quiet=True
)
assert np.isfinite(mix.llk(dataset))
filled = mix.extrapolate(dataset).numpy()
assert np.isfinite(filled).all(), "every missing channel is imputed"
print("ok: structured-missingness fast path verified end to end")
