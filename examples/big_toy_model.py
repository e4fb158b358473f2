"""Throughput workload: 100k samples x 200 dims, k=16, 24 EM iterations.

Same shape as the reference's de-facto perf workload
(`ppca/src/lib.rs:65-99`), but driven through PPCATrainer with a timing
callback. Each EM iteration is one fused device program (E-step
posterior solves + M-step statistics + llk in a single pass over the data),
so after the first compiled step the loop runs at device speed.
"""

import os
import time

import jax
import numpy as np

from ppca_rs_tpu import PPCAModel, PPCATrainer, TrainMetrics
from ppca_rs_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

D, K, N, ITERS = 200, 16, 100_000, 24
if os.environ.get("PPCA_EXAMPLE_SMOKE"):  # CPU CI smoke (tests/test_examples.py)
    N, ITERS = 4_000, 4

rng = np.random.default_rng(42)
print(f"synthesizing a rank-{K} ground truth over {D} dims")
# Low-rank loading with decaying column scales, so the spectrum is
# interesting rather than flat.
scales = 3.0 * 0.8 ** np.arange(K)
truth = PPCAModel(
    transform=rng.normal(size=(D, K)) * scales,
    isotropic_noise=0.5,
    mean=rng.normal(size=D),
)

print(f"drawing {N:,} samples with 20% missing entries")
dataset = truth.sample(N, mask_prob=0.2, key=jax.random.PRNGKey(42))

llks: list[float] = []
times: list[float] = []


def record(iteration: int, metrics: TrainMetrics) -> None:
    llks.append(metrics.llk)
    times.append(time.perf_counter())


print(f"training for {ITERS} EM iterations")
t0 = time.perf_counter()
model = PPCATrainer(dataset).train(
    state_size=K, n_iters=ITERS, key=jax.random.PRNGKey(0), callback=record, quiet=True
)
total = time.perf_counter() - t0

# First iteration includes compilation; report the steady-state marginal too.
steady = (times[-1] - times[0]) / (len(times) - 1)
print(f"total wall time: {total:.2f}s ({steady * 1e3:.1f} ms/iter steady-state, "
      f"{N / steady / 1e6:.2f}M samples/s)")
print(f"llk/sample: first {llks[0] / N:.4f} -> last {llks[-1] / N:.4f}")

assert all(b >= a - 1e-3 for a, b in zip(llks, llks[1:])), "EM llk must not decrease"
assert np.isfinite(model.transform).all()
print("ok: scale workload converged with monotone llk")
