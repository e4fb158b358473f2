"""Multi-device training over a ('data', 'model') mesh.

An extra with no reference counterpart: shard the dataset and every verb —
training, inference, readouts — runs as shard_map programs with psum'd EM
statistics. On a single-device machine this still runs (1x1 mesh); on a
multi-GPU host it spreads over all cards. Force a virtual multi-device CPU
run with:

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python examples/sharded_training.py
"""

import numpy as np

from ppca_rs_tpu import Dataset, PPCATrainer
from ppca_rs_tpu.parallel import make_mesh, shard_dataset

rng = np.random.default_rng(0)
C_true = rng.normal(size=(32, 4))
data = rng.normal(size=(100_001, 4)) @ C_true.T + 0.3 * rng.normal(size=(100_001, 32))
data[rng.random(data.shape) < 0.25] = np.nan

mesh = make_mesh()  # all devices on the 'data' axis
dataset = shard_dataset(Dataset(data), mesh)
print(f"mesh: {dict(mesh.shape)}, dataset: {dataset}")

model = PPCATrainer(dataset).train(state_size=4, n_iters=10)
filled = model.extrapolate(dataset)
print("imputed NaNs:", np.isnan(filled.numpy()).sum(), "(should be 0)")
print(model)

# Whole-training-run compilation on the same mesh: every EM iteration runs
# inside ONE lax.scan (collectives once per iteration, zero per-iteration
# dispatch), with the llk trace still returned.
model2, llks = model.iterate_n(dataset, 5)
# monotone up to f32 reduction noise (llk totals are ~1e6 here)
assert np.all(np.diff(llks) > -1e-6 * np.abs(llks[:-1])), "plain EM llk is monotone"
print(f"5 more scanned iterations: llk {llks[0]:.1f} -> {model2.llk(dataset):.1f}")

# Sharded chunks also stream: a fleet can train on datasets larger than its
# combined device memory by accumulating per-chunk EM statistics.
from ppca_rs_tpu import iterate_streamed
from ppca_rs_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

half = 100_001 // 2
chunks = [
    shard_dataset(Dataset(data[:half]), mesh),
    shard_dataset(Dataset(data[half:]), mesh),
]
streamed, llk_s = iterate_streamed(model2, chunks)
single = model2.iterate(dataset)
assert np.isclose(llk_s, float(model2.llk(dataset)), rtol=1e-5)
assert np.allclose(streamed.transform, single.transform, rtol=1e-4, atol=1e-5)
print(f"streamed == single-shot iteration: llk {llk_s:.1f}")
print("ok: sharded training, scanned training, and sharded streaming agree")
