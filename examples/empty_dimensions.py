"""Degenerate data: all-missing columns and per-sample weights.

Covers the reference capability of `examples/empty_dimensions.py`:
`Dataset.empty_dimensions()` finds columns that are missing in EVERY sample,
and training remains well-defined — the model keeps a zero loading row for
such columns instead of diverging.
"""

import jax
import numpy as np

from ppca_rs_tpu import Dataset, PPCATrainer
from ppca_rs_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

rng = np.random.default_rng(13)
n, d = 30, 5
values = rng.normal(size=(n, d))
values[:, 2] = np.nan            # dimension 2 is never observed
values[rng.random((n, d)) < 0.1] = np.nan

# Weights let an outer algorithm (e.g. the mixture EM, or importance
# sampling) reweight samples without copying the data.
weights = np.concatenate([np.full(15, 2.0), np.full(15, 0.5)])
dataset = Dataset(values, weights=weights)

empty = dataset.empty_dimensions()
print("empty dimensions:", empty)
assert list(empty) == [2]

model = PPCATrainer(dataset).train(
    state_size=2, n_iters=25, key=jax.random.PRNGKey(13), quiet=True
)

# The never-observed dimension contributes nothing: zero loading row, and
# its reconstruction is just the (zero-initialized) mean.
loading_row = np.asarray(model.transform)[2]
print("loading row for the empty dimension:", loading_row)
assert np.allclose(loading_row, 0.0)
assert np.isfinite(model.llk(dataset))
print("ok: empty dimensions stay inert and weighted training is finite")
