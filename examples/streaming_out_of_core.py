"""Out-of-core training: the dataset never fits in device memory at once.

An extra with no reference counterpart (the reference leaves chunked
workflows to the user via `Dataset.chunks`): EM sufficient statistics are
additive, so chunks stream through the device one at a time.
"""

import os

import numpy as np

from ppca_rs_tpu import Dataset, StreamingPPCATrainer
from ppca_rs_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

CHUNK, N_CHUNKS = 20_000, 5
if os.environ.get("PPCA_EXAMPLE_SMOKE"):  # CPU CI smoke (tests/test_examples.py)
    CHUNK, N_CHUNKS = 2_000, 3

rng = np.random.default_rng(0)
C_true = rng.normal(size=(64, 4))


def make_chunk(seed):
    def load():
        r = np.random.default_rng(seed)
        z = r.normal(size=(CHUNK, 4))
        data = z @ C_true.T + 0.3 * r.normal(size=(CHUNK, 64))
        data[r.random(data.shape) < 0.2] = np.nan
        return Dataset(data)

    return load


chunks = [make_chunk(s) for s in range(N_CHUNKS)]  # loaded lazily
model = StreamingPPCATrainer(chunks).train(state_size=4, n_iters=10)
print(model)
print("singular values:", model.singular_values)
