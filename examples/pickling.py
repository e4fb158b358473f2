"""Serialization: pickle, stable bytes (dump/load), and llk preservation.

Covers the reference capability of `examples/pickling.py` and the
dump/load verbs: models are frozen pytrees of device arrays, so a round trip
through pickle or through the versioned byte format must reproduce the model
exactly — same parameters, same log-likelihood function.
"""

import pickle

import jax
import numpy as np

from ppca_rs_tpu import PPCAModel, PPCAMix
from ppca_rs_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

rng = np.random.default_rng(5)
model = PPCAModel(
    transform=rng.normal(size=(6, 2)),
    isotropic_noise=0.35,
    mean=rng.normal(size=6),
)
dataset = model.sample(64, mask_prob=0.25, key=jax.random.PRNGKey(5))

# --- pickle round trip
clone = pickle.loads(pickle.dumps(model))
np.testing.assert_array_equal(np.asarray(clone.transform), np.asarray(model.transform))
np.testing.assert_array_equal(np.asarray(clone.mean), np.asarray(model.mean))
assert float(clone.llk(dataset)) == float(model.llk(dataset))
print("pickle round trip: exact")

# --- stable-bytes round trip (the dump()/load() persistence verbs)
blob = model.dump()
restored = PPCAModel.load(blob)
assert float(restored.llk(dataset)) == float(model.llk(dataset))
print(f"dump/load round trip: exact ({len(blob)} bytes)")

# --- mixtures serialize the same way
mix = PPCAMix([model, clone], log_weights=np.log([0.25, 0.75]))
mix_clone = pickle.loads(pickle.dumps(mix))
assert float(mix_clone.llk(dataset)) == float(mix.llk(dataset))
np.testing.assert_array_equal(
    np.asarray(mix_clone.log_weights), np.asarray(mix.log_weights)
)
print("mixture pickle round trip: exact")
print("ok: serialization preserves models bit-for-bit")
