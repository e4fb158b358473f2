"""Bayesian MAP training: priors regularize what the data can't pin down.

Covers the reference capability of `examples/priors.py`
(`iterate_with_prior` with an inverse-gamma noise prior and a normal mean
prior), demonstrated as a contrast experiment: with only 25 heavily-masked
samples, maximum likelihood overfits the noise floor, while a MAP fit with a
strong inverse-gamma prior keeps sigma near its prior mode.
"""

import jax
import numpy as np

from ppca_rs_tpu import PPCATrainer, Prior, PPCAModel
from ppca_rs_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

rng = np.random.default_rng(21)
D, K, N = 8, 3, 25
TRUE_SIGMA = 0.6

truth = PPCAModel(
    transform=rng.normal(size=(D, K)),
    isotropic_noise=TRUE_SIGMA,
    mean=np.zeros(D),
)
# tiny and 40% missing: deliberately under-determined
dataset = truth.sample(N, mask_prob=0.4, key=jax.random.PRNGKey(21))

ml_fit = PPCATrainer(dataset).train(
    state_size=K, n_iters=80, key=jax.random.PRNGKey(1), quiet=True
)

# Inverse-gamma(alpha, beta) over sigma^2 with mode beta/(alpha+1) at the true
# noise level, plus a normal prior anchoring the mean at zero and a ridge on
# the transform entries.
alpha = 50.0
beta = TRUE_SIGMA**2 * (alpha + 1.0)
prior = (
    Prior()
    .with_isotropic_noise_prior(alpha, beta)
    .with_mean_prior(np.zeros(D), 10.0 * np.eye(D))
    .with_transformation_precision(0.05)
)
map_fit = PPCATrainer(dataset).train(
    state_size=K, n_iters=80, prior=prior, key=jax.random.PRNGKey(1), quiet=True
)

print(f"true sigma          : {TRUE_SIGMA:.3f}")
print(f"ML  fitted sigma    : {float(ml_fit.isotropic_noise):.3f}")
print(f"MAP fitted sigma    : {float(map_fit.isotropic_noise):.3f}")
print(f"ML  mean norm       : {float(np.linalg.norm(ml_fit.mean)):.3f}")
print(f"MAP mean norm       : {float(np.linalg.norm(map_fit.mean)):.3f}")

# The prior should pull sigma toward its mode and shrink the mean.
map_err = abs(float(map_fit.isotropic_noise) - TRUE_SIGMA)
ml_err = abs(float(ml_fit.isotropic_noise) - TRUE_SIGMA)
assert map_err <= ml_err + 1e-6, (map_err, ml_err)
assert np.linalg.norm(map_fit.mean) < np.linalg.norm(ml_fit.mean) + 1e-6
assert np.isfinite(map_fit.transform).all()
print("ok: MAP estimate is regularized toward the prior")
