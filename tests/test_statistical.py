"""Statistical recovery tests — the assertion-backed versions of the
reference's eyeball-only integration tests (`ppca/src/lib.rs:27-100`,
SURVEY.md §4: "the rebuild should turn these into real assertions").
"""

import numpy as np
import jax
import jax.numpy as jnp

from ppca_rs_tpu import Dataset, PPCATrainer, PPCAModel


def principal_angles(A, B):
    """Largest principal angle (radians) between the column spaces."""
    Qa, _ = np.linalg.qr(A)
    Qb, _ = np.linalg.qr(B)
    s = np.linalg.svd(Qa.T @ Qb, compute_uv=False)
    s = np.clip(s, -1.0, 1.0)
    return float(np.arccos(s.min()))


def test_subspace_recovery(rng):
    """toy-model convergence: EM recovers the ground-truth subspace up to
    rotation, and sigma to the true noise level."""
    C_true = rng.normal(size=(12, 3)) * 2.0
    real = PPCAModel(isotropic_noise=0.2, transform=C_true, mean=rng.normal(size=12))
    data = real.sample(4000, 0.2, key=jax.random.PRNGKey(3))
    model = PPCATrainer(data).train(state_size=3, n_iters=60, quiet=True,
                                    key=jax.random.PRNGKey(4))
    angle = principal_angles(model.transform, C_true)
    assert angle < 0.05, f"subspace angle {angle}"
    assert abs(model.isotropic_noise - 0.2) < 0.05
    np.testing.assert_allclose(model.mean, real.mean, atol=0.15)


def test_singular_values_recovered(rng):
    """Canonical singular values match the ground-truth spectrum.

    sigma = 1.0 keeps the EM mixing fast; with tiny noise the EM's slow tail
    needs the reference's 1600-iteration budget (`ppca/src/lib.rs:47-63`) —
    same algorithm, same behavior."""
    C_true = np.linalg.qr(rng.normal(size=(20, 2)))[0] * np.array([4.0, 2.0])
    real = PPCAModel(isotropic_noise=1.0, transform=C_true, mean=np.zeros(20))
    data = real.sample(6000, 0.0, key=jax.random.PRNGKey(5))
    model = PPCATrainer(data).train(state_size=2, n_iters=80, quiet=True,
                                    key=jax.random.PRNGKey(6))
    # singular_values is sqrt of the column norm (ppca_model.rs:113-121), and
    # the ML column norms are sqrt(lambda_i - sigma^2) = [4, 2].
    got = np.sort(model.singular_values**2)[::-1]
    np.testing.assert_allclose(got, [4.0, 2.0], rtol=0.1)


def test_posterior_sampler_statistics(rng):
    """Posterior draws match the analytic posterior moments: mean ~= smoothed,
    variance ~= smoothed covariance diagonal (the sampler includes the output
    noise, matching the reference code, ppca_model.rs:603-626)."""
    C = rng.normal(size=(6, 2))
    model = PPCAModel(isotropic_noise=0.3, transform=C, mean=rng.normal(size=6))
    data = model.sample(50, 0.3, key=jax.random.PRNGKey(7))
    inf = model.infer(data)
    sampler = inf.posterior_sampler()

    draws = np.stack(
        [sampler.sample(key=jax.random.PRNGKey(100 + i)).numpy() for i in range(600)]
    )  # (600, 50, 6)
    emp_mean = draws.mean(axis=0)
    emp_var = draws.var(axis=0)

    want_mean = inf.smoothed(model).numpy()
    want_var = inf.smoothed_covariances_diagonal(model).numpy()
    np.testing.assert_allclose(emp_mean, want_mean, atol=0.15)
    np.testing.assert_allclose(emp_var, want_var, rtol=0.35, atol=0.05)


def test_extrapolation_accuracy(rng):
    """Imputed values are close to the ground truth within predicted CI."""
    C_true = rng.normal(size=(10, 2)) * 2.0
    real = PPCAModel(isotropic_noise=0.05, transform=C_true, mean=np.zeros(10))
    full = real.sample(2000, 0.0, key=jax.random.PRNGKey(8))
    truth = full.numpy()
    # mask 30% of entries
    holes = rng.random(truth.shape) < 0.3
    observed = np.where(holes, np.nan, truth)
    ds = Dataset(observed)
    model = PPCATrainer(ds).train(state_size=2, n_iters=40, quiet=True,
                                  key=jax.random.PRNGKey(9))
    extr = model.extrapolate(ds).numpy()
    err = np.abs(extr - truth)[holes]
    inf = model.infer(ds)
    ci = inf.extrapolated_covariances_diagonal(model, ds).numpy() ** 0.5
    # >=95% of imputations within 3 predicted std
    frac = np.mean(err <= 3 * ci[holes] + 1e-6)
    assert frac > 0.95, frac
    # overall imputation error is small relative to data scale
    assert np.median(err) < 0.5


def test_f32_pipeline(rng):
    """The whole verb surface works in f32 (the accelerator dtype) with sane tolerances
    vs f64 (SURVEY.md §7 hard-parts: numerics parity in f32)."""
    C = rng.normal(size=(8, 2))
    mean = rng.normal(size=8)
    data = rng.normal(size=(200, 8)) + mean
    data[rng.random((200, 8)) < 0.3] = np.nan
    ds64 = Dataset(data)
    filled, mask = np.nan_to_num(data), np.isfinite(data)
    ds32 = Dataset.from_parts(
        jnp.asarray(filled, jnp.float32), jnp.asarray(mask)
    )
    model64 = PPCAModel(isotropic_noise=0.5, transform=C, mean=mean)
    model32 = PPCAModel._from_params(
        jnp.asarray(C, jnp.float32),
        jnp.asarray(mean, jnp.float32),
        jnp.asarray(0.5, jnp.float32),
    )
    np.testing.assert_allclose(model32.llk(ds32), model64.llk(ds64), rtol=1e-4)
    np.testing.assert_allclose(
        model32.infer(ds32).states(), model64.infer(ds64).states(), rtol=1e-3, atol=1e-4
    )
    m32 = model32.iterate(ds32)
    m64 = model64.iterate(ds64)
    np.testing.assert_allclose(m32.transform, m64.transform, rtol=5e-3, atol=5e-4)
    assert np.isclose(m32.isotropic_noise, m64.isotropic_noise, rtol=1e-3)


def test_bf16_storage_pipeline(rng):
    """bf16 value STORAGE (halved HBM traffic; math stays >= f32) keeps the
    verb surface within a documented envelope of the f64 pipeline: data
    quantization is ~0.4% relative per entry, and the sample-averaged EM
    statistics keep parameter updates well inside 1e-2."""
    C = rng.normal(size=(8, 2))
    mean = rng.normal(size=8)
    data = rng.normal(size=(2000, 8)) + mean
    data[rng.random((2000, 8)) < 0.3] = np.nan
    ds64 = Dataset(data)
    filled, mask = np.nan_to_num(data), np.isfinite(data)
    ds16 = Dataset.from_parts(
        jnp.asarray(filled, jnp.bfloat16), jnp.asarray(mask)
    )
    assert ds16.dtype == jnp.bfloat16
    model64 = PPCAModel(isotropic_noise=0.5, transform=C, mean=mean)
    model16 = PPCAModel._from_params(
        jnp.asarray(C, jnp.float32),
        jnp.asarray(mean, jnp.float32),
        jnp.asarray(0.5, jnp.float32),
    )
    # parameters stay f32 even over bf16 data
    assert model16.iterate(ds16).transform.dtype == np.float32
    np.testing.assert_allclose(model16.llk(ds16), model64.llk(ds64), rtol=3e-3)
    np.testing.assert_allclose(
        model16.infer(ds16).states(), model64.infer(ds64).states(),
        rtol=2e-2, atol=2e-2,
    )
    m16 = model16.iterate(ds16)
    m64 = model64.iterate(ds64)
    np.testing.assert_allclose(m16.transform, m64.transform, rtol=2e-2, atol=2e-3)
    assert np.isclose(m16.isotropic_noise, m64.isotropic_noise, rtol=1e-2)
    # ... and EM converges to the same model: quantization perturbs the
    # fixed point by ~data precision, not the convergence itself
    t16, _ = model16.iterate_n(ds16, 30)
    t64, _ = model64.iterate_n(ds64, 30)
    np.testing.assert_allclose(
        np.abs(t16.to_canonical().transform), np.abs(t64.to_canonical().transform),
        rtol=5e-2, atol=5e-2,
    )
