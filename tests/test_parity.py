"""Numerical parity against the brute-force NumPy reference implementation.

Random masked datasets (including all-masked rows and empty dimensions) are
run through both the framework and `reference_impl.py` in f64; results
must agree to tight tolerance — llk, posteriors, readouts, and the full EM
update with and without priors.
"""

import numpy as np
import pytest

import reference_impl as ref
from ppca_rs_tpu import Dataset, PPCAModel, Prior


def make_problem(rng, n=40, d=7, k=3, mask_prob=0.3, with_empty_row=True, with_empty_dim=True):
    C = rng.normal(size=(d, k))
    mean = rng.normal(size=d)
    sigma = 0.5
    data = rng.normal(size=(n, d)) * 2.0 + mean
    mask = rng.random((n, d)) > mask_prob
    if with_empty_row:
        mask[1] = False
    if with_empty_dim:
        mask[:, 2] = False
    weights = rng.random(n) + 0.5
    data = np.where(mask, data, np.nan)
    return C, mean, sigma, data, mask, weights


@pytest.fixture
def problem(rng):
    return make_problem(rng)


def as_dataset(data, weights=None):
    return Dataset(data, weights=weights)


def test_llks_parity(problem):
    C, mean, sigma, data, mask, weights = problem
    model = PPCAModel(isotropic_noise=sigma, transform=C, mean=mean)
    ds = as_dataset(data, weights)
    got = model.llks(ds)
    want = np.array([
        ref.llk_one(C, mean, sigma, np.nan_to_num(data[i]), mask[i])
        for i in range(data.shape[0])
    ])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    # weighted total
    assert np.isclose(model.llk(ds), np.sum(want * weights), rtol=1e-9)


def test_infer_parity(problem):
    C, mean, sigma, data, mask, weights = problem
    model = PPCAModel(isotropic_noise=sigma, transform=C, mean=mean)
    ds = as_dataset(data, weights)
    inf = model.infer(ds)
    states = inf.states()
    covs = inf.covariances_array()
    for i in range(data.shape[0]):
        s, cov = ref.infer_one(C, mean, sigma, np.nan_to_num(data[i]), mask[i])
        np.testing.assert_allclose(states[i], s, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(covs[i], cov, rtol=1e-8, atol=1e-10)


def test_empty_sample_is_uninferred(problem):
    """All-masked rows give zero state, identity covariance and zero llk
    (`ppca_model.rs:98-104,124-129,196-198`)."""
    C, mean, sigma, data, mask, weights = problem
    model = PPCAModel(isotropic_noise=sigma, transform=C, mean=mean)
    ds = as_dataset(data, weights)
    inf = model.infer(ds)
    k = C.shape[1]
    np.testing.assert_allclose(inf.states()[1], np.zeros(k), atol=1e-12)
    np.testing.assert_allclose(inf.covariances_array()[1], np.eye(k), rtol=1e-9, atol=1e-12)
    assert abs(model.llks(ds)[1]) < 1e-9


def test_smooth_extrapolate_parity(problem):
    C, mean, sigma, data, mask, weights = problem
    model = PPCAModel(isotropic_noise=sigma, transform=C, mean=mean)
    ds = as_dataset(data, weights)
    inf = model.infer(ds)
    states = inf.states()

    smoothed = model.smooth(ds).numpy()
    want_smoothed = states @ C.T + mean
    np.testing.assert_allclose(smoothed, want_smoothed, rtol=1e-8, atol=1e-10)

    extr = model.extrapolate(ds).numpy()
    want_extr = np.where(mask, np.nan_to_num(data), want_smoothed)
    np.testing.assert_allclose(extr, want_extr, rtol=1e-8, atol=1e-10)

    # batch-wrapper equivalents
    np.testing.assert_allclose(inf.smoothed(model).numpy(), want_smoothed, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(
        inf.extrapolated(model, ds).numpy(), want_extr, rtol=1e-8, atol=1e-10
    )


def test_covariance_readouts_parity(problem):
    C, mean, sigma, data, mask, weights = problem
    model = PPCAModel(isotropic_noise=sigma, transform=C, mean=mean)
    ds = as_dataset(data, weights)
    inf = model.infer(ds)
    covs = inf.covariances_array()

    sm_diag = inf.smoothed_covariances_diagonal(model).numpy()
    ex_diag = inf.extrapolated_covariances_diagonal(model, ds).numpy()
    sm_full = inf.smoothed_covariances(model)
    ex_full = inf.extrapolated_covariances(model, ds)
    d = C.shape[0]
    for i in range(data.shape[0]):
        want_sm = ref.smoothed_cov_diag_one(C, sigma, covs[i])
        np.testing.assert_allclose(sm_diag[i], want_sm, rtol=1e-8, atol=1e-10)
        want_ex = ref.extrapolated_cov_diag_one(C, sigma, covs[i], mask[i])
        np.testing.assert_allclose(ex_diag[i], want_ex, rtol=1e-8, atol=1e-10)

        want_sm_full = C @ covs[i] @ C.T + sigma**2 * np.eye(d)
        np.testing.assert_allclose(sm_full[i], want_sm_full, rtol=1e-8, atol=1e-10)
        neg = ~mask[i]
        want_ex_full = want_sm_full * np.outer(neg, neg)
        np.testing.assert_allclose(ex_full[i], want_ex_full, rtol=1e-8, atol=1e-10)


def test_second_moments_parity(problem):
    """`ppca_model.rs:437-439`: second_moment = s s^T + Sigma."""
    C, mean, sigma, data, mask, weights = problem
    model = PPCAModel(isotropic_noise=sigma, transform=C, mean=mean)
    ds = as_dataset(data, weights)
    inf = model.infer(ds)
    states = inf.states()
    covs = inf.covariances_array()
    sm_list = inf.second_moments()
    sm_arr = inf.second_moments_array()
    for i in range(data.shape[0]):
        want = covs[i] + np.outer(states[i], states[i])
        np.testing.assert_allclose(sm_list[i], want, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(sm_arr[i], want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("prior_kind", ["none", "noise", "mean", "ridge", "all"])
def test_em_step_parity(problem, rng, prior_kind):
    C, mean, sigma, data, mask, weights = problem
    d = C.shape[0]
    model = PPCAModel(isotropic_noise=sigma, transform=C, mean=mean)
    ds = as_dataset(data, weights)

    prior = Prior()
    kwargs = {}
    if prior_kind in ("noise", "all"):
        prior = prior.with_isotropic_noise_prior(2.0, 3.0)
        kwargs["noise_prior"] = (2.0, 3.0)
    if prior_kind in ("mean", "all"):
        pm = rng.normal(size=d)
        pc = np.eye(d) * 0.5 + 0.1 * np.ones((d, d))
        prior = prior.with_mean_prior(pm, pc)
        kwargs["mean_prior"] = (pm, np.linalg.inv(pc))
    if prior_kind in ("ridge", "all"):
        prior = prior.with_transformation_precision(0.7)
        kwargs["transformation_precision"] = 0.7

    if prior_kind == "none":
        new_model = model.iterate(ds)
    else:
        new_model = model.iterate_with_prior(ds, prior)

    want_C, want_mean, want_sigma = ref.em_iterate(
        C, mean, sigma, np.nan_to_num(data), mask, weights, **kwargs
    )

    np.testing.assert_allclose(new_model.transform, want_C, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(new_model.mean, want_mean, rtol=1e-7, atol=1e-9)
    assert np.isclose(new_model.isotropic_noise, want_sigma, rtol=1e-8)


def test_em_keeps_empty_dimension_rows(problem):
    """Empty dimensions: the row solve is singular, so the old (zero at init)
    row is kept (`ppca_model.rs:304-321`)."""
    C, mean, sigma, data, mask, weights = problem
    C = C.copy()
    C[2] = 0.0  # mimic init() zeroing the empty dimension's row
    model = PPCAModel(isotropic_noise=sigma, transform=C, mean=mean)
    new_model = model.iterate(as_dataset(data, weights))
    np.testing.assert_allclose(new_model.transform[2], np.zeros(C.shape[1]), atol=1e-12)
    # and the mean of an empty dimension stays put
    assert np.isclose(new_model.mean[2], mean[2])


def test_llk_monotone_increase(rng):
    """EM property: llk never decreases under iterate without prior
    (`ppca_model.rs:263-265`)."""
    C, mean, sigma, data, mask, weights = make_problem(rng, n=80, d=6, k=2)
    real = PPCAModel(isotropic_noise=0.3, transform=C[:, :2], mean=mean)
    ds = real.sample(200, 0.2)
    model = PPCAModel.init(2, ds)
    prev = model.llk(ds)
    for _ in range(15):
        model = model.iterate(ds)
        cur = model.llk(ds)
        assert cur >= prev - 1e-8
        prev = cur


def test_to_canonical_preserves_llk(problem):
    """to_canonical does not alter the log-probability function
    (`ppca_model.rs:395-397`)."""
    C, mean, sigma, data, mask, weights = problem
    model = PPCAModel(isotropic_noise=sigma, transform=C, mean=mean)
    ds = as_dataset(data, weights)
    canon = model.to_canonical()
    np.testing.assert_allclose(canon.llks(ds), model.llks(ds), rtol=1e-8)
    # canonical transform has orthogonal columns, scaled by singular values
    gram = canon.transform.T @ canon.transform
    np.testing.assert_allclose(gram, np.diag(np.diag(gram)), atol=1e-8)


def test_weights_equal_duplication(rng):
    """Weight w=2 must equal duplicating the sample, both in llk and in the
    EM update (`dataset.rs:93-100` semantics)."""
    C, mean, sigma, data, mask, weights = make_problem(
        rng, n=12, d=5, k=2, with_empty_row=False, with_empty_dim=False
    )
    model = PPCAModel(isotropic_noise=sigma, transform=C, mean=mean)

    w = np.ones(12)
    w[3] = 2.0
    ds_weighted = Dataset(data, weights=w)
    dup = np.concatenate([data, data[3:4]], axis=0)
    ds_dup = Dataset(dup)

    assert np.isclose(model.llk(ds_weighted), model.llk(ds_dup), rtol=1e-10)
    m1 = model.iterate(ds_weighted)
    m2 = model.iterate(ds_dup)
    np.testing.assert_allclose(m1.transform, m2.transform, rtol=1e-8)
    np.testing.assert_allclose(m1.mean, m2.mean, rtol=1e-8)
    assert np.isclose(m1.isotropic_noise, m2.isotropic_noise, rtol=1e-9)


def test_state_size_zero(rng):
    """k=0 degenerate model works end to end (`ppca_model.rs:398-401`)."""
    data = rng.normal(size=(10, 4))
    ds = Dataset(data)
    model = PPCAModel.init(0, ds)
    assert model.state_size == 0
    llk = model.llk(ds)
    assert np.isfinite(llk)
    m2 = model.iterate(ds)
    assert np.isfinite(m2.isotropic_noise)
    assert m2.to_canonical().state_size == 0
    inf = model.infer(ds)
    assert inf.states().shape == (10, 0)
