"""Brute-force NumPy reference implementation of masked PPCA.

Implements the reference's math *directly from the formulas* with explicit
per-sample loops and materialized masked covariance matrices — no Woodbury or
determinant-lemma shortcuts.  This is the parity anchor: the framework's
mask-weighted dense algebra must agree with this to f64 tolerance, the same
way the Rust reference's tricks agree with naive dense algebra.

Formulas follow `ppca/src/ppca_model.rs` and `ppca/src/output_covariance.rs`.
"""

from __future__ import annotations

import numpy as np

LN_2PI = 1.8378770664093453


def llk_one(C, mean, sigma, y, m):
    """Naive masked log-density: materialize the observed-dims covariance."""
    obs = np.nonzero(m)[0]
    if obs.size == 0:
        return 0.0
    Co = C[obs]
    cov = sigma**2 * np.eye(obs.size) + Co @ Co.T
    r = y[obs] - mean[obs]
    sol = np.linalg.solve(cov, r)
    sign, logdet = np.linalg.slogdet(cov)
    assert sign > 0
    return -0.5 * (r @ sol + logdet + LN_2PI * obs.size)


def infer_one(C, mean, sigma, y, m):
    """Posterior state mean and covariance via the full Woodbury estimator."""
    k = C.shape[1]
    obs = np.nonzero(m)[0]
    if obs.size == 0:
        return np.zeros(k), np.eye(k)
    Co = C[obs]
    cov = sigma**2 * np.eye(obs.size) + Co @ Co.T
    est = Co.T @ np.linalg.inv(cov)          # estimator_transform
    state = est @ (y[obs] - mean[obs])
    covariance = np.eye(k) - est @ Co        # estimator_covariance
    return state, covariance


def em_iterate(C, mean, sigma, data, mask, weights, *,
               transformation_precision=0.0, noise_prior=None, mean_prior=None):
    """One EM iteration following `ppca_model.rs:277-393` verbatim."""
    N, D = data.shape
    k = C.shape[1]
    states = np.zeros((N, k))
    covs = np.zeros((N, k, k))
    for n in range(N):
        states[n], covs[n] = infer_one(C, mean, sigma, data[n], mask[n])

    # cross moment (ppca_model.rs:281-293)
    cross = np.zeros((D, k))
    for n in range(N):
        centered = np.where(mask[n], data[n] - mean, 0.0)
        cross += weights[n] * np.outer(centered, states[n])

    # per-row second-moment solves (ppca_model.rs:294-325)
    new_C = np.zeros_like(C)
    for d in range(D):
        S = transformation_precision * np.eye(k)
        for n in range(N):
            if mask[n, d]:
                S += weights[n] * (np.outer(states[n], states[n]) + covs[n])
        try:
            sol = np.linalg.solve(S, cross[d])
            if not np.all(np.isfinite(sol)):
                raise np.linalg.LinAlgError
            new_C[d] = sol
        except np.linalg.LinAlgError:
            new_C[d] = C[d]

    # noise + mean statistics (ppca_model.rs:328-358)
    square_error = 0.0
    dev_sq = 0.0
    total_dev = np.zeros(D)
    totals = np.zeros(D)
    for n in range(N):
        if not mask[n].any():
            continue
        obs = np.nonzero(mask[n])[0]
        Co = C[obs]
        square_error += weights[n] * np.sum((Co @ covs[n]) * Co)
        deviation = np.where(mask[n], data[n] - C @ states[n] - mean, 0.0)
        dev_sq += weights[n] * deviation @ deviation
        total_dev += weights[n] * deviation
        totals += weights[n] * mask[n].astype(float)

    if noise_prior is not None:
        alpha, beta = noise_prior
        sigma2 = ((square_error + dev_sq) / 2.0 + beta) / (totals.sum() / 2.0 + alpha + 1.0)
    else:
        sigma2 = (square_error + dev_sq) / totals.sum()

    new_mean = np.where(totals > 0, total_dev / np.where(totals > 0, totals, 1.0), 0.0) + mean
    if mean_prior is not None:
        prior_mean, prior_precision = mean_prior
        precision = np.diag(totals) / sigma2
        total_precision = prior_precision + precision
        numerator = prior_precision @ prior_mean + precision @ new_mean
        new_mean = np.linalg.solve(total_precision, numerator)

    return new_C, new_mean, np.sqrt(sigma2)


def smoothed_cov_diag_one(C, sigma, cov):
    return np.einsum("dk,kl,dl->d", C, cov, C) + sigma**2


def extrapolated_cov_diag_one(C, sigma, cov, m):
    diag = smoothed_cov_diag_one(C, sigma, cov)
    return np.where(m, 0.0, diag)
