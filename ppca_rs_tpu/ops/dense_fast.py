"""Fully-observed fast path.

When a dataset has no missing entries, every sample shares the same posterior
precision ``M = sigma^2 I + C^T C`` — so the per-sample factorizations that
dominate the masked E-step collapse to ONE k x k solve, and the whole EM
iteration reduces to a few large matmuls:

    b      = (Y - mu) C                    (N,D)x(D,k)
    s      = b M^{-1}                      posterior states
    cross  = (w * R)^T s                   (D,N)x(N,k)
    S      = s^T diag(w) s + (sum w) sigma^2 M^{-1}     ONE (k,k) matrix —
             every output row d shares it, so the M-step's D row solves
             (`ppca_model.rs:294-325`) become one solve with D right-hand
             sides
    dev    = R - s C^T                     residuals for the noise/mean update

That is ~6 D k flops per sample instead of the masked path's ~4 D k^2 — about
k/10 x fewer (40x at k=64), putting fully-observed EM at matmul speed.
Semantically identical to the masked path with an all-True mask (tested), and
therefore to the reference which always walks the per-sample masked route.

Neutral padding rows (all-masked, zero-weight) are handled by *weights*
alone here: the mask is ignored, padded rows produce garbage per-sample
values that are weighted by 0 in every reduction and sliced off per-sample
outputs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .masked_linalg import LN_2PI, _psum, _scan_blocks, compute_dtype


class DensePosterior(NamedTuple):
    M: jax.Array        # (k, k) shared posterior precision
    Minv: jax.Array     # (k, k)
    logdet: jax.Array   # scalar log det M
    Sigma: jax.Array    # (k, k) = sigma^2 M^{-1}


def dense_posterior(C: jax.Array, sigma: jax.Array, axis_model: Optional[str] = None) -> DensePosterior:
    """The one shared k x k solve (model-axis rows psum into the full Gram)."""
    k = C.shape[1]
    dtype = C.dtype
    sigma2 = sigma * sigma
    G = _psum(C.T @ C, axis_model)
    M = G + sigma2 * jnp.eye(k, dtype=dtype)
    L = jnp.linalg.cholesky(M)
    eye = jnp.eye(k, dtype=dtype)
    Minv = jax.scipy.linalg.cho_solve((L, True), eye)
    if k > 0:
        logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
    else:
        logdet = jnp.zeros((), dtype)
    return DensePosterior(M=M, Minv=Minv, logdet=logdet, Sigma=sigma2 * Minv)


def _centered_products(C, mean, data, axis_model):
    """b = (Y - mu) C and rowwise |Y - mu|^2.

    Written against the centered values directly (XLA fuses the broadcast
    subtraction into the matmul/reduction loads, so no (N, D) temporary is
    forced) — NOT via the expanded |Y|^2 - 2 Y.mu + |mu|^2 / YC - muC
    forms, whose cancellation destroys f32 accuracy whenever |mu| is large
    relative to the residual spread."""
    R = data - mean[None, :]
    b = _psum(R @ C, axis_model)
    rnorm = _psum(jnp.sum(R * R, axis=-1), axis_model)
    return b, rnorm


def llks(C, mean, sigma, data, *, axis_model: Optional[str] = None) -> jax.Array:
    """Per-sample log-likelihood, fully observed: one shared log-det and a
    quadratic form through the shared M^{-1}."""
    k = C.shape[1]
    post = dense_posterior(C, sigma, axis_model)
    b, rnorm = _centered_products(C, mean, data, axis_model)
    quad = (rnorm - jnp.sum((b @ post.Minv) * b, axis=-1)) / (sigma * sigma)
    # COMPUTE dtype, never the storage dtype: a bf16 d_obs would drag the
    # weakly-typed LN_2PI constant down to bf16 (1.836 vs 1.8379 — a ~1e-3
    # shift on every llk; caught by test_dense_bf16_storage_fold_matches_f32).
    d_obs = _psum(jnp.asarray(data.shape[1], compute_dtype(data.dtype, C.dtype)),
                  axis_model)
    logdet = post.logdet + 2.0 * jnp.log(sigma) * (d_obs - k)
    return -0.5 * (quad + logdet + LN_2PI * d_obs)


def states(C, mean, sigma, data, *, axis_model: Optional[str] = None) -> jax.Array:
    post = dense_posterior(C, sigma, axis_model)
    b, _ = _centered_products(C, mean, data, axis_model)
    return b @ post.Minv


def infer(C, mean, sigma, data, *, axis_model: Optional[str] = None):
    post = dense_posterior(C, sigma, axis_model)
    b, _ = _centered_products(C, mean, data, axis_model)
    s = b @ post.Minv
    covs = jnp.broadcast_to(post.Sigma, (data.shape[0],) + post.Sigma.shape)
    return s, covs


class DenseEMStats(NamedTuple):
    """Dense-path sufficient statistics.  ``S_common`` is the single (k, k)
    second-moment matrix shared by every output row; ``totals`` collapses to
    the scalar weight sum.  Sharding discipline matches
    masked_linalg.EMStats: cross/total_dev are D-local;
    llk/S_common/square_error/w_sum/dev_sq are model-replicated (dev_sq is
    computed from the model-full rnorm/b/G, not from local residual columns)."""

    cross: jax.Array         # (D_loc, k)
    S_common: jax.Array      # (k, k)
    square_error: jax.Array  # scalar
    dev_sq: jax.Array        # scalar (model-replicated)
    total_dev: jax.Array     # (D_loc,)
    w_sum: jax.Array         # scalar (model-replicated)
    llk: jax.Array           # scalar (model-replicated)


def em_stats(C, mean, sigma, data, weights, *, block_size: int,
             axis_model: Optional[str] = None) -> DenseEMStats:
    """Fused dense EM statistics, blocked over N for bounded temporaries.

    The scan body never materializes a RESIDUAL (B, D) array: the residual
    statistics are re-expressed through the posterior identities, so each
    block costs TWO (B, D)x(D, k) matmuls (``R @ C`` and ``R^T @ sw``) and
    one reduction pass — the third matmul (``s @ C^T``) and the dev array
    of the naive form disappear:

        |dev|^2   = |R - s C^T|^2 = |R|^2 - b.s - sigma^2 |s|^2   (row-wise;
                    s^T G s = b.s - sigma^2 |s|^2 exactly, since M s = b and
                    G = M - sigma^2 I)
        total_dev = w @ dev = w R - C (sum sw)

    Centering is computed as ``data - mean`` directly (XLA fuses the
    broadcast subtraction into the consuming matmul/reduction loads) — the
    expanded uncentered forms (|data|^2 - 2 data.mu + ..., data C - mu C)
    cancel catastrophically in f32 when |mu| is large relative to the
    residual spread.
    """
    n, D_loc = data.shape
    k = C.shape[1]
    dtype = compute_dtype(data.dtype, C.dtype)
    sigma2 = sigma * sigma
    post = dense_posterior(C, sigma, axis_model)
    d_obs = _psum(jnp.asarray(D_loc, dtype), axis_model)
    logdet_obs = post.logdet + 2.0 * jnp.log(sigma) * (d_obs - k)
    G = post.M - sigma2 * jnp.eye(k, dtype=dtype)     # = C^T C (model-full)

    def body(acc, fresh, datab, w):
        datab = datab.astype(dtype)
        # stale rows (final-window overlap, _scan_blocks) zero their
        # weight; every statistic below is w-linear.
        w = w.astype(dtype) * fresh.astype(dtype)
        R = datab - mean[None, :]
        b = _psum(R @ C, axis_model)                            # (B, k)
        s = b @ post.Minv
        sw = s * w[:, None]
        sw_sum = jnp.sum(sw, axis=0)                            # (k,)
        w_sum = jnp.sum(w)
        cross = R.T @ sw                                        # (D_loc, k)
        wR = w @ R                                              # (D_loc,)
        S_part = s.T @ sw                                       # (k, k)
        rnorm = _psum(jnp.sum(R * R, axis=-1), axis_model)
        bs = jnp.sum(b * s, axis=-1)
        # clamp: the cancellation can dip epsilon-negative in f32 when the
        # model explains the data almost exactly (|dev|^2 ~ 0); a negative
        # sum would NaN the sigma update via sqrt.
        dev_sq = jnp.sum(w * jnp.maximum(
            rnorm - bs - sigma2 * jnp.sum(s * s, axis=-1), 0.0))
        total_dev = wR - C @ sw_sum                             # (D_loc,)
        quad = (rnorm - bs) / sigma2
        llk_b = -0.5 * (quad + logdet_obs + LN_2PI * d_obs)
        llk = jnp.sum(w * llk_b)
        return (acc[0] + cross, acc[1] + S_part), (dev_sq, total_dev, w_sum, llk)

    zero = (jnp.zeros((D_loc, k), dtype), jnp.zeros((k, k), dtype))
    (cross, S_part), small, _ = _scan_blocks(n, block_size, (data, weights), body, zero)
    dev_sq, total_dev, w_sum, llk = (jnp.sum(x, axis=0) for x in small)

    S_common = S_part + w_sum * post.Sigma
    square_error = w_sum * jnp.sum(G * post.Sigma)
    return DenseEMStats(
        cross=cross,
        S_common=S_common,
        square_error=square_error,
        dev_sq=dev_sq,
        total_dev=total_dev,
        w_sum=w_sum,
        llk=llk,
    )


def em_finalize(C, mean, sigma, stats: DenseEMStats, *,
                transformation_precision,
                noise_prior=None, mean_prior=None,
                axis_model: Optional[str] = None):
    """Dense M-step: ONE (k, k) solve with D right-hand sides replaces the D
    per-row solves; mean/noise updates use the scalar observation count."""
    D_loc, k = C.shape
    dtype = C.dtype

    if k > 0:
        A = stats.S_common + transformation_precision * jnp.eye(k, dtype=dtype)
        sol = jnp.linalg.solve(A, stats.cross.T).T        # (D_loc, k)
        ok = jnp.all(jnp.isfinite(sol))
        new_C = jnp.where(ok, sol, C)
    else:
        new_C = C

    d_obs = _psum(jnp.asarray(D_loc, dtype), axis_model)
    sq = stats.square_error + stats.dev_sq   # both model-replicated
    n_obs = stats.w_sum * d_obs
    if noise_prior is not None:
        alpha, beta = noise_prior
        sigma2_new = (sq / 2.0 + beta) / (n_obs / 2.0 + alpha + 1.0)
    else:
        sigma2_new = sq / n_obs

    # Mirror the masked path's totals>0 guard: an all-zero-weight dataset
    # keeps the old mean instead of NaN-ing it.
    new_mean = jnp.where(stats.w_sum > 0, stats.total_dev / jnp.where(stats.w_sum > 0, stats.w_sum, 1.0), 0.0) + mean
    if mean_prior is not None:
        prior_mean, prior_precision = mean_prior
        if axis_model is not None:
            mean_full = lax.all_gather(new_mean, axis_model, tiled=True)
        else:
            mean_full = new_mean
        data_precision = stats.w_sum / sigma2_new
        total_precision = prior_precision + data_precision * jnp.eye(
            prior_precision.shape[0], dtype=dtype
        )
        numerator = prior_precision @ prior_mean + data_precision * mean_full
        smoothed = jnp.linalg.solve(total_precision, numerator)
        if axis_model is not None:
            idx = lax.axis_index(axis_model)
            new_mean = lax.dynamic_slice_in_dim(smoothed, idx * D_loc, D_loc)
        else:
            new_mean = smoothed

    return new_C, new_mean, jnp.sqrt(sigma2_new)
