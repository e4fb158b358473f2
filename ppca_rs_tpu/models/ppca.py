"""Probabilistic PCA with missing data — the single model.

Rebuild of `ppca/src/ppca_model.rs` (PPCAModel / InferredMasked /
PosteriorSampler) on the mask-weighted dense algebra in
:mod:`ppca_rs_tpu.ops.masked_linalg`.  The statistical model
(`ppca_model.rs:24-40`):

    x ~ N(0, I_k)            # latent state
    y = C x + mu + eps       # observed, D dims
    eps ~ N(0, sigma^2 I_D)  # isotropic noise

Every heavy verb (llk/llks/infer/smooth/extrapolate/iterate) is a single
jitted XLA program blocked over samples; the EM iteration is one fused pass
producing both the updated parameters and the current log-likelihood.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import block_size_for, config
from ..dataset import Dataset
from ..ops import dense_fast as df
from ..ops import masked_linalg as ml
from ..ops import pattern_dedup as pd
from ..prior import Prior
from ..utils.rng import ensure_key
from ..utils.serialization import dump_bytes, load_bytes


def _as_vector(arr, name: str) -> np.ndarray:
    """Accept (D,), (D,1) or (1,D) arrays, like the bindings' numpy->vector
    converter (`src/utils.rs:12-23`)."""
    a = np.asarray(arr, dtype=np.float64)
    if a.ndim == 2:
        if 1 in a.shape:
            a = a.reshape(-1)
        else:
            raise ValueError(f"{name} must be a vector; got shape {a.shape}")
    elif a.ndim != 1:
        raise ValueError(f"{name} must be a vector; got shape {a.shape}")
    return a


AUTO_PRECISION_MIN_D = 512


def _precision(output_size: int = AUTO_PRECISION_MIN_D):
    """Matmul-precision context; "auto" resolves by output dimension (see
    config.matmul_precision)."""
    p = config.matmul_precision
    if p == "auto":
        p = "default" if output_size >= AUTO_PRECISION_MIN_D else "highest"
    return jax.default_matmul_precision(p)


def _impl_and_block(dataset: Dataset, k: int = 0):
    """Pick the single-device or shard_map implementation based on how the
    dataset's arrays are sharded (see parallel/mesh.py), plus the scan block
    size appropriate for the per-device row count (and shrunk for large
    state sizes in the blocked Schur-inverse regime — block_size_for)."""
    from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, dataset_mesh

    dense = dataset.all_observed()
    mesh = dataset_mesh(dataset)
    if mesh is None:
        bs = block_size_for(dataset.padded_len, k)
        if dense:
            return _SINGLE_DENSE, bs
        pat = dataset.pattern_info()
        if pat is not None:
            order = dataset.pattern_order()
            if order is not None:
                return _pattern_sorted_fns(*pat, order), bs
            return _pattern_fns(*pat), bs
        return _SINGLE, bs
    from ..parallel.api import fns_for

    n_data = mesh.shape[DATA_AXIS]
    use_model = MODEL_AXIS in mesh.axis_names and mesh.shape[MODEL_AXIS] > 1
    fns = fns_for(mesh, use_model, dense)
    bs = block_size_for(max(1, dataset.padded_len // n_data), k)
    if not dense and not use_model:
        # Data-axis-sharded pattern dedup: same tables, per-shard rows.
        pat = dataset.pattern_info()
        if pat is not None:
            order = dataset.pattern_order_sharded()
            if order is not None:
                return _sharded_pattern_sorted_fns(fns, *pat, order), bs
            return _sharded_pattern_fns(fns, *pat), bs
    return fns, bs


# ===================================================================== #
# jitted kernels (module-level so the compile cache is shared across model
# instances with the same shapes)

@functools.partial(jax.jit, static_argnames=("block_size",))
def _llks_jit(C, mean, sigma, data, mask, block_size):
    return ml.llks(C, mean, sigma, data, mask, block_size=block_size)


@functools.partial(jax.jit, static_argnames=("block_size",))
def _llk_jit(C, mean, sigma, data, mask, weights, block_size):
    per = ml.llks(C, mean, sigma, data, mask, block_size=block_size)
    return jnp.sum(per * weights)


@functools.partial(jax.jit, static_argnames=("block_size",))
def _infer_jit(C, mean, sigma, data, mask, block_size):
    return ml.infer(C, mean, sigma, data, mask, block_size=block_size)


def _em_body(C, mean, sigma, data, mask, weights, tprec, noise_prior,
             mean_prior, block_size):
    """One fused EM step: ((new_C, new_mean, new_sigma), llk-before).  The
    single shared body behind both the one-step jit and the n-step scan."""
    stats = ml.em_stats(C, mean, sigma, data, mask, weights, block_size=block_size)
    out = ml.em_finalize(
        C, mean, sigma, stats,
        transformation_precision=tprec,
        noise_prior=noise_prior,
        mean_prior=mean_prior,
    )
    return out, stats.llk


def _scan_em(body, C, mean, sigma, n_iters):
    """lax.scan of an ((params), llk) EM body over n_iters steps.  Returns
    (C, mean, sigma, llks) with llks[i] the llk of the model BEFORE step i."""
    def step(carry, _):
        return body(*carry)
    (C, mean, sigma), llks = jax.lax.scan(
        step, (C, mean, sigma), None, length=n_iters
    )
    return C, mean, sigma, llks


@functools.partial(jax.jit, static_argnames=("block_size",))
def _em_step_jit(C, mean, sigma, data, mask, weights, tprec, noise_prior, mean_prior, block_size):
    (new_C, new_mean, new_sigma), llk = _em_body(
        C, mean, sigma, data, mask, weights, tprec, noise_prior, mean_prior,
        block_size,
    )
    return new_C, new_mean, new_sigma, llk


@functools.partial(jax.jit, static_argnames=("block_size", "n_iters"))
def _em_n_jit(C, mean, sigma, data, mask, weights, tprec, noise_prior,
              mean_prior, block_size, n_iters):
    """``n_iters`` fused EM steps in ONE compiled program — no per-iteration
    host round-trip or dispatch."""
    def body(C, mean, sigma):
        return _em_body(C, mean, sigma, data, mask, weights, tprec,
                        noise_prior, mean_prior, block_size)
    return _scan_em(body, C, mean, sigma, n_iters)


@functools.partial(jax.jit, static_argnames=("block_size",))
def _smooth_jit(C, mean, sigma, data, mask, block_size):
    states = ml.states(C, mean, sigma, data, mask, block_size=block_size)
    return states @ C.T + mean


@functools.partial(jax.jit, static_argnames=("block_size",))
def _extrapolate_jit(C, mean, sigma, data, mask, block_size):
    states = ml.states(C, mean, sigma, data, mask, block_size=block_size)
    smoothed = states @ C.T + mean
    return jnp.where(mask, data, smoothed)


@jax.jit
def _smoothed_from_states_jit(C, mean, states):
    return states @ C.T + mean


@jax.jit
def _smoothed_cov_diag_jit(C, sigma, covs):
    # diag(C Sigma C^T)[d] = sum_{kl} C[d,k] Sigma[k,l] C[d,l]
    #                      = (Sigma_flat @ CC_flat^T)[n, d]; one matmul.
    CC = ml.outer_flat(C)
    n, k, _ = covs.shape
    return covs.reshape(n, k * k) @ CC.T + sigma * sigma


@jax.jit
def _extrapolated_cov_diag_jit(C, sigma, covs, mask):
    CC = ml.outer_flat(C)
    n, k, _ = covs.shape
    diag = covs.reshape(n, k * k) @ CC.T + sigma * sigma
    # Observed dims have zero extrapolation variance (ppca_model.rs:542-577).
    return jnp.where(mask, jnp.zeros_like(diag), diag)


@jax.jit
def _second_moments_jit(states, covs):
    return covs + states[:, :, None] * states[:, None, :]


@jax.jit
def _smoothed_cov_full_jit(C, sigma, covs):
    full = jnp.einsum("dk,nkl,el->nde", C, covs, C)
    D = C.shape[0]
    return full + (sigma * sigma) * jnp.eye(D, dtype=C.dtype)


@jax.jit
def _extrapolated_cov_full_jit(C, sigma, covs, mask):
    full = _smoothed_cov_full_jit(C, sigma, covs)
    neg = (~mask).astype(C.dtype)
    return full * neg[:, :, None] * neg[:, None, :]


@functools.partial(jax.jit, static_argnames=("n", "state_size"))
def _sample_jit(C, mean, sigma, n, state_size, mask_prob, key):
    """Generative sampling with Bernoulli masking (`ppca_model.rs:164-191`)."""
    kz, ke, km = jax.random.split(key, 3)
    dtype = C.dtype
    D = C.shape[0]
    z = jax.random.normal(kz, (n, state_size), dtype=dtype)
    eps = jax.random.normal(ke, (n, D), dtype=dtype)
    values = z @ C.T + mean + sigma * eps
    observed = jax.random.bernoulli(km, 1.0 - mask_prob, (n, D))
    return jnp.where(observed, values, 0.0), observed


@jax.jit
def _posterior_sample_jit(C, mean, sigma, states, chol, key):
    """One posterior draw per sample: y = sigma z2 + mu + C (s + L z1)
    (`ppca_model.rs:603-626` — note the reference *does* include the output
    noise term despite its doc comment; we match the code)."""
    k1, k2 = jax.random.split(key)
    n, k = states.shape
    dtype = C.dtype
    z1 = jax.random.normal(k1, (n, k), dtype=dtype)
    z2 = jax.random.normal(k2, (n, C.shape[0]), dtype=dtype)
    s = states + jnp.einsum("nkl,nl->nk", chol, z1)
    return sigma * z2 + mean + s @ C.T


@jax.jit
def _to_canonical_jit(C):
    """SVD-orthogonalize with V := I and sign-fix columns by the sign of the
    column sum (`ppca_model.rs:398-425`)."""
    U, svals, _ = jnp.linalg.svd(C, full_matrices=False)
    new_C = U * svals[None, :]
    col_sums = jnp.sum(new_C, axis=0)
    signs = jnp.where(col_sums >= 0, 1.0, -1.0).astype(C.dtype)
    return new_C * signs[None, :]


_SINGLE = {
    "llks": _llks_jit,
    "llk": _llk_jit,
    "infer": _infer_jit,
    "smooth": _smooth_jit,
    "extrapolate": _extrapolate_jit,
    "em_step": _em_step_jit,
    "em_n": _em_n_jit,
}


# --- fully-observed fast path (ops/dense_fast.py): same signatures, the mask
# argument is accepted and ignored (callers guarantee all entries observed).

@functools.partial(jax.jit, static_argnames=("block_size",))
def _llks_dense_jit(C, mean, sigma, data, mask, block_size):
    return df.llks(C, mean, sigma, data)


@functools.partial(jax.jit, static_argnames=("block_size",))
def _llk_dense_jit(C, mean, sigma, data, mask, weights, block_size):
    return jnp.sum(df.llks(C, mean, sigma, data) * weights)


@functools.partial(jax.jit, static_argnames=("block_size",))
def _infer_dense_jit(C, mean, sigma, data, mask, block_size):
    return df.infer(C, mean, sigma, data)


@functools.partial(jax.jit, static_argnames=("block_size",))
def _smooth_dense_jit(C, mean, sigma, data, mask, block_size):
    return df.states(C, mean, sigma, data) @ C.T + mean


@functools.partial(jax.jit, static_argnames=("block_size",))
def _extrapolate_dense_jit(C, mean, sigma, data, mask, block_size):
    # fully observed: extrapolation keeps every (observed) value
    return data


def _em_body_dense(C, mean, sigma, data, weights, tprec, noise_prior,
                   mean_prior, block_size):
    stats = df.em_stats(C, mean, sigma, data, weights, block_size=block_size)
    out = df.em_finalize(
        C, mean, sigma, stats,
        transformation_precision=tprec,
        noise_prior=noise_prior,
        mean_prior=mean_prior,
    )
    return out, stats.llk


@functools.partial(jax.jit, static_argnames=("block_size",))
def _em_step_dense_jit(C, mean, sigma, data, mask, weights, tprec, noise_prior, mean_prior, block_size):
    (new_C, new_mean, new_sigma), llk = _em_body_dense(
        C, mean, sigma, data, weights, tprec, noise_prior, mean_prior, block_size
    )
    return new_C, new_mean, new_sigma, llk


@functools.partial(jax.jit, static_argnames=("block_size", "n_iters"))
def _em_n_dense_jit(C, mean, sigma, data, mask, weights, tprec, noise_prior,
                    mean_prior, block_size, n_iters):
    def body(C, mean, sigma):
        return _em_body_dense(C, mean, sigma, data, weights, tprec,
                              noise_prior, mean_prior, block_size)
    return _scan_em(body, C, mean, sigma, n_iters)


_SINGLE_DENSE = {
    "llks": _llks_dense_jit,
    "llk": _llk_dense_jit,
    "infer": _infer_dense_jit,
    "smooth": _smooth_dense_jit,
    "extrapolate": _extrapolate_dense_jit,
    "em_step": _em_step_dense_jit,
    "em_n": _em_n_dense_jit,
}


# --- mask-pattern-dedup fast path (ops/pattern_dedup.py): P distinct mask
# patterns << N samples; per-pattern factorization tables replace per-sample
# ones. Signature-compatible via closures over the dataset's pattern arrays.

@functools.partial(jax.jit, static_argnames=("block_size",))
def _llks_pat_jit(C, mean, sigma, data, mask, pidx, pats, block_size):
    return pd.llks(C, mean, sigma, data, mask, pidx, pats, block_size=block_size)


@functools.partial(jax.jit, static_argnames=("block_size",))
def _llk_pat_jit(C, mean, sigma, data, mask, weights, pidx, pats, block_size):
    per = pd.llks(C, mean, sigma, data, mask, pidx, pats, block_size=block_size)
    return jnp.sum(per * weights)


@functools.partial(jax.jit, static_argnames=("block_size",))
def _infer_pat_jit(C, mean, sigma, data, mask, pidx, pats, block_size):
    return pd.infer(C, mean, sigma, data, mask, pidx, pats, block_size=block_size)


@functools.partial(jax.jit, static_argnames=("block_size",))
def _smooth_pat_jit(C, mean, sigma, data, mask, pidx, pats, block_size):
    states = pd.states(C, mean, sigma, data, mask, pidx, pats, block_size=block_size)
    return states @ C.T + mean


@functools.partial(jax.jit, static_argnames=("block_size",))
def _extrapolate_pat_jit(C, mean, sigma, data, mask, pidx, pats, block_size):
    states = pd.states(C, mean, sigma, data, mask, pidx, pats, block_size=block_size)
    smoothed = states @ C.T + mean
    return jnp.where(mask, data, smoothed)


def _em_body_pat(C, mean, sigma, data, mask, weights, pidx, pats,
                 tprec, noise_prior, mean_prior, block_size):
    stats = pd.em_stats(
        C, mean, sigma, data, mask, pidx, pats, weights, block_size=block_size
    )
    out = ml.em_finalize(
        C, mean, sigma, stats,
        transformation_precision=tprec,
        noise_prior=noise_prior,
        mean_prior=mean_prior,
    )
    return out, stats.llk


@functools.partial(jax.jit, static_argnames=("block_size",))
def _em_step_pat_jit(C, mean, sigma, data, mask, weights, pidx, pats,
                     tprec, noise_prior, mean_prior, block_size):
    (new_C, new_mean, new_sigma), llk = _em_body_pat(
        C, mean, sigma, data, mask, weights, pidx, pats,
        tprec, noise_prior, mean_prior, block_size,
    )
    return new_C, new_mean, new_sigma, llk


@functools.partial(jax.jit, static_argnames=("block_size", "n_iters"))
def _em_n_pat_jit(C, mean, sigma, data, mask, weights, pidx, pats,
                  tprec, noise_prior, mean_prior, block_size, n_iters):
    def body(C, mean, sigma):
        return _em_body_pat(C, mean, sigma, data, mask, weights, pidx, pats,
                            tprec, noise_prior, mean_prior, block_size)
    return _scan_em(body, C, mean, sigma, n_iters)


def _em_body_pat_sorted(C, mean, sigma, data_s, weights, perm, pats,
                        tprec, noise_prior, mean_prior, block_size, counts):
    # weights are sorted per call (cheap (N,) gather) so with_weights twins
    # and mixture-style reweighting reuse the cached sorted data copy.
    w_s = jnp.take(weights, perm, axis=0)
    stats = pd.em_stats_sorted(
        C, mean, sigma, data_s, w_s, pats, counts, block_size=block_size
    )
    out = ml.em_finalize(
        C, mean, sigma, stats,
        transformation_precision=tprec,
        noise_prior=noise_prior,
        mean_prior=mean_prior,
    )
    return out, stats.llk


@functools.partial(jax.jit, static_argnames=("block_size", "counts"))
def _em_step_pat_sorted_jit(C, mean, sigma, data_s, weights, perm, pats,
                            tprec, noise_prior, mean_prior, block_size,
                            counts):
    (new_C, new_mean, new_sigma), llk = _em_body_pat_sorted(
        C, mean, sigma, data_s, weights, perm, pats,
        tprec, noise_prior, mean_prior, block_size, counts,
    )
    return new_C, new_mean, new_sigma, llk


@functools.partial(jax.jit, static_argnames=("block_size", "counts", "n_iters"))
def _em_n_pat_sorted_jit(C, mean, sigma, data_s, weights, perm, pats,
                         tprec, noise_prior, mean_prior, block_size, counts,
                         n_iters):
    w_s = jnp.take(weights, perm, axis=0)  # sort once for the whole scan

    def body(C, mean, sigma):
        stats = pd.em_stats_sorted(
            C, mean, sigma, data_s, w_s, pats, counts, block_size=block_size
        )
        out = ml.em_finalize(
            C, mean, sigma, stats,
            transformation_precision=tprec,
            noise_prior=noise_prior,
            mean_prior=mean_prior,
        )
        return out, stats.llk

    return _scan_em(body, C, mean, sigma, n_iters)


def _pattern_sorted_fns(pidx, pats, order):
    """Pattern verbs with the EM steps routed through the sorted-segment
    path (ops/pattern_dedup.em_stats_sorted); readout verbs keep the
    table-grouped implementations (they are per-sample outputs, where the
    sorted layout would only add an unsort gather)."""
    fns = _pattern_fns(pidx, pats)
    data_s, perm, counts = order
    fns["em_step"] = (
        lambda C, mean, sigma, data, mask, weights, tprec, noise_prior,
               mean_prior, bs:
        _em_step_pat_sorted_jit(C, mean, sigma, data_s, weights, perm, pats,
                                tprec, noise_prior, mean_prior, bs, counts)
    )
    fns["em_n"] = (
        lambda C, mean, sigma, data, mask, weights, tprec, noise_prior,
               mean_prior, bs, n:
        _em_n_pat_sorted_jit(C, mean, sigma, data_s, weights, perm, pats,
                             tprec, noise_prior, mean_prior, bs, counts, n)
    )
    return fns


def _sharded_pattern_fns(fns, pidx, pats):
    """Adapter closures binding a sharded dataset's pattern arrays onto the
    common verb signatures (see parallel/api.py *_pat)."""
    return {
        "llks": lambda C, mean, sigma, data, mask, bs:
            fns["llks_pat"](C, mean, sigma, data, mask, pidx, pats, bs),
        "llk": lambda C, mean, sigma, data, mask, weights, bs:
            fns["llk_pat"](C, mean, sigma, data, mask, weights, pidx, pats, bs),
        "infer": lambda C, mean, sigma, data, mask, bs:
            fns["infer_pat"](C, mean, sigma, data, mask, pidx, pats, bs),
        "smooth": lambda C, mean, sigma, data, mask, bs:
            fns["smooth_pat"](C, mean, sigma, data, mask, pidx, pats, bs, False),
        "extrapolate": lambda C, mean, sigma, data, mask, bs:
            fns["smooth_pat"](C, mean, sigma, data, mask, pidx, pats, bs, True),
        "em_step": lambda C, mean, sigma, data, mask, weights, tprec, noise_prior, mean_prior, bs:
            fns["em_step_pat"](C, mean, sigma, data, mask, weights, pidx, pats,
                               tprec, noise_prior, mean_prior, bs),
        "em_n": lambda C, mean, sigma, data, mask, weights, tprec, noise_prior, mean_prior, bs, n:
            fns["em_n_pat"](C, mean, sigma, data, mask, weights, pidx, pats,
                            tprec, noise_prior, mean_prior, bs, n),
        "mix_llks": fns["mix_llks"],
        "mix_em_step": fns["mix_em_step"],
    }


def _sharded_pattern_sorted_fns(fns, pidx, pats, order):
    """Sharded pattern verbs with the EM steps routed through the
    balanced sorted-segment layout (Dataset.pattern_order_sharded):
    per-shard local segments, identical static counts on every shard,
    psum'd statistics.  Readout verbs keep the table-grouped path (same
    rationale as _pattern_sorted_fns)."""
    out = _sharded_pattern_fns(fns, pidx, pats)
    data_s, perm, valid, counts = order
    out["em_step"] = (
        lambda C, mean, sigma, data, mask, weights, tprec, noise_prior,
               mean_prior, bs:
        fns["em_step_pat_sorted"](C, mean, sigma, data_s, weights, perm,
                                  valid, pats, tprec, noise_prior,
                                  mean_prior, bs, counts)
    )
    out["em_n"] = (
        lambda C, mean, sigma, data, mask, weights, tprec, noise_prior,
               mean_prior, bs, n:
        fns["em_n_pat_sorted"](C, mean, sigma, data_s, weights, perm,
                               valid, pats, tprec, noise_prior,
                               mean_prior, bs, counts, n)
    )
    return out


def _pattern_fns(pidx, pats):
    """Adapter closures binding a dataset's pattern arrays onto the common
    verb signatures (the jit caches below are shared across datasets)."""
    return {
        "llks": lambda C, mean, sigma, data, mask, bs:
            _llks_pat_jit(C, mean, sigma, data, mask, pidx, pats, bs),
        "llk": lambda C, mean, sigma, data, mask, weights, bs:
            _llk_pat_jit(C, mean, sigma, data, mask, weights, pidx, pats, bs),
        "infer": lambda C, mean, sigma, data, mask, bs:
            _infer_pat_jit(C, mean, sigma, data, mask, pidx, pats, bs),
        "smooth": lambda C, mean, sigma, data, mask, bs:
            _smooth_pat_jit(C, mean, sigma, data, mask, pidx, pats, bs),
        "extrapolate": lambda C, mean, sigma, data, mask, bs:
            _extrapolate_pat_jit(C, mean, sigma, data, mask, pidx, pats, bs),
        "em_step": lambda C, mean, sigma, data, mask, weights, tprec, noise_prior, mean_prior, bs:
            _em_step_pat_jit(C, mean, sigma, data, mask, weights, pidx, pats,
                             tprec, noise_prior, mean_prior, bs),
        "em_n": lambda C, mean, sigma, data, mask, weights, tprec, noise_prior, mean_prior, bs, n:
            _em_n_pat_jit(C, mean, sigma, data, mask, weights, pidx, pats,
                          tprec, noise_prior, mean_prior, bs, n),
    }


# ===================================================================== #


class PPCAModel:
    """A PPCA model which can infer missing values (`ppca_model.rs:24-40`)."""

    __slots__ = ("_transform", "_mean", "_isotropic_noise")

    def __init__(self, isotropic_noise=None, transform=None, mean=None):
        if transform is None or mean is None or isotropic_noise is None:
            raise TypeError("PPCAModel requires isotropic_noise, transform and mean")
        t = np.asarray(transform, dtype=np.float64)
        if t.ndim != 2:
            raise ValueError(f"transform must be 2D (D, state_size); got {t.shape}")
        m = _as_vector(mean, "mean")
        if m.shape[0] != t.shape[0]:
            raise ValueError(
                f"mean length {m.shape[0]} does not match transform rows {t.shape[0]}"
            )
        self._transform = jnp.asarray(t)
        self._mean = jnp.asarray(m, dtype=self._transform.dtype)
        self._isotropic_noise = jnp.asarray(float(isotropic_noise), dtype=self._transform.dtype)

    @classmethod
    def _from_params(cls, transform, mean, isotropic_noise) -> "PPCAModel":
        obj = object.__new__(cls)
        obj._transform = transform
        obj._mean = mean
        obj._isotropic_noise = isotropic_noise
        return obj

    # ------------------------------------------------------------------ #
    # construction

    @staticmethod
    def init(state_size: int, dataset: Dataset, key=None) -> "PPCAModel":
        """Random untrained model: C ~ N(0,1) with empty-dimension rows
        zeroed, sigma = 1, mu = 0 (`ppca_model.rs:51-70`)."""
        if dataset.is_empty():
            raise ValueError("dataset must not be empty")
        output_size = dataset.output_size()
        key = ensure_key(key)
        # parameters live in compute precision even for bf16-storage datasets
        dtype = jnp.promote_types(dataset.dtype, jnp.float32)
        C = jax.random.normal(key, (output_size, state_size), dtype=dtype)
        empty = dataset.empty_dimensions()
        if empty:
            C = C.at[jnp.asarray(empty, dtype=jnp.int32)].set(0.0)
        mean = jnp.zeros((output_size,), dtype=dtype)
        return PPCAModel._from_params(C, mean, jnp.asarray(1.0, dtype=dtype))

    # ------------------------------------------------------------------ #
    # accessors (ppca_model.rs:73-121; exposed as properties like the
    # bindings, src/python_bindings.rs:403-447)

    @property
    def transform(self) -> np.ndarray:
        return np.asarray(self._transform)

    @property
    def mean(self) -> np.ndarray:
        return np.asarray(self._mean)

    @property
    def isotropic_noise(self) -> float:
        return float(self._isotropic_noise)

    @property
    def output_size(self) -> int:
        return int(self._transform.shape[0])

    @property
    def state_size(self) -> int:
        return int(self._transform.shape[1])

    @property
    def n_parameters(self) -> int:
        """1 + k*D + D (`ppca_model.rs:107-109`)."""
        return 1 + self.state_size * self.output_size + self.output_size

    @property
    def singular_values(self) -> np.ndarray:
        """sqrt of each column norm — matches the reference exactly, which
        takes ``column.norm().sqrt()`` (`ppca_model.rs:113-121`)."""
        norms = jnp.linalg.norm(self._transform, axis=0)
        return np.asarray(jnp.sqrt(norms))

    def __repr__(self) -> str:
        return (
            f"PPCAModel(isotropic_noise={self.isotropic_noise}, "
            f"transform=array({self.transform.tolist()}), "
            f"mean=array({self.mean.tolist()}))"
        )

    # ------------------------------------------------------------------ #
    # serialization (src/python_bindings.rs:388-401,513-532)

    def dump(self) -> bytes:
        return dump_bytes(
            "ppca_model",
            {
                "transform": np.asarray(self._transform, dtype=np.float64),
                "mean": np.asarray(self._mean, dtype=np.float64),
                "isotropic_noise": np.asarray(self.isotropic_noise, dtype=np.float64),
            },
        )

    @staticmethod
    def load(data: bytes) -> "PPCAModel":
        arrays, _ = load_bytes(data, "ppca_model")
        return PPCAModel(
            isotropic_noise=float(arrays["isotropic_noise"]),
            transform=arrays["transform"],
            mean=arrays["mean"],
        )

    def __getstate__(self):
        return self.dump()

    def __setstate__(self, state):
        other = PPCAModel.load(state)
        self._transform = other._transform
        self._mean = other._mean
        self._isotropic_noise = other._isotropic_noise

    def __reduce__(self):
        return (PPCAModel.load, (self.dump(),))

    # ------------------------------------------------------------------ #
    # likelihood (ppca_model.rs:124-159)

    def llk(self, dataset: Dataset) -> float:
        """Weighted total log-likelihood (`ppca_model.rs:142-149`)."""
        if dataset.is_empty():
            return 0.0
        fns, bs = _impl_and_block(dataset, self.state_size)
        with _precision(self.output_size):
            out = fns["llk"](
                self._transform, self._mean, self._isotropic_noise,
                dataset.data, dataset.mask, dataset.weights_dev, bs,
            )
        return float(out)

    def llks(self, dataset: Dataset) -> np.ndarray:
        """Per-sample log-likelihoods (`ppca_model.rs:152-159`)."""
        return np.asarray(self._llks_device(dataset))[: len(dataset)]

    def _llks_device(self, dataset: Dataset):
        """Per-sample llks as a device array over the (possibly padded)
        physical rows — used by the mixture layer to stay on device."""
        fns, bs = _impl_and_block(dataset, self.state_size)
        with _precision(self.output_size):
            return fns["llks"](
                self._transform, self._mean, self._isotropic_noise,
                dataset.data, dataset.mask, bs,
            )

    # ------------------------------------------------------------------ #
    # sampling (ppca_model.rs:164-191)

    def sample(self, dataset_size: int, mask_prob: float, key=None) -> Dataset:
        key = ensure_key(key)
        with _precision(self.output_size):
            values, observed = _sample_jit(
                self._transform, self._mean, self._isotropic_noise,
                int(dataset_size), self.state_size, float(mask_prob), key,
            )
        return Dataset.from_parts(values, observed)

    # ------------------------------------------------------------------ #
    # inference (ppca_model.rs:195-261)

    def uninferred(self, n: int = 1) -> "InferredMasked":
        """Zeroed posterior batch compatible with this model — the prior
        N(0, I) used for all-masked samples (`ppca_model.rs:98-104`)."""
        k = self.state_size
        dtype = self._transform.dtype
        return InferredMasked(
            self,
            jnp.zeros((n, k), dtype=dtype),
            jnp.broadcast_to(jnp.eye(k, dtype=dtype), (n, k, k)),
        )

    def inferred_one(self, state, covariance) -> "InferredMasked":
        """Build a posterior batch from raw values (`ppca_model.rs:211-217`);
        accepts a single (k,)/(k,k) pair or stacked (n,k)/(n,k,k) arrays."""
        state = jnp.atleast_2d(jnp.asarray(state, dtype=self._transform.dtype))
        covariance = jnp.asarray(covariance, dtype=self._transform.dtype)
        if covariance.ndim == 2:
            covariance = covariance[None]
        return InferredMasked(self, state, covariance)

    def infer(self, dataset: Dataset) -> "InferredMasked":
        states, covs = self._infer_arrays(dataset)
        return InferredMasked(self, states, covs)

    def _infer_arrays(self, dataset: Dataset):
        fns, bs = _impl_and_block(dataset, self.state_size)
        with _precision(self.output_size):
            states, covs = fns["infer"](
                self._transform, self._mean, self._isotropic_noise,
                dataset.data, dataset.mask, bs,
            )
        n = len(dataset)
        return states[:n], covs[:n]

    def smooth(self, dataset: Dataset) -> Dataset:
        """De-noise observed values and fill missing ones
        (`ppca_model.rs:231-244`); preserves dataset weights."""
        fns, bs = _impl_and_block(dataset, self.state_size)
        with _precision(self.output_size):
            smoothed = fns["smooth"](
                self._transform, self._mean, self._isotropic_noise,
                dataset.data, dataset.mask, bs,
            )
        n = len(dataset)
        return Dataset.unmasked(smoothed[:n], dataset.weights_dev[:n])

    def extrapolate(self, dataset: Dataset) -> Dataset:
        """Fill missing values, keeping observed ones untouched
        (`ppca_model.rs:248-261`); preserves dataset weights."""
        fns, bs = _impl_and_block(dataset, self.state_size)
        with _precision(self.output_size):
            extr = fns["extrapolate"](
                self._transform, self._mean, self._isotropic_noise,
                dataset.data, dataset.mask, bs,
            )
        n = len(dataset)
        return Dataset.unmasked(extr[:n], dataset.weights_dev[:n])

    # ------------------------------------------------------------------ #
    # EM (ppca_model.rs:263-393)

    def iterate(self, dataset: Dataset) -> "PPCAModel":
        """One EM iteration; the log-likelihood always increases
        (`ppca_model.rs:263-269`)."""
        model, _ = self._iterate_with_llk(dataset, None)
        return model

    def iterate_with_prior(self, dataset: Dataset, prior: Prior) -> "PPCAModel":
        """One MAP-EM iteration with the supplied prior
        (`ppca_model.rs:271-393`)."""
        model, _ = self._iterate_with_llk(dataset, prior)
        return model

    def _iterate_with_llk(self, dataset: Dataset, prior: Optional[Prior]) -> Tuple["PPCAModel", float]:
        """Fused EM step: returns (new model, llk of *this* model on the
        dataset) computed in the same pass over the data."""
        if dataset.is_empty():
            # the reference panics with expect("non-empty dataset")
            # (ppca_model.rs:358); raise instead of returning a NaN model.
            raise ValueError("cannot iterate on an empty dataset")
        dtype = self._transform.dtype
        if prior is None:
            prior = Prior()
        tprec, noise_prior, mean_prior = prior.device_pieces(dtype)
        fns, bs = _impl_and_block(dataset, self.state_size)
        with _precision(self.output_size):
            new_C, new_mean, new_sigma, llk = fns["em_step"](
                self._transform, self._mean, self._isotropic_noise,
                dataset.data, dataset.mask, dataset.weights_dev,
                tprec, noise_prior, mean_prior, bs,
            )
        return PPCAModel._from_params(new_C, new_mean, new_sigma), float(llk)

    def iterate_n(
        self, dataset: Dataset, n_iters: int, prior: Optional[Prior] = None
    ) -> Tuple["PPCAModel", np.ndarray]:
        """``n_iters`` (MAP-)EM iterations in ONE compiled program.

        Semantically identical to calling :meth:`iterate` /
        :meth:`iterate_with_prior` ``n_iters`` times, but the whole loop is a
        single ``lax.scan`` on device: no per-iteration dispatch or host
        sync (~35 ms/iteration saved in remote-device setups, and the llk of
        every iteration still comes back for free).  Returns
        ``(model, llks)`` where ``llks[i]`` is the log-likelihood of the
        model *before* iteration ``i`` (same convention as the trainers).
        An extra — the reference iterates one step at a time."""
        if dataset.is_empty():
            raise ValueError("cannot iterate on an empty dataset")
        if n_iters <= 0:
            return self, np.zeros((0,))
        dtype = self._transform.dtype
        if prior is None:
            prior = Prior()
        tprec, noise_prior, mean_prior = prior.device_pieces(dtype)
        fns, bs = _impl_and_block(dataset, self.state_size)
        with _precision(self.output_size):
            new_C, new_mean, new_sigma, llks = fns["em_n"](
                self._transform, self._mean, self._isotropic_noise,
                dataset.data, dataset.mask, dataset.weights_dev,
                tprec, noise_prior, mean_prior, bs, int(n_iters),
            )
        return PPCAModel._from_params(new_C, new_mean, new_sigma), np.asarray(llks)

    # ------------------------------------------------------------------ #

    def to_canonical(self) -> "PPCAModel":
        """Canonical rotation of the latent space; does not alter the
        log-probability function (`ppca_model.rs:395-425`)."""
        if self.state_size == 0:
            return self
        if self.state_size > self.output_size:
            # SVD with V := I is shape-inconsistent here; the reference
            # panics in recompose() (ppca_model.rs:412).
            raise ValueError(
                "to_canonical requires state_size <= output_size "
                f"(got {self.state_size} > {self.output_size})"
            )
        with _precision(self.output_size):
            new_C = _to_canonical_jit(self._transform)
        return PPCAModel._from_params(new_C, self._mean, self._isotropic_noise)


class InferredMasked:
    """Batch of per-sample posterior distributions in state space — the
    Python-facing twin of the reference's batch wrapper
    (`src/python_bindings.rs:203-345` over `ppca_model.rs:428-593`)."""

    def __init__(self, model: PPCAModel, states, covariances):
        self._model = model
        self._states = states          # (N, k)
        self._covariances = covariances  # (N, k, k)

    def __len__(self) -> int:
        return int(self._states.shape[0])

    def states(self) -> np.ndarray:
        return np.asarray(self._states)

    def covariances(self) -> List[np.ndarray]:
        """List of per-sample (k, k) posterior covariances (parity with the
        list-returning binding at `src/python_bindings.rs:228-234`)."""
        return list(np.asarray(self._covariances))

    def covariances_array(self) -> np.ndarray:
        """(N, k, k) stacked covariances — an extra over the reference."""
        return np.asarray(self._covariances)

    def second_moments(self) -> List[np.ndarray]:
        """Per-sample posterior second moments ``s s^T + Sigma``
        (`ppca_model.rs:437-439`; absent from the reference's Python
        bindings — exposed here for core-crate parity)."""
        return list(np.asarray(_second_moments_jit(self._states, self._covariances)))

    def second_moments_array(self) -> np.ndarray:
        """(N, k, k) stacked second moments — an extra over the reference."""
        return np.asarray(_second_moments_jit(self._states, self._covariances))

    def smoothed(self, model: PPCAModel) -> Dataset:
        """C s + mu per sample (`ppca_model.rs:454-457`)."""
        with _precision(self._model.output_size):
            out = _smoothed_from_states_jit(model._transform, model._mean, self._states)
        return Dataset.unmasked(out)

    def extrapolated(self, model: PPCAModel, dataset: Dataset) -> Dataset:
        """Observed values kept, missing filled from the posterior
        (`ppca_model.rs:460-463`)."""
        n = len(dataset)
        with _precision(self._model.output_size):
            smoothed = _smoothed_from_states_jit(model._transform, model._mean, self._states)
            out = jnp.where(dataset.mask[:n], dataset.data[:n], smoothed)
        return Dataset.unmasked(out)

    def smoothed_covariances(self, model: PPCAModel) -> List[np.ndarray]:
        """Full (D, D) smoothed output covariances (`ppca_model.rs:471-477`)."""
        with _precision(self._model.output_size):
            full = _smoothed_cov_full_jit(model._transform, model._isotropic_noise, self._covariances)
        return list(np.asarray(full))

    def smoothed_covariances_diagonal(self, model: PPCAModel) -> Dataset:
        """Diagonal-only smoothed covariance via the row-dot trick
        (`ppca_model.rs:485-508`), one matmul."""
        with _precision(self._model.output_size):
            diag = _smoothed_cov_diag_jit(model._transform, model._isotropic_noise, self._covariances)
        return Dataset.unmasked(diag)

    def extrapolated_covariances(self, model: PPCAModel, dataset: Dataset) -> List[np.ndarray]:
        """Full (D, D) extrapolation covariances, zero at observed dims
        (`ppca_model.rs:517-534`)."""
        with _precision(self._model.output_size):
            full = _extrapolated_cov_full_jit(
                model._transform, model._isotropic_noise, self._covariances,
                dataset.mask[: len(dataset)],
            )
        return list(np.asarray(full))

    def extrapolated_covariances_diagonal(self, model: PPCAModel, dataset: Dataset) -> Dataset:
        """Diagonal extrapolation variances, zero at observed dims
        (`ppca_model.rs:542-577`)."""
        with _precision(self._model.output_size):
            diag = _extrapolated_cov_diag_jit(
                model._transform, model._isotropic_noise, self._covariances,
                dataset.mask[: len(dataset)],
            )
        return Dataset.unmasked(diag)

    def posterior_sampler(self) -> "PosteriorSampler":
        """Cholesky-factor the posterior covariances for repeated sampling
        (`ppca_model.rs:581-592`)."""
        chol = jnp.linalg.cholesky(self._covariances)
        if not bool(jnp.all(jnp.isfinite(chol))):
            raise ValueError("Cholesky decomposition failed: posterior covariance not PD")
        return PosteriorSampler(self._model, self._states, chol)


class PosteriorSampler:
    """Batch sampler from per-sample posteriors (`ppca_model.rs:595-626`).

    Each ``sample()`` call returns a Dataset with one fresh draw per sample:
    ``y = sigma z2 + mu + C (s + L z1)`` — including the output noise term,
    matching the reference code (not its doc comment)."""

    def __init__(self, model: PPCAModel, states, chol):
        self._model = model
        self._states = states
        self._chol = chol

    def sample(self, key=None) -> Dataset:
        key = ensure_key(key)
        with _precision(self._model.output_size):
            out = _posterior_sample_jit(
                self._model._transform, self._model._mean, self._model._isotropic_noise,
                self._states, self._chol, key,
            )
        return Dataset.unmasked(out)
