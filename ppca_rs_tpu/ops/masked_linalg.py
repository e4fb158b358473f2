"""Mask-weighted dense linear algebra for masked PPCA.

This replaces the reference's ragged per-sample algebra
(`ppca/src/output_covariance.rs`): instead of gathering the observed
rows of ``C`` into a smaller matrix per sample (hostile to XLA's static
shapes), every sample runs the same fixed-shape kernel using mask-weighted
dense algebra.  The two formulations are algebraically identical:

* masked inner matrix ``M_n = sigma^2 I_k + C^T diag(m_n) C`` equals the
  reference's ``sub_covariance.inner_matrix`` (`output_covariance.rs:61-64`
  computed on the mask-gathered rows) because rows of ``C`` at masked
  dimensions contribute nothing to the Gram.
* the posterior state is ``s_n = M_n^{-1} C^T (m_n * (y_n - mu))`` which by
  the push-through identity equals the reference's Woodbury
  ``estimator_transform`` applied to the gathered sample
  (`output_covariance.rs:72-94`), and the posterior covariance is
  ``Sigma_n = sigma^2 M_n^{-1}``, equal to ``estimator_covariance``
  (`output_covariance.rs:96-101`).
* the log-likelihood uses ``x^T Cov^{-1} x = (|r|^2 - b^T M^{-1} b)/sigma^2``
  (the reference's ``quadratic_form``, `output_covariance.rs:133-142`) and the
  matrix-determinant-lemma log-det restricted to observed dims:
  ``log det = log det(M) + 2 log(sigma) (|m| - k)``
  (`output_covariance.rs:103-121`).

The matmul mapping trick: since masks are 0/1, ``C^T diag(m) C`` is a *linear*
function of the mask — ``sum_d m_d c_d c_d^T``.  Flattening the per-row outer
products into ``CC in R^{D x k^2}`` turns the per-sample Gram for a whole
batch into ONE dense matmul ``mask @ CC`` of shape ``(B, D) x (D, k^2)``.
The M-step's ``S[d] = sum_n w_n m_{nd} (s_n s_n^T + Sigma_n)`` (the per-row second-moment
sums at `ppca_model.rs:294-325`) is the transpose trick:
``(w*m)^T @ SM_flat`` of shape ``(D, B) x (B, k^2)`` — also one matmul, and it
computes each sample's second moment once (the reference recomputes it per
observed (row, sample) pair).

Everything is blocked over N with ``lax.scan`` so peak memory is
O(block * (D + k^2)) regardless of dataset size, and every function takes an
optional ``axis_model`` mesh-axis name: when the D dimension is sharded
(tensor-parallel layout), the two small cross-shard reductions (``b`` and
``G``) become ``psum`` s and everything else stays local.

The per-sample k x k SPD work (factor, solve, inverse, log-determinant)
takes one of three routes, chosen in one place (:func:`spd_route`): the
fused Pallas kernel of ops/kernels.py, the blocked Schur inverse of
ops/block_spd.py for large k, or XLA's batched Cholesky — the reference
semantics, and the only route on the CPU.

All empty-sample / empty-dimension special cases of the reference fall out of
the algebra with no branches: an all-masked sample has ``m = 0`` so
``M = sigma^2 I``, ``s = 0``, ``Sigma = I`` (the reference's ``uninferred``,
`ppca_model.rs:98-104,196-198`) and its log-likelihood is exactly 0
(`ppca_model.rs:124-129`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import cho_solve

LN_2PI = 1.8378770664093453


def compute_dtype(storage_dtype, model_dtype=jnp.float32):
    """Storage may be bf16 (halves device memory per sample); all math runs
    in at least f32 (and at the model's dtype when that is wider, e.g. f64 on CPU) —
    blocks are upcast as they enter the scan body, so accumulators,
    posteriors and statistics keep full precision."""
    return jnp.promote_types(jnp.promote_types(storage_dtype, jnp.float32), model_dtype)


def _psum(x, axis_name: Optional[str]):
    return lax.psum(x, axis_name) if axis_name is not None else x


def outer_flat(C: jax.Array) -> jax.Array:
    """Per-row flattened outer products: ``CC[d] = vec(c_d c_d^T)``, (D, k*k)."""
    D, k = C.shape
    return (C[:, :, None] * C[:, None, :]).reshape(D, k * k)


class BlockPosterior(NamedTuple):
    """Per-block E-step quantities. ``R``, ``G_local`` are model-shard local;
    the solved quantities (``states``, ``chol``, ...) are model-replicated.

    Exactly one of ``chol`` / (``Minv``, ``logdet_m``) is populated: the XLA
    path factors M, the large-k blocked path (ops/block_spd.py) inverts it."""

    R: jax.Array        # (B, D_loc) masked centered data
    b: jax.Array        # (B, k) = C^T r   (model-reduced)
    G_local: jax.Array  # (B, k*k) local mask Gram (before model psum)
    M: jax.Array        # (B, k, k) = sigma^2 I + C^T diag(m) C
    chol: Optional[jax.Array]  # (B, k, k) lower Cholesky of M (XLA path)
    states: jax.Array   # (B, k) posterior means
    d_obs: jax.Array    # (B,) observed-entry counts (model-reduced)
    Minv: Optional[jax.Array] = None      # (B, k, k) M^{-1} (blocked path)
    logdet_m: Optional[jax.Array] = None  # (B,) log det M  (blocked path)


def block_posterior(
    C: jax.Array,
    CC: jax.Array,
    mean: jax.Array,
    sigma: jax.Array,
    data: jax.Array,
    mask_f: jax.Array,
    axis_model: Optional[str] = None,
    use_blocked: bool = False,
) -> BlockPosterior:
    """Fixed-shape E-step for one block of samples.

    Mirrors `ppca_model.rs:195-208` (infer_one) batched over the block.
    ``use_blocked`` (static) routes the factorization through the blocked
    Schur-complement inverse (large k, see :mod:`.block_spd`).
    """
    k = C.shape[1]
    n = data.shape[0]
    dtype = data.dtype
    sigma2 = sigma * sigma
    R = mask_f * (data - mean)
    b = _psum(R @ C, axis_model)
    G_local = mask_f @ CC
    G = _psum(G_local, axis_model).reshape(n, k, k)
    M = G + sigma2 * jnp.eye(k, dtype=dtype)
    d_obs = _psum(jnp.sum(mask_f, axis=-1), axis_model)
    if use_blocked:
        from . import block_spd

        Minv, logdet_m = block_spd.inv_logdet(M)
        states = block_spd.mm_hp(Minv, b[..., None])[..., 0]
        return BlockPosterior(R=R, b=b, G_local=G_local, M=M, chol=None,
                              states=states, d_obs=d_obs, Minv=Minv,
                              logdet_m=logdet_m)
    L = jnp.linalg.cholesky(M)
    states = cho_solve((L, True), b[..., None])[..., 0]
    return BlockPosterior(R=R, b=b, G_local=G_local, M=M, chol=L, states=states, d_obs=d_obs)


def block_covariances(post: BlockPosterior, sigma: jax.Array) -> jax.Array:
    """Posterior state covariances ``Sigma = sigma^2 M^{-1}`` for a block."""
    if post.Minv is not None:
        return (sigma * sigma) * post.Minv
    k = post.chol.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(k, dtype=post.chol.dtype), post.chol.shape)
    return (sigma * sigma) * cho_solve((post.chol, True), eye)


def block_llk(
    post: BlockPosterior, sigma: jax.Array, k: int, axis_model: Optional[str] = None
) -> jax.Array:
    """Per-sample log-likelihood for a block (`ppca_model.rs:124-139`).
    ``R`` is model-shard local, so its squared norm is psum-reduced here;
    every other input is already model-replicated."""
    sigma2 = sigma * sigma
    rnorm = _psum(jnp.sum(post.R * post.R, axis=-1), axis_model)
    quad = (rnorm - jnp.sum(post.b * post.states, axis=-1)) / sigma2
    if post.logdet_m is not None:
        logdet_m = post.logdet_m
    elif k > 0:
        diag = jnp.diagonal(post.chol, axis1=-2, axis2=-1)
        logdet_m = 2.0 * jnp.sum(jnp.log(diag), axis=-1)
    else:
        logdet_m = jnp.zeros_like(post.d_obs)
    logdet = logdet_m + 2.0 * jnp.log(sigma) * (post.d_obs - k)
    return -0.5 * (quad + logdet + LN_2PI * post.d_obs)


def spd_route(k: int, dtype, want: str, sharded: bool, platform: Optional[str] = None) -> str:
    """Where the per-sample k x k SPD work runs: ``"kernel"`` (the fused
    Pallas E-step, ops/kernels.py), ``"blocked"`` (the blocked Schur
    inverse, ops/block_spd.py) or ``"xla"`` (batched Cholesky — the
    reference semantics).  ``want`` names the work: an E-step variant of
    ``kernels.WANTS``, or ``"rows"`` for the M-step row solve
    (em_finalize), which rides the kernel's states variant.

    Only a GPU leaves ``"xla"``, for f32 work on an unsharded D (the kernel
    sees whole Grams; with D sharded the Gram is a psum the XLA route
    already carries).  Up to ``kernels.MAX_K`` the kernel serves every
    ``want``: each beat XLA's route on an H100 at k <= 64 (docs/DESIGN.md
    §2).  Past ``block_spd.BASE``, where the blocked inverse actually
    recurses, ``config.use_blocked_large_k`` picks it over XLA; in between,
    the blocked route would be XLA's Cholesky plus an explicit inverse, so
    XLA serves.  ``platform`` defaults to JAX's backend (tests pass it)."""
    from ..config import config
    from . import block_spd, kernels

    if want not in kernels.WANTS + ("rows",):
        raise ValueError(f"unknown SPD work {want!r}")
    if platform is None:
        platform = jax.default_backend()
    if platform != "gpu" or sharded or k == 0 or dtype != jnp.float32:
        return "xla"
    if k <= kernels.MAX_K:
        return "kernel" if config.use_pallas else "xla"
    if k > block_spd.BASE and config.use_blocked_large_k:
        return "blocked"
    return "xla"


def _kernel_rows_solve(S_sq, cross, lam, *, interpret: bool = False):
    """Batched SPD row solve ``(S[d] + lam I) c_d = cross[d]`` through the
    kernel's ``want="states"`` variant with ``sigma^2 = lam``.  The kernel
    puts ones on the diagonal of padded state dims, so ``lam = 0`` (the
    Prior default) stays finite; a genuinely singular real row (an empty
    dimension with ``lam = 0``) goes non-finite for that row only — the
    same as the XLA solve, handled by the caller's keep-old-row fallback."""
    from . import kernels

    zeros = jnp.zeros(cross.shape[:1], S_sq.dtype)
    kw = {"interpret": True} if interpret else {}
    sol, _ = kernels.spd_estep(
        S_sq, cross, zeros, zeros, jnp.sqrt(jnp.asarray(lam, S_sq.dtype)),
        want="states", **kw,
    )
    return sol


def _kernel_block(C, CC, mean, sigma, data, mask_f, want: str):
    """One block through the fused kernel (unsharded D).  Returns
    ``(R, b, rnorm, d_obs, out)`` with ``out`` as kernels.spd_estep
    returns it for ``want``."""
    from . import kernels

    n, k = data.shape[0], C.shape[1]
    R = mask_f * (data - mean)
    b = R @ C
    G = (mask_f @ CC).reshape(n, k, k)
    rnorm = jnp.sum(R * R, axis=-1)
    d_obs = jnp.sum(mask_f, axis=-1)
    out = kernels.spd_estep(G, b, rnorm, d_obs, sigma, want=want)
    return R, b, rnorm, d_obs, out


#: Row-block height of the tril-wedge slabs that the pattern paths'
#: outer-product statistics are narrowed to (config.s_slab_stats).
S_SLAB_ROWS = 16


def _sm_slabs(k: int):
    """Row-block slabs [(r0, r1, cw)] of a (k, k) second moment covering
    its lower wedge: row-block [r0, r1) keeps cols [:cw] (cw = r1) — the
    lower triangle plus the diagonal block's interior, i.e. exactly the
    entries em_finalize's tril + tril^T reconstruction reads."""
    return [(r0, min(r0 + S_SLAB_ROWS, k), min(r0 + S_SLAB_ROWS, k))
            for r0 in range(0, k, S_SLAB_ROWS)]


def _s_packed_width(k: int) -> int:
    return sum((r1 - r0) * cw for r0, r1, cw in _sm_slabs(k))


def _s_unpack(S_packed: jax.Array, k: int) -> jax.Array:
    """(D, packed) slab-packed S statistic -> the standard (D, k*k) layout
    (entries outside the slabs are zero; em_finalize only reads tril)."""
    D = S_packed.shape[0]
    parts, off = [], 0
    for r0, r1, cw in _sm_slabs(k):
        width = (r1 - r0) * cw
        blk = S_packed[:, off : off + width].reshape(D, r1 - r0, cw)
        parts.append(jnp.pad(blk, ((0, 0), (0, 0), (0, k - cw))))
        off += width
    return jnp.concatenate(parts, axis=1).reshape(D, k * k)


def _scan_blocks(n: int, block: int, arrays, body, init):
    """Blocked scan over ``n`` rows WITHOUT copying the inputs.

    ``body(carry, fresh, *blocks) -> (carry, out)`` runs ceil(n/block)
    times on (block, ...) row windows dynamic-sliced straight from the
    original buffers.  When ``block`` doesn't divide ``n`` the FINAL window
    is the last `block` rows, so its leading rows were already covered by
    the previous window; ``fresh`` is False exactly there (and on padding
    rows when n < block).  Reduction bodies must neutralize stale rows by
    zeroing their mask and weight — all-masked zero-weight rows are exactly
    neutral in every reduction (the library's padding-row invariant, module
    docstring).  Per-row OUTPUTS need no neutralization: the returned
    ``flatten`` drops stale rows when assembling the (n, ...) result.

    This replaces a jnp.pad + reshape layout whose pad COPIED the whole
    dataset inside the compiled program — a 7.6 GiB HLO temp at N=4M,
    D=1024 bf16 that OOM'd the 16 GB chip before a single block ran.

    Returns ``(carry, outs, flatten)`` with ``outs`` as stacked by
    lax.scan (leading dim = number of blocks) and ``flatten(o) -> (n, ...)``.
    """
    nb = -(-n // block)
    if n <= block:
        pad = block - n
        blocks = [jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)) for a in arrays]
        fresh = jnp.arange(block) < n
        carry, out = body(init, fresh, *blocks)
        out = jax.tree.map(lambda o: o[None], out)

        def flatten(o):
            return o.reshape((block,) + o.shape[2:])[:n]

        return carry, out, flatten

    iota = jnp.arange(block, dtype=jnp.int32)
    starts = jnp.arange(nb, dtype=jnp.int32) * block

    def step(carry, start):
        actual = jnp.minimum(start, n - block)
        fresh = iota >= (start - actual)
        blocks = [lax.dynamic_slice_in_dim(a, actual, block, 0) for a in arrays]
        return body(carry, fresh, *blocks)

    carry, outs = lax.scan(step, init, starts)
    pad = nb * block - n

    def flatten(o):
        flat = o.reshape((nb * block,) + o.shape[2:])
        if pad == 0:
            return flat
        return jnp.concatenate([flat[: (nb - 1) * block], o[-1, pad:]], axis=0)

    return carry, outs, flatten


def llks(
    C: jax.Array,
    mean: jax.Array,
    sigma: jax.Array,
    data: jax.Array,
    mask: jax.Array,
    *,
    block_size: int,
    axis_model: Optional[str] = None,
) -> jax.Array:
    """Per-sample log-likelihoods, blocked over N (`ppca_model.rs:152-159`).

    When ``axis_model`` is set the result is replicated across the model axis.
    ``rnorm`` and friends are psum-reduced inside :func:`block_posterior`, so
    the per-sample values are already full-D quantities.
    """
    n = data.shape[0]
    k = C.shape[1]
    cdtype = compute_dtype(data.dtype, C.dtype)
    CC = outer_flat(C)
    route = spd_route(k, cdtype, "llk", axis_model is not None)

    def body(_, fresh, datab, maskb):
        datab = datab.astype(cdtype)
        mf = maskb.astype(cdtype)
        if route == "kernel":
            return None, _kernel_block(C, CC, mean, sigma, datab, mf, "llk")[-1]
        post = block_posterior(C, CC, mean, sigma, datab, mf, axis_model,
                               use_blocked=route == "blocked")
        return None, block_llk(post, sigma, k, axis_model)

    _, out, flatten = _scan_blocks(n, block_size, (data, mask), body, None)
    return flatten(out)


def infer(
    C: jax.Array,
    mean: jax.Array,
    sigma: jax.Array,
    data: jax.Array,
    mask: jax.Array,
    *,
    block_size: int,
    axis_model: Optional[str] = None,
):
    """Posterior states and covariances for every sample
    (`ppca_model.rs:221-227`). Returns ``(states (N,k), covariances (N,k,k))``.
    """
    n = data.shape[0]
    cdtype = compute_dtype(data.dtype, C.dtype)
    CC = outer_flat(C)
    route = spd_route(C.shape[1], cdtype, "infer", axis_model is not None)

    def body(_, fresh, datab, maskb):
        datab = datab.astype(cdtype)
        mf = maskb.astype(cdtype)
        if route == "kernel":
            # want="infer": the kernel emits Sigma = sigma^2 M^{-1} directly —
            # no SM - s s^T round trip, so covariances keep full relative
            # precision and stay PSD for well-observed samples.
            s, Sig, _ = _kernel_block(C, CC, mean, sigma, datab, mf, "infer")[-1]
            return None, (s, Sig)
        post = block_posterior(C, CC, mean, sigma, datab, mf, axis_model,
                               use_blocked=route == "blocked")
        return None, (post.states, block_covariances(post, sigma))

    _, (states, covs), flatten = _scan_blocks(n, block_size, (data, mask), body, None)
    return flatten(states), flatten(covs)


def states(
    C: jax.Array,
    mean: jax.Array,
    sigma: jax.Array,
    data: jax.Array,
    mask: jax.Array,
    *,
    block_size: int,
    axis_model: Optional[str] = None,
) -> jax.Array:
    """Posterior state means only, (N, k) — the cheap path behind
    smooth/extrapolate (`ppca_model.rs:231-261`), which need no posterior
    covariances."""
    n = data.shape[0]
    k = C.shape[1]
    cdtype = compute_dtype(data.dtype, C.dtype)
    CC = outer_flat(C)
    route = spd_route(k, cdtype, "states", axis_model is not None)

    def body(_, fresh, datab, maskb):
        datab = datab.astype(cdtype)
        mf = maskb.astype(cdtype)
        if route == "kernel":
            return None, _kernel_block(C, CC, mean, sigma, datab, mf, "states")[-1][0]
        post = block_posterior(C, CC, mean, sigma, datab, mf, axis_model,
                               use_blocked=route == "blocked")
        return None, post.states

    _, out, flatten = _scan_blocks(n, block_size, (data, mask), body, None)
    return flatten(out)


class EMStats(NamedTuple):
    """Sufficient statistics of one EM iteration.

    Sharding discipline: ``cross``, ``S``, ``total_dev``, ``totals`` are
    indexed by (local) D and stay model-sharded; ``square_error``, ``dev_sq``
    are built from model-*local* terms and must be psum-reduced over BOTH mesh
    axes; ``llk`` is built from model-reduced terms, so it is already
    model-replicated and must be psum-reduced over the data axis only.
    """

    cross: jax.Array         # (D_loc, k)   sum w r s^T        (ppca_model.rs:281-293)
    S: jax.Array             # (D_loc, k*k) sum w m_d (ss^T+Sigma) (ppca_model.rs:297-308)
    square_error: jax.Array  # scalar       sum w tr(G Sigma)  (ppca_model.rs:345)
    dev_sq: jax.Array        # scalar       sum w |dev|^2      (ppca_model.rs:346)
    total_dev: jax.Array     # (D_loc,)     sum w dev          (ppca_model.rs:347)
    totals: jax.Array        # (D_loc,)     sum w m            (ppca_model.rs:348)
    llk: jax.Array           # scalar       weighted llk of the *current* model


def em_stats(
    C: jax.Array,
    mean: jax.Array,
    sigma: jax.Array,
    data: jax.Array,
    mask: jax.Array,
    weights: jax.Array,
    *,
    block_size: int,
    axis_model: Optional[str] = None,
) -> EMStats:
    """One fused pass over the data computing E-step posteriors and all M-step
    sufficient statistics (the reference's separate infer + three rayon
    reduces, `ppca_model.rs:277-358`), plus the dataset log-likelihood of the
    current model for free.
    """
    n, _ = data.shape
    k = C.shape[1]
    dtype = compute_dtype(data.dtype, C.dtype)
    CC = outer_flat(C)
    route = spd_route(k, dtype, "fullt", axis_model is not None)

    def body(acc, fresh, datab, maskb, w):
        datab = datab.astype(dtype)
        # stale rows (the final window re-reads rows an earlier window
        # covered — _scan_blocks) are neutralized exactly like padding
        # rows: zero weight AND zero mask.
        fr = fresh.astype(dtype)
        w = w.astype(dtype) * fr
        mask_f = maskb.astype(dtype) * fr[:, None]
        if route == "kernel":
            R, b, rn, _, (s, SM, llk_b, sq_b) = _kernel_block(
                C, CC, mean, sigma, datab, mask_f, "fullt"
            )
            sw = s * w[:, None]
            cross = lax.dot_general(R, sw, (((0,), (0,)), ((), ())))
            mw = mask_f * w[:, None]
            S = lax.dot_general(mw, SM.reshape(-1, k * k), (((0,), (0,)), ((), ())))
            square_error = jnp.sum(w * sq_b)
            # No residual materialization: with M s = b and G = M - sigma^2 I,
            # s^T G s = b.s - sigma^2 |s|^2 exactly, so the masked residual
            # norm |mask*(y - s C^T - mean)|^2 = rnorm - b.s - sigma^2 |s|^2,
            # and w @ dev collapses to w @ R minus a (D, k) contraction.
            bs = jnp.sum(b * s, axis=-1)
            s2 = jnp.sum(s * s, axis=-1)
            # clamp: epsilon-negative in f32 iff |dev|^2 ~ 0 (see dense_fast)
            dev_sq = jnp.sum(w * jnp.maximum(rn - bs - (sigma * sigma) * s2, 0.0))
            msw = lax.dot_general(mask_f, sw, (((0,), (0,)), ((), ())))
            total_dev = w @ R - jnp.sum(C * msw, axis=-1)
            totals = w @ mask_f
            llk = jnp.sum(w * llk_b)
            return (
                (acc[0] + cross, acc[1] + S),
                (square_error, dev_sq, total_dev, totals, llk),
            )
        post = block_posterior(C, CC, mean, sigma, datab, mask_f, axis_model,
                               use_blocked=route == "blocked")
        Sigma = block_covariances(post, sigma)
        s = post.states

        Rw = post.R * w[:, None]
        cross = Rw.T @ s
        SM = (s[:, :, None] * s[:, None, :] + Sigma).reshape(s.shape[0], k * k)
        S = (mask_f * w[:, None]).T @ SM
        # sum w tr(G Sigma): G_local keeps this model-shard-local so the final
        # psum over both mesh axes counts every dimension exactly once.
        square_error = jnp.sum(w * jnp.sum(post.G_local * Sigma.reshape(s.shape[0], k * k), axis=-1))

        dev = mask_f * (datab - s @ C.T - mean)
        dev_sq = jnp.sum(w * jnp.sum(dev * dev, axis=-1))
        total_dev = w @ dev
        totals = w @ mask_f

        llk = jnp.sum(w * block_llk(post, sigma, k, axis_model))

        return (
            (acc[0] + cross, acc[1] + S),
            (square_error, dev_sq, total_dev, totals, llk),
        )

    # The large per-D accumulators are carried through the scan (sequential
    # adds — their relative f32 error stays small because each entry sums few
    # terms); the scalar and (D,)-vector statistics are stacked per block and
    # tree-reduced by jnp.sum, keeping the dataset llk accurate at 10M+
    # samples in f32.
    zero = (jnp.zeros(C.shape, dtype), jnp.zeros((C.shape[0], k * k), dtype))
    (cross, S), small, _ = _scan_blocks(
        n, block_size, (data, mask, weights), body, zero
    )
    square_error, dev_sq, total_dev, totals, llk = (
        jnp.sum(x, axis=0) for x in small
    )
    return EMStats(cross, S, square_error, dev_sq, total_dev, totals, llk)


def em_finalize(
    C: jax.Array,
    mean: jax.Array,
    sigma: jax.Array,
    stats: EMStats,
    *,
    transformation_precision,
    noise_prior: Optional[tuple] = None,    # (alpha, beta)
    mean_prior: Optional[tuple] = None,     # (prior_mean (D,), prior_precision (D,D))
    axis_model: Optional[str] = None,
    transform_rows: Optional[jax.Array] = None,
    under_vmap: bool = False,
):
    """M-step parameter updates from the sufficient statistics
    (`ppca_model.rs:294-393`). Returns ``(new_C, new_mean, new_sigma)``.

    Statistics must already be reduced over the data axis; D-indexed entries
    may still be model-sharded (this function handles the few cross-D
    reductions with psum/all_gather when ``axis_model`` is set).
    """
    D_loc, k = C.shape
    dtype = C.dtype

    # --- transform rows: batched solve of (S[d] + lambda I) c_d = cross[d],
    # keeping the old row when the solve is non-finite (the QR-failure
    # fallback at ppca_model.rs:313-321).  S[d] is PSD (a nonneg-weighted sum
    # of ss^T + sigma^2 M^{-1} terms); a failed factorization (indefinite or
    # singular row, e.g. an empty dimension with lambda=0) yields non-finite
    # entries on every route and takes the same keep-old-row fallback.
    if k > 0:
        # The pattern paths accumulate only the lower wedge of S
        # (config.s_slab_stats); restore symmetry from the lower triangle —
        # exact for an already-symmetric S.  Under vmap (the mixture's
        # per-component finalize) callers pass the solution precomputed
        # over all components via ``transform_rows``.
        S_sq = stats.S.reshape(D_loc, k, k)
        S_sq = jnp.tril(S_sq) + jnp.swapaxes(jnp.tril(S_sq, -1), -1, -2)
        route = "xla" if under_vmap else spd_route(k, dtype, "rows", axis_model is not None)
        if transform_rows is not None:
            sol = transform_rows
        elif route == "kernel":
            sol = _kernel_rows_solve(S_sq, stats.cross, transformation_precision)
        elif route == "blocked":
            from . import block_spd

            sol = block_spd.solve_psd(S_sq, stats.cross, transformation_precision)
        else:
            A = S_sq + transformation_precision * jnp.eye(k, dtype=dtype)
            sol = jnp.linalg.solve(A, stats.cross[..., None])[..., 0]
        ok = jnp.all(jnp.isfinite(sol), axis=-1, keepdims=True)
        new_C = jnp.where(ok, sol, C)
    else:
        new_C = C

    # --- isotropic noise (ppca_model.rs:360-371)
    sq = _psum(stats.square_error + stats.dev_sq, axis_model)
    n_obs = _psum(jnp.sum(stats.totals), axis_model)
    if noise_prior is not None:
        alpha, beta = noise_prior
        # inverse-gamma MAP mode: (sq/2 + beta) / (n/2 + alpha + 1)
        sigma2_new = (sq / 2.0 + beta) / (n_obs / 2.0 + alpha + 1.0)
    else:
        sigma2_new = sq / n_obs

    # --- mean (ppca_model.rs:373-384)
    new_mean = jnp.where(stats.totals > 0, stats.total_dev / jnp.where(stats.totals > 0, stats.totals, 1.0), 0.0) + mean
    if mean_prior is not None:
        prior_mean, prior_precision = mean_prior
        if axis_model is not None:
            mean_full = lax.all_gather(new_mean, axis_model, tiled=True)
            totals_full = lax.all_gather(stats.totals, axis_model, tiled=True)
        else:
            mean_full, totals_full = new_mean, stats.totals
        # precision-weighted combine solved directly (prior.rs:97-110)
        data_precision_diag = totals_full / sigma2_new
        total_precision = prior_precision + jnp.diag(data_precision_diag)
        numerator = prior_precision @ prior_mean + data_precision_diag * mean_full
        smoothed = jnp.linalg.solve(total_precision, numerator)
        if axis_model is not None:
            idx = lax.axis_index(axis_model)
            new_mean = lax.dynamic_slice_in_dim(smoothed, idx * D_loc, D_loc)
        else:
            new_mean = smoothed

    return new_C, new_mean, jnp.sqrt(sigma2_new)
