"""Mask-pattern deduplication: factor P distinct patterns, not N samples.

Real-world missingness is usually *structured* — a handful of instruments,
survey versions or join shapes produce P distinct mask patterns with
P << N.  Every per-sample quantity that depends on the sample only through
its mask then collapses to a P-sized table:

* the masked Gram ``G_p = C^T diag(m_p) C``, its factorization, the posterior
  covariance ``Sigma_p = sigma^2 M_p^{-1}``, the log-determinant and the
  noise-update trace ``tr(G_p Sigma_p)`` are computed ONCE per pattern
  (`ppca/src/ppca_model.rs:195-208` pays all of this per sample);
* per-sample work shrinks to the mask-weighted projections ``b_n = C^T r_n``
  (one matmul per block) and a batched (k, k) @ (k,) mat-vec against the
  gathered ``Sigma_{p(n)}`` — no per-sample factorization at all;
* the M-step's dominant ``(D, B) x (B, k^2)`` second-moment matmul is grouped
  by pattern when ``P <= D``: per-pattern sums of ``w s s^T`` via a one-hot
  matmul, then a single ``(D, P) x (P, k^2)`` contraction.

The pattern tables themselves are built by batched XLA Cholesky: P is small,
and the factorization runs once per EM iteration.

Pattern *detection* is host-side (``Dataset.pattern_info``): device-side
``packbits`` over the mask, ``np.unique`` on the packed rows.

Everything here is algebraically identical to ops/masked_linalg (same
reductions, different grouping) and is tested for f64 parity against it and
against the brute-force reference formulas.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import cho_solve

from . import masked_linalg as ml
from .masked_linalg import LN_2PI, _scan_blocks


class PatternTables(NamedTuple):
    """Per-pattern E-step quantities (leading axis P)."""

    Sigma: jax.Array    # (P, k*k) posterior covariance sigma^2 M_p^{-1}
    pat_llk: jax.Array  # (P,) the mask-only llk term:
                        #      -0.5 (logdet M_p + 2 log sigma (d_p - k) + LN_2PI d_p)
    sq: jax.Array       # (P,) tr(G_p Sigma_p)  (the noise-update term)


def compute_tables(C: jax.Array, sigma: jax.Array, patterns_f: jax.Array) -> PatternTables:
    """Factor all P patterns at once.  ``patterns_f`` is the (P, D) 0/1
    pattern matrix in compute dtype."""
    P, _ = patterns_f.shape
    k = C.shape[1]
    dtype = patterns_f.dtype
    CC = ml.outer_flat(C).astype(dtype)
    G = patterns_f @ CC                                   # (P, k*k)
    d_obs = jnp.sum(patterns_f, axis=-1)                  # (P,)
    sigma2 = sigma * sigma

    M = G.reshape(P, k, k) + sigma2 * jnp.eye(k, dtype=dtype)
    L = jnp.linalg.cholesky(M)
    eye = jnp.broadcast_to(jnp.eye(k, dtype=dtype), M.shape)
    Sigma = (sigma2 * cho_solve((L, True), eye)).reshape(P, k * k)
    if k > 0:
        logdet_m = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
    else:
        logdet_m = jnp.zeros((P,), dtype)
    logdet = logdet_m + 2.0 * jnp.log(sigma) * (d_obs - k)
    pat_llk = -0.5 * (logdet + LN_2PI * d_obs)
    sq = jnp.sum(G * Sigma, axis=-1)
    return PatternTables(Sigma, pat_llk, sq)


# The per-sample (B, k*k) Sigma gather costs ~2 * 4 * k^2 bytes/sample of
# device-memory traffic (write + re-read; 32 KB/sample at k=64 f32).  Below
# this P * k bound the all-patterns candidate matmul (one (B, k) x (k, P*k)
# contraction +
# a (B, 1, k) row gather; temp traffic 4 * P * k bytes/sample) is cheaper.
_SALL_MAX_PK = 4096


def _block_states_llk(C, mean, sigma, tables: PatternTables, datab, mask_f, pidx):
    """Per-sample states + llks for one block.  Returns (R, b, s, llk)."""
    from ..config import config

    k = C.shape[1]
    B = datab.shape[0]
    P = tables.Sigma.shape[0]
    R = mask_f * (datab - mean)
    b = R @ C                                             # (B, k)
    if config.pat_grouped_estep and 0 < P * k <= _SALL_MAX_PK:
        # s_n = Sigma_{p(n)} b_n / sigma^2 via the candidates for ALL
        # patterns in one matmul (Sigma_p is symmetric, so the
        # (k, P*k) right operand is just the table re-laid-out), then a
        # contiguous per-row gather of the winning k-vector.
        W = tables.Sigma.reshape(P, k, k).transpose(1, 0, 2).reshape(k, P * k)
        sall = (b @ W).reshape(B, P, k)
        s = jnp.take_along_axis(
            sall, pidx.astype(jnp.int32)[:, None, None], axis=1
        )[:, 0, :] / (sigma * sigma)
    else:
        Sig = jnp.take(tables.Sigma, pidx, axis=0)        # (B, k*k)
        s = jnp.einsum("bij,bj->bi", Sig.reshape(B, k, k), b) / (sigma * sigma)
    rnorm = jnp.sum(R * R, axis=-1)
    quad = (rnorm - jnp.sum(b * s, axis=-1)) / (sigma * sigma)
    llk = jnp.take(tables.pat_llk, pidx, axis=0) - 0.5 * quad
    return R, b, s, llk


def llks(C, mean, sigma, data, mask, pidx, patterns, *, block_size: int) -> jax.Array:
    """Per-sample log-likelihoods via the pattern tables."""
    n = data.shape[0]
    cdtype = ml.compute_dtype(data.dtype, C.dtype)
    tables = compute_tables(C, sigma, patterns.astype(cdtype))

    def body(_, fresh, datab, maskb, pb):
        _, _, _, llk = _block_states_llk(
            C, mean, sigma, tables, datab.astype(cdtype), maskb.astype(cdtype), pb
        )
        return None, llk

    _, out, flatten = _scan_blocks(n, block_size, (data, mask, pidx), body, None)
    return flatten(out)


def states(C, mean, sigma, data, mask, pidx, patterns, *, block_size: int) -> jax.Array:
    """Posterior state means only (smooth/extrapolate path)."""
    n = data.shape[0]
    k = C.shape[1]
    cdtype = ml.compute_dtype(data.dtype, C.dtype)
    tables = compute_tables(C, sigma, patterns.astype(cdtype))

    def body(_, fresh, datab, maskb, pb):
        _, _, s, _ = _block_states_llk(
            C, mean, sigma, tables, datab.astype(cdtype), maskb.astype(cdtype), pb
        )
        return None, s

    _, out, flatten = _scan_blocks(n, block_size, (data, mask, pidx), body, None)
    return flatten(out)


def infer(C, mean, sigma, data, mask, pidx, patterns, *, block_size: int):
    """Posterior states and covariances.  Covariances come straight from the
    pattern table (sigma^2 M^{-1}), with no round-trip through second
    moments — so no cancellation error and guaranteed symmetric PSD."""
    n = data.shape[0]
    k = C.shape[1]
    cdtype = ml.compute_dtype(data.dtype, C.dtype)
    tables = compute_tables(C, sigma, patterns.astype(cdtype))

    def body(_, fresh, datab, maskb, pb):
        _, _, s, _ = _block_states_llk(
            C, mean, sigma, tables, datab.astype(cdtype), maskb.astype(cdtype), pb
        )
        return None, (s, jnp.take(tables.Sigma, pb, axis=0).reshape(-1, k, k))

    _, (s, covs), flatten = _scan_blocks(n, block_size, (data, mask, pidx), body, None)
    return flatten(s), flatten(covs)


def em_stats(C, mean, sigma, data, mask, pidx, patterns, weights, *,
             block_size: int) -> ml.EMStats:
    """One fused pass computing all EM sufficient statistics, grouped by
    pattern wherever the quantity depends on the sample only through its
    mask.  Returns the same EMStats as masked_linalg.em_stats.

    Grouped-by-pattern pieces (computed once per pattern / per (P,) table):
      * ``S``'s covariance half: sum_p wsum_p m_pd Sigma_p
      * ``S``'s outer-product half, when P <= D: per-pattern sums of
        ``w s s^T`` via a one-hot matmul, then one (D, P) x (P, k^2)
      * ``square_error`` = sum_p wsum_p tr(G_p Sigma_p)
      * ``totals``       = sum_p wsum_p m_pd
    """
    from ..config import config

    n, _ = data.shape
    D, k = C.shape
    dtype = ml.compute_dtype(data.dtype, C.dtype)
    patterns_f = patterns.astype(dtype)
    P = patterns_f.shape[0]
    tables = compute_tables(C, sigma, patterns_f)
    group_outer = P <= D  # one-hot grouping beats the direct (D,B)x(B,k^2)
    # config.s_slab_stats: build only the ml._sm_slabs tril wedge of the
    # per-sample outer s s^T (em_finalize reads tril of S only) — ~0.55x
    # the outer elementwise work, temporary, and Souter matmul flops at
    # k=64.  The
    # scan carries Souter PACKED; S is unpacked once after assembly.
    slab = config.s_slab_stats and k > 0
    grouped = config.pat_grouped_estep
    outer_ranges = ml._sm_slabs(k) if slab else [(0, k, k)]
    q_pack = ml._s_packed_width(k) if slab else k * k

    def body(acc, fresh, datab, maskb, pb, w):
        datab = datab.astype(dtype)
        mask_f = maskb.astype(dtype)
        # stale rows (final-window overlap, _scan_blocks) zero their
        # weight; every statistic below is w-linear.
        w = w.astype(dtype) * fresh.astype(dtype)
        R, b, s, llk_b = _block_states_llk(C, mean, sigma, tables, datab, mask_f, pb)

        sw = s * w[:, None]
        cross = lax.dot_general(R, sw, (((0,), (0,)), ((), ())))              # (D, k)
        outer_s = jnp.concatenate(
            [
                (s[:, r0:r1, None] * s[:, None, :cw]).reshape(
                    s.shape[0], (r1 - r0) * cw
                )
                for r0, r1, cw in outer_ranges
            ],
            axis=1,
        ) if len(outer_ranges) > 1 else (
            s[:, :, None] * s[:, None, :]
        ).reshape(s.shape[0], k * k)
        onehot = (pb[:, None] == jnp.arange(P, dtype=pb.dtype)[None, :]).astype(dtype)
        wsum = w @ onehot                                                     # (P,)
        if group_outer:
            Souter = lax.dot_general(
                onehot * w[:, None], outer_s, (((0,), (0,)), ((), ()))
            )                                                                 # (P, q_pack)
        else:
            Souter = lax.dot_general(
                mask_f * w[:, None], outer_s, (((0,), (0,)), ((), ()))
            )                                                                 # (D, q_pack)

        # No residual array: s = M^{-1} b exactly (s = Sigma b / sigma^2),
        # so |mask*(y - s C^T - mean)|^2 = rnorm - b.s - sigma^2 |s|^2 and
        # w @ dev = w @ R - sum_k C (mask^T sw) — the same identities as
        # masked_linalg.em_stats (rnorm/b.s CSE with _block_states_llk).
        rnorm = jnp.sum(R * R, axis=-1)
        bs = jnp.sum(b * s, axis=-1)
        # clamp: epsilon-negative in f32 iff |dev|^2 ~ 0 (see dense_fast)
        dev_sq = jnp.sum(w * jnp.maximum(
            rnorm - bs - (sigma * sigma) * jnp.sum(s * s, axis=-1), 0.0))
        if grouped:
            # mask^T sw == patterns^T (onehot^T sw): accumulate the tiny
            # (P, k) grouped projection and apply the (D, P) contraction
            # once at assembly — exact sum reordering, and it removes the
            # per-block (D, B) x (B, k) matmul plus a full mask re-read.
            psw = lax.dot_general(onehot, sw, (((0,), (0,)), ((), ())))       # (P, k)
            wR = w @ R                                                        # (D,)
        else:
            msw = lax.dot_general(mask_f, sw, (((0,), (0,)), ((), ())))      # (D, k)
            psw = jnp.zeros((P, k), dtype)
            wR = w @ R - jnp.sum(C * msw, axis=-1)
        llk = jnp.sum(w * llk_b)
        return (
            (acc[0] + cross, acc[1] + Souter, acc[2] + wsum, acc[3] + psw),
            (dev_sq, wR, llk),
        )

    souter_shape = (P, q_pack) if group_outer else (D, q_pack)
    zero = (
        jnp.zeros((D, k), dtype),
        jnp.zeros(souter_shape, dtype),
        jnp.zeros((P,), dtype),
        jnp.zeros((P, k), dtype),
    )
    (cross, Souter, wsum, psw), small, _ = _scan_blocks(
        n, block_size, (data, mask, pidx, weights), body, zero
    )
    dev_sq, total_dev, llk = (jnp.sum(x, axis=0) for x in small)
    if grouped:
        msw = patterns_f.T @ psw                                              # (D, k)
        total_dev = total_dev - jnp.sum(C * msw, axis=-1)

    # Assemble the pattern-grouped statistics with single (D, P) contractions.
    pat_T = patterns_f.T                                   # (D, P)
    Sigma_tab = tables.Sigma                               # (P, k*k)
    if slab:
        # pack the (cheap, P-sized) covariance table the same way so the
        # assembly runs at the packed width; unpack S once at the end.
        Sigma4 = Sigma_tab.reshape(P, k, k)
        Sigma_tab = jnp.concatenate(
            [
                Sigma4[:, r0:r1, :cw].reshape(P, (r1 - r0) * cw)
                for r0, r1, cw in outer_ranges
            ],
            axis=1,
        )
    if group_outer:
        S = pat_T @ (Souter + wsum[:, None] * Sigma_tab)
    else:
        S = Souter + pat_T @ (wsum[:, None] * Sigma_tab)
    if slab:
        S = ml._s_unpack(S, k)
    square_error = jnp.sum(wsum * tables.sq)
    totals = pat_T @ wsum
    return ml.EMStats(cross, S, square_error, dev_sq, total_dev, totals, llk)


def em_stats_sorted(C, mean, sigma, data_sorted, weights_sorted, patterns,
                    counts, *, block_size: int) -> ml.EMStats:
    """Pattern-SORTED segment EM statistics — the flop-minimal pattern path.

    ``data_sorted``/``weights_sorted`` are the dataset's rows grouped by
    pattern (``Dataset.pattern_order``); ``counts`` is the static tuple of
    per-pattern row counts (segment ``p`` is rows
    ``[sum(counts[:p]), sum(counts[:p]) + counts[p])``).  Inside a segment
    the mask is the CONSTANT row ``patterns[p]``, so per-sample work
    collapses to plain dense matmuls with no gathers, no one-hot
    contractions and no mask array at all:

      * no mask read: ``R = m_p * (data - mean)`` with ``m_p`` a constant
        (this also zero-fills whatever the data buffer holds at
        unobserved positions);
      * states ``s = (R C) Sigma_p / sigma^2`` cost 2k^2 flops/sample
        against the segment's ONE table entry — the general pattern path
        pays 2*P*k^2 for the all-patterns candidates matmul (or a
        32 KB/sample gather);
      * the per-pattern outer statistic is a plain segment Gram
        ``(w s)^T s`` (2k^2) instead of the one-hot contraction (2 * q * P);
      * ``mask^T sw`` corrections group per segment for free (psw), and
        the residual identities (rnorm/b.s/|s|^2) are unchanged.

    Per-sample matmul flops drop from ~2(D + Pk + Pq/k)k to ~2(2D + 2k)k
    (the data pass now also carries the cross matmul per segment).
    Everything is an exact reordering of :func:`em_stats`'s sums — f64
    parity is pinned by tests/test_pattern_dedup.py.

    Reference semantics: `ppca/src/ppca_model.rs:195-230` (per-sample
    rayon fold), regrouped by pattern segment.
    """
    D, k = C.shape
    n = data_sorted.shape[0]
    dtype = ml.compute_dtype(data_sorted.dtype, C.dtype)
    patterns_f = patterns.astype(dtype)
    P = patterns_f.shape[0]
    if len(counts) != P or sum(counts) != n:
        raise ValueError(
            f"counts {len(counts)}/{sum(counts)} do not partition "
            f"{P} patterns x {n} rows"
        )
    tables = compute_tables(C, sigma, patterns_f)
    Sig3 = tables.Sigma.reshape(P, k, k)
    sigma2 = sigma * sigma

    cross = jnp.zeros((D, k), dtype)
    wR = jnp.zeros((D,), dtype)
    dev_sq = jnp.zeros((), dtype)
    quad = jnp.zeros((), dtype)
    souter, psw_l, wsum_l = [], [], []
    off = 0
    for p, c in enumerate(counts):
        if c == 0:
            souter.append(jnp.zeros((k * k,), dtype))
            psw_l.append(jnp.zeros((k,), dtype))
            wsum_l.append(jnp.zeros((), dtype))
            continue
        dseg = lax.slice_in_dim(data_sorted, off, off + c, axis=0)
        wseg = lax.slice_in_dim(weights_sorted, off, off + c, axis=0)
        off += c
        m_p = patterns_f[p]                                  # (D,) constant
        Sp = Sig3[p]

        def body(acc, fresh, db, wb, m_p=m_p, Sp=Sp):
            # stale rows (final-window overlap / n<block padding) zero
            # their weight; every statistic is w-linear.
            w = wb.astype(dtype) * fresh.astype(dtype)
            R = m_p * (db.astype(dtype) - mean)              # (B, D)
            b = R @ C                                        # (B, k)
            s = (b @ Sp) / sigma2
            sw = s * w[:, None]
            cr = lax.dot_general(R, sw, (((0,), (0,)), ((), ())))   # (D, k)
            so = lax.dot_general(sw, s, (((0,), (0,)), ((), ())))   # (k, k)
            rnorm = jnp.sum(R * R, axis=-1)
            bs = jnp.sum(b * s, axis=-1)
            # clamp: epsilon-negative in f32 iff |dev|^2 ~ 0 (see dense_fast)
            dv = jnp.sum(w * jnp.maximum(
                rnorm - bs - sigma2 * jnp.sum(s * s, axis=-1), 0.0))
            qd = jnp.sum(w * (rnorm - bs))
            return (
                (acc[0] + cr, acc[1] + so, acc[2] + jnp.sum(sw, axis=0),
                 acc[3] + jnp.sum(w), acc[4] + dv, acc[5] + qd,
                 acc[6] + w @ R),
                None,
            )

        from ..config import block_size_for

        zero = (
            jnp.zeros((D, k), dtype), jnp.zeros((k, k), dtype),
            jnp.zeros((k,), dtype), jnp.zeros((), dtype),
            jnp.zeros((), dtype), jnp.zeros((), dtype),
            jnp.zeros((D,), dtype),
        )
        acc, _, _ = _scan_blocks(
            c, min(block_size, block_size_for(c)), (dseg, wseg), body, zero
        )
        cross = cross + acc[0]
        souter.append(acc[1].reshape(k * k))
        psw_l.append(acc[2])
        wsum_l.append(acc[3])
        dev_sq = dev_sq + acc[4]
        quad = quad + acc[5]
        wR = wR + acc[6]

    Souter = jnp.stack(souter)                               # (P, k*k)
    psw = jnp.stack(psw_l)                                   # (P, k)
    wsum = jnp.stack(wsum_l)                                 # (P,)
    llk = jnp.sum(wsum * tables.pat_llk) - 0.5 * quad / sigma2
    pat_T = patterns_f.T                                     # (D, P)
    total_dev = wR - jnp.sum(C * (pat_T @ psw), axis=-1)
    S = pat_T @ (Souter + wsum[:, None] * tables.Sigma)
    square_error = jnp.sum(wsum * tables.sq)
    totals = pat_T @ wsum
    return ml.EMStats(cross, S, square_error, dev_sq, total_dev, totals, llk)
