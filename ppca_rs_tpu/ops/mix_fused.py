"""Fused mixture EM — all components in ONE pass over the data.

The reference's mixture EM (`ppca/src/mix.rs:281-337`) makes M llks passes
(responsibilities) followed by M reweighted single-model EM passes — 2M scans
of the dataset per iteration, and in our setting 2M separate device programs.
When every component shares the same state size (the overwhelmingly common
case, and all the reference examples), the whole iteration fuses into one
blocked scan:

* the per-sample masked Grams and projections for all M components are
  batched einsums over a stacked ``Cs (M, D, k)``;
* the per-sample SPD work is independent across samples and components,
  so one batched factorization (or one kernel call) covers all M x B
  posteriors of a block;
* component responsibilities come from the same per-sample llks inside the
  block, so the M-step statistics are accumulated responsibility-weighted in
  the same pass.

Numerical note: the reference scales each component's weights to max 1
before the inner EM (`mix.rs:310-323`).  Without priors the EM updates are
invariant to that scale (every update is a ratio of weighted sums), but WITH
priors the scale matters — the ridge / inverse-gamma / mean-prior strengths
are relative to it.  The fused path therefore tracks the per-component
maximum responsibility in the same pass and rescales the (weight-linear)
statistics before finalization, reproducing the reference exactly.

Heterogeneous state sizes ride the same fused pass, zero-padded to max(k)
by models/mix.py (padded latent dimensions are exactly inert — the padded
Gram block is zero, its log-det contribution cancels against the
(d_obs - k) noise term, and the M-step solve is block-diagonal with zero
cross-moment, so padded transform columns come out exactly 0).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from . import masked_linalg as ml
from .masked_linalg import LN_2PI, _psum, _scan_blocks


class MixEMStats(NamedTuple):
    """Per-component EM sufficient statistics (leading axis M), plus the
    mixture llk and the new-log-weight numerators.  Sharding discipline
    matches EMStats (see masked_linalg): D-indexed fields stay model-sharded,
    ``square_error``/``dev_sq`` are model-local, the rest model-replicated."""

    cross: jax.Array         # (M, D_loc, k)
    S: jax.Array             # (M, D_loc, k*k)
    square_error: jax.Array  # (M,)
    dev_sq: jax.Array        # (M,)
    total_dev: jax.Array     # (M, D_loc)
    totals: jax.Array        # (M, D_loc)
    resp_sum: jax.Array      # (M,)  sum_n w_n post_{n,m}  (new log-weight numerators)
    resp_max: jax.Array      # (M,)  max_n w_n post_{n,m}  (the reference's per-
                             #       component weight normalization, mix.rs:310-323:
                             #       priors act relative to max-1-scaled weights)
    llk: jax.Array           # scalar mixture llk of the current parameters


def _block_post(Cs, CCs, means, sigmas, datab, mask_f,
                route: str, axis_model: Optional[str], want: str):
    """Per-component posteriors for one block of samples, all M components in
    one shot (one kernel call over the M*B problems, or one batched
    factorization).  Returns (R, llks, s, SM, sq_b); ``s``/``SM``/``sq_b``
    are None when ``want`` (a kernels.WANTS variant) doesn't request them
    ("llk" < "states" < "infer"/"fullt"; "infer" returns Sigma as SM)."""
    M, D_loc, k = Cs.shape
    B = datab.shape[0]
    dtype = datab.dtype

    # Per-component masked centering / projections, batched over M.
    R = mask_f[None, :, :] * (datab[None, :, :] - means[:, None, :])   # (M,B,D)
    b = _psum(jnp.einsum("mbd,mdk->mbk", R, Cs), axis_model)           # (M,B,k)
    G_flat_loc = jnp.einsum("bd,mdq->mbq", mask_f, CCs)                # (M,B,k^2)
    rnorm = _psum(jnp.sum(R * R, axis=-1), axis_model)                 # (M,B)
    d_obs = _psum(jnp.sum(mask_f, axis=-1), axis_model)                # (B,)

    s = SM = sq_b = None
    if route == "kernel":
        out = _kernel_mix(
            G_flat_loc.reshape(M, B, k, k), b, rnorm, d_obs, sigmas, want
        )
        llks, s = out[0], out[1]
        if want in ("fullt", "infer"):
            SM = out[2].reshape(M, B, k * k)
        if want == "fullt":
            sq_b = out[3]
    else:
        sigma2 = (sigmas * sigmas)[:, None, None]
        G = _psum(G_flat_loc, axis_model).reshape(M, B, k, k)
        Mmat = G + sigma2[..., None] * jnp.eye(k, dtype=dtype)
        Sigma = None
        if route == "blocked":
            from . import block_spd

            Minv, ldm = block_spd.inv_logdet(Mmat.reshape(M * B, k, k))
            Minv = Minv.reshape(M, B, k, k)
            logdet_m = ldm.reshape(M, B)
            s = block_spd.mm_hp(Minv, b[..., None])[..., 0]
            if want in ("infer", "fullt"):
                Sigma = sigma2[..., None] * Minv
        else:
            L = jnp.linalg.cholesky(Mmat)
            s = jax.scipy.linalg.cho_solve((L, True), b[..., None])[..., 0]
            if want in ("infer", "fullt"):
                eye = jnp.broadcast_to(jnp.eye(k, dtype=dtype), Mmat.shape)
                Sigma = sigma2[..., None] * jax.scipy.linalg.cho_solve((L, True), eye)
            if k > 0:
                diag = jnp.diagonal(L, axis1=-2, axis2=-1)
                logdet_m = 2.0 * jnp.sum(jnp.log(diag), axis=-1)
            else:
                logdet_m = jnp.zeros((M, B), dtype)
        if want in ("infer", "fullt"):
            if want == "infer":
                SM = Sigma.reshape(M, B, k * k)
            else:
                SM = (s[..., :, None] * s[..., None, :] + Sigma).reshape(M, B, k * k)
            sq_b = jnp.sum(
                G_flat_loc.reshape(M, B, k * k) * Sigma.reshape(M, B, k * k), axis=-1
            )
        quad = (rnorm - jnp.sum(b * s, axis=-1)) / (sigmas * sigmas)[:, None]
        logdet = logdet_m + 2.0 * jnp.log(sigmas)[:, None] * (d_obs[None, :] - k)
        llks = -0.5 * (quad + logdet + LN_2PI * d_obs[None, :])
        if want == "llk":
            s = None
    return R, llks, s, SM, sq_b


def _kernel_mix(G4, b, rnorm, d_obs, sigmas, want: str):
    """All M*B problems of a block through one kernel call.  ``G4`` is
    (M, B, k, k), ``b`` (M, B, k), ``rnorm`` (M, B), ``d_obs`` (B,) and
    ``sigmas`` (M,).  Returns (llks (M, B), s (M, B, k) or None,
    SM or Sigma (M, B, k, k) or None, sq (M, B) or None) per ``want``."""
    from . import kernels

    M, B, k, _ = G4.shape
    sig = jnp.broadcast_to(sigmas[:, None], (M, B)).reshape(M * B)
    dob = jnp.broadcast_to(d_obs[None, :], (M, B)).reshape(M * B)
    out = kernels.spd_estep(
        G4.reshape(M * B, k, k), b.reshape(M * B, k), rnorm.reshape(M * B),
        dob, sig, want=want,
    )
    if want == "llk":
        return out.reshape(M, B), None, None, None
    s = out[0].reshape(M, B, k)
    if want == "states":
        return out[1].reshape(M, B), s, None, None
    sq = out[3].reshape(M, B) if want == "fullt" else None
    return out[2].reshape(M, B), s, out[1].reshape(M, B, k, k), sq


def compute_mix_tables(Cs, sigmas, patterns_f):
    """Per-(component, pattern) E-step tables: with P distinct mask patterns
    every mask-only quantity is computed M*P times instead of M*N times.
    Returns (Sigma (M, P, k^2), pat_llk (M, P), sq (M, P)) — the mixture twin
    of ops/pattern_dedup.compute_tables, all M*P problems in one batched
    factorization.  A fully-observed dataset is the P = 1 special case,
    which is how dense mixtures get their fast path."""
    M, D_loc, k = Cs.shape
    P = patterns_f.shape[0]
    dtype = patterns_f.dtype
    CCs = (Cs[:, :, :, None] * Cs[:, :, None, :]).reshape(M, D_loc, k * k)
    G = jnp.einsum("pd,mdq->mpq", patterns_f, CCs)            # (M,P,k^2)
    d_obs = jnp.sum(patterns_f, axis=-1)                      # (P,)
    sig = sigmas.astype(dtype)

    sigma2 = (sig * sig)[:, None, None, None]
    Mm = G.reshape(M, P, k, k) + sigma2 * jnp.eye(k, dtype=dtype)
    L = jnp.linalg.cholesky(Mm)
    eye = jnp.broadcast_to(jnp.eye(k, dtype=dtype), Mm.shape)
    Sigma = (sigma2 * jax.scipy.linalg.cho_solve((L, True), eye)).reshape(M, P, k * k)
    if k > 0:
        logdet_m = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
    else:
        logdet_m = jnp.zeros((M, P), dtype)
    logdet = logdet_m + 2.0 * jnp.log(sig)[:, None] * (d_obs[None, :] - k)
    pat_llk = -0.5 * (logdet + LN_2PI * d_obs[None, :])
    sq = jnp.sum(G * Sigma, axis=-1)
    return Sigma, pat_llk, sq


def _center_prep(Cs, means):
    """Loop-invariant component-centering operands for the no-R fast path
    (hoisted out of the scan).  Per-component centerings are expressed
    relative to the component-average mean (data is centred ONCE on mean0,
    then corrected per component), so the expanded |r|^2 quadratic's
    cancellation error scales with the between-component mean spread, not
    with the raw data magnitude."""
    mean0 = jnp.mean(means, axis=0)
    dm = means - mean0                                        # (M,D)
    return mean0, dm, Cs * dm[:, :, None]                     # Cdm (M,D,k)


def _block_post_pat(Cs, means, sigmas, tables, datab, mask_f, pidx,
                    center=None, need_sig=False):
    """Table-driven per-component posteriors for one block: no per-sample
    factorization at all.  Returns (R, llks, s, Sig_b, sq_b, b, rnorm) with
    b/rnorm the (M, B, k)/(M, B) projection pieces (so EM consumers need
    not recompute them for the residual identities).

    ``Sig_b`` (the gathered per-sample (M, B, k^2) covariances) is only
    materialized with ``need_sig=True`` (the infer readout, which returns
    them) — it costs 2 * 4 * M * k^2 bytes/sample of device-memory
    traffic.  Everyone else gets
    ``None``: the states come from per-component candidate matmuls against
    the whole table + a row gather when ``config.pat_grouped_estep`` and
    P * k is small (see pattern_dedup._SALL_MAX_PK), or from the einsum on
    the gathered covariances otherwise.

    With ``center`` (from :func:`_center_prep`; the readout verbs) the
    (M, B, D) centered-data temporary is avoided: projections become shared
    matmuls against mask*data and mask, |r|^2 uses the mean0-centered
    expansion at full product precision, and R is returned as None."""
    from ..config import config
    from .pattern_dedup import _SALL_MAX_PK

    Sigma, pat_llk, sq_tab = tables
    M, D_loc, k = Cs.shape
    B = datab.shape[0]
    P = Sigma.shape[1]
    if center is None:
        R = mask_f[None, :, :] * (datab[None, :, :] - means[:, None, :])  # (M,B,D)
        b = jnp.einsum("mbd,mdk->mbk", R, Cs)                             # (M,B,k)
        rnorm = jnp.sum(R * R, axis=-1)                                   # (M,B)
    else:
        R = None
        mean0, dm, Cdm = center
        md0 = mask_f * (datab - mean0)                                    # (B,D)
        b = (jnp.einsum("bd,mdk->mbk", md0, Cs)
             - jnp.einsum("bd,mdk->mbk", mask_f, Cdm))
        hp = jax.lax.Precision.HIGHEST
        rd2 = jnp.sum(md0 * md0, axis=-1)                                 # (B,)
        mdm = jnp.matmul(md0, dm.T, precision=hp)                         # (B,M)
        m2 = jnp.matmul(mask_f, (dm * dm).T, precision=hp)                # (B,M)
        rnorm = (rd2[:, None] - 2.0 * mdm + m2).T                         # (M,B)
    sigma2 = (sigmas * sigmas)[:, None]
    if need_sig or not (config.pat_grouped_estep and 0 < P * k <= _SALL_MAX_PK):
        Sig_b = jnp.take(Sigma, pidx, axis=1)                             # (M,B,k^2)
        s = jnp.einsum(
            "mbij,mbj->mbi", Sig_b.reshape(M, B, k, k), b
        ) / sigma2[..., None]
    else:
        # s_{m,n} = Sigma_{m,p(n)} b_{m,n} / sigma_m^2 via candidates for
        # ALL patterns (Sigma is symmetric, so the (M, k, P*k) right
        # operand is the table re-laid-out), row-chunked so the
        # (M, B', P, k) candidate temporary stays ~128 MB.
        Sig_b = None
        W = Sigma.reshape(M, P, k, k).transpose(0, 2, 1, 3).reshape(M, k, P * k)
        idx = pidx.astype(jnp.int32)[None, :, None, None]
        ic = max(256, (1 << 27) // max(1, M * P * k * 4))
        pieces = []
        for i0 in range(0, B, ic):
            i1 = min(i0 + ic, B)
            cand = jnp.einsum("mbk,mkq->mbq", b[:, i0:i1], W).reshape(
                M, i1 - i0, P, k
            )
            pieces.append(
                jnp.take_along_axis(cand, idx[:, i0:i1], axis=2)[:, :, 0, :]
            )
        s = (pieces[0] if len(pieces) == 1 else jnp.concatenate(pieces, axis=1))
        s = s / sigma2[..., None]
    quad = (rnorm - jnp.sum(b * s, axis=-1)) / sigma2
    llks = jnp.take(pat_llk, pidx, axis=1) - 0.5 * quad                   # (M,B)
    return R, llks, s, Sig_b, jnp.take(sq_tab, pidx, axis=1), b, rnorm


# SPD variant of the fused EM (second moments s s^T + Sigma and tr(G Sigma)).
EM_WANT = "fullt"


def _block_mix_fast(Cs, Cs_t, Cdm_t, CCs_t, mean0, dm, dm2, sigmas,
                    log_weights, datab, mask_f, w, route: str):
    """One block of the fused mixture EM in the axis_model-free fast form:
    no (M, B, D) temporary anywhere.

    - Component centering is the _center_prep trick: every per-component
      projection is a shared matmul against ``mask*(data - mean0)`` and
      ``mask`` (R = md0 - mask*dm_m never exists).
    - The projections and Grams come from pre-transposed ``(.., M, D)``
      operands, so every per-block contraction is one plain matmul.
    - Residual statistics use s^T G s = b.s - sigma^2 |s|^2 (M s = b), so
      dev_sq needs only k-sized per-sample quantities and total_dev two
      (M, D) contractions (same identities as the single-model paths).

    Precision envelope: ``rnorm`` comes from the expanded quadratic
    ``|md0|^2 - 2 md0.dm + mask.dm^2`` (full-f32 products), whose
    cancellation error relative to the residual grows
    ~O(mean_separation^2 / sigma^2) — measured dev_sq rel err ~7e-4 and llk
    ~1.6e-4 vs f64 at separation 300 with residual 0.5.  EM convergence is
    unaffected (the M-step is a ratio of weighted sums), but for widely
    separated components where exact llk/noise values matter,
    ``config.mix_exact_rnorm`` routes mix_em_stats to the R-materializing
    :func:`_block_mix`, which is immune.
    """
    M, D_loc, k = Cs.shape
    B = datab.shape[0]
    dtype = datab.dtype
    q = k * k
    hp = jax.lax.Precision.HIGHEST

    md0 = mask_f * (datab - mean0[None, :])                       # (B, D)
    b_km = (lax.dot_general(Cs_t, md0, (((1,), (1,)), ((), ())))
            - lax.dot_general(Cdm_t, mask_f, (((1,), (1,)), ((), ()))))    # (kM, B)
    rd2 = jnp.sum(md0 * md0, axis=-1)                             # (B,)
    mdm = jnp.matmul(md0, dm.T, precision=hp)                     # (B, M)
    m2 = jnp.matmul(mask_f, dm2.T, precision=hp)                  # (B, M)
    rnorm = (rd2[:, None] - 2.0 * mdm + m2).T                     # (M, B)
    d_obs = jnp.sum(mask_f, axis=-1)                              # (B,)
    sigma2 = (sigmas * sigmas)[:, None]

    b = b_km.reshape(k, M, B).transpose(1, 2, 0)                # (M, B, k)
    G = lax.dot_general(CCs_t, mask_f, (((1,), (1,)), ((), ())))
    G = G.reshape(q, M, B).transpose(1, 2, 0)                     # (M, B, q)
    if route == "kernel":
        llks, s, SM4, sq_b = _kernel_mix(
            G.reshape(M, B, k, k), b, rnorm, d_obs, sigmas, EM_WANT
        )
        SM = SM4.reshape(M, B, q)
    else:
        eye = jnp.eye(k, dtype=dtype)
        Mmat = G.reshape(M, B, k, k) + sigma2[..., None, None] * eye
        if route == "blocked":
            from . import block_spd

            Minv, ldm = block_spd.inv_logdet(Mmat.reshape(M * B, k, k))
            Minv = Minv.reshape(M, B, k, k)
            logdet_m = ldm.reshape(M, B)
            s = block_spd.mm_hp(Minv, b[..., None])[..., 0]
            Sigma = sigma2[..., None, None] * Minv
        else:
            L = jnp.linalg.cholesky(Mmat)
            s = jax.scipy.linalg.cho_solve((L, True), b[..., None])[..., 0]
            Sigma = sigma2[..., None, None] * jax.scipy.linalg.cho_solve(
                (L, True), jnp.broadcast_to(eye, Mmat.shape)
            )
            if k > 0:
                diag = jnp.diagonal(L, axis1=-2, axis2=-1)
                logdet_m = 2.0 * jnp.sum(jnp.log(diag), axis=-1)
            else:
                logdet_m = jnp.zeros((M, B), dtype)
        SM = (s[..., :, None] * s[..., None, :] + Sigma).reshape(M, B, q)
        sq_b = jnp.sum(G * Sigma.reshape(M, B, q), axis=-1)
        quad = (rnorm - jnp.sum(b * s, axis=-1)) / sigma2
        logdet = logdet_m + 2.0 * jnp.log(sigmas)[:, None] * (d_obs[None, :] - k)
        llks = -0.5 * (quad + logdet + LN_2PI * d_obs[None, :])
    bs = jnp.sum(b * s, axis=-1)
    s2 = jnp.sum(s * s, axis=-1)
    s3 = s.transpose(2, 0, 1)                                     # (k, M, B)
    SM3v = SM.transpose(2, 0, 1)                                  # (q, M, B)

    # responsibilities (mix.rs:289-295) and the mixture llk — same pass.
    joint = llks + log_weights[:, None]                           # (M, B)
    mx = jnp.max(joint, axis=0)
    lse = mx + jnp.log(jnp.sum(jnp.exp(joint - mx[None, :]), axis=0))
    post = jnp.exp(joint - lse[None, :])
    llk_mix = jnp.sum(w * lse)
    resp = post * w[None, :]                                      # (M, B)

    # responsibility-weighted M-step statistics
    srw = (s3 * resp[None, :, :]).reshape(k * M, B)
    c1 = lax.dot_general(srw, md0, (((1,), (0,)), ((), ())))      # (kM, D)
    c2 = lax.dot_general(srw, mask_f, (((1,), (0,)), ((), ())))   # (kM, D)
    c2t = jnp.transpose(c2.reshape(k, M, D_loc), (1, 2, 0))       # (M, D, k)
    cross = jnp.transpose(c1.reshape(k, M, D_loc), (1, 2, 0)) - dm[:, :, None] * c2t
    SMw = (SM3v * resp[None, :, :]).reshape(q * M, B)
    S = jnp.transpose(
        lax.dot_general(SMw, mask_f, (((1,), (0,)), ((), ()))).reshape(q, M, D_loc),
        (1, 2, 0),
    )
    # clamp: epsilon-negative in f32 iff |dev|^2 ~ 0 (see dense_fast)
    dev_sq = jnp.sum(resp * jnp.maximum(rnorm - bs - sigma2 * s2, 0.0), axis=-1)
    rm = lax.dot_general(resp, mask_f, (((1,), (0,)), ((), ())))  # (M, D)
    t1 = lax.dot_general(resp, md0, (((1,), (0,)), ((), ())))     # (M, D)
    total_dev = t1 - dm * rm - jnp.sum(Cs * c2t, axis=-1)
    totals = rm
    square_error = jnp.sum(resp * sq_b, axis=-1)
    resp_sum = jnp.sum(resp, axis=-1)
    resp_max = jnp.max(resp, axis=-1)

    return MixEMStats(cross, S, square_error, dev_sq, total_dev, totals,
                      resp_sum, resp_max, llk_mix)


def _block_mix(Cs, CCs, means, sigmas, log_weights, datab, mask_f, w,
               route: str, axis_model: Optional[str]):
    """One block: per-component posteriors + responsibilities + weighted
    M-step contributions for every component.  (The model-axis-sharded
    form; the unsharded fast path is :func:`_block_mix_fast`.)"""
    M, D_loc, k = Cs.shape
    R, llks, s, SM, sq_b = _block_post(
        Cs, CCs, means, sigmas, datab, mask_f, route, axis_model, EM_WANT
    )

    # responsibilities (mix.rs:289-295) and the mixture llk — same pass.
    joint = llks + log_weights[:, None]                 # (M,B)
    mx = jnp.max(joint, axis=0)
    lse = mx + jnp.log(jnp.sum(jnp.exp(joint - mx[None, :]), axis=0))
    post = jnp.exp(joint - lse[None, :])                # (M,B)
    llk_mix = jnp.sum(w * lse)
    resp = post * w[None, :]                            # (M,B) responsibility weights

    # responsibility-weighted M-step statistics per component.
    cross = jnp.einsum("mbd,mbk->mdk", R, s * resp[..., None])
    S = jnp.einsum("bd,mbq->mdq", mask_f, SM * resp[..., None])
    dev = mask_f[None] * (datab[None] - jnp.einsum("mbk,mdk->mbd", s, Cs) - means[:, None, :])
    dev_sq = jnp.sum(resp * jnp.sum(dev * dev, axis=-1), axis=-1)
    total_dev = jnp.einsum("mb,mbd->md", resp, dev)
    totals = jnp.einsum("mb,bd->md", resp, mask_f)
    square_error = jnp.sum(resp * sq_b, axis=-1)
    resp_sum = jnp.sum(resp, axis=-1)
    resp_max = jnp.max(resp, axis=-1)

    return MixEMStats(cross, S, square_error, dev_sq, total_dev, totals,
                      resp_sum, resp_max, llk_mix)


def _mix_prep(Cs, data, axis_model, want):
    M, D_loc, k = Cs.shape
    dtype = ml.compute_dtype(data.dtype, Cs.dtype)
    CCs = (Cs[:, :, :, None] * Cs[:, :, None, :]).reshape(M, D_loc, k * k)
    return dtype, CCs, ml.spd_route(k, dtype, want, axis_model is not None)


def _pat_prep(Cs, means, sigmas, data, patterns):
    """Loop-invariant prep for the pattern-table readout verbs: tables and
    hoisted centering operands.  No CC build, no kernel gating — the table
    path never factors per sample."""
    dtype = ml.compute_dtype(data.dtype, Cs.dtype)
    tables = compute_mix_tables(Cs, sigmas, patterns.astype(dtype))
    center = _center_prep(Cs, means)
    return dtype, tables, center


def _block_llks_kernel(center, Cs, CCs, sigmas, datab, mask_f, want: str):
    """llk/states/infer kernel route for one block (unsharded D): shared
    matmuls against ``mask*(data - mean0)`` and ``mask`` (the _center_prep
    trick) feed one kernel call over all M*B problems — no (M, B, D)
    centred-data temporary.
    Returns (llks (M, B), s (M, B, k) or None, Sig (M, B, k, k) or None)."""
    mean0, dm, Cdm = center
    M, _, k = Cs.shape
    md0 = mask_f * (datab - mean0)                                # (B, D)
    # b_m = C_m^T (mask (y - mu_m)) = C_m^T md0 - C_m^T (mask dm_m)
    b = (jnp.einsum("bd,mdk->mbk", md0, Cs)
         - jnp.einsum("bd,mdk->mbk", mask_f, Cdm))                # (M, B, k)
    G = jnp.einsum("bd,mdq->mbq", mask_f, CCs).reshape(M, -1, k, k)
    # |mask (y - mu_m)|^2 = |md0|^2 - 2 md0 . dm_m + mask . dm_m^2.  These
    # two (B, D) x (D, M) products are tiny but feed the llk quadratic form
    # directly, so they run at full f32 precision regardless of the global
    # matmul-precision setting (reduced-precision operands cost ~nats here).
    hp = jax.lax.Precision.HIGHEST
    rd2 = jnp.sum(md0 * md0, axis=-1)                             # (B,)
    mdm = jnp.matmul(md0, dm.T, precision=hp)                     # (B, M)
    m2 = jnp.matmul(mask_f, (dm * dm).T, precision=hp)            # (B, M)
    rnorm = (rd2[:, None] - 2.0 * mdm + m2).T                     # (M, B)
    d_obs = jnp.sum(mask_f, axis=-1)                              # (B,)
    llks, s, Sig, _ = _kernel_mix(G, b, rnorm, d_obs, sigmas, want)
    return llks, s, Sig


def mix_llks(Cs, means, sigmas, data, mask, *, block_size: int,
             axis_model: Optional[str] = None,
             pidx=None, patterns=None) -> jax.Array:
    """(N, M) per-component per-sample log-likelihoods in ONE pass — the
    fused replacement for M separate llks scans (`mix.rs:137-159` runs each
    component's llks over the whole dataset).  With ``pidx``/``patterns``
    the per-(component, pattern) tables replace all factorizations."""
    n = data.shape[0]
    M = Cs.shape[0]
    if pidx is not None:
        dtype, tables, center = _pat_prep(Cs, means, sigmas, data, patterns)

        def body_pat(_, fresh, datab, maskb, pb):
            _, llks, _, _, _, _, _ = _block_post_pat(
                Cs, means, sigmas, tables, datab.astype(dtype),
                maskb.astype(dtype), pb, center=center,
            )
            return None, llks.T

        _, out, flatten = _scan_blocks(
            n, block_size, (data, mask, pidx), body_pat, None
        )
        return flatten(out)

    dtype, CCs, route = _mix_prep(Cs, data, axis_model, "llk")
    center = _center_prep(Cs, means) if route == "kernel" else None

    def body(_, fresh, datab, maskb):
        if route == "kernel":
            llks, _, _ = _block_llks_kernel(
                center, Cs, CCs, sigmas, datab.astype(dtype),
                maskb.astype(dtype), "llk",
            )
        else:
            _, llks, _, _, _ = _block_post(
                Cs, CCs, means, sigmas, datab.astype(dtype), maskb.astype(dtype),
                route, axis_model, "llk",
            )
        return None, llks.T                                   # (B, M)

    _, out, flatten = _scan_blocks(n, block_size, (data, mask), body, None)
    return flatten(out)


def mix_infer(Cs, means, sigmas, log_weights, data, mask, *, block_size: int,
              axis_model: Optional[str] = None, pidx=None, patterns=None):
    """Fused mixture inference: ONE pass produces the (N, M) log-posteriors
    plus every component's posterior states (M, N, k) and covariances
    (M, N, k, k) — vs the reference's M llks passes + M infer passes
    (`mix.rs:205-236`).  Covariances come from the "infer" variant
    (sigma^2 M^{-1} directly, no SM - s s^T cancellation) or straight from
    the pattern tables when ``pidx``/``patterns`` are given."""
    n = data.shape[0]
    M, _, k = Cs.shape
    if pidx is not None:
        dtype, tables, center = _pat_prep(Cs, means, sigmas, data, patterns)

        def body_pat(_, fresh, datab, maskb, pb):
            _, llks, s, Sig_b, _, _, _ = _block_post_pat(
                Cs, means, sigmas, tables, datab.astype(dtype),
                maskb.astype(dtype), pb, center=center, need_sig=True,
            )
            # block dim leading so _scan_blocks' flatten applies directly
            return None, (llks.T, jnp.moveaxis(s, 1, 0),
                          jnp.moveaxis(Sig_b.reshape(M, -1, k, k), 1, 0))

        _, (llks, s, covs), flatten = _scan_blocks(
            n, block_size, (data, mask, pidx), body_pat, None
        )
    else:
        dtype, CCs, route = _mix_prep(Cs, data, axis_model, "infer")
        center = _center_prep(Cs, means) if route == "kernel" else None

        def body(_, fresh, datab, maskb):
            if route == "kernel":
                llks, s, Sig = _block_llks_kernel(
                    center, Cs, CCs, sigmas, datab.astype(dtype),
                    maskb.astype(dtype), "infer",
                )
            else:
                _, llks, s, Sig, _ = _block_post(
                    Cs, CCs, means, sigmas, datab.astype(dtype), maskb.astype(dtype),
                    route, axis_model, "infer",
                )
                Sig = Sig.reshape(M, -1, k, k)
            return None, (llks.T, jnp.moveaxis(s, 1, 0), jnp.moveaxis(Sig, 1, 0))

        _, (llks, s, covs), flatten = _scan_blocks(
            n, block_size, (data, mask), body, None
        )
    log_post = flatten(llks) + log_weights[None, :]
    mx = jnp.max(log_post, axis=-1, keepdims=True)
    log_post = log_post - mx - jnp.log(
        jnp.sum(jnp.exp(log_post - mx), axis=-1, keepdims=True)
    )
    states = jnp.moveaxis(flatten(s), 1, 0)
    covs = jnp.moveaxis(flatten(covs), 1, 0)
    return log_post, states, covs


def mix_smooth(Cs, means, sigmas, log_weights, data, mask, *, block_size: int,
               axis_model: Optional[str] = None, extrapolate: bool = False,
               pidx=None, patterns=None):
    """Fused posterior-weighted smoothing (`mix.rs:239-251`) — or, with
    ``extrapolate=True``, extrapolation (`mix.rs:253-265`) — end to end in
    one pass: no (M, N, ...) intermediate ever materializes."""
    n = data.shape[0]
    if pidx is not None:
        dtype, tables, center = _pat_prep(Cs, means, sigmas, data, patterns)
        route = None
    else:
        dtype, CCs, route = _mix_prep(Cs, data, axis_model, "states")
        center = _center_prep(Cs, means) if route == "kernel" else None

    def body(_, fresh, datab, maskb, pb=None):
        datab = datab.astype(dtype)
        mask_f = maskb.astype(dtype)
        if pidx is not None:
            _, llks, s, _, _, _, _ = _block_post_pat(
                Cs, means, sigmas, tables, datab, mask_f, pb, center=center
            )
        elif route == "kernel":
            llks, s, _ = _block_llks_kernel(
                center, Cs, CCs, sigmas, datab, mask_f, "states"
            )
        else:
            _, llks, s, _, _ = _block_post(
                Cs, CCs, means, sigmas, datab, mask_f, route, axis_model, "states"
            )
        joint = llks + log_weights[:, None]                   # (M, B)
        post = jnp.exp(joint - _logsumexp0(joint)[None, :])
        # out[b, d] = sum_m post[m, b] (s[m, b] @ C_m^T + mu_m)[d]: fold the
        # posterior weights into the states so the M-component combine is ONE
        # (B, M k) x (M k, D) matmul.
        M, D_loc, k = Cs.shape
        B = datab.shape[0]
        ws = (post[..., None] * s).transpose(1, 0, 2).reshape(B, M * k)
        sm = ws @ Cs.transpose(0, 2, 1).reshape(M * k, D_loc) + post.T @ means
        if extrapolate:
            sm = jnp.where(maskb, datab, sm)
        return None, sm

    arrays = (data, mask, pidx) if pidx is not None else (data, mask)
    _, out, flatten = _scan_blocks(n, block_size, arrays, body, None)
    return flatten(out)


def _logsumexp0(x):
    m = jnp.max(x, axis=0)
    return m + jnp.log(jnp.sum(jnp.exp(x - m[None, :]), axis=0))


def mix_em_stats(Cs, means, sigmas, log_weights, data, mask, weights, *,
                 block_size: int, axis_model: Optional[str] = None) -> MixEMStats:
    """One fused pass computing every component's EM statistics, the
    responsibilities, the mixture llk, and the new-weight numerators."""
    from ..config import config

    n, _ = data.shape
    M, D_loc, k = Cs.shape
    dtype = ml.compute_dtype(data.dtype, Cs.dtype)
    CCs = (Cs[:, :, :, None] * Cs[:, :, None, :]).reshape(M, D_loc, k * k)
    route = ml.spd_route(k, dtype, EM_WANT, axis_model is not None)

    # config.mix_exact_rnorm: the fast block's expanded rnorm
    # quadratic cancels ~O(separation^2); the R-materializing _block_mix
    # computes it from the actual residual (see _block_mix_fast docstring).
    use_fast = axis_model is None and not config.mix_exact_rnorm
    if use_fast:
        # Loop-invariant operands of the fast block, hoisted: centering
        # pieces and the (.., M, D)-flattened transposes that make every
        # per-block contraction one plain matmul.
        mean0, dm, Cdm = _center_prep(Cs, means)
        Cs_t = jnp.transpose(Cs, (2, 0, 1)).reshape(k * M, D_loc)
        Cdm_t = jnp.transpose(Cdm, (2, 0, 1)).reshape(k * M, D_loc)
        CCs_t = jnp.transpose(CCs, (2, 0, 1)).reshape(k * k * M, D_loc)
        dm2 = dm * dm

    def body(acc, fresh, datab, maskb, w):
        # stale rows (the final window overlap, _scan_blocks) zero their
        # weight: every MixEMStats field is responsibility(= w post)-linear.
        w = w.astype(dtype) * fresh.astype(dtype)
        if use_fast:
            new = _block_mix_fast(Cs, Cs_t, Cdm_t, CCs_t, mean0, dm, dm2,
                                  sigmas, log_weights, datab.astype(dtype),
                                  maskb.astype(dtype), w, route)
        else:
            new = _block_mix(Cs, CCs, means, sigmas, log_weights,
                             datab.astype(dtype), maskb.astype(dtype),
                             w, route, axis_model)
        big = (acc[0] + new.cross, acc[1] + new.S)
        small = (new.square_error, new.dev_sq, new.total_dev, new.totals,
                 new.resp_sum, new.resp_max, new.llk)
        return big, small

    zero = (jnp.zeros((M, D_loc, k), dtype), jnp.zeros((M, D_loc, k * k), dtype))
    (cross, S), small, _ = _scan_blocks(
        n, block_size, (data, mask, weights), body, zero
    )
    (square_error, dev_sq, total_dev, totals, resp_sum, llk) = (
        jnp.sum(x, axis=0)
        for x in (small[0], small[1], small[2], small[3], small[4], small[6])
    )
    resp_max = jnp.max(small[5], axis=0)
    return MixEMStats(cross, S, square_error, dev_sq, total_dev, totals,
                      resp_sum, resp_max, llk)


def mix_em_stats_pat(Cs, means, sigmas, log_weights, data, mask, pidx, patterns,
                     weights, *, block_size: int) -> MixEMStats:
    """Pattern-deduplicated fused mixture EM statistics: all factorizations
    collapse to the M x P tables, the ``S`` statistic is grouped per pattern
    (per-pattern responsibility-weighted outer-product sums via a one-hot
    matmul when P <= D, then one (P, D) contraction), and ``square_error``
    and ``totals`` become P-sized sums.  Algebraically identical to
    :func:`mix_em_stats`; a fully-observed dataset is the P = 1 case (the
    dense-mixture fast path)."""
    n, _ = data.shape
    M, D_loc, k = Cs.shape
    dtype = ml.compute_dtype(data.dtype, Cs.dtype)
    patterns_f = patterns.astype(dtype)
    P = patterns_f.shape[0]
    from ..config import config

    tables = compute_mix_tables(Cs, sigmas, patterns_f)
    group_outer = P <= D_loc
    # s_slab_stats: compute/accumulate only the tril block-wedge of the
    # s s^T outer statistic (see the Souter comment in body); q_pack is the
    # packed width the scan carries.
    slab = config.s_slab_stats and k > 0
    souter_ranges = ml._sm_slabs(k) if slab else [(0, k, k)]
    q_pack = ml._s_packed_width(k) if slab else k * k
    grouped = config.pat_grouped_estep
    center = _center_prep(Cs, means)
    mean0, dm, _ = center
    # mix_exact_rnorm: center=None makes _block_post_pat materialize the
    # per-component residual, so rnorm (hence llks/dev_sq) avoids the
    # expanded quadratic's O(separation^2) cancellation (see _block_mix_fast).
    post_center = None if config.mix_exact_rnorm else center

    def body(acc, fresh, datab, maskb, pb, w):
        datab = datab.astype(dtype)
        mask_f = maskb.astype(dtype)
        # stale rows (final-window overlap) zero their weight; every
        # statistic below is responsibility(= w post)-linear.
        w = w.astype(dtype) * fresh.astype(dtype)
        B = datab.shape[0]
        # center => no (M, B, D) R; b/rnorm come from shared matmuls against
        # mask*(data - mean0) and mask (see _block_post_pat).
        _, llks, s, _, sq_b, b, rnorm = _block_post_pat(
            Cs, means, sigmas, tables, datab, mask_f, pb, post_center
        )
        md0 = mask_f * (datab - mean0[None, :])             # (B,D) shared

        joint = llks + log_weights[:, None]                 # (M,B)
        lse = _logsumexp0(joint)
        post = jnp.exp(joint - lse[None, :])
        llk_mix = jnp.sum(w * lse)
        resp = post * w[None, :]

        # cross = sum_b R_m (s resp): R_m = md0 - mask*dm_m never exists —
        # one shared flattened matmul against the data + a dm-scaled mask
        # correction.  Under config.pat_grouped_estep the mask correction
        # is pattern-grouped: srw @ mask == (srw @ onehot) @ patterns (the
        # mask IS the pattern row), so the per-block (k*M, B) x (B, D)
        # matmul and its mask re-read become a tiny (k*M, P) accumulation
        # applied once at assembly — an exact sum reordering.
        srw = (s * resp[..., None]).transpose(2, 0, 1).reshape(k * M, B)
        c1 = lax.dot_general(srw, md0, (((1,), (0,)), ((), ())))
        onehot = (pb[:, None] == jnp.arange(P, dtype=pb.dtype)[None, :]).astype(dtype)
        if grouped:
            psrw = lax.dot_general(srw, onehot, (((1,), (0,)), ((), ())))  # (kM,P)
            cross = jnp.transpose(c1.reshape(k, M, D_loc), (1, 2, 0))
            c2t = None
        else:
            psrw = jnp.zeros((k * M, P), dtype)
            c2 = lax.dot_general(srw, mask_f, (((1,), (0,)), ((), ())))
            c2t = jnp.transpose(c2.reshape(k, M, D_loc), (1, 2, 0))  # (M,D,k)
            cross = (jnp.transpose(c1.reshape(k, M, D_loc), (1, 2, 0))
                     - dm[:, :, None] * c2t)
        wsum = jnp.einsum("mb,bp->mp", resp, onehot)        # (M,P)
        # Souter needs the order-3 contraction onehot x s_i x s_j, which has
        # no two-matmul factoring; instead of materializing the full
        # (M, B, k^2) outer_s (268 MB/block at k=32, M=8 — the round-2
        # block-size cap), build it in (row-range, col-width) pieces so the
        # temporary stays ~<=64 MB and each piece is still one matmul.
        # config.s_slab_stats narrows each row range's columns to the
        # ml._sm_slabs wedge (cw = r1): only the entries mix_em_finalize's
        # tril + tril^T reconstruction reads are ever computed (~0.55x the
        # outer flops at k=64), accumulated PACKED and unpacked after the
        # scan.  Without the flag the ranges cover the full k columns.
        sw = s * resp[..., None]                            # (M,B,k) weighted once
        parts = []
        for r0, r1, cw in souter_ranges:
            ic = max(1, (1 << 26) // max(1, M * B * cw * 4))  # rows: ~64 MB temp
            for i0 in range(r0, r1, ic):
                i1 = min(i0 + ic, r1)
                chunk = (sw[..., i0:i1, None] * s[..., None, :cw]).reshape(
                    M, B, (i1 - i0) * cw
                )
                if group_outer:
                    parts.append(jnp.einsum("bp,mbq->mpq", onehot, chunk))
                else:
                    parts.append(jnp.einsum("bd,mbq->mdq", mask_f, chunk))
        Souter = (
            parts[0]
            if len(parts) == 1
            else jnp.concatenate(parts, axis=-1)
        )
        # parts are (M, *, rows*cw) pieces of the (i, j)-flattened outer axis
        # in row order within each range, so concatenation restores the exact
        # layout (full (k*k,), or the _sm_slabs packing under the flag).

        # Residual statistics without the (M, B, D) dev array: s = M^{-1} b
        # exactly (s = Sigma b / sigma^2), so s^T G s = b.s - sigma^2 |s|^2
        # and |dev|^2 = rnorm - b.s - sigma^2 |s|^2 per sample; b/rnorm come
        # straight from _block_post_pat.
        sigma2 = (sigmas * sigmas)[:, None]
        bs = jnp.sum(b * s, axis=-1)
        s2 = jnp.sum(s * s, axis=-1)
        # clamp: epsilon-negative in f32 iff |dev|^2 ~ 0 (see dense_fast)
        dev_sq = jnp.sum(resp * jnp.maximum(rnorm - bs - sigma2 * s2, 0.0),
                         axis=-1)
        t1 = lax.dot_general(resp, md0, (((1,), (0,)), ((), ())))
        if grouped:
            # resp @ mask == wsum @ patterns and the Cs*c2t term are both
            # linear in the accumulated pieces — applied at assembly.
            total_dev = t1
        else:
            rm = lax.dot_general(resp, mask_f, (((1,), (0,)), ((), ())))
            total_dev = t1 - dm * rm - jnp.sum(Cs * c2t, axis=-1)
        square_error = jnp.sum(resp * sq_b, axis=-1)
        resp_sum = jnp.sum(resp, axis=-1)
        resp_max = jnp.max(resp, axis=-1)

        big = (acc[0] + cross, acc[1] + Souter, acc[2] + wsum, acc[3] + psrw)
        small = (square_error, dev_sq, total_dev, resp_sum, resp_max, llk_mix)
        return big, small

    souter_shape = (M, P, q_pack) if group_outer else (M, D_loc, q_pack)
    zero = (
        jnp.zeros((M, D_loc, k), dtype),
        jnp.zeros(souter_shape, dtype),
        jnp.zeros((M, P), dtype),
        jnp.zeros((k * M, P), dtype),
    )
    (cross, Souter, wsum, psrw), small, _ = _scan_blocks(
        n, block_size, (data, mask, pidx, weights), body, zero
    )
    square_error, dev_sq, total_dev, resp_sum, llk = (
        jnp.sum(x, axis=0)
        for x in (small[0], small[1], small[2], small[3], small[5])
    )
    resp_max = jnp.max(small[4], axis=0)
    if grouped:
        # apply the pattern-grouped mask corrections once: c2 = psrw @
        # patterns and rm = wsum @ patterns (exact reorderings of the
        # per-block sums).
        c2t = jnp.transpose(
            (psrw @ patterns_f).reshape(k, M, D_loc), (1, 2, 0)
        )                                                    # (M,D,k)
        cross = cross - dm[:, :, None] * c2t
        rm = wsum @ patterns_f                               # (M,D)
        total_dev = total_dev - dm * rm - jnp.sum(Cs * c2t, axis=-1)

    Sigma = tables[0]                                        # (M,P,k^2)
    if slab:
        # pack the (cheap, P-sized) covariance table the same way so the
        # reconstruction runs at the packed width too.
        Sigma4 = Sigma.reshape(M, P, k, k)
        Sigma = jnp.concatenate(
            [
                Sigma4[..., r0:r1, :cw].reshape(M, P, (r1 - r0) * cw)
                for r0, r1, cw in souter_ranges
            ],
            axis=-1,
        )
    if group_outer:
        S = jnp.einsum("pd,mpq->mdq", patterns_f, Souter + wsum[..., None] * Sigma)
    else:
        S = Souter + jnp.einsum("pd,mpq->mdq", patterns_f, wsum[..., None] * Sigma)
    if slab:
        S = ml._s_unpack(S.reshape(M * D_loc, q_pack), k).reshape(M, D_loc, k * k)
    totals = jnp.einsum("mp,pd->md", wsum, patterns_f)
    return MixEMStats(cross, S, square_error, dev_sq, total_dev, totals,
                      resp_sum, resp_max, llk)


def mix_em_finalize(Cs, means, sigmas, stats: MixEMStats, *,
                    transformation_precision,
                    noise_prior=None, mean_prior=None,
                    axis_model: Optional[str] = None):
    """Vmapped per-component M-step (same math as masked_linalg.em_finalize)
    plus the new mixture log-weights (`mix.rs:324-335`)."""

    # The reference runs each component's inner EM with weights scaled to
    # max 1 (`mix.rs:310-323`); prior strengths are relative to that scale,
    # so the (weight-linear) statistics are rescaled the same way here.
    # A dead component (zero responsibility everywhere, possible via f32
    # underflow when another component dominates by >~103 nats) has
    # resp_max == 0: guard the reciprocal and keep its old parameters below
    # instead of propagating inf/NaN through the whole mixture.
    alive = stats.resp_max > 0
    inv_scale = jnp.where(alive, 1.0 / jnp.where(alive, stats.resp_max, 1.0), 0.0)

    def finalize_one(C, mean, sigma, cross, S, square_error, dev_sq,
                     total_dev, totals, c, rows=None, *, under_vmap=False):
        st = ml.EMStats(cross * c, S * c, square_error * c, dev_sq * c,
                        total_dev * c, totals * c, jnp.zeros((), C.dtype))
        return ml.em_finalize(
            C, mean, sigma, st,
            transformation_precision=transformation_precision,
            noise_prior=noise_prior,
            mean_prior=mean_prior,
            axis_model=axis_model,
            transform_rows=rows,
            under_vmap=under_vmap,
        )

    finalize_vmapped = functools.partial(finalize_one, under_vmap=True)

    if axis_model is None:
        M, D_loc, k = Cs.shape
        rows_pre = None
        # The kernel and the blocked inverse run outside the vmapped
        # finalize: the M x D_loc per-row solves are flattened into ONE call
        # here and handed to it via transform_rows (same scaled statistics).
        route = ml.spd_route(k, Cs.dtype, "rows", False)
        if route != "xla":
            S_sc = stats.S * inv_scale[:, None, None]
            cr_sc = (stats.cross * inv_scale[:, None, None]).reshape(M * D_loc, k)
            # S's upper triangle is unreliable on the pattern paths
            # (config.s_slab_stats); restore symmetry from the lower one.
            S_sq = S_sc.reshape(M * D_loc, k, k)
            S_sq = jnp.tril(S_sq) + jnp.swapaxes(jnp.tril(S_sq, -1), -1, -2)
            if route == "kernel":
                rows_pre = ml._kernel_rows_solve(S_sq, cr_sc, transformation_precision)
            else:
                from . import block_spd

                # singular rows go non-finite and take the keep-old-row
                # fallback inside em_finalize, exactly like the LU path
                rows_pre = block_spd.solve_psd(S_sq, cr_sc, transformation_precision)
            rows_pre = rows_pre.reshape(M, D_loc, k)
        if rows_pre is not None:
            new_Cs, new_means, new_sigmas = jax.vmap(finalize_vmapped)(
                Cs, means, sigmas, stats.cross, stats.S, stats.square_error,
                stats.dev_sq, stats.total_dev, stats.totals, inv_scale,
                rows_pre,
            )
        else:
            new_Cs, new_means, new_sigmas = jax.vmap(finalize_vmapped)(
                Cs, means, sigmas, stats.cross, stats.S, stats.square_error,
                stats.dev_sq, stats.total_dev, stats.totals, inv_scale,
            )
    else:
        # collectives inside vmap are awkward; M is small — loop.
        outs = [
            finalize_one(Cs[m], means[m], sigmas[m], stats.cross[m], stats.S[m],
                         stats.square_error[m], stats.dev_sq[m],
                         stats.total_dev[m], stats.totals[m], inv_scale[m])
            for m in range(Cs.shape[0])
        ]
        new_Cs = jnp.stack([o[0] for o in outs])
        new_means = jnp.stack([o[1] for o in outs])
        new_sigmas = jnp.stack([o[2] for o in outs])

    # Dead components keep their previous parameters (the finalize math on
    # all-zero statistics yields 0/0); their new mixture weight is exp(-inf)=0.
    new_Cs = jnp.where(alive[:, None, None], new_Cs, Cs)
    new_means = jnp.where(alive[:, None], new_means, means)
    new_sigmas = jnp.where(alive, new_sigmas, sigmas)

    new_log_weights = jnp.log(stats.resp_sum)
    new_log_weights = new_log_weights - jax.scipy.special.logsumexp(new_log_weights)
    return new_Cs, new_means, new_sigmas, new_log_weights


def mix_em_stats_pat_sorted(Cs, means, sigmas, log_weights, data_sorted,
                            weights_sorted, patterns, counts, *,
                            block_size: int) -> MixEMStats:
    """Pattern-SORTED segment mixture EM statistics — the flop-minimal
    pattern-mixture path (single-model analog: pattern_dedup.
    em_stats_sorted; see its docstring for the sorted-layout contract).

    Inside a segment every component's mask quantities are constants:
    ``b_m = md0 @ C_m - bcorr[p, m]`` (one shared (B, D) x (D, M*k)
    matmul + a precomputed (P, M, k) table), states are ONE batched
    (M, B', k) x (M, k, k) matmul against the segment's table column —
    2k^2 flops/sample/component instead of the candidates matmul's
    2*P*k^2 (the dominant cost of the grouped path: ~4.2M of its ~11M
    effective flops/sample at M=8, P=32, k=64) — and the per-pattern
    outer statistic is a plain batched segment Gram instead of the
    one-hot contraction (2*q*128 effective -> 2k^2).  Responsibilities
    are computed inside the segment (the per-component llk differs only
    through b/rnorm, which are exact there).

    Exact reordering of :func:`mix_em_stats_pat`'s sums; f64 parity is
    pinned by tests/test_mix_fused.py.  Reference semantics:
    `ppca/src/mix.rs:281-337`, regrouped by pattern segment.
    """
    from ..config import block_size_for, config

    n = data_sorted.shape[0]
    M, D_loc, k = Cs.shape
    dtype = ml.compute_dtype(data_sorted.dtype, Cs.dtype)
    patterns_f = patterns.astype(dtype)
    P = patterns_f.shape[0]
    if len(counts) != P or sum(counts) != n:
        raise ValueError(
            f"counts {len(counts)}/{sum(counts)} do not partition "
            f"{P} patterns x {n} rows"
        )
    tables = compute_mix_tables(Cs, sigmas, patterns_f)
    Sig4 = tables[0].reshape(M, P, k, k)
    pat_llk, sq_tab = tables[1], tables[2]                   # (M, P) each
    mean0, dm, Cdm = _center_prep(Cs, means)
    Cflat = jnp.transpose(Cs, (1, 0, 2)).reshape(D_loc, M * k)
    # P-sized loop-invariant tables: computed once, so full product
    # precision is free (the expanded-rnorm identity is cancellation-prone;
    # see _block_post_pat's hp matmuls)
    hp = jax.lax.Precision.HIGHEST
    bcorr = jnp.einsum("pd,mdk->pmk", patterns_f, Cdm, precision=hp)
    m2_tab = jnp.matmul(patterns_f, (dm * dm).T, precision=hp)  # (P, M)
    sigma2 = (sigmas * sigmas)                               # (M,)
    exact_rnorm = config.mix_exact_rnorm

    cross1 = jnp.zeros((M * k, D_loc), dtype)                # md0-half of cross
    t1 = jnp.zeros((M, D_loc), dtype)
    dev_sq = jnp.zeros((M,), dtype)
    llk = jnp.zeros((), dtype)
    resp_max = jnp.zeros((M,), dtype)
    souter, psw_l, wsum_l = [], [], []
    off = 0
    for p, c in enumerate(counts):
        if c == 0:
            souter.append(jnp.zeros((M, k * k), dtype))
            psw_l.append(jnp.zeros((M, k), dtype))
            wsum_l.append(jnp.zeros((M,), dtype))
            continue
        dseg = lax.slice_in_dim(data_sorted, off, off + c, axis=0)
        wseg = lax.slice_in_dim(weights_sorted, off, off + c, axis=0)
        off += c
        m_p = patterns_f[p]                                  # (D,) constant
        Sp = Sig4[:, p]                                      # (M, k, k)
        bc_p = bcorr[p]                                      # (M, k)
        m2_p = m2_tab[p]                                     # (M,)
        pl_p = pat_llk[:, p]                                 # (M,)

        def body(acc, fresh, db, wb, m_p=m_p, Sp=Sp, bc_p=bc_p, m2_p=m2_p,
                 pl_p=pl_p):
            B = db.shape[0]
            w = wb.astype(dtype) * fresh.astype(dtype)
            md0 = m_p * (db.astype(dtype) - mean0)           # (B, D)
            bflat = md0 @ Cflat                              # (B, M*k)
            b = bflat.reshape(B, M, k) - bc_p[None]          # (B, M, k)
            s = jnp.einsum("bmk,mkj->bmj", b, Sp) / sigma2[None, :, None]
            if exact_rnorm:
                Rm = m_p * (db.astype(dtype)[None] - means[:, None, :])
                rnorm = jnp.sum(Rm * Rm, axis=-1).T          # (B, M)
            else:
                rd2 = jnp.sum(md0 * md0, axis=-1)            # (B,)
                mdm = jnp.matmul(md0, dm.T, precision=jax.lax.Precision.HIGHEST)
                rnorm = rd2[:, None] - 2.0 * mdm + m2_p[None]
            bs = jnp.sum(b * s, axis=-1)                     # (B, M)
            quad = (rnorm - bs) / sigma2[None]
            llks = pl_p[None] - 0.5 * quad                   # (B, M)
            joint = (llks + log_weights[None, :]).T          # (M, B)
            lse = _logsumexp0(joint)                         # (B,)
            post = jnp.exp(joint - lse[None, :])             # (M, B)
            resp = (post * w[None, :]).T                     # (B, M)
            sw = s * resp[..., None]                         # (B, M, k)
            swf = sw.reshape(B, M * k)
            c1 = lax.dot_general(swf, md0, (((0,), (0,)), ((), ())))
            so = jnp.einsum("bmk,bmj->mkj", sw, s)           # (M, k, k)
            s2 = jnp.sum(s * s, axis=-1)
            # clamp: epsilon-negative in f32 iff |dev|^2 ~ 0 (see dense_fast)
            dv = jnp.sum(resp * jnp.maximum(
                rnorm - bs - sigma2[None] * s2, 0.0), axis=0)
            tt = lax.dot_general(resp, md0, (((0,), (0,)), ((), ())))  # (M, D)
            return (
                (acc[0] + c1, acc[1] + so.reshape(M, k * k),
                 acc[2] + jnp.sum(sw, axis=0), acc[3] + jnp.sum(resp, axis=0),
                 acc[4] + dv, acc[5] + tt, acc[6] + jnp.sum(w * lse),
                 jnp.maximum(acc[7], jnp.max(resp, axis=0))),
                None,
            )

        zero = (
            jnp.zeros((M * k, D_loc), dtype), jnp.zeros((M, k * k), dtype),
            jnp.zeros((M, k), dtype), jnp.zeros((M,), dtype),
            jnp.zeros((M,), dtype), jnp.zeros((M, D_loc), dtype),
            jnp.zeros((), dtype), jnp.zeros((M,), dtype),
        )
        acc, _, _ = _scan_blocks(
            c, min(block_size, block_size_for(c, 0, M)), (dseg, wseg), body,
            zero,
        )
        cross1 = cross1 + acc[0]
        souter.append(acc[1])
        psw_l.append(acc[2])
        wsum_l.append(acc[3])
        dev_sq = dev_sq + acc[4]
        t1 = t1 + acc[5]
        llk = llk + acc[6]
        resp_max = jnp.maximum(resp_max, acc[7])

    Souter_t = jnp.stack(souter)                             # (P, M, k^2)
    psw_t = jnp.stack(psw_l)                                 # (P, M, k)
    wsum_t = jnp.stack(wsum_l)                               # (P, M)

    # cross: the md0 half accumulated per block; the mask*dm half grouped
    # per pattern (same identities as mix_em_stats_pat's grouped assembly).
    c2t = jnp.einsum("pd,pmk->mdk", patterns_f, psw_t)       # (M, D, k)
    cross = (jnp.transpose(cross1.reshape(M, k, D_loc), (0, 2, 1))
             - dm[:, :, None] * c2t)
    rm = jnp.einsum("pm,pd->md", wsum_t, patterns_f)         # (M, D)
    total_dev = t1 - dm * rm - jnp.sum(Cs * c2t, axis=-1)
    S = jnp.einsum(
        "pd,mpq->mdq", patterns_f,
        jnp.transpose(Souter_t, (1, 0, 2)) + wsum_t.T[..., None] * tables[0],
    )
    square_error = jnp.sum(wsum_t.T * sq_tab, axis=-1)       # (M,)
    resp_sum = jnp.sum(wsum_t, axis=0)                       # (M,)
    totals = rm
    return MixEMStats(cross, S, square_error, dev_sq, total_dev, totals,
                      resp_sum, resp_max, llk)
