"""Fused batched SPD E-step kernel (Pallas, Triton route, NVIDIA GPUs).

Per sample, the masked-PPCA E-step factors ``M = sigma^2 I + G`` (G the
masked Gram ``C^T diag(m) C``) and derives everything downstream from that
one factorization: the posterior state ``s = M^{-1} b``, the log-likelihood
(log-determinant plus quadratic form), the noise-update term
``sq = tr(G Sigma)`` and the second moment ``SM = s s^T + sigma^2 M^{-1}``
(or the covariance ``Sigma = sigma^2 M^{-1}`` itself).  XLA runs this as a
batched Cholesky, two batched triangular solves and a handful of
elementwise passes, writing ``M``, ``L`` and ``M^{-1}`` to device memory
between them; the kernel reads ``G`` once and writes only what the caller
asked for.

Layout: sample-major.  Each program owns ``S`` samples whose (kp, kp)
working matrices live in registers; ``kp`` is ``k`` rounded up to a power
of two (Triton block shapes must be) and ``S * kp * kp`` is about one
4096-element tile, so small state sizes pack several samples per program.

One Gauss-Jordan loop over the k columns does the whole factorization.
At column j, with A the working copy of M, v of b and R of I::

    col_j  = A[:, j];  d_j = A[j, j]       # pivot = Cholesky's L_jj^2
    f      = col_j / d_j, with f_j = 0
    A     -= f row_j^T                     # row_j = col_j below the pivot
    v     -= f v_j                         # ends as D M^{-1} b
    R     -= f R[j]^T                      # ends as D M^{-1} ("fullt"/"infer")
    logdet += log d_j

with D = diag(d).  Row j needs no second extraction: left of the pivot it
is zero, and the trailing block is the symmetric Schur complement, so it
equals the lower part of column j.  Column and row extraction are masked
reductions (no dynamic register indexing), which is what Triton lowers.
The states are ``s = v / d``, the quadratic form ``b^T M^{-1} b = b . s``,
and the trace identity ``tr(G M^{-1}) = k - sigma^2 tr(M^{-1})`` gives
``sq`` without keeping G.  An SPD matrix needs no pivoting: the pivots
are those of its Cholesky factorization.

Padding: padded state dims get a unit diagonal and zero coupling, so they
factor to themselves (log 1 = 0, zero state) and the column loop stops at
the real ``k``; padded samples are identity matrices.  A zero noise level
is accepted (the M-step row solve ``(S + lam I) x = cross`` runs through
``want="states"`` with ``sigma^2 = lam``), since the padded diagonal never
depends on it.

Variants (static ``want``): ``"llk"`` -> llk; ``"states"`` -> (s, llk);
``"fullt"`` -> (s, SM, llk, sq); ``"infer"`` -> (s, Sigma, llk).

Equivalent to (and tested against) the XLA path in
``ops/masked_linalg.block_posterior`` + ``block_covariances`` +
``block_llk``, which mirrors `ppca/src/output_covariance.rs` /
`ppca_model.rs:195-208`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

LN_2PI = 1.8378770664093453

#: Largest state size the router sends to the kernel (larger k still
#: computes correctly, only slower).  The fullt/infer variants hold two
#: (kp, kp) f32 matrices per sample in registers: 8K values at kp = 64
#: (64 per thread at 4 warps), 32K at kp = 128, where one program fills the
#: 64K-register file of an SM.  Measured on an H100 at B = 8192, k = 128
#: ran slower than XLA's batched Cholesky route and k = 64 faster
#: (docs/DESIGN.md §2).
MAX_K = 64

#: Elements of one working matrix per program (S * kp * kp).
_TILE = 4096

WANTS = ("llk", "states", "fullt", "infer")


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def padded_k(k: int) -> int:
    """The kernel's working width for state size ``k``."""
    return max(8, _pow2(k))


def samples_per_program(k: int, batch: int) -> int:
    """Samples one program owns: about one ``_TILE`` of working matrix,
    never more than the (power-of-two rounded) batch itself."""
    kp = padded_k(k)
    return max(1, min(_TILE // (kp * kp), _pow2(batch)))


def _num_warps(k: int, batch: int) -> int:
    """4 warps up to one 4096-element tile, 8 above (measured on an H100:
    4 beat 8 at k = 64, 8 beat 16 and 32 at k = 128)."""
    return 4 if samples_per_program(k, batch) * padded_k(k) ** 2 <= _TILE else 8


def _make_kernel(want: str, k: int, kp: int, S: int):
    def kernel(sig_ref, g_ref, b_ref, rn_ref, dob_ref, *out_refs):
        dtype = g_ref.dtype
        sigma = sig_ref[...]
        sigma2 = sigma * sigma                                  # (S,)
        ii = lax.broadcasted_iota(jnp.int32, (S, kp), 1)
        rr = lax.broadcasted_iota(jnp.int32, (S, kp, kp), 1)
        cc = lax.broadcasted_iota(jnp.int32, (S, kp, kp), 2)
        eye = (rr == cc).astype(dtype)
        diag = jnp.where(ii < k, sigma2[:, None], 1.0)          # (S, kp)
        A0 = g_ref[...] + eye * diag[:, :, None]
        b = b_ref[...]
        need_minv = want in ("fullt", "infer")

        def body(j, carry):
            A, v, dvec, logdet, R = carry
            col = jnp.sum(jnp.where(cc == j, A, 0.0), axis=2)   # A[:, :, j]
            d = jnp.sum(jnp.where(ii == j, col, 0.0), axis=1)
            # row j: zero left of the pivot, and the trailing block is the
            # (symmetric) Schur complement, so it is the column's lower part
            row = jnp.where(ii >= j, col, 0.0)
            f = jnp.where(ii == j, 0.0, col * (1.0 / d)[:, None])
            A = A - f[:, :, None] * row[:, None, :]
            vj = jnp.sum(jnp.where(ii == j, v, 0.0), axis=1)
            v = v - f * vj[:, None]
            if need_minv:
                rrow = jnp.sum(jnp.where(rr == j, R, 0.0), axis=1)
                R = R - f[:, :, None] * rrow[:, None, :]
            dvec = jnp.where(ii == j, d[:, None], dvec)
            return A, v, dvec, logdet + jnp.log(d), R

        R0 = eye if need_minv else jnp.zeros((S,), dtype)
        carry = (A0, b, jnp.ones((S, kp), dtype), jnp.zeros((S,), dtype), R0)
        _, v, dvec, logdet, R = lax.fori_loop(0, k, body, carry)
        s = v / dvec                                            # M^{-1} b

        d_obs = dob_ref[...]
        ld = logdet + jnp.log(sigma2) * (d_obs - k)
        quad = jnp.sum(b * s, axis=1)
        llk = -0.5 * ((rn_ref[...] - quad) / sigma2 + ld + LN_2PI * d_obs)

        if want == "llk":
            (llk_ref,) = out_refs
        elif want == "states":
            s_ref, llk_ref = out_refs
            s_ref[...] = s
        else:
            Sig = (sigma2[:, None] / dvec)[:, :, None] * R      # sigma^2 M^{-1}
            if want == "fullt":
                s_ref, sm_ref, llk_ref, sq_ref = out_refs
                sm_ref[...] = s[:, :, None] * s[:, None, :] + Sig
                tr = jnp.sum(jnp.where(ii < k, jnp.sum(Sig * eye, axis=2), 0.0), axis=1)
                sq_ref[...] = sigma2 * k - sigma2 * tr
            else:  # infer
                s_ref, sm_ref, llk_ref = out_refs
                sm_ref[...] = Sig
            s_ref[...] = s
        llk_ref[...] = llk

    return kernel


@functools.partial(jax.jit, static_argnames=("want", "interpret"))
def spd_estep(G, b, rnorm, d_obs, sigma, *, want: str, interpret: bool = False):
    """Fused batched SPD E-step.

    Args:
      G: (B, k, k) per-sample masked Grams ``C^T diag(m) C``.
      b: (B, k) per-sample ``C^T (m * (y - mu))``.
      rnorm: (B,) squared norms of the masked centred samples.
      d_obs: (B,) observed-entry counts.
      sigma: isotropic noise (not squared), scalar or per sample (B,) —
        the fused mixture stacks components with different noise levels.
      want: "llk" -> llk; "states" -> (s, llk); "fullt" -> (s, SM, llk, sq);
        "infer" -> (s, Sigma, llk).
      interpret: run the kernel in the Pallas interpreter (tests only).

    Returns s (B, k) posterior states, SM (B, k, k) second moments
    ``s s^T + sigma^2 M^{-1}`` (or Sigma = ``sigma^2 M^{-1}``), llk (B,)
    log-likelihoods and sq (B,) = ``tr(G Sigma)``.
    """
    if want not in WANTS:
        raise ValueError(f"want must be one of {WANTS}")
    B, k, _ = G.shape
    if k < 1:
        raise ValueError("the kernel needs a state size k >= 1")
    dtype = G.dtype
    kp = padded_k(k)
    S = samples_per_program(k, B)
    Bp = -(-B // S) * S
    sigma = jnp.broadcast_to(jnp.asarray(sigma, dtype), (B,))
    if kp != k:
        G = jnp.pad(G, ((0, 0), (0, kp - k), (0, kp - k)))
        b = jnp.pad(b, ((0, 0), (0, kp - k)))
    if Bp != B:
        pad = Bp - B
        G = jnp.concatenate([G, jnp.broadcast_to(jnp.eye(kp, dtype=dtype), (pad, kp, kp))])
        b = jnp.pad(b, ((0, pad), (0, 0)))
        rnorm = jnp.pad(rnorm, (0, pad))
        d_obs = jnp.pad(d_obs, (0, pad))
        sigma = jnp.pad(sigma, (0, pad), constant_values=1.0)

    vec = pl.BlockSpec((S,), lambda i: (i,))
    mat = pl.BlockSpec((S, kp), lambda i: (i, 0))
    cube = pl.BlockSpec((S, kp, kp), lambda i: (i, 0, 0))
    vec_out = jax.ShapeDtypeStruct((Bp,), dtype)
    mat_out = jax.ShapeDtypeStruct((Bp, kp), dtype)
    cube_out = jax.ShapeDtypeStruct((Bp, kp, kp), dtype)
    outs = {
        "llk": ((vec,), (vec_out,)),
        "states": ((mat, vec), (mat_out, vec_out)),
        "fullt": ((mat, cube, vec, vec), (mat_out, cube_out, vec_out, vec_out)),
        "infer": ((mat, cube, vec), (mat_out, cube_out, vec_out)),
    }
    out_specs, out_shape = outs[want]
    res = pl.pallas_call(
        _make_kernel(want, k, kp, S),
        grid=(Bp // S,),
        in_specs=[vec, cube, mat, vec, vec],
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_num_warps(k, B), num_stages=1
        ),
        interpret=interpret,
        name=f"spd_estep_{want}",
    )(sigma, G.astype(dtype), b.astype(dtype), rnorm.astype(dtype),
      d_obs.astype(dtype))

    def cut(x):
        x = x[:B]
        if x.ndim >= 2:
            x = x[:, :k]
        if x.ndim == 3:
            x = x[:, :, :k]
        return x

    res = tuple(cut(x) for x in res)
    return res[0] if want == "llk" else res
