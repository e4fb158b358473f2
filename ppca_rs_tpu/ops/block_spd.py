"""Size-generic batched SPD inversion: blocked Schur complements on matmuls.

The reference's per-sample algebra is unbounded in the state size k
(`ppca/src/output_covariance.rs:72-121` gathers observed rows and solves
whatever k it is given).  Past the fused kernel's ceiling
(ops/kernels.MAX_K) the E-step needs a route whose cost grows with large
batched matmuls rather than with a batched factorization of big matrices.
The batched SPD inverse and log-determinant of
``M = sigma^2 I + C^T diag(m) C`` are computed here by recursive 2x2
Schur-complement blocking::

    M = [A  B ]        M^{-1} = [ Ai + W Si W^T   -W Si ]
        [B^T C ]                [   -(W Si)^T       Si  ]

    with  W = Ai B,   S = C - B^T W  (the Schur complement),  Si = S^{-1}

where every off-base operation is one large batched matmul and the
(B, <=BASE, <=BASE) base problems go through batched Cholesky.

Numerical notes:

* Every trailing Schur complement of an SPD matrix M satisfies
  ``lambda_min(S) >= lambda_min(M)`` (S is the inverse of a principal
  submatrix of M^{-1}), so with ``M = G + sigma^2 I`` the base problems
  stay at least as well-conditioned as M itself at every level.
* The recursion's matmuls run at ``precision="highest"`` (full f32): the
  Schur update ``C - B^T W`` is a genuine cancellation, and reduced
  precision would feed its error through every deeper level.
* The flop count is ~2 B k^3 for the inverse (vs ~1/3 B k^3 for a
  factorization alone), but it is matmul work; the E-step at these k
  needs the full inverse anyway (the posterior second moment
  ``s s^T + sigma^2 M^{-1}`` is a dense (k, k) output per sample).

Routing lives in masked_linalg (``spd_route``); this module is pure linear
algebra with no PPCA knowledge beyond the eigenvalue-floor convention
above.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

#: Base-case size: problems up to this width are factored directly.
BASE = 256


def mm_hp(a, b):
    """Batched matmul at full-f32 precision (see module docstring).  Also
    used by callers to APPLY the inverse (``Minv @ b``): the surrounding
    model code may run under a "default" (bf16-pass) matmul-precision
    context, and solve applications should keep solve-grade precision."""
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)


_mm = mm_hp


def _t(a):
    return jnp.swapaxes(a, -1, -2)


def base_inv_logdet_xla(M: jax.Array):
    """Cholesky-based base case: (B, p, p) -> inverse and log-determinant."""
    from jax.scipy.linalg import cho_solve

    L = jnp.linalg.cholesky(M)
    eye = jnp.broadcast_to(jnp.eye(M.shape[-1], dtype=M.dtype), M.shape)
    Minv = cho_solve((L, True), eye)
    logdet = 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1
    )
    return Minv, logdet


def _split(p: int) -> int:
    """Leading block size: half of p rounded up to a multiple of 8."""
    return 8 * (-(-p // 16))


def _inv_logdet(M, base_fn: Callable, base: int):
    p = M.shape[-1]
    if p <= base:
        return base_fn(M)
    p1 = min(_split(p), base * (-(-p // (2 * base))))
    A = M[:, :p1, :p1]
    Bm = M[:, :p1, p1:]
    Cm = M[:, p1:, p1:]
    Ai, ldA = _inv_logdet(A, base_fn, base)
    W = _mm(Ai, Bm)                       # (B, p1, p2)
    S = Cm - _mm(_t(Bm), W)               # Schur complement, SPD
    S = 0.5 * (S + _t(S))                 # keep the base factor symmetric
    Si, ldS = _inv_logdet(S, base_fn, base)
    WSi = _mm(W, Si)
    TL = Ai + _mm(WSi, _t(W))
    top = jnp.concatenate([TL, -WSi], axis=-1)
    bot = jnp.concatenate([-_t(WSi), Si], axis=-1)
    return jnp.concatenate([top, bot], axis=-2), ldA + ldS


def solve_rows(k: int) -> int:
    """Batch-chunk size for :func:`solve_psd`: the recursion holds ~6 live
    (rows, k, k) f32 arrays, so cap each at 1/64 of the device's memory
    (256 MB on a 16 GiB device)."""
    from ..config import device_bytes

    return max(128, (device_bytes() // 64) // max(1, k * k * 4))


def solve_psd(S_sq: jax.Array, rhs: jax.Array, lam) -> jax.Array:
    """Batched ``(S[d] + lam I) x = rhs[d]`` through the blocked inverse —
    the M-step row solve on the blocked route
    (masked_linalg.em_finalize / mix_fused.mix_em_finalize).  ``S_sq`` is
    (B, k, k) symmetric PSD, ``rhs`` (B, k).  A singular row (e.g. an empty
    dimension with lam = 0) yields non-finite entries for that row exactly
    like the LU path, taking the caller's keep-old-row fallback.

    The batch runs in :func:`solve_rows`-sized chunks under ``lax.map``:
    only the solutions persist across chunks, never the full (B, k, k)
    inverse — at the mixture's (M*D, k, k) M-step batch (8192 rows at
    k=512, M=8, D=1024) the unchunked inverse alone would be ~8.6 GB."""
    B, k = rhs.shape
    dtype = S_sq.dtype
    eye = jnp.eye(k, dtype=dtype)
    lamt = jnp.asarray(lam, dtype)

    def one(args):
        A, r = args
        Ainv, _ = inv_logdet(A + lamt * eye)
        return mm_hp(Ainv, r[..., None])[..., 0]

    rows = solve_rows(k)
    if B <= rows:
        return one((S_sq, rhs))
    nb = -(-B // rows)
    pad = nb * rows - B
    if pad:
        # identity-padded rows solve (1 + lam) x = 0 -> 0; dropped below
        S_sq = jnp.concatenate([S_sq, jnp.broadcast_to(eye, (pad, k, k))])
        rhs = jnp.concatenate([rhs, jnp.zeros((pad, k), rhs.dtype)])
    out = lax.map(one, (S_sq.reshape(nb, rows, k, k), rhs.reshape(nb, rows, k)))
    return out.reshape(nb * rows, k)[:B]


def inv_logdet(
    M: jax.Array,
    *,
    base: Optional[int] = None,
    base_fn: Optional[Callable] = None,
):
    """Batched SPD inverse + log-determinant, (B, k, k) -> ((B, k, k), (B,)).

    ``base_fn`` overrides the base case (tests; default batched Cholesky)
    and ``base`` the base-case size (module BASE).
    """
    return _inv_logdet(M, base_fn or base_inv_logdet_xla, base or BASE)
