"""Global configuration knobs for ppca_rs_tpu.

The reference library (viodotcom/ppca_rs) has no config system — everything is
plain function arguments (see SURVEY.md §5).  We keep that philosophy: the only
things configured here are accelerator-performance knobs that have no
counterpart in the reference API and sensible defaults everywhere.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional


@dataclasses.dataclass
class Config:
    #: Number of samples processed per scan step inside the blocked EM/llk
    #: reductions.  Bounds peak memory of the (block, D) and (block, k*k)
    #: temporaries.  Must be a power of two.
    block_size: int = 8192

    #: jax.lax matmul precision for the hot contractions.  "auto" (default)
    #: picks "default" matmuls when the output dimension is >= 512 and full
    #: f32 "highest" below.  On an NVIDIA GPU "default" runs f32 matmuls in
    #: TF32.  The error is dominated by cancellation in the llk quadratic
    #: form near convergence (quad = |r|^2 - b^T M^-1 b, a small difference
    #: of large terms): measured same-model llk deviation of "auto" from
    #: "highest" for a 10-iteration model at D=1024, k=64, N=1M, 50% missing
    #: on an H100 80GB HBM3 (400 W power limit): 3.2e-5 and 9.6e-5 relative
    #: in two runs.  EM *convergence* is unaffected either way (the M-step
    #: is a fixed-point ratio of weighted sums) — only reported
    #: llk/posterior values degrade.  Set "default"/"high"/"highest" to
    #: force; CPU f64 runs are unaffected.
    matmul_precision: str = "auto"

    #: Use the fused Pallas E-step kernel (ops/kernels.py) where the router
    #: sends work to it (masked_linalg.spd_route: a GPU, f32, k <=
    #: kernels.MAX_K); False keeps every factorization on XLA.
    use_pallas: bool = True

    #: Use the native C++ host-side packing extension when available.
    use_native: bool = True

    #: Compute the fused mixture EM's per-component residual norms from a
    #: materialized (M, block, D) residual instead of the expanded
    #: quadratic |md0|^2 - 2 md0.dm + mask.dm^2.  The expanded form's f32
    #: cancellation error grows ~O(mean_separation^2 / sigma^2) relative
    #: (measured dev_sq ~7e-4 and llk ~1.6e-4 rel vs f64 at separation 300
    #: with residual 0.5); the materialized form is immune but costs the
    #: (M, block, D) temporary the fast path exists to avoid.  Leave False
    #: unless component means are separated by >> 100x the noise scale and
    #: exact llk/noise values matter more than EM speed (EM *convergence* is
    #: unaffected either way).
    mix_exact_rnorm: bool = False

    #: Build the pattern paths' per-sample outer products s s^T only on the
    #: lower block-wedge em_finalize reads (masked_linalg._sm_slabs): ~0.55x
    #: the outer-product work and temporary at k=64.  Numerics are exactly
    #: the tril + tril^T semantics either way.
    s_slab_stats: bool = True

    #: For state sizes past the kernel's ceiling (kernels.MAX_K): route the
    #: factorization through the blocked Schur-complement inverse
    #: (ops/block_spd.py) instead of XLA's batched Cholesky.  The default is
    #: the faster of the two at k=384 on an H100 (docs/DESIGN.md §2).
    use_blocked_large_k: bool = True

    #: Mask-pattern deduplication: when a dataset has P distinct mask
    #: patterns with P << N (structured missingness), per-sample
    #: factorizations collapse to a P-sized table (ops/pattern_dedup.py).
    use_pattern_dedup: bool = True

    #: Pattern-path E-step restructure (ops/pattern_dedup.py): (a) compute
    #: the posterior states via ONE (B, k) x (k, P*k) matmul against the
    #: whole Sigma table + a per-row gather instead of gathering a (B, k^2)
    #: per-sample Sigma (the gather materializes 16 KB/sample of device
    #: memory traffic each way at k=64); engages
    #: when P * k is small enough that the (B, P, k) candidate temporary
    #: beats the gather.  (b) accumulate the mean-update correction
    #: pattern-grouped: mask^T (s w) == patterns^T (onehot^T (s w)), an
    #: exact sum reordering that removes a (D, B) x (B, k) matmul and a
    #: full mask re-read per block.  Both are algebraically exact.
    #: Opt out with PPCA_RS_TPU_NO_PAT_GROUPED.
    pat_grouped_estep: bool = True

    #: Sorted-segment pattern EM (ops/pattern_dedup.em_stats_sorted): rows
    #: are grouped by mask pattern ONCE per dataset (host argsort of the
    #: detected pattern index; the sorted data copy is cached on the
    #: Dataset), so each segment's mask is a CONSTANT row and the e-step
    #: runs per-segment matmuls: states cost 2k^2 flops/sample instead of
    #: the candidates matmul's 2Pk^2, and the per-pattern outer-product
    #: statistic is a plain segment Gram (2k^2) instead of the one-hot
    #: contraction (2*q*P).  Costs: one sorted data copy in device memory
    #: (gated by pat_sorted_max_bytes) and a retrace per dataset (segment
    #: offsets are compile-time constants).  Opt out with
    #: PPCA_RS_TPU_NO_PAT_SORTED.
    pat_sorted_estep: bool = True

    #: Do not build the sorted-by-pattern data copy past this size (it
    #: doubles the dataset's device footprint while training).  None: a
    #: quarter of the device's memory (see :meth:`sorted_copy_bytes`).
    pat_sorted_max_bytes: Optional[int] = None

    #: Upper bound on P for the sorted-segment path: each pattern adds an
    #: unrolled segment scan to the compiled EM step, so very fragmented
    #: masks would bloat the program for shrinking per-segment wins.
    pat_sorted_max_p: int = 256

    #: Require N / P >= this many rows per segment (on average) before the
    #: sorted path engages.  Tiny segments lose twice: per-segment matmuls
    #: stop amortizing, and the O(P)-segment unrolled program explodes
    #: compile size (a ~200-pattern/2000-row random-mask dataset produced a
    #: program big enough to SEGFAULT the XLA:CPU compiler under suite
    #: memory pressure).  Below the gate the grouped pattern path
    #: (pat_grouped_estep) carries the workload.
    pat_sorted_min_rows: int = 512

    #: Upper bound on P for the dedup path (table memory is P * k^2 and the
    #: final assembly is a (D, P) contraction).
    pattern_max: int = 4096

    #: Require P * pattern_min_ratio <= N before switching to the dedup path
    #: (below that the general masked path wins).
    pattern_min_ratio: int = 4

    def sorted_copy_bytes(self) -> int:
        """The sorted-copy size limit in force (pat_sorted_max_bytes)."""
        if self.pat_sorted_max_bytes is not None:
            return self.pat_sorted_max_bytes
        return device_bytes() // 4


@functools.lru_cache(maxsize=None)
def device_bytes() -> int:
    """Memory JAX may allocate on the default device (its
    ``memory_stats()["bytes_limit"]``), or 16 GiB where the backend does not
    report one (the CPU).  The memory bounds derived from it keep their
    proportions on every device."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("bytes_limit", 16 << 30))


config = Config()

def _env_flag(name: str) -> bool:
    """True when the env var is set to anything but an explicit falsey value
    ("", "0", "false", "no", "off" — case-insensitive). Guards the NO_*
    opt-outs against the double-negative foot-gun NO_X=0 reading as opt-out."""
    return os.environ.get(name, "").strip().lower() not in ("", "0", "false", "no", "off")


if _env_flag("PPCA_RS_TPU_NO_PALLAS"):
    config.use_pallas = False
if _env_flag("PPCA_RS_TPU_NO_NATIVE"):
    config.use_native = False
if _env_flag("PPCA_RS_TPU_NO_BLOCKED_LARGE_K"):
    config.use_blocked_large_k = False
if _env_flag("PPCA_RS_TPU_NO_S_SLAB_STATS"):
    config.s_slab_stats = False
if _env_flag("PPCA_RS_TPU_NO_PAT_GROUPED"):
    config.pat_grouped_estep = False
if _env_flag("PPCA_RS_TPU_PAT_SORTED"):
    config.pat_sorted_estep = True
if _env_flag("PPCA_RS_TPU_NO_PAT_SORTED"):
    config.pat_sorted_estep = False
if _env_flag("PPCA_RS_TPU_MIX_EXACT_RNORM"):
    config.mix_exact_rnorm = True
if os.environ.get("PPCA_RS_TPU_MATMUL_PRECISION"):
    config.matmul_precision = os.environ["PPCA_RS_TPU_MATMUL_PRECISION"]


def block_size_for(n: int, k: int = 0, m: int = 1) -> int:
    """Pick the scan block size for an N-sample reduction: the configured block
    size, shrunk to the smallest power of two >= n for small inputs so tiny
    datasets don't pay for an 8k-row pad.

    When the state size ``k`` is given and exceeds the fused kernel's
    ceiling (kernels.MAX_K: the blocked or XLA large-k regime), the block is
    also shrunk so the ~4 live (m * block, k, k) f32 temporaries (M,
    M^{-1}, Sigma, SM) stay within an eighth of the device's memory (2 GiB
    of 16 GiB) — at k = 512 an 8192-row block would otherwise hold 8 GiB
    PER temporary.  Mixtures pass ``m`` = number of components: their
    per-block problems stack all M components, so the bound must count
    M * block rows."""
    b = config.block_size
    if k:
        from .ops import kernels  # lazy: config must import before ops

        if k > kernels.MAX_K:
            limit = device_bytes() // 8
            while b > 128 and max(1, m) * b * k * k * 16 > limit:
                b //= 2
    while b >= 2 * max(n, 1):
        b //= 2
    return max(b, 8)
