"""Masked dataset container.

Dense-array twin of the reference's ``MaskedSample``/``Dataset``
(`ppca/src/dataset.rs`): instead of a ragged ``Vec<MaskedSample>`` of
bitvec-masked vectors, we hold one dense zero-filled ``(N, D)`` value array,
an ``(N, D)`` boolean mask (True = observed, matching the bit-set convention
at `ppca/src/dataset.rs:10-22`) and an ``(N,)`` per-sample weight vector
(default 1.0, `dataset.rs:93-100`).  Fixed dense shapes are what XLA needs to
tile the EM onto large matmuls.

API parity with the Python bindings (`src/python_bindings.rs:28-166`):
``Dataset(ndarray, weights=None)`` masks non-finite entries, ``numpy()``
round-trips with NaN fill, ``dump``/``load``, ``__len__``, ``output_size``,
``empty_dimensions``, ``weights``, ``chunks(n)`` -> ``DatasetChunks``, and
static ``concat``.
"""

from __future__ import annotations

import functools
from typing import Iterator, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .utils.serialization import dump_bytes, load_bytes
from .native import packing as _packing


@jax.jit
def _n_incomplete_rows(mask):
    """Number of rows with at least one masked entry — the all_observed
    probe.  Row-counted (<= N, int32-exact) because an observed-ENTRY count
    wraps int32 at N*D >= 2^31; jitted so no (N, D) temporary materializes
    and sharded/global masks reduce in place."""
    return jnp.sum(jnp.any(~mask, axis=1), dtype=jnp.int32)


@jax.jit
def _any_over_rows(mask):
    """Per-dimension any() over samples (the empty_dimensions reduction).
    Module-level jit: a per-call ``jax.jit(partial(...))`` would defeat the
    trace cache and pay a (remote) compile on every invocation."""
    return jnp.any(mask, axis=0)


@functools.lru_cache(maxsize=16)
def _hash_powers(d: int) -> np.ndarray:
    """(d, 2) int32 matrix of [m^(d-1), ..., m, 1] mod 2^32 (wrapped to
    two's-complement) for two independent multipliers."""
    cols = []
    for m in (0x9E3779B9, 0x85EBCA6B):
        p = [pow(m, d - 1 - j, 1 << 32) for j in range(d)]
        cols.append([x - (1 << 32) if x >= (1 << 31) else x for x in p])
    return np.asarray(cols, dtype=np.int32).T


#: Rows hashed per map step: bounds the per-chunk packbits/int32
#: temporaries to ~768 MB at D=1024.  An unchunked version cast the whole
#: (N, D) mask at once — a 16 GB int32 transient at N=4M that OOM'd the
#: chip right at the dataset's HBM high-water mark.
_HASH_CHUNK = 1 << 19


def _row_hashes(mask):
    """Two independent 32-bit polynomial hashes of each mask row — so pattern
    detection ships 8 bytes per row to the host instead of D bits.

    Each chunk of rows is packed to bytes (8x smaller) and the polynomial
    fold h = ((b_0 m + b_1) m + ...) over the bytes is evaluated as an s32
    matmul sum_j b_j m^(L-1-j): s32 dot wraps mod 2^32 exactly like the
    fold (verified against a numpy u64 reference), and the matmul program
    compiles in <1 s where a per-step lax.scan took ~9 s and a device
    sort-based ranking ~30 s through the remote-compile path.  The
    packbits/cast temporaries live only per ``_HASH_CHUNK`` rows, so the
    program's footprint is bounded regardless of N."""
    powers = jnp.asarray(_hash_powers(-(-mask.shape[1] // 8)))

    def chunk(mb):
        return jnp.packbits(mb, axis=1).astype(jnp.int32) @ powers

    n = mask.shape[0]
    if n <= _HASH_CHUNK:
        return chunk(mask)
    nb = -(-n // _HASH_CHUNK)
    pad = nb * _HASH_CHUNK - n
    if pad:
        mask = jnp.pad(mask, ((0, pad), (0, 0)))
    out = lax.map(chunk, mask.reshape(nb, _HASH_CHUNK, -1))
    return out.reshape(nb * _HASH_CHUNK, 2)[:n]


_row_hashes_jit = jax.jit(_row_hashes)


def _combine_hashes(h: np.ndarray) -> np.ndarray:
    """(N, 2) int32 -> (N,) uint64 for host-side unique."""
    u = np.ascontiguousarray(h).view(np.uint32)
    return (u[:, 0].astype(np.uint64) << np.uint64(32)) | u[:, 1].astype(np.uint64)


def _pattern_counts(pidx, mask, *, P):
    """Per-(hash-group, column) observed counts and group sizes, blocked
    over rows so the one-hot temporary stays bounded.

    The matmul is exact: 0/1 inputs and each block's f32 accumulation is an
    integer <= the block size <= 2^24 (every such integer is f32-exact);
    blocks are summed in int32.  Rows of
    the final (clamped) block that earlier blocks already counted are routed
    to a scratch group P that is dropped on return.  The block size bounds
    BOTH f32 temporaries — the (step, P+1) one-hot and the (step, d) cast
    mask — at ~256 MB (P can reach config.pattern_max=4096, where a 2^20
    block's one-hot alone would be 16 GB)."""
    n, d = mask.shape
    # <= 2^24 keeps every per-block f32 count exactly representable even
    # when tiny D/P would let the memory bound admit 2^25-row blocks.
    step = min(n, 1 << 24, max(8192, (1 << 26) // max(d, P + 1)))
    nb = -(-n // step)
    starts = jnp.arange(nb, dtype=jnp.int32) * step
    iota = jnp.arange(step, dtype=jnp.int32)

    def body(carry, start):
        actual = jnp.minimum(start, n - step)  # dynamic_slice clamps likewise
        pb = lax.dynamic_slice(pidx, (actual,), (step,))
        mb = lax.dynamic_slice_in_dim(mask, actual, step, 0)
        pb = jnp.where(iota >= start - actual, pb, P)  # already-counted rows
        ob = jax.nn.one_hot(pb, P + 1, dtype=jnp.float32)
        c = lax.dot_general(ob, mb.astype(jnp.float32), (((0,), (0,)), ((), ())))
        s = jnp.sum(ob, axis=0)
        return (carry[0] + c.astype(jnp.int32), carry[1] + s.astype(jnp.int32)), None

    zero = (jnp.zeros((P + 1, d), jnp.int32), jnp.zeros((P + 1,), jnp.int32))
    (cnt, sz), _ = lax.scan(body, zero, starts)
    return cnt[:P], sz[:P]


_pattern_counts_jit = jax.jit(_pattern_counts, static_argnames=("P",))

# row gather for pattern_order's sorted copy (jitted so the (N, D) result
# is a single device program, not an eager dispatch per use)
_take_rows_jit = jax.jit(lambda a, idx: jnp.take(a, idx, axis=0))


class _WeightsView(np.ndarray):
    """numpy view of the dataset weights that is ALSO callable, so both
    spellings work: ``ds.weights`` (array-style attribute) and
    ``ds.weights()`` (the reference's method spelling,
    `src/python_bindings.rs:106-108`)."""

    def __call__(self) -> np.ndarray:
        return np.asarray(self)


class Dataset:
    """A dense masked dataset: values (zero-filled where masked), an
    observed-mask and per-sample weights, all device arrays.

    ``weights`` is exposed as a callable numpy view (both ``ds.weights`` and
    the reference's ``ds.weights()`` work); the device-resident weight vector
    used by the compute paths is ``weights_dev``."""

    __slots__ = ("data", "mask", "weights_dev", "_n_real", "_all_observed",
                 "_patterns", "_pattern_order", "_pattern_order_sharded")

    def __init__(self, ndarray=None, weights=None, *, _parts=None):
        self._all_observed = None
        self._patterns = None
        self._pattern_order = None
        self._pattern_order_sharded = None
        if _parts is not None:
            self.data, self.mask, self.weights_dev = _parts[:3]
            self._n_real = _parts[3] if len(_parts) > 3 else None
            return
        self._n_real = None
        if ndarray is None:
            raise TypeError("Dataset() requires an (N, D) array")
        arr = np.asarray(ndarray, dtype=np.float64)
        if arr.ndim != 2:
            raise ValueError(f"expected a 2D (N, D) array, got shape {arr.shape}")
        # Non-finite entries (NaN/inf) are masked out, mirroring
        # MaskedSample::mask_non_finite (ppca/src/dataset.rs:19-22).
        filled, mask = _packing.mask_non_finite(arr)
        self.data = jnp.asarray(filled)
        self.mask = jnp.asarray(mask)
        if weights is not None:
            w = np.asarray(weights, dtype=np.float64).reshape(-1)
            if w.shape[0] != arr.shape[0]:
                raise ValueError("weights length must match number of samples")
            self.weights_dev = jnp.asarray(w, dtype=self.data.dtype)
        else:
            self.weights_dev = jnp.ones((arr.shape[0],), dtype=self.data.dtype)

    # ------------------------------------------------------------------ #
    # constructors

    @classmethod
    def from_parts(cls, data, mask, weights=None, n_real=None) -> "Dataset":
        """Build from already-prepared device arrays (data must be zero-filled
        at masked entries).  ``n_real`` marks the logical length when the
        arrays carry neutral padding rows (used by the sharding layer: padding
        rows are all-masked and zero-weight, hence invisible in every
        reduction)."""
        data = jnp.asarray(data)
        mask = jnp.asarray(mask, dtype=bool)
        wdtype = jnp.promote_types(data.dtype, jnp.float32)  # never bf16 weights
        if weights is None:
            weights = jnp.ones((data.shape[0],), dtype=wdtype)
        else:
            weights = jnp.asarray(weights, dtype=wdtype)
        return cls(_parts=(data, mask, weights, n_real))

    @classmethod
    def unmasked(cls, data, weights=None) -> "Dataset":
        """Fully-observed dataset (MaskedSample::unmasked, dataset.rs:29-35)."""
        data = jnp.asarray(data)
        return cls.from_parts(data, jnp.ones(data.shape, dtype=bool), weights)

    def astype(self, dtype) -> "Dataset":
        """Cast the value storage (e.g. to jnp.bfloat16 to halve HBM per
        sample — all math still runs in f32; see ops.masked_linalg
        compute_dtype).  Mask and weights are unchanged."""
        new = Dataset.from_parts(
            self.data.astype(dtype), self.mask, self.weights_dev, n_real=self._n_real
        )
        new._all_observed = self._all_observed
        new._patterns = self._patterns
        return new

    def with_weights(self, weights) -> "Dataset":
        """Same data, new weights — the cheap reweighting hook the mixture EM
        uses (`dataset.rs:169-176`; data arrays are shared, not copied)."""
        w = jnp.asarray(weights, dtype=self.weights_dev.dtype)
        if w.shape[0] != self.padded_len:
            if w.shape[0] != len(self):
                raise ValueError("weights length must match number of samples")
            w = jnp.pad(w, (0, self.padded_len - len(self)))
            w = jax.device_put(w, self.weights_dev.sharding)
        new = Dataset.from_parts(self.data, self.mask, w, n_real=self._n_real)
        new._all_observed = self._all_observed  # same mask, same observedness
        new._patterns = self._patterns          # same mask, same patterns
        new._pattern_order = self._pattern_order  # same data; weights are
        # re-sorted per call by the consumers (see pattern_order docstring)
        new._pattern_order_sharded = self._pattern_order_sharded
        return new

    # ------------------------------------------------------------------ #
    # basic accessors

    def __len__(self) -> int:
        if self._n_real is not None:
            return self._n_real
        return int(self.data.shape[0])

    @property
    def weights(self) -> "_WeightsView":
        """Per-sample weights as numpy (real rows only).  Callable for
        drop-in parity with the reference's ``weights()`` method.  Read-only:
        each access materializes a fresh copy from the device array, so
        in-place writes would be silently discarded — use ``with_weights``."""
        view = self.weights_numpy().view(_WeightsView)
        view.setflags(write=False)
        return view

    @property
    def padded_len(self) -> int:
        """Physical length including neutral padding rows."""
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def is_empty(self) -> bool:
        return len(self) == 0

    def output_size(self) -> Optional[int]:
        """Number of output dimensions, or None for the empty dataset
        (`dataset.rs:183-191`)."""
        if self.is_empty():
            return None
        return int(self.data.shape[1])

    def all_observed(self) -> bool:
        """True when every (real) entry is observed — unlocks the dense
        fully-observed fast path (ops/dense_fast.py).  Counted over the
        padded mask so sharded arrays need no gather: padding rows are
        all-masked, so the count matches exactly iff all real entries are
        observed.  Cached after the first call."""
        if self._all_observed is None:
            if self.is_empty():
                self._all_observed = True
            else:
                # Counted as not-fully-observed ROWS (bounded by N, exact in
                # int32) rather than observed ENTRIES: an entry count
                # overflows int32 at N*D >= 2^31 — e.g. N=4M, D=1024 — and
                # would silently skip the dense fast path.  Padding rows are
                # all-masked, so they count as exactly padded_len - len.
                bad = int(_n_incomplete_rows(self.mask))
                self._all_observed = bad == self.padded_len - len(self)
        return self._all_observed

    def pattern_info(self, include_dense: bool = False):
        """Distinct-mask-pattern table for the dedup fast path
        (ops/pattern_dedup.py), or ``None`` when it would not pay off.

        Returns ``(pattern_idx (N,) int32, patterns (P, D) bool)`` device
        arrays with ``mask[n] == patterns[pattern_idx[n]]``.

        Detection minimizes host traffic: rows are reduced on-device to a
        pair of independent 32-bit polynomial hashes (one exact s32 matmul —
        8 bytes per row leave the device instead of D bits), the hashes are
        uniqued on the host, and the resulting assignment is then verified
        EXACTLY on-device (per-group per-column observed counts via a
        one-hot matmul must all be 0 or the group size, which also yields
        the pattern table itself) — a hash collision can therefore never
        mis-group rows, it only demotes the dataset to the general path.
        Unstructured (all-rows-distinct) masks only
        ever pay for a 64k-row prefix sample of the hashes, which already
        proves the pattern count over the cap.  The result is cached;
        ``with_weights``
        and ``astype`` share the cache (same mask).  The config gate is
        re-checked on every call, so toggling ``config.use_pattern_dedup``
        takes effect even for datasets with already-cached patterns.

        ``include_dense=True`` (the mixture path) also returns the trivial
        single-pattern table for fully-observed data — the single-model path
        leaves that case to its dedicated dense code (ops/dense_fast.py)."""
        from .config import config

        if not config.use_pattern_dedup:
            return None
        if self._patterns is not None:
            return self._patterns or None  # False => checked, not profitable
        n = self.padded_len
        if self.is_empty() or n < 2 * config.pattern_min_ratio:
            self._patterns = False
            return None
        # Multi-PROCESS arrays need the explicit COLLECTIVE entry point
        # `detect_patterns()` — pattern_info is a host-local lazy call that
        # other processes may reach at different times, so it cannot launch
        # collectives (this guard must run BEFORE the all_observed() probe
        # below, which is itself a device reduction over the global mask);
        # without a prior detect_patterns() a multi-host dataset takes the
        # general path (correct, just without the dedup speedup).  NOT
        # cached: a cached False would make a LATER (documented)
        # detect_patterns() call a silent no-op — the demotion must stay
        # re-checkable.
        if jax.process_count() > 1:
            return None
        if self.all_observed():
            if include_dense:
                if len(self.mask.sharding.device_set) > 1:
                    # Column (model-axis) sharding keeps the general path,
                    # exactly like the non-dense branch below — the *_pat
                    # verbs have no model-axis collectives.  NOT cached
                    # (the sharding, not the mask, is what demoted us).
                    shard_shape = self.mask.sharding.shard_shape(self.mask.shape)
                    if shard_shape[1] != self.mask.shape[1]:
                        return None
                pidx = jnp.zeros((n,), jnp.int32)
                pats = jnp.ones((1, int(self.data.shape[1])), bool)
                if len(self.mask.sharding.device_set) > 1:
                    # pin shardings so the table mixes with the sharded
                    # data downstream (same as detect_patterns' branch)
                    from jax.sharding import NamedSharding, PartitionSpec

                    pidx = jax.device_put(pidx, self.weights_dev.sharding)
                    pats = jax.device_put(
                        pats,
                        NamedSharding(
                            self.mask.sharding.mesh, PartitionSpec(None, None)
                        ),
                    )
                self._patterns = (pidx, pats)
                return self._patterns
            return None  # uncached: a later include_dense call may want it
        # Data-axis sharding is supported: the hash/verify programs run
        # distributed, pidx is placed with the row sharding and the pattern
        # table is replicated.  Column (model-axis) sharding keeps the
        # general path (tables would need a D-psum).
        sharded = len(self.mask.sharding.device_set) > 1
        mesh = None
        if sharded:
            shard_shape = self.mask.sharding.shard_shape(self.mask.shape)
            if shard_shape[1] != self.mask.shape[1]:
                self._patterns = False
                return None
            mesh = self.mask.sharding.mesh
        self._detect(mesh)
        return self._patterns or None

    def detect_patterns(self, include_dense: bool = False):
        """Explicitly run pattern detection now; REQUIRED for multi-process
        (`jax.distributed`) datasets, optional (equivalent to
        :meth:`pattern_info`) everywhere else.

        The detection programs are collectives over the global mask, so in a
        multi-process job EVERY process must call this at the same point
        (before training starts); the grouping is then cached and later
        ``pattern_info()`` calls are host-local, which lets the ``*_pat``
        fast-path verbs engage exactly as in the single-process case.
        Returns ``(pattern_idx, patterns)`` or ``None`` like
        :meth:`pattern_info`."""
        from .config import config

        if jax.process_count() <= 1:
            return self.pattern_info(include_dense=include_dense)
        if not config.use_pattern_dedup:
            return None
        if self._patterns is not None:
            return self._patterns or None
        n = self.padded_len
        if self.is_empty() or n < 2 * config.pattern_min_ratio:
            self._patterns = False
            return None
        # all_observed() is jitted, so its reduction is legal on a
        # non-fully-addressable global array too.
        if self.all_observed():
            if include_dense:
                from jax.sharding import NamedSharding, PartitionSpec

                mesh = self.mask.sharding.mesh
                # pin shardings: plain jnp arrays would be process-local and
                # could not mix with the global data downstream
                self._patterns = (
                    jax.device_put(
                        np.zeros((n,), np.int32), self.weights_dev.sharding
                    ),
                    jax.device_put(
                        np.ones((1, int(self.data.shape[1])), bool),
                        NamedSharding(mesh, PartitionSpec(None, None)),
                    ),
                )
                return self._patterns
            return None
        shard_shape = self.mask.sharding.shard_shape(self.mask.shape)
        if shard_shape[1] != self.mask.shape[1]:
            self._patterns = False
            return None
        self._detect(self.mask.sharding.mesh)
        return self._patterns or None

    def _detect(self, mesh):
        """Shared detection body.  ``mesh`` is None for plain single-device
        data; otherwise the rows' NamedSharding mesh (single- OR
        multi-process), and every device program pins replicated/row-sharded
        output shardings so the host-side steps below see fully-addressable
        arrays in either case."""
        from .config import config

        n = self.padded_len
        p_cap = min(config.pattern_max, n // config.pattern_min_ratio)
        # Cheap pre-check on a 64k-row prefix (hash program on the prefix
        # only; 512 KB host transfer): unstructured data (all rows
        # distinct) must demote without paying the full-N hash + transfer +
        # unique — a fresh Dataset's first EM iteration would otherwise eat
        # ~0.5 s of detection for nothing (this regressed bench.py by 19%
        # when dropped).
        sample_cap = 131072
        if mesh is None:
            if n > sample_cap:
                head = np.asarray(_row_hashes_jit(self.mask[: sample_cap // 2]))
                if len(np.unique(_combine_hashes(head))) > p_cap:
                    self._patterns = False
                    return
            h = _row_hashes_jit(self.mask)
        else:
            # (sharded: slicing a row-sharded / multi-process mask is not
            # generally addressable, so pre-check on the replicated hash
            # OUTPUT instead — the full hash program is cheap; it is the
            # host-side full-N unique this avoids for unstructured data)
            from jax.sharding import NamedSharding, PartitionSpec

            rep2 = NamedSharding(mesh, PartitionSpec(None, None))
            h = jax.jit(_row_hashes, out_shardings=rep2)(self.mask)
            if n > sample_cap:
                head = np.asarray(h[: sample_cap // 2])
                if len(np.unique(_combine_hashes(head))) > p_cap:
                    self._patterns = False
                    return
        # Host-side unique of the (N, 2) hashes: 8 MB off-device at N=1M
        # plus np.unique — cheaper than ranking on device, whose sort
        # program adds a large one-time compile.
        h64 = _combine_hashes(np.asarray(h))
        uniq, inverse = np.unique(h64, return_inverse=True)
        P = len(uniq)
        if P > p_cap:
            self._patterns = False
            return
        inverse = np.ascontiguousarray(inverse.astype(np.int32))
        # Exact verification (defends against hash collisions) AND pattern
        # table extraction in one device pass (_pattern_counts): a group is
        # internally consistent iff every column's count is 0 or the group
        # size, and the pattern table is then exactly `count == size`.
        if mesh is None:
            pidx = jnp.asarray(inverse)
            cnt, sz = _pattern_counts_jit(pidx, self.mask, P=P)
        else:
            from jax.sharding import NamedSharding, PartitionSpec

            row_sh = self.weights_dev.sharding
            pidx = jax.make_array_from_callback(
                (n,), row_sh, lambda idx: inverse[idx]
            )
            cnt, sz = jax.jit(
                functools.partial(_pattern_counts, P=P),
                out_shardings=(
                    NamedSharding(mesh, PartitionSpec(None, None)),
                    NamedSharding(mesh, PartitionSpec(None)),
                ),
            )(pidx, self.mask)
        cnt_h = np.asarray(cnt)                      # the ONE host sync
        sz_h = np.asarray(sz)[:, None]
        if not bool(((cnt_h == 0) | (cnt_h == sz_h)).all()):
            # collision (~2^-64 per pattern pair): demote to the general path
            self._patterns = False
            return
        patterns = cnt_h == sz_h
        if mesh is None:
            patterns = jnp.asarray(patterns)
        else:
            from jax.sharding import NamedSharding, PartitionSpec

            patterns = jax.device_put(
                patterns, NamedSharding(mesh, PartitionSpec(None, None))
            )
        self._patterns = (pidx, patterns)

    def pattern_order(self):
        """Sorted-by-pattern view for the segment EM fast path
        (ops/pattern_dedup.em_stats_sorted), or ``None`` when it does not
        apply.  Returns ``(data_sorted, perm, counts)``:

        * ``data_sorted`` — the data rows stably reordered so each
          pattern's rows are contiguous (a cached device copy; it DOUBLES
          the dataset's data footprint in device memory while alive, which is why
          ``config.pat_sorted_max_bytes`` gates it);
        * ``perm`` — the (N,) int32 permutation (``data_sorted = data[perm]``;
          consumers sort per-call quantities like weights with it, so
          ``with_weights`` twins share this cache safely);
        * ``counts`` — host tuple of per-pattern row counts (segment ``p``
          is rows ``[sum(counts[:p]), +counts[p])``).  These are
          compile-time constants: a dataset with a different pattern
          layout retraces the EM program (~seconds; the segment slicing
          is what buys the flop win).

        Applies only to plain single-device datasets with detected
        patterns (sharded/multi-process data keeps the table-grouped
        path) and only while ``config.pat_sorted_estep`` is on."""
        from .config import config

        if not (config.use_pattern_dedup and config.pat_sorted_estep):
            return None
        if self._pattern_order is not None:
            return self._pattern_order or None
        info = self.pattern_info()
        if info is None:
            self._pattern_order = False
            return None
        if (jax.process_count() > 1
                or len(self.mask.sharding.device_set) > 1
                or len(self.data.sharding.device_set) > 1):
            # sharded rows: segments would straddle shard boundaries
            return None  # uncached — mirrors pattern_info's demotion rules
        pidx, patterns = info
        P = int(patterns.shape[0])
        if P > config.pat_sorted_max_p:
            self._pattern_order = False
            return None
        if len(self) < P * config.pat_sorted_min_rows:
            # fragmented masks: tiny segments stop amortizing and the
            # O(P)-segment unrolled program bloats compile (see config)
            self._pattern_order = False
            return None
        if self.data.nbytes > config.sorted_copy_bytes():
            self._pattern_order = False
            return None
        pidx_h = np.asarray(pidx)
        perm_h = np.argsort(pidx_h, kind="stable").astype(np.int32)
        counts = tuple(int(c) for c in np.bincount(pidx_h, minlength=P))
        perm = jnp.asarray(perm_h)
        data_sorted = _take_rows_jit(self.data, perm)
        self._pattern_order = (data_sorted, perm, counts)
        return self._pattern_order

    def pattern_order_sharded(self):
        """Balanced sorted-by-pattern view for DATA-AXIS-SHARDED datasets —
        the shard_map twin of :meth:`pattern_order`.  Returns
        ``(data_sorted, perm, valid, counts_local)`` or ``None``.

        shard_map is SPMD: every shard runs the SAME compiled program, so
        per-shard segment offsets must be identical compile-time constants.
        Each pattern's rows are therefore ceil-padded to a multiple of the
        data-axis size S and dealt contiguously across shards — shard ``s``
        holds, for every pattern ``p``, rows ``idx_p[s*c_p:(s+1)*c_p]``
        with ``c_p = ceil(count_p / S)``, so ``counts_local = (c_0..c_P)``
        is the same static tuple on every shard.  Padding slots duplicate
        the pattern's first row with ``valid = 0``; every EM statistic is
        weight-linear, so zero-weight duplicates are exactly neutral (the
        same invariant that makes the sharding layer's all-masked padding
        rows inert).  ``perm``/``valid`` are (S*L,) device arrays sharded
        over rows; consumers build per-call sorted weights as
        ``take(weights, perm) * valid``.

        Applies to single-process datasets sharded over the data axis only
        (model-axis sharding keeps the general path: segment constants span
        full D rows), while ``config.pat_sorted_estep`` is on."""
        from .config import config

        if not (config.use_pattern_dedup and config.pat_sorted_estep):
            return None
        if jax.process_count() > 1:
            # host argsort needs every row's pattern index; multi-process
            # arrays are not fully addressable — keep the grouped path.
            return None
        if self._pattern_order_sharded is not None:
            return self._pattern_order_sharded or None
        from .parallel.mesh import DATA_AXIS, MODEL_AXIS, dataset_mesh

        mesh = dataset_mesh(self)
        if (mesh is None or DATA_AXIS not in mesh.axis_names
                or (MODEL_AXIS in mesh.axis_names
                    and mesh.shape[MODEL_AXIS] > 1)):
            self._pattern_order_sharded = False
            return None
        info = self.pattern_info()
        if info is None:
            self._pattern_order_sharded = False
            return None
        pidx, patterns = info
        P = int(patterns.shape[0])
        S = int(mesh.shape[DATA_AXIS])
        if P > config.pat_sorted_max_p:
            self._pattern_order_sharded = False
            return None
        if len(self) < P * config.pat_sorted_min_rows:
            self._pattern_order_sharded = False
            return None
        if self.data.nbytes > config.sorted_copy_bytes():
            self._pattern_order_sharded = False
            return None
        pidx_h = np.asarray(pidx)
        order = np.argsort(pidx_h, kind="stable").astype(np.int32)
        counts = np.bincount(pidx_h, minlength=P)
        starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        c_loc = -(-counts // S)                       # ceil(count_p / S)
        L = int(c_loc.sum())
        offs = np.concatenate(([0], np.cumsum(c_loc)[:-1]))
        perm_h = np.zeros((S, L), np.int32)
        valid_h = np.zeros((S, L), np.float32)
        for p in range(P):
            c, n_p = int(c_loc[p]), int(counts[p])
            if c == 0:
                continue
            idx_p = order[starts[p]:starts[p] + n_p]
            pad = S * c - n_p
            perm_h[:, offs[p]:offs[p] + c] = np.concatenate(
                (idx_p, np.full(pad, idx_p[0], np.int32))).reshape(S, c)
            valid_h[:, offs[p]:offs[p] + c] = np.concatenate(
                (np.ones(n_p, np.float32),
                 np.zeros(pad, np.float32))).reshape(S, c)
        from jax.sharding import NamedSharding, PartitionSpec

        row_sh = NamedSharding(mesh, PartitionSpec(DATA_AXIS, None))
        vec_sh = NamedSharding(mesh, PartitionSpec(DATA_AXIS))
        perm = jax.device_put(jnp.asarray(perm_h.reshape(-1)), vec_sh)
        valid = jax.device_put(jnp.asarray(valid_h.reshape(-1)), vec_sh)
        data_sorted = jax.jit(
            lambda d, p: jnp.take(d, p, axis=0), out_shardings=row_sh
        )(self.data, perm)
        counts_local = tuple(int(c) for c in c_loc)
        self._pattern_order_sharded = (data_sorted, perm, valid, counts_local)
        return self._pattern_order_sharded

    def empty_dimensions(self) -> List[int]:
        """Dimensions masked in *every* sample (`dataset.rs:193-222`).
        The reduction is jitted: an eager ``jnp.any`` over a multi-GB mask
        can allocate a transient cast right at the dataset's HBM high-water
        mark (observed OOM at N=4M, D=1024 bf16 on a 16 GB chip)."""
        if self.is_empty():
            return []
        any_observed = np.asarray(_any_over_rows(self.mask))
        return [int(i) for i in np.nonzero(~any_observed)[0]]

    def numpy(self) -> np.ndarray:
        """NaN-filled (N, D) round-trip (`src/python_bindings.rs:81-92`)."""
        data = np.asarray(self.data, dtype=np.float64)[: len(self)]
        mask = np.asarray(self.mask)[: len(self)]
        return np.where(mask, data, np.nan)

    def weights_numpy(self) -> np.ndarray:
        return np.asarray(self.weights_dev, dtype=np.float64)[: len(self)]

    # Parity alias: the bindings expose `weights()` as a method
    # (`src/python_bindings.rs:106-108`).
    def weights_(self) -> np.ndarray:  # pragma: no cover - thin alias
        return self.weights_numpy()

    # ------------------------------------------------------------------ #
    # serialization

    def dump(self) -> bytes:
        """Stable bytes (API twin of the bincode dump at
        `src/python_bindings.rs:74-79`; byte format is ours, see SURVEY §5)."""
        n = len(self)
        return dump_bytes(
            "dataset",
            {
                "data": np.asarray(self.data, dtype=np.float64)[:n],
                "mask": np.asarray(self.mask)[:n],
                "weights": np.asarray(self.weights_dev, dtype=np.float64)[:n],
            },
        )

    @staticmethod
    def load(data: bytes) -> "Dataset":
        arrays, _ = load_bytes(data, "dataset")
        return Dataset.from_parts(arrays["data"], arrays["mask"], arrays["weights"])

    def __getstate__(self):
        return self.dump()

    def __setstate__(self, state):
        other = Dataset.load(state)
        self.data, self.mask, self.weights_dev = other.data, other.mask, other.weights_dev
        self._n_real = None
        self._all_observed = None
        self._patterns = None

    def __reduce__(self):
        return (Dataset.load, (self.dump(),))

    # ------------------------------------------------------------------ #
    # slicing

    def slice(self, start: int, stop: int) -> "Dataset":
        stop = min(stop, len(self))
        new = Dataset.from_parts(
            self.data[start:stop], self.mask[start:stop], self.weights_dev[start:stop]
        )
        if self._all_observed:
            new._all_observed = True
        return new

    def chunks(self, chunks: int) -> "DatasetChunks":
        """Iterator over ``chunks`` contiguous pieces with stride
        ``ceil(len / chunks)`` (`src/python_bindings.rs:110-118,136-166`)."""
        stride = -(-len(self) // chunks) if chunks > 0 else len(self)
        return DatasetChunks(self, max(stride, 1))

    @staticmethod
    def concat(datasets: Sequence["Dataset"]) -> "Dataset":
        """Concatenate datasets (`src/python_bindings.rs:120-133`)."""
        datasets = list(datasets)
        if not datasets:
            raise ValueError("cannot concat an empty list of datasets")
        return Dataset.from_parts(
            jnp.concatenate([d.data[: len(d)] for d in datasets], axis=0),
            jnp.concatenate([d.mask[: len(d)] for d in datasets], axis=0),
            jnp.concatenate([d.weights_dev[: len(d)] for d in datasets], axis=0),
        )

    def __repr__(self) -> str:
        return f"Dataset(len={len(self)}, output_size={self.output_size()}, dtype={self.dtype})"


class DatasetChunks:
    """Iterator of Dataset slices (`src/python_bindings.rs:136-166`)."""

    def __init__(self, dataset: Dataset, stride: int):
        self._dataset = dataset
        self._stride = stride
        self._position = 0

    def __iter__(self) -> Iterator[Dataset]:
        return self

    def __next__(self) -> Dataset:
        if self._position >= len(self._dataset):
            raise StopIteration
        start = self._position
        stop = min(len(self._dataset), start + self._stride)
        self._position += self._stride
        return self._dataset.slice(start, stop)
