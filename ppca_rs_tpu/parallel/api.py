"""Sharded (SPMD) implementations of the heavy verbs.

Mirrors the single-device jitted kernels in ``models/ppca.py`` but wraps the
blocked reductions in ``jax.shard_map`` over a ('data', 'model') mesh:

* every device runs the same blocked scan over its local rows (and local
  columns when the model axis is used),
* EM sufficient statistics are combined with ``psum`` across devices —
  the equivalent of the reference's rayon reduces (SURVEY.md §2.5),
* parameter finalization runs replicated (it is tiny: k x k solves over D
  rows, model-sharded when D is sharded).

The functions here are cached per (mesh, model-axis-use) pair and are
signature-compatible with their single-device twins, so the model classes
dispatch transparently on the dataset's sharding.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from ..ops import masked_linalg as ml
from .mesh import DATA_AXIS, MODEL_AXIS


@functools.lru_cache(maxsize=None)
def fns_for(mesh, use_model_axis: bool, dense: bool = False):
    """Build (and cache) the sharded verb implementations for a mesh.
    ``dense=True`` swaps in the fully-observed fast path
    (ops/dense_fast.py) under the same shard_map layout."""
    from ..ops import dense_fast as df

    axis_model = MODEL_AXIS if use_model_axis else None
    col = MODEL_AXIS if use_model_axis else None
    rows = P(DATA_AXIS, col)        # data, mask
    wspec = P(DATA_AXIS)            # weights
    cspec = P(col, None)            # transform C (D, k)
    mspec = P(col)                  # mean (D,)
    rep = P()                       # replicated scalars / prior pieces

    def smap(f, in_specs, out_specs):
        return jax.shard_map(
            f, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
        )

    @functools.partial(jax.jit, static_argnames=("block_size",))
    def llks(C, mean, sigma, data, mask, block_size):
        def inner(C, mean, sigma, data, mask):
            if dense:
                return df.llks(C, mean, sigma, data, axis_model=axis_model)
            return ml.llks(
                C, mean, sigma, data, mask,
                block_size=block_size, axis_model=axis_model,
            )
        return smap(
            inner, (cspec, mspec, rep, rows, rows), P(DATA_AXIS)
        )(C, mean, sigma, data, mask)

    @functools.partial(jax.jit, static_argnames=("block_size",))
    def llk(C, mean, sigma, data, mask, weights, block_size):
        def inner(C, mean, sigma, data, mask, weights):
            if dense:
                per = df.llks(C, mean, sigma, data, axis_model=axis_model)
            else:
                per = ml.llks(
                    C, mean, sigma, data, mask,
                    block_size=block_size, axis_model=axis_model,
                )
            return lax.psum(jnp.sum(per * weights), DATA_AXIS)
        return smap(
            inner, (cspec, mspec, rep, rows, rows, wspec), rep
        )(C, mean, sigma, data, mask, weights)

    @functools.partial(jax.jit, static_argnames=("block_size",))
    def infer(C, mean, sigma, data, mask, block_size):
        def inner(C, mean, sigma, data, mask):
            if dense:
                return df.infer(C, mean, sigma, data, axis_model=axis_model)
            return ml.infer(
                C, mean, sigma, data, mask,
                block_size=block_size, axis_model=axis_model,
            )
        return smap(
            inner, (cspec, mspec, rep, rows, rows), (P(DATA_AXIS), P(DATA_AXIS))
        )(C, mean, sigma, data, mask)

    @functools.partial(jax.jit, static_argnames=("block_size",))
    def smooth(C, mean, sigma, data, mask, block_size):
        def inner(C, mean, sigma, data, mask):
            if dense:
                states = df.states(C, mean, sigma, data, axis_model=axis_model)
            else:
                states = ml.states(
                    C, mean, sigma, data, mask,
                    block_size=block_size, axis_model=axis_model,
                )
            return states @ C.T + mean
        return smap(
            inner, (cspec, mspec, rep, rows, rows), rows
        )(C, mean, sigma, data, mask)

    @functools.partial(jax.jit, static_argnames=("block_size",))
    def extrapolate(C, mean, sigma, data, mask, block_size):
        def inner(C, mean, sigma, data, mask):
            if dense:
                return data  # fully observed: nothing to fill
            states = ml.states(
                C, mean, sigma, data, mask,
                block_size=block_size, axis_model=axis_model,
            )
            smoothed = states @ C.T + mean
            return jnp.where(mask, data, smoothed)
        return smap(
            inner, (cspec, mspec, rep, rows, rows), rows
        )(C, mean, sigma, data, mask)

    def _em_body(C, mean, sigma, data, mask, weights, tprec, noise_prior,
                 mean_prior, block_size):
        """One sharded EM step (inside shard_map): data-axis psum of all
        statistics, model-axis reductions of the few cross-D scalars inside
        em_finalize.  The single shared body behind em_step and em_n."""
        if dense:
            st = df.em_stats(
                C, mean, sigma, data, weights,
                block_size=block_size, axis_model=axis_model,
            )
            st = jax.tree.map(lambda x: lax.psum(x, DATA_AXIS), st)
            out = df.em_finalize(
                C, mean, sigma, st,
                transformation_precision=tprec,
                noise_prior=noise_prior, mean_prior=mean_prior,
                axis_model=axis_model,
            )
            return out, st.llk
        st = ml.em_stats(
            C, mean, sigma, data, mask, weights,
            block_size=block_size, axis_model=axis_model,
        )
        st = jax.tree.map(lambda x: lax.psum(x, DATA_AXIS), st)
        out = ml.em_finalize(
            C, mean, sigma, st,
            transformation_precision=tprec,
            noise_prior=noise_prior, mean_prior=mean_prior,
            axis_model=axis_model,
        )
        return out, st.llk

    @functools.partial(jax.jit, static_argnames=("block_size",))
    def em_stats_only(C, mean, sigma, data, mask, weights, block_size):
        """Data-axis-reduced EM sufficient statistics of one sharded chunk,
        replicated on every device — the sharded twin of masked_linalg /
        dense_fast em_stats for the streaming accumulator (stats are
        additive over chunks).  Data-parallel meshes only — the verb is
        omitted from the model-axis fns table entirely (the data-axis psum
        would stitch D_loc-local fields as if they were global)."""
        def inner(C, mean, sigma, data, mask, weights):
            if dense:
                st = df.em_stats(
                    C, mean, sigma, data, weights,
                    block_size=block_size, axis_model=axis_model,
                )
            else:
                st = ml.em_stats(
                    C, mean, sigma, data, mask, weights,
                    block_size=block_size, axis_model=axis_model,
                )
            return jax.tree.map(lambda x: lax.psum(x, DATA_AXIS), st)
        return smap(
            inner, (cspec, mspec, rep, rows, rows, wspec), rep
        )(C, mean, sigma, data, mask, weights)

    @functools.partial(jax.jit, static_argnames=("block_size",))
    def em_stats_pat_only(C, mean, sigma, data, mask, weights, pidx, pats,
                          block_size):
        """Pattern-table twin of em_stats_only (data-parallel meshes only)."""
        def inner(C, mean, sigma, data, mask, weights, pidx, pats):
            st = pd.em_stats(
                C, mean, sigma, data, mask, pidx, pats, weights,
                block_size=block_size,
            )
            return jax.tree.map(lambda x: lax.psum(x, DATA_AXIS), st)
        return smap(
            inner, (cspec, mspec, rep, rows, rows, wspec, pspec, rep), rep
        )(C, mean, sigma, data, mask, weights, pidx, pats)

    @functools.partial(jax.jit, static_argnames=("block_size",))
    def em_step(C, mean, sigma, data, mask, weights, tprec, noise_prior, mean_prior, block_size):
        def inner(C, mean, sigma, data, mask, weights, tprec, noise_prior, mean_prior):
            (new_C, new_mean, new_sigma), llk = _em_body(
                C, mean, sigma, data, mask, weights, tprec, noise_prior,
                mean_prior, block_size,
            )
            return new_C, new_mean, new_sigma, llk
        return smap(
            inner,
            (cspec, mspec, rep, rows, rows, wspec, rep, rep, rep),
            (cspec, mspec, rep, rep),
        )(C, mean, sigma, data, mask, weights, tprec, noise_prior, mean_prior)

    # ---- mask-pattern-dedup variants (ops/pattern_dedup.py) -------------
    # Data-axis sharding only: each shard runs the table path on its local
    # rows with the replicated pattern table and its local pattern indices;
    # statistics psum over the data axis exactly like the general path.
    # (Model-axis sharding keeps the general path — gated at dispatch.)

    from ..ops import pattern_dedup as pd

    pspec = P(DATA_AXIS)               # pattern indices (N,)

    @functools.partial(jax.jit, static_argnames=("block_size",))
    def llks_pat(C, mean, sigma, data, mask, pidx, pats, block_size):
        def inner(C, mean, sigma, data, mask, pidx, pats):
            return pd.llks(C, mean, sigma, data, mask, pidx, pats,
                           block_size=block_size)
        return smap(
            inner, (cspec, mspec, rep, rows, rows, pspec, rep), P(DATA_AXIS)
        )(C, mean, sigma, data, mask, pidx, pats)

    @functools.partial(jax.jit, static_argnames=("block_size",))
    def llk_pat(C, mean, sigma, data, mask, weights, pidx, pats, block_size):
        def inner(C, mean, sigma, data, mask, weights, pidx, pats):
            per = pd.llks(C, mean, sigma, data, mask, pidx, pats,
                          block_size=block_size)
            return lax.psum(jnp.sum(per * weights), DATA_AXIS)
        return smap(
            inner, (cspec, mspec, rep, rows, rows, wspec, pspec, rep), rep
        )(C, mean, sigma, data, mask, weights, pidx, pats)

    @functools.partial(jax.jit, static_argnames=("block_size",))
    def infer_pat(C, mean, sigma, data, mask, pidx, pats, block_size):
        def inner(C, mean, sigma, data, mask, pidx, pats):
            return pd.infer(C, mean, sigma, data, mask, pidx, pats,
                            block_size=block_size)
        return smap(
            inner, (cspec, mspec, rep, rows, rows, pspec, rep),
            (P(DATA_AXIS), P(DATA_AXIS)),
        )(C, mean, sigma, data, mask, pidx, pats)

    @functools.partial(jax.jit, static_argnames=("block_size", "extrapolate"))
    def smooth_pat(C, mean, sigma, data, mask, pidx, pats, block_size,
                   extrapolate=False):
        def inner(C, mean, sigma, data, mask, pidx, pats):
            states = pd.states(C, mean, sigma, data, mask, pidx, pats,
                               block_size=block_size)
            smoothed = states @ C.T + mean
            if extrapolate:
                return jnp.where(mask, data, smoothed)
            return smoothed
        return smap(
            inner, (cspec, mspec, rep, rows, rows, pspec, rep), rows
        )(C, mean, sigma, data, mask, pidx, pats)

    @functools.partial(jax.jit, static_argnames=("block_size",))
    def em_step_pat(C, mean, sigma, data, mask, weights, pidx, pats,
                    tprec, noise_prior, mean_prior, block_size):
        def inner(C, mean, sigma, data, mask, weights, pidx, pats,
                  tprec, noise_prior, mean_prior):
            (new_C, new_mean, new_sigma), llk = _em_body_pat(
                C, mean, sigma, data, mask, weights, pidx, pats,
                tprec, noise_prior, mean_prior, block_size,
            )
            return new_C, new_mean, new_sigma, llk
        return smap(
            inner,
            (cspec, mspec, rep, rows, rows, wspec, pspec, rep, rep, rep, rep),
            (cspec, mspec, rep, rep),
        )(C, mean, sigma, data, mask, weights, pidx, pats,
          tprec, noise_prior, mean_prior)

    @functools.partial(jax.jit, static_argnames=("block_size", "n_iters"))
    def em_n(C, mean, sigma, data, mask, weights, tprec, noise_prior,
             mean_prior, block_size, n_iters):
        """n_iters sharded EM steps inside ONE shard_map: the scan carries
        the parameters on device, collectives run once per iteration."""
        def inner(C, mean, sigma, data, mask, weights, tprec, noise_prior,
                  mean_prior):
            def step(carry, _):
                return _em_body(*carry, data, mask, weights, tprec,
                                noise_prior, mean_prior, block_size)
            (C, mean, sigma), llks = lax.scan(
                step, (C, mean, sigma), None, length=n_iters
            )
            return C, mean, sigma, llks
        return smap(
            inner,
            (cspec, mspec, rep, rows, rows, wspec, rep, rep, rep),
            (cspec, mspec, rep, rep),
        )(C, mean, sigma, data, mask, weights, tprec, noise_prior, mean_prior)

    def _em_body_pat(C, mean, sigma, data, mask, weights, pidx, pats,
                     tprec, noise_prior, mean_prior, block_size):
        st = pd.em_stats(
            C, mean, sigma, data, mask, pidx, pats, weights,
            block_size=block_size,
        )
        st = jax.tree.map(lambda x: lax.psum(x, DATA_AXIS), st)
        out = ml.em_finalize(
            C, mean, sigma, st,
            transformation_precision=tprec,
            noise_prior=noise_prior, mean_prior=mean_prior,
        )
        return out, st.llk

    @functools.partial(jax.jit, static_argnames=("block_size", "n_iters"))
    def em_n_pat(C, mean, sigma, data, mask, weights, pidx, pats,
                 tprec, noise_prior, mean_prior, block_size, n_iters):
        def inner(C, mean, sigma, data, mask, weights, pidx, pats,
                  tprec, noise_prior, mean_prior):
            def step(carry, _):
                return _em_body_pat(*carry, data, mask, weights, pidx, pats,
                                    tprec, noise_prior, mean_prior, block_size)
            (C, mean, sigma), llks = lax.scan(
                step, (C, mean, sigma), None, length=n_iters
            )
            return C, mean, sigma, llks
        return smap(
            inner,
            (cspec, mspec, rep, rows, rows, wspec, pspec, rep, rep, rep, rep),
            (cspec, mspec, rep, rep),
        )(C, mean, sigma, data, mask, weights, pidx, pats,
          tprec, noise_prior, mean_prior)

    def _em_body_pat_sorted(C, mean, sigma, data_s, w_s, pats,
                            tprec, noise_prior, mean_prior, block_size,
                            counts):
        st = pd.em_stats_sorted(
            C, mean, sigma, data_s, w_s, pats, counts,
            block_size=block_size,
        )
        st = jax.tree.map(lambda x: lax.psum(x, DATA_AXIS), st)
        out = ml.em_finalize(
            C, mean, sigma, st,
            transformation_precision=tprec,
            noise_prior=noise_prior, mean_prior=mean_prior,
        )
        return out, st.llk

    # Sorted-segment EM over a data-axis mesh (Dataset.pattern_order_sharded):
    # every shard holds the SAME static per-pattern counts (ceil-balanced
    # layout with zero-weight duplicate padding), so one SPMD program runs
    # the flop-minimal segment scan locally and the statistics psum exactly
    # like the general path.  Weights are sorted per call OUTSIDE shard_map
    # ((N,) cross-shard gather — XLA inserts the collective) so with_weights
    # twins share the cached sorted data copy.

    @functools.partial(jax.jit, static_argnames=("block_size", "counts"))
    def em_step_pat_sorted(C, mean, sigma, data_s, weights, perm, valid,
                           pats, tprec, noise_prior, mean_prior, block_size,
                           counts):
        w_s = jnp.take(weights, perm, axis=0) * valid

        def inner(C, mean, sigma, data_s, w_s, pats,
                  tprec, noise_prior, mean_prior):
            (new_C, new_mean, new_sigma), llk = _em_body_pat_sorted(
                C, mean, sigma, data_s, w_s, pats,
                tprec, noise_prior, mean_prior, block_size, counts,
            )
            return new_C, new_mean, new_sigma, llk
        return smap(
            inner,
            (cspec, mspec, rep, rows, wspec, rep, rep, rep, rep),
            (cspec, mspec, rep, rep),
        )(C, mean, sigma, data_s, w_s, pats, tprec, noise_prior, mean_prior)

    @functools.partial(jax.jit,
                       static_argnames=("block_size", "counts", "n_iters"))
    def em_n_pat_sorted(C, mean, sigma, data_s, weights, perm, valid, pats,
                        tprec, noise_prior, mean_prior, block_size, counts,
                        n_iters):
        w_s = jnp.take(weights, perm, axis=0) * valid  # sort once per scan

        def inner(C, mean, sigma, data_s, w_s, pats,
                  tprec, noise_prior, mean_prior):
            def step(carry, _):
                return _em_body_pat_sorted(
                    *carry, data_s, w_s, pats,
                    tprec, noise_prior, mean_prior, block_size, counts,
                )
            (C, mean, sigma), llks = lax.scan(
                step, (C, mean, sigma), None, length=n_iters
            )
            return C, mean, sigma, llks
        return smap(
            inner,
            (cspec, mspec, rep, rows, wspec, rep, rep, rep, rep),
            (cspec, mspec, rep, rep),
        )(C, mean, sigma, data_s, w_s, pats, tprec, noise_prior, mean_prior)

    @functools.partial(jax.jit, static_argnames=("block_size",))
    def mix_llks(Cs, means, sigmas, data, mask, block_size):
        """Sharded fused per-component llks: one pass for all M components
        on every data shard (ops/mix_fused.py)."""
        from ..ops import mix_fused as mfd

        def inner(Cs, means, sigmas, data, mask):
            return mfd.mix_llks(
                Cs, means, sigmas, data, mask,
                block_size=block_size, axis_model=axis_model,
            )

        return smap(
            inner,
            (P(None, col, None), P(None, col), rep, rows, rows),
            P(DATA_AXIS),
        )(Cs, means, sigmas, data, mask)

    @functools.partial(jax.jit, static_argnames=("block_size",))
    def mix_infer(Cs, means, sigmas, log_weights, data, mask, block_size):
        """Sharded fused mixture inference: ONE device program for the
        log-posteriors plus every component's posterior states and
        covariances — replacing the per-component fallback's M+1 programs
        (VERDICT round 2 weak #4; matches `mix.rs:205-236`)."""
        from ..ops import mix_fused as mfd

        def inner(Cs, means, sigmas, log_weights, data, mask):
            return mfd.mix_infer(
                Cs, means, sigmas, log_weights, data, mask,
                block_size=block_size, axis_model=axis_model,
            )

        return smap(
            inner,
            (P(None, col, None), P(None, col), rep, rep, rows, rows),
            (P(DATA_AXIS), P(None, DATA_AXIS), P(None, DATA_AXIS)),
        )(Cs, means, sigmas, log_weights, data, mask)

    @functools.partial(jax.jit, static_argnames=("block_size", "extrapolate"))
    def mix_smooth(Cs, means, sigmas, log_weights, data, mask, block_size,
                   extrapolate=False):
        """Sharded fused posterior-weighted smoothing / extrapolation
        (`mix.rs:239-265`) — one end-to-end pass per shard."""
        from ..ops import mix_fused as mfd

        def inner(Cs, means, sigmas, log_weights, data, mask):
            return mfd.mix_smooth(
                Cs, means, sigmas, log_weights, data, mask,
                block_size=block_size, axis_model=axis_model,
                extrapolate=extrapolate,
            )

        return smap(
            inner,
            (P(None, col, None), P(None, col), rep, rep, rows, rows),
            rows,
        )(Cs, means, sigmas, log_weights, data, mask)

    @functools.partial(jax.jit, static_argnames=("block_size",))
    def mix_llks_pat(Cs, means, sigmas, data, mask, pidx, pats, block_size):
        """Pattern-table twin of mix_llks (data-parallel meshes only)."""
        from ..ops import mix_fused as mfd

        def inner(Cs, means, sigmas, data, mask, pidx, pats):
            return mfd.mix_llks(
                Cs, means, sigmas, data, mask,
                block_size=block_size, pidx=pidx, patterns=pats,
            )

        return smap(
            inner,
            (P(None, col, None), P(None, col), rep, rows, rows, pspec, rep),
            P(DATA_AXIS),
        )(Cs, means, sigmas, data, mask, pidx, pats)

    @functools.partial(jax.jit, static_argnames=("block_size",))
    def mix_infer_pat(Cs, means, sigmas, log_weights, data, mask, pidx, pats,
                      block_size):
        """Pattern-table twin of mix_infer (data-parallel meshes only, like
        every *_pat verb — pattern_info demotes model-sharded datasets)."""
        from ..ops import mix_fused as mfd

        def inner(Cs, means, sigmas, log_weights, data, mask, pidx, pats):
            return mfd.mix_infer(
                Cs, means, sigmas, log_weights, data, mask,
                block_size=block_size, pidx=pidx, patterns=pats,
            )

        return smap(
            inner,
            (P(None, col, None), P(None, col), rep, rep, rows, rows, pspec, rep),
            (P(DATA_AXIS), P(None, DATA_AXIS), P(None, DATA_AXIS)),
        )(Cs, means, sigmas, log_weights, data, mask, pidx, pats)

    @functools.partial(jax.jit, static_argnames=("block_size", "extrapolate"))
    def mix_smooth_pat(Cs, means, sigmas, log_weights, data, mask, pidx, pats,
                       block_size, extrapolate=False):
        from ..ops import mix_fused as mfd

        def inner(Cs, means, sigmas, log_weights, data, mask, pidx, pats):
            return mfd.mix_smooth(
                Cs, means, sigmas, log_weights, data, mask,
                block_size=block_size, pidx=pidx, patterns=pats,
                extrapolate=extrapolate,
            )

        return smap(
            inner,
            (P(None, col, None), P(None, col), rep, rep, rows, rows, pspec, rep),
            rows,
        )(Cs, means, sigmas, log_weights, data, mask, pidx, pats)

    def _combine_mix_stats(stats):
        """Combine MixEMStats across the data axis: psum for every additive
        field, pmax for the per-component weight-normalization term."""
        from ..ops import mix_fused as mfd

        return mfd.MixEMStats(
            *(
                lax.pmax(x, DATA_AXIS) if name == "resp_max"
                else lax.psum(x, DATA_AXIS)
                for name, x in zip(stats._fields, stats)
            )
        )

    def _mix_em_body(Cs, means, sigmas, log_weights, data, mask, weights,
                     tprec, noise_prior, mean_prior, block_size):
        """One sharded fused mixture EM step (inside shard_map): stats psum
        over the data axis (pmax for the weight-normalization term),
        finalization model-sharded like the single-model path."""
        from ..ops import mix_fused as mfd

        stats = mfd.mix_em_stats(
            Cs, means, sigmas, log_weights, data, mask, weights,
            block_size=block_size, axis_model=axis_model,
        )
        stats = _combine_mix_stats(stats)
        out = mfd.mix_em_finalize(
            Cs, means, sigmas, stats,
            transformation_precision=tprec,
            noise_prior=noise_prior,
            mean_prior=mean_prior,
            axis_model=axis_model,
        )
        return out, stats.llk

    @functools.partial(jax.jit, static_argnames=("block_size",))
    def mix_em_stats_only(Cs, means, sigmas, log_weights, data, mask, weights,
                          block_size):
        """Data-axis-combined fused mixture EM statistics of one sharded
        chunk, replicated on every device (psum; pmax for resp_max) — the
        streaming accumulator's sharded source.  Data-parallel meshes only."""
        from ..ops import mix_fused as mfd

        def inner(Cs, means, sigmas, log_weights, data, mask, weights):
            stats = mfd.mix_em_stats(
                Cs, means, sigmas, log_weights, data, mask, weights,
                block_size=block_size, axis_model=axis_model,
            )
            return _combine_mix_stats(stats)
        return smap(
            inner,
            (P(None, col, None), P(None, col), rep, rep, rows, rows, wspec),
            rep,
        )(Cs, means, sigmas, log_weights, data, mask, weights)

    @functools.partial(jax.jit, static_argnames=("block_size",))
    def mix_em_step(Cs, means, sigmas, log_weights, data, mask, weights,
                    tprec, noise_prior, mean_prior, block_size):
        def inner(Cs, means, sigmas, log_weights, data, mask, weights,
                  tprec, noise_prior, mean_prior):
            (new_Cs, new_means, new_sigmas, new_logw), llk = _mix_em_body(
                Cs, means, sigmas, log_weights, data, mask, weights,
                tprec, noise_prior, mean_prior, block_size,
            )
            return new_Cs, new_means, new_sigmas, new_logw, llk

        return smap(
            inner,
            (P(None, col, None), P(None, col), rep, rep,
             rows, rows, wspec, rep, rep, rep),
            (P(None, col, None), P(None, col), rep, rep, rep),
        )(Cs, means, sigmas, log_weights, data, mask, weights,
          tprec, noise_prior, mean_prior)

    @functools.partial(jax.jit, static_argnames=("block_size", "n_iters"))
    def mix_em_n(Cs, means, sigmas, log_weights, data, mask, weights,
                 tprec, noise_prior, mean_prior, block_size, n_iters):
        def inner(Cs, means, sigmas, log_weights, data, mask, weights,
                  tprec, noise_prior, mean_prior):
            def step(carry, _):
                return _mix_em_body(*carry, data, mask, weights, tprec,
                                    noise_prior, mean_prior, block_size)
            carry, llks = lax.scan(
                step, (Cs, means, sigmas, log_weights), None, length=n_iters
            )
            return (*carry, llks)

        return smap(
            inner,
            (P(None, col, None), P(None, col), rep, rep,
             rows, rows, wspec, rep, rep, rep),
            (P(None, col, None), P(None, col), rep, rep, rep),
        )(Cs, means, sigmas, log_weights, data, mask, weights,
          tprec, noise_prior, mean_prior)

    def _mix_em_body_pat(Cs, means, sigmas, log_weights, data, mask, weights,
                         pidx, pats, tprec, noise_prior, mean_prior,
                         block_size):
        """Pattern-table twin of _mix_em_body (`mix.rs:281-337` semantics):
        each data shard runs the M x P table path on its local rows, then
        the statistics combine exactly like the general path."""
        from ..ops import mix_fused as mfd

        stats = mfd.mix_em_stats_pat(
            Cs, means, sigmas, log_weights, data, mask, pidx, pats, weights,
            block_size=block_size,
        )
        stats = _combine_mix_stats(stats)
        out = mfd.mix_em_finalize(
            Cs, means, sigmas, stats,
            transformation_precision=tprec,
            noise_prior=noise_prior,
            mean_prior=mean_prior,
        )
        return out, stats.llk

    @functools.partial(jax.jit, static_argnames=("block_size",))
    def mix_em_step_pat(Cs, means, sigmas, log_weights, data, mask, weights,
                        pidx, pats, tprec, noise_prior, mean_prior,
                        block_size):
        def inner(Cs, means, sigmas, log_weights, data, mask, weights,
                  pidx, pats, tprec, noise_prior, mean_prior):
            (new_Cs, new_means, new_sigmas, new_logw), llk = _mix_em_body_pat(
                Cs, means, sigmas, log_weights, data, mask, weights,
                pidx, pats, tprec, noise_prior, mean_prior, block_size,
            )
            return new_Cs, new_means, new_sigmas, new_logw, llk

        return smap(
            inner,
            (P(None, col, None), P(None, col), rep, rep,
             rows, rows, wspec, pspec, rep, rep, rep, rep),
            (P(None, col, None), P(None, col), rep, rep, rep),
        )(Cs, means, sigmas, log_weights, data, mask, weights,
          pidx, pats, tprec, noise_prior, mean_prior)

    @functools.partial(jax.jit, static_argnames=("block_size", "n_iters"))
    def mix_em_n_pat(Cs, means, sigmas, log_weights, data, mask, weights,
                     pidx, pats, tprec, noise_prior, mean_prior,
                     block_size, n_iters):
        def inner(Cs, means, sigmas, log_weights, data, mask, weights,
                  pidx, pats, tprec, noise_prior, mean_prior):
            def step(carry, _):
                return _mix_em_body_pat(*carry, data, mask, weights, pidx,
                                        pats, tprec, noise_prior, mean_prior,
                                        block_size)
            carry, llks = lax.scan(
                step, (Cs, means, sigmas, log_weights), None, length=n_iters
            )
            return (*carry, llks)

        return smap(
            inner,
            (P(None, col, None), P(None, col), rep, rep,
             rows, rows, wspec, pspec, rep, rep, rep, rep),
            (P(None, col, None), P(None, col), rep, rep, rep),
        )(Cs, means, sigmas, log_weights, data, mask, weights,
          pidx, pats, tprec, noise_prior, mean_prior)

    def _mix_em_body_pat_sorted(Cs, means, sigmas, log_weights, data_s, w_s,
                                pats, tprec, noise_prior, mean_prior,
                                block_size, counts):
        """Sorted-segment twin of _mix_em_body_pat under the balanced
        sharded layout (Dataset.pattern_order_sharded): identical static
        per-pattern counts on every shard, zero-weight duplicate padding
        (neutral in every statistic incl. the weight-scaled resp_max)."""
        from ..ops import mix_fused as mfd

        stats = mfd.mix_em_stats_pat_sorted(
            Cs, means, sigmas, log_weights, data_s, w_s, pats, counts,
            block_size=block_size,
        )
        stats = _combine_mix_stats(stats)
        out = mfd.mix_em_finalize(
            Cs, means, sigmas, stats,
            transformation_precision=tprec,
            noise_prior=noise_prior,
            mean_prior=mean_prior,
        )
        return out, stats.llk

    @functools.partial(jax.jit, static_argnames=("block_size", "counts"))
    def mix_em_step_pat_sorted(Cs, means, sigmas, log_weights, data_s,
                               weights, perm, valid, pats, tprec,
                               noise_prior, mean_prior, block_size, counts):
        w_s = jnp.take(weights, perm, axis=0) * valid

        def inner(Cs, means, sigmas, log_weights, data_s, w_s, pats,
                  tprec, noise_prior, mean_prior):
            (new_Cs, new_means, new_sigmas, new_logw), llk = \
                _mix_em_body_pat_sorted(
                    Cs, means, sigmas, log_weights, data_s, w_s, pats,
                    tprec, noise_prior, mean_prior, block_size, counts,
                )
            return new_Cs, new_means, new_sigmas, new_logw, llk

        return smap(
            inner,
            (P(None, col, None), P(None, col), rep, rep,
             rows, wspec, rep, rep, rep, rep),
            (P(None, col, None), P(None, col), rep, rep, rep),
        )(Cs, means, sigmas, log_weights, data_s, w_s, pats,
          tprec, noise_prior, mean_prior)

    @functools.partial(jax.jit,
                       static_argnames=("block_size", "counts", "n_iters"))
    def mix_em_n_pat_sorted(Cs, means, sigmas, log_weights, data_s, weights,
                            perm, valid, pats, tprec, noise_prior,
                            mean_prior, block_size, counts, n_iters):
        w_s = jnp.take(weights, perm, axis=0) * valid  # sort once per scan

        def inner(Cs, means, sigmas, log_weights, data_s, w_s, pats,
                  tprec, noise_prior, mean_prior):
            def step(carry, _):
                return _mix_em_body_pat_sorted(
                    *carry, data_s, w_s, pats,
                    tprec, noise_prior, mean_prior, block_size, counts,
                )
            carry, llks = lax.scan(
                step, (Cs, means, sigmas, log_weights), None, length=n_iters
            )
            return (*carry, llks)

        return smap(
            inner,
            (P(None, col, None), P(None, col), rep, rep,
             rows, wspec, rep, rep, rep, rep),
            (P(None, col, None), P(None, col), rep, rep, rep),
        )(Cs, means, sigmas, log_weights, data_s, w_s, pats,
          tprec, noise_prior, mean_prior)

    @functools.partial(jax.jit, static_argnames=("block_size",))
    def mix_em_stats_pat_only(Cs, means, sigmas, log_weights, data, mask,
                              weights, pidx, pats, block_size):
        """Pattern-table twin of mix_em_stats_only for the streaming
        accumulator (data-parallel meshes only)."""
        from ..ops import mix_fused as mfd

        def inner(Cs, means, sigmas, log_weights, data, mask, weights,
                  pidx, pats):
            stats = mfd.mix_em_stats_pat(
                Cs, means, sigmas, log_weights, data, mask, pidx, pats,
                weights, block_size=block_size,
            )
            return _combine_mix_stats(stats)
        return smap(
            inner,
            (P(None, col, None), P(None, col), rep, rep,
             rows, rows, wspec, pspec, rep),
            rep,
        )(Cs, means, sigmas, log_weights, data, mask, weights, pidx, pats)

    fns = {
        "llks": llks,
        "llk": llk,
        "infer": infer,
        "smooth": smooth,
        "extrapolate": extrapolate,
        "em_step": em_step,
        "em_n": em_n,
        "mix_llks": mix_llks,
        "mix_infer": mix_infer,
        "mix_smooth": mix_smooth,
        "mix_em_step": mix_em_step,
        "mix_em_n": mix_em_n,
    }
    if not use_model_axis:
        # Pattern-table verbs are data-parallel only: their bodies carry no
        # model-axis collectives (pattern tables index full D rows), and the
        # call sites demote to the general path on model-axis meshes
        # (pattern_info returns None there). Omitting the keys makes any
        # future misuse a KeyError instead of silently-wrong statistics.
        fns["llks_pat"] = llks_pat
        fns["llk_pat"] = llk_pat
        fns["infer_pat"] = infer_pat
        fns["smooth_pat"] = smooth_pat
        fns["em_step_pat"] = em_step_pat
        fns["em_n_pat"] = em_n_pat
        fns["em_step_pat_sorted"] = em_step_pat_sorted
        fns["em_n_pat_sorted"] = em_n_pat_sorted
        fns["mix_llks_pat"] = mix_llks_pat
        fns["mix_infer_pat"] = mix_infer_pat
        fns["mix_smooth_pat"] = mix_smooth_pat
        fns["mix_em_step_pat"] = mix_em_step_pat
        fns["mix_em_n_pat"] = mix_em_n_pat
        fns["mix_em_step_pat_sorted"] = mix_em_step_pat_sorted
        fns["mix_em_n_pat_sorted"] = mix_em_n_pat_sorted
        # stats-only verbs (the streaming accumulator's sources) psum over
        # the data axis alone; on a model-axis mesh their D-indexed fields
        # would be device-local, so the keys simply don't exist there.
        fns["em_stats"] = em_stats_only
        fns["em_stats_pat"] = em_stats_pat_only
        fns["mix_em_stats"] = mix_em_stats_only
        fns["mix_em_stats_pat"] = mix_em_stats_pat_only
    return fns
