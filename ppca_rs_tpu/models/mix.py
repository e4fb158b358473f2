"""PPCA mixture models — rebuild of `ppca/src/mix.rs`.

A mixture of :class:`PPCAModel` components with log-domain prior weights.
Components may have different state sizes but must share the output size
(`mix.rs:41-64`).  The mixture EM is the layered composition the reference
uses (`mix.rs:281-337`): per-sample responsibilities become per-sample
weights for each component's inner EM — which is what makes
``Dataset.with_weights`` load-bearing.

All N-sized math is fused across components (ops/mix_fused.py): EM,
per-component llks, infer, smooth and extrapolate are each ONE pass over the
data regardless of M.  Heterogeneous state sizes ride the same fused pass
zero-padded to max(k) — padded latent dimensions are exactly inert (see
PPCAMix._stacked_params); a reference-shaped per-component loop is kept as
the independently-implemented oracle the fused paths are tested against.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import block_size_for
from ..dataset import Dataset
from ..ops import mix_fused as mf
from ..prior import Prior
from ..utils.rng import ensure_key
from ..utils.serialization import dump_bytes, load_bytes
from .ppca import InferredMasked, PosteriorSampler, PPCAModel, _precision


def _mix_em_body(Cs, means, sigmas, log_weights, data, mask, weights,
                 tprec, noise_prior, mean_prior, block_size):
    """One fused mixture EM step: ((Cs, means, sigmas, logw), llk-before).
    The shared body behind the one-step jit and the n-step scan."""
    stats = mf.mix_em_stats(
        Cs, means, sigmas, log_weights, data, mask, weights,
        block_size=block_size,
    )
    out = mf.mix_em_finalize(
        Cs, means, sigmas, stats,
        transformation_precision=tprec,
        noise_prior=noise_prior,
        mean_prior=mean_prior,
    )
    return out, stats.llk


def _mix_em_body_pat(Cs, means, sigmas, log_weights, data, mask, pidx, pats,
                     weights, tprec, noise_prior, mean_prior, block_size):
    stats = mf.mix_em_stats_pat(
        Cs, means, sigmas, log_weights, data, mask, pidx, pats, weights,
        block_size=block_size,
    )
    out = mf.mix_em_finalize(
        Cs, means, sigmas, stats,
        transformation_precision=tprec,
        noise_prior=noise_prior,
        mean_prior=mean_prior,
    )
    return out, stats.llk


@functools.partial(jax.jit, static_argnames=("block_size",))
def _mix_em_jit(Cs, means, sigmas, log_weights, data, mask, weights,
                tprec, noise_prior, mean_prior, block_size):
    """Fused mixture EM step (ops/mix_fused.py): one pass over the data for
    all components' responsibilities + statistics, vs the reference's 2M
    passes (`mix.rs:281-337`)."""
    (Cs, means, sigmas, logw), llk = _mix_em_body(
        Cs, means, sigmas, log_weights, data, mask, weights,
        tprec, noise_prior, mean_prior, block_size,
    )
    return Cs, means, sigmas, logw, llk


@functools.partial(jax.jit, static_argnames=("block_size",))
def _mix_llks_jit(Cs, means, sigmas, data, mask, block_size):
    return mf.mix_llks(Cs, means, sigmas, data, mask, block_size=block_size)


@functools.partial(jax.jit, static_argnames=("block_size",))
def _mix_em_pat_jit(Cs, means, sigmas, log_weights, data, mask, pidx, pats,
                    weights, tprec, noise_prior, mean_prior, block_size):
    (Cs, means, sigmas, logw), llk = _mix_em_body_pat(
        Cs, means, sigmas, log_weights, data, mask, pidx, pats, weights,
        tprec, noise_prior, mean_prior, block_size,
    )
    return Cs, means, sigmas, logw, llk


def _mix_em_pat_jit_adapter(pat, Cs, means, sigmas, log_weights, data, mask,
                            weights, tprec, noise_prior, mean_prior, block_size):
    """Adapter binding (pidx, patterns) onto _mix_em_jit's signature."""
    return _mix_em_pat_jit(Cs, means, sigmas, log_weights, data, mask,
                           pat[0], pat[1], weights, tprec, noise_prior,
                           mean_prior, block_size)


@functools.partial(jax.jit, static_argnames=("block_size", "n_iters"))
def _mix_em_n_jit(Cs, means, sigmas, log_weights, data, mask, weights,
                  tprec, noise_prior, mean_prior, block_size, n_iters):
    """n_iters fused mixture EM steps in ONE compiled scan (no per-iteration
    dispatch); llks[i] is the mixture llk BEFORE step i."""
    def step(carry, _):
        return _mix_em_body(*carry, data, mask, weights, tprec,
                            noise_prior, mean_prior, block_size)
    carry, llks = jax.lax.scan(
        step, (Cs, means, sigmas, log_weights), None, length=n_iters
    )
    return (*carry, llks)


@functools.partial(jax.jit, static_argnames=("block_size", "n_iters"))
def _mix_em_n_pat_jit(Cs, means, sigmas, log_weights, data, mask, pidx, pats,
                      weights, tprec, noise_prior, mean_prior, block_size,
                      n_iters):
    def step(carry, _):
        return _mix_em_body_pat(*carry, data, mask, pidx, pats, weights,
                                tprec, noise_prior, mean_prior, block_size)
    carry, llks = jax.lax.scan(
        step, (Cs, means, sigmas, log_weights), None, length=n_iters
    )
    return (*carry, llks)


def _mix_em_n_pat_adapter(pat, Cs, means, sigmas, log_weights, data, mask,
                          weights, tprec, noise_prior, mean_prior, block_size,
                          n_iters):
    return _mix_em_n_pat_jit(Cs, means, sigmas, log_weights, data, mask,
                             pat[0], pat[1], weights, tprec, noise_prior,
                             mean_prior, block_size, n_iters)


@functools.partial(jax.jit, static_argnames=("block_size", "counts"))
def _mix_em_pat_sorted_jit(Cs, means, sigmas, log_weights, data_s, perm, pats,
                           weights, tprec, noise_prior, mean_prior,
                           block_size, counts):
    # weights sorted per call (cheap (N,) gather): with_weights twins and
    # the oracle loop's responsibility-weighted datasets reuse the cached
    # sorted data copy (Dataset.pattern_order).
    w_s = jnp.take(weights, perm, axis=0)
    stats = mf.mix_em_stats_pat_sorted(
        Cs, means, sigmas, log_weights, data_s, w_s, pats, counts,
        block_size=block_size,
    )
    out = mf.mix_em_finalize(
        Cs, means, sigmas, stats,
        transformation_precision=tprec,
        noise_prior=noise_prior,
        mean_prior=mean_prior,
    )
    return (*out, stats.llk)


@functools.partial(jax.jit, static_argnames=("block_size", "counts", "n_iters"))
def _mix_em_n_pat_sorted_jit(Cs, means, sigmas, log_weights, data_s, perm,
                             pats, weights, tprec, noise_prior, mean_prior,
                             block_size, counts, n_iters):
    w_s = jnp.take(weights, perm, axis=0)  # sort once for the whole scan

    def step(carry, _):
        Cs, means, sigmas, log_weights = carry
        stats = mf.mix_em_stats_pat_sorted(
            Cs, means, sigmas, log_weights, data_s, w_s, pats, counts,
            block_size=block_size,
        )
        out = mf.mix_em_finalize(
            Cs, means, sigmas, stats,
            transformation_precision=tprec,
            noise_prior=noise_prior,
            mean_prior=mean_prior,
        )
        return out, stats.llk

    carry, llks = jax.lax.scan(
        step, (Cs, means, sigmas, log_weights), None, length=n_iters
    )
    return (*carry, llks)


def _mix_em_pat_sorted_adapter(pat, order, Cs, means, sigmas, log_weights,
                               data, mask, weights, tprec, noise_prior,
                               mean_prior, block_size):
    data_s, perm, counts = order
    return _mix_em_pat_sorted_jit(Cs, means, sigmas, log_weights, data_s,
                                  perm, pat[1], weights, tprec, noise_prior,
                                  mean_prior, block_size, counts)


def _mix_em_n_pat_sorted_adapter(pat, order, Cs, means, sigmas, log_weights,
                                 data, mask, weights, tprec, noise_prior,
                                 mean_prior, block_size, n_iters):
    data_s, perm, counts = order
    return _mix_em_n_pat_sorted_jit(Cs, means, sigmas, log_weights, data_s,
                                    perm, pat[1], weights, tprec, noise_prior,
                                    mean_prior, block_size, counts, n_iters)


def _sharded_mix_em_pat_adapter(fn, pat, Cs, means, sigmas, log_weights, data,
                                mask, weights, tprec, noise_prior, mean_prior,
                                block_size, *n_iters):
    """Reorder the generic EM-step call signature into the sharded pattern
    verbs' (weights, pidx, pats, ...) order (parallel/api.py)."""
    return fn(Cs, means, sigmas, log_weights, data, mask, weights,
              pat[0], pat[1], tprec, noise_prior, mean_prior, block_size,
              *n_iters)


def _sharded_mix_em_pat_sorted_adapter(fn, pat, order, Cs, means, sigmas,
                                       log_weights, data, mask, weights,
                                       tprec, noise_prior, mean_prior,
                                       block_size, *n_iters):
    """Bind the balanced sorted layout (Dataset.pattern_order_sharded) onto
    the sharded sorted-segment mixture verbs (parallel/api.py)."""
    data_s, perm, valid, counts = order
    return fn(Cs, means, sigmas, log_weights, data_s, weights, perm, valid,
              pat[1], tprec, noise_prior, mean_prior, block_size, counts,
              *n_iters)


@functools.partial(jax.jit, static_argnames=("block_size",))
def _mix_llks_pat_jit(Cs, means, sigmas, data, mask, pidx, pats, block_size):
    return mf.mix_llks(Cs, means, sigmas, data, mask,
                       block_size=block_size, pidx=pidx, patterns=pats)


@functools.partial(jax.jit, static_argnames=("block_size",))
def _mix_infer_pat_jit(Cs, means, sigmas, log_weights, data, mask, pidx, pats, block_size):
    return mf.mix_infer(Cs, means, sigmas, log_weights, data, mask,
                        block_size=block_size, pidx=pidx, patterns=pats)


@functools.partial(jax.jit, static_argnames=("block_size", "extrapolate"))
def _mix_smooth_pat_jit(Cs, means, sigmas, log_weights, data, mask, pidx, pats,
                        block_size, extrapolate):
    return mf.mix_smooth(Cs, means, sigmas, log_weights, data, mask,
                         block_size=block_size, extrapolate=extrapolate,
                         pidx=pidx, patterns=pats)


@functools.partial(jax.jit, static_argnames=("block_size",))
def _mix_infer_jit(Cs, means, sigmas, log_weights, data, mask, block_size):
    return mf.mix_infer(
        Cs, means, sigmas, log_weights, data, mask, block_size=block_size
    )


@functools.partial(jax.jit, static_argnames=("block_size", "extrapolate"))
def _mix_smooth_jit(Cs, means, sigmas, log_weights, data, mask, block_size, extrapolate):
    return mf.mix_smooth(
        Cs, means, sigmas, log_weights, data, mask,
        block_size=block_size, extrapolate=extrapolate,
    )


@functools.partial(jax.jit, static_argnames=("n",))
def _mix_sample_jit(Cs, means, sigmas, log_weights, mask_prob, n, key):
    """Ancestral sampling in ONE device program (`mix.rs:176-190` semantics):
    component index from the prior weights, then that component's generative
    model.  The latent/output noise and the Bernoulli mask are drawn once for
    the whole batch (they are component-independent), so peak memory is
    O(N D) — no M full (N, D) datasets.  Padded latent columns of the
    stacked transforms are exactly inert (see _stacked_params)."""
    kc, kz, ke, km = jax.random.split(key, 4)
    M, D, kmax = Cs.shape
    dtype = Cs.dtype
    comp = jax.random.categorical(kc, log_weights, shape=(n,))
    z = jax.random.normal(kz, (n, kmax), dtype=dtype)
    eps = jax.random.normal(ke, (n, D), dtype=dtype)
    proj = jnp.zeros((n, D), dtype=dtype)
    for i in range(M):
        sel = (comp == i)[:, None]
        proj = proj + jnp.where(sel, z @ Cs[i].T, jnp.zeros((), dtype))
    values = proj + means[comp] + sigmas[comp][:, None] * eps
    observed = jax.random.bernoulli(km, 1.0 - mask_prob, (n, D))
    return jnp.where(observed, values, 0.0), observed


@jax.jit
def _log_softmax_jit(x):
    """Max-shifted log-softmax (`mix.rs:14-18`)."""
    m = jnp.max(x, axis=-1, keepdims=True)
    return x - m - jnp.log(jnp.sum(jnp.exp(x - m), axis=-1, keepdims=True))


@jax.jit
def _logsumexp_jit(x):
    """Robust logsumexp (`mix.rs:20-25`)."""
    m = jnp.max(x, axis=-1)
    return m + jnp.log(jnp.sum(jnp.exp(x - m[..., None]), axis=-1))


class PPCAMix:
    """A mixture of PPCA models (`mix.rs:27-347`)."""

    __slots__ = ("_models", "_log_weights", "_output_size")

    def __init__(self, models: List[PPCAModel], log_weights):
        models = list(models)
        if not models:
            raise ValueError("mixture must have at least one component")
        lw = np.asarray(log_weights, dtype=np.float64).reshape(-1)
        if lw.shape[0] != len(models):
            raise ValueError("log_weights length must match number of models")
        sizes = {m.output_size for m in models}
        if len(sizes) != 1:
            raise ValueError(f"Model output sizes are not the same: {[m.output_size for m in models]}")
        self._models = models
        self._output_size = models[0].output_size
        dtype = models[0]._transform.dtype
        self._log_weights = _log_softmax_jit(jnp.asarray(lw, dtype=dtype))

    @staticmethod
    def init(n_models: int, state_size: int, dataset: Dataset, key=None) -> "PPCAMix":
        """n_models random untrained components, uniform weights
        (`mix.rs:76-83`)."""
        key = ensure_key(key)
        keys = jax.random.split(key, n_models)
        return PPCAMix(
            [PPCAModel.init(state_size, dataset, key=k) for k in keys],
            np.zeros(n_models),
        )

    # ------------------------------------------------------------------ #
    # accessors (mix.rs:85-119)

    @property
    def output_size(self) -> int:
        return self._output_size

    @property
    def state_sizes(self) -> List[int]:
        return [m.state_size for m in self._models]

    @property
    def n_parameters(self) -> int:
        """Component parameters plus the M-1 free mixture weights
        (`mix.rs:96-104`)."""
        return sum(m.n_parameters for m in self._models) + len(self._models) - 1

    @property
    def models(self) -> List[PPCAModel]:
        return list(self._models)

    @property
    def log_weights(self) -> np.ndarray:
        return np.asarray(self._log_weights)

    @property
    def weights(self) -> np.ndarray:
        return np.asarray(jnp.exp(self._log_weights))

    def __repr__(self) -> str:
        return f"PPCAMix(n_models={len(self._models)}, state_sizes={self.state_sizes})"

    # ------------------------------------------------------------------ #
    # serialization

    def dump(self) -> bytes:
        arrays = {"log_weights": np.asarray(self._log_weights, dtype=np.float64)}
        for i, m in enumerate(self._models):
            arrays[f"transform_{i}"] = np.asarray(m._transform, dtype=np.float64)
            arrays[f"mean_{i}"] = np.asarray(m._mean, dtype=np.float64)
            arrays[f"isotropic_noise_{i}"] = np.asarray(m.isotropic_noise, dtype=np.float64)
        return dump_bytes("ppca_mix", arrays, {"n_models": len(self._models)})

    @staticmethod
    def load(data: bytes) -> "PPCAMix":
        arrays, meta = load_bytes(data, "ppca_mix")
        n = int(meta["n_models"])
        models = [
            PPCAModel(
                isotropic_noise=float(arrays[f"isotropic_noise_{i}"]),
                transform=arrays[f"transform_{i}"],
                mean=arrays[f"mean_{i}"],
            )
            for i in range(n)
        ]
        return PPCAMix(models, arrays["log_weights"])

    def __getstate__(self):
        return self.dump()

    def __setstate__(self, state):
        other = PPCAMix.load(state)
        self._models = other._models
        self._log_weights = other._log_weights
        self._output_size = other._output_size

    def __reduce__(self):
        return (PPCAMix.load, (self.dump(),))

    # ------------------------------------------------------------------ #
    # likelihood (mix.rs:136-174)

    def _stacked_params(self):
        """(Cs, means, sigmas) stacked over components.  Heterogeneous state
        sizes are zero-padded to max(k): padded latent dimensions are EXACTLY
        inert through the whole fused algebra — the padded Gram block is 0,
        so M gains a sigma^2 I block whose log-det cancels against the
        (d_obs - k) noise term, padded states are 0, padded posterior
        covariance is the prior's I (sliced away on readout), the M-step's
        cross-moment rows for padded columns are 0 so the solve returns 0,
        and tr(G Sigma) gets no padded contribution."""
        kmax = max(m.state_size for m in self._models)
        return (
            jnp.stack([
                jnp.pad(m._transform, ((0, 0), (0, kmax - m.state_size)))
                for m in self._models
            ]),
            jnp.stack([m._mean for m in self._models]),
            jnp.stack([m._isotropic_noise for m in self._models]),
        )

    def _pattern(self, dataset: Dataset):
        """(pidx, patterns) for the mixture's pattern-table path, or None.
        A fully-observed dataset is the trivial single-pattern case — this is
        how dense mixtures get a fast path (the single-model dense path is
        ops/dense_fast.py; mixtures share the table machinery instead).

        Data-axis-sharded datasets are allowed (pattern_info shards pidx
        with the rows; the inference AND EM verbs have *_pat shard_map
        twins in parallel/api.py).  Model-axis meshes are demoted HERE
        (the *_pat verbs carry no model-axis collectives and are not even
        registered for such meshes); pattern_info additionally demotes
        column-sharded and multi-process arrays itself."""
        from ..parallel.mesh import MODEL_AXIS, dataset_mesh

        mesh = dataset_mesh(dataset)
        if (
            mesh is not None
            and MODEL_AXIS in mesh.axis_names
            and mesh.shape[MODEL_AXIS] > 1
        ):
            return None
        return dataset.pattern_info(include_dense=True)

    def _mix_block(self, dataset: Dataset, mesh) -> int:
        from ..parallel.mesh import DATA_AXIS

        n_data = 1 if mesh is None else mesh.shape[DATA_AXIS]
        kmax = max((m.state_size for m in self._models), default=0)
        return block_size_for(
            max(1, dataset.padded_len // (n_data * max(1, len(self._models)))),
            kmax, m=len(self._models),
        )

    def _component_llks(self, dataset: Dataset) -> jnp.ndarray:
        """(N_padded, M) per-component per-sample log-likelihoods, on device
        (padding rows are neutral: all-masked rows have zero llk).

        ONE fused pass over the data for all M components (ops/mix_fused.py);
        the reference makes M passes (`mix.rs:283-288`).  Heterogeneous state
        sizes ride the same pass zero-padded (see _stacked_params)."""
        from ..parallel.mesh import MODEL_AXIS, dataset_mesh

        Cs, means, sigmas = self._stacked_params()
        mesh = dataset_mesh(dataset)
        block = self._mix_block(dataset, mesh)
        with _precision(self._output_size):
            if mesh is None:
                pat = self._pattern(dataset)
                if pat is not None:
                    return _mix_llks_pat_jit(
                        Cs, means, sigmas, dataset.data, dataset.mask, *pat, block
                    )
                return _mix_llks_jit(Cs, means, sigmas, dataset.data, dataset.mask, block)
            from ..parallel.api import fns_for

            use_model = MODEL_AXIS in mesh.axis_names and mesh.shape[MODEL_AXIS] > 1
            fns = fns_for(mesh, use_model)
            pat = self._pattern(dataset)  # None on model-axis meshes
            if pat is not None:
                return fns["mix_llks_pat"](
                    Cs, means, sigmas, dataset.data, dataset.mask, *pat, block
                )
            return fns["mix_llks"](
                Cs, means, sigmas, dataset.data, dataset.mask, block
            )

    def llks(self, dataset: Dataset) -> np.ndarray:
        """Per-sample mixture log-likelihood: logsumexp over components of
        llk + log weight (`mix.rs:147-159`)."""
        per = self._component_llks(dataset)
        return np.asarray(_logsumexp_jit(per + self._log_weights[None, :]))[: len(dataset)]

    def llk(self, dataset: Dataset) -> float:
        """Weighted total mixture log-likelihood (`mix.rs:162-174`)."""
        if dataset.is_empty():
            return 0.0
        per = self._component_llks(dataset)
        mix_llk = _logsumexp_jit(per + self._log_weights[None, :])
        return float(jnp.sum(mix_llk * dataset.weights_dev))

    def infer_cluster(self, dataset: Dataset) -> np.ndarray:
        """(N, M) per-sample *log*-posterior over components — the reference
        returns the log-softmax values despite its doc comment speaking of
        probabilities (`mix.rs:179-189`); we match the code."""
        per = self._component_llks(dataset)
        return np.asarray(_log_softmax_jit(per + self._log_weights[None, :]))[: len(dataset)]

    # ------------------------------------------------------------------ #
    # sampling (mix.rs:121-134)

    def sample(self, dataset_size: int, mask_probability: float, key=None) -> Dataset:
        """Ancestral sampling: component index from the prior weights, then
        that component's generative model — one fused device program with
        O(N D) peak memory (see _mix_sample_jit)."""
        key = ensure_key(key)
        Cs, means, sigmas = self._stacked_params()
        with _precision(self._output_size):
            values, observed = _mix_sample_jit(
                Cs, means, sigmas, self._log_weights,
                float(mask_probability), int(dataset_size), key,
            )
        return Dataset.from_parts(values, observed)

    # ------------------------------------------------------------------ #
    # inference (mix.rs:193-265)

    def uninferred(self, n: int = 1) -> "InferredMaskedMix":
        """The prior mixture posterior: log-weights as responsibilities and
        each component's uninferred batch (`mix.rs:193-202`)."""
        log_post = jnp.broadcast_to(self._log_weights[None, :], (n, len(self._models)))
        return InferredMaskedMix(self, log_post, [m.uninferred(n) for m in self._models])

    def inferred_one(self, log_posterior, inferred: List[InferredMasked]) -> "InferredMaskedMix":
        """Build from raw values (`mix.rs:218-227`)."""
        log_post = jnp.atleast_2d(jnp.asarray(log_posterior))
        return InferredMaskedMix(self, log_post, list(inferred))

    def infer(self, dataset: Dataset) -> "InferredMaskedMix":
        from ..parallel.mesh import MODEL_AXIS, dataset_mesh

        n = len(dataset)
        # ONE fused pass for responsibilities AND every component's
        # posterior (vs the reference's M llks + M infer passes,
        # mix.rs:205-236) — sharded datasets run the identical pass under
        # shard_map (round 3; previously a per-component fallback of M+1
        # device programs).  Heterogeneous state sizes ride the same pass
        # zero-padded; each component's readout slices back to its k.
        mesh = dataset_mesh(dataset)
        Cs, means, sigmas = self._stacked_params()
        block = self._mix_block(dataset, mesh)
        pat = self._pattern(dataset)
        with _precision(self._output_size):
            if mesh is None:
                if pat is not None:
                    log_post, states, covs = _mix_infer_pat_jit(
                        Cs, means, sigmas, self._log_weights,
                        dataset.data, dataset.mask, *pat, block,
                    )
                else:
                    log_post, states, covs = _mix_infer_jit(
                        Cs, means, sigmas, self._log_weights,
                        dataset.data, dataset.mask, block,
                    )
            else:
                from ..parallel.api import fns_for

                use_model = (
                    MODEL_AXIS in mesh.axis_names and mesh.shape[MODEL_AXIS] > 1
                )
                fns = fns_for(mesh, use_model)
                if pat is not None:
                    log_post, states, covs = fns["mix_infer_pat"](
                        Cs, means, sigmas, self._log_weights,
                        dataset.data, dataset.mask, *pat, block,
                    )
                else:
                    log_post, states, covs = fns["mix_infer"](
                        Cs, means, sigmas, self._log_weights,
                        dataset.data, dataset.mask, block,
                    )
        inferred = [
            InferredMasked(m, states[i, :n, : m.state_size],
                           covs[i, :n, : m.state_size, : m.state_size])
            for i, m in enumerate(self._models)
        ]
        return InferredMaskedMix(self, log_post[:n], inferred)

    def _smooth_fused(self, dataset: Dataset, extrapolate: bool):
        from ..parallel.mesh import MODEL_AXIS, dataset_mesh

        mesh = dataset_mesh(dataset)
        Cs, means, sigmas = self._stacked_params()
        block = self._mix_block(dataset, mesh)
        pat = self._pattern(dataset)
        with _precision(self._output_size):
            if mesh is None:
                if pat is not None:
                    out = _mix_smooth_pat_jit(
                        Cs, means, sigmas, self._log_weights,
                        dataset.data, dataset.mask, *pat, block, extrapolate,
                    )
                else:
                    out = _mix_smooth_jit(
                        Cs, means, sigmas, self._log_weights,
                        dataset.data, dataset.mask, block, extrapolate,
                    )
            else:
                from ..parallel.api import fns_for

                use_model = (
                    MODEL_AXIS in mesh.axis_names and mesh.shape[MODEL_AXIS] > 1
                )
                fns = fns_for(mesh, use_model)
                if pat is not None:
                    out = fns["mix_smooth_pat"](
                        Cs, means, sigmas, self._log_weights,
                        dataset.data, dataset.mask, *pat, block, extrapolate,
                    )
                else:
                    out = fns["mix_smooth"](
                        Cs, means, sigmas, self._log_weights,
                        dataset.data, dataset.mask, block, extrapolate,
                    )
        return Dataset.unmasked(out[: len(dataset)])

    def smooth(self, dataset: Dataset) -> Dataset:
        """Posterior-weighted mixture of component smoothings
        (`mix.rs:239-251`); one fused end-to-end pass, sharded or not."""
        return self._smooth_fused(dataset, extrapolate=False)

    def extrapolate(self, dataset: Dataset) -> Dataset:
        """Posterior-weighted mixture of component extrapolations
        (`mix.rs:253-265`); one fused end-to-end pass, sharded or not."""
        return self._smooth_fused(dataset, extrapolate=True)

    # ------------------------------------------------------------------ #
    # EM (mix.rs:267-337)

    def iterate(self, dataset: Dataset) -> "PPCAMix":
        return self.iterate_with_prior(dataset, Prior())

    def iterate_with_prior(self, dataset: Dataset, prior: Prior) -> "PPCAMix":
        """One mixture EM iteration: responsibilities in the log domain, then
        a reweighted inner EM per component (`mix.rs:281-337`)."""
        new_mix, _ = self._iterate_with_llk(dataset, prior)
        return new_mix

    def _iterate_with_llk(self, dataset: Dataset, prior: Prior):
        """Fused mixture EM step returning (new mixture, llk of *this* mixture
        on the dataset) — the responsibilities pass already computes every
        per-component llk, so the dataset llk is free.

        Heterogeneous state sizes ride the same single fused pass
        (ops/mix_fused.py) zero-padded to max(k): padded latent dimensions
        are exactly inert (see _stacked_params), and each new transform is
        sliced back to its component's size (its padded columns come out
        exactly 0 from the block-diagonal M-step solve)."""
        if dataset.is_empty():
            raise ValueError("cannot iterate on an empty dataset")
        return self._iterate_fused(dataset, prior)

    def _iterate_loop(self, dataset: Dataset, prior: Prior):
        """The reference-shaped per-component loop (`mix.rs:281-337`): M llks
        passes then M reweighted inner EMs.  Kept as the independent
        implementation the fused path is tested against."""
        per = self._component_llks(dataset)                      # (N, M)
        joint = per + self._log_weights[None, :]
        llk = float(jnp.sum(_logsumexp_jit(joint) * dataset.weights_dev))
        log_post = _log_softmax_jit(joint)
        log_w_data = jnp.log(dataset.weights_dev)                # -inf for w=0 drops the sample
        new_models: List[PPCAModel] = []
        new_log_weights: List[jnp.ndarray] = []
        for i, model in enumerate(self._models):
            lp = log_w_data + log_post[:, i]
            max_lp = jnp.max(lp)
            # Un-normalized posteriors as weights for numerical stability; one
            # entry is guaranteed to be 1 (mix.rs:310-323).
            unnorm = jnp.exp(lp - max_lp)
            logsum = jnp.log(jnp.sum(unnorm)) + max_lp
            reweighted = dataset.with_weights(unnorm)
            new_models.append(model.iterate_with_prior(reweighted, prior))
            new_log_weights.append(logsum)
        return PPCAMix(new_models, jnp.stack(new_log_weights)), llk

    def _em_dispatch(self, dataset: Dataset, n_variant: bool):
        """Pick the fused mixture EM implementation (single-device / pattern /
        sharded) and the per-device block size; ``n_variant`` selects the
        n-step scan twin of each path."""
        from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, dataset_mesh

        mesh = dataset_mesh(dataset)
        if mesh is None:
            pat = self._pattern(dataset)
            if pat is not None:
                # pattern_order is None for dense datasets (their P=1 table
                # path stays) and when config.pat_sorted_estep is off
                order = dataset.pattern_order()
                if order is not None:
                    adapter = (_mix_em_n_pat_sorted_adapter if n_variant
                               else _mix_em_pat_sorted_adapter)
                    step = functools.partial(adapter, pat, order)
                else:
                    adapter = (_mix_em_n_pat_adapter if n_variant
                               else _mix_em_pat_jit_adapter)
                    step = functools.partial(adapter, pat)
            else:
                step = _mix_em_n_jit if n_variant else _mix_em_jit
            block = block_size_for(
                max(1, dataset.padded_len // max(1, len(self._models))),
                max((m.state_size for m in self._models), default=0),
                m=len(self._models),
            )
        else:
            from ..parallel.api import fns_for

            use_model = MODEL_AXIS in mesh.axis_names and mesh.shape[MODEL_AXIS] > 1
            fns = fns_for(mesh, use_model)
            # _pattern is None on model-axis meshes / multi-process arrays,
            # so the table path only ever rides data-parallel shardings —
            # where it keeps the same M x P speedup as the unsharded EM.
            pat = self._pattern(dataset)
            if pat is not None:
                order = (None if use_model
                         else dataset.pattern_order_sharded())
                if order is not None:
                    base = fns["mix_em_n_pat_sorted" if n_variant
                               else "mix_em_step_pat_sorted"]
                    step = functools.partial(
                        _sharded_mix_em_pat_sorted_adapter, base, pat, order)
                else:
                    base = fns["mix_em_n_pat" if n_variant
                               else "mix_em_step_pat"]
                    step = functools.partial(
                        _sharded_mix_em_pat_adapter, base, pat)
            else:
                step = fns["mix_em_n" if n_variant else "mix_em_step"]
            block = block_size_for(
                max(1, dataset.padded_len
                    // (mesh.shape[DATA_AXIS] * max(1, len(self._models)))),
                max((m.state_size for m in self._models), default=0),
                m=len(self._models),
            )
        return step, block

    def _iterate_fused(self, dataset: Dataset, prior: Prior):
        dtype = self._models[0]._transform.dtype
        Cs, means, sigmas = self._stacked_params()
        step, block = self._em_dispatch(dataset, n_variant=False)
        tprec, noise_prior, mean_prior = prior.device_pieces(dtype)
        with _precision(self._output_size):
            new_Cs, new_means, new_sigmas, new_logw, llk = step(
                Cs, means, sigmas, self._log_weights,
                dataset.data, dataset.mask, dataset.weights_dev,
                tprec, noise_prior, mean_prior, block,
            )
        new_models = [
            PPCAModel._from_params(
                new_Cs[i][:, : m.state_size], new_means[i], new_sigmas[i]
            )
            for i, m in enumerate(self._models)
        ]
        return PPCAMix(new_models, new_logw), float(llk)

    def iterate_n(
        self, dataset: Dataset, n_iters: int, prior: Optional[Prior] = None
    ) -> Tuple["PPCAMix", np.ndarray]:
        """``n_iters`` fused mixture (MAP-)EM iterations in ONE compiled
        program (lax.scan over the parameters — no per-iteration dispatch
        or host sync).  Returns ``(mix, llks)`` with ``llks[i]`` the llk of
        the mixture *before* iteration ``i``.  An extra — the
        reference iterates one step at a time."""
        if dataset.is_empty():
            raise ValueError("cannot iterate on an empty dataset")
        if n_iters <= 0:
            return self, np.zeros((0,))
        if prior is None:
            prior = Prior()
        dtype = self._models[0]._transform.dtype
        Cs, means, sigmas = self._stacked_params()
        step_n, block = self._em_dispatch(dataset, n_variant=True)
        tprec, noise_prior, mean_prior = prior.device_pieces(dtype)
        with _precision(self._output_size):
            new_Cs, new_means, new_sigmas, new_logw, llks = step_n(
                Cs, means, sigmas, self._log_weights,
                dataset.data, dataset.mask, dataset.weights_dev,
                tprec, noise_prior, mean_prior, block, int(n_iters),
            )
        new_models = [
            PPCAModel._from_params(
                new_Cs[i][:, : m.state_size], new_means[i], new_sigmas[i]
            )
            for i, m in enumerate(self._models)
        ]
        return PPCAMix(new_models, new_logw), np.asarray(llks)

    def to_canonical(self) -> "PPCAMix":
        """Map PPCAModel::to_canonical over components (`mix.rs:340-346`)."""
        out = PPCAMix.__new__(PPCAMix)
        out._models = [m.to_canonical() for m in self._models]
        out._log_weights = self._log_weights
        out._output_size = self._output_size
        return out


class InferredMaskedMix:
    """Batch of mixture posteriors (`mix.rs:349-515` /
    `src/python_bindings.rs:713-905`).

    NOTE on ``states()``: the reference's ``InferredMaskedMix::state`` weights
    component states by the *log*-posterior entries directly
    (`mix.rs:374-380`) while every other moment-matched readout uses
    ``exp(log_posterior)``.  SURVEY.md §2 flags this as an apparent bug; we
    implement the mathematically consistent version (exponentiated weights)
    and record the deviation here.
    """

    def __init__(self, mix: PPCAMix, log_posteriors, inferred: List[InferredMasked]):
        self._mix = mix
        self._log_post = log_posteriors        # (N, M)
        self._inferred = inferred              # M × InferredMasked(batch)

    def __len__(self) -> int:
        return int(self._log_post.shape[0])

    def log_posteriors(self) -> np.ndarray:
        return np.asarray(self._log_post)

    def posteriors(self) -> np.ndarray:
        return np.asarray(jnp.exp(self._log_post))

    def sub_states(self) -> List[InferredMasked]:
        return list(self._inferred)

    def _require_equal_state_sizes(self):
        sizes = {inf._states.shape[1] for inf in self._inferred}
        if len(sizes) != 1:
            raise ValueError(
                "moment-matched state readouts require all components to share "
                f"a state size; got {sorted(sizes)}"
            )

    def states(self, *, reference_log_weighting: bool = False) -> np.ndarray:
        """Moment-matched posterior state means (see class note).

        ``reference_log_weighting=True`` reproduces the reference's behavior
        bit-for-bit-in-spirit (`mix.rs:374-380` weights component states by
        the raw *log*-posterior entries instead of their exponentials) for
        users migrating numeric outputs who need the old numbers.  The
        default is the mathematically consistent exp-weighting that every
        other readout uses.
        """
        self._require_equal_state_sizes()
        post = (self._log_post if reference_log_weighting
                else jnp.exp(self._log_post))
        out = sum(
            post[:, i : i + 1] * inf._states for i, inf in enumerate(self._inferred)
        )
        return np.asarray(out)

    def covariances(self) -> List[np.ndarray]:
        """Law-of-total-variance state covariances (`mix.rs:383-394`)."""
        self._require_equal_state_sizes()
        post = jnp.exp(self._log_post)
        mean = sum(post[:, i : i + 1] * inf._states for i, inf in enumerate(self._inferred))
        total = 0.0
        for i, inf in enumerate(self._inferred):
            d = inf._states - mean
            total = total + post[:, i, None, None] * (
                inf._covariances + d[:, :, None] * d[:, None, :]
            )
        return list(np.asarray(total))

    def second_moments(self) -> List[np.ndarray]:
        """Mixture-posterior second moments ``E[s s^T] = sum_i post_i
        (Sigma_i + s_i s_i^T)`` — the mixture twin of
        `ppca_model.rs:437-439`, consistent with ``covariances()``'s
        law-of-total-variance (second moment = covariance + mean mean^T)."""
        self._require_equal_state_sizes()
        post = jnp.exp(self._log_post)
        total = 0.0
        for i, inf in enumerate(self._inferred):
            total = total + post[:, i, None, None] * (
                inf._covariances + inf._states[:, :, None] * inf._states[:, None, :]
            )
        return list(np.asarray(total))

    # -- output-space readouts ------------------------------------------ #

    def _component_smoothed(self) -> List[jnp.ndarray]:
        return [
            inf._states @ m._transform.T + m._mean
            for inf, m in zip(self._inferred, self._mix._models)
        ]

    def smoothed(self, mix: PPCAMix) -> Dataset:
        """Posterior-weighted mixture of component smoothings (`mix.rs:397-404`)."""
        post = jnp.exp(self._log_post)
        with _precision(self._mix.output_size):
            out = sum(post[:, i : i + 1] * sm for i, sm in enumerate(self._component_smoothed()))
        return Dataset.unmasked(out)

    def extrapolated(self, mix: PPCAMix, dataset: Dataset) -> Dataset:
        """(`mix.rs:407-414`)"""
        n = len(dataset)
        post = jnp.exp(self._log_post)
        with _precision(self._mix.output_size):
            out = 0.0
            for i, sm in enumerate(self._component_smoothed()):
                extr = jnp.where(dataset.mask[:n], dataset.data[:n], sm)
                out = out + post[:, i : i + 1] * extr
        return Dataset.unmasked(out)

    def smoothed_covariances(self, mix: PPCAMix) -> List[np.ndarray]:
        """Full (D, D) with between-component spread (`mix.rs:422-435`)."""
        post = jnp.exp(self._log_post)
        sms = self._component_smoothed()
        with _precision(self._mix.output_size):
            mean = sum(post[:, i : i + 1] * sm for i, sm in enumerate(sms))
            total = 0.0
            for i, (inf, m) in enumerate(zip(self._inferred, self._mix._models)):
                from .ppca import _smoothed_cov_full_jit
                cov = _smoothed_cov_full_jit(m._transform, m._isotropic_noise, inf._covariances)
                d = sms[i] - mean
                total = total + post[:, i, None, None] * (cov + d[:, :, None] * d[:, None, :])
        return list(np.asarray(total))

    def smoothed_covariances_diagonal(self, mix: PPCAMix) -> Dataset:
        """(`mix.rs:443-455`)"""
        from .ppca import _smoothed_cov_diag_jit

        post = jnp.exp(self._log_post)
        sms = self._component_smoothed()
        with _precision(self._mix.output_size):
            mean = sum(post[:, i : i + 1] * sm for i, sm in enumerate(sms))
            total = 0.0
            for i, (inf, m) in enumerate(zip(self._inferred, self._mix._models)):
                diag = _smoothed_cov_diag_jit(m._transform, m._isotropic_noise, inf._covariances)
                total = total + post[:, i : i + 1] * (diag + (sms[i] - mean) ** 2)
        return Dataset.unmasked(total)

    def extrapolated_covariances(self, mix: PPCAMix, dataset: Dataset) -> List[np.ndarray]:
        """Full (D, D): per-component *smoothed* covariance plus the spread of
        the extrapolations — matching the reference exactly, which combines
        ``smoothed_covariance`` with extrapolated spreads (`mix.rs:464-477`)."""
        from .ppca import _smoothed_cov_full_jit

        n = len(dataset)
        post = jnp.exp(self._log_post)
        sms = self._component_smoothed()
        with _precision(self._mix.output_size):
            extrs = [jnp.where(dataset.mask[:n], dataset.data[:n], sm) for sm in sms]
            mean = sum(post[:, i : i + 1] * ex for i, ex in enumerate(extrs))
            total = 0.0
            for i, (inf, m) in enumerate(zip(self._inferred, self._mix._models)):
                cov = _smoothed_cov_full_jit(m._transform, m._isotropic_noise, inf._covariances)
                d = extrs[i] - mean
                total = total + post[:, i, None, None] * (cov + d[:, :, None] * d[:, None, :])
        return list(np.asarray(total))

    def extrapolated_covariances_diagonal(self, mix: PPCAMix, dataset: Dataset) -> Dataset:
        """(`mix.rs:485-501`)"""
        from .ppca import _extrapolated_cov_diag_jit

        n = len(dataset)
        post = jnp.exp(self._log_post)
        sms = self._component_smoothed()
        with _precision(self._mix.output_size):
            extrs = [jnp.where(dataset.mask[:n], dataset.data[:n], sm) for sm in sms]
            mean = sum(post[:, i : i + 1] * ex for i, ex in enumerate(extrs))
            total = 0.0
            for i, (inf, m) in enumerate(zip(self._inferred, self._mix._models)):
                diag = _extrapolated_cov_diag_jit(
                    m._transform, m._isotropic_noise, inf._covariances,
                    dataset.mask[:n],
                )
                total = total + post[:, i : i + 1] * (diag + (extrs[i] - mean) ** 2)
        return Dataset.unmasked(total)

    def posterior_sampler(self) -> "PosteriorSamplerMix":
        """(`mix.rs:505-514`)"""
        samplers = [inf.posterior_sampler() for inf in self._inferred]
        return PosteriorSamplerMix(self._log_post, samplers)


class PosteriorSamplerMix:
    """Ancestral batch sampler: component from the per-sample posterior, then
    that component's posterior sampler (`mix.rs:517-532`).  A fresh component
    index is drawn per sample on every ``sample()`` call, matching the
    reference's per-draw ``WeightedIndex`` sampling."""

    def __init__(self, log_posteriors, samplers: List[PosteriorSampler]):
        self._log_post = log_posteriors
        self._samplers = samplers

    def sample(self, key=None) -> Dataset:
        key = ensure_key(key)
        kc, ks = jax.random.split(key)
        comp = jax.random.categorical(kc, self._log_post, axis=-1)
        keys = jax.random.split(ks, len(self._samplers))
        out = None
        for i, (sampler, ki) in enumerate(zip(self._samplers, keys)):
            draw = sampler.sample(key=ki).data
            sel = (comp == i)[:, None]
            out = draw if out is None else jnp.where(sel, draw, out)
        return Dataset.unmasked(out)
