"""Convenience train loops — rebuild of `python/ppca_rs/__init__.py:14-118`.

Same API and metric semantics as the reference trainers (llk/aic/bic per
iteration, optional warm start and prior, final ``to_canonical``), with two
upgrades:

* the per-iteration log-likelihood is computed in the *same* fused device
  pass as the EM update (the reference makes two passes over the data per
  iteration: `__init__.py:50-66`), so metric logging is free;
* printing goes through a pluggable ``callback`` (SURVEY.md §5) — default
  behavior prints exactly like the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Literal, Optional

import numpy as np

from .dataset import Dataset
from .models.mix import PPCAMix
from .models.ppca import PPCAModel
from .prior import Prior
from .utils.profiling import trace


@dataclass(frozen=True)
class TrainMetrics:
    """Per-iteration metrics (`python/ppca_rs/__init__.py:14-18`):
    llk and bic are per-sample; aic = 2 (p - llk_total) / n."""

    llk: float
    aic: float
    bic: float

    @staticmethod
    def compute(llk_total: float, n_parameters: int, n_samples: int) -> "TrainMetrics":
        n = n_samples
        return TrainMetrics(
            llk=llk_total / n,
            aic=2.0 * (n_parameters - llk_total) / n,
            bic=(llk_total - n_parameters * float(np.log(n))) / n,
        )


Metric = Literal["aic", "bic", "llk"]
MetricsCallback = Callable[[int, TrainMetrics], None]


def _maybe_checkpoint(model, iteration: int, n_iters: int, path: Optional[str], every: int) -> None:
    """Atomic dump of the in-progress model (resume with
    ``train(start=Model.load(open(path, 'rb').read()), ...)``).  The
    reference's only recovery primitive is re-loading a dumped model
    (SURVEY.md §5); this automates the dumping for long trainings."""
    if path is None:
        return
    if iteration % max(every, 1) != 0 and iteration != n_iters:
        return
    import os

    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(model.dump())
    os.replace(tmp, path)


def _scan_segments(model, iterate_n_fn, n_iters: int,
                   checkpoint_path: Optional[str], checkpoint_every: int):
    """Run n_iters scanned EM iterations; with a checkpoint path, scan in
    checkpoint_every-sized segments and dump atomically at each boundary
    (one compiled program per distinct segment length — at most two)."""
    if checkpoint_path is None:
        return iterate_n_fn(model, n_iters)
    every = max(checkpoint_every, 1)
    done = 0
    while done < n_iters:
        step = min(every, n_iters - done)
        model = iterate_n_fn(model, step)
        done += step
        _maybe_checkpoint(model, done, n_iters, checkpoint_path, every)
    return model


@dataclass
class PPCATrainer:
    """A trainer for a PPCA model over masked data
    (`python/ppca_rs/__init__.py:21-67`)."""

    dataset: Dataset

    def train(
        self,
        *,
        start: Optional[PPCAModel] = None,
        prior: Optional[Prior] = None,
        state_size: int,
        n_iters: int = 10,
        metric: Metric = "aic",
        quiet: bool = False,
        callback: Optional[MetricsCallback] = None,
        key=None,
        profile_dir: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 10,
    ) -> PPCAModel:
        model = start if start is not None else PPCAModel.init(state_size, self.dataset, key=key)
        n = len(self.dataset)

        # Pure-compute training (no per-iteration metrics requested): run the
        # iterations in compiled scans — no per-iteration dispatch or host
        # sync (iterate_n).  With checkpointing, scan in checkpoint_every-
        # sized segments and dump at each segment boundary.
        if quiet and callback is None:
            with trace(profile_dir):
                model = _scan_segments(
                    model, lambda m, k: m.iterate_n(self.dataset, k, prior)[0],
                    n_iters, checkpoint_path, checkpoint_every,
                )
            return model.to_canonical()

        with trace(profile_dir):
            for idx in range(n_iters):
                # Fused: llk of the current model + the EM update in one pass.
                new_model, llk = model._iterate_with_llk(self.dataset, prior)
                if not quiet or callback is not None:
                    metrics = TrainMetrics.compute(llk, model.n_parameters, n)
                    if callback is not None:
                        callback(idx + 1, metrics)
                    if not quiet:
                        print(
                            f"Masked PPCA iteration {idx + 1}: "
                            f"{metric}={getattr(metrics, metric)}"
                        )
                model = new_model
                _maybe_checkpoint(model, idx + 1, n_iters, checkpoint_path, checkpoint_every)

        return model.to_canonical()


@dataclass
class PPCAMixTrainer:
    """A trainer for a PPCA mixture model over masked data
    (`python/ppca_rs/__init__.py:70-118`)."""

    dataset: Dataset

    def train(
        self,
        *,
        start: Optional[PPCAMix] = None,
        prior: Optional[Prior] = None,
        n_models: int,
        state_size: int,
        n_iters: int = 10,
        metric: Metric = "aic",
        quiet: bool = False,
        callback: Optional[MetricsCallback] = None,
        key=None,
        profile_dir: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 10,
    ) -> PPCAMix:
        model = (
            start
            if start is not None
            else PPCAMix.init(n_models, state_size, self.dataset, key=key)
        )
        n = len(self.dataset)

        # Pure-compute training: compiled scans (segmented by checkpoints).
        if quiet and callback is None:
            with trace(profile_dir):
                model = _scan_segments(
                    model, lambda m, k: m.iterate_n(self.dataset, k, prior)[0],
                    n_iters, checkpoint_path, checkpoint_every,
                )
            return model.to_canonical()

        with trace(profile_dir):
            for idx in range(n_iters):
                # Fused: the responsibilities pass of the mixture EM already
                # yields the dataset llk of the current model.
                new_model, llk = model._iterate_with_llk(
                    self.dataset, prior if prior is not None else Prior()
                )
                if not quiet or callback is not None:
                    metrics = TrainMetrics.compute(llk, model.n_parameters, n)
                    if callback is not None:
                        callback(idx + 1, metrics)
                    if not quiet:
                        print(
                            f"Masked PPCA mix iteration {idx + 1}: "
                            f"{metric}={getattr(metrics, metric)}"
                        )
                model = new_model
                _maybe_checkpoint(model, idx + 1, n_iters, checkpoint_path, checkpoint_every)

        return model.to_canonical()
