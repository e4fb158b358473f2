"""ppca_rs_tpu — a Probabilistic PCA framework for accelerators, in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
viodotcom/ppca_rs: PPCA with per-entry missing-data masks, Bayesian priors,
mixture models, per-sample weights, posterior uncertainty quantification,
DataFrame adapters, and full serialization — redesigned for accelerators
(mask-weighted dense algebra on large matmuls, a fused SPD kernel for the
per-sample factorizations, SPMD sharding over device meshes) rather than
translated from the reference's Rust/rayon design.
"""

from .config import config
from .dataset import Dataset, DatasetChunks
from .prior import Prior
from .models.ppca import InferredMasked, PosteriorSampler, PPCAModel
from .models.mix import InferredMaskedMix, PosteriorSamplerMix, PPCAMix
from .trainer import PPCAMixTrainer, PPCATrainer, TrainMetrics
from .streaming import (StreamingPPCAMixTrainer, StreamingPPCATrainer,
                        iterate_mix_streamed, iterate_streamed)
from .adapters import DataFrameAdapter, DataFrameAdapterDescription
from .utils.rng import seed

__version__ = "0.1.0"

__all__ = [
    "Dataset",
    "DatasetChunks",
    "Prior",
    "PPCAModel",
    "InferredMasked",
    "PosteriorSampler",
    "PPCAMix",
    "InferredMaskedMix",
    "PosteriorSamplerMix",
    "PPCATrainer",
    "PPCAMixTrainer",
    "StreamingPPCAMixTrainer",
    "StreamingPPCATrainer",
    "iterate_mix_streamed",
    "iterate_streamed",
    "TrainMetrics",
    "DataFrameAdapter",
    "DataFrameAdapterDescription",
    "config",
    "seed",
    "__version__",
]
