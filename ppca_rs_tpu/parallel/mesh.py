"""Device mesh construction and dataset sharding.

The reference's parallelism layer is rayon work-stealing over shared memory
(SURVEY.md §2.5).  The equivalent here is SPMD over a 2D device mesh:

* ``data`` axis — samples (N) are sharded; EM sufficient statistics are
  psum-reduced across devices (this replaces every rayon ``par_iter().reduce``:
  `ppca_model.rs:281-293,328-358`, `dataset.rs:208-214`).
* ``model`` axis — optional tensor-parallel sharding of the output dimension
  D (rows of C, mean, and columns of the data).  The only cross-shard
  communication in the E-step is a psum of the tiny (block, k) and
  (block, k^2) partials; all D-indexed M-step statistics stay local.

``shard_dataset`` pads N up to a multiple of the data-axis size with neutral
rows (all-masked, zero-weight — exactly invisible to every reduction) and
places the arrays with ``NamedSharding``; everything downstream dispatches on
the arrays' sharding automatically.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..dataset import Dataset

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(data: Optional[int] = None, model: int = 1, devices=None) -> Mesh:
    """Build a ('data', 'model') mesh.  By default all devices go on the data
    axis; pass ``model=M`` to carve out a tensor-parallel axis for very large
    output dimensions."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    dev_array = np.array(devices[: data * model]).reshape(data, model)
    return Mesh(dev_array, (DATA_AXIS, MODEL_AXIS))


def shard_dataset(dataset: Dataset, mesh: Mesh) -> Dataset:
    """Place a dataset on the mesh: rows sharded over the data axis (padded
    with neutral rows to divide evenly), columns over the model axis (the
    output dimension must divide the model-axis size)."""
    n = len(dataset)
    n_data = mesh.shape[DATA_AXIS]
    n_model = mesh.shape[MODEL_AXIS]
    d = dataset.data.shape[1]
    if d % n_model != 0:
        raise ValueError(
            f"output_size {d} must be divisible by the model axis size {n_model}"
        )
    pad = (-n) % n_data
    data, mask, weights = dataset.data[:n], dataset.mask[:n], dataset.weights_dev[:n]
    if pad:
        import jax.numpy as jnp

        data = jnp.pad(data, ((0, pad), (0, 0)))
        mask = jnp.pad(mask, ((0, pad), (0, 0)))
        weights = jnp.pad(weights, (0, pad))
    row_sharding = NamedSharding(mesh, P(DATA_AXIS, MODEL_AXIS))
    w_sharding = NamedSharding(mesh, P(DATA_AXIS))
    return Dataset.from_parts(
        jax.device_put(data, row_sharding),
        jax.device_put(mask, row_sharding),
        jax.device_put(weights, w_sharding),
        n_real=n if pad else None,
    )


def dataset_mesh(dataset: Dataset) -> Optional[Mesh]:
    """The mesh a dataset is sharded over, or None for single-device data."""
    sharding = getattr(dataset.data, "sharding", None)
    if isinstance(sharding, NamedSharding) and sharding.mesh.size > 1:
        mesh = sharding.mesh
        if DATA_AXIS in mesh.axis_names:
            return mesh
    return None
