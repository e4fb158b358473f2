"""Multi-host (multi-process) initialization.

The reference is a single-process shared-memory library (SURVEY.md §2.5);
this rebuild scales across hosts with `jax.distributed`: each host owns its
local devices, `make_mesh` spans the global device list, and the EM's psum
reductions are the only cross-device traffic besides data loading.  This
module is the thin, standard glue — nothing framework-
specific is needed beyond sharding the dataset with `shard_dataset`, because
the sufficient statistics the EM exchanges are tiny (D x k, D x k^2 per-shard
partials; see ops/masked_linalg.EMStats).

Typical multi-host driver::

    from ppca_rs_tpu.parallel import distributed, make_mesh, shard_dataset

    distributed.initialize("host0:1234", num_processes=2, process_id=rank)
    mesh = make_mesh()                        # global ('data', 'model') mesh
    dataset = shard_dataset(local_dataset, mesh)
    model = PPCATrainer(dataset).train(state_size=..., n_iters=...)

Each process should construct its dataset from its local slice of samples;
`jax.make_array_from_process_local_data` is the escape hatch for fully
host-local loading.
"""

from __future__ import annotations

from typing import Optional

import jax


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> None:
    """Initialize `jax.distributed`.  On GPU hosts pass the coordinator
    address and the process layout explicitly; nothing detects a cluster
    from the environment there."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )


def is_initialized() -> bool:
    try:
        return jax.process_count() > 1 or jax._src.distributed.global_state.client is not None
    except Exception:
        return False


def shard_dataset_local(dataset, mesh):
    """Assemble a globally data-sharded Dataset from THIS process's rows.

    The multi-process twin of :func:`parallel.shard_dataset`: in a
    `jax.distributed` job each process loads only its own samples and calls
    this with the global mesh; the global array is stitched together with
    ``jax.make_array_from_process_local_data`` (rows over the ``data``
    axis, columns over ``model``).  Tested by tests/test_distributed.py
    (2-process CPU job asserting EM/llk equality vs single-process).

    Every process must end up contributing equally-shaped shards, so local
    rows are padded up to the per-process maximum with neutral samples
    (all-masked, zero-weight — invisible to every reduction; the same
    invariant shard_dataset relies on).  Because that padding sits at the
    end of EACH process chunk (not the end of the global array), per-sample
    readouts (``llks``/``infer``/...) on such a dataset include the neutral
    rows in process-concatenated order; training, ``llk`` totals and all
    EM statistics are unaffected.
    """
    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..dataset import Dataset
    from .mesh import DATA_AXIS, MODEL_AXIS

    n_local = len(dataset)
    n_data = mesh.shape[DATA_AXIS]
    n_model = mesh.shape[MODEL_AXIS]
    d = dataset.data.shape[1]
    if d % n_model:
        raise ValueError(
            f"output_size {d} must be divisible by the model axis size {n_model}"
        )
    n_proc = jax.process_count()
    if n_data % n_proc:
        raise ValueError(
            f"data axis size {n_data} must be divisible by process count {n_proc}"
        )
    local_devices = n_data // n_proc
    counts = np.asarray(multihost_utils.process_allgather(np.int64(n_local)))
    per_proc = -(-int(counts.max()) // local_devices) * local_devices
    pad = per_proc - n_local

    data = np.asarray(dataset.data)
    mask = np.asarray(dataset.mask)
    weights = np.asarray(dataset.weights_dev)
    if pad:
        data = np.pad(data, ((0, pad), (0, 0)))
        mask = np.pad(mask, ((0, pad), (0, 0)))
        weights = np.pad(weights, (0, pad))

    row_sharding = NamedSharding(mesh, P(DATA_AXIS, MODEL_AXIS))
    w_sharding = NamedSharding(mesh, P(DATA_AXIS))
    n_global = per_proc * n_proc
    return Dataset.from_parts(
        jax.make_array_from_process_local_data(row_sharding, data, (n_global, d)),
        jax.make_array_from_process_local_data(row_sharding, mask, (n_global, d)),
        jax.make_array_from_process_local_data(w_sharding, weights, (n_global,)),
    )
