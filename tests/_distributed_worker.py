"""Worker process for tests/test_distributed.py.

Invoked as: python _distributed_worker.py <process_id> <coordinator_port>

Two of these form a jax.distributed CPU job (4 virtual devices each, 8
global).  Each worker holds HALF of a deterministic dataset, assembles the
global sharded Dataset with parallel.distributed.shard_dataset_local, runs
3 EM iterations + a final llk through the public API, and prints the
resulting parameters as one JSON line for the parent to compare against a
single-process reference run.
"""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax

jax.config.update("jax_enable_x64", True)  # match the parent's test config

import numpy as np

from ppca_rs_tpu import Dataset, PPCAMix, PPCAModel
from ppca_rs_tpu.parallel import distributed, make_mesh


def make_global_data(seed=0, n=256, d=16):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, d))
    data[rng.random((n, d)) < 0.3] = np.nan
    weights = rng.random(n) + 0.5
    return data, weights


def make_patterned_data(seed=1, n=256, d=16, p=4):
    """Masks drawn from a small pattern pool — the collective
    detect_patterns() fixture (same data on every process)."""
    rng = np.random.default_rng(seed)
    pats = rng.random((p, d)) < 0.7
    pidx = rng.integers(0, p, size=n)
    data = rng.normal(size=(n, d))
    data[~pats[pidx]] = np.nan
    return data


def main():
    pid = int(sys.argv[1])
    port = int(sys.argv[2])
    distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid
    )
    assert jax.process_count() == 2
    assert len(jax.devices()) == 8

    data, weights = make_global_data()
    half = data.shape[0] // 2
    lo, hi = pid * half, (pid + 1) * half
    local = Dataset(data[lo:hi], weights=weights[lo:hi])

    mesh = make_mesh()  # all 8 global devices on the data axis
    ds = distributed.shard_dataset_local(local, mesh)
    assert distributed.is_initialized()

    model = PPCAModel.init(4, ds, key=jax.random.key(7))
    for _ in range(3):
        model = model.iterate(ds)
    llk = float(model.llk(ds))

    # Phase 2: COLLECTIVE pattern detection on a structured-missingness
    # dataset (Dataset.detect_patterns is a collective; every process calls
    # it here, at the same point) followed by pattern-fast-path EM.
    pdata = make_patterned_data()
    half2 = pdata.shape[0] // 2
    local2 = Dataset(pdata[pid * half2 : (pid + 1) * half2])
    ds2 = distributed.shard_dataset_local(local2, mesh)
    # A lazy pattern_info() first (as any pre-detection verb would trigger):
    # it must demote WITHOUT caching, so the explicit collective
    # detect_patterns() below still runs (regression: a cached False made it
    # a permanent no-op).
    assert ds2.pattern_info() is None
    info = ds2.detect_patterns()
    assert info is not None, "collective pattern detection demoted"
    n_patterns = int(info[1].shape[0])
    assert ds2.pattern_info() is info  # cached; later calls are host-local
    model2 = PPCAModel.init(3, ds2, key=jax.random.key(9))
    for _ in range(2):
        model2 = model2.iterate(ds2)
    llk2 = float(model2.llk(ds2))

    # Phase 3: a FULLY-OBSERVED multi-process dataset.  A lazy
    # pattern_info(include_dense=True) (what the mixture path triggers)
    # must demote to None BEFORE probing all_observed — the dense branch
    # used to run first and cache process-local unsharded arrays as the
    # pattern table (and launch the all_observed reduction from a
    # host-local lazy call).  detect_patterns(include_dense=True) is the
    # collective way and must return the sharding-pinned dense table.
    dense = np.asarray(make_global_data(seed=5)[0])
    dense = np.where(np.isnan(dense), 0.0, dense)
    local3 = Dataset(dense[pid * half : (pid + 1) * half])
    ds3 = distributed.shard_dataset_local(local3, mesh)
    assert ds3.pattern_info(include_dense=True) is None
    info3 = ds3.detect_patterns(include_dense=True)
    assert info3 is not None and int(info3[1].shape[0]) == 1
    assert len(info3[0].sharding.device_set) == 8  # globally sharded pidx

    print(json.dumps({
        "llk": llk,
        "transform": np.asarray(model.transform).tolist(),
        "mean": np.asarray(model.mean).tolist(),
        "sigma": float(model.isotropic_noise),
        "llk_pat": llk2,
        "n_patterns": n_patterns,
        "transform_pat": np.asarray(model2.transform).tolist(),
    }), flush=True)


if __name__ == "__main__":
    main()
