"""Benchmark: fused EM iteration throughput on the BASELINE workload.

Workload (BASELINE.json): D=1024, state_size=64, 50% missing entries, f32.
Runs on NVIDIA GPUs only (it fails when JAX finds none).  N defaults to 1M
samples per card; with multiple devices the dataset is
sample-sharded over a ('data',) mesh and the same jitted EM runs under
shard_map with psum'd statistics — exactly the library's user-facing path.

Prints ONE JSON line:
  {"metric": "em_estep_samples_per_sec_per_chip", "value": ..., "unit": ...,
   "vs_baseline": ..., "device": {"platform": ..., "kind": ..., "count": ...}}

vs_baseline: the reference publishes no quantitative numbers (BASELINE.md),
so the baseline is an estimated 64-core-CPU throughput of the reference's EM:
a single-core (BLAS pinned to one thread) vectorized NumPy implementation of
the identical blocked E+M step, FROZEN at its measured median (see
FROZEN_NUMPY_SPS) and scaled by 64 (the north-star CPU).  A live pinned
re-measure is logged each run so drift from the frozen constant is visible.
"""

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# Frozen single-core NumPy proxy throughput (samples/s) for the headline
# D=1024/k=64/50%-missing EM step: a labelled single-thread CPU baseline.
# Provenance: measured 2026-08-20 on a shared development host's CPU with
# BLAS pinned to ONE thread (threadpoolctl), median of 9 reps across 3 fresh
# processes: 2636-2682, median 2650 (BASELINE.md "CPU proxy").  Unpinned,
# BLAS-thread contention swung the same measurement 5.1e2-2.4e3, so the
# RATIO uses this frozen constant and the live pinned re-measure below is
# logged only to make drift visible.
FROZEN_NUMPY_SPS = 2650.0


def numpy_em_throughput(D, k, n=2048, block=512, reps=5):
    """Single-core NumPy twin of the fused EM pass; returns samples/sec
    (median of ``reps`` with BLAS pinned to one thread — see
    FROZEN_NUMPY_SPS for why pinning matters on a shared host)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # pragma: no cover - baked into this image
        import contextlib

        threadpool_limits = lambda *_a, **_k: contextlib.nullcontext()
    rng = np.random.default_rng(0)
    C = rng.normal(size=(D, k)).astype(np.float32)
    mean = np.zeros(D, dtype=np.float32)
    sigma2 = 1.0
    data = rng.normal(size=(n, D)).astype(np.float32)
    mask = (rng.random((n, D)) < 0.5).astype(np.float32)
    w = np.ones(n, dtype=np.float32)
    CC = (C[:, :, None] * C[:, None, :]).reshape(D, k * k)

    times = []
    with threadpool_limits(limits=1):
      for _ in range(reps):
        start = time.perf_counter()
        cross = np.zeros((D, k), dtype=np.float32)
        S = np.zeros((D, k * k), dtype=np.float32)
        for i in range(0, n, block):
            d, m, wb = data[i : i + block], mask[i : i + block], w[i : i + block]
            R = m * (d - mean)
            b = R @ C
            M = (m @ CC).reshape(-1, k, k) + sigma2 * np.eye(k, dtype=np.float32)
            L = np.linalg.cholesky(M)
            s = np.linalg.solve(M, b[..., None])[..., 0]
            Sigma = sigma2 * np.linalg.inv(M)
            SM = (s[:, :, None] * s[:, None, :] + Sigma).reshape(-1, k * k)
            cross += (R * wb[:, None]).T @ s
            S += (m * wb[:, None]).T @ SM
            _ = m * (d - s @ C.T - mean)
            _ = np.log(np.diagonal(L, axis1=-2, axis2=-1)).sum()
        np.linalg.solve(S.reshape(D, k, k) + 1e-6 * np.eye(k), cross[..., None])
        times.append(time.perf_counter() - start)
    return n / float(np.median(times))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-per-chip", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--missing", type=float, default=0.5)
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="bfloat16",
                    help="value-STORAGE dtype; math always runs in f32. "
                         "bfloat16 halves the data reads (numerics envelope "
                         "tested in tests/test_statistical.py)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, ".")
    from ppca_rs_tpu import Dataset, PPCAModel
    from ppca_rs_tpu.parallel.mesh import make_mesh, shard_dataset
    from ppca_rs_tpu.utils.compile_cache import enable_compile_cache

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {devices[0].platform}")
    n_chips = len(devices)
    log(f"devices: {devices}; compile cache {enable_compile_cache()}")

    D, k = args.d, args.k
    N = args.n_per_chip * n_chips

    key = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)
    C_true = jax.random.normal(k1, (D, k), dtype=jnp.float32)

    @jax.jit
    def gen(k2, k3, C):
        kz, ke = jax.random.split(k2)
        z = jax.random.normal(kz, (N, k), dtype=jnp.float32)
        eps = jax.random.normal(ke, (N, D), dtype=jnp.float32)
        data = z @ C.T + 0.5 * eps
        mask = jax.random.bernoulli(k3, 1.0 - args.missing, (N, D))
        return jnp.where(mask, data, 0.0), mask

    data, mask = gen(k2, k3, C_true)
    if args.dtype == "bfloat16":
        data = data.astype(jnp.bfloat16)
    dataset = Dataset.from_parts(data, mask)
    if n_chips > 1:
        mesh = make_mesh()
        dataset = shard_dataset(dataset, mesh)
        log(f"sharded over mesh {dict(mesh.shape)}")
    jax.block_until_ready(dataset.data)
    log(f"data ready: {dataset.data.shape} {dataset.dtype}")

    model = PPCAModel.init(k, dataset, key=jax.random.PRNGKey(7))

    # warmup / compile: the whole args.iters-iteration training run is ONE
    # compiled scan (PPCAModel.iterate_n — what PPCATrainer uses in quiet
    # mode), so production pays a single dispatch per training run.
    t0 = time.perf_counter()
    _, llks_w = model.iterate_n(dataset, args.iters)
    log(f"compile+first run: {time.perf_counter() - t0:.2f}s, llk0/N={llks_w[0] / N:.6g}")

    # Best of 2 timed runs of the compiled scan.
    elapsed = float("inf")
    for rep in range(2):
        t0 = time.perf_counter()
        model2, llks = model.iterate_n(dataset, args.iters)
        final_llk = float(llks[-1])          # forces the scan outputs
        jax.block_until_ready(model2._transform)
        elapsed = min(elapsed, time.perf_counter() - t0)
    iters_per_sec = args.iters / elapsed
    samples_per_sec = N * args.iters / elapsed / n_chips
    log(
        f"{args.iters} EM iters (one compiled scan, best of 2 runs) in {elapsed:.3f}s -> "
        f"{iters_per_sec:.3f} iters/s, {samples_per_sec:.3e} samples/s/chip, "
        f"llk[last]/N={final_llk / N:.6g}, sigma={model2.isotropic_noise:.4f}"
    )

    # vs_baseline uses the FROZEN pinned proxy so the ratio is deterministic;
    # the live pinned re-measure is logged only so drift stays visible.
    np_sps = numpy_em_throughput(D, k)
    drift = np_sps / FROZEN_NUMPY_SPS
    if not 0.7 < drift < 1.4:
        log(f"WARNING: live pinned proxy drifted {drift:.2f}x from frozen "
            f"constant — re-measure and update FROZEN_NUMPY_SPS/BASELINE.md")
    baseline = FROZEN_NUMPY_SPS * 64.0
    log(f"numpy single-core pinned: live {np_sps:.3e} samples/s "
        f"(frozen {FROZEN_NUMPY_SPS:.3e}, drift {drift:.2f}x) -> "
        f"64-core baseline {baseline:.3e}")

    print(
        json.dumps(
            {
                "metric": "em_estep_samples_per_sec_per_chip",
                "value": round(samples_per_sec, 1),
                "unit": (
                    f"samples/s/chip (fused EM iter incl. llk, {args.iters}-iter "
                    f"compiled scan, best of 2 runs, D={D}, k={k}, "
                    f"N={N}, {int(args.missing * 100)}% missing, {args.dtype} storage, {n_chips} chip(s))"
                ),
                "vs_baseline": round(samples_per_sec * n_chips / baseline, 3),
                "device": {"platform": devices[0].platform,
                           "kind": devices[0].device_kind, "count": n_chips},
            }
        )
    )


if __name__ == "__main__":
    main()
