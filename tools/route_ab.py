"""Time whole EM iterations on each SPD route, on the card.

Three comparisons, each through the library's normal verbs
(``PPCAModel.iterate_n``), in the order A, B, B, A so that drift on the
card shows up as a spread rather than as a difference:

* ``kernel`` against ``xla`` (``config.use_pallas``) at the headline shape
  D=1024, k=64, N=1,048,576, 50% missing, f32;
* ``blocked`` against ``xla`` (``config.use_blocked_large_k``) at k=384,
  D=1024, N=65,536, 50% missing;
* the llk of one trained headline model at matmul precision "auto"
  against "highest".

Prints the card's name and power limit first, then one JSON line per
measurement.  Fails when JAX finds no GPU.

    python tools/route_ab.py [--iters 5]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from chip_smoke import make_data  # noqa: E402
from ppca_rs_tpu import Dataset, PPCAModel  # noqa: E402
from ppca_rs_tpu.config import config  # noqa: E402
from ppca_rs_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402


def time_route(ds, k, iters, flag, value):
    """Seconds per EM iteration with ``config.<flag> = value`` (compile
    excluded: the same program runs twice and the second run is timed)."""
    old = getattr(config, flag)
    setattr(config, flag, value)
    jax.clear_caches()  # the route is fixed when a verb is traced
    try:
        model = PPCAModel.init(k, ds, key=jax.random.PRNGKey(3))
        t0 = time.perf_counter()
        warm, _ = model.iterate_n(ds, iters)
        jax.block_until_ready(warm._transform)
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out, llks = model.iterate_n(ds, iters)
        jax.block_until_ready(out._transform)
        dt = (time.perf_counter() - t0) / iters
    finally:
        setattr(config, flag, old)
        jax.clear_caches()
    return dt, compile_s, float(llks[-1])


def ab(name, ds, k, iters, flag, a, b):
    times = {a: [], b: []}
    for value in (a, b, b, a):
        dt, comp, llk = time_route(ds, k, iters, flag, value)
        times[value].append(dt)
        print(json.dumps({"ab": name, flag: value, "s_per_iter": dt,
                          "samples_per_s": len(ds) / dt, "first_run_s": comp,
                          "last_llk": llk}), flush=True)
    print(json.dumps({"ab": name, "summary": {
        str(v): {"median_s_per_iter": float(np.median(t)), "runs": t}
        for v, t in times.items()}}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {jax.devices()[0].platform}")
    enable_compile_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    data, mask = make_data(1, 1 << 20, 1024, 64)
    ds = Dataset.from_parts(data, mask)
    ab("headline D=1024 k=64 N=1M", ds, 64, args.iters, "use_pallas", True, False)

    model, _ = PPCAModel.init(64, ds, key=jax.random.PRNGKey(3)).iterate_n(ds, 10)
    llk = {}
    for p in ("auto", "highest"):
        old = config.matmul_precision
        config.matmul_precision = p
        try:
            llk[p] = model.llk(ds)
        finally:
            config.matmul_precision = old
    print(json.dumps({"precision": llk, "rel_dev_auto_vs_highest":
                      abs(llk["auto"] - llk["highest"]) / abs(llk["highest"])}),
          flush=True)
    del ds, data, mask, model

    data, mask = make_data(2, 1 << 16, 1024, 384)
    ds = Dataset.from_parts(data, mask)
    ab("large k=384 D=1024 N=64k", ds, 384, 2, "use_blocked_large_k", True, False)


if __name__ == "__main__":
    main()
