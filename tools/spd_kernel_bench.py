"""Time the fused SPD E-step kernel against XLA's route on the card.

For each state size, one (B, k, k) batch of masked Grams with the headline
data's conditioning goes through both routes of every variant:

* ``xla``: what ``ops/masked_linalg`` compiles when the router says
  ``xla`` — batched Cholesky, ``cho_solve`` for the state and ``M^{-1}``,
  and the llk / second-moment / trace arithmetic around them;
* ``kernel``: ``ops/kernels.spd_estep``.

It prints one JSON line per (k, variant) with the time per call of each
route (median of three windows of back-to-back calls, one sync per window),
the kernel's largest deviation from the XLA route at
``precision="highest"``, and the M-step row solve (``(S + lam I) x =
cross`` at D = 1024) both ways.  The first line is the card's name and
power limit.  Fails when JAX finds no GPU.

    python tools/spd_kernel_bench.py [--batch 8192] [--ks 32,64,128] [--reps 20]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.scipy.linalg import cho_solve  # noqa: E402

from ppca_rs_tpu.ops import kernels  # noqa: E402
from ppca_rs_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

LN_2PI = kernels.LN_2PI


def xla_estep(G, b, rnorm, d_obs, sigma, want):
    """The XLA route's arithmetic for one block (masked_linalg.block_*)."""
    k = G.shape[-1]
    s2 = sigma * sigma
    M = G + s2 * jnp.eye(k, dtype=G.dtype)
    L = jnp.linalg.cholesky(M)
    s = cho_solve((L, True), b[..., None])[..., 0]
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
    quad = (rnorm - jnp.sum(b * s, axis=-1)) / s2
    llk = -0.5 * (quad + logdet + jnp.log(s2) * (d_obs - k) + LN_2PI * d_obs)
    if want == "llk":
        return llk
    if want == "states":
        return s, llk
    eye = jnp.broadcast_to(jnp.eye(k, dtype=G.dtype), M.shape)
    Sigma = s2 * cho_solve((L, True), eye)
    if want == "infer":
        return s, Sigma, llk
    SM = s[:, :, None] * s[:, None, :] + Sigma
    sq = jnp.sum(G * Sigma, axis=(-1, -2))
    return s, SM, llk, sq


def make_block(key, B, k, D=1024, obs=0.5):
    """Masked Grams of a random D x k loading at 50% missingness, with
    sigma chosen so cond(M) is about 2e3, like the headline data's."""
    k1, k2, k3 = jax.random.split(key, 3)
    C = jax.random.normal(k1, (D, k), jnp.float32) / np.sqrt(D)
    mask = (jax.random.uniform(k2, (B, D)) < obs).astype(jnp.float32)
    CC = (C[:, :, None] * C[:, None, :]).reshape(D, k * k)
    G = jnp.matmul(mask, CC, precision="highest").reshape(B, k, k)
    b = jax.random.normal(k3, (B, k), jnp.float32)
    rnorm = jnp.sum(b * b, axis=-1) * 4.0 + float(D)
    d_obs = jnp.sum(mask, axis=-1)
    lam_max = float(jnp.max(jnp.linalg.eigvalsh(G[:8])))
    sigma = jnp.float32(np.sqrt(lam_max / 2e3))
    return G, b, rnorm, d_obs, sigma


def timeit(fn, args, reps):
    """Median over 3 windows of ``reps`` back-to-back calls (one sync per
    window, so host dispatch overlaps the device work)."""
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            res = fn(*args)
        jax.block_until_ready(res)
        ts.append((time.perf_counter() - t0) / reps)
    return float(np.median(ts)), out


def rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def device_ops(trace_dir):
    """(name, launches, total ms) of every GPU operation in a trace."""
    import glob

    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "plugins/profile/*/*.xplane.pb")))[-1]
    agg = {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "Stream" not in line.name:
                continue
            for ev in line.events:
                n, t = agg.get(ev.name, (0, 0.0))
                agg[ev.name] = (n + 1, t + ev.duration_ns / 1e6)
    return sorted(((k, n, t) for k, (n, t) in agg.items()), key=lambda r: -r[2])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--ks", default="32,64,128")
    ap.add_argument("--wants", default="llk,states,fullt,infer")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--trace", default="",
                    help="trace one fullt call of each route at k=64 here")
    args = ap.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {dev.platform}")
    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    key = jax.random.PRNGKey(0)
    if args.trace:
        blk = make_block(key, args.batch, 64)
        routes = {
            "xla": jax.jit(lambda *a: xla_estep(*a, "fullt")),
            "kernel": jax.jit(lambda *a: kernels.spd_estep(*a, want="fullt")),
        }
        for route, fn in routes.items():
            jax.block_until_ready(fn(*blk))
            d = os.path.join(args.trace, route)
            with jax.profiler.trace(d):
                jax.block_until_ready(fn(*blk))
            for name, n, ms in device_ops(d)[:12]:
                print(json.dumps({"trace": route, "op": name[:80],
                                  "launches": n, "ms": ms}), flush=True)
    for k in (int(x) for x in args.ks.split(",")):
        G, b, rnorm, d_obs, sigma = make_block(key, args.batch, k)
        for want in args.wants.split(","):
            with jax.default_matmul_precision("highest"):
                xla_fn = jax.jit(lambda *a, w=want: xla_estep(*a, w))
                t_xla, ref = timeit(xla_fn, (G, b, rnorm, d_obs, sigma), args.reps)
            ker_fn = jax.jit(lambda *a, w=want: kernels.spd_estep(*a, want=w))
            t_ker, got = timeit(ker_fn, (G, b, rnorm, d_obs, sigma), args.reps)
            ref = ref if isinstance(ref, tuple) else (ref,)
            got = got if isinstance(got, tuple) else (got,)
            errs = [rel_err(g, r) for g, r in zip(got, ref)]
            print(json.dumps({
                "k": k, "batch": args.batch, "want": want,
                "xla_ms": t_xla * 1e3, "kernel_ms": t_ker * 1e3,
                "speedup": t_xla / t_ker, "max_rel_err": errs,
            }), flush=True)
        # M-step row solve at D = 1024: (S + lam I) x = cross
        D = 1024
        S = jnp.einsum("bij,bkj->bik", G[:D], G[:D]) / args.batch + 1e-3 * jnp.eye(k)
        cross = b[:D]
        lam = jnp.float32(0.0)
        with jax.default_matmul_precision("highest"):
            solve = jax.jit(lambda S, c, lam: jnp.linalg.solve(
                S + lam * jnp.eye(k, dtype=S.dtype), c[..., None])[..., 0])
            t_xla, ref = timeit(solve, (S, cross, lam), args.reps)
        zeros = jnp.zeros((D,), jnp.float32)
        rows = jax.jit(lambda S, c, lam: kernels.spd_estep(
            S, c, zeros, zeros, jnp.sqrt(lam), want="states")[0])
        t_ker, got = timeit(rows, (S, cross, lam), args.reps)
        print(json.dumps({
            "k": k, "rows": D, "want": "rows_solve", "xla_ms": t_xla * 1e3,
            "kernel_ms": t_ker * 1e3, "speedup": t_xla / t_ker,
            "max_rel_err": [rel_err(got, ref)],
        }), flush=True)


if __name__ == "__main__":
    main()
