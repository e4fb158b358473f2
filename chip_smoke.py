"""Smoke run of ppca_rs_tpu on one NVIDIA GPU: the main path at full size.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the sharded path on four cards only

Phases (one process, one card):

1. device — JAX must see a GPU; there is no CPU fallback.
2. kernel parity — every variant of the fused SPD E-step kernel, compiled
   for the card, at B = 8192 and k in {13, 64, 128}, against the plain XLA
   route of ops/masked_linalg on the same card at precision "highest".
3. main path — D=1024, k=64, N=1,048,576, 50% missing, f32: 10 EM
   iterations through ``PPCATrainer``; the first iteration against the XLA
   route, one EM step on a 4096-row slice against the f64 NumPy reference
   (tests/reference_impl.py); then llk, infer, extrapolate and the
   posterior sampler on the trained model.
4. other routed paths — an 8-component mixture (D=512, k=32), structured
   masks (P=32) through the sorted pattern path, fully observed data, k=384
   through the large-k route, and the streaming trainer over host chunks.

``--four-cards`` runs only the sharded path: D=1024, k=64, N=4M on a
("data",) mesh of four cards and on a 2x2 data x model mesh, each against
the same data on one card.

Every phase raises on failure, so the exit code is non-zero and the last
line is not printed.  On success the last line is one JSON object with the
device JAX reports.

Tolerances, each with its reason:

* llk: 1e-4 relative.  An f32 Cholesky of M = sigma^2 I + G at the data's
  conditioning (about 2e3) loses about 1e-4 of relative accuracy, and the
  llk is a sum of such terms.
* states, Sigma, SM, sq: 1e-3 of the reference's max-abs.  They are
  solves with M, so they carry the condition number times f32 epsilon
  (2e3 * 6e-8 ~ 1e-4) with headroom for the two routes' different
  summation orders.
* model parameters after one EM step against f64: 2e-3 of max-abs (the
  M-step solves a second, less well-conditioned system per row).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ppca_rs_tpu import (  # noqa: E402
    Dataset,
    PPCAMix,
    PPCAMixTrainer,
    PPCAModel,
    PPCATrainer,
    StreamingPPCATrainer,
)
from ppca_rs_tpu.config import config  # noqa: E402
from ppca_rs_tpu.ops import kernels, masked_linalg as ml  # noqa: E402
from ppca_rs_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

#: Problem sizes of each phase (the headline deployment and its cuts).
SIZES = {
    "parity_batch": 8192, "parity_ks": (13, 64, 128), "parity_d": 1024,
    "main": dict(n=1 << 20, d=1024, k=64, iters=10),
    "ref_rows": 4096, "readout_rows": 1 << 18,
    "mix": dict(n=1 << 18, d=512, k=32, m=8, iters=3),
    "pattern": dict(n=1 << 18, d=1024, k=64, p=32, iters=3),
    "dense": dict(n=1 << 18, d=1024, k=64, iters=3),
    "large_k": dict(n=1 << 15, d=1024, k=384, iters=2),
    "stream": dict(n=1 << 16, d=1024, k=64, chunks=4, iters=3),
    "four": dict(n=1 << 22, d=1024, k=64, iters=3, pattern_n=1 << 20),
}

LLK_RTOL = 1e-4
SOLVE_RTOL = 1e-3
PARAM_RTOL = 2e-3


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Times a phase and prints it; exceptions propagate."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"   {self.name}: ok in {time.perf_counter() - self.t0:.1f} s")
        return False


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


class precision:
    """Run the model verbs at a given matmul precision (config)."""

    def __init__(self, p: str):
        self.p = p

    def __enter__(self):
        self.old = config.matmul_precision
        config.matmul_precision = self.p

    def __exit__(self, *exc):
        config.matmul_precision = self.old
        return False


class xla_route:
    """Send every SPD factorization to XLA (config.use_pallas off).  The
    route is fixed when a verb is traced, so compiled programs are dropped
    on the way in and out."""

    def __enter__(self):
        self.old = config.use_pallas
        config.use_pallas = False
        jax.clear_caches()

    def __exit__(self, *exc):
        config.use_pallas = self.old
        jax.clear_caches()
        return False


def make_data(seed: int, n: int, d: int, k: int, obs: float = 0.5,
              noise: float = 0.5, patterns: int = 0):
    """Low-rank data plus noise, generated on the device from ``seed``:
    ``y = W z + mu + noise * e`` with a random mask (``obs`` observed) or,
    with ``patterns`` > 0, masks drawn from that many random patterns."""
    kw, kz, ke, km, kp, kmu = jax.random.split(jax.random.PRNGKey(seed), 6)

    @jax.jit
    def gen():
        W = jax.random.normal(kw, (d, k), jnp.float32) / np.sqrt(k)
        mu = jax.random.normal(kmu, (d,), jnp.float32)
        z = jax.random.normal(kz, (n, k), jnp.float32)
        y = jnp.matmul(z, W.T, precision="highest") + mu
        y = y + noise * jax.random.normal(ke, (n, d), jnp.float32)
        if patterns:
            pats = jax.random.uniform(kp, (patterns, d)) < obs
            mask = pats[jax.random.randint(km, (n,), 0, patterns)]
        else:
            mask = jax.random.uniform(km, (n, d)) < obs
        return jnp.where(mask, y, 0.0), mask

    data, mask = gen()
    return data, mask


def llk_trace_train(ds, **kw):
    """Train through PPCATrainer, collecting the per-iteration llk."""
    trace = []
    model = PPCATrainer(ds).train(
        quiet=True, callback=lambda i, m: trace.append(m.llk), **kw)
    return model, np.asarray(trace)


def check_monotone(trace, what: str) -> None:
    trace = np.asarray(trace, np.float64)
    check(bool(np.all(np.isfinite(trace))), f"{what}: non-finite llk {trace}")
    # f32 noise: each step may lose a few ulps of the per-sample llk
    slack = 1e-5 * np.maximum(np.abs(trace[:-1]), 1.0)
    check(bool(np.all(np.diff(trace) >= -slack)), f"{what}: llk decreased {trace}")


# ---------------------------------------------------------------- phases


def phase_device():
    with Phase("device"):
        dev = jax.devices()[0]
        check(dev.platform == "gpu", f"JAX found no GPU (platform {dev.platform})")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        log(smi)
        log(f"jax {jax.__version__}, devices {jax.devices()}")
        log(f"compile cache: {enable_compile_cache()}")
        return dev


def phase_kernel_parity():
    """Each kernel variant against the XLA route on the same block."""
    B, D = SIZES["parity_batch"], SIZES["parity_d"]
    for k in SIZES["parity_ks"]:
        with Phase(f"kernel parity k={k}"):
            data, mask = make_data(100 + k, B, D, k)
            key = jax.random.PRNGKey(k)
            C = jax.random.normal(key, (D, k), jnp.float32) / np.sqrt(k)
            mean = jnp.zeros((D,), jnp.float32)
            sigma = jnp.float32(0.5)
            CC = ml.outer_flat(C)
            mf = mask.astype(jnp.float32)

            @jax.jit
            def reference(C, CC, data, mf):
                with jax.default_matmul_precision("highest"):
                    post = ml.block_posterior(C, CC, mean, sigma, data, mf)
                    Sigma = ml.block_covariances(post, sigma)
                    llk = ml.block_llk(post, sigma, k)
                    s = post.states
                    SM = s[:, :, None] * s[:, None, :] + Sigma
                    sq = jnp.sum(post.G_local.reshape(-1, k, k) * Sigma, axis=(1, 2))
                return s, Sigma, SM, llk, sq

            @jax.jit
            def kernel(C, CC, data, mf):
                with jax.default_matmul_precision("highest"):
                    return {w: ml._kernel_block(C, CC, mean, sigma, data, mf, w)[-1]
                            for w in kernels.WANTS}

            s, Sigma, SM, llk, sq = reference(C, CC, data, mf)
            got = kernel(C, CC, data, mf)
            ref = {"s": s, "Sigma": Sigma, "SM": SM, "llk": llk, "sq": sq}
            names = {"llk": ("llk",), "states": ("s", "llk"),
                     "fullt": ("s", "SM", "llk", "sq"), "infer": ("s", "Sigma", "llk")}
            for want, outs in got.items():
                outs = outs if isinstance(outs, tuple) else (outs,)
                for name, val in zip(names[want], outs):
                    err = rel(val, ref[name])
                    tol = LLK_RTOL if name == "llk" else SOLVE_RTOL
                    log(f"   k={k} {want}.{name}: rel err {err:.2e} (tol {tol:.0e})")
                    check(err <= tol, f"kernel {want}.{name} at k={k}: {err}")
            # the M-step row solve through the states variant
            rows = min(D, B)
            S = jnp.einsum("bi,bj->bij", s[:rows], s[:rows]) + Sigma[:rows]
            cross = jax.random.normal(key, (rows, k), jnp.float32)
            sol = jax.jit(ml._kernel_rows_solve)(S, cross, 0.0)
            with jax.default_matmul_precision("highest"):
                ref_sol = jnp.linalg.solve(S, cross[..., None])[..., 0]
            err = rel(sol, ref_sol)
            log(f"   k={k} rows solve: rel err {err:.2e} (tol {SOLVE_RTOL:.0e})")
            check(err <= SOLVE_RTOL, f"kernel rows solve at k={k}: {err}")
            del data, mask, mf


def phase_main_path():
    sz = SIZES["main"]
    n, d, k = sz["n"], sz["d"], sz["k"]
    with Phase(f"main path data N={n} D={d}"):
        data, mask = make_data(1, n, d, k)
        ds = Dataset.from_parts(data, mask)
        jax.block_until_ready(ds.data)
        log(f"   data {data.nbytes / 1e9:.2f} GB + mask {mask.nbytes / 1e9:.2f} GB; "
            f"route {ml.spd_route(k, jnp.float32, 'fullt', False)}")
    model0 = PPCAModel.init(k, ds, key=jax.random.PRNGKey(2))

    with Phase("first iteration against the XLA route (highest)"):
        with precision("highest"):
            llk0 = model0.llk(ds)
            llk1 = model0.iterate(ds).llk(ds)
            with xla_route():
                llk0_x = model0.llk(ds)
                llk1_x = model0.iterate(ds).llk(ds)
        for name, a, b in (("llk before", llk0, llk0_x), ("llk after", llk1, llk1_x)):
            err = abs(a - b) / abs(b)
            log(f"   {name}: kernel {a:.6f} xla {b:.6f} rel {err:.2e}")
            check(err <= LLK_RTOL, f"first iteration {name}: {err}")
        llk1_auto = model0.iterate(ds).llk(ds)
        log(f"   llk after one iteration at precision 'auto': {llk1_auto:.6f} "
            f"(rel to highest {abs(llk1_auto - llk1) / abs(llk1):.2e})")

    with Phase(f"train {sz['iters']} EM iterations (PPCATrainer)"):
        t0 = time.perf_counter()
        model, trace = llk_trace_train(ds, state_size=k, n_iters=sz["iters"],
                                       key=jax.random.PRNGKey(2))
        jax.block_until_ready(model._transform)
        log(f"   llk/sample trace {np.array2string(trace, precision=6)}")
        log(f"   {sz['iters']} iterations incl. compile: {time.perf_counter() - t0:.2f} s")
        check_monotone(trace, "main path")

    with Phase(f"one EM step on {SIZES['ref_rows']} rows against f64 NumPy"):
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        import reference_impl as ri

        r = SIZES["ref_rows"]
        sl = Dataset.from_parts(data[:r], mask[:r])
        with precision("highest"):
            got = model.iterate(sl)
        C = np.asarray(model._transform, np.float64)
        mu = np.asarray(model._mean, np.float64)
        sig = float(model._isotropic_noise)
        m_np = np.asarray(mask[:r])
        ref_C, ref_mu, ref_sig = ri.em_iterate(
            C, mu, sig, np.asarray(data[:r], np.float64), m_np, np.ones(r))
        for name, a, b in (("C", got._transform, ref_C), ("mean", got._mean, ref_mu),
                           ("sigma", got._isotropic_noise, ref_sig)):
            err = rel(a, b)
            log(f"   {name}: rel err {err:.2e} (tol {PARAM_RTOL:.0e})")
            check(err <= PARAM_RTOL, f"EM step vs f64 reference, {name}: {err}")

    with Phase("readouts on the trained model"):
        llk = model.llk(ds)
        check(np.isfinite(llk), f"llk {llk}")
        ext = model.extrapolate(ds)
        e = ext.data
        check(e.shape == (n, d) and bool(jnp.all(jnp.isfinite(e))), "extrapolate")
        check(bool(jnp.all(jnp.where(mask, e == data, True))),
              "extrapolate changed observed entries")
        del ext, e
        r = SIZES["readout_rows"]
        part = Dataset.from_parts(data[:r], mask[:r])
        inf = model.infer(part)
        covs = jnp.asarray(inf._covariances)
        check(covs.shape == (r, k, k) and bool(jnp.all(jnp.isfinite(covs))), "infer")
        sample = inf.posterior_sampler().sample(jax.random.PRNGKey(5)).data
        check(sample.shape == (r, d) and bool(jnp.all(jnp.isfinite(sample))),
              "posterior sampler")
        log(f"   llk {llk:.4f}; infer/sampler on {r} rows")
    return ds, data, mask


def phase_mixture():
    sz = SIZES["mix"]
    with Phase(f"mixture M={sz['m']} D={sz['d']} k={sz['k']} N={sz['n']}"):
        data, mask = make_data(3, sz["n"], sz["d"], sz["k"])
        ds = Dataset.from_parts(data, mask)
        trace = []
        mix = PPCAMixTrainer(ds).train(
            n_models=sz["m"], state_size=sz["k"], n_iters=sz["iters"], quiet=True,
            callback=lambda i, m: trace.append(m.llk), key=jax.random.PRNGKey(4))
        log(f"   llk/sample trace {np.array2string(np.asarray(trace), precision=6)}")
        check_monotone(trace, "mixture")
        check(np.isfinite(mix.llk(ds)), "mixture llk")


def phase_pattern():
    sz = SIZES["pattern"]
    with Phase(f"structured masks P={sz['p']} (sorted pattern path)"):
        data, mask = make_data(5, sz["n"], sz["d"], sz["k"], patterns=sz["p"])
        ds = Dataset.from_parts(data, mask)
        info = ds.pattern_info()
        check(info is not None, "pattern detection found no patterns")
        check(ds.pattern_order() is not None, "sorted pattern path not taken")
        model0 = PPCAModel.init(sz["k"], ds, key=jax.random.PRNGKey(6))
        with precision("highest"):
            llk_p = model0.iterate(ds).llk(ds)
            old = config.use_pattern_dedup
            config.use_pattern_dedup = False
            try:
                llk_m = model0.iterate(ds).llk(ds)
            finally:
                config.use_pattern_dedup = old
        err = abs(llk_p - llk_m) / abs(llk_m)
        log(f"   one step: pattern {llk_p:.6f} masked {llk_m:.6f} rel {err:.2e}")
        check(err <= LLK_RTOL, f"pattern path vs masked path: {err}")
        _, trace = llk_trace_train(ds, state_size=sz["k"], n_iters=sz["iters"],
                                   key=jax.random.PRNGKey(6))
        check_monotone(trace, "pattern path")


def phase_dense():
    sz = SIZES["dense"]
    with Phase(f"fully observed D={sz['d']} k={sz['k']} N={sz['n']} (dense path)"):
        data, _ = make_data(7, sz["n"], sz["d"], sz["k"], obs=1.1)
        ds = Dataset.unmasked(data)
        check(ds.all_observed(), "dense path not taken")
        _, trace = llk_trace_train(ds, state_size=sz["k"], n_iters=sz["iters"],
                                   key=jax.random.PRNGKey(8))
        check_monotone(trace, "dense path")


def phase_large_k():
    sz = SIZES["large_k"]
    route = ml.spd_route(sz["k"], jnp.float32, "fullt", False)
    with Phase(f"large k={sz['k']} ({route} route) N={sz['n']}"):
        data, mask = make_data(9, sz["n"], sz["d"], sz["k"])
        ds = Dataset.from_parts(data, mask)
        _, trace = llk_trace_train(ds, state_size=sz["k"], n_iters=sz["iters"],
                                   key=jax.random.PRNGKey(10))
        check_monotone(trace, "large k")


def phase_streaming():
    sz = SIZES["stream"]
    with Phase(f"streaming {sz['chunks']} host chunks of {sz['n']} rows"):
        chunks = []
        for c in range(sz["chunks"]):
            data, mask = make_data(20 + c, sz["n"], sz["d"], sz["k"])
            y = np.where(np.asarray(mask), np.asarray(data), np.nan)
            chunks.append(lambda y=y: Dataset(y))
        trace = []
        model = StreamingPPCATrainer(chunks).train(
            state_size=sz["k"], n_iters=sz["iters"], quiet=True,
            callback=lambda i, m: trace.append(m.llk), key=jax.random.PRNGKey(11))
        check_monotone(trace, "streaming")
        check(bool(jnp.all(jnp.isfinite(model._transform))), "streaming model")


def phase_four_cards():
    from ppca_rs_tpu.parallel.mesh import make_mesh, shard_dataset

    check(len(jax.devices()) >= 4, f"--four-cards needs 4 GPUs, found {len(jax.devices())}")
    sz = SIZES["four"]
    n, d, k = sz["n"], sz["d"], sz["k"]
    with Phase(f"four cards data N={n} D={d}"):
        data, mask = make_data(12, n, d, k)
        pdata, pmask = make_data(13, sz["pattern_n"], d, k, patterns=32)
    meshes = {"1 card": None, "data=4": make_mesh(data=4, model=1),
              "data=2 x model=2": make_mesh(data=2, model=2)}
    results = {}
    for name, mesh in meshes.items():
        with Phase(f"sharded path on {name}"), precision("highest"):
            ds = Dataset.from_parts(data, mask)
            pds = Dataset.from_parts(pdata, pmask)
            if mesh is not None:
                ds, pds = shard_dataset(ds, mesh), shard_dataset(pds, mesh)
            m0 = PPCAModel.init(k, ds, key=jax.random.PRNGKey(14))
            model, trace = m0.iterate_n(ds, sz["iters"])
            llk = model.llk(ds)
            ext_rows = np.asarray(model.extrapolate(ds).data[:64])
            mix = PPCAMix.init(2, k, ds, key=jax.random.PRNGKey(15)).iterate(ds)
            mix_llk = mix.llk(ds)
            pm = PPCAModel.init(k, pds, key=jax.random.PRNGKey(16)).iterate(pds)
            pat_llk = pm.llk(pds)
            check_monotone(trace, f"{name} EM")
            results[name] = dict(trace=np.asarray(trace), llk=llk, ext=ext_rows,
                                 mix=mix_llk, pat=pat_llk,
                                 C=np.asarray(model._transform))
            log(f"   {name}: llk {llk:.4f} mix {mix_llk:.4f} pattern {pat_llk:.4f}")
            del ds, pds
    base = results["1 card"]
    for name in ("data=4", "data=2 x model=2"):
        got = results[name]
        for key in ("llk", "mix", "pat"):
            err = abs(got[key] - base[key]) / abs(base[key])
            log(f"   {name} {key}: rel {err:.2e}")
            check(err <= LLK_RTOL, f"{name} {key} vs one card: {err}")
        err = rel(got["trace"], base["trace"])
        check(err <= LLK_RTOL, f"{name} llk trace vs one card: {err}")
        err = rel(got["C"], base["C"])
        log(f"   {name} C: rel {err:.2e}")
        check(err <= PARAM_RTOL, f"{name} transform vs one card: {err}")
        err = rel(got["ext"], base["ext"])
        check(err <= SOLVE_RTOL, f"{name} extrapolate rows vs one card: {err}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four cards")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    dev = phase_device()
    if args.four_cards:
        phase_four_cards()
    else:
        phase_kernel_parity()
        phase_main_path()
        phase_mixture()
        phase_pattern()
        phase_dense()
        phase_large_k()
        phase_streaming()
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
