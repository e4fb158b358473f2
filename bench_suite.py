"""Benchmark suite: the five BASELINE.json configs, end to end.

Run on a GPU: python bench_suite.py        (prints a markdown table)

`bench.py` remains the driver's single-JSON-line benchmark; this suite is the
broader evidence across workload shapes.
"""

import sys
import time

import numpy as np


def log(*a):
    print(*a, flush=True)


def main():
    sys.path.insert(0, ".")
    import jax
    import jax.numpy as jnp

    from ppca_rs_tpu import Dataset, PPCAMix, PPCAModel, PPCATrainer, Prior
    from ppca_rs_tpu.utils.compile_cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"bench_suite.py needs a GPU; JAX found {jax.devices()[0].platform}")
    enable_compile_cache()

    rows = []
    key = jax.random.PRNGKey(0)

    # 1. Toy PPCA: fully observed, D=16, k=2, 10 EM iters ------------------
    real = PPCAModel(
        isotropic_noise=0.3,
        transform=np.random.default_rng(0).normal(size=(16, 2)),
        mean=np.zeros(16),
    )
    ds = real.sample(100_000, 0.0, key=key)
    model = PPCAModel.init(2, ds, key=key)
    # compile the 10-iteration scan with a different init (same program)
    wm, _ = PPCAModel.init(2, ds, key=jax.random.PRNGKey(99)).iterate_n(ds, 10)
    jax.block_until_ready(wm._transform)
    t0 = time.perf_counter()
    model, llks = model.iterate_n(ds, 10)
    jax.block_until_ready(model._transform)
    dt = time.perf_counter() - t0
    rows.append(("toy fully-observed (D=16, k=2, N=100k, 10 EM iters)",
                 f"{dt:.3f}s total", f"{len(ds) * 10 / dt:,.0f} samples/s"))

    # 2. Masked PPCA 30% NaN: train + extrapolate + CIs --------------------
    real = PPCAModel(
        isotropic_noise=0.2,
        transform=np.random.default_rng(1).normal(size=(128, 8)),
        mean=np.zeros(128),
    )
    ds = real.sample(100_000, 0.3, key=jax.random.PRNGKey(1))
    model = PPCATrainer(ds).train(state_size=8, n_iters=10, quiet=True,
                                  key=jax.random.PRNGKey(2))

    def readout():
        extr = model.extrapolate(ds)
        inf = model.infer(ds)
        ci = inf.extrapolated_covariances_diagonal(model, ds)
        jax.block_until_ready(ci.data)
        return extr

    extr = readout()  # compile
    t0 = time.perf_counter()
    extr = readout()
    dt = time.perf_counter() - t0
    assert np.isfinite(extr.numpy()).all()
    rows.append(("masked 30% NaN: extrapolate + CI readout (D=128, k=8, N=100k)",
                 f"{dt:.3f}s", f"{len(ds) / dt:,.0f} samples/s"))

    # 3. Big toy: D=512, k=32, N=1M, masked EM ------------------------------
    N, D, k = 1_000_000, 512, 32
    ks = jax.random.split(jax.random.PRNGKey(3), 3)
    Ct = jax.random.normal(ks[0], (D, k), dtype=jnp.float32)

    @jax.jit
    def gen():
        z = jax.random.normal(ks[1], (N, k), dtype=jnp.float32)
        eps = jax.random.normal(ks[2], (N, D), dtype=jnp.float32)
        data = z @ Ct.T + 0.4 * eps
        mask = jax.random.bernoulli(ks[1], 0.8, (N, D))
        return jnp.where(mask, data, 0.0), mask

    data, mask = gen()
    big = Dataset.from_parts(data, mask)
    model = PPCAModel.init(k, big, key=jax.random.PRNGKey(4))
    iters = 5
    # warm the exact scan with a different init (results cache per args)
    wm, _ = PPCAModel.init(k, big, key=jax.random.PRNGKey(44)).iterate_n(big, iters)
    jax.block_until_ready(wm._transform)
    t0 = time.perf_counter()
    model, _ = model.iterate_n(big, iters)
    jax.block_until_ready(model._transform)
    dt = time.perf_counter() - t0
    rows.append((f"big toy masked EM (D={D}, k={k}, N=1M, 20% missing, {iters}-iter scan)",
                 f"{dt / iters:.3f}s/iter", f"{N * iters / dt:,.0f} samples/s"))

    # 3a. k=128: past the fused kernel's ceiling (kernels.MAX_K) -----------
    N, D, k = 262_144, 1024, 128
    kk = jax.random.split(jax.random.PRNGKey(31), 4)

    @jax.jit
    def genk():
        C = jax.random.normal(kk[0], (D, k), dtype=jnp.float32)
        z = jax.random.normal(kk[1], (N, k), dtype=jnp.float32)
        eps = jax.random.normal(kk[2], (N, D), dtype=jnp.float32)
        data = z @ C.T + 0.5 * eps
        mask = jax.random.bernoulli(kk[3], 0.5, (N, D))
        return jnp.where(mask, data, 0.0), mask

    kdata, kmask = genk()
    kds = Dataset.from_parts(kdata, kmask)
    kmodel = PPCAModel.init(k, kds, key=jax.random.PRNGKey(32))
    wm, _ = PPCAModel.init(k, kds, key=jax.random.PRNGKey(33)).iterate_n(kds, 3)
    jax.block_until_ready(wm._transform)
    t0 = time.perf_counter()
    kmodel, _ = kmodel.iterate_n(kds, 3)
    jax.block_until_ready(kmodel._transform)
    dt = time.perf_counter() - t0
    rows.append((f"masked EM at k=128 (D={D}, N=262k, 50% missing)",
                 f"{dt / 3:.3f}s/iter", f"{N * 3 / dt:,.0f} samples/s"))
    del kds, kmodel, kdata, kmask

    # 3a'. k=192, 256, 384 and 512: the large-k route (blocked Schur
    # inverse or XLA Cholesky, config.use_blocked_large_k).  The per-sample
    # factorization cost scales ~k^3.
    for kbig, nbig, it in ((192, 131_072, 3), (256, 131_072, 2),
                           (384, 65_536, 2), (512, 32_768, 2)):
        kb = jax.random.split(jax.random.PRNGKey(40 + kbig), 4)

        @jax.jit
        def genb():
            C = jax.random.normal(kb[0], (1024, kbig), dtype=jnp.float32)
            z = jax.random.normal(kb[1], (nbig, kbig), dtype=jnp.float32)
            eps = jax.random.normal(kb[2], (nbig, 1024), dtype=jnp.float32)
            data = z @ C.T + 0.5 * eps
            mask = jax.random.bernoulli(kb[3], 0.5, (nbig, 1024))
            return jnp.where(mask, data, 0.0), mask

        bdata, bmask = genb()
        bds = Dataset.from_parts(bdata, bmask)
        bmodel = PPCAModel.init(kbig, bds, key=jax.random.PRNGKey(41))
        wm, _ = PPCAModel.init(kbig, bds, key=jax.random.PRNGKey(42)).iterate_n(bds, it)
        jax.block_until_ready(wm._transform)
        t0 = time.perf_counter()
        bmodel, _ = bmodel.iterate_n(bds, it)
        jax.block_until_ready(bmodel._transform)
        dt = time.perf_counter() - t0
        rows.append((f"masked EM at k={kbig} (D=1024, N={nbig // 1024}k, 50% missing)",
                     f"{dt / it:.3f}s/iter", f"{nbig * it / dt:,.0f} samples/s"))
        del bds, bmodel, bdata, bmask

    # 3b. Dense fully-observed at the flagship shape ------------------------
    N, D, k = 1_000_000, 1024, 64
    kd = jax.random.split(jax.random.PRNGKey(21), 3)

    @jax.jit
    def gend():
        C = jax.random.normal(kd[0], (D, k), dtype=jnp.float32)
        z = jax.random.normal(kd[1], (N, k), dtype=jnp.float32)
        eps = jax.random.normal(kd[2], (N, D), dtype=jnp.float32)
        return z @ C.T + 0.5 * eps

    dds_full = Dataset.unmasked(gend())
    assert dds_full.all_observed()
    dmodel = PPCAModel.init(k, dds_full, key=jax.random.PRNGKey(22))
    # warm the exact scan with a different init (results cache per args)
    wm, _ = PPCAModel.init(k, dds_full, key=jax.random.PRNGKey(23)).iterate_n(dds_full, 5)
    jax.block_until_ready(wm._transform)
    t0 = time.perf_counter()
    dmodel, _ = dmodel.iterate_n(dds_full, 5)
    jax.block_until_ready(dmodel._transform)
    dt = time.perf_counter() - t0
    rows.append((f"dense fully-observed EM (D={D}, k={k}, N=1M, 5-iter scan)",
                 f"{dt / 5:.3f}s/iter", f"{N * 5 / dt:,.0f} samples/s"))

    # 3c. Same, bf16 value storage (halved HBM reads) -----------------------
    dds16 = dds_full.astype(jnp.bfloat16)
    dmodel16 = PPCAModel.init(k, dds16, key=jax.random.PRNGKey(22))
    wm16, _ = PPCAModel.init(k, dds16, key=jax.random.PRNGKey(23)).iterate_n(dds16, 5)
    jax.block_until_ready(wm16._transform)
    t0 = time.perf_counter()
    dmodel16, _ = dmodel16.iterate_n(dds16, 5)
    jax.block_until_ready(dmodel16._transform)
    dt = time.perf_counter() - t0
    rows.append((f"dense fully-observed EM, bf16 storage (D={D}, k={k}, N=1M, 5-iter scan)",
                 f"{dt / 5:.3f}s/iter", f"{N * 5 / dt:,.0f} samples/s"))
    del dds_full, dmodel, dds16, dmodel16, wm16

    # 4. 8-component mixture ------------------------------------------------
    N, D, k, M = 200_000, 512, 32, 8
    ksm = jax.random.split(jax.random.PRNGKey(5), 4)

    @jax.jit
    def genm():
        comp = jax.random.randint(ksm[0], (N,), 0, M)
        Cs = jax.random.normal(ksm[1], (M, D, k), dtype=jnp.float32)
        means = 3.0 * jax.random.normal(ksm[2], (M, D), dtype=jnp.float32)
        z = jax.random.normal(ksm[3], (N, k), dtype=jnp.float32)
        eps = jax.random.normal(ksm[0], (N, D), dtype=jnp.float32)
        data = jnp.einsum("nk,ndk->nd", z, Cs[comp]) + means[comp] + 0.3 * eps
        mask = jax.random.bernoulli(ksm[1], 0.8, (N, D))
        return jnp.where(mask, data, 0.0), mask

    data, mask = genm()
    mds = Dataset.from_parts(data, mask)
    mix = PPCAMix.init(M, k, mds, key=jax.random.PRNGKey(6))
    iters = 5
    # warm the exact scan with a different init (results cache per args)
    wmx, _ = PPCAMix.init(M, k, mds, key=jax.random.PRNGKey(66)).iterate_n(
        mds, iters, Prior())
    jax.block_until_ready(wmx._models[0]._transform)
    t0 = time.perf_counter()
    mix, _ = mix.iterate_n(mds, iters, Prior())
    jax.block_until_ready(mix._models[0]._transform)
    dt = time.perf_counter() - t0
    rows.append((f"mixture EM, M={M} fused single-pass "
                 f"(D={D}, k={k}, N=200k, {iters}-iter scan)",
                 f"{dt / iters:.3f}s/iter", f"{N * iters / dt:,.0f} samples/s"))
    del wmx
    del mds, mix, data, mask

    # 5. Priors + degenerate cases ------------------------------------------
    rng = np.random.default_rng(7)
    data = rng.normal(size=(50_000, 64))
    data[rng.random(data.shape) < 0.4] = np.nan
    data[:, 3] = np.nan              # empty dimension
    data[: 100] = np.nan             # all-missing rows
    dds = Dataset(data)
    prior = (
        Prior()
        .with_isotropic_noise_prior(50.0, 50.0)
        .with_transformation_precision(0.1)
        .with_mean_prior(np.zeros(64), np.eye(64))
    )
    # compile the exact 10-iteration scan program with a different init key
    wm = PPCATrainer(dds).train(state_size=8, n_iters=10, prior=prior,
                                quiet=True, key=jax.random.PRNGKey(98))
    jax.block_until_ready(wm._transform)
    t0 = time.perf_counter()
    model = PPCATrainer(dds).train(state_size=8, n_iters=10, prior=prior,
                                   quiet=True, key=jax.random.PRNGKey(8))
    dt = time.perf_counter() - t0
    # The empty-dim row is EXACTLY zero through every EM iteration (ridge
    # solve with zero RHS); train() ends in to_canonical, whose f32 SVD
    # rotation smears it to ~1e-8 (just over allclose's default atol).
    # 1e-6 is the f32 assertion.
    assert np.allclose(model.transform[3], 0.0, atol=1e-6)
    rows.append(("priors + empty dim + all-NaN rows (D=64, k=8, N=50k, 10 iters)",
                 f"{dt:.3f}s total", f"{len(dds) * 10 / dt:,.0f} samples/s"))

    # 6. Structured missingness: mask-pattern dedup (P=32 patterns) ---------
    N, D, k, Pn = 1_000_000, 1024, 64, 32
    kp = jax.random.split(jax.random.PRNGKey(9), 4)

    @jax.jit
    def genp():
        pats = jax.random.bernoulli(kp[0], 0.5, (Pn, D))
        pidx = jax.random.randint(kp[1], (N,), 0, Pn)
        z = jax.random.normal(kp[2], (N, k), dtype=jnp.float32)
        Ct = jax.random.normal(kp[3], (D, k), dtype=jnp.float32)
        eps = jax.random.normal(kp[2], (N, D), dtype=jnp.float32)
        mask = pats[pidx]
        return jnp.where(mask, z @ Ct.T + 0.4 * eps, 0.0), mask

    data, mask = genp()
    pds = Dataset.from_parts(data, mask)
    t0 = time.perf_counter()
    assert pds.pattern_info() is not None
    detect = time.perf_counter() - t0
    model = PPCAModel.init(k, pds, key=jax.random.PRNGKey(10))
    iters = 5
    # warm the exact scan with a different init (results cache per args)
    wm, _ = PPCAModel.init(k, pds, key=jax.random.PRNGKey(11)).iterate_n(pds, iters)
    jax.block_until_ready(wm._transform)
    t0 = time.perf_counter()
    model, _ = model.iterate_n(pds, iters)
    jax.block_until_ready(model._transform)
    dt = time.perf_counter() - t0
    rows.append((f"structured missingness, P={Pn} patterns dedup "
                 f"(D={D}, k={k}, N=1M, 50% missing; detect {detect:.1f}s once; "
                 f"{iters}-iter scan)",
                 f"{dt / iters:.3f}s/iter", f"{N * iters / dt:,.0f} samples/s"))

    # 6b. Same, bf16 value storage (halved data reads) ----------------------
    pds16 = Dataset.from_parts(data.astype(jnp.bfloat16), mask)
    assert pds16.pattern_info() is not None
    model16 = PPCAModel.init(k, pds16, key=jax.random.PRNGKey(10))
    wm16, _ = PPCAModel.init(k, pds16, key=jax.random.PRNGKey(11)).iterate_n(pds16, iters)
    jax.block_until_ready(wm16._transform)
    t0 = time.perf_counter()
    model16, _ = model16.iterate_n(pds16, iters)
    jax.block_until_ready(model16._transform)
    dt = time.perf_counter() - t0
    rows.append((f"structured missingness P={Pn}, bf16 storage "
                 f"(D={D}, k={k}, N=1M, {iters}-iter scan)",
                 f"{dt / iters:.3f}s/iter", f"{N * iters / dt:,.0f} samples/s"))
    # free the ~5 GB of section-4..6 device arrays before the 12 GB
    # bf16-storage row below
    del pds, model, data, mask, dds, wm, pds16, model16, wm16
    import gc

    gc.collect()

    # 7. Large-N single-chip headline with bf16 storage ---------------------
    # The north-star config is 10M rows at D=1024; this N=4M point with
    # bf16-stored data (2 B/entry) + bool mask (1 B/entry) is 12 GB
    # resident.
    N, D, k = 4_000_000, 1024, 64
    CH = 250_000  # generate in chunks: a whole-N f32 eps would be 16 GB alone
    kh = jax.random.split(jax.random.PRNGKey(60), 2)

    @jax.jit
    def genh():
        C = jax.random.normal(kh[0], (D, k), dtype=jnp.float32)

        def chunk(key):
            kz, ke, km = jax.random.split(key, 3)
            z = jax.random.normal(kz, (CH, k), dtype=jnp.float32)
            eps = jax.random.normal(ke, (CH, D), dtype=jnp.float32)
            d = (z @ C.T + 0.5 * eps).astype(jnp.bfloat16)
            m = jax.random.bernoulli(km, 0.5, (CH, D))
            return jnp.where(m, d, 0), m

        ds, ms = jax.lax.map(chunk, jax.random.split(kh[1], N // CH))
        return ds.reshape(N, D), ms.reshape(N, D)

    try:
        hdata, hmask = genh()
        hds = Dataset.from_parts(hdata, hmask)
        hmodel = PPCAModel.init(k, hds, key=jax.random.PRNGKey(61))
        wm, _ = PPCAModel.init(k, hds, key=jax.random.PRNGKey(62)).iterate_n(hds, 2)
        jax.block_until_ready(wm._transform)
        t0 = time.perf_counter()
        hmodel, _ = hmodel.iterate_n(hds, 2)
        jax.block_until_ready(hmodel._transform)
        dt = time.perf_counter() - t0
        rows.append((f"headline at N=4M, bf16 storage (D={D}, k={k}, 50% missing)",
                     f"{dt / 2:.3f}s/iter", f"{N * 2 / dt:,.0f} samples/s"))
        del hds, hmodel, hdata, hmask
    except Exception as e:  # HBM-capacity guard: report instead of dying
        rows.append((f"headline at N=4M bf16 (D={D}, k={k})", "OOM/err", str(e)[:60]))

    log("\n| config | time | throughput |")
    log("|---|---|---|")
    for name, t, thr in rows:
        log(f"| {name} | {t} | {thr} |")


if __name__ == "__main__":
    main()
