"""Fused single-pass mixture EM (ops/mix_fused.py) vs the reference-shaped
per-component loop — both must produce identical models."""

import numpy as np
import pytest

import jax

from ppca_rs_tpu import Dataset, PPCAMix, PPCAModel, Prior
from ppca_rs_tpu.parallel.mesh import dataset_mesh


def make_mix_and_data(rng, M=3, d=7, k=2, n=60):
    models = [
        PPCAModel(
            isotropic_noise=0.3 + 0.1 * i,
            transform=rng.normal(size=(d, k)),
            mean=rng.normal(size=d),
        )
        for i in range(M)
    ]
    mix = PPCAMix(models, rng.normal(size=M))
    data = rng.normal(size=(n, d))
    data[rng.random((n, d)) < 0.3] = np.nan
    data[4] = np.nan
    weights = rng.random(n) + 0.5
    weights[7] = 0.0
    return mix, Dataset(data, weights=weights)


def loop_iterate(mix, dataset, prior):
    """Force the reference-shaped per-component loop by faking a mesh check."""
    per = mix._component_llks(dataset)
    import jax.numpy as jnp
    from ppca_rs_tpu.models.mix import _log_softmax_jit, _logsumexp_jit

    joint = per + mix._log_weights[None, :]
    llk = float(jnp.sum(_logsumexp_jit(joint) * dataset.weights_dev))
    log_post = _log_softmax_jit(joint)
    log_w_data = jnp.log(dataset.weights_dev)
    new_models, new_lw = [], []
    for i, model in enumerate(mix._models):
        lp = log_w_data + log_post[:, i]
        max_lp = jnp.max(lp)
        unnorm = jnp.exp(lp - max_lp)
        logsum = jnp.log(jnp.sum(unnorm)) + max_lp
        new_models.append(model.iterate_with_prior(dataset.with_weights(unnorm), prior))
        new_lw.append(logsum)
    return PPCAMix(new_models, jnp.stack(new_lw)), llk


@pytest.mark.parametrize("prior_kind", ["none", "all"])
def test_fused_matches_loop(rng, prior_kind):
    mix, ds = make_mix_and_data(rng)
    prior = Prior()
    if prior_kind == "all":
        prior = (
            prior.with_isotropic_noise_prior(2.0, 3.0)
            .with_transformation_precision(0.3)
            .with_mean_prior(rng.normal(size=7), np.eye(7) * 0.8)
        )

    fused, llk_f = mix._iterate_fused(ds, prior)
    loop, llk_l = loop_iterate(mix, ds, prior)

    assert np.isclose(llk_f, llk_l, rtol=1e-10)
    np.testing.assert_allclose(fused.log_weights, loop.log_weights, rtol=1e-8, atol=1e-10)
    for a, b in zip(fused.models, loop.models):
        np.testing.assert_allclose(a.transform, b.transform, rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(a.mean, b.mean, rtol=1e-7, atol=1e-9)
        assert np.isclose(a.isotropic_noise, b.isotropic_noise, rtol=1e-8)


def test_fused_is_default_for_equal_sizes(rng):
    mix, ds = make_mix_and_data(rng)
    assert dataset_mesh(ds) is None
    # iterate() routes through the fused path and increases llk
    prev = mix.llk(ds)
    cur = mix
    for _ in range(6):
        cur = cur.iterate(ds)
        llk = cur.llk(ds)
        assert llk >= prev - 1e-6
        prev = llk


def test_fused_inference_verbs_match_loop(rng):
    """mix_llks / mix_infer / mix_smooth must equal the per-component loop."""
    import jax.numpy as jnp

    mix, ds = make_mix_and_data(rng)
    n = len(ds)

    # loop references (the reference's M-pass shape, mix.rs:137-265)
    per_loop = jnp.stack([m._llks_device(ds) for m in mix._models], axis=1)
    per_fused = mix._component_llks(ds)
    np.testing.assert_allclose(per_fused, per_loop, rtol=1e-9, atol=1e-11)

    inf = mix.infer(ds)  # fused path (equal state sizes, unsharded)
    from ppca_rs_tpu.models.mix import _log_softmax_jit

    log_post_ref = _log_softmax_jit(per_loop + mix._log_weights[None, :])[:n]
    np.testing.assert_allclose(inf.log_posteriors(), log_post_ref, rtol=1e-9, atol=1e-11)
    for sub, m in zip(inf.sub_states(), mix._models):
        ref = m.infer(ds)
        np.testing.assert_allclose(sub.states(), ref.states(), rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(
            sub.covariances_array(), ref.covariances_array(), rtol=1e-7, atol=1e-9
        )

    # fused smooth/extrapolate vs the infer-based combination
    sm_ref = inf.smoothed(mix).numpy()
    ex_ref = inf.extrapolated(mix, ds).numpy()
    np.testing.assert_allclose(mix.smooth(ds).numpy(), sm_ref, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(mix.extrapolate(ds).numpy(), ex_ref, rtol=1e-8, atol=1e-10)


def _mk_patterned_mix_data(rng, n=96, d=9, n_patterns=4, weights=True):
    pats = rng.random((n_patterns, d)) < 0.65
    pats[0, :] = True
    idx = rng.integers(0, n_patterns, size=n)
    values = rng.normal(size=(n, d))
    values[~pats[idx]] = np.nan
    w = rng.random(n) + 0.3 if weights else None
    return Dataset(values, weights=w)


def test_mix_pattern_path_matches_general(rng):
    """Mixture EM + verbs through the pattern-table path must equal the
    general fused path and the reference-shaped loop."""
    from ppca_rs_tpu.config import config

    ds = _mk_patterned_mix_data(rng)
    models = [
        PPCAModel(isotropic_noise=0.4 + 0.1 * i,
                  transform=rng.normal(size=(9, 2)), mean=rng.normal(size=9))
        for i in range(3)
    ]
    mix = PPCAMix(models, rng.normal(size=3))
    assert mix._pattern(ds) is not None

    prior = Prior().with_isotropic_noise_prior(2.0, 2.0).with_transformation_precision(0.2)
    pat_em, llk_pat = mix._iterate_fused(ds, prior)
    pat_llks = mix._component_llks(ds)
    pat_inf = mix.infer(ds)
    pat_sm = mix.smooth(ds).numpy()
    pat_ex = mix.extrapolate(ds).numpy()

    config.use_pattern_dedup = False
    try:
        gen_em, llk_gen = mix._iterate_fused(ds, prior)
        loop_em, llk_loop = mix._iterate_loop(ds, prior)
        gen_llks = mix._component_llks(ds)
        gen_inf = mix.infer(ds)
        gen_sm = mix.smooth(ds).numpy()
        gen_ex = mix.extrapolate(ds).numpy()
    finally:
        config.use_pattern_dedup = True

    np.testing.assert_allclose(pat_llks, gen_llks, rtol=1e-9, atol=1e-11)
    assert np.isclose(llk_pat, llk_gen, rtol=1e-10) and np.isclose(llk_pat, llk_loop, rtol=1e-10)
    for a, b, c in zip(pat_em.models, gen_em.models, loop_em.models):
        np.testing.assert_allclose(a.transform, b.transform, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(a.transform, c.transform, rtol=1e-7, atol=1e-9)
        assert np.isclose(a.isotropic_noise, b.isotropic_noise, rtol=1e-9)
    np.testing.assert_allclose(pat_em.log_weights, gen_em.log_weights, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(pat_inf.log_posteriors(), gen_inf.log_posteriors(),
                               rtol=1e-9, atol=1e-11)
    for a, b in zip(pat_inf.sub_states(), gen_inf.sub_states()):
        np.testing.assert_allclose(a.states(), b.states(), rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(a.covariances_array(), b.covariances_array(),
                                   rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(pat_sm, gen_sm, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(pat_ex, gen_ex, rtol=1e-8, atol=1e-10)


def test_dense_mixture_fast_path(rng):
    """A fully-observed dataset takes the P=1 pattern-table path in the
    mixture; results equal the general fused path and EM stays monotone."""
    from ppca_rs_tpu.config import config

    models = [
        PPCAModel(isotropic_noise=0.5, transform=rng.normal(size=(6, 2)),
                  mean=rng.normal(size=6))
        for _ in range(2)
    ]
    mix = PPCAMix(models, np.zeros(2))
    ds = Dataset(rng.normal(size=(80, 6)))
    assert ds.all_observed()
    pat = mix._pattern(ds)
    assert pat is not None and pat[1].shape == (1, 6)

    llk_pat = mix.llk(ds)
    new_pat, _ = mix._iterate_fused(ds, Prior())
    config.use_pattern_dedup = False
    try:
        llk_gen = mix.llk(ds)
        new_gen, _ = mix._iterate_fused(ds, Prior())
    finally:
        config.use_pattern_dedup = True
    assert np.isclose(llk_pat, llk_gen, rtol=1e-10)
    for a, b in zip(new_pat.models, new_gen.models):
        np.testing.assert_allclose(a.transform, b.transform, rtol=1e-8, atol=1e-10)

    cur, prev = mix, llk_pat
    for _ in range(5):
        cur = cur.iterate(ds)
        llk = cur.llk(ds)
        assert llk >= prev - 1e-8
        prev = llk


def test_mix_pattern_group_outer_both_branches(rng):
    """P > D exercises the direct (non-grouped) S branch of the pattern EM."""
    from ppca_rs_tpu.config import config

    explicit = np.array([
        [1, 1, 1], [1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 0, 0],
    ], dtype=bool)
    idx = rng.integers(0, len(explicit), size=128)
    values = rng.normal(size=(128, 3))
    values[~explicit[idx]] = np.nan
    ds = Dataset(values, weights=rng.random(128) + 0.3)
    pats = ds.pattern_info()
    assert pats is not None and pats[1].shape[0] > 3
    models = [
        PPCAModel(isotropic_noise=0.5, transform=rng.normal(size=(3, 1)),
                  mean=rng.normal(size=3))
        for _ in range(2)
    ]
    mix = PPCAMix(models, np.zeros(2))
    new_pat, llk_pat = mix._iterate_fused(ds, Prior())
    config.use_pattern_dedup = False
    try:
        new_gen, llk_gen = mix._iterate_fused(ds, Prior())
    finally:
        config.use_pattern_dedup = True
    assert np.isclose(llk_pat, llk_gen, rtol=1e-10)
    for a, b in zip(new_pat.models, new_gen.models):
        np.testing.assert_allclose(a.transform, b.transform, rtol=1e-8, atol=1e-10)
        assert np.isclose(a.isotropic_noise, b.isotropic_noise, rtol=1e-9)


def test_dead_component_keeps_params(rng):
    """A component dominated everywhere gets responsibility exactly 0
    (exp underflow); the fused EM must keep its old parameters and the
    mixture must stay finite, instead of NaN-ing via 1/resp_max=inf."""
    d, k, n = 4, 2, 50
    alive = PPCAModel(
        isotropic_noise=0.4, transform=rng.normal(size=(d, k)), mean=np.zeros(d)
    )
    # mean ~1e6 away from all the data => per-sample llk gap >> 745 nats,
    # so exp(joint - lse) underflows to exactly 0 for this component.
    dead = PPCAModel(
        isotropic_noise=0.4,
        transform=rng.normal(size=(d, k)),
        mean=np.full(d, 1e6),
    )
    mix = PPCAMix([alive, dead], np.zeros(2))
    data = rng.normal(size=(n, d))
    data[rng.random((n, d)) < 0.2] = np.nan
    ds = Dataset(data)

    new = mix.iterate(ds)
    for m in new.models:
        assert np.isfinite(m.transform).all()
        assert np.isfinite(m.mean).all()
        assert np.isfinite(m.isotropic_noise)
    # dead component's parameters are untouched
    np.testing.assert_array_equal(new.models[1].transform, dead.transform)
    np.testing.assert_array_equal(new.models[1].mean, dead.mean)
    assert float(new.models[1].isotropic_noise) == 0.4
    # its weight collapses to 0 (log weight -inf) and the next llk is finite
    assert np.exp(new.log_weights[1]) == 0.0
    assert np.isfinite(new.llk(ds))
    again = new.iterate(ds)
    assert np.isfinite(again.llk(ds))

    # with priors active the same guard must hold
    prior = Prior().with_isotropic_noise_prior(2.0, 2.0).with_transformation_precision(0.1)
    new_p = mix.iterate_with_prior(ds, prior)
    for m in new_p.models:
        assert np.isfinite(m.transform).all()
        assert np.isfinite(m.isotropic_noise)


def test_heterogeneous_rides_fused_path(rng):
    """Components with different state sizes go through the same fused pass
    zero-padded to max(k); results must equal the reference-shaped
    per-component loop exactly (padded latent dims are inert)."""
    m1 = PPCAModel(isotropic_noise=0.5, transform=rng.normal(size=(5, 1)), mean=np.zeros(5))
    m2 = PPCAModel(isotropic_noise=0.4, transform=rng.normal(size=(5, 3)), mean=np.ones(5))
    mix = PPCAMix([m1, m2], np.log([0.4, 0.6]))
    data = mix.sample(60, 0.2, key=jax.random.PRNGKey(0))
    data = data.with_weights(rng.random(60) + 0.5)

    fused, llk_f = mix._iterate_fused(data, Prior())
    loop, llk_l = mix._iterate_loop(data, Prior())
    assert fused.state_sizes == [1, 3]
    assert np.isclose(llk_f, llk_l, rtol=1e-10)
    np.testing.assert_allclose(fused.log_weights, loop.log_weights, rtol=1e-8, atol=1e-10)
    for a, b in zip(fused.models, loop.models):
        np.testing.assert_allclose(a.transform, b.transform, rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(a.mean, b.mean, rtol=1e-7, atol=1e-9)
        assert np.isclose(a.isotropic_noise, b.isotropic_noise, rtol=1e-8)

    # with priors too (the prior strengths interact with the weight scaling)
    prior = (
        Prior()
        .with_isotropic_noise_prior(2.0, 1.5)
        .with_transformation_precision(0.2)
        .with_mean_prior(np.zeros(5), 0.7 * np.eye(5))
    )
    fused_p, _ = mix._iterate_fused(data, prior)
    loop_p, _ = mix._iterate_loop(data, prior)
    for a, b in zip(fused_p.models, loop_p.models):
        np.testing.assert_allclose(a.transform, b.transform, rtol=1e-7, atol=1e-9)
        assert np.isclose(a.isotropic_noise, b.isotropic_noise, rtol=1e-8)

    # inference verbs: fused infer slices each component back to its k and
    # matches the per-component path
    inf = mix.infer(data)
    for sub, m in zip(inf.sub_states(), mix._models):
        ref = m.infer(data)
        assert sub.states().shape[1] == m.state_size
        np.testing.assert_allclose(sub.states(), ref.states(), rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(
            sub.covariances_array(), ref.covariances_array(), rtol=1e-7, atol=1e-9
        )
    sm_ref = inf.smoothed(mix).numpy()
    np.testing.assert_allclose(mix.smooth(data).numpy(), sm_ref, rtol=1e-8, atol=1e-10)
    ex_ref = inf.extrapolated(mix, data).numpy()
    np.testing.assert_allclose(mix.extrapolate(data).numpy(), ex_ref, rtol=1e-8, atol=1e-10)

    # monotone llk through several heterogeneous fused iterations
    cur, prev = mix, mix.llk(data)
    for _ in range(5):
        cur = cur.iterate(data)
        llk = cur.llk(data)
        assert llk >= prev - 1e-8
        prev = llk


def test_kernel_routed_mix_em_matches_fallback(rng, monkeypatch):
    """The kernel-routed fast block == the XLA block, end to end through
    mix_em_stats, with the kernel in interpret mode (f32)."""
    import functools

    import jax.numpy as jnp
    from ppca_rs_tpu.ops import kernels
    from ppca_rs_tpu.ops import masked_linalg as ml
    from ppca_rs_tpu.ops import mix_fused as mf

    M, B, D, k = 3, 128, 64, 8
    Cs = jnp.asarray(rng.normal(size=(M, D, k)), jnp.float32) * 0.5
    means = jnp.asarray(rng.normal(size=(M, D)), jnp.float32)
    sigmas = jnp.asarray(0.5 + rng.random(M), jnp.float32)
    lw = jnp.log(jnp.full((M,), 1.0 / M, jnp.float32))
    data = jnp.asarray(rng.normal(size=(B, D)), jnp.float32)
    mask = jnp.asarray(rng.random((B, D)) > 0.4)
    mask = mask.at[3].set(False)
    data = jnp.where(mask, data, 0.0)
    w = jnp.asarray(rng.random(B) + 0.5, jnp.float32)
    w = w.at[7].set(0.0)

    ref = mf.mix_em_stats(Cs, means, sigmas, lw, data, mask, w, block_size=128)

    monkeypatch.setattr(ml, "spd_route", lambda *a, **kw: "kernel")
    monkeypatch.setattr(
        kernels, "spd_estep", functools.partial(kernels.spd_estep, interpret=True)
    )
    got = mf.mix_em_stats(Cs, means, sigmas, lw, data, mask, w, block_size=128)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)

    assert rel(got.cross, ref.cross) < 1e-4
    assert rel(got.S, ref.S) < 1e-4
    assert rel(got.square_error, ref.square_error) < 1e-4
    assert rel(got.dev_sq, ref.dev_sq) < 1e-3
    assert rel(got.total_dev, ref.total_dev) < 1e-3
    # totals = resp @ mask: not mask-exact — the responsibilities themselves
    # differ at f32 between the two llk computations.
    assert rel(got.totals, ref.totals) < 1e-5
    assert rel(got.resp_sum, ref.resp_sum) < 1e-5
    assert rel(got.resp_max, ref.resp_max) < 1e-5
    assert rel(got.llk, ref.llk) < 1e-5


def test_mix_exact_rnorm_envelope(rng):
    """config.mix_exact_rnorm: at wide component-mean separation the
    lane-major expanded rnorm quadratic cancels (error ~O(separation^2));
    the exact-rnorm route computes it from the materialized residual and
    must track the f64 oracle much more closely (ADVICE round-2 medium)."""
    import jax.numpy as jnp
    from ppca_rs_tpu.config import config
    from ppca_rs_tpu.ops import mix_fused as mf

    M, B, D, k = 2, 256, 64, 4
    sep = 300.0
    centers = np.stack([np.full(D, -sep / 2), np.full(D, sep / 2)])
    comp = rng.integers(0, M, size=B)
    data_np = centers[comp] + 0.5 * rng.normal(size=(B, D))
    mask_np = rng.random((B, D)) > 0.3
    C_np = rng.normal(size=(D, k))

    def stats(dtype, exact):
        Cs = jnp.asarray(np.tile(C_np, (M, 1, 1)), dtype) * 0.5
        means = jnp.asarray(centers, dtype)
        sigmas = jnp.full((M,), 0.5, dtype)
        lw = jnp.log(jnp.full((M,), 1.0 / M, dtype))
        data = jnp.asarray(np.where(mask_np, data_np, 0.0), dtype)
        w = jnp.ones((B,), dtype)
        old = config.mix_exact_rnorm
        config.mix_exact_rnorm = exact
        try:
            return mf.mix_em_stats(Cs, means, sigmas, lw, data,
                                   jnp.asarray(mask_np), w, block_size=128)
        finally:
            config.mix_exact_rnorm = old

    oracle = stats(jnp.float64, False)
    fast = stats(jnp.float32, False)
    exact = stats(jnp.float32, True)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)

    err_fast = rel(fast.dev_sq, oracle.dev_sq)
    err_exact = rel(exact.dev_sq, oracle.dev_sq)
    # the exact route must be at least 10x closer to f64, and tight in
    # absolute terms; the fast route's documented envelope is ~1e-3.
    assert err_exact < 1e-5, err_exact
    assert err_fast > 10 * err_exact, (err_fast, err_exact)
    assert rel(exact.llk, oracle.llk) < 1e-6


def test_mix_exact_rnorm_pattern_path(rng):
    """The pattern-table EM with mix_exact_rnorm routes through center=None
    and still matches the default path on a benign (small-separation) case."""
    import jax.numpy as jnp
    from ppca_rs_tpu.config import config
    from ppca_rs_tpu.ops import mix_fused as mf

    M, B, D, k, P = 2, 64, 16, 3, 4
    Cs = jnp.asarray(rng.normal(size=(M, D, k)))
    means = jnp.asarray(rng.normal(size=(M, D)))
    sigmas = jnp.asarray(0.5 + rng.random(M))
    lw = jnp.log(jnp.full((M,), 1.0 / M))
    patterns = jnp.asarray(rng.random((P, D)) > 0.3)
    pidx = jnp.asarray(rng.integers(0, P, size=B), jnp.int32)
    data = jnp.asarray(rng.normal(size=(B, D))) * patterns[pidx]
    w = jnp.ones((B,))
    mask = patterns[pidx]

    args = (Cs, means, sigmas, lw, data, mask, pidx, patterns, w)
    ref = mf.mix_em_stats_pat(*args, block_size=64)
    old = config.mix_exact_rnorm
    config.mix_exact_rnorm = True
    try:
        got = mf.mix_em_stats_pat(*args, block_size=64)
    finally:
        config.mix_exact_rnorm = old
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-8, atol=1e-10)


def test_kernel_routed_mix_readouts_match_fallback(rng, monkeypatch):
    """The kernel-routed readout blocks (mix_llks / mix_smooth / mix_infer)
    == the XLA paths, with the kernel in interpret mode."""
    import functools

    import jax.numpy as jnp
    from ppca_rs_tpu.ops import kernels
    from ppca_rs_tpu.ops import masked_linalg as ml
    from ppca_rs_tpu.ops import mix_fused as mf

    M, B, D, k = 3, 128, 32, 8
    Cs = jnp.asarray(rng.normal(size=(M, D, k)), jnp.float32) * 0.5
    means = jnp.asarray(rng.normal(size=(M, D)), jnp.float32)
    sigmas = jnp.asarray(0.5 + rng.random(M), jnp.float32)
    lw = jnp.log(jnp.full((M,), 1.0 / M, jnp.float32))
    data = jnp.asarray(rng.normal(size=(B, D)), jnp.float32)
    mask = jnp.asarray(rng.random((B, D)) > 0.4)
    mask = mask.at[3].set(False)
    data = jnp.where(mask, data, 0.0)

    args = (Cs, means, sigmas, lw, data, mask)
    ref_lp, ref_s, ref_cov = mf.mix_infer(*args, block_size=128)
    ref_sm = mf.mix_smooth(*args, block_size=128)
    ref_ex = mf.mix_smooth(*args, block_size=128, extrapolate=True)

    monkeypatch.setattr(ml, "spd_route", lambda *a, **kw: "kernel")
    monkeypatch.setattr(
        kernels, "spd_estep", functools.partial(kernels.spd_estep, interpret=True)
    )
    got_lp, got_s, got_cov = mf.mix_infer(*args, block_size=128)
    got_sm = mf.mix_smooth(*args, block_size=128)
    got_ex = mf.mix_smooth(*args, block_size=128, extrapolate=True)

    np.testing.assert_allclose(np.asarray(got_lp), np.asarray(ref_lp),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(ref_s),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got_cov), np.asarray(ref_cov),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_sm), np.asarray(ref_sm),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.asarray(got_ex), np.asarray(ref_ex),
                               rtol=1e-3, atol=1e-3)


def test_mix_em_stats_pat_s_slab_matches(rng):
    """The pattern-mixture Souter under config.s_slab_stats (compute only
    the ml._sm_slabs tril wedge of s s^T, carry packed, unpack after the
    scan) == the full contraction exactly where mix_em_finalize reads
    (tril of S; every other statistic verbatim).  Covers both Souter
    groupings (P <= D and P > D) and k unaligned to the slab width."""
    import jax.numpy as jnp

    from ppca_rs_tpu.config import config
    from ppca_rs_tpu.ops import mix_fused as mf

    for k, P, D in ((11, 4, 16), (16, 24, 8)):
        M, B = 2, 96
        Cs = jnp.asarray(rng.normal(size=(M, D, k)))
        means = jnp.asarray(rng.normal(size=(M, D)))
        sigmas = jnp.asarray(0.5 + rng.random(M))
        lw = jnp.log(jnp.full((M,), 1.0 / M))
        patterns = jnp.asarray(rng.random((P, D)) > 0.3)
        pidx = jnp.asarray(rng.integers(0, P, size=B), jnp.int32)
        data = jnp.asarray(rng.normal(size=(B, D))) * patterns[pidx]
        w = jnp.asarray(rng.random(B) + 0.5)
        mask = patterns[pidx]

        args = (Cs, means, sigmas, lw, data, mask, pidx, patterns, w)
        old = config.s_slab_stats
        try:
            config.s_slab_stats = False
            ref = mf.mix_em_stats_pat(*args, block_size=64)
            config.s_slab_stats = True
            got = mf.mix_em_stats_pat(*args, block_size=64)
        finally:
            config.s_slab_stats = old

        tril = np.tril(np.ones((k, k)))
        S_ref = np.asarray(ref.S, np.float64).reshape(M, D, k, k) * tril
        S_got = np.asarray(got.S, np.float64).reshape(M, D, k, k) * tril
        np.testing.assert_allclose(S_got, S_ref, rtol=1e-9, atol=1e-11)
        for name in ("cross", "square_error", "dev_sq", "total_dev",
                     "totals", "resp_sum", "resp_max", "llk"):
            np.testing.assert_allclose(
                np.asarray(getattr(got, name)), np.asarray(getattr(ref, name)),
                rtol=1e-9, atol=1e-11, err_msg=name)


def test_mix_readout_gates_use_per_verb_want(rng, monkeypatch):
    """Regression: each mixture readout must ask the router for its own
    variant ('llk' / 'infer' / 'states'), so a per-variant route (the
    kernel serves some variants and not others) reaches every verb."""
    import jax.numpy as jnp
    from ppca_rs_tpu.ops import masked_linalg as ml
    from ppca_rs_tpu.ops import mix_fused as mf

    seen = []

    def spy(k, dtype, want, sharded, platform=None):
        seen.append(want)
        return "xla"  # no kernel runs on CPU

    monkeypatch.setattr(ml, "spd_route", spy)
    M, B, D, k = 2, 32, 8, 3
    Cs = jnp.asarray(rng.normal(size=(M, D, k)), jnp.float32)
    means = jnp.zeros((M, D), jnp.float32)
    sigmas = jnp.ones((M,), jnp.float32)
    lw = jnp.zeros((M,), jnp.float32)
    data = jnp.asarray(rng.normal(size=(B, D)), jnp.float32)
    mask = jnp.ones((B, D), bool)

    mf.mix_llks(Cs, means, sigmas, data, mask, block_size=32)
    mf.mix_infer(Cs, means, sigmas, lw, data, mask, block_size=32)
    mf.mix_smooth(Cs, means, sigmas, lw, data, mask, block_size=32)
    assert seen == ["llk", "infer", "states"], seen


def test_mix_pattern_grouped_estep_matches(rng):
    """config.pat_grouped_estep in the pattern-mixture path (per-component
    candidate matmuls for the states + pattern-grouped c2/rm corrections
    applied at assembly) is an exact reordering: every MixEMStats field and
    the readout verbs match the ungrouped path to f64 roundoff, on both
    sides of the sall candidates bound."""
    import jax.numpy as jnp
    from ppca_rs_tpu.config import config
    from ppca_rs_tpu.ops import mix_fused as mf
    from ppca_rs_tpu.ops import pattern_dedup as pd

    M, B, D, k, P = 3, 96, 16, 5, 4
    Cs = jnp.asarray(rng.normal(size=(M, D, k)))
    means = jnp.asarray(rng.normal(size=(M, D)))
    sigmas = jnp.asarray(0.5 + rng.random(M))
    lw = jnp.log(jnp.full((M,), 1.0 / M))
    patterns = jnp.asarray(rng.random((P, D)) > 0.3)
    pidx = jnp.asarray(rng.integers(0, P, size=B), jnp.int32)
    data = jnp.asarray(rng.normal(size=(B, D))) * patterns[pidx]
    w = jnp.asarray(rng.random(B) + 0.25)
    mask = patterns[pidx]

    em_args = (Cs, means, sigmas, lw, data, mask, pidx, patterns, w)

    def readouts():
        st = mf.mix_em_stats_pat(*em_args, block_size=32)
        lk = mf.mix_llks(Cs, means, sigmas, data, mask, block_size=32,
                         pidx=pidx, patterns=patterns)
        sm = mf.mix_smooth(Cs, means, sigmas, lw, data, mask, block_size=32,
                           pidx=pidx, patterns=patterns)
        inf = mf.mix_infer(Cs, means, sigmas, lw, data, mask, block_size=32,
                           pidx=pidx, patterns=patterns)
        return (st, lk, sm, inf)

    old = config.pat_grouped_estep
    old_bound = pd._SALL_MAX_PK
    try:
        config.pat_grouped_estep = False
        ref = readouts()
        config.pat_grouped_estep = True
        for bound in (old_bound, 1):   # candidates matmul / gather fallback
            pd._SALL_MAX_PK = bound
            got = readouts()
            import jax
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           rtol=1e-9, atol=1e-11)
    finally:
        config.pat_grouped_estep = old
        pd._SALL_MAX_PK = old_bound


def test_mix_pattern_sorted_path(rng, monkeypatch):
    """mix_em_stats_pat_sorted is an exact reordering of the grouped path
    (every MixEMStats field, both rnorm modes, garbage at masked data,
    zero-count pattern), and PPCAMix EM routes through it when
    config.pat_sorted_estep is on, producing the same mixture."""
    import jax.numpy as jnp
    from ppca_rs_tpu import Dataset, PPCAMix
    from ppca_rs_tpu.config import config
    from ppca_rs_tpu.ops import mix_fused as mf

    M, N, D, k, P = 3, 311, 24, 7, 5
    monkeypatch.setattr(config, "pat_sorted_min_rows", 0)  # tiny parity shapes
    pats = rng.random((P, D)) < 0.55
    pats[0] = False
    pidx = rng.integers(0, P, size=N)
    pidx = np.where(pidx == 2, 3, pidx)              # zero-count pattern
    Cs = jnp.asarray(rng.normal(size=(M, D, k)))
    means = jnp.asarray(rng.normal(size=(M, D)))
    sigmas = jnp.asarray(0.5 + rng.random(M))
    lw = jnp.log(jnp.asarray(rng.dirichlet(np.ones(M))))
    data = rng.normal(size=(N, D))
    mask = pats[pidx]
    dz = np.where(mask, data, 0.0)
    w = rng.random(N) + 0.25
    w[3] = 0.0

    perm = np.argsort(pidx, kind="stable")
    counts = tuple(int(c) for c in np.bincount(pidx, minlength=P))
    poison = np.where(mask, data, 77.7)
    for exact in (False, True):
        monkeypatch.setattr(config, "mix_exact_rnorm", exact)
        ref = mf.mix_em_stats_pat(
            Cs, means, sigmas, lw, jnp.asarray(dz), jnp.asarray(mask),
            jnp.asarray(pidx, jnp.int32), jnp.asarray(pats), jnp.asarray(w),
            block_size=64)
        got = mf.mix_em_stats_pat_sorted(
            Cs, means, sigmas, lw, jnp.asarray(poison[perm]),
            jnp.asarray(w[perm]), jnp.asarray(pats), counts, block_size=64)
        for name in ref._fields:
            np.testing.assert_allclose(
                np.asarray(getattr(got, name)), np.asarray(getattr(ref, name)),
                rtol=1e-9, atol=1e-11, err_msg=f"{name} exact={exact}")

    # end-to-end routing: PPCAMix.iterate equal through both paths
    values = np.where(mask, data, np.nan)
    monkeypatch.setattr(config, "pat_sorted_estep", False)
    ds_a = Dataset(values, weights=w)
    mix = PPCAMix.init(M, k, ds_a, key=jax.random.PRNGKey(0))
    ref_mix = mix.iterate(ds_a)
    monkeypatch.setattr(config, "pat_sorted_estep", True)
    ds_b = Dataset(values, weights=w)
    assert ds_b.pattern_order() is not None
    calls = []
    orig = mf.mix_em_stats_pat_sorted
    monkeypatch.setattr(mf, "mix_em_stats_pat_sorted",
                        lambda *a, **kw: (calls.append(1), orig(*a, **kw))[1])
    got_mix = mix.iterate(ds_b)
    assert calls, "sorted mixture path did not engage"
    for a, b in zip(got_mix._models, ref_mix._models):
        np.testing.assert_allclose(np.asarray(a._transform),
                                   np.asarray(b._transform),
                                   rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(got_mix._log_weights),
                               np.asarray(ref_mix._log_weights),
                               rtol=1e-9, atol=1e-11)
