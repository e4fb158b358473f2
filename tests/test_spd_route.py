"""The SPD router (masked_linalg.spd_route) and the verbs it sends to the
kernel, run here with the kernel in Pallas interpret mode and compared
with the XLA route."""

import functools

import numpy as np
import pytest

import jax.numpy as jnp

from ppca_rs_tpu.config import config
from ppca_rs_tpu.ops import kernels, masked_linalg as ml

WANTS = ["llk", "states", "fullt", "infer", "rows"]


@pytest.fixture
def rng():
    return np.random.default_rng(11)


@pytest.mark.parametrize("want", WANTS)
@pytest.mark.parametrize("k", [1, 64, 65, 384])
def test_cpu_routes_to_xla(k, want):
    assert ml.spd_route(k, jnp.float32, want, False, platform="cpu") == "xla"


@pytest.mark.parametrize("want", WANTS)
def test_gpu_kernel_up_to_ceiling(want):
    for k in (1, 13, kernels.MAX_K):
        assert ml.spd_route(k, jnp.float32, want, False, platform="gpu") == "kernel"


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_unknown_want_is_an_error(platform):
    with pytest.raises(ValueError):
        ml.spd_route(8, jnp.float32, "full", False, platform=platform)


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("want", WANTS)
def test_gpu_past_ceiling(monkeypatch, want, blocked):
    """Past the kernel's ceiling XLA serves until the blocked inverse would
    recurse (k > block_spd.BASE); from there the flag picks the route."""
    from ppca_rs_tpu.ops import block_spd

    monkeypatch.setattr(config, "use_blocked_large_k", blocked)
    for k in (kernels.MAX_K + 1, block_spd.BASE):
        assert ml.spd_route(k, jnp.float32, want, False, platform="gpu") == "xla"
    for k in (block_spd.BASE + 1, 384):
        got = ml.spd_route(k, jnp.float32, want, False, platform="gpu")
        assert got == ("blocked" if blocked else "xla")


@pytest.mark.parametrize("want", WANTS)
def test_gpu_sharded_d_never_takes_the_kernel(want):
    for k in (8, 64, 384):
        assert ml.spd_route(k, jnp.float32, want, True, platform="gpu") == "xla"


def test_gpu_non_f32_and_empty_state_stay_on_xla(monkeypatch):
    assert ml.spd_route(32, jnp.float64, "fullt", False, platform="gpu") == "xla"
    assert ml.spd_route(32, jnp.bfloat16, "fullt", False, platform="gpu") == "xla"
    assert ml.spd_route(0, jnp.float32, "fullt", False, platform="gpu") == "xla"
    monkeypatch.setattr(config, "use_pallas", False)
    assert ml.spd_route(32, jnp.float32, "fullt", False, platform="gpu") == "xla"


def _masked(rng, B, D, k, dtype=jnp.float32):
    C = jnp.asarray(rng.normal(size=(D, k)) / np.sqrt(D) * 3, dtype)
    mean = jnp.asarray(rng.normal(size=D), dtype)
    data = jnp.asarray(rng.normal(size=(B, D)), dtype)
    mask = jnp.asarray(rng.random((B, D)) > 0.4)
    mask = mask.at[3].set(False)
    data = jnp.where(mask, data, 0.0)
    w = jnp.asarray(rng.random(B) + 0.5, dtype).at[5].set(0.0)
    return C, mean, jnp.asarray(0.7, dtype), data, mask, w


def _route_kernel(monkeypatch, calls=None):
    """Send every SPD call to the kernel, run in interpret mode; record
    whether any caller asked for interpret mode itself."""
    real = kernels.spd_estep

    def spy(*a, **kw):
        if calls is not None:
            calls.append(kw.get("interpret", False))
        return real(*a, **{**kw, "interpret": True})

    monkeypatch.setattr(ml, "spd_route", lambda *a, **kw: "kernel")
    monkeypatch.setattr(kernels, "spd_estep", spy)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.mark.parametrize("k", [5, 16])
def test_kernel_routed_em_stats_matches_xla(rng, monkeypatch, k):
    C, mean, sig, data, mask, w = _masked(rng, 70, 24, k)
    ref = ml.em_stats(C, mean, sig, data, mask, w, block_size=32)
    _route_kernel(monkeypatch)
    got = ml.em_stats(C, mean, sig, data, mask, w, block_size=32)
    for name, a, b in zip(ref._fields, got, ref):
        assert _rel(a, b) < 2e-4, name


def test_kernel_routed_readouts_match_xla(rng, monkeypatch):
    C, mean, sig, data, mask, _ = _masked(rng, 40, 20, 6)
    ref_llk = ml.llks(C, mean, sig, data, mask, block_size=16)
    ref_s, ref_cov = ml.infer(C, mean, sig, data, mask, block_size=16)
    _route_kernel(monkeypatch)
    got_llk = ml.llks(C, mean, sig, data, mask, block_size=16)
    got_s, got_cov = ml.infer(C, mean, sig, data, mask, block_size=16)
    assert _rel(got_llk, ref_llk) < 1e-5
    assert _rel(got_s, ref_s) < 1e-4
    assert _rel(got_cov, ref_cov) < 1e-4


def test_kernel_routed_em_finalize_matches_solve(rng, monkeypatch):
    D, k = 30, 12
    C_old = jnp.asarray(rng.normal(size=(D, k)), jnp.float32)
    V = rng.normal(size=(D, k, 2 * k)) / np.sqrt(2 * k)
    S = V @ np.swapaxes(V, -1, -2) + 0.05 * np.eye(k)
    S[5] = 0.0  # empty dimension with lambda = 0: singular
    stats = ml.EMStats(
        cross=jnp.asarray(rng.normal(size=(D, k)), jnp.float32).at[5].set(0.0),
        S=jnp.asarray(S.reshape(D, k * k), jnp.float32),
        square_error=jnp.asarray(1.0), dev_sq=jnp.asarray(1.0),
        total_dev=jnp.zeros(D), totals=jnp.full(D, 7.0), llk=jnp.asarray(0.0),
    )
    mean, sig = jnp.zeros(D, jnp.float32), jnp.asarray(0.7, jnp.float32)
    ref = ml.em_finalize(C_old, mean, sig, stats, transformation_precision=0.0)
    _route_kernel(monkeypatch)
    got = ml.em_finalize(C_old, mean, sig, stats, transformation_precision=0.0)
    assert _rel(got[0], ref[0]) < 1e-4
    np.testing.assert_array_equal(np.asarray(got[0][5]), np.asarray(C_old[5]))


def test_model_paths_never_ask_for_interpret_mode(rng, monkeypatch):
    """Interpret mode is a test-only argument: no library call site passes
    it, so a device run always compiles the kernel."""
    from ppca_rs_tpu.ops import mix_fused as mf

    calls = []
    _route_kernel(monkeypatch, calls)
    C, mean, sig, data, mask, w = _masked(rng, 40, 16, 4)
    ml.llks(C, mean, sig, data, mask, block_size=16)
    ml.infer(C, mean, sig, data, mask, block_size=16)
    stats = ml.em_stats(C, mean, sig, data, mask, w, block_size=16)
    ml.em_finalize(C, mean, sig, stats, transformation_precision=0.0)
    Cs, means = jnp.stack([C, 0.5 * C]), jnp.stack([mean, -mean])
    sigmas, lw = jnp.asarray([0.7, 0.9], jnp.float32), jnp.log(jnp.full(2, 0.5))
    mf.mix_llks(Cs, means, sigmas, data, mask, block_size=16)
    mst = mf.mix_em_stats(Cs, means, sigmas, lw, data, mask, w, block_size=16)
    mf.mix_em_finalize(Cs, means, sigmas, mst, transformation_precision=0.0)
    assert calls and not any(calls), calls


def test_kernel_routed_training_matches_xla(rng, monkeypatch):
    """A few EM iterations through the public trainer, kernel-routed vs
    XLA-routed (f32), end at the same model."""
    from ppca_rs_tpu import Dataset, PPCATrainer

    X = rng.normal(size=(96, 3)) @ rng.normal(size=(3, 18)) + 0.3 * rng.normal(size=(96, 18))
    M = rng.random(X.shape) > 0.3
    ds = Dataset.from_parts(np.where(M, X, 0.0).astype(np.float32), M)

    def train():
        import jax

        with jax.default_matmul_precision("highest"):
            m = PPCATrainer(ds).train(state_size=3, n_iters=4, quiet=True,
                                      key=jax.random.PRNGKey(3))
        return m.llk(ds)

    import jax

    calls = []
    ref = train()
    _route_kernel(monkeypatch, calls)
    jax.clear_caches()  # the route is fixed when a verb is traced
    got = train()
    jax.clear_caches()
    assert calls, "the kernel never ran"
    assert abs(got - ref) <= 1e-4 * abs(ref)


def test_block_size_unchanged_up_to_ceiling():
    from ppca_rs_tpu.config import block_size_for

    for k in (1, 32, kernels.MAX_K):
        assert block_size_for(10**7, k) == config.block_size
    assert block_size_for(10**7, 2 * kernels.MAX_K) <= config.block_size


def test_interpret_partial_is_a_plain_call(rng):
    """functools.partial(spd_estep, interpret=True) — the form tests use —
    returns the same outputs as passing the flag directly."""
    k, B = 6, 5
    G = jnp.asarray(np.eye(k)[None].repeat(B, 0) * 2.0, jnp.float32)
    b = jnp.asarray(rng.normal(size=(B, k)), jnp.float32)
    z = jnp.zeros((B,), jnp.float32)
    f = functools.partial(kernels.spd_estep, interpret=True)
    s1, _ = f(G, b, z, z, 1.0, want="states")
    s2, _ = kernels.spd_estep(G, b, z, z, 1.0, want="states", interpret=True)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    np.testing.assert_allclose(np.asarray(s1), np.asarray(b) / 3.0, rtol=1e-6)
