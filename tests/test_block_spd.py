"""Blocked Schur-complement inversion (ops/block_spd.py) — the size-generic
large-k route (`output_covariance.rs:72-121` is unbounded in k).

CPU coverage: the recursion against numpy (f64), and the masked_linalg
routing (``spd_route`` forced to "blocked") against the default XLA path.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from ppca_rs_tpu.ops import block_spd, masked_linalg as ml


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _spd(rng, B, k, jitter=0.5, dtype=np.float64):
    X = rng.normal(size=(B, k, k))
    M = X @ np.swapaxes(X, -1, -2) + jitter * np.eye(k)
    return M.astype(dtype)


@pytest.mark.parametrize(
    "B,k,base",
    [
        (4, 16, 16),    # exactly one base call
        (4, 40, 16),    # two levels, non-multiple split
        (3, 57, 16),    # odd k
        (2, 200, 32),   # three levels
    ],
)
def test_recursion_matches_numpy(rng, B, k, base):
    M = _spd(rng, B, k)
    Minv, ld = block_spd.inv_logdet(
        jnp.asarray(M), base=base, base_fn=block_spd.base_inv_logdet_xla
    )
    ref_inv = np.linalg.inv(M)
    ref_ld = np.linalg.slogdet(M)[1]
    np.testing.assert_allclose(np.asarray(Minv), ref_inv, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(np.asarray(ld), ref_ld, rtol=1e-10)


def test_singular_matrix_stays_per_sample(rng):
    """A singular matrix in the batch NaNs/infs out only its own entry —
    the neighboring samples' inverses stay exact (the keep-old-row /
    per-row isfinite guards downstream rely on this)."""
    B, k = 3, 40
    M = _spd(rng, B, k)
    M[1] = 0.0  # exactly singular
    Minv, ld = block_spd.inv_logdet(
        jnp.asarray(M), base=16, base_fn=block_spd.base_inv_logdet_xla
    )
    good = np.asarray(Minv)[[0, 2]]
    ref = np.linalg.inv(M[[0, 2]])
    np.testing.assert_allclose(good, ref, rtol=1e-9, atol=1e-10)
    assert not np.all(np.isfinite(np.asarray(Minv)[1]))


def _force_blocked(monkeypatch, base):
    """Route masked_linalg through the blocked path on CPU, recursion
    exercised via a small base."""
    monkeypatch.setattr(ml, "spd_route", lambda *a, **kw: "blocked")
    monkeypatch.setattr(
        block_spd, "inv_logdet", functools.partial(block_spd.inv_logdet, base=base)
    )


def test_blocked_verbs_match_default(rng, monkeypatch):
    """llks / infer / states / em_stats through the blocked path == the
    default XLA path (f64, masked data with all-masked and zero-weight
    rows)."""
    B, D, k = 64, 48, 20
    C = jnp.asarray(rng.normal(size=(D, k)))
    mean = jnp.asarray(rng.normal(size=D))
    sig = jnp.asarray(0.7)
    data = jnp.asarray(rng.normal(size=(B, D)))
    mask = jnp.asarray(rng.random((B, D)) > 0.4)
    mask = mask.at[3].set(False)
    data = jnp.where(mask, data, 0.0)
    w = jnp.asarray(rng.random(B) + 0.5)
    w = w.at[7].set(0.0)

    ref_llks = ml.llks(C, mean, sig, data, mask, block_size=32)
    ref_s, ref_cov = ml.infer(C, mean, sig, data, mask, block_size=32)
    ref_states = ml.states(C, mean, sig, data, mask, block_size=32)
    ref_stats = ml.em_stats(C, mean, sig, data, mask, w, block_size=32)

    _force_blocked(monkeypatch, base=8)

    got_llks = ml.llks(C, mean, sig, data, mask, block_size=32)
    got_s, got_cov = ml.infer(C, mean, sig, data, mask, block_size=32)
    got_states = ml.states(C, mean, sig, data, mask, block_size=32)
    got_stats = ml.em_stats(C, mean, sig, data, mask, w, block_size=32)

    np.testing.assert_allclose(np.asarray(got_llks), np.asarray(ref_llks), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(got_s), np.asarray(ref_s),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(got_cov), np.asarray(ref_cov),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(got_states), np.asarray(ref_states),
                               rtol=1e-8, atol=1e-10)
    for a, b in zip(got_stats, ref_stats):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-8, atol=1e-9)


def test_blocked_mixture_verbs_match_default(rng, monkeypatch):
    """mix_llks / mix_infer / mix_em_stats through the blocked fallback ==
    the cholesky fallback (f64; also covers _block_mix_fast's blocked
    branch via mix_em_stats and mix_em_finalize's blocked M-step solve)."""
    from ppca_rs_tpu.ops import mix_fused as mf

    Mc, B, D, k = 3, 48, 32, 10
    Cs = jnp.asarray(rng.normal(size=(Mc, D, k)))
    means = jnp.asarray(rng.normal(size=(Mc, D)))
    sigmas = jnp.asarray(rng.random(Mc) + 0.5)
    lw = jnp.log(jnp.full(Mc, 1.0 / Mc))
    data = jnp.asarray(rng.normal(size=(B, D)))
    mask = jnp.asarray(rng.random((B, D)) > 0.4)
    mask = mask.at[3].set(False)
    data = jnp.where(mask, data, 0.0)
    w = jnp.asarray(rng.random(B) + 0.5)

    ref_llks = mf.mix_llks(Cs, means, sigmas, data, mask, block_size=16)
    ref_inf = mf.mix_infer(Cs, means, sigmas, lw, data, mask, block_size=16)
    ref_stats = mf.mix_em_stats(Cs, means, sigmas, lw, data, mask, w, block_size=16)
    ref_fin = mf.mix_em_finalize(Cs, means, sigmas, ref_stats,
                                 transformation_precision=0.0)

    _force_blocked(monkeypatch, base=8)

    got_llks = mf.mix_llks(Cs, means, sigmas, data, mask, block_size=16)
    got_inf = mf.mix_infer(Cs, means, sigmas, lw, data, mask, block_size=16)
    got_stats = mf.mix_em_stats(Cs, means, sigmas, lw, data, mask, w, block_size=16)
    got_fin = mf.mix_em_finalize(Cs, means, sigmas, got_stats,
                                 transformation_precision=0.0)

    np.testing.assert_allclose(np.asarray(got_llks), np.asarray(ref_llks),
                               rtol=1e-8, atol=1e-10)
    for a, b in zip(got_inf, ref_inf):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-7, atol=1e-9)
    for a, b in zip(got_stats, ref_stats):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-7, atol=1e-9)
    for a, b in zip(got_fin, ref_fin):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-7, atol=1e-9)


def test_em_finalize_blocked_solve(rng, monkeypatch):
    """em_finalize's M-step solve through the blocked inverse == the LU
    solve, and an exactly-singular row (empty dimension, lambda = 0) still
    takes the keep-old-row fallback."""
    D, k = 30, 12
    C_old = jnp.asarray(rng.normal(size=(D, k)))
    mean = jnp.asarray(rng.normal(size=D))
    sig = jnp.asarray(0.7)
    V = rng.normal(size=(D, k, 2 * k)) / np.sqrt(2 * k)
    S = V @ np.swapaxes(V, -1, -2) + 0.05 * np.eye(k)
    S[5] = 0.0  # empty dimension: S row all zero, lambda = 0 -> singular
    stats = ml.EMStats(
        cross=jnp.asarray(rng.normal(size=(D, k))).at[5].set(0.0),
        S=jnp.asarray(S.reshape(D, k * k)),
        square_error=jnp.asarray(1.0),
        dev_sq=jnp.asarray(1.0),
        total_dev=jnp.zeros(D),
        totals=jnp.full(D, 7.0),
        llk=jnp.asarray(0.0),
    )
    ref = ml.em_finalize(C_old, mean, sig, stats, transformation_precision=0.0)

    monkeypatch.setattr(ml, "spd_route", lambda *a, **kw: "blocked")
    monkeypatch.setattr(
        block_spd, "inv_logdet", functools.partial(block_spd.inv_logdet, base=8)
    )
    got = ml.em_finalize(C_old, mean, sig, stats, transformation_precision=0.0)

    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               rtol=1e-7, atol=1e-9)
    # row 5 is the keep-old-row fallback in BOTH paths
    np.testing.assert_allclose(np.asarray(got[0][5]), np.asarray(C_old[5]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(ref[1]), rtol=1e-12)
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-12)


def test_block_size_for_shrinks_past_ceiling():
    """block_size_for caps the block in the large-k regime and is
    unchanged at kernel-supported state sizes."""
    from ppca_rs_tpu.config import block_size_for, config
    from ppca_rs_tpu.ops import kernels

    assert block_size_for(10**6, 64) == config.block_size
    assert block_size_for(10**6, kernels.MAX_K) == config.block_size
    assert block_size_for(10**6, 256) < config.block_size
    big = block_size_for(10**6, 512)
    assert big < config.block_size
    assert big * 512 * 512 * 16 <= (2 << 30)
    assert block_size_for(10**6) == config.block_size


def test_solve_psd_chunked_matches_unchunked(rng, monkeypatch):
    """solve_psd's lax.map batch chunking (identity-padded tail chunk) must
    be exact vs the single-shot path, including a batch not a multiple of
    the chunk size."""
    from ppca_rs_tpu.ops import block_spd

    k, B = 12, 333
    A = rng.normal(size=(B, k, k))
    S = jnp.asarray(A @ np.swapaxes(A, -1, -2) + 3.0 * np.eye(k), jnp.float64)
    rhs = jnp.asarray(rng.normal(size=(B, k)), jnp.float64)

    ref = block_spd.solve_psd(S, rhs, 0.5)
    monkeypatch.setattr(block_spd, "solve_rows", lambda kk: 128)
    got = block_spd.solve_psd(S, rhs, 0.5)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-12, atol=1e-13)


def test_block_size_for_counts_mixture_components():
    """The blocked-regime block shrink must scale with the number of
    mixture components: the per-block problems stack M * block rows."""
    from ppca_rs_tpu.config import block_size_for

    b1 = block_size_for(1 << 22, 512)
    b8 = block_size_for(1 << 22, 512, m=8)
    assert b1 == 512  # single model: 512 * 512^2 * 16 B ~ 2 GiB
    assert b8 == 128  # M=8 shrinks to the 128-row floor
    b4 = block_size_for(1 << 22, 320, m=4)
    assert b4 * 4 * 320 * 320 * 16 <= (2 << 30)
