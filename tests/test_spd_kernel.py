"""The fused SPD E-step kernel (ops/kernels.py) in Pallas interpret mode.

Every variant is checked against the plain per-sample algebra in f64
(``M = sigma^2 I + G``, its inverse and log-determinant), over state sizes
that exercise the power-of-two padding of k (2, 13, 80), several samples per
program (2, 13, 32) and one sample per program (64, 80), with batches that
are not a multiple of the samples per program.  The compiled GPU kernel
itself runs in ``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from ppca_rs_tpu.ops import kernels

LN_2PI = kernels.LN_2PI


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _problem(rng, B, k, per_sample_sigma=True, empty=(0,)):
    D = 2 * k + 3
    C = rng.normal(size=(D, k)) / np.sqrt(D)
    mask = (rng.random((B, D)) > 0.4).astype(np.float64)
    for i in empty:
        mask[i] = 0.0
    G = np.einsum("bd,di,dj->bij", mask, C, C)
    b = rng.normal(size=(B, k)) * mask.sum(1, keepdims=True) ** 0.5 / 4
    for i in empty:
        b[i] = 0.0
    d_obs = mask.sum(1)
    rnorm = np.sum(b * b, axis=1) * 3.0 + d_obs
    sigma = 0.3 + rng.random(B) if per_sample_sigma else np.float64(0.6)
    return G, b, rnorm, d_obs, sigma


def _reference(G, b, rnorm, d_obs, sigma):
    """The XLA route's semantics (masked_linalg.block_*), in f64 numpy."""
    B, k, _ = G.shape
    s2 = np.broadcast_to(np.asarray(sigma, np.float64) ** 2, (B,))
    M = G + s2[:, None, None] * np.eye(k)
    Minv = np.linalg.inv(M)
    s = np.einsum("bij,bj->bi", Minv, b)
    logdet = np.linalg.slogdet(M)[1] + np.log(s2) * (d_obs - k)
    quad = (rnorm - np.sum(b * s, axis=1)) / s2
    llk = -0.5 * (quad + logdet + LN_2PI * d_obs)
    Sigma = s2[:, None, None] * Minv
    SM = s[:, :, None] * s[:, None, :] + Sigma
    sq = np.einsum("bij,bij->b", G, Sigma)
    return {"s": s, "Sigma": Sigma, "SM": SM, "llk": llk, "sq": sq}


def _run(G, b, rnorm, d_obs, sigma, want):
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    return kernels.spd_estep(f32(G), f32(b), f32(rnorm), f32(d_obs), f32(sigma),
                             want=want, interpret=True)


def _close(got, ref, rtol):
    got = np.asarray(got, np.float64)
    scale = np.abs(ref).max() + 1e-30
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= rtol * scale, np.abs(got - ref).max() / scale


OUTPUTS = {
    "llk": ("llk",),
    "states": ("s", "llk"),
    "fullt": ("s", "SM", "llk", "sq"),
    "infer": ("s", "Sigma", "llk"),
}


@pytest.mark.parametrize("want", ["llk", "states", "fullt", "infer"])
@pytest.mark.parametrize("k", [2, 13, 32, 64, 80])
def test_variant_matches_reference(rng, k, want):
    B = 11
    prob = _problem(rng, B, k)
    ref = _reference(*prob)
    out = _run(*prob, want)
    out = out if isinstance(out, tuple) else (out,)
    assert len(out) == len(OUTPUTS[want])
    for name, got in zip(OUTPUTS[want], out):
        _close(got, ref[name], 2e-5)


@pytest.mark.parametrize("want", ["llk", "states", "fullt", "infer"])
def test_empty_sample_is_neutral(rng, want):
    """An all-masked sample (G = 0, b = 0, rnorm = 0, d_obs = 0) has llk
    exactly 0, state 0 and covariance I — the reference's ``uninferred``
    (`ppca_model.rs:98-104,124-129`)."""
    k = 13
    G, b, rnorm, d_obs, sigma = _problem(rng, 5, k, empty=(0, 3))
    out = _run(G, b, rnorm, d_obs, sigma, want)
    out = dict(zip(OUTPUTS[want], out if isinstance(out, tuple) else (out,)))
    for i in (0, 3):
        assert abs(float(out["llk"][i])) < 1e-5
        if "s" in out:
            np.testing.assert_allclose(np.asarray(out["s"][i]), 0.0, atol=1e-7)
        if "Sigma" in out:
            np.testing.assert_allclose(np.asarray(out["Sigma"][i]), np.eye(k),
                                       atol=1e-5)
        if "SM" in out:
            np.testing.assert_allclose(np.asarray(out["SM"][i]), np.eye(k),
                                       atol=1e-5)
            assert abs(float(out["sq"][i])) < 1e-5


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("k", [5, 32])
def test_scalar_and_per_sample_sigma(rng, k, per_sample):
    """The mixture stacks components with different noise levels, one sigma
    per sample; single models pass a scalar."""
    prob = _problem(rng, 9, k, per_sample_sigma=per_sample)
    ref = _reference(*prob)
    s, SM, llk, sq = _run(*prob, "fullt")
    _close(s, ref["s"], 2e-5)
    _close(SM, ref["SM"], 2e-5)
    _close(llk, ref["llk"], 2e-5)
    _close(sq, ref["sq"], 2e-5)


@pytest.mark.parametrize(
    "k,B,kp,S",
    [(1, 3, 8, 4), (2, 100, 8, 64), (13, 37, 16, 16), (32, 5, 32, 4),
     (64, 9, 64, 1), (80, 2, 128, 1)],
)
def test_padding_and_program_shape(k, B, kp, S):
    """k pads to a power of two (at least 8), a program owns about one
    4096-element tile of samples (never more than the batch needs), and
    every output comes back at the caller's (B, k) shapes."""
    assert kernels.padded_k(k) == kp
    assert kernels.samples_per_program(k, B) == S
    G = jnp.broadcast_to(jnp.eye(k, dtype=jnp.float32), (B, k, k))
    z = jnp.zeros((B,), jnp.float32)
    s, SM, llk, sq = kernels.spd_estep(G, jnp.zeros((B, k), jnp.float32), z, z,
                                       1.0, want="fullt", interpret=True)
    assert s.shape == (B, k) and SM.shape == (B, k, k)
    assert llk.shape == (B,) and sq.shape == (B,)
    # G = I, sigma = 1: M = 2I, Sigma = I/2, logdet M = k log 2
    np.testing.assert_allclose(np.asarray(SM), np.broadcast_to(np.eye(k) / 2, (B, k, k)),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(llk), -0.5 * k * np.log(2.0), rtol=1e-5)


def test_singular_row_goes_nonfinite_alone(rng):
    """The M-step row solve through the kernel (sigma^2 = lam = 0): an
    exactly singular row (an empty dimension) goes non-finite for that row
    only, and the padded state dims never do (their diagonal is 1, not
    lam)."""
    from ppca_rs_tpu.ops import masked_linalg as ml

    D, k = 12, 13
    V = rng.normal(size=(D, k, 2 * k)) / np.sqrt(2 * k)
    S = V @ np.swapaxes(V, -1, -2) + 0.05 * np.eye(k)
    S[4] = 0.0
    cross = rng.normal(size=(D, k))
    sol = np.asarray(ml._kernel_rows_solve(jnp.asarray(S, jnp.float32),
                                           jnp.asarray(cross, jnp.float32),
                                           0.0, interpret=True))
    assert not np.all(np.isfinite(sol[4]))
    good = [d for d in range(D) if d != 4]
    assert np.all(np.isfinite(sol[good]))
    ref = np.linalg.solve(S[good], cross[good][..., None])[..., 0]
    _close(sol[good], ref, 1e-4)
