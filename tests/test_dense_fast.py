"""Fully-observed fast path (ops/dense_fast.py) vs the masked path.

A fully-observed dataset must produce identical results through the dense
shortcut (one shared k x k solve) and through the generic masked machinery
with an all-True mask — on a single device and on an 8-device mesh.
"""

import numpy as np
import pytest

import jax

from ppca_rs_tpu import Dataset, PPCAModel, PPCATrainer, Prior, config
from ppca_rs_tpu.parallel.mesh import make_mesh, shard_dataset


def make_pair(rng, n=64, d=10, k=3):
    """(dense-flagged dataset, force-masked-path dataset) with same values."""
    C = rng.normal(size=(d, k))
    mean = rng.normal(size=d)
    data = rng.normal(size=(n, d)) + mean
    weights = rng.random(n) + 0.5
    model = PPCAModel(isotropic_noise=0.4, transform=C, mean=mean)
    ds = Dataset(data, weights=weights)
    assert ds.all_observed()
    masked_ds = Dataset(data, weights=weights)
    masked_ds._all_observed = False  # force the generic masked machinery
    return model, ds, masked_ds


def test_dense_matches_masked(rng):
    model, ds, masked_ds = make_pair(rng)
    np.testing.assert_allclose(model.llks(ds), model.llks(masked_ds), rtol=1e-9)
    assert np.isclose(model.llk(ds), model.llk(masked_ds), rtol=1e-10)

    inf_d = model.infer(ds)
    inf_m = model.infer(masked_ds)
    np.testing.assert_allclose(inf_d.states(), inf_m.states(), rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(
        inf_d.covariances_array(), inf_m.covariances_array(), rtol=1e-8, atol=1e-12
    )

    np.testing.assert_allclose(
        model.smooth(ds).numpy(), model.smooth(masked_ds).numpy(), rtol=1e-8
    )
    np.testing.assert_allclose(model.extrapolate(ds).numpy(), ds.numpy(), rtol=1e-12)


@pytest.mark.parametrize("prior_kind", ["none", "all"])
def test_dense_em_matches_masked(rng, prior_kind):
    model, ds, masked_ds = make_pair(rng, n=80, d=8, k=3)
    prior = None
    if prior_kind == "all":
        prior = (
            Prior()
            .with_isotropic_noise_prior(2.0, 3.0)
            .with_transformation_precision(0.4)
            .with_mean_prior(rng.normal(size=8), np.eye(8) * 0.6)
        )
    if prior is None:
        m_d, m_m = model.iterate(ds), model.iterate(masked_ds)
    else:
        m_d = model.iterate_with_prior(ds, prior)
        m_m = model.iterate_with_prior(masked_ds, prior)
    np.testing.assert_allclose(m_d.transform, m_m.transform, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(m_d.mean, m_m.mean, rtol=1e-7, atol=1e-10)
    assert np.isclose(m_d.isotropic_noise, m_m.isotropic_noise, rtol=1e-9)

    # fused llk agrees too
    _, llk_d = model._iterate_with_llk(ds, prior)
    _, llk_m = model._iterate_with_llk(masked_ds, prior)
    assert np.isclose(llk_d, llk_m, rtol=1e-10)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_dense_sharded_matches_single(rng, mesh_shape):
    model, ds, _ = make_pair(rng, n=101, d=8, k=3)  # padding exercised
    mesh = make_mesh(data=mesh_shape[0], model=mesh_shape[1])
    sds = shard_dataset(ds, mesh)
    assert sds.all_observed()
    assert np.isclose(model.llk(sds), model.llk(ds), rtol=1e-10)
    np.testing.assert_allclose(model.llks(sds), model.llks(ds), rtol=1e-9)
    m_s, m_d = model.iterate(sds), model.iterate(ds)
    np.testing.assert_allclose(m_s.transform, m_d.transform, rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(m_s.mean, m_d.mean, rtol=1e-8, atol=1e-11)
    assert np.isclose(m_s.isotropic_noise, m_d.isotropic_noise, rtol=1e-10)


def test_dense_training_converges(rng):
    real = PPCAModel(
        isotropic_noise=0.1,
        transform=rng.normal(size=(6, 2)),
        mean=rng.normal(size=6),
    )
    data = real.sample(400, 0.0)  # fully observed
    assert data.all_observed()
    seen = []
    PPCATrainer(data).train(
        state_size=2, n_iters=10, quiet=True, callback=lambda i, m: seen.append(m.llk)
    )
    assert seen[-1] > seen[0]
    assert all(b >= a - 1e-7 for a, b in zip(seen, seen[1:]))


def test_dense_bf16_storage_matches_f32(rng):
    """bf16 value storage on the dense path is a STORAGE change only — the SAME bf16-representable values
    stored as bf16 and as f32 must produce near-identical EM results (math
    is f32 both ways).  Also pins the llks d_obs compute-dtype fix (a bf16
    d_obs dragged the weakly-typed LN_2PI constant to bf16, shifting every
    llk by ~1e-3) and the from_parts weights-dtype guard."""
    import jax.numpy as jnp

    d, k, n = 10, 3, 300
    C = rng.normal(size=(d, k))
    mean = rng.normal(size=d)
    data = rng.normal(size=(n, d)) + mean
    weights = (rng.random(n) + 0.5).astype(np.float32)
    # quantize once so both datasets hold IDENTICAL values
    q = np.asarray(jnp.asarray(data, jnp.bfloat16))
    ds16 = Dataset.from_parts(
        jnp.asarray(q, jnp.bfloat16),
        jnp.ones((n, d), bool),
        weights=jnp.asarray(weights),
    )
    ds32 = Dataset.from_parts(
        jnp.asarray(q, jnp.float32),
        jnp.ones((n, d), bool),
        weights=jnp.asarray(weights),
    )
    assert ds16.all_observed() and ds32.all_observed()
    # weights must NEVER inherit the bf16 storage dtype (from_parts guard):
    # they carry mixture responsibilities, where 0.4% quantization would
    # perturb the outer EM.
    assert ds16.weights_dev.dtype == np.float32
    model = PPCAModel._from_params(
        jnp.asarray(C, jnp.float32),
        jnp.asarray(mean, jnp.float32),
        jnp.asarray(0.4, jnp.float32),
    )
    np.testing.assert_allclose(model.llk(ds16), model.llk(ds32), rtol=1e-5)
    m16, m32 = model.iterate(ds16), model.iterate(ds32)
    np.testing.assert_allclose(m16.transform, m32.transform, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(m16.mean, m32.mean, rtol=1e-4, atol=1e-5)
    assert np.isclose(m16.isotropic_noise, m32.isotropic_noise, rtol=1e-5)
