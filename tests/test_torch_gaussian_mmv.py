"""Port's Gaussian mmv (plain version of kernel B1) vs the JAX package:
``mmv_xla``, the Pallas ``mmv_pallas`` in interpret mode, the class-batched
FALKON predict, and the own-class mask scores.

Tolerance: the same fp32 function summed in another order, so each output
may differ by 1e-5 of the sum of its terms' magnitudes, ``K @ |v|``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.ops.gaussian_mmv import mmv_pallas, mmv_xla
from online_detection_tpu.solvers.falkon import FalkonModel as JFalkon
from online_detection_tpu.solvers.falkon import falkon_predict_classes as j_predict_classes
from online_detection_tpu_torch.ops.gaussian_mmv import (
    gaussian_kernel,
    mmv,
    mmv_grouped,
    mmv_reference,
)
from online_detection_tpu_torch.solvers.falkon import FalkonModel, falkon_predict_classes

torch.set_num_threads(2)


def _mmv_columns(x, c, v, sigma):
    """The port's single-set ``mmv`` (v [M]) on each column of a v [M] or [M, t]."""
    x, c = torch.from_numpy(x), torch.from_numpy(c)
    if v.ndim == 1:
        return mmv(x, c, torch.from_numpy(v), sigma).numpy()
    return np.stack([mmv(x, c, torch.from_numpy(np.ascontiguousarray(v[:, k])), sigma).numpy()
                     for k in range(v.shape[1])], axis=-1)


def _bound(x, c, v, sigma):
    """1e-5 of sum |terms| per output, in float64."""
    x, c = x.astype(np.float64), c.astype(np.float64)
    sq = (x * x).sum(1)[:, None] + (c * c).sum(1)[None] - 2 * x @ c.T
    k = np.exp(-np.maximum(sq, 0) / (2 * sigma * sigma))
    return 1e-5 * (k @ np.abs(v).reshape(len(c), -1)) + 1e-30


def _data(rng, n, m, d, t=None, s=None):
    x = rng.normal(size=(n, d)).astype(np.float32)
    shape_c = (m, d) if s is None else (s, m, d)
    c = rng.normal(size=shape_c).astype(np.float32)
    shape_v = (m,) if t is None else (m, t)
    if s is not None:
        shape_v = (s,) + shape_v
    v = rng.normal(size=shape_v).astype(np.float32)
    return x, c, v


@pytest.mark.parametrize("n,m,d,t,sigma", [(37, 50, 24, None, 4.0), (130, 70, 40, 3, 5.0)])
def test_mmv_matches_mmv_xla(rng, n, m, d, t, sigma):
    x, c, v = _data(rng, n, m, d, t)
    want = np.asarray(mmv_xla(jnp.asarray(x), jnp.asarray(c), jnp.asarray(v), sigma))
    got = _mmv_columns(x, c, v, sigma)
    assert got.shape == want.shape
    bound = _bound(x, c, v, sigma).reshape(want.shape)
    assert (np.abs(got - want) <= bound).all()


def test_mmv_matches_mmv_pallas_interpret(rng):
    x, c, v = _data(rng, 150, 140, 48, 2)
    sigma = 5.0
    want = np.asarray(mmv_pallas(jnp.asarray(x), jnp.asarray(c), jnp.asarray(v), sigma,
                                 tile_n=128, tile_m=128, interpret=True, bf16_dot=False))
    got = _mmv_columns(x, c, v, sigma)
    assert (np.abs(got - want) <= _bound(x, c, v, sigma)).all()


def test_gaussian_kernel_matches_dense_numpy(rng):
    x, c, _ = _data(rng, 9, 11, 6)
    sq = ((x[:, None, :].astype(np.float64) - c[None]) ** 2).sum(-1)
    want = np.exp(-sq / (2 * 3.0 ** 2))
    got = gaussian_kernel(torch.from_numpy(x), torch.from_numpy(c), 3.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_grouped_mmv_shared_and_per_group_x(rng):
    """Shared x (one group per center set) and per-group x with an index
    gather of center sets (the mask head's form) both equal per-group
    ``mmv_xla``."""
    s, m, d, sigma = 4, 33, 20, 4.0
    x, c, v = _data(rng, 45, m, d, s=s)
    got = mmv_grouped(torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(v),
                      sigma).numpy()
    assert got.shape == (s, 45)
    for g in range(s):
        want = np.asarray(mmv_xla(jnp.asarray(x), jnp.asarray(c[g]), jnp.asarray(v[g]), sigma))
        assert (np.abs(got[g] - want) <= _bound(x, c[g], v[g], sigma)[:, 0]).all()

    set_idx = np.array([3, 0, 0, 2, 1, 3], np.int32)
    xg = rng.normal(size=(len(set_idx), 17, d)).astype(np.float32)
    got = mmv_grouped(torch.from_numpy(xg), torch.from_numpy(c), torch.from_numpy(v), sigma,
                      set_idx=torch.from_numpy(set_idx)).numpy()
    ref = mmv_reference(torch.from_numpy(xg), torch.from_numpy(c), torch.from_numpy(v), sigma,
                        torch.from_numpy(set_idx)).numpy()
    np.testing.assert_array_equal(got, ref)
    for g, si in enumerate(set_idx):
        want = np.asarray(mmv_xla(jnp.asarray(xg[g]), jnp.asarray(c[si]),
                                  jnp.asarray(v[si]), sigma))
        assert (np.abs(got[g] - want) <= _bound(xg[g], c[si], v[si], sigma)[:, 0]).all()


def test_grouped_mmv_rejects_mismatched_groups():
    with pytest.raises(ValueError):
        mmv_grouped(torch.ones(3, 5, 4), torch.ones(2, 6, 4), torch.ones(2, 6), 1.0)


def test_falkon_predict_classes_matches_jax(rng):
    c_, m, d, sigma = 5, 40, 32, 6.0
    centers = rng.normal(size=(c_, m, d)).astype(np.float32)
    alpha = rng.normal(size=(c_, m)).astype(np.float32)
    exists = np.array([True, False, True, True, False])
    x = rng.normal(size=(60, d)).astype(np.float32)
    want = np.asarray(j_predict_classes(
        JFalkon(jnp.asarray(centers), jnp.asarray(alpha), jnp.asarray(exists), sigma),
        jnp.asarray(x), missing_score=-2.0))
    got = falkon_predict_classes(
        FalkonModel(torch.from_numpy(centers), torch.from_numpy(alpha),
                    torch.from_numpy(exists), sigma),
        torch.from_numpy(x)).numpy()
    assert got.shape == (60, c_)
    assert (got[:, ~exists] == -2.0).all()
    for k in np.nonzero(exists)[0]:
        assert (np.abs(got[:, k] - want[:, k]) <= _bound(x, centers[k], alpha[k], sigma)[:, 0]).all()


def test_mask_predict_labels_matches_jax(rng):
    """Own-class mask scores, with background labels and a missing class."""
    from online_detection_tpu.models.heads import OnlineMaskModels as JMask
    from online_detection_tpu.models.heads import mask_predict_labels as j_labels
    from online_detection_tpu.utils.stats import FeatureStats as JStats
    from online_detection_tpu_torch.models.heads import OnlineMaskModels, mask_predict_labels
    from online_detection_tpu_torch.utils.stats import FeatureStats

    c_, m, ch = 4, 12, 256
    centers = rng.normal(size=(c_, m, ch)).astype(np.float32)
    alpha = rng.normal(size=(c_, m)).astype(np.float32)
    exists = np.array([True, True, False, True])
    mean = (rng.normal(size=ch) * 0.1).astype(np.float32)
    feats = np.abs(rng.normal(size=(7, 14, 14, ch))).astype(np.float32)
    labels = np.array([0, 1, 2, 3, 4, 1, 3], np.int32)
    jm = JMask(JFalkon(jnp.asarray(centers), jnp.asarray(alpha), jnp.asarray(exists), 10.0),
               JStats(jnp.asarray(mean), jnp.ones(ch), jnp.asarray(20.0)))
    want = np.asarray(j_labels(jm, jnp.asarray(feats), jnp.asarray(labels)))
    pm = OnlineMaskModels(
        FalkonModel(torch.from_numpy(centers), torch.from_numpy(alpha),
                    torch.from_numpy(exists), 10.0),
        FeatureStats(torch.from_numpy(mean), torch.ones(ch), torch.tensor(20.0)))
    got = mask_predict_labels(pm, torch.from_numpy(feats), torch.from_numpy(labels)).numpy()
    assert got.shape == (7, 14, 14)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
