"""Port's on-line heads and their solvers' predict side vs the JAX package:
z-scoring, RLS refiners, FALKON for one classifier, the RPN heads, the box
predictor, the all-class mask sweep and its own-class selection.

Tolerance: fp32 sums in another order, rtol 1e-5 / atol 1e-5 (scores are
O(1), deltas O(0.1)); the own-class mask scores equal the selected channel of
the all-class sweep to the same tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.models import heads as jheads
from online_detection_tpu.models import postprocess as jpost
from online_detection_tpu.models import rpn as jrpn
from online_detection_tpu.solvers.falkon import FalkonModel as JFalkon
from online_detection_tpu.solvers.falkon import falkon_predict as j_falkon_predict
from online_detection_tpu.solvers.rls import RLSModel as JRLS
from online_detection_tpu.solvers.rls import rls_predict as j_rls_predict
from online_detection_tpu.utils.stats import FeatureStats as JStats
from online_detection_tpu.utils.stats import zscore as j_zscore
from online_detection_tpu_torch.models import heads, postprocess, rpn
from online_detection_tpu_torch.models.weights import online_from_jax
from online_detection_tpu_torch.solvers.falkon import FalkonModel, falkon_predict
from online_detection_tpu_torch.solvers.rls import RLSModel, rls_predict
from online_detection_tpu_torch.utils.stats import FeatureStats, zscore

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _jstats(rng, d):
    return JStats(jnp.asarray(_f32(rng, d, scale=0.1)), jnp.ones((d,)),
                  jnp.asarray(np.float32(rng.uniform(5, 10))))


def _jrls(rng, c, d, exists=None):
    return JRLS(jnp.asarray(_f32(rng, c, d + 1, 4, scale=1e-2)),
                jnp.asarray(_f32(rng, c, 4, 4, scale=0.3) + np.eye(4, dtype=np.float32)),
                jnp.asarray(np.broadcast_to(np.eye(4, dtype=np.float32), (c, 4, 4)).copy()),
                jnp.asarray(_f32(rng, c, 4, scale=0.05)),
                jnp.asarray(np.ones(c, bool) if exists is None else exists),
                jnp.zeros((c, 4)))


def _jfalkon(rng, c, m, d, sigma, exists=None):
    return JFalkon(jnp.asarray(_f32(rng, c, m, d, scale=2.0)), jnp.asarray(_f32(rng, c, m)),
                   jnp.asarray(np.ones(c, bool) if exists is None else exists), sigma)


def _torch(arrays):
    """JAX arrays (e.g. a NamedTuple's fields) as writable torch tensors."""
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_zscore_and_rls_predict_match_jax(rng):
    d, c = 24, 5
    x = _f32(rng, 40, d, scale=3.0)
    js = _jstats(rng, d)
    z = zscore(torch.from_numpy(x), FeatureStats(*_torch(js)))
    np.testing.assert_allclose(z.numpy(), np.asarray(j_zscore(jnp.asarray(x), js)), **TOL)
    jm = _jrls(rng, c, d, np.array([True, True, False, True, True]))
    rls = RLSModel(*_torch(jm))
    got = rls_predict(rls, z).numpy()
    np.testing.assert_allclose(got, np.asarray(j_rls_predict(jm, jnp.asarray(z.numpy()))), **TOL)
    assert got.shape == (40, c, 4) and (got[:, 2] == 0).all()


@pytest.mark.parametrize("exists", [True, False])
def test_falkon_predict_matches_jax(rng, exists):
    jm = _jfalkon(rng, 1, 30, 16, 6.0, np.array([exists]))
    jm = JFalkon(jm.centers[0], jm.alpha[0], jm.exists[0], jm.sigma)
    x = _f32(rng, 50, 16, scale=2.0)
    centers, alpha, exists_t = _torch((jm.centers, jm.alpha, jm.exists))
    got = falkon_predict(FalkonModel(centers, alpha, exists_t, jm.sigma), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_falkon_predict(jm, jnp.asarray(x))), **TOL)
    if not exists:
        assert (got == -2.0).all()


def _online(rng, ch=32, c5=48, n_cls=4):
    from online_detection_tpu.models.detector import OnlineModelSet

    mask_exists = np.array([True, False, True, True])
    return OnlineModelSet(
        rpn=jrpn.OnlineRPNModels(_jfalkon(rng, 15, 12, ch, 50.0), _jrls(rng, 15, ch),
                                 _jstats(rng, ch)),
        detector=jheads.OnlineDetectorModels(
            _jfalkon(rng, n_cls, 12, c5, 40.0, np.array([True, True, False, True])),
            _jrls(rng, n_cls, c5), _jstats(rng, c5)),
        mask=jheads.OnlineMaskModels(_jfalkon(rng, n_cls, 10, 256, 10.0, mask_exists),
                                     _jstats(rng, 256)),
    )


def test_rpn_heads_match_jax(rng):
    ch, a = 32, 15
    params = {"cls_w": _f32(rng, ch, a, scale=0.1), "cls_b": _f32(rng, a),
              "bbox_w": _f32(rng, ch, 4 * a, scale=0.1), "bbox_b": _f32(rng, 4 * a)}
    head = rpn.RPNHead(torch.zeros(ch, ch, 3, 3), torch.zeros(ch),
                       *(torch.from_numpy(params[k]) for k in ("cls_w", "cls_b", "bbox_w",
                                                               "bbox_b")))
    t = np.abs(_f32(rng, 2, 3, 5, ch, scale=2.0))
    got = rpn.rpn_pretrained(head, torch.from_numpy(t))
    want = jrpn.rpn_pretrained({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(t))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

    jonline = _online(rng, ch=ch)
    got = rpn.rpn_online(online_from_jax(jonline).rpn, torch.from_numpy(t[0]))
    want = jrpn.rpn_online(jonline.rpn, jnp.asarray(t[0]))
    assert got[0].shape == (15, a) and got[1].shape == (15, a, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("normalize", [False, True])
def test_box_predict_matches_jax(rng, normalize):
    jonline = _online(rng)
    feats = np.abs(_f32(rng, 30, 48, scale=2.0))
    got = heads.box_predict(online_from_jax(jonline).detector, torch.from_numpy(feats), normalize)
    want = jheads.box_predict(jonline.detector, jnp.asarray(feats), normalize)
    assert got[0].shape == (30, 5) and got[1].shape == (30, 20)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert (got[0][:, 0] == -2.0).all() and (got[0][:, 3] == -2.0).all()


def test_mask_sweep_matches_jax_and_own_class_selection(rng):
    """``mask_predict`` (all classes) vs JAX; ``select_mask_channel`` of it vs
    JAX; and the own-class ``mask_predict_labels`` equals that selection."""
    jonline = _online(rng)
    models = online_from_jax(jonline).mask
    feats = np.abs(_f32(rng, 6, 14, 14, 256))
    labels = np.array([0, 1, 2, 3, 4, 3], np.int32)
    sweep = heads.mask_predict(models, torch.from_numpy(feats))
    want = jheads.mask_predict(jonline.mask, jnp.asarray(feats))
    assert sweep.shape == (6, 14, 14, 5)
    np.testing.assert_allclose(sweep.numpy(), np.asarray(want), **TOL)
    selected = postprocess.select_mask_channel(sweep, torch.from_numpy(labels))
    np.testing.assert_allclose(selected.numpy(),
                               np.asarray(jpost.select_mask_channel(want, jnp.asarray(labels))), **TOL)
    own = heads.mask_predict_labels(models, torch.from_numpy(feats), torch.from_numpy(labels))
    np.testing.assert_allclose(own.numpy(), selected.numpy(), **TOL)
