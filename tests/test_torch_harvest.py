"""Port's harvest (``engine/harvest.py``) vs the JAX package's, on the CPU.

The samplers take the JAX package's own draws (``draws`` / ``uniforms``);
the per-head harvests run in ``parity_sampling`` mode, so neither side
draws. Index outputs must be identical; features and targets agree within
1e-5 (the same arithmetic); the trunk within 1e-4 (fp32 convs in another
order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.engine import harvest as jh
from online_detection_tpu.models import detector as jdet
from online_detection_tpu_torch.engine import harvest as h
from online_detection_tpu_torch.models.anchors import anchor_visibility, grid_anchors
from online_detection_tpu_torch.models.detector import DetectorConfig
from online_detection_tpu_torch.models.weights import params_from_jax
from online_detection_tpu_torch.pipelines.device_pipeline import _gate_chunk
from tests.test_torch_detector import narrow_tree

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_out", [7, 60])  # a draw and no draw (count 24)
def test_masked_sample_with_jax_draws(rng, n_out):
    mask = rng.uniform(size=(3, 40)) < 0.6
    mask[1] = False  # an empty pool
    keys = jax.random.split(jax.random.key(4), 3)
    for i in range(3):
        cnt = int(mask[i].sum())
        draws = np.array(jax.random.randint(keys[i], (n_out,), 0, max(cnt, 1)))
        want = jh.masked_sample(keys[i], jnp.asarray(mask[i]), n_out)
        got = h.masked_sample(_t(mask[i]), n_out, draws=draws)
        _eq(got[0], want[0])
        _eq(got[1], want[1])


@pytest.mark.parametrize("always", [False, True])
def test_masked_sample_parity_modes(rng, always):
    mask = rng.uniform(size=(4, 30)) < 0.3
    mask[0] = False
    got = h.masked_sample(_t(mask), 12, parity=True, always_resample=always)
    for i in range(4):
        want = jh.masked_sample(None, jnp.asarray(mask[i]), 12, parity=True,
                                always_resample=always)
        _eq(got[0][i], want[0])
        _eq(got[1][i], want[1])


def test_compact(rng):
    mask = rng.uniform(size=(3, 25)) < 0.4
    got = h.compact(_t(mask), 30)
    for i in range(3):
        want = jh.compact(jnp.asarray(mask[i]), 30)
        _eq(got[0][i], want[0])
        _eq(got[1][i], want[1])


@pytest.mark.parametrize("parity", [False, True])
def test_random_subsample_with_jax_uniforms(rng, parity):
    mask = rng.uniform(size=(2, 196)) < 0.5
    keys = jax.random.split(jax.random.key(9), 2)
    u = np.stack([np.array(jax.random.uniform(k, (196,))) for k in keys])
    got = h.random_subsample(_t(mask), 0.3, 64, parity=parity, uniforms=u)
    for i in range(2):
        want = jh.random_subsample(keys[i], jnp.asarray(mask[i]), 0.3, 64, parity=parity)
        _eq(got[0][i], want[0])
        _eq(got[1][i], want[1])


HCFG = dict(num_anchor_classes=15, num_classes=4, negatives_to_pick=9, gt_cap=3,
            rpn_pos_cap=6, coxy_cap=10, mask_pix_cap=12, parity_sampling=True)


def _gt(rng, b, g, hi_w, hi_h):
    boxes = np.zeros((b, g, 4), np.float32)
    for i in range(b):
        for j in range(g):
            x1, y1 = rng.uniform(0, hi_w * 0.6), rng.uniform(0, hi_h * 0.6)
            boxes[i, j] = [x1, y1, x1 + rng.uniform(20, hi_w * 0.4),
                           y1 + rng.uniform(20, hi_h * 0.4)]
    valid = np.array([[True, True, False], [True, False, False]])[:b, :g]
    labels = np.array([[1, 3, 0], [2, 0, 0]], np.int32)[:b, :g]
    return boxes, labels, valid


def _fields_match(got, want, atol=1e-5):
    for name, g, w in zip(got._fields, got, want):
        if g is None:
            assert w is None, name
            continue
        w = np.asarray(w)
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=1e-5, err_msg=name)


def test_harvest_rpn_matches_jax(rng):
    b, hh, ww, ch = 2, 6, 8, 16
    t = rng.normal(size=(b, hh, ww, ch)).astype(np.float32)
    anchors = grid_anchors(hh, ww)
    vis = np.stack([anchor_visibility(anchors, (128, 96)), anchor_visibility(anchors, (100, 80))])
    gt, _, gv = _gt(rng, b, 3, 128, 96)
    gt[0, 0] = anchors[8 * 15 + 4] + 2.0  # an anchor above IoU 0.7
    cfg = h.HarvestConfig(**HCFG)
    got = h.harvest_rpn(_t(t), _t(anchors), _t(vis), _t(gt), _t(gv), cfg)
    want = [jh.harvest_rpn(jax.random.key(0), jnp.asarray(t[i]), jnp.asarray(anchors), jnp.asarray(vis[i]),
                           jnp.asarray(gt[i]), jnp.asarray(gv[i]), jh.HarvestConfig(**HCFG))
            for i in range(b)]
    want = type(want[0])(*[np.stack([np.asarray(w[k]) for w in want]) for k in range(6)])
    _fields_match(got, want)
    assert got.pos_valid.any() and got.neg_valid.any()


def test_harvest_detector_matches_jax(rng):
    b, r, d = 2, 3 + 17, 24
    feats = rng.normal(size=(b, r, d)).astype(np.float32)
    gt, labels, gv = _gt(rng, b, 3, 128, 96)
    props = _gt(rng, b, r - 3, 128, 96)[0]
    props[:, :4] = gt[:, :1] + rng.normal(size=(b, 4, 4)).astype(np.float32) * 3  # COXY rows
    boxes = np.concatenate([gt, props], 1)
    rows_valid = np.concatenate([gv, rng.uniform(size=(b, r - 3)) < 0.8], 1)
    sizes = np.array([[128, 96], [110, 90]], np.float32)
    cfg = h.HarvestConfig(**HCFG)
    got = h.harvest_detector(_t(feats), _t(boxes), _t(rows_valid), _t(labels), _t(gv),
                             _t(sizes), cfg)
    jcfg = jh.HarvestConfig(**HCFG)
    want = [jh.harvest_detector(jax.random.key(0), jnp.asarray(feats[i]), jnp.asarray(boxes[i]),
                                jnp.asarray(rows_valid[i]), jnp.asarray(labels[i]),
                                jnp.asarray(gv[i]), jnp.asarray(sizes[i]), jcfg)
            for i in range(b)]
    want = type(want[0])(*[np.stack([np.asarray(w[k]) for w in want]) for k in range(10)])
    _fields_match(got, want)
    assert got.coxy_valid.any() and got.neg_valid.any()


def test_harvest_mask_matches_jax(rng):
    b, g = 2, 3
    deconv = rng.normal(size=(b, g, 14, 14, 8)).astype(np.float32)
    masks = (rng.uniform(size=(b, g, 14, 14)) < 0.4).astype(np.float32)
    _, labels, gv = _gt(rng, b, g, 128, 96)
    cfg = h.HarvestConfig(**HCFG)
    got = h.harvest_mask(_t(deconv), _t(masks), _t(labels), _t(gv), cfg)
    jcfg = jh.HarvestConfig(**HCFG)
    want = [jh.harvest_mask(jax.random.key(0), jnp.asarray(deconv[i]), jnp.asarray(masks[i]),
                            jnp.asarray(labels[i]), jnp.asarray(gv[i]), jcfg) for i in range(b)]
    want = type(want[0])(*[np.stack([np.asarray(w[k]) for w in want]) for k in range(7)])
    _fields_match(got, want)
    assert int(got.dropped.sum()) > 0  # the 12-pixel cap bites


def test_average_recall_and_gate_match_jax(rng):
    gt, labels, gv = _gt(rng, 2, 3, 128, 96)
    props = np.concatenate([gt + 4.0, _gt(rng, 2, 3, 128, 96)[0]], 1)
    pv = np.array([[True] * 5 + [False], [True, False, True, True, True, True]])
    got = h.average_recall(_t(gt), _t(gv), _t(props), _t(pv))
    want = [jh.average_recall(jnp.asarray(gt[i]), jnp.asarray(gv[i]), jnp.asarray(props[i]),
                              jnp.asarray(pv[i])) for i in range(2)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert float(got.max()) > 0

    from online_detection_tpu.pipelines.device_pipeline import _gate_chunk as j_gate

    chunk = h.harvest_chunks(
        torch.zeros(2, 2, 3, 8), _t(props), _t(pv), torch.randn(2, 9, 5), None,
        _t(grid_anchors(2, 3)), torch.ones(2, 90, dtype=torch.bool),
        torch.tensor([[48, 32], [48, 32]]), _t(gt), _t(labels), _t(gv), None,
        h.HarvestConfig(**dict(HCFG, num_classes=3)), True)
    valid = torch.tensor([True, False])
    gated = _gate_chunk(chunk, valid[:, None, None])
    jchunk = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), chunk)
    jgated = j_gate(jchunk, jnp.asarray(valid.numpy())[:, None, None])
    for got_t, want_t in zip(jax.tree_util.tree_leaves(gated), jax.tree_util.tree_leaves(jgated)):
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    assert not gated.det.neg_valid[1].any() and gated.det.neg_valid[0].any()


def test_harvest_trunk_matches_jax():
    rng = np.random.default_rng(7)
    tree = narrow_tree(rng)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    params = params_from_jax(tree)
    hh, ww, b = 64, 96, 2
    images = rng.integers(0, 256, size=(b, hh, ww, 3), dtype=np.uint8)
    sizes = np.array([[ww, hh], [ww - 8, hh - 6]], np.float32)
    gt, _, gv = _gt(rng, b, 3, ww, hh)
    anchors = grid_anchors(hh // 16, ww // 16)
    kw = dict(pre_nms_top_n=80, post_nms_top_n=20)
    got = h.harvest_trunk(params, None, _t(anchors), _t(images), _t(sizes), _t(gt), _t(gv),
                          DetectorConfig(**kw, compute_dtype="float32"))
    jdcfg = jdet.DetectorConfig(**kw)
    want = jax.vmap(lambda im, sz, gb, v: jh.harvest_trunk(
        jtree, None, jnp.asarray(anchors), im, sz, gb, v, jdcfg))(
        jnp.asarray(images), jnp.asarray(sizes), jnp.asarray(gt), jnp.asarray(gv))
    names = ("t", "prop_boxes", "prop_valid", "feats", "deconv")
    for name, g, w in zip(names, got, want):
        if name == "prop_valid":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4,
                                       err_msg=name)
    assert got[3].shape == (b, 3 + 20, 64) and got[4].shape == (b, 3, 14, 14, 256)
