"""Checkpoint files through both packages: the JAX package's exporters write
a Caffe2 ``.pkl`` and a maskrcnn-benchmark ``.pth`` from one parameter tree
(R-50's block counts 3/4/6/3, which the converters' names need, at narrow
widths, with a stock box predictor); the port's ``load_checkpoint`` must give
``params_from_jax`` of the JAX ``load_checkpoint`` tensor for tensor, bit for
bit, and the port's exporters must write the JAX exporters' blobs.
``activation_checksums`` of both packages agree within rtol 1e-4."""

import pickle

import jax
import numpy as np
import pytest
import torch

from online_detection_tpu.models import weights as jw
from online_detection_tpu_torch.experiments.run_experiment_test_feature_task import (
    load_any_checkpoint,
)
from online_detection_tpu_torch.models import weights as pw

torch.set_num_threads(2)

# (mid, out) per stage at R-50's block counts
STAGES = ((8, 32), (8, 32), (16, 64), (16, 64))
BLOCKS = (3, 4, 6, 3)
N_CLS = 3  # foreground classes; the predictors have N_CLS + 1 columns


def _conv_bn(rng, k, cin, cout, damp=1.0):
    return {"w": (rng.normal(size=(k, k, cin, cout)) * (2.0 / (k * k * cin)) ** 0.5
                  ).astype(np.float32),
            "scale": (rng.uniform(0.8, 1.2, cout) * damp).astype(np.float32),
            "bias": (rng.normal(size=cout) * 0.05).astype(np.float32)}


def r50_narrow_tree(seed=0, n_cls=N_CLS, mask=True, box_predictor=True):
    """A JAX-schema tree with numpy leaves: the stem, 3/4/6/3 bottlenecks
    (a projection on each stage's first), RPN, mask head, box predictor."""
    rng = np.random.default_rng(seed)
    stem = _conv_bn(rng, 7, 3, 64)
    stem["w"] /= 64.0
    bb = {"stem": stem}
    cin = 64
    for si, ((mid, cout), n) in enumerate(zip(STAGES, BLOCKS)):
        blocks = []
        for bi in range(n):
            blk = {"branch2a": _conv_bn(rng, 1, cin, mid), "branch2b": _conv_bn(rng, 3, mid, mid),
                   "branch2c": _conv_bn(rng, 1, mid, cout, 0.1)}
            if bi == 0:
                blk["branch1"] = _conv_bn(rng, 1, cin, cout)
            blocks.append(blk)
            cin = cout
        bb[f"res{si + 2}"] = blocks
    c4, c5 = STAGES[2][1], STAGES[3][1]
    f = lambda *s: (rng.normal(size=s) * 0.05).astype(np.float32)  # noqa: E731
    tree = {"backbone": bb,
            "rpn": {"conv_w": f(3, 3, c4, c4), "conv_b": f(c4), "cls_w": f(c4, 15),
                    "cls_b": f(15), "bbox_w": f(c4, 60), "bbox_b": f(60)},
            "mask_head": {}}
    if mask:
        tree["mask_head"] = {"w": f(2, 2, c5, 256) * 4, "b": f(256),
                             "logits_w": f(256, n_cls + 1), "logits_b": f(n_cls + 1)}
    if box_predictor:
        tree["box_predictor"] = {"cls_w": f(c5, n_cls + 1) * 20, "cls_b": f(n_cls + 1),
                                 "bbox_w": f(c5, 4 * (n_cls + 1)), "bbox_b": f(4 * (n_cls + 1))}
    return tree


def write_pkl(path, tree, extra=None):
    blobs = jw.export_caffe2_blobs(tree)
    blobs.update(extra or {})
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f)
    return str(path)


def write_pth(path, tree, prefix="", key="model", stats_rng=None, tensors=False):
    """The JAX exporter's state dict; with ``stats_rng``, random running
    statistics in place of the exporter's mean 0 / variance 1, so the BN fold
    does real float64 work."""
    sd = jw.export_torch_state_dict(tree)
    if stats_rng is not None:
        for k in list(sd):
            if k.endswith(".running_mean"):
                sd[k] = stats_rng.normal(size=sd[k].shape).astype(np.float32)
            elif k.endswith(".running_var"):
                sd[k] = stats_rng.uniform(0.2, 3.0, size=sd[k].shape).astype(np.float32)
    sd = {prefix + k: (torch.from_numpy(np.ascontiguousarray(v)) if tensors else v)
          for k, v in sd.items()}
    torch.save({key: sd} if key else sd, str(path))
    return str(path)


def jax_params(path):
    """The JAX package's load_checkpoint, carried over by params_from_jax."""
    return pw.params_from_jax(jax.tree_util.tree_map(np.asarray, jw.load_checkpoint(path)))


def assert_same_params(got, want):
    g, w = dict(got.named_buffers()), dict(want.named_buffers())
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert torch.equal(g[k], w[k]), k
    assert (got.mask_head is None) == (want.mask_head is None)
    assert (got.box_predictor is None) == (want.box_predictor is None)


@pytest.fixture(scope="module")
def tree():
    return r50_narrow_tree()


@pytest.mark.parametrize("fmt", ["pkl", "pth", "pth_prefixed_tensors", "pth_folded_stats",
                                 "pth_bare_state_dict"])
def test_load_checkpoint_matches_jax_bit_for_bit(tmp_path, tree, fmt):
    if fmt == "pkl":
        path = write_pkl(tmp_path / "m.pkl", tree)
    elif fmt == "pth":
        path = write_pth(tmp_path / "m.pth", tree)
    elif fmt == "pth_prefixed_tensors":
        path = write_pth(tmp_path / "m.pth", tree, prefix="module.", tensors=True)
    elif fmt == "pth_folded_stats":
        path = write_pth(tmp_path / "m.pth", tree, stats_rng=np.random.default_rng(5))
    else:
        path = write_pth(tmp_path / "m.pth", tree, key=None)
    got = pw.load_checkpoint(path)
    want = jax_params(path)
    assert_same_params(got, want)
    assert got.box_predictor is not None and got.mask_head is not None
    assert got.rpn.conv_w.device.type == "cpu"
    if fmt != "pth_folded_stats":  # the exporters' mean 0 / var 1 fold is exact
        assert_same_params(got, pw.params_from_jax(tree))


def test_frozen_bn_fold_in_float64_without_eps(tmp_path, tree):
    """scale = w / sqrt(rv), bias = b - rm * scale in float64, then float32."""
    rng = np.random.default_rng(9)
    path = write_pth(tmp_path / "m.pth", tree, stats_rng=rng)
    sd = torch.load(path, weights_only=False)["model"]
    pre = "backbone.body.layer3.2.bn2"
    w, b, rm, rv = (np.asarray(sd[f"{pre}.{k}"], np.float64)
                    for k in ("weight", "bias", "running_mean", "running_var"))
    scale = w / np.sqrt(rv)
    blk = pw.load_checkpoint(path).backbone.res4[2].branch2b
    np.testing.assert_array_equal(blk.scale.numpy(), scale.astype(np.float32))
    np.testing.assert_array_equal(blk.bias.numpy(), (b - rm * scale).astype(np.float32))


def test_port_exporters_equal_jax_exporters(tree):
    params = pw.params_from_jax(tree)
    for jfn, pfn in ((jw.export_caffe2_blobs, pw.export_caffe2_blobs),
                     (jw.export_torch_state_dict, pw.export_torch_state_dict)):
        want, got = jfn(tree), pfn(params)
        assert sorted(got) == sorted(want)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_tree_from_params_inverts_params_from_jax(tree):
    back = pw.tree_from_params(pw.params_from_jax(tree))
    flat_w, tdef_w = jax.tree_util.tree_flatten(tree)
    flat_g, tdef_g = jax.tree_util.tree_flatten(back)
    assert tdef_g == tdef_w
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_array_equal(g, w)


def test_momentum_blobs_and_a_flat_pickle_load(tmp_path, tree):
    blobs = jw.export_caffe2_blobs(tree)
    noisy = dict(blobs, conv1_w_momentum=np.ones(3, np.float32),
                 res2_0_branch2a_w_momentum=np.ones(3, np.float32))
    path = tmp_path / "flat.pkl"
    with open(path, "wb") as f:
        pickle.dump(noisy, f)  # no "blobs" key
    loaded = pw.load_caffe2_pickle(str(path))
    assert sorted(loaded) == sorted(blobs)
    assert_same_params(pw.load_checkpoint(str(path)), jax_params(str(path)))


def test_file_without_mask_blobs_has_no_mask_head(tmp_path):
    t = r50_narrow_tree(mask=False, box_predictor=False)
    for path in (write_pkl(tmp_path / "m.pkl", t), write_pth(tmp_path / "m.pth", t)):
        got = pw.load_checkpoint(path)
        assert got.mask_head is None and got.box_predictor is None
        assert jw.load_checkpoint(path)["mask_head"] == {}
        assert_same_params(got, jax_params(path))
        assert "conv5_mask_w" not in pw.export_caffe2_blobs(got)


def test_incomplete_tree_raises_key_error(tmp_path, tree):
    blobs = jw.export_caffe2_blobs(tree)
    del blobs["res4_5_branch2c_w"]
    with pytest.raises(KeyError):
        pw.params_from_caffe2(blobs)
    with pytest.raises(KeyError):
        jw.params_from_caffe2(blobs)
    stem_only = {"backbone.body.stem.conv1.weight": torch.zeros(64, 3, 7, 7),
                 "backbone.body.stem.bn1.weight": torch.full((64,), 2.0),
                 "backbone.body.stem.bn1.bias": torch.full((64,), 1.0),
                 "backbone.body.stem.bn1.running_mean": torch.full((64,), 3.0),
                 "backbone.body.stem.bn1.running_var": torch.full((64,), 4.0)}
    with pytest.raises(KeyError):
        pw.params_from_torch_state_dict(stem_only)


def test_pickled_numpy_tree_loads_through_params_from_jax(tmp_path, tree):
    """The SGD trainers' ``model_final.pkl``: the JAX tree with numpy leaves."""
    path = tmp_path / "model_final.pkl"
    with open(path, "wb") as f:
        pickle.dump(tree, f)
    assert_same_params(load_any_checkpoint(str(path)), pw.params_from_jax(tree))
    caffe2 = write_pkl(tmp_path / "model_c2.pkl", tree)
    assert_same_params(load_any_checkpoint(caffe2), jax_params(caffe2))


@pytest.mark.parametrize("mask", [True, False])
def test_activation_checksums_match_jax(tree, mask):
    t = tree if mask else r50_narrow_tree(mask=False)
    want = jw.activation_checksums(jax.tree_util.tree_map(np.asarray, t), seed=3)
    got = pw.activation_checksums(pw.params_from_jax(t), seed=3, device="cpu")
    assert list(got) == list(want)
    assert ("mask_deconv_256" in got) == mask and "cls_logits" in got
    for stage in want:
        assert tuple(got[stage]["shape"]) == tuple(want[stage]["shape"]), stage
        for field in ("mean", "std", "absmax"):
            np.testing.assert_allclose(got[stage][field], want[stage][field], rtol=1e-4,
                                       atol=1e-7, err_msg=f"{stage}/{field}")
