"""The port's backbone-feature cache (``online_detection_tpu_torch/engine/
backbone_cache.py``) against the JAX package's, on the CPU, on one
``make_synthetic_icwt`` tree with a narrow R-50 network:

- both packages' dumps hold the same files, and every cached C4 value within
  one float16 ulp (the two trunks sum in float32 in other orders before the
  rounding); below float16's smallest normal (6.1e-5) its grid is finer
  than those float32 differences on activations of order 1, so there the
  bound is 1e-6;
- each package's ``FromFeatDataset`` reads the other's cache: the same maps,
  scales and sizes;
- fine-tuning from the cached maps (``freeze_backbone``) gives the JAX
  package's loss history with the JAX draws injected, and no RoIAlign
  backward (the cached maps need no gradient)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.data.datasets.icubworld import ICubWorldDataset as JDataset
from online_detection_tpu.engine import backbone_cache as jbc
from online_detection_tpu.engine import trainer as jt
from online_detection_tpu_torch.data.datasets.icubworld import ICubWorldDataset
from online_detection_tpu_torch.data.datasets.synthetic import make_synthetic_icwt
from online_detection_tpu_torch.engine import backbone_cache as pbc
from online_detection_tpu_torch.engine import trainer as pt
from online_detection_tpu_torch.models.weights import params_from_jax
from tests.test_torch_sgd_trainer import CANVAS, N_CLS, SIZES, TRAIN_KW, step_draws
from tests.test_torch_weights import r50_narrow_tree

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("backbone_cache")
    root = str(tmp / "ycbv_synth")
    make_synthetic_icwt(root, n_train=3, n_test=1)
    tree = r50_narrow_tree(seed=5, n_cls=N_CLS)
    pds, jds = ICubWorldDataset(root, "Main", "train"), JDataset(root, "Main", "train")
    port_dir = pbc.dump_backbone_features(params_from_jax(tree), pds, str(tmp / "port"), CANVAS,
                                          device="cpu", **SIZES)
    jax_dir = jbc.dump_backbone_features(jax.tree_util.tree_map(jnp.asarray, tree), jds,
                                         str(tmp / "jax"), CANVAS, **SIZES)
    return {"tree": tree, "pds": pds, "jds": jds, "port": port_dir, "jax": jax_dir}


def test_dumps_agree_within_one_float16_ulp(caches):
    names = sorted(os.listdir(caches["port"]))
    assert names == sorted(os.listdir(caches["jax"])) and "_meta.npy" in names
    assert len(names) == len(caches["pds"]) + 1
    for name in names:
        if name == "_meta.npy":
            continue
        got = np.load(os.path.join(caches["port"], name))
        want = np.load(os.path.join(caches["jax"], name))
        assert got.dtype == want.dtype == np.float16 and got.shape == want.shape
        assert got.shape == (CANVAS[0] // 16, CANVAS[1] // 16, 64)
        mag = np.maximum(np.abs(got), np.abs(want)).astype(np.float32)
        ulp = np.maximum(np.spacing(mag.astype(np.float16)).astype(np.float32), 1e-6)
        assert (np.abs(got.astype(np.float32) - want.astype(np.float32)) <= ulp).all(), name
    pm = np.load(os.path.join(caches["port"], "_meta.npy"), allow_pickle=True).item()
    jm = np.load(os.path.join(caches["jax"], "_meta.npy"), allow_pickle=True).item()
    assert pm == jm


@pytest.mark.parametrize("cache", ["port", "jax"])
def test_each_package_reads_the_others_cache(caches, cache):
    pff = pbc.FromFeatDataset(caches["pds"], caches[cache])
    jff = jbc.FromFeatDataset(caches["jds"], caches[cache])
    assert len(pff) == len(jff) and pff.classes == jff.classes
    for i in range(len(pff)):
        (pc4, ps, psz), (jc4, js, jsz) = pff.load_features(i), jff.load_features(i)
        np.testing.assert_array_equal(pc4, jc4)
        assert pc4.dtype == np.float32 and ps == js and psz == jsz
        assert pff.get_annotation(i).image_id == jff.get_annotation(i).image_id


def test_fine_tuning_from_features_matches_jax(caches, monkeypatch):
    from online_detection_tpu_torch.ops import roi_align as proi

    calls = []
    backward = proi.roi_align_backward
    monkeypatch.setattr(proi, "roi_align_backward", lambda *a, **k: calls.append(1) or
                        backward(*a, **k))
    kw = dict(TRAIN_KW, freeze_backbone=True, freeze_rpn_except_logits=True)
    key = jax.random.key(4)
    _, jhist = jt.do_train(jax.tree_util.tree_map(jnp.asarray, caches["tree"]),
                           jbc.FromFeatDataset(caches["jds"], caches["jax"]), CANVAS,
                           jt.SGDConfig(max_iter=2, **kw), key, with_mask=True, log_every=100,
                           **SIZES)
    params, hist = pt.do_train(params_from_jax(caches["tree"]),
                               pbc.FromFeatDataset(caches["pds"], caches["jax"]), CANVAS,
                               pt.SGDConfig(max_iter=2, **kw),
                               draws=step_draws(key, 2, kw["post_nms_train"]), with_mask=True,
                               log_every=100, device="cpu", **SIZES)
    np.testing.assert_allclose(hist, jhist, rtol=1e-4)
    assert calls == []
