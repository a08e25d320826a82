"""The port's device mesh (``online_detection_tpu_torch/parallel/mesh.py``)
on a virtual CPU mesh of 8, against the JAX package's 8-device CPU mesh
(``tests/conftest.py``): the cases of ``tests/test_mesh.py``.

Pools are sized at the center quotas (6 positives = M/2, 6 negatives in one
batch), so no Nystrom draw happens on either side and the sharded models are
comparable across frameworks. Tolerances are the JAX tests': scores within
1e-4 (rtol and atol); RLS mu within 1e-5, beta within 2e-3, t_inv within
1e-4; ``run_inference`` boxes within rtol 1e-3 / atol 0.1 with equal labels.
Each sharded port result is also held to the port's unsharded one at the
same tolerances.

The port's flagship CLI with ``--CPU --n_devices 2`` (device route, harvest
trunk and inference split over the mesh, solvers class-sharded) trains the
models of its unsharded device route on one synthetic tree: exists equal,
centers within 1e-4, scores on a probe within 2e-3, RLS beta within 1e-3
(the JAX CLI test's tolerances)."""

import copy
import gc
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.parallel import mesh as jmesh
from online_detection_tpu.solvers import falkon as jf
from online_detection_tpu.solvers import minibootstrap as jmb
from online_detection_tpu.solvers import rls as jr
from online_detection_tpu.utils.stats import FeatureStats as JStats
from online_detection_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    pad_axis,
    shard_batch,
    train_classifiers_minibootstrap_sharded,
)
from online_detection_tpu_torch.ops import _build
from online_detection_tpu_torch.solvers import falkon as f
from online_detection_tpu_torch.solvers import minibootstrap as mb
from online_detection_tpu_torch.solvers import rls as r
from online_detection_tpu_torch.utils.stats import FeatureStats

torch.set_num_threads(2)

P = dict(m=12, sigma=3.0, lam=1e-2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _mesh8():
    return make_mesh(8, device="cpu")


def _toy_problem(rng, c=8, p_cap=6, n_iter=1, batch=6, d=8):
    pos = (rng.normal(size=(c, p_cap, d)) + 1.0).astype(np.float32)
    neg = (rng.normal(size=(c, n_iter, batch, d)) - 1.0).astype(np.float32)
    return pos, np.ones((c, p_cap), bool), neg, np.ones((c, n_iter, batch), bool)


def _probe(seed, d=8, n=32):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _scores(model, x):
    return f.falkon_predict_classes(model, torch.from_numpy(x)).numpy()


def _jscores(model, x):
    return np.asarray(jf.falkon_predict_classes(model, jnp.asarray(x)))


def test_mesh_requires_enough_devices():
    assert make_mesh(8, device="cpu").size == 8 == jmesh.make_mesh(8).devices.size
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="devices requested"):
        make_mesh(n_cards + 1)
    with pytest.raises(ValueError, match="devices requested"):
        jmesh.make_mesh(len(jax.devices()) + 1)
    # an explicit list may repeat a device; equal devices compare equal
    m = Mesh(devices=["cpu", torch.device("cpu")])
    assert m.size == 2 and m.devices[0] == m.devices[1] == m.first
    with pytest.raises(ValueError):
        Mesh(devices=[])


@pytest.mark.parametrize("c", [8, 5], ids=["8_classes", "5_padded_to_8"])
def test_sharded_minibootstrap_matches_jax_and_unsharded(rng, c):
    pos, pv, neg, nv = _toy_problem(rng, c=c)
    jref = jmb.train_classifiers_minibootstrap(
        jax.random.key(0), *map(jnp.asarray, (pos, pv, neg, nv)), jmb.MinibootstrapParams(**P))
    jgot = jmesh.train_classifiers_minibootstrap_sharded(
        jax.random.key(0), *map(jnp.asarray, (pos, pv, neg, nv)), jmb.MinibootstrapParams(**P),
        jmesh.make_mesh(8))
    args = [torch.from_numpy(a) for a in (pos, pv, neg, nv)]
    ref = mb.train_classifiers_minibootstrap(*args, mb.MinibootstrapParams(**P),
                                             generator=torch.Generator().manual_seed(0))
    got = train_classifiers_minibootstrap_sharded(*args, mb.MinibootstrapParams(**P), _mesh8(),
                                                  generator=torch.Generator().manual_seed(0))
    assert got.alpha.shape == ref.alpha.shape == (c, P["m"])
    assert bool(got.exists.all())
    np.testing.assert_array_equal(got.exists.numpy(), np.asarray(jgot.exists))
    x = _probe(7)
    np.testing.assert_allclose(_scores(got, x), _jscores(jgot, x), **TOL)
    np.testing.assert_allclose(_scores(got, x), _scores(ref, x), **TOL)
    np.testing.assert_allclose(_jscores(jgot, x), _jscores(jref, x), **TOL)


def test_sharded_solver_with_stats_and_class_chunk(rng):
    """Stats inside the solver and ``class_chunk`` 4 (rounded up to one
    8-wide chunk on the mesh) over 10 classes (padded to 16)."""
    pos, pv, neg, nv = _toy_problem(rng, c=10)
    jstats = JStats(jnp.full((8,), 0.1), jnp.ones((8,)), jnp.asarray(18.0))
    stats = FeatureStats(torch.full((8,), 0.1), torch.ones(8), torch.tensor(18.0))
    jgot = jmb.train_classifiers_minibootstrap(
        jax.random.key(3), *map(jnp.asarray, (pos, pv, neg, nv)), jmb.MinibootstrapParams(**P),
        stats=jstats, mesh=jmesh.make_mesh(8), class_chunk=4)
    args = [torch.from_numpy(a) for a in (pos, pv, neg, nv)]
    ref = mb.train_classifiers_minibootstrap(*args, mb.MinibootstrapParams(**P), stats=stats)
    got = mb.train_classifiers_minibootstrap(*args, mb.MinibootstrapParams(**P), stats=stats,
                                             mesh=_mesh8(), class_chunk=4)
    assert got.alpha.shape == ref.alpha.shape == (10, P["m"])
    np.testing.assert_array_equal(got.exists.numpy(), np.asarray(jgot.exists))
    np.testing.assert_array_equal(got.exists.numpy(), ref.exists.numpy())
    x = _probe(11)
    np.testing.assert_allclose(_scores(got, x), _jscores(jgot, x), **TOL)
    np.testing.assert_allclose(_scores(got, x), _scores(ref, x), **TOL)


@pytest.mark.parametrize("n", [96, 600], ids=["masked", "class_blocks"])
def test_sharded_rls_matches_jax_and_unsharded(rng, n):
    """n 96: the blocks would be the whole buffer, so each device masks it;
    n 600: the classes' rows are compacted into 256-row blocks first."""
    d, c = 16, 5  # pads to 8 on the mesh
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(n, 4)).astype(np.float32)
    cls1 = rng.integers(1, c + 1, n).astype(np.float32)
    w = (rng.uniform(size=n) > 0.2).astype(np.float32)
    jgot = jr.rls_fit_grouped(*map(jnp.asarray, (x, y, cls1, w)), c, 10.0, device_solve=True,
                              mesh=jmesh.make_mesh(8))
    args = [torch.from_numpy(a) for a in (x, y, cls1, w)]
    ref = r.rls_fit_grouped(*args, c, 10.0, device_solve=True)
    got = r.rls_fit_grouped(*args, c, 10.0, device_solve=True, mesh=_mesh8())
    assert got.beta.shape == ref.beta.shape == (c, d + 1, 4)
    for want, name in ((jgot, "jax"), (ref, "unsharded")):
        np.testing.assert_array_equal(got.exists.numpy(), np.asarray(want.exists), name)
        np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(got.beta.numpy(), np.asarray(want.beta), rtol=2e-3,
                                   atol=2e-3, err_msg=name)
        np.testing.assert_allclose(got.t_inv.numpy(), np.asarray(want.t_inv), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_shard_batch_places_batch_axis():
    mesh = Mesh(devices=["cpu"] * 8)
    tree = {"x": torch.zeros((16, 4)), "y": (torch.arange(16), None)}
    out = shard_batch(tree, mesh)
    assert len(out) == 8
    for k, part in enumerate(out):
        assert part["x"].shape == (2, 4)  # 16 rows / 8 devices
        assert part["y"][0].tolist() == [2 * k, 2 * k + 1] and part["y"][1] is None
    jout = jmesh.shard_batch({"x": jnp.zeros((16, 4))}, jmesh.make_mesh(8))
    assert jout["x"].addressable_shards[0].data.shape[0] == out[0]["x"].shape[0]
    assert pad_axis(torch.ones(5, 3), 8).shape == (8, 3)
    with pytest.raises(ValueError, match="does not split"):
        mesh.split(torch.zeros(12))


def test_replicas_are_made_once_per_device():
    lin = torch.nn.Linear(2, 2)
    mesh = Mesh(devices=["cpu"] * 3)
    reps = mesh.replicas(lin)
    assert all(rep is lin for rep in reps)  # already on that device: not copied
    assert mesh.replicas(None) == [None] * 3


class _CardsOnTheCpu(Mesh):
    """A mesh of CUDA entries whose data stay on the CPU (a CPU build of
    torch cannot move a tensor to a card): each object replica is a copy."""

    def _place(self, obj, dev):
        return obj if isinstance(obj, torch.Tensor) else copy.deepcopy(obj)


@pytest.fixture
def current_card(monkeypatch):
    """``torch.cuda.device`` / ``current_device`` / ``current_stream`` faked:
    ``current[0]`` is the current card's index, None outside any context."""
    current = [None]

    class _Device:
        def __init__(self, dev):
            self.index = torch.device(dev).index

        def __enter__(self):
            self.prev, current[0] = current[0], self.index

        def __exit__(self, *exc):
            current[0] = self.prev

    monkeypatch.setattr(torch.cuda, "device", _Device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=1000 + current[0]))
    return current


def test_map_runs_each_slice_with_its_card_current(current_card):
    mesh = _CardsOnTheCpu(devices=["cuda:0", "cuda:1"])
    lin = torch.nn.Linear(2, 2)
    seen = []

    def shard(x, net):
        seen.append((torch.cuda.current_device(), x.tolist(), net is lin))
        return x * 2, (None, x + 1)

    doubled, (none, plus) = mesh.map(shard, (torch.arange(4),), (lin,))
    assert seen == [(0, [0, 1], False), (1, [2, 3], False)]
    assert doubled.tolist() == [0, 2, 4, 6] and none is None and plus.tolist() == [1, 2, 3, 4]
    assert current_card[0] is None  # restored after each slice


def test_every_mining_launch_has_its_slice_card_current(rng, current_card, monkeypatch):
    """The class-sharded minibootstrap through the B1 wrapper, patched to
    record the current card: slice k's launches all see card k."""
    pos, pv, neg, nv = _toy_problem(rng, c=4, n_iter=3, batch=2)
    args = [torch.from_numpy(a) for a in (pos, pv, neg, nv)]
    launches = []

    def recorded(x, *a, **kw):
        launches.append(torch.cuda.current_device())
        return mmv_grouped(x, *a, **kw)

    mmv_grouped = mb.mmv_grouped
    params = mb.MinibootstrapParams(**P)
    ref = mb.train_classifiers_minibootstrap(*args, params,
                                             generator=torch.Generator().manual_seed(0))
    monkeypatch.setattr(mb, "mmv_grouped", recorded)
    got = mb.train_classifiers_minibootstrap(*args, params, class_chunk=2,
                                             generator=torch.Generator().manual_seed(0),
                                             mesh=_CardsOnTheCpu(devices=["cuda:0", "cuda:1"]))
    # 2 chunks of 2 classes, each split over 2 cards, 3 mining passes a slice
    assert launches == ([0] * 3 + [1] * 3) * 2
    x = _probe(7)
    np.testing.assert_allclose(_scores(got, x), _scores(ref, x), **TOL)


def test_kernel_launch_makes_the_tensors_card_current(current_card):
    calls = []

    def entry(*args):
        calls.append((torch.cuda.current_device(), args))
        return 0

    assert _build.launch(entry, torch.device("cuda", 3), 7, 8) == 0
    assert calls == [(3, (7, 8, 1003))]  # the card's own stream, passed last
    assert current_card[0] is None


def test_replicas_are_kept_per_card_until_the_object_is_freed():
    mesh = _CardsOnTheCpu(devices=["cuda:0", "cuda:1", "cuda:1"])
    lin = torch.nn.Linear(2, 2)
    reps = mesh.replicas(lin)
    assert reps[0] is not lin and reps[1] is reps[2] and reps[0] is not reps[1]
    assert mesh.replicas(lin) == reps  # made once per distinct card
    assert len(mesh._replicas) == 1
    del lin, reps
    gc.collect()
    assert mesh._replicas == {}


class _Anno:
    def __init__(self, boxes, labels):
        self.boxes, self.labels = boxes, labels
        self.difficult = np.zeros(len(labels), bool)


class _EvalSet:
    """3 held-out images of 96x128 with one coloured ellipse each."""

    classes = ("__background__", "a", "b", "c")

    def __len__(self):
        return 3

    def _make(self, i):
        rng = np.random.default_rng(300 + i)
        img = rng.integers(0, 60, (96, 128, 3), dtype=np.uint8)
        x1, y1 = int(rng.integers(0, 60)), int(rng.integers(0, 40))
        yy, xx = np.mgrid[:96, :128]
        ell = ((xx - x1 - 24) / 24.0) ** 2 + ((yy - y1 - 20) / 20.0) ** 2 <= 1
        img[ell] = [(i * 70) % 255, (i * 130) % 255, 200]
        return img, np.array([[x1, y1, x1 + 48, y1 + 40]], np.float32), ell[None]

    def load_image(self, i):
        return self._make(i)[0]

    def get_annotation(self, i):
        return _Anno(self._make(i)[1], np.array([i % 3 + 1]))

    def load_masks(self, i, anno=None):
        return self._make(i)[2].astype(np.float32)


def _random_online(rng, c4, c5, n_cls):
    """On-line models of the narrow network's widths, random but fixed."""
    from online_detection_tpu_torch.models.detector import OnlineModelSet
    from online_detection_tpu_torch.models.heads import OnlineDetectorModels, OnlineMaskModels
    from online_detection_tpu_torch.models.rpn import OnlineRPNModels
    from online_detection_tpu_torch.solvers.falkon import FalkonModel
    from online_detection_tpu_torch.solvers.rls import RLSModel

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))

    def falkon(c, d, m, sigma):
        return FalkonModel(t(c, m, d), t(c, m, scale=0.5), torch.ones(c, dtype=torch.bool),
                           sigma)

    def rls(c, d):
        eye = torch.eye(4).expand(c, 4, 4).clone()
        return RLSModel(t(c, d + 1, 4, scale=0.01), eye, eye, t(c, 4, scale=0.01),
                        torch.ones(c, dtype=torch.bool), torch.zeros(c, 4))

    def stats(d):
        return FeatureStats(torch.zeros(d), torch.ones(d), torch.tensor(float(d) ** 0.5))

    return OnlineModelSet(
        OnlineRPNModels(falkon(15, c4, 16, 6.0), rls(15, c4), stats(c4)),
        OnlineDetectorModels(falkon(n_cls, c5, 16, 8.0), rls(n_cls, c5), stats(c5)),
        OnlineMaskModels(falkon(n_cls, 256, 16, 16.0), stats(256)))


def test_batched_inference_on_a_mesh_matches_per_image(rng):
    """``run_inference(batch_size=8, mesh)`` over 3 images (the batch padded
    to 8, one image a device) predicts what the per-image path does."""
    from online_detection_tpu_torch.models.detector import DetectorConfig
    from online_detection_tpu_torch.models.weights import params_from_jax
    from online_detection_tpu_torch.pipelines.online_pipeline import run_inference
    from tests.test_torch_detector import STAGES, narrow_tree

    params = params_from_jax(narrow_tree(np.random.default_rng(7)))
    online = _random_online(rng, STAGES[2][1], STAGES[3][1], 3)
    dcfg = DetectorConfig(pre_nms_top_n=150, post_nms_top_n=40, detections_per_img=10,
                          score_thresh=-2.0)
    kw = dict(min_size=96, max_size=400, device="cpu")
    ds = _EvalSet()
    r1, p1 = run_inference(params, online, ds, (96, 128), dcfg, **kw)
    r8, p8 = run_inference(params, online, ds, (96, 128), dcfg, batch_size=8, mesh=_mesh8(),
                           **kw)
    assert len(p1) == len(p8) == 3
    assert sum(len(a["boxes"]) for a in p1) > 0
    for a, b in zip(p1, p8):
        assert len(a["boxes"]) == len(b["boxes"])
        np.testing.assert_allclose(a["boxes"], b["boxes"], rtol=1e-3, atol=0.1)
        np.testing.assert_array_equal(a["labels"], b["labels"])
    assert r1.keys() == r8.keys()


MESH_FEAT_CFG = """
MODEL:
  WEIGHT: ""
  RPN:
    PRE_NMS_TOP_N_TEST: 120
    POST_NMS_TOP_N_TEST: 30
  MASK_ON: True
DATASETS:
  TRAIN: ("path:{root}::train",)
  TEST: ("path:{root}::test",)
INPUT:
  MIN_SIZE_TEST: 96
  MAX_SIZE_TEST: 160
MINIBOOTSTRAP:
  RPN:
    POS_CAP: 96
  DETECTOR:
    NUM_CLASSES: 5
    ITERATIONS: 2
    BATCH_SIZE: 48
    SHUFFLE_NEGATIVES: True
    POS_CAP: 64
    COXY_CAP: 512
SEGMENTATION:
  BATCH_SIZE: 192
  POS_CAP: 128
EVALUATION:
  IOU_THRESHOLDS: (0.5,)
  USE_VOC07_METRIC: True
"""

MESH_ONLINE_CFG = """
NUM_CLASSES: 6
ONLINE_REGION_CLASSIFIER:
  MINIBOOTSTRAP:
    EASY_THRESH: -0.9
    HARD_THRESH: -0.7
  CLASSIFIER: {lambda: 0.00001, sigma: 15, M: 24, kernel_type: 'gauss'}
REGION_REFINER:
  opts: {lambda: 1000}
ONLINE_SEGMENTATION:
  MINIBOOTSTRAP: {EASY_THRESH: -0.9, HARD_THRESH: -0.7}
  CLASSIFIER: {lambda: 0.000001, sigma: 10, M: 16, kernel_type: 'gauss'}
EVALUATION: {SCORE_THRESH: -2, NMS: 0.3, DETECTIONS_PER_IMAGE: 10}
RPN:
  ONLINE_REGION_CLASSIFIER:
    MINIBOOTSTRAP: {EASY_THRESH: -0.9, HARD_THRESH: -0.7}
    CLASSIFIER: {lambda: 0.001, sigma: 50, M: 24, kernel_type: 'gauss'}
  REGION_REFINER:
    opts: {lambda: 0.01}
"""


def test_flagship_cli_n_devices_matches_unsharded_device_route(tmp_path):
    """The port's flagship CLI with ``--CPU --n_devices 2`` against
    ``harvest_dataset_device`` + ``train_online_modules_device`` unsharded,
    with the CLI's configuration, network and seeds (the slimmed YAML of
    ``tests/test_mesh.py``)."""
    from online_detection_tpu_torch.data.datasets.synthetic import make_synthetic_icwt
    from online_detection_tpu_torch.experiments import _common
    from online_detection_tpu_torch.experiments import run_experiment_online_rpn_ood_oos as cli
    from online_detection_tpu_torch.pipelines import device_pipeline as dpipe
    from online_detection_tpu_torch.utils import checkpoint as ckpt

    root = str(tmp_path / "ycbv_synth")
    # classes 1 and 2 of the YCB-Video table: inside the configuration's 5
    make_synthetic_icwt(root, classes=("002_master_chef_can", "003_cracker_box"), n_train=5,
                        n_test=3, image_hw=(120, 160))
    feat, online_yaml = tmp_path / "feat.yaml", tmp_path / "online.yaml"
    feat.write_text(MESH_FEAT_CFG.format(root=root))
    online_yaml.write_text(MESH_ONLINE_CFG)
    out = str(tmp_path / "out")
    results = cli.main(["--output_dir", out, "--config_file_feature_extraction", str(feat),
                        "--config_file_online_rpn_detection_segmentation", str(online_yaml),
                        "--save_RPN_detector_segmentation_models", "--CPU", "--n_devices", "2"])
    assert "det_map_0.5" in results
    assert "Detector's features extracted in" in open(f"{out}/result.txt").read()
    got = ckpt.load_online_models(out)

    train_cfg, det_cfg, extras = _common.load_configs(str(feat), str(online_yaml), None)
    train_ds = _common.make_dataset(extras["train_datasets"][0], "Data/datasets")
    params = _common.load_params(None, extras, train_cfg.num_classes)
    state, _ = dpipe.harvest_dataset_device(
        torch.Generator().manual_seed(1), params, train_ds, train_cfg,
        _common.dataset_canvas(train_ds, extras), dcfg=det_cfg, batch_size=8,
        min_size=extras["min_size_test"], max_size=extras["max_size_test"], device="cpu")
    ref = dpipe.train_online_modules_device(torch.Generator().manual_seed(2), [state],
                                            train_cfg, device="cpu")
    for name in ("rpn", "detector", "mask"):
        g, w = getattr(got, name), getattr(ref, name)
        np.testing.assert_array_equal(g.falkon.exists.numpy(), w.falkon.exists.numpy(), name)
        assert bool(g.falkon.exists.any()), name
        np.testing.assert_allclose(g.falkon.centers.numpy(), w.falkon.centers.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
        x = _probe(7, d=g.falkon.centers.shape[-1])
        np.testing.assert_allclose(_scores(g.falkon, x), _scores(w.falkon, x), rtol=2e-3,
                                   atol=2e-3, err_msg=name)
        if getattr(g, "rls", None) is not None:
            np.testing.assert_allclose(g.rls.beta.numpy(), w.rls.beta.numpy(), rtol=1e-3,
                                       atol=1e-3, err_msg=name)


def test_host_route_detector_on_a_mesh_matches_unsharded(rng):
    """``train_detector_module`` (the host route, its classes in one chunk)
    on a mesh of 2 trains the unsharded models: its pools are above the
    center quota, so the per-class draws must not depend on the split."""
    from online_detection_tpu_torch.pipelines import online_pipeline as pipe

    c, d, n_coxy = 3, 16, 90
    cls = rng.integers(1, c + 1, n_coxy)
    x = (rng.normal(size=(n_coxy, d)) + cls[:, None]).astype(np.float32)
    det = {"pos": np.zeros((c, 1, d), np.float32), "pos_valid": np.zeros((c, 1), bool),
           "neg": rng.normal(size=(c, 2, 20, d)).astype(np.float32) - 2.0,
           "neg_valid": np.ones((c, 2, 20), bool),
           "coxy": {"X": x, "Y": rng.normal(size=(n_coxy, 4)).astype(np.float32) * 0.1,
                    "C": cls.astype(np.float32)}}
    cfg = pipe.OnlineTrainConfig(num_classes=c, det_m=12, det_sigma=4.0, det_lam=1e-3,
                                 iterations=2, batch_size=20)
    ref = pipe.train_detector_module(torch.Generator().manual_seed(4), det, cfg, device="cpu")
    got = pipe.train_detector_module(torch.Generator().manual_seed(4), det, cfg,
                                     mesh=Mesh(devices=["cpu", "cpu"]), device="cpu")
    assert bool(got.falkon.exists.all())
    x = _probe(5, d=d)
    np.testing.assert_allclose(_scores(got.falkon, x), _scores(ref.falkon, x), **TOL)
    np.testing.assert_allclose(got.rls.beta.numpy(), ref.rls.beta.numpy(), rtol=1e-5,
                               atol=1e-6)
