"""The host route of on-line training, through both packages on the CPU:
``compute_feature_stats``, ``project_mask_on_box``, ``harvest_image``, the
host reservoirs (``HarvestAccumulator``), the per-image device fold
(``accumulate``), the COXY grouping (``_positives_from_coxy``,
``_fit_rls_per_class``), and ``harvest_dataset`` + ``train_online_modules``
as a whole on the narrow network of ``test_torch_detector``.

Tolerances: the NumPy parts (statistics, reservoirs, their shuffles, the
COXY grouping) are the same bits with the same seed; the mask projection
within 1e-6 (fp32 sums in another order); the harvested rows within 1e-4
(fp32 convs in another order); head scores and RLS predictions within 2e-3
(fp32 Cholesky solves), as in ``test_torch_training_slice``. The harvests
run in the pinned ``parity_sampling`` mode and the solvers are sized so that
no draw decides anything (every cache row is a Nystrom center)."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.engine import accumulate as j_acc
from online_detection_tpu.engine import device_accumulate as jd
from online_detection_tpu.engine import harvest as jh
from online_detection_tpu.models import detector as jdet
from online_detection_tpu.pipelines import online_pipeline as j_pipe
from online_detection_tpu.solvers.falkon import falkon_predict_classes as j_predict
from online_detection_tpu.solvers.rls import rls_predict as j_rls_predict
from online_detection_tpu.utils import stats as j_stats
from online_detection_tpu_torch.engine import accumulate as acc
from online_detection_tpu_torch.engine import device_accumulate as d
from online_detection_tpu_torch.engine import harvest as h
from online_detection_tpu_torch.models import detector
from online_detection_tpu_torch.models.anchors import anchor_visibility, grid_anchors
from online_detection_tpu_torch.models.weights import params_from_jax
from online_detection_tpu_torch.pipelines import online_pipeline as pipe
from online_detection_tpu_torch.solvers.falkon import falkon_predict_classes
from online_detection_tpu_torch.solvers.rls import rls_predict
from online_detection_tpu_torch.utils import stats
from tests.test_torch_detector import STAGES, narrow_tree
from tests.test_torch_training_slice import DCFG, TinyTeachingSet

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# feature statistics and mask projection


def _masked_pools(rng, c=4, p=9, i=3, b=7, dim=6):
    pos = rng.normal(size=(c, p, dim)).astype(np.float32)
    pv = rng.uniform(size=(c, p)) < 0.6
    pv[1] = False  # a class without positives
    neg = rng.normal(size=(c, i, b, dim)).astype(np.float32) * 2
    nv = rng.uniform(size=(c, i, b)) < 0.5
    nv[2, 1] = False  # an empty batch
    return pos, pv, neg, nv


@pytest.mark.parametrize("as_tensors", [False, True], ids=["numpy", "tensors"])
@pytest.mark.parametrize("pos_fraction", [0.8, None])
def test_compute_feature_stats_bit_equal(rng, as_tensors, pos_fraction):
    pos, pv, neg, nv = _masked_pools(rng)
    want = j_stats.compute_feature_stats(np.random.default_rng(5), pos, pv, neg, nv,
                                         num_samples=200, pos_fraction=pos_fraction)
    args = (pos, pv, neg, nv)
    if as_tensors:
        args = tuple(torch.from_numpy(a) for a in args)
    got = stats.compute_feature_stats(np.random.default_rng(5), *args, num_samples=200,
                                      pos_fraction=pos_fraction)
    for k in ("mean", "std", "mean_norm"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(stats.normalize_coxy(torch.from_numpy(pos[0]), got).numpy(),
                                  np.asarray(j_stats.normalize_coxy(jnp.asarray(pos[0]), want)))


def test_compute_feature_stats_index_fn(rng):
    """The injectable draws (``index_fn``) take the place of the generator."""
    pos, pv, neg, nv = _masked_pools(rng)
    fn = lambda n, size: np.arange(size) % n  # noqa: E731
    want = j_stats.compute_feature_stats(None, pos, pv, neg, nv, num_samples=120, index_fn=fn)
    got = stats.compute_feature_stats(None, pos, pv, neg, nv, num_samples=120, index_fn=fn)
    np.testing.assert_array_equal(got.mean.numpy(), np.asarray(want.mean))
    np.testing.assert_array_equal(got.std.numpy(), np.asarray(want.std))


def test_project_mask_on_box_matches_jax(rng):
    masks = (rng.uniform(size=(5, 37, 53)) < 0.4).astype(np.float32)
    boxes = np.array([[3.0, 4.0, 30.0, 20.0], [0.0, 0.0, 52.0, 36.0], [10.5, 7.25, 11.0, 7.5],
                      [-6.0, -3.0, 60.0, 45.0], [40.0, 30.0, 39.0, 29.0]], np.float32)
    got = h.project_mask_on_box(torch.from_numpy(masks), torch.from_numpy(boxes), 14).numpy()
    for g, (m, b) in enumerate(zip(masks, boxes)):
        want = np.asarray(jh.project_mask_on_box(jnp.asarray(m), jnp.asarray(b), 14))
        np.testing.assert_allclose(got[g], want, atol=1e-6, err_msg=str(g))
    one = h.project_mask_on_box(torch.from_numpy(masks[0]), torch.from_numpy(boxes[0]))
    np.testing.assert_array_equal(one.numpy(), got[0])


# ---------------------------------------------------------------------------
# host reservoirs


A, C, G, NPICK, PPOS, CCAP, PIX = 3, 4, 3, 5, 4, 6, 5
DIMS = dict(rpn_dim=6, det_dim=8, mask_dim=5)


def _valid_first(rng, shape):
    n = shape[-1]
    return np.arange(n) < rng.integers(0, n + 1, size=shape[:-1] + (1,))


def _image_chunk(rng):
    """One image's chunk as numpy fields: (rpn, det, mask, ar)."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    rpn = (f(A, NPICK, 6), _valid_first(rng, (A, NPICK)), f(A, PPOS, 6),
           _valid_first(rng, (A, PPOS)), f(A, PPOS, 4), rng.integers(0, 3, size=(A,)))
    det = (f(G, 8), rng.integers(1, C + 1, size=(G,)), rng.uniform(size=(G,)) < 0.7,
           f(C, NPICK, 8), _valid_first(rng, (C, NPICK)), f(CCAP, 8), f(CCAP, 4),
           rng.integers(1, C + 1, size=(CCAP,)).astype(np.float32),
           _valid_first(rng, (CCAP,)), np.asarray(rng.integers(0, 2)))
    mask = (f(G, PIX, 5), _valid_first(rng, (G, PIX)), f(G, PIX, 5),
            _valid_first(rng, (G, PIX)), rng.integers(1, C + 1, size=(G,)),
            rng.uniform(size=(G,)) < 0.8, np.asarray(rng.integers(0, 3)))
    return rpn, det, mask, np.float32(rng.uniform())


def _build(mod, conv, fields):
    rpn, det, mask, ar = fields
    return mod.HarvestChunk(mod.RPNChunk(*map(conv, rpn)), mod.DetChunk(*map(conv, det)),
                            mod.MaskChunk(*map(conv, mask)), conv(ar))


def _port_chunk(fields):
    return _build(h, lambda a: torch.from_numpy(np.asarray(a)), fields)


def _jax_chunk(fields):
    return _build(jh, jnp.asarray, fields)


_FINALIZE = {
    # det shuffled, RPN dealt round-robin at the configured stride
    "shuffle_det": dict(shuffle_negatives=True, rpn_shuffle_negatives=False,
                        negatives_to_pick=7),
    # both dealt round-robin; the stride differs from the rows an image gave
    "round_robin": dict(shuffle_negatives=False, negatives_to_pick=9),
    # both shuffled, the RPN's draws after the detector's would change them
    "shuffle_all": dict(shuffle_negatives=True),
    # the defaults of the keyword arguments
    "defaults": dict(),
}


def _fill(images=9, seed=3):
    rng = np.random.default_rng(seed)
    mine = acc.HarvestAccumulator(A, C, **DIMS)
    theirs = j_acc.HarvestAccumulator(A, C, **DIMS)
    for _ in range(images):
        fields = _image_chunk(rng)
        mine.add(_port_chunk(fields))
        theirs.add(_jax_chunk(fields))
    return mine, theirs


def _assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("mode", sorted(_FINALIZE))
def test_accumulator_finalize_bit_equal(mode):
    """The same chunks give the same solver arrays, shuffles and truncation
    counts; the small batches (I x B = 2 x 8) truncate every head."""
    mine, theirs = _fill()
    kw = dict(rpn_iterations=2, rpn_batch_size=8, det_iterations=2, det_batch_size=8,
              segm_batch_size=6, **_FINALIZE[mode])
    got, want = mine.finalize(**kw), theirs.finalize(**kw)
    _assert_same_tree(got, want)
    assert got["truncation"]["total"] > 0
    assert got["truncation"]["rpn_neg"] > 0 and got["truncation"]["det_neg"] > 0
    assert got["mask"]["neg"].shape[1] > 1  # several arrival-order batches


def test_accumulator_packed_copy_round_trips():
    """``add``'s one packed copy: every field comes back with its dtype,
    shape and values, and the bytes counted are the fields' bytes."""
    rng = np.random.default_rng(0)
    mine = acc.HarvestAccumulator(A, C, **DIMS)
    fields = _image_chunk(rng)
    chunk = _port_chunk(fields)
    back = mine._to_host(chunk)
    for part, got_part, src_part in zip(("rpn", "det", "mask"), back[:3], fields[:3]):
        for f, g, w in zip(got_part._fields, got_part, src_part):
            w = np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, (part, f)
            np.testing.assert_array_equal(g, w, err_msg=f"{part}.{f}")
    assert float(back.average_recall) == float(fields[3])
    size = sum(t.numel() * t.element_size() for _, t in acc._leaves(chunk))
    assert mine.host_bytes == size


def test_accumulate_matches_accumulate_batch_and_jax():
    """The per-image device fold: the same pools as ``accumulate_batch`` of a
    one-image batch and as the JAX package's ``accumulate``."""
    spec = dict(num_anchor_classes=A, num_classes=C, neg_cap=12, rpn_pos_cap=9, det_pos_cap=4,
                coxy_cap=10, mask_cap=20, mask_pos_cap=15,
                chunk_sizes={"npick": NPICK, "rpn_pos": PPOS, "gt_cap": G, "coxy": CCAP,
                             "mask_pix": PIX}, rpn_dim=6, det_dim=8, mask_dim=5)
    rng = np.random.default_rng(4)
    one, batched, jstate = (d.init_reservoirs(**spec), d.init_reservoirs(**spec),
                            jd.init_reservoirs(**spec))
    for _ in range(4):  # enough to saturate the small pools
        fields = _image_chunk(rng)
        chunk = _port_chunk(fields)
        one = d.accumulate(one, chunk, C)
        batch = h.HarvestChunk(*(type(p)(*(x[None] for x in p)) for p in chunk[:3]),
                               chunk.average_recall[None])
        batched = d.accumulate_batch(batched, batch, torch.tensor([True]), C)
        jstate = jd.accumulate(jstate, _jax_chunk(fields), C)
    for k in ("rpn_neg", "rpn_pos", "rpn_coxy_y", "det_neg", "det_pos", "det_coxy",
              "mask_pos", "mask_neg"):
        got = getattr(one, k)
        valid = got.valid_mask().numpy()
        for other in (getattr(batched, k), getattr(jstate, k)):
            np.testing.assert_array_equal(got.counts.numpy(), np.asarray(other.counts),
                                          err_msg=k)
            np.testing.assert_array_equal(got.rows.numpy()[valid], np.asarray(other.rows)[valid],
                                          err_msg=k)
        np.testing.assert_array_equal(got.attempted.numpy(),
                                      np.asarray(getattr(jstate, k).attempted), err_msg=k)
    assert sum(getattr(one, k).dropped() for k in ("rpn_neg", "det_neg", "mask_neg")) > 0
    for state in (batched, jstate):
        assert int(one.n_images) == int(state.n_images) == 4
        assert int(one.harvest_dropped) == int(state.harvest_dropped)
        np.testing.assert_allclose(float(one.ar_sum), float(state.ar_sum), rtol=1e-6)


# ---------------------------------------------------------------------------
# the COXY rows grouped by class


def _coxy(rng, n=40, dim=6, classes=5):
    c = rng.integers(1, classes + 1, size=n).astype(np.float32)
    c[c == 3] = 1  # a class with no row
    return {"X": rng.normal(size=(n, dim)).astype(np.float32),
            "Y": rng.normal(size=(n, 4)).astype(np.float32) * 0.1, "C": c}


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_positives_from_coxy_bit_equal(rng, fraction):
    coxy = _coxy(rng)
    want, wvalid = j_pipe._positives_from_coxy(coxy, 5, fraction, np.random.default_rng(2))
    got, valid = pipe._positives_from_coxy(coxy, 5, fraction, np.random.default_rng(2))
    np.testing.assert_array_equal(valid.numpy(), wvalid)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not valid[2].any() and valid.any(1).sum() == 4


@pytest.mark.parametrize("zero_based", [True, False])
def test_fit_rls_per_class_matches_jax(rng, zero_based):
    coxy = _coxy(rng, n=60, dim=5)
    cls = coxy["C"] - 1 if zero_based else coxy["C"]
    want = j_pipe._fit_rls_per_class(coxy["X"], coxy["Y"], cls, 5, 0.01, zero_based)
    got = pipe._fit_rls_per_class(torch.from_numpy(coxy["X"]), coxy["Y"], cls, 5, 0.01,
                                  zero_based)
    np.testing.assert_array_equal(got.exists.numpy(), np.asarray(want.exists))
    assert not got.exists[2] and got.exists.sum() == 4
    x = rng.normal(size=(16, 5)).astype(np.float32)
    np.testing.assert_allclose(rls_predict(got, torch.from_numpy(x)).numpy(),
                               np.asarray(j_rls_predict(want, jnp.asarray(x))), atol=2e-3,
                               rtol=2e-3)


def test_fit_rls_per_class_without_rows():
    x = torch.zeros((0, 5))
    got = pipe._fit_rls_per_class(x, np.zeros((0, 4), np.float32), np.zeros((0,)), 3, 0.01,
                                  zero_based=True)
    want = j_pipe._fit_rls_per_class(np.zeros((0, 5), np.float32), np.zeros((0, 4), np.float32),
                                     np.zeros((0,)), 3, 0.01, zero_based=True)
    assert got.beta.shape == tuple(want.beta.shape) and not got.exists.any()


# ---------------------------------------------------------------------------
# the narrow network: harvest_image, then the host route as a whole


H, W, N_IMG, N_CLS = 96, 128, 4, 3
# quota-sized solvers: every cache row is a Nystrom center, in both packages
CFG = dict(num_classes=N_CLS, det_m=256, rpn_m=256, segm_m=512, iterations=2, batch_size=24,
           segm_batch_size=64, shuffle_negatives=True)
HARVEST = dict(gt_cap=4, min_size=96, max_size=400)


@pytest.fixture(scope="module")
def network():
    tree = narrow_tree(np.random.default_rng(7))
    return jax.tree_util.tree_map(jnp.asarray, tree), params_from_jax(tree)


def test_harvest_image_matches_jax(network):
    jtree, params = network
    ds = TinyTeachingSet(N_IMG, H, W)
    hcfg = dict(num_anchor_classes=15, num_classes=N_CLS, negatives_to_pick=6, gt_cap=4,
                parity_sampling=True)
    anchors = grid_anchors(H // 16, W // 16)
    vis = anchor_visibility(anchors, (W, H))
    image = ds.load_image(1)
    gb = np.zeros((4, 4), np.float32)
    gb[0] = ds.get_annotation(1).boxes[0]
    gl = np.array([2, 0, 0, 0])
    gv = np.arange(4) < 1
    gm = np.zeros((4, H, W), np.float32)
    gm[0] = ds.load_masks(1)[0]
    size = np.array([W, H])
    want = jh.harvest_image(jax.random.key(0), jtree, None, jnp.asarray(anchors),
                            jnp.asarray(vis), jnp.asarray(image), jnp.asarray(size),
                            jnp.asarray(gb), jnp.asarray(gl), jnp.asarray(gv), jnp.asarray(gm),
                            jh.HarvestConfig(**hcfg), jdet.DetectorConfig(**DCFG))
    t = torch.from_numpy
    got = h.harvest_image(params, None, t(anchors), t(vis), t(image), t(size), t(gb), t(gl),
                          t(gv), t(gm), h.HarvestConfig(**hcfg), detector.DetectorConfig(**DCFG))
    for part in ("rpn", "det", "mask"):
        for f, g, w in zip(getattr(got, part)._fields, getattr(got, part),
                           getattr(want, part)):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape, (part, f)
            if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
                np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{part}.{f}")
            else:
                np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4,
                                           err_msg=f"{part}.{f}")
    assert got.mask.pos_valid[0].any() and got.mask.neg_valid[0].any()
    np.testing.assert_allclose(float(got.average_recall), float(want.average_recall), atol=1e-5)


def _result_lines(out_dir):
    """result.txt's lines, the times and the AR value taken out."""
    text = (out_dir / "result.txt").read_text()
    text = re.sub(r"\d+min:\d+s", "T", text)
    return [re.sub(r"(Average Recall \(AR\): )\S+", r"\1AR", ln) for ln in text.splitlines()]


_ROUTE = {}


@pytest.fixture(scope="module")
def host_route(network, tmp_path_factory):
    """(JAX harvest, JAX models, port harvest, port models); ``_ROUTE`` gets
    both packages' result.txt lines and the port's stage timings."""
    jtree, params = network
    ds = TinyTeachingSet(N_IMG, H, W)
    c4, c5 = STAGES[2][1], STAGES[3][1]
    mp = pytest.MonkeyPatch()
    try:
        for mod in (j_pipe, pipe):
            mp.setattr(mod, "HarvestConfig",
                       functools.partial(mod.HarvestConfig, parity_sampling=True))
            mp.setattr(mod, "HarvestAccumulator",
                       functools.partial(mod.HarvestAccumulator, rpn_dim=c4, det_dim=c5))
        jdir, pdir = (tmp_path_factory.mktemp(n) for n in ("jax_host", "port_host"))
        jcfg = j_pipe.OnlineTrainConfig(**CFG)
        jharvest = j_pipe.harvest_dataset(jax.random.key(1), jtree, ds, jcfg, (H, W),
                                          dcfg=jdet.DetectorConfig(**DCFG), output_dir=str(jdir),
                                          **HARVEST)
        jonline = j_pipe.train_online_modules(jax.random.key(2), jharvest, jcfg,
                                              output_dir=str(jdir))
        cfg = pipe.OnlineTrainConfig(**CFG)
        gen = torch.Generator().manual_seed(0)
        harvest = pipe.harvest_dataset(gen, params, ds, cfg, (H, W),
                                       dcfg=detector.DetectorConfig(**DCFG),
                                       output_dir=str(pdir), device="cpu", **HARVEST)
        timings = {}
        online = pipe.train_online_modules(gen, harvest, cfg, output_dir=str(pdir),
                                           device="cpu", timings=timings)
    finally:
        mp.undo()
    _ROUTE.update(jax_lines=_result_lines(jdir), port_lines=_result_lines(pdir),
                  timings=timings)
    return jharvest, jonline, harvest, online


def test_host_route_pools_match(host_route):
    jharvest, _, harvest, _ = host_route
    for head in ("rpn", "det", "mask"):
        for k in ("pos_valid", "neg_valid"):
            np.testing.assert_array_equal(harvest[head][k], jharvest[head][k],
                                          err_msg=f"{head}/{k}")
        for k in ("pos", "neg"):
            np.testing.assert_allclose(harvest[head][k], jharvest[head][k], atol=1e-4,
                                       rtol=1e-4, err_msg=f"{head}/{k}")
        assert harvest[head]["neg_valid"].any() and harvest[head]["pos_valid"].any()
    for head in ("rpn", "det"):
        np.testing.assert_array_equal(harvest[head]["coxy"]["C"], jharvest[head]["coxy"]["C"])
        for k in ("X", "Y"):
            np.testing.assert_allclose(harvest[head]["coxy"][k], jharvest[head]["coxy"][k],
                                       atol=1e-4, rtol=1e-4, err_msg=f"{head}/coxy/{k}")
    assert harvest["truncation"] == jharvest["truncation"]
    np.testing.assert_allclose(harvest["average_recall"], jharvest["average_recall"], atol=1e-5)
    assert harvest["host_bytes"] > 0 and harvest["finalize_time"] >= 0
    # no Nystrom draw decides anything: every head's cache fits its centers
    for head, m in (("rpn", CFG["rpn_m"]), ("det", CFG["det_m"]), ("mask", CFG["segm_m"])):
        n_pos = harvest[head]["pos_valid"].sum(1).max()
        n_neg = harvest[head]["neg_valid"].reshape(N_CLS if head != "rpn" else 15, -1).sum(1)
        assert 2 * n_pos <= m and n_pos + n_neg.max() <= m, head


@pytest.mark.parametrize("head", ["rpn", "detector", "mask"])
def test_host_route_heads_score_alike(host_route, head):
    _, jonline, _, online = host_route
    jm, m = getattr(jonline, head), getattr(online, head)
    np.testing.assert_array_equal(m.falkon.exists.numpy(), np.asarray(jm.falkon.exists))
    assert m.falkon.exists.any()
    for k in ("mean", "std", "mean_norm"):
        np.testing.assert_allclose(getattr(m.stats, k).numpy(), np.asarray(getattr(jm.stats, k)),
                                   atol=1e-4, rtol=1e-4, err_msg=k)
    x = np.random.default_rng(3).normal(size=(32, m.falkon.centers.shape[-1])).astype(
        np.float32) * 3.0 + m.stats.mean.numpy()
    want = np.asarray(j_predict(jm.falkon, j_stats.zscore(jnp.asarray(x), jm.stats)))
    got = falkon_predict_classes(m.falkon, stats.zscore(torch.from_numpy(x), m.stats)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)
    if head != "mask":
        np.testing.assert_array_equal(m.rls.exists.numpy(), np.asarray(jm.rls.exists))
        np.testing.assert_allclose(rls_predict(m.rls, torch.from_numpy(x)).numpy(),
                                   np.asarray(j_rls_predict(jm.rls, jnp.asarray(x))),
                                   atol=2e-3, rtol=2e-3)


def test_host_route_result_lines_match_jax(host_route):
    assert _ROUTE["port_lines"] == _ROUTE["jax_lines"]
    assert _ROUTE["port_lines"][:2] == ["Detector's features extracted in: T ",
                                        "Average Recall (AR): AR "]
    assert list(_ROUTE["timings"]) == ["rpn_falkon", "rpn_rls", "det_rls", "det_falkon",
                                       "segm_falkon"]


def test_host_route_mesh_raises():
    """The host route trains on a mesh now; a mesh whose first device is
    not the ``device`` asked for raises before any work."""
    from online_detection_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="not the mesh's first device"):
        pipe.train_online_modules(None, {}, pipe.OnlineTrainConfig(),
                                  mesh=Mesh(devices=["cpu"]), device="cuda")
