"""The port's spans and counters (``utils/telemetry.py``: ``annotate``,
``count``, ``last_root``) and where the program opens them.

The mechanism on the CPU: with no ``torch.profiler`` session nothing is
recorded; under one a span is an ``odtpu::`` range in the trace and a record
with its parent, root and self time; counts land on the innermost open span;
an exception closes its span and goes through; each thread keeps its own
stack.

The instrumented paths: a tiny ``harvest_dataset_device`` and
``train_online_modules_device`` (the teaching set, narrow network and sizes
of ``test_torch_training_slice``) run with and without a profiler: every
canvas batch has its ``harvest.*`` and ``trunk.*`` spans in order,
``harvest.masks`` only with the segmenter, ``nms.sweeps`` at least 1 a
batch, the training stages' spans beside ``timings=``; the reservoirs and
models are bit-identical, and the ``timings`` keys and ``result.txt`` lines
unchanged."""

import contextlib
import functools
import re
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from online_detection_tpu_torch.engine import device_accumulate as dacc
from online_detection_tpu_torch.models import detector
from online_detection_tpu_torch.models.weights import params_from_jax
from online_detection_tpu_torch.pipelines import device_pipeline as dpipe
from online_detection_tpu_torch.pipelines.online_pipeline import OnlineTrainConfig
from online_detection_tpu_torch.utils import telemetry
from online_detection_tpu_torch.utils.telemetry import annotate, count, last_root
from tests.test_torch_detector import STAGES, narrow_tree
from tests.test_torch_training_slice import CFG, DCFG, HARVEST, H, W, TinyTeachingSet

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _empty_buffer():
    telemetry._RECORDS.clear()
    yield
    telemetry._RECORDS.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


# ---------------------------------------------------------------- the mechanism

def test_nothing_is_recorded_without_a_profiler():
    with annotate("outer"):
        count("probe", 3)
        with annotate("inner"):
            count("probe")
    assert len(telemetry._RECORDS) == 0 and last_root("outer") == []
    assert telemetry._stack() == []


def test_span_is_a_trace_range_and_a_record_with_parent_root_and_self_time():
    with _cpu_profile() as prof:
        with annotate("outer"):
            time.sleep(0.002)
            with annotate("inner"):
                time.sleep(0.004)
                (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    names = [e.name for e in prof.events()]
    assert "odtpu::outer" in names and "odtpu::inner" in names
    tree = last_root("outer")
    assert [r.name for r in tree] == ["outer", "inner"]
    outer, inner = tree
    assert outer.parent is None and outer.root == outer.index
    assert inner.parent == outer.index and inner.root == outer.index
    assert outer.start_ns <= inner.start_ns and inner.end_ns <= outer.end_ns
    dur = lambda r: r.end_ns - r.start_ns
    assert inner.self_ns == dur(inner) >= 4e6
    assert outer.self_ns == dur(outer) - dur(inner) >= 2e6
    assert last_root("odtpu::outer") == tree  # the range's name finds it too
    assert last_root("inner") == []  # not a root


def test_last_root_reads_the_last_of_its_name():
    with _cpu_profile():
        for k in range(3):
            with annotate("round"):
                with annotate(f"step{k}"):
                    pass
    assert [r.name for r in last_root("round")] == ["round", "step2"]


def test_counts_land_on_the_innermost_open_span():
    with _cpu_profile():
        count("outside")  # no span open: dropped
        with annotate("outer"):
            count("a", 2)
            with annotate("inner"):
                count("a")
                count("b", 5)
                count("b", 1)
            count("a", 3)
    outer, inner = last_root("outer")
    assert outer.counts == {"a": 5}
    assert inner.counts == {"a": 1, "b": 6}


def test_an_exception_closes_the_span_and_goes_through():
    with _cpu_profile() as prof:
        with pytest.raises(KeyError, match="inside"):
            with annotate("raises"):
                with annotate("child"):
                    raise KeyError("inside")
        with annotate("after"):
            pass
    assert telemetry._stack() == []
    assert [r.name for r in last_root("raises")] == ["raises", "child"]
    assert [r.name for r in last_root("after")] == ["after"]  # a root, not a child
    names = [e.name for e in prof.events()]
    assert {"odtpu::raises", "odtpu::child", "odtpu::after"} <= set(names)


def test_two_threads_keep_separate_stacks():
    both_open = threading.Barrier(2)

    def work(tag):
        with annotate(f"root_{tag}"):
            both_open.wait(timeout=10)
            with annotate(f"leaf_{tag}"):
                count("n", 1 if tag == "a" else 10)
            both_open.wait(timeout=10)

    with _cpu_profile():
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for tag, n in (("a", 1), ("b", 10)):
        root, leaf = last_root(f"root_{tag}")
        assert leaf.name == f"leaf_{tag}" and leaf.parent == root.index
        assert leaf.counts == {"n": n} and root.parent is None


# ---------------------------------------------------------------- the instrumented paths

HARVEST_BATCH = ["harvest.load", "harvest.upload", "harvest.trunk", "trunk.backbone",
                 "trunk.propose", "trunk.roi", "harvest.sample", "harvest.accumulate"]


def _teach(with_segmentation, traced, out_dir):
    """One harvest and training of the tiny teaching set -> (reservoirs'
    arrays, models' tensors, timings, result.txt lines, harvest spans,
    training spans, the trace's names)."""
    rng = np.random.default_rng(7)
    params = params_from_jax(narrow_tree(rng))
    cfg = OnlineTrainConfig(**dict(CFG, with_segmentation=with_segmentation))
    c4, c5 = STAGES[2][1], STAGES[3][1]
    mp = pytest.MonkeyPatch()
    mp.setattr(dacc, "init_reservoirs",
               functools.partial(dacc.init_reservoirs, rpn_dim=c4, det_dim=c5))
    telemetry._RECORDS.clear()
    timings = {}
    try:
        with (_cpu_profile() if traced else contextlib.nullcontext()) as prof:
            gen = torch.Generator().manual_seed(0)
            state, _ = dpipe.harvest_dataset_device(
                gen, params, TinyTeachingSet(4, H, W), cfg, (H, W),
                dcfg=detector.DetectorConfig(**DCFG), device="cpu", **HARVEST)
            pools = {k: (v.rows.clone(), v.counts.clone()) for k, v in vars(state).items()
                     if isinstance(v, dacc.Pool)}
            online = dpipe.train_online_modules_device(gen, [state], cfg,
                                                       output_dir=str(out_dir), device="cpu",
                                                       timings=timings)
    finally:
        mp.undo()
    models = list(_tensors(online))
    lines = [re.sub(r"\d+min:\d+s", "T", line)
             for line in (out_dir / "result.txt").read_text().splitlines()]
    names = set() if prof is None else {e.name for e in prof.events()}
    return pools, models, timings, lines, last_root("harvest"), last_root("train"), names


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, tuple) or hasattr(obj, "_fields"):
        for x in obj:
            yield from _tensors(x)
    elif hasattr(obj, "__dataclass_fields__"):
        for k in obj.__dataclass_fields__:
            yield from _tensors(getattr(obj, k))


@pytest.fixture(scope="module", params=[True, False], ids=["segmenter", "no_segmenter"])
def teach_runs(request, tmp_path_factory):
    seg = request.param
    plain = _teach(seg, False, tmp_path_factory.mktemp("plain"))
    assert len(telemetry._RECORDS) == 0  # no profiler: nothing recorded
    traced = _teach(seg, True, tmp_path_factory.mktemp("traced"))
    return seg, plain, traced


def _batches(tree):
    """The harvest root's spans without the masks, cut at each batch's
    ``harvest.load``."""
    names = [r.name for r in tree[1:] if r.name != "harvest.masks"]
    assert names[-1] == "harvest.finish"
    names = names[:-1]
    per = len(HARVEST_BATCH)
    return [names[i:i + per] for i in range(0, len(names), per)]


def test_every_batch_has_its_spans_in_order(teach_runs):
    seg, _, (*_, tree, _, names) = teach_runs
    assert tree[0].name == "harvest" and tree[0].parent is None
    n_batches = -(-4 // HARVEST["batch_size"])
    batches = _batches(tree)
    assert batches == [HARVEST_BATCH] * n_batches
    by_index = {r.index: r for r in tree}
    for r in tree[1:]:
        parent = by_index[r.parent].name
        want = {"trunk": "harvest.trunk", "harvest": "harvest"}[r.name.split(".")[0]]
        if r.name == "harvest.masks":
            want = "harvest.load"
        assert parent == want, (r.name, parent)
    masks = [r for r in tree if r.name == "harvest.masks"]
    assert len(masks) == (4 if seg else 0)
    assert {"odtpu::" + n for n in HARVEST_BATCH} <= names


def test_nms_sweeps_are_counted_on_each_batch(teach_runs):
    _, _, (*_, tree, _, _) = teach_runs
    proposes = [r for r in tree if r.name == "trunk.propose"]
    assert proposes and all(r.counts.get("nms.sweeps", 0) >= 1 for r in proposes)
    assert all(not r.counts for r in tree if r.name != "trunk.propose")


def test_training_stages_have_spans_beside_timings(teach_runs):
    seg, _, (_, _, timings, _, _, tree, names) = teach_runs
    assert tree[0].name == "train" and tree[0].parent is None
    stages = [r.name for r in tree[1:] if r.parent == tree[0].index]
    want = ["train.prepare", "train.rpn_falkon", "train.rpn_rls", "train.prepare",
            "train.det_rls", "train.det_falkon"]
    want += ["train.prepare", "train.segm_falkon"] if seg else []
    assert stages == want
    assert [s for s in stages if s != "train.prepare"] == ["train." + k for k in timings]
    for r in tree:
        if r.name[len("train."):] in timings:
            # the span holds the clock's reading, and little more
            assert 0 <= (r.end_ns - r.start_ns) / 1e9 - timings[r.name[6:]] < 0.05
    assert {"odtpu::train", "odtpu::train.det_falkon"} <= names


def test_a_traced_run_computes_what_an_untraced_one_does(teach_runs):
    _, plain, traced = teach_runs
    (pools0, models0, timings0, lines0, *_), (pools1, models1, timings1, lines1, *_) = \
        plain, traced
    assert pools0.keys() == pools1.keys() and pools0
    for k in pools0:
        assert torch.equal(pools0[k][0], pools1[k][0]) and torch.equal(pools0[k][1],
                                                                       pools1[k][1]), k
    assert len(models0) == len(models1) > 0
    for a, b in zip(models0, models1):
        assert torch.equal(a, b)
    assert list(timings0) == list(timings1)
    assert lines0 == lines1 and lines0
    assert not plain[4] and not plain[5]  # no spans recorded untraced


# ---------------------------------------------------------------- tools/idle_by_span.py

def _idle_tool():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / "idle_by_span.py"
    spec = importlib.util.spec_from_file_location("idle_by_span", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_idle_tool_puts_each_gap_under_the_innermost_span():
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [
        x("user_annotation", "bench.harvest", 0, 1000),
        x("user_annotation", "odtpu::harvest", 5, 990),
        x("user_annotation", "odtpu::harvest.load", 10, 200),
        x("user_annotation", "odtpu::harvest.masks", 50, 100),
        x("cpu_op", "aten::copy_", 60, 10),  # host operations are not spans
        x("user_annotation", "odtpu::harvest.trunk", 300, 400),
        x("user_annotation", "bench.train", 1000, 500),
        x("kernel", "k0", 0, 20),
        x("kernel", "k1", 120, 30),  # gap 20..120, midpoint 70: harvest.masks
        x("gpu_memcpy", "copy", 150, 250),  # gap 150..150: none
        x("kernel", "k2", 380, 20),  # overlaps the copy
        x("kernel", "k3", 800, 10),  # gap 400..800, midpoint 600: harvest.trunk
        x("kernel", "k4", 1100, 100),  # gap 810..1100, midpoint 955: harvest (root)
        x("kernel", "k5", 1400, 10),  # gap 1200..1400: bench.train, no span
    ]
    out = _idle_tool().idle_by_span(events)
    assert out["gaps"] == 4
    assert out["busy_s"] == pytest.approx((20 + 30 + 250 + 10 + 100 + 10) / 1e6)
    assert dict(out["by_span"]) == pytest.approx({
        "bench.harvest/odtpu::harvest.masks": 100e-6,
        "bench.harvest/odtpu::harvest.trunk": 400e-6,
        "bench.harvest/odtpu::harvest": 290e-6,
        "bench.train/none": 200e-6})
    assert out["by_bench"] == pytest.approx({"bench.harvest": 790e-6, "bench.train": 200e-6})
    assert out["idle_s"] == pytest.approx(990e-6)
    assert out["span_s"] == {"odtpu::harvest": [1, pytest.approx(990e-6)],
                             "odtpu::harvest.load": [1, pytest.approx(200e-6)],
                             "odtpu::harvest.masks": [1, pytest.approx(100e-6)],
                             "odtpu::harvest.trunk": [1, pytest.approx(400e-6)]}
