"""On-line model files and feature caches with the reference's file-name
contract (counterpart of ``utils/checkpoint.py``).

The reference persists the on-line modules as plain ``torch.save`` files
named ``classifier_rpn`` / ``regressor_rpn`` / ``stats_rpn`` /
``classifier_detector`` / ``regressor_detector`` / ``stats_detector`` /
``classifier_segmentation`` / ``stats_segmentation``
(``run_experiment_online_rpn_ood_oos.py:117-120,236-239,264-267,281-288``),
plus feature caches named ``{positives,negatives}_cl_{i}_batch_{j}`` and
``reg_{x,c,y}_batch_{i}`` (``extract_features_rpn_detector.py:195-299``).

The port keeps the same names and the JAX package's payload, so either
package reads the other's files: an ``.npz`` per model file whose arrays are
``leaf_0``, ``leaf_1``, ... in the order of the model's fields, plus
``meta_sigma`` for a FALKON model and the ``treedef`` string the JAX package
writes (its loaders, like these, read the leaves by index), and one ``.npy``
per cache array. Reference files (extensionless ``torch.save`` pickles) are
read too, when the ``.npz`` / ``.npy`` is absent. Models load onto the CPU;
``OnlineModelSet.to`` moves them.

The feature loader keeps the reference's load-time semantics
(``py_od_utils.load_features_classifier:120-200``): negatives re-batched
under SHUFFLE_NEGATIVES with the feature-extraction config's
ITERATIONS/BATCH_SIZE, and the segmentation pools subsampled at
``sample_ratio`` (with replacement, like the reference's ``torch.randint``),
with the JAX package's NumPy draws.
"""

from __future__ import annotations

import glob
import os
import pickle
import types
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from online_detection_tpu_torch.models.detector import OnlineModelSet
from online_detection_tpu_torch.models.heads import OnlineDetectorModels, OnlineMaskModels
from online_detection_tpu_torch.models.rpn import OnlineRPNModels
from online_detection_tpu_torch.solvers.falkon import FalkonModel
from online_detection_tpu_torch.solvers.rls import RLSModel
from online_detection_tpu_torch.utils.stats import FeatureStats


def _save_leaves(path: str, leaves: Sequence[torch.Tensor], meta: Optional[Dict] = None):
    payload = {f"leaf_{i}": x.detach().cpu().numpy() for i, x in enumerate(leaves)}
    # the JAX package's str(treedef) of a flat tuple of leaves
    treedef = "PyTreeDef((" + ", ".join("*" * len(leaves)) + "))"
    payload["treedef"] = np.frombuffer(treedef.encode(), dtype=np.uint8)
    for k, v in (meta or {}).items():
        payload[f"meta_{k}"] = np.asarray(v)
    np.savez(path + ".npz", **payload)


def _load_leaves(path: str, n: int):
    """-> (the first ``n`` leaves as CPU tensors, {meta name: array})."""
    with np.load(path + ".npz") as data:
        leaves = [torch.from_numpy(data[f"leaf_{i}"]) for i in range(n)]
        meta = {k[len("meta_"):]: data[k] for k in data.files if k.startswith("meta_")}
    return leaves, meta


class _StubObject:
    """Stand-in for classes whose defining module is absent at unpickle time
    (the reference's ``classifier_*`` files pickle ``falkon.models.Falkon``
    instances; the falkon CUDA library is not installed here). Captures the
    pickled attribute state; attribute access reads it."""

    def __setstate__(self, state):
        if isinstance(state, tuple) and len(state) == 2:
            merged = dict(state[0] or {})
            merged.update(state[1] or {})
            state = merged
        self.__dict__.update(state if isinstance(state, dict) else {"_state": state})

    def __getattr__(self, name):  # only called when not in __dict__
        raise AttributeError(name)


def _tolerant_pickle_module():
    """A pickle-compatible module whose Unpickler maps unresolvable classes
    to _StubObject — lets ``torch.load`` read reference payloads that
    reference uninstalled libraries (falkon, maskrcnn_benchmark)."""

    class TolerantUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return type(name, (_StubObject,), {"__module__": module})

    mod = types.ModuleType("tolerant_pickle")
    mod.Unpickler = TolerantUnpickler
    mod.load = lambda *a, **k: TolerantUnpickler(*a, **k).load()
    mod.loads = pickle.loads
    mod.dump = pickle.dump
    mod.dumps = pickle.dumps
    return mod


def torch_load_tolerant(path: str):
    """``torch.load(map_location='cpu')`` with unresolvable classes stubbed."""
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_tolerant_pickle_module())


def _torch_numpy(t) -> np.ndarray:
    a = t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)
    return a.astype(np.float32) if a.dtype == np.float64 else a


def _falkon_from_torch_payload(payload) -> FalkonModel:
    """Reference ``classifier_*`` file (list/array of falkon.Falkon objects,
    None where a class had no data) -> class-batched FalkonModel."""
    models = list(payload)
    centers_list, alpha_list, sigma = [], [], None
    for m in models:
        if m is None:
            centers_list.append(None)
            alpha_list.append(None)
            continue
        centers_list.append(_torch_numpy(m.ny_points_))
        alpha_list.append(_torch_numpy(m.alpha_).reshape(-1))
        if sigma is None and hasattr(m, "kernel"):
            s = getattr(m.kernel, "sigma", None)
            if s is not None:
                sigma = float(np.asarray(_torch_numpy(s)).reshape(-1)[0])
    dims = [c.shape[1] for c in centers_list if c is not None]
    m_cap = max([1] + [len(c) for c in centers_list if c is not None])
    d = dims[0] if dims else 1
    c_n = len(models)
    centers = np.zeros((c_n, m_cap, d), np.float32)
    alpha = np.zeros((c_n, m_cap), np.float32)
    exists = np.zeros((c_n,), bool)
    for i, (cen, al) in enumerate(zip(centers_list, alpha_list)):
        if cen is None:
            continue
        # duplicate-pad short center lists (spans the same Nystrom subspace;
        # padded alpha stays 0 so predictions are unchanged)
        centers[i, : len(cen)] = cen
        centers[i, len(cen):] = cen[0] if len(cen) else 0.0
        alpha[i, : len(al)] = al
        exists[i] = True
    return FalkonModel(torch.from_numpy(centers), torch.from_numpy(alpha),
                       torch.from_numpy(exists), float(sigma if sigma is not None else 5.0))


def _rls_from_torch_payload(payload) -> RLSModel:
    """Reference ``regressor_*`` file (array of {mu, T, T_inv, Beta} dicts,
    ``train_region_refiner.py:73-78``) -> class-batched RLSModel."""
    models = list(payload)
    c_n = len(models)
    d = 1
    for m in models:
        if m is not None and m.get("Beta") is not None:
            d = len(_torch_numpy(m["Beta"]["0"]["weights"])) - 1
            break
    beta = np.zeros((c_n, d + 1, 4), np.float32)
    t = np.zeros((c_n, 4, 4), np.float32)
    t_inv = np.zeros((c_n, 4, 4), np.float32)
    mu = np.zeros((c_n, 4), np.float32)
    exists = np.zeros((c_n,), bool)
    losses = np.zeros((c_n, 4), np.float32)
    for i, m in enumerate(models):
        if m is None or m.get("Beta") is None:
            continue
        exists[i] = True
        mu[i] = _torch_numpy(m["mu"])
        t[i] = _torch_numpy(m["T"])
        t_inv[i] = _torch_numpy(m["T_inv"])
        for k in range(4):
            beta[i, :, k] = _torch_numpy(m["Beta"][str(k)]["weights"])
            losses[i, k] = float(_torch_numpy(m["Beta"][str(k)]["losses"]).mean())
    return RLSModel(*(torch.from_numpy(a) for a in (beta, t_inv, t, mu, exists, losses)))


def _stats_from_torch_payload(payload) -> FeatureStats:
    return FeatureStats(*(torch.from_numpy(np.asarray(_torch_numpy(payload[k]), np.float32))
                          for k in ("mean", "std", "mean_norm")))


def _reference_file(path: str) -> bool:
    return not os.path.exists(path + ".npz") and os.path.exists(path)


def save_falkon(path: str, model: FalkonModel):
    _save_leaves(path, (model.centers, model.alpha, model.exists),
                 meta={"sigma": model.sigma})


def load_falkon(path: str) -> FalkonModel:
    if _reference_file(path):
        return _falkon_from_torch_payload(torch_load_tolerant(path))
    leaves, meta = _load_leaves(path, 3)
    return FalkonModel(*leaves, float(meta["sigma"]))


def save_rls(path: str, model: RLSModel):
    _save_leaves(path, (model.beta, model.t_inv, model.t, model.mu, model.exists,
                        model.mean_losses))


def load_rls(path: str) -> RLSModel:
    if _reference_file(path):
        return _rls_from_torch_payload(torch_load_tolerant(path))
    return RLSModel(*_load_leaves(path, 6)[0])


def save_stats(path: str, stats: FeatureStats):
    _save_leaves(path, (stats.mean, stats.std, stats.mean_norm))


def load_stats(path: str) -> FeatureStats:
    if _reference_file(path):
        return _stats_from_torch_payload(torch_load_tolerant(path))
    return FeatureStats(*_load_leaves(path, 3)[0])


def save_rpn_models(output_dir: str, rpn: OnlineRPNModels):
    """``classifier_rpn``/``regressor_rpn``/``stats_rpn``
    (``run_experiment_online_rpn_ood_oos.py:117-120``)."""
    os.makedirs(output_dir, exist_ok=True)
    save_falkon(os.path.join(output_dir, "classifier_rpn"), rpn.falkon)
    save_rls(os.path.join(output_dir, "regressor_rpn"), rpn.rls)
    save_stats(os.path.join(output_dir, "stats_rpn"), rpn.stats)


def load_rpn_models(output_dir: str) -> OnlineRPNModels:
    j = lambda n: os.path.join(output_dir, n)
    return OnlineRPNModels(
        falkon=load_falkon(j("classifier_rpn")),
        rls=load_rls(j("regressor_rpn")),
        stats=load_stats(j("stats_rpn")),
    )


def save_detector_models(output_dir: str, det: OnlineDetectorModels):
    os.makedirs(output_dir, exist_ok=True)
    save_falkon(os.path.join(output_dir, "classifier_detector"), det.falkon)
    save_rls(os.path.join(output_dir, "regressor_detector"), det.rls)
    save_stats(os.path.join(output_dir, "stats_detector"), det.stats)


def load_detector_models(output_dir: str) -> OnlineDetectorModels:
    j = lambda n: os.path.join(output_dir, n)
    return OnlineDetectorModels(
        falkon=load_falkon(j("classifier_detector")),
        rls=load_rls(j("regressor_detector")),
        stats=load_stats(j("stats_detector")),
    )


def save_segmentation_models(output_dir: str, mask: OnlineMaskModels):
    os.makedirs(output_dir, exist_ok=True)
    save_falkon(os.path.join(output_dir, "classifier_segmentation"), mask.falkon)
    save_stats(os.path.join(output_dir, "stats_segmentation"), mask.stats)


def load_segmentation_models(output_dir: str) -> OnlineMaskModels:
    j = lambda n: os.path.join(output_dir, n)
    return OnlineMaskModels(
        falkon=load_falkon(j("classifier_segmentation")),
        stats=load_stats(j("stats_segmentation")),
    )


def save_online_models(output_dir: str, online: OnlineModelSet):
    """Write the reference's 8 model files (those that exist)."""
    os.makedirs(output_dir, exist_ok=True)
    if online.rpn is not None:
        save_rpn_models(output_dir, online.rpn)
    save_detector_models(output_dir, online.detector)
    if online.mask is not None:
        save_segmentation_models(output_dir, online.mask)


def load_online_models(output_dir: str) -> OnlineModelSet:
    """Read the reference's 8 model files — either payload format (.npz from
    either package, or reference torch pickles of the same names) — onto the
    CPU."""
    j = lambda n: os.path.join(output_dir, n)
    have = lambda n: os.path.exists(j(n + ".npz")) or os.path.exists(j(n))
    rpn = load_rpn_models(output_dir) if have("classifier_rpn") else None
    mask = load_segmentation_models(output_dir) if have("classifier_segmentation") else None
    return OnlineModelSet(rpn=rpn, detector=load_detector_models(output_dir), mask=mask)


# ---------------------------------------------------------------------------
# feature caches


def save_features(output_dir: str, harvest: Dict, heads=None):
    """Persist harvested feature pools (NumPy, as ``harvest_dataset`` returns
    them) with the reference's cache names. ``heads``: optional subset of
    {"rpn", "det", "mask"} to write."""
    os.makedirs(output_dir, exist_ok=True)
    if heads is not None:
        harvest = {k: v for k, v in harvest.items() if k in heads}

    def save_head(sub: str, head: Dict):
        d = os.path.join(output_dir, sub)
        os.makedirs(d, exist_ok=True)
        pos, pv = head["pos"], head["pos_valid"]
        for c in range(pos.shape[0]):
            np.save(os.path.join(d, f"positives_cl_{c}_batch_0.npy"), pos[c][pv[c]])
        neg, nv = head["neg"], head["neg_valid"]
        for c in range(neg.shape[0]):
            for b in range(neg.shape[1]):
                np.save(os.path.join(d, f"negatives_cl_{c}_batch_{b}.npy"), neg[c, b][nv[c, b]])
        if "coxy" in head:
            np.save(os.path.join(d, "reg_x_batch_0.npy"), head["coxy"]["X"])
            np.save(os.path.join(d, "reg_c_batch_0.npy"), head["coxy"]["C"])
            np.save(os.path.join(d, "reg_y_batch_0.npy"), head["coxy"]["Y"])

    if "rpn" in harvest:
        save_head("features_RPN", harvest["rpn"])
    if "det" in harvest:
        save_head("features_detector", harvest["det"])
    if "mask" in harvest:
        save_head("features_segmentation", harvest["mask"])


def _load_rows(d: str, stem: str) -> Optional[np.ndarray]:
    """One cache array: ``{stem}.npy``, or the reference's extensionless
    ``torch.save`` pickle of the same name."""
    npy = os.path.join(d, stem + ".npy")
    if os.path.exists(npy):
        return np.load(npy)
    ref = os.path.join(d, stem)
    if os.path.exists(ref):
        return _torch_numpy(torch.load(ref, map_location="cpu", weights_only=False))
    return None


def _cache_stems(d: str, pattern: str) -> List[str]:
    """Cache file stems matching a ``positives_cl_*``-style pattern, in
    either payload format."""
    stems = {
        os.path.basename(p)[: -len(".npy")] if p.endswith(".npy") else os.path.basename(p)
        for p in glob.glob(os.path.join(d, pattern + ".npy")) + glob.glob(os.path.join(d, pattern))
        if not p.endswith(".npz")
    }
    return sorted(stems)


def _num_classes_in_dir(d: str, prefix: str) -> int:
    ids = set()
    for stem in _cache_stems(d, f"{prefix}_cl_*_batch_*"):
        try:
            ids.add(int(stem.split("_cl_")[1].split("_batch_")[0]))
        except (IndexError, ValueError):
            continue
    return max(ids) + 1 if ids else 0


def _load_class_batches(d: str, prefix: str, c: int) -> List[np.ndarray]:
    out = []
    for b in range(len(_cache_stems(d, f"{prefix}_cl_{c}_batch_*"))):
        rows = _load_rows(d, f"{prefix}_cl_{c}_batch_{b}")
        if rows is None:
            break
        out.append(rows)
    return out


def rebatch_negatives_shuffled(neg_batches: List[np.ndarray], batch_size: Optional[int],
                               num_batches: Optional[int], perm_fn) -> List[np.ndarray]:
    """One class of ``py_od_utils.shuffle_negatives`` (``:276-294``):
    concatenate all batches, permute, re-slice into ``num_batches`` batches
    of ``batch_size`` (trailing batches may be empty; overflow rows are
    dropped, as in the reference). ``perm_fn(n) -> permutation``."""
    bs = batch_size if batch_size is not None else (len(neg_batches[0]) if neg_batches else 0)
    total = np.concatenate(neg_batches, axis=0) if neg_batches else np.zeros((0, 0), np.float32)
    nb = num_batches
    if nb is None:
        nb = int(np.ceil(len(total) / max(bs, 1)))
    ids = np.asarray(perm_fn(len(total)))
    out = []
    for j in range(nb):
        lo = min(j * bs, len(ids))
        hi = min((j + 1) * bs, len(ids))
        out.append(total[ids[lo:hi]])
    return out


def _pack_head(pos_list, neg_list) -> Dict:
    """Per-class row lists -> the ``finalize``-shaped masked buffers."""
    n_cls = len(pos_list)
    p_cap = max([1] + [len(p) for p in pos_list])
    n_iter = max([1] + [len(n) for n in neg_list])
    b_cap = max([1] + [len(b) for blist in neg_list for b in blist])
    dim = 1
    for p in pos_list:
        if np.asarray(p).size:
            dim = np.asarray(p).shape[1]
            break
    else:
        for blist in neg_list:
            for b in blist:
                if np.asarray(b).size:
                    dim = np.asarray(b).shape[1]
                    break
    pos = np.zeros((n_cls, p_cap, dim), np.float32)
    pv = np.zeros((n_cls, p_cap), bool)
    neg = np.zeros((n_cls, n_iter, b_cap, dim), np.float32)
    nv = np.zeros((n_cls, n_iter, b_cap), bool)
    for c in range(n_cls):
        n = len(pos_list[c])
        if n:
            pos[c, :n] = pos_list[c]
            pv[c, :n] = True
        for b, rows in enumerate(neg_list[c]):
            if len(rows):
                neg[c, b, : len(rows)] = rows
                nv[c, b, : len(rows)] = True
    return {"pos": pos, "pos_valid": pv, "neg": neg, "neg_valid": nv}


def load_features(output_dir: str, det_shuffle_negatives: bool = False,
                  rpn_shuffle_negatives: bool = False, iterations: Optional[int] = None,
                  batch_size: Optional[int] = None, sampling_ratio_segmentation: float = 1.0,
                  rng: Optional[np.random.Generator] = None) -> Dict:
    """Inverse of ``save_features`` -> the ``finalize``-shaped dict, with the
    reference loader's semantics (``load_features_classifier:120-200``):

    - ``det/rpn_shuffle_negatives``: that head's negative batches are pooled,
      permuted and re-sliced into ``iterations`` batches of ``batch_size``;
    - ``sampling_ratio_segmentation``: segmentation positives/negatives are
      subsampled at this ratio with replacement (``:162-182``), negatives
      pooled into a single batch;
    - reads ``.npy`` caches and reference torch-pickle caches.
    """
    rng = rng if rng is not None else np.random.default_rng(0)
    out: Dict = {}
    for sub, key in (("features_RPN", "rpn"), ("features_detector", "det"),
                     ("features_segmentation", "mask")):
        d = os.path.join(output_dir, sub)
        if not os.path.isdir(d):
            continue
        n_cls = _num_classes_in_dir(d, "positives")
        # multi-batch positives per class (reference spill) are concatenated
        pos_list = []
        for c in range(n_cls):
            batches = [b for b in _load_class_batches(d, "positives", c) if len(b)]
            pos_list.append(np.concatenate(batches, axis=0) if batches
                            else np.zeros((0, 1), np.float32))
        neg_list = [_load_class_batches(d, "negatives", c) for c in range(n_cls)]

        if key == "mask":
            # is_segm: negatives pooled into one batch; both pools subsampled
            ratio = sampling_ratio_segmentation

            def subsample(rows):
                if ratio < 1 and len(rows):
                    return rows[rng.integers(0, len(rows), size=int(len(rows) * ratio))]
                return rows

            pos_list = [subsample(p) for p in pos_list]
            neg_list = [[subsample(np.concatenate(nb, axis=0))] if nb else [] for nb in neg_list]
        elif rpn_shuffle_negatives if key == "rpn" else det_shuffle_negatives:
            neg_list = [rebatch_negatives_shuffled(nb, batch_size, iterations, rng.permutation)
                        for nb in neg_list]

        head = _pack_head(pos_list, neg_list)
        # all reg batches concatenated (``load_features_regressor:202-224``)
        n_reg = len(_cache_stems(d, "reg_x_batch_*"))
        if n_reg:
            xs, cs, ys = [], [], []
            for i in range(n_reg):
                xs.append(_load_rows(d, f"reg_x_batch_{i}"))
                cs.append(_load_rows(d, f"reg_c_batch_{i}"))
                ys.append(_load_rows(d, f"reg_y_batch_{i}"))
            head["coxy"] = {
                "X": np.concatenate(xs, axis=0),
                "C": np.concatenate([np.reshape(c, (-1,)) for c in cs], axis=0),
                "Y": np.concatenate(ys, axis=0),
            }
        out[key] = head
    return out
