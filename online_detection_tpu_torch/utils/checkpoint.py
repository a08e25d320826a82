"""On-line model files with the reference's file-name contract (counterpart
of the model half of ``utils/checkpoint.py``).

The reference persists the on-line modules as plain ``torch.save`` files
named ``classifier_rpn`` / ``regressor_rpn`` / ``stats_rpn`` /
``classifier_detector`` / ``regressor_detector`` / ``stats_detector`` /
``classifier_segmentation`` / ``stats_segmentation``
(``run_experiment_online_rpn_ood_oos.py:117-120,236-239,264-267,281-288``).

The port keeps the same names and the JAX package's payload, so either
package reads the other's files: an ``.npz`` per file whose arrays are
``leaf_0``, ``leaf_1``, ... in the order of the model's fields, plus
``meta_sigma`` for a FALKON model and the ``treedef`` string the JAX package
writes (its loaders, like these, read the leaves by index). Reference files
(extensionless ``torch.save`` pickles) are read too, when the ``.npz`` is
absent. Models load onto the CPU; ``OnlineModelSet.to`` moves them.
"""

from __future__ import annotations

import os
import pickle
import types
from typing import Dict, Optional, Sequence

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
