"""The port's config loader and on-line model files against the JAX
package's, on the CPU.

- ``build_configs``: the same field values in both packages for the YAML
  texts of the flagship CLI's smoke test, and the same dataset resolution.
- Model files: on-line models saved by the JAX package load in the port and
  the reverse, with equal arrays, dtypes and sigmas (with and without the
  RPN and segmentation heads); the port writes the same ``.npz`` members as
  the JAX package. A reference-style ``torch.save`` pickle (falkon objects
  whose library is absent at load time, regressor dict arrays, stats dicts)
  loads to the same arrays in both packages.

Every comparison is exact.
"""

import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.config import config as j_config
from online_detection_tpu.models.detector import OnlineModelSet as JSet
from online_detection_tpu.models.heads import OnlineDetectorModels as JDet
from online_detection_tpu.models.heads import OnlineMaskModels as JMask
from online_detection_tpu.models.rpn import OnlineRPNModels as JRPN
from online_detection_tpu.solvers.falkon import FalkonModel as JFalkon
from online_detection_tpu.solvers.rls import RLSModel as JRLS
from online_detection_tpu.utils import checkpoint as j_ckpt
from online_detection_tpu.utils.stats import FeatureStats as JStats
from online_detection_tpu_torch.config import config as t_config
from online_detection_tpu_torch.utils import checkpoint as t_ckpt
from tests.test_experiment_cli import FEAT_CFG, ONLINE_CFG

torch.set_num_threads(2)


@pytest.mark.parametrize("iterations", [None, 3])
@pytest.mark.parametrize("online_text", [ONLINE_CFG, ONLINE_CFG + """
CHOSEN_CLASSES: {0: __background__, 1: mug1, 2: flower2, 3: book4}
"""])
def test_build_configs_match_jax(tmp_path, iterations, online_text):
    feat = tmp_path / "feat.yaml"
    feat.write_text(FEAT_CFG.format(root=str(tmp_path / "data")))
    online = tmp_path / "online.yaml"
    online.write_text(online_text)
    jf, jo = j_config.load_yaml(str(feat)), j_config.load_yaml(str(online))
    tf, to = t_config.load_yaml(str(feat)), t_config.load_yaml(str(online))
    assert (tf, to) == (jf, jo)
    jt, jd, jx = j_config.build_configs(jf, jo, iterations)
    tt, td, tx = t_config.build_configs(tf, to, iterations)
    assert tt._asdict() == jt._asdict()
    assert td._asdict() == jd._asdict()
    assert tx == jx
    assert tt.iterations == (iterations or 2) and td.detections_per_img == 10


@pytest.mark.parametrize("name", ["icubworld_id_21objects_test_target_task_with_masks",
                                  "ycb_video_test_keyframe", "ho3d_v2_test_icubworld_format",
                                  "path:/data/x:Main:test"])
def test_resolve_dataset_matches_jax(name):
    assert t_config.resolve_dataset(name, "/d") == j_config.resolve_dataset(name, "/d")
    text = f'("{name}", "")'
    assert t_config.parse_dataset_tuple(text) == j_config.parse_dataset_tuple(text) == (name,)


def _arrays(rng, c, m, d):
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    exists = np.arange(c) % 3 != 1
    return dict(centers=f32(c, m, d), alpha=f32(c, m), exists=exists,
                beta=f32(c, d + 1, 4), t_inv=f32(c, 4, 4), t=f32(c, 4, 4), mu=f32(c, 4),
                losses=np.abs(f32(c, 4)), mean=f32(d), std=np.abs(f32(d)),
                mean_norm=np.float32(11.5))


def _jax_set(rng, rpn=True, mask=True):
    def head(c, m, d, sigma, with_rls=True):
        a = _arrays(rng, c, m, d)
        j = {k: jnp.asarray(v) for k, v in a.items()}
        parts = [JFalkon(j["centers"], j["alpha"], j["exists"], sigma)]
        if with_rls:
            parts.append(JRLS(j["beta"], j["t_inv"], j["t"], j["mu"], j["exists"],
                              j["losses"]))
        parts.append(JStats(j["mean"], j["std"], j["mean_norm"]))
        return parts

    return JSet(rpn=JRPN(*head(5, 6, 8, 50.0)) if rpn else None,
                detector=JDet(*head(4, 7, 12, 15.0)),
                mask=JMask(*head(4, 5, 6, 10.0, with_rls=False)) if mask else None)


def _leaves(online):
    """(name, numpy array) of every model array, and the sigmas, in one
    order for either package."""
    out = []
    for head in ("rpn", "detector", "mask"):
        h = getattr(online, head)
        if h is None:
            out.append((head, None))
            continue
        f = h.falkon
        out += [(f"{head}.falkon.{k}", getattr(f, k)) for k in ("centers", "alpha", "exists")]
        out.append((f"{head}.falkon.sigma", f.sigma))
        if head != "mask":
            out += [(f"{head}.rls.{k}", getattr(h.rls, k))
                    for k in ("beta", "t_inv", "t", "mu", "exists", "mean_losses")]
        out += [(f"{head}.stats.{k}", getattr(h.stats, k)) for k in ("mean", "std", "mean_norm")]
    return [(k, v if v is None or isinstance(v, float) else np.asarray(v)) for k, v in out]


def _assert_same_models(got, want):
    g, w = _leaves(got), _leaves(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        if a is None or isinstance(a, float):
            assert a == b, k
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("rpn,mask", [(True, True), (False, True), (True, False)])
def test_jax_model_files_load_in_port_and_back(tmp_path, rpn, mask):
    rng = np.random.default_rng(0)
    jset = _jax_set(rng, rpn, mask)
    j_ckpt.save_online_models(str(tmp_path / "jax"), jset)
    loaded = t_ckpt.load_online_models(str(tmp_path / "jax"))
    assert loaded.detector.falkon.centers.device.type == "cpu"
    _assert_same_models(loaded, jset)

    t_ckpt.save_online_models(str(tmp_path / "port"), loaded)
    back = j_ckpt.load_online_models(str(tmp_path / "port"))
    _assert_same_models(back, jset)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for n in names:  # the same members, the same arrays, the same treedef text
        with np.load(tmp_path / "jax" / n) as a, np.load(tmp_path / "port" / n) as b:
            assert a.files == b.files, n
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{n}:{k}")


def _install_fake_falkon():
    mod = types.ModuleType("fake_falkon_port_test")

    class GaussianKernel:
        def __init__(self, sigma):
            self.sigma = sigma

    class Falkon:
        def __init__(self, ny, alpha, sigma):
            self.ny_points_ = ny
            self.alpha_ = alpha
            self.kernel = GaussianKernel(torch.tensor(float(sigma)))

    for cls in (GaussianKernel, Falkon):
        cls.__module__ = mod.__name__
        cls.__qualname__ = cls.__name__
        setattr(mod, cls.__name__, cls)
    sys.modules[mod.__name__] = mod
    return mod


def test_reference_torch_pickles_load_alike(tmp_path):
    """Extensionless ``torch.save`` files of the reference's layout, read
    after the falkon library is gone, give the same models in both
    packages."""
    rng = np.random.default_rng(1)
    mod = _install_fake_falkon()
    d, m = 6, 4
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    try:
        for head in ("detector", "rpn", "segmentation"):  # classes 1 and 3 have models
            fal = [mod.Falkon(t(m, d), t(m, 1), 12.0), None,
                   mod.Falkon(t(m - 1, d), t(m - 1, 1), 12.0)]
            torch.save(fal, str(tmp_path / f"classifier_{head}"))
            stats = {"mean": t(d), "std": t(d).abs(), "mean_norm": torch.tensor(9.25)}
            torch.save(stats, str(tmp_path / f"stats_{head}"))
            if head == "segmentation":
                continue
            regs = np.empty((0,))
            for k in range(3):
                if k == 1:
                    regs = np.append(regs, {"mu": None, "T": None, "T_inv": None, "Beta": None})
                    continue
                regs = np.append(regs, {
                    "mu": t(4), "T": t(4, 4), "T_inv": t(4, 4),
                    "Beta": {str(c): {"weights": t(d + 1), "losses": t(9) ** 2}
                             for c in range(4)}})
            torch.save(regs, str(tmp_path / f"regressor_{head}"))
    finally:
        del sys.modules[mod.__name__]  # the falkon library is absent at load time

    jset = j_ckpt.load_online_models(str(tmp_path))
    tset = t_ckpt.load_online_models(str(tmp_path))
    _assert_same_models(tset, jset)
    assert tset.detector.falkon.sigma == 12.0
    assert tset.detector.falkon.exists.tolist() == [True, False, True]
    assert float(tset.detector.falkon.alpha[2, m - 1]) == 0.0  # short list, zero-padded
