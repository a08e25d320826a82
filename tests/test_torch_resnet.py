"""Port's stem (plain version of kernel B2) and trunk vs the JAX package.

- stem: the plain fused stem vs ``stem_fused`` (Pallas, interpret mode) and
  ``resnet.stem`` on f32 inputs (fp32 sums in another order: atol 1e-5), and
  vs ``stem_fused`` on bf16 inputs (both round once from fp32: 1 bf16 ulp).
- trunk: ``params_from_jax`` then ``backbone_c4`` / ``res5_head`` /
  ``rpn_features`` / ``mask_deconv`` at full R-50 depth on a tiny canvas
  (rtol 1e-4 of each output's largest magnitude).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.models import resnet as jresnet
from online_detection_tpu.ops.stem_pool import stem_fused as j_stem_fused
from online_detection_tpu_torch.ops.stem_pool import pooled_size, stem_fused, stem_reference

torch.set_num_threads(2)


def _stem_params(rng):
    w = (rng.normal(size=(7, 7, 3, 64)) * 0.1).astype(np.float32)  # HWIO
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = (rng.normal(size=64) * 0.1).astype(np.float32)
    return w, scale, bias


def _port_stem(x, w, scale, bias):
    return stem_fused(torch.from_numpy(x), torch.from_numpy(np.transpose(w, (3, 2, 0, 1)).copy()),
                      torch.from_numpy(scale), torch.from_numpy(bias)).numpy()


@pytest.mark.parametrize("h,w", [(32, 64), (64, 96)])
def test_stem_matches_pallas_interpret_and_stem_f32(rng, h, w):
    x = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    wt, scale, bias = _stem_params(rng)
    got = _port_stem(x, wt, scale, bias)
    pallas = np.asarray(j_stem_fused(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(scale),
                                     jnp.asarray(bias), interpret=True))
    plain = np.asarray(jresnet.stem(jnp.asarray(x), {"w": jnp.asarray(wt),
                                                     "scale": jnp.asarray(scale),
                                                     "bias": jnp.asarray(bias)}))
    assert got.shape == pallas.shape == plain.shape == (2, h // 4, w // 4, 64)
    np.testing.assert_allclose(got, pallas, atol=1e-5)
    np.testing.assert_allclose(got, plain, atol=1e-5)


@pytest.mark.parametrize("h,w", [(34, 42), (30, 38)])
def test_stem_odd_half_sizes_match_stem(rng, h, w):
    """H/2 or W/2 odd: the pool's last window hangs over the edge."""
    x = rng.normal(size=(1, h, w, 3)).astype(np.float32)
    wt, scale, bias = _stem_params(rng)
    got = _port_stem(x, wt, scale, bias)
    plain = np.asarray(jresnet.stem(jnp.asarray(x), {"w": jnp.asarray(wt),
                                                     "scale": jnp.asarray(scale),
                                                     "bias": jnp.asarray(bias)}))
    assert got.shape == plain.shape == (1, *pooled_size(h, w), 64)
    np.testing.assert_allclose(got, plain, atol=1e-5)


def test_stem_bf16_within_one_ulp_of_pallas(rng):
    x = rng.normal(size=(2, 64, 96, 3)).astype(np.float32)
    wt, scale, bias = _stem_params(rng)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(np.transpose(wt, (3, 2, 0, 1)).copy()).to(torch.bfloat16)
    got = stem_reference(xb, wb, torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(j_stem_fused(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt, jnp.bfloat16),
                                   jnp.asarray(scale), jnp.asarray(bias), interpret=True),
                      np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp + 1e-30).all()


@pytest.fixture(scope="module")
def full_tree():
    from online_detection_tpu.models.detector import init_detector_params

    tree = init_detector_params(jax.random.key(0), 15, 22)
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol=1e-4):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def test_params_from_jax_backbone_full_depth(full_tree, rng):
    from online_detection_tpu_torch.models import resnet
    from online_detection_tpu_torch.models.weights import params_from_jax

    params = params_from_jax(full_tree)
    assert len(params.backbone.res4) == 6 and len(params.backbone.res5) == 3
    images = (rng.uniform(-120, 120, size=(2, 64, 96, 3))).astype(np.float32)
    want = np.asarray(jresnet.backbone_c4(full_tree["backbone"], jnp.asarray(images)))
    got = resnet.backbone_c4(params.backbone, torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (2, 4, 6, 1024)
    _close(got, want)


def test_params_from_jax_heads(full_tree, rng):
    from online_detection_tpu.models.heads import mask_deconv as j_deconv
    from online_detection_tpu.models.rpn import rpn_features as j_rpn_features
    from online_detection_tpu_torch.models import resnet
    from online_detection_tpu_torch.models.heads import mask_deconv
    from online_detection_tpu_torch.models.rpn import rpn_features
    from online_detection_tpu_torch.models.weights import params_from_jax

    params = params_from_jax(full_tree)
    c4 = np.abs(rng.normal(size=(2, 4, 5, 1024))).astype(np.float32)
    _close(rpn_features(params.rpn, torch.from_numpy(c4)).numpy(),
           np.asarray(j_rpn_features(full_tree["rpn"], jnp.asarray(c4))))
    pooled = np.abs(rng.normal(size=(3, 14, 14, 1024))).astype(np.float32)
    _close(resnet.res5_head(params.backbone, torch.from_numpy(pooled)).numpy(),
           np.asarray(jresnet.res5_head(full_tree["backbone"], jnp.asarray(pooled))))
    res5 = resnet.res5_feature_map(params.backbone, torch.from_numpy(pooled))
    want5 = np.asarray(jresnet.res5_feature_map(full_tree["backbone"], jnp.asarray(pooled)))
    _close(res5.numpy(), want5)
    _close(mask_deconv(params.mask_head, res5).numpy(),
           np.asarray(j_deconv(full_tree["mask_head"], jnp.asarray(want5))))


def test_init_resnet50_params_schema():
    from online_detection_tpu_torch.models.resnet import init_resnet50_params

    net = init_resnet50_params(0)
    assert [len(s) for s in (net.res2, net.res3, net.res4, net.res5)] == [3, 4, 6, 3]
    assert tuple(net.stem.weight.shape) == (64, 3, 7, 7)
    assert tuple(net.res4[0].branch2b.weight.shape) == (256, 256, 3, 3)
    assert net.res3[0].stride == 2 and net.res2[0].stride == 1 and net.res3[1].stride == 1
    assert torch.allclose(net.res5[2].branch2c.scale, torch.full((2048,), 0.1))
    again = init_resnet50_params(0)
    assert torch.equal(net.res4[3].branch2a.weight, again.res4[3].branch2a.weight)
