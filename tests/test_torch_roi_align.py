"""Port's RoIAlign (plain versions of kernels B3 and B4) vs the JAX
package's ``roi_align``, and the Pallas ``roi_align_batched`` /
``roi_align_fused2`` in interpret mode. Boxes include zero-area boxes, boxes past the image edge
and a box wider than 8 * P feature cells, which hits the 8-sample clamp.

Tolerance: fp32 sums in another order, atol 5e-5 / rtol 1e-5 (the JAX
package's own interpret-mode tolerance for these kernels)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.ops.roi_align import roi_align as j_roi_align
from online_detection_tpu.ops.roi_align import roi_align_batched as j_batched
from online_detection_tpu.ops.roi_align import roi_align_fused2 as j_fused2
from online_detection_tpu_torch.ops.roi_align import (
    interp_matrix,
    roi_align,
    roi_align_batched,
    roi_align_fused2,
)

torch.set_num_threads(2)


def _rois(rng, b, r, hi):
    raw = rng.uniform(0, hi, size=(b, r, 4)).astype(np.float32)
    rois = np.concatenate([np.minimum(raw[..., :2], raw[..., 2:]),
                           np.maximum(raw[..., :2], raw[..., 2:])], -1)
    # zero-area, past the far edge, before the near edge, wider than 8*P cells
    rois[:, 0] = [50.0, 40.0, 50.0, 40.0]
    rois[:, 1] = [hi - 20, hi - 30, hi + 200, hi + 150]
    rois[:, 2] = [-60.0, -40.0, 30.0, 20.0]
    rois[:, 3] = [0.0, 0.0, 2000.0, 1900.0]
    return rois


def _separable(feats, rois, p):
    return np.asarray(jax.vmap(lambda f, b: j_roi_align(f, b, p, p, 1 / 16.0, 8))(
        jnp.asarray(feats), jnp.asarray(rois)))


def test_roi_align_matches_jax_separable(rng):
    feats = rng.normal(size=(2, 18, 24, 32)).astype(np.float32)
    rois = _rois(rng, 2, 23, 350)
    want = _separable(feats, rois, 14)
    got = roi_align_batched(torch.from_numpy(feats), torch.from_numpy(rois), 14).numpy()
    assert got.shape == (2, 23, 14, 14, 32)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-5)
    # the giant box really used the clamp: ceil(125 / 14) = 9 > 8
    assert np.ceil((2000 / 16) / 14) > 8


def test_roi_align_matches_pallas_batched_interpret(rng):
    feats = rng.normal(size=(2, 18, 24, 32)).astype(np.float32)
    rois = _rois(rng, 2, 21, 350)
    want = np.asarray(j_batched(jnp.asarray(feats), jnp.asarray(rois), interpret=True))
    got = roi_align_batched(torch.from_numpy(feats), torch.from_numpy(rois)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-5)


def test_roi_align_matches_pallas_fused2_interpret(rng):
    feats = rng.normal(size=(2, 10, 12, 8)).astype(np.float32)
    rois = _rois(rng, 2, 6, 150)
    want = np.asarray(j_fused2(jnp.asarray(feats), jnp.asarray(rois), 4, 4, 1 / 16.0, 8,
                               roi_tile=4, chan_tile=8, interpret=True))
    got = roi_align_batched(torch.from_numpy(feats), torch.from_numpy(rois), 4).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-5)


def test_single_image_roi_align(rng):
    feats = rng.normal(size=(9, 11, 5)).astype(np.float32)
    rois = _rois(rng, 1, 7, 160)[0]
    want = np.asarray(j_roi_align(jnp.asarray(feats), jnp.asarray(rois), 7, 7, 1 / 16.0))
    got = roi_align(torch.from_numpy(feats), torch.from_numpy(rois), 7).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-5)


@pytest.mark.parametrize("start,size", [(-0.7, 1.0), (3.2, 40.0), (10.5, 140.0)])
def test_interp_matrix_matches_jax(start, size):
    from online_detection_tpu.ops.roi_align import _interp_matrix

    want = np.asarray(_interp_matrix(jnp.float32(start), jnp.float32(size), 14, 24, 8))
    got = interp_matrix(torch.tensor([start]), torch.tensor([size]), 14, 24)[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_fused2_matches_pallas_fused2_interpret(rng):
    """B4's plain version against the TPU kernel it replaces, run in
    interpret mode (f32: there the TPU kernel's feature-dtype rounding of A,
    B and stage 1 is exact)."""
    feats = rng.normal(size=(2, 10, 12, 8)).astype(np.float32)
    rois = _rois(rng, 2, 6, 150)
    want = np.asarray(j_fused2(jnp.asarray(feats), jnp.asarray(rois), 4, 4, 1 / 16.0, 8,
                               roi_tile=4, chan_tile=8, interpret=True))
    got = roi_align_fused2(torch.from_numpy(feats), torch.from_numpy(rois), 4).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-5)


@pytest.mark.parametrize("r", [5, 23])  # under and over one tile of 16 RoIs
def test_fused2_matches_jax_separable(rng, r):
    feats = rng.normal(size=(2, 18, 24, 32)).astype(np.float32)
    rois = _rois(rng, 2, r, 350)
    want = _separable(feats, rois, 14)
    got = roi_align_fused2(torch.from_numpy(feats), torch.from_numpy(rois), 14).numpy()
    assert got.shape == (2, r, 14, 14, 32)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-5)


def test_fused2_keeps_the_feature_dtype(rng):
    feats = torch.from_numpy(rng.normal(size=(1, 6, 7, 4)).astype(np.float32))
    rois = torch.from_numpy(_rois(rng, 1, 4, 90))
    got = roi_align_fused2(feats.to(torch.bfloat16), rois, 3)
    assert got.dtype == torch.bfloat16
    want = roi_align_fused2(feats.to(torch.bfloat16).float(), rois, 3)
    # one rounding of the fp32 result: within half a bf16 ulp
    assert torch.all((got.float() - want).abs() <= want.abs() * 2.0 ** -8 + 1e-30)
