"""Port's RoIAlign (plain versions of kernels B3 and B4) vs the JAX
package's ``roi_align``, and the Pallas ``roi_align_batched`` /
``roi_align_fused2`` in interpret mode. Boxes include zero-area boxes, boxes past the image edge
and a box wider than 8 * P feature cells, which hits the 8-sample clamp.

Tolerance: fp32 sums in another order, atol 5e-5 / rtol 1e-5 (the JAX
package's own interpret-mode tolerance for these kernels).

The argument check both CUDA wrappers run (``check_kernel_args``) is tested
here too, on CPU tensors: it raises on what the kernels do not take."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.ops.roi_align import roi_align as j_roi_align
from online_detection_tpu.ops.roi_align import roi_align_batched as j_batched
from online_detection_tpu.ops.roi_align import roi_align_fused2 as j_fused2
from online_detection_tpu_torch.ops.roi_align import (
    MAX_DIM,
    MAX_POOLED,
    MAX_SAMPLES,
    check_kernel_args,
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


def _check_inputs(b=2, h=38, w=50, c=1024, r=5, dtype=torch.bfloat16):
    return torch.zeros((b, h, w, c), dtype=dtype), torch.zeros((b, r, 4))


def test_kernel_args_accept_the_main_path_shapes():
    """The shapes the inference and harvest paths give kernels B3 and B4, in
    both dtypes, a 1333-pixel-wide map (W = 84) and pooled 32."""
    for dtype in (torch.bfloat16, torch.float32):
        check_kernel_args(*_check_inputs(dtype=dtype), 14)
        check_kernel_args(*_check_inputs(h=50, w=84, dtype=dtype), 14)
        check_kernel_args(*_check_inputs(c=8, dtype=dtype), 32)
    check_kernel_args(*_check_inputs(c=4, dtype=torch.float32), 7)


@pytest.mark.parametrize("case", [
    "c_not_vector_bf16", "c_not_vector_f32", "c_below_vector", "w_too_wide", "h_too_tall",
    "pooled_33", "pooled_0", "rois_batch", "rois_width", "rois_rank", "features_rank",
    "misaligned",
])
def test_kernel_args_refuse_what_the_kernels_do_not_take(case):
    """One check for both CUDA wrappers: C a whole number of 16-byte vectors
    (8 bf16 or 4 fp32 channels), H and W <= 128, 1 <= pooled <= 32, rois
    [B, R, 4] of the features' batch, 16-byte aligned contiguous features."""
    feats, rois, pooled = *_check_inputs(), 14
    if case == "c_not_vector_bf16":
        feats = feats[..., :1020].contiguous()
    elif case == "c_not_vector_f32":
        feats = torch.zeros((2, 38, 50, 6))
    elif case == "c_below_vector":
        feats = feats[..., :4].contiguous()
    elif case == "w_too_wide":
        feats = torch.zeros((2, 38, MAX_DIM + 1, 8), dtype=torch.bfloat16)
    elif case == "h_too_tall":
        feats = torch.zeros((2, MAX_DIM + 1, 50, 8), dtype=torch.bfloat16)
    elif case == "pooled_33":
        pooled = MAX_POOLED + 1
    elif case == "pooled_0":
        pooled = 0
    elif case == "rois_batch":
        rois = torch.zeros((3, 5, 4))
    elif case == "rois_width":
        rois = torch.zeros((2, 5, 5))
    elif case == "rois_rank":
        rois = torch.zeros((10, 4))
    elif case == "features_rank":
        feats = feats[0]
    elif case == "misaligned":  # a contiguous view that starts 2 bytes into its storage
        flat = torch.zeros(2 * 38 * 50 * 1024 + 1, dtype=torch.bfloat16)
        feats = flat[1:].view(2, 38, 50, 1024)
        assert feats.is_contiguous() and feats.data_ptr() % 16
    with pytest.raises(ValueError):
        check_kernel_args(feats, rois, pooled)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_kernel_args_refuse_other_dtypes(dtype):
    feats, rois = _check_inputs(c=16, dtype=dtype)
    with pytest.raises(TypeError):
        check_kernel_args(feats, rois, 14)


def test_kernel_limits_match_the_cuda_header():
    """The Python limits mirror roi::MAX_POOLED and roi::MAX_DIM, which size
    the kernels' shared-memory tables."""
    from pathlib import Path

    import online_detection_tpu_torch

    header = (Path(online_detection_tpu_torch.__file__).parent / "csrc"
              / "roi_align_common.cuh").read_text()
    assert f"constexpr int MAX_POOLED = {MAX_POOLED};" in header
    assert f"constexpr int MAX_DIM = {MAX_DIM};" in header
    assert f"constexpr int MAX_SAMPLES = {MAX_SAMPLES};" in header
