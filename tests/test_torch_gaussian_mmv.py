"""Port's Gaussian mmv (plain version of kernel B1) vs the JAX package:
``mmv_xla``, the Pallas ``mmv_pallas`` in interpret mode, the class-batched
FALKON predict, and the own-class mask scores; and the kernel's 3xTF32
arithmetic, emulated on the CPU, against ``mmv_xla`` and float64.

Tolerance: the same fp32 function summed in another order, so each output
may differ by 1e-5 of the sum of its terms' magnitudes, ``K @ |v|``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.ops.gaussian_mmv import mmv_pallas, mmv_xla
from online_detection_tpu.solvers.falkon import FalkonModel as JFalkon
from online_detection_tpu.solvers.falkon import falkon_predict_classes as j_predict_classes
from online_detection_tpu_torch.ops.gaussian_mmv import (
    gaussian_kernel,
    mmv,
    mmv_grouped,
    mmv_reference,
    split_tf32,
    split_tf32_reference,
)
from online_detection_tpu_torch.solvers.falkon import FalkonModel, falkon_predict_classes

torch.set_num_threads(2)


def _mmv_columns(x, c, v, sigma):
    """The port's single-set ``mmv`` (v [M]) on each column of a v [M] or [M, t]."""
    x, c = torch.from_numpy(x), torch.from_numpy(c)
    if v.ndim == 1:
        return mmv(x, c, torch.from_numpy(v), sigma).numpy()
    return np.stack([mmv(x, c, torch.from_numpy(np.ascontiguousarray(v[:, k])), sigma).numpy()
                     for k in range(v.shape[1])], axis=-1)


def _bound(x, c, v, sigma):
    """1e-5 of sum |terms| per output, in float64."""
    x, c = x.astype(np.float64), c.astype(np.float64)
    sq = (x * x).sum(1)[:, None] + (c * c).sum(1)[None] - 2 * x @ c.T
    k = np.exp(-np.maximum(sq, 0) / (2 * sigma * sigma))
    return 1e-5 * (k @ np.abs(v).reshape(len(c), -1)) + 1e-30


def _data(rng, n, m, d, t=None, s=None):
    x = rng.normal(size=(n, d)).astype(np.float32)
    shape_c = (m, d) if s is None else (s, m, d)
    c = rng.normal(size=shape_c).astype(np.float32)
    shape_v = (m,) if t is None else (m, t)
    if s is not None:
        shape_v = (s,) + shape_v
    v = rng.normal(size=shape_v).astype(np.float32)
    return x, c, v


@pytest.mark.parametrize("n,m,d,t,sigma", [(37, 50, 24, None, 4.0), (130, 70, 40, 3, 5.0)])
def test_mmv_matches_mmv_xla(rng, n, m, d, t, sigma):
    x, c, v = _data(rng, n, m, d, t)
    want = np.asarray(mmv_xla(jnp.asarray(x), jnp.asarray(c), jnp.asarray(v), sigma))
    got = _mmv_columns(x, c, v, sigma)
    assert got.shape == want.shape
    bound = _bound(x, c, v, sigma).reshape(want.shape)
    assert (np.abs(got - want) <= bound).all()


def test_mmv_matches_mmv_pallas_interpret(rng):
    x, c, v = _data(rng, 150, 140, 48, 2)
    sigma = 5.0
    want = np.asarray(mmv_pallas(jnp.asarray(x), jnp.asarray(c), jnp.asarray(v), sigma,
                                 tile_n=128, tile_m=128, interpret=True, bf16_dot=False))
    got = _mmv_columns(x, c, v, sigma)
    assert (np.abs(got - want) <= _bound(x, c, v, sigma)).all()


def test_gaussian_kernel_matches_dense_numpy(rng):
    x, c, _ = _data(rng, 9, 11, 6)
    sq = ((x[:, None, :].astype(np.float64) - c[None]) ** 2).sum(-1)
    want = np.exp(-sq / (2 * 3.0 ** 2))
    got = gaussian_kernel(torch.from_numpy(x), torch.from_numpy(c), 3.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_grouped_mmv_shared_and_per_group_x(rng):
    """Shared x (one group per center set) and per-group x with an index
    gather of center sets (the mask head's form) both equal per-group
    ``mmv_xla``."""
    s, m, d, sigma = 4, 33, 20, 4.0
    x, c, v = _data(rng, 45, m, d, s=s)
    got = mmv_grouped(torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(v),
                      sigma).numpy()
    assert got.shape == (s, 45)
    for g in range(s):
        want = np.asarray(mmv_xla(jnp.asarray(x), jnp.asarray(c[g]), jnp.asarray(v[g]), sigma))
        assert (np.abs(got[g] - want) <= _bound(x, c[g], v[g], sigma)[:, 0]).all()

    set_idx = np.array([3, 0, 0, 2, 1, 3], np.int32)
    xg = rng.normal(size=(len(set_idx), 17, d)).astype(np.float32)
    got = mmv_grouped(torch.from_numpy(xg), torch.from_numpy(c), torch.from_numpy(v), sigma,
                      set_idx=torch.from_numpy(set_idx)).numpy()
    ref = mmv_reference(torch.from_numpy(xg), torch.from_numpy(c), torch.from_numpy(v), sigma,
                        torch.from_numpy(set_idx)).numpy()
    np.testing.assert_array_equal(got, ref)
    for g, si in enumerate(set_idx):
        want = np.asarray(mmv_xla(jnp.asarray(xg[g]), jnp.asarray(c[si]),
                                  jnp.asarray(v[si]), sigma))
        assert (np.abs(got[g] - want) <= _bound(xg[g], c[si], v[si], sigma)[:, 0]).all()


def test_grouped_mmv_rejects_mismatched_groups():
    with pytest.raises(ValueError):
        mmv_grouped(torch.ones(3, 5, 4), torch.ones(2, 6, 4), torch.ones(2, 6), 1.0)


def test_falkon_predict_classes_matches_jax(rng):
    c_, m, d, sigma = 5, 40, 32, 6.0
    centers = rng.normal(size=(c_, m, d)).astype(np.float32)
    alpha = rng.normal(size=(c_, m)).astype(np.float32)
    exists = np.array([True, False, True, True, False])
    x = rng.normal(size=(60, d)).astype(np.float32)
    want = np.asarray(j_predict_classes(
        JFalkon(jnp.asarray(centers), jnp.asarray(alpha), jnp.asarray(exists), sigma),
        jnp.asarray(x), missing_score=-2.0))
    got = falkon_predict_classes(
        FalkonModel(torch.from_numpy(centers), torch.from_numpy(alpha),
                    torch.from_numpy(exists), sigma),
        torch.from_numpy(x)).numpy()
    assert got.shape == (60, c_)
    assert (got[:, ~exists] == -2.0).all()
    for k in np.nonzero(exists)[0]:
        assert (np.abs(got[:, k] - want[:, k]) <= _bound(x, centers[k], alpha[k], sigma)[:, 0]).all()


def test_mask_predict_labels_matches_jax(rng):
    """Own-class mask scores, with background labels and a missing class."""
    from online_detection_tpu.models.heads import OnlineMaskModels as JMask
    from online_detection_tpu.models.heads import mask_predict_labels as j_labels
    from online_detection_tpu.utils.stats import FeatureStats as JStats
    from online_detection_tpu_torch.models.heads import OnlineMaskModels, mask_predict_labels
    from online_detection_tpu_torch.utils.stats import FeatureStats

    c_, m, ch = 4, 12, 256
    centers = rng.normal(size=(c_, m, ch)).astype(np.float32)
    alpha = rng.normal(size=(c_, m)).astype(np.float32)
    exists = np.array([True, True, False, True])
    mean = (rng.normal(size=ch) * 0.1).astype(np.float32)
    feats = np.abs(rng.normal(size=(7, 14, 14, ch))).astype(np.float32)
    labels = np.array([0, 1, 2, 3, 4, 1, 3], np.int32)
    jm = JMask(JFalkon(jnp.asarray(centers), jnp.asarray(alpha), jnp.asarray(exists), 10.0),
               JStats(jnp.asarray(mean), jnp.ones(ch), jnp.asarray(20.0)))
    want = np.asarray(j_labels(jm, jnp.asarray(feats), jnp.asarray(labels)))
    pm = OnlineMaskModels(
        FalkonModel(torch.from_numpy(centers), torch.from_numpy(alpha),
                    torch.from_numpy(exists), 10.0),
        FeatureStats(torch.from_numpy(mean), torch.ones(ch), torch.tensor(20.0)))
    got = mask_predict_labels(pm, torch.from_numpy(feats), torch.from_numpy(labels)).numpy()
    assert got.shape == (7, 14, 14)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# --- the kernel's arithmetic: 3xTF32 --------------------------------------

# (d, sigma) of the three roles: RPN, detector, mask / segmenter
_ROLES = [(1024, 50.0), (2048, 15.0), (256, 10.0)]


def _tf32(a):
    """TF32 rounding to nearest, ties away from zero (``cvt.rna.tf32.f32``),
    on the int32 view: add half of the 13 dropped bits, then clear them."""
    bits = np.ascontiguousarray(a, np.float32).view(np.int32)
    return ((bits + 0x1000) & np.int32(-0x2000)).view(np.float32)


def _near_centers(rng, d, sigma, n=96, m=64):
    """Centers at the scale of z-scored features (norm ~20) and rows drawn
    next to them, as in minibootstrap mining: the cross term cancels most."""
    c = (rng.normal(size=(m, d)) * 20 / np.sqrt(d)).astype(np.float32)
    x = c[rng.integers(0, m, n)] + rng.normal(size=(n, d)) * 0.5 * sigma / np.sqrt(d)
    v = rng.normal(size=m).astype(np.float32)
    return x.astype(np.float32), c, v


def _tf32_mmv(x, c, v, sigma, passes):
    """The mmv with its cross term as a sum of fp32 products of tf32 values:
    3 passes (x_lo c_hi + x_hi c_lo + x_hi c_hi, as the kernel) or 1."""
    xh, ch = _tf32(x), _tf32(c)
    xl, cl = _tf32(x - xh), _tf32(c - ch)
    pairs = [(xl, ch), (xh, cl), (xh, ch)] if passes == 3 else [(xh, ch)]
    cross = torch.zeros(len(x), len(c))
    for a, b in pairs:
        cross += torch.from_numpy(a) @ torch.from_numpy(b).T
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    sq = (xt * xt).sum(1)[:, None] + (ct * ct).sum(1)[None] - 2 * cross
    k = torch.exp(-sq.clamp(min=0) / (2 * sigma * sigma))
    return (k @ torch.from_numpy(v)).numpy()


def test_split_tf32_reference_gives_tf32_halves(rng):
    x = (rng.normal(size=4096) * 10.0 ** rng.uniform(-15, 15, 4096)).astype(np.float32)
    ties = np.array([1, -1, 2.0 ** -12], np.float32) * np.float32(1 + 2.0 ** -11)
    x = np.concatenate([x, ties])
    hi, lo, sq = (t.numpy() for t in split_tf32_reference(torch.from_numpy(x[:, None])))
    hi, lo = hi[:, 0], lo[:, 0]
    np.testing.assert_array_equal(sq, x * x)
    assert (hi.view(np.int32) & 0x1FFF == 0).all() and (lo.view(np.int32) & 0x1FFF == 0).all()
    np.testing.assert_array_equal(hi, _tf32(x))
    np.testing.assert_array_equal(lo, _tf32(x - hi))
    # ties round away from zero
    np.testing.assert_array_equal(hi[-3:], np.array([1, -1, 2.0 ** -12], np.float32)
                                  * np.float32(1 + 2.0 ** -10))
    err = np.abs(hi.astype(np.float64) + lo - x)
    assert (err <= 2.0 ** -22 * np.abs(x)).all()
    rows = torch.from_numpy(x[:4096].reshape(64, 64))
    cpu_hi, cpu_lo, cpu_sq = split_tf32(rows)  # a CPU tensor takes the plain version
    np.testing.assert_array_equal(cpu_hi.numpy().ravel(), hi[:4096])
    np.testing.assert_array_equal(cpu_lo.numpy().ravel(), lo[:4096])
    np.testing.assert_array_equal(cpu_sq.numpy(), (rows * rows).sum(1).numpy())


@pytest.mark.parametrize("d,sigma", _ROLES)
def test_three_pass_tf32_mmv_matches_mmv_xla(rng, d, sigma):
    x, c, v = _near_centers(rng, d, sigma)
    want = np.asarray(mmv_xla(jnp.asarray(x), jnp.asarray(c), jnp.asarray(v), sigma))
    got = _tf32_mmv(x, c, v, sigma, passes=3)
    assert (np.abs(got - want) <= _bound(x, c, v, sigma)[:, 0]).all()


@pytest.mark.parametrize("d,sigma", _ROLES)
def test_one_pass_tf32_mmv_is_far_less_accurate(rng, d, sigma):
    """Control for the test above: on the same data a single TF32 pass is at
    least 10x further from ``mmv_xla``, and at the mask role's width (the
    smallest sigma against the features' norm) it breaks the bound."""
    x, c, v = _near_centers(rng, d, sigma)
    want = np.asarray(mmv_xla(jnp.asarray(x), jnp.asarray(c), jnp.asarray(v), sigma))
    bound = _bound(x, c, v, sigma)[:, 0]
    err3 = np.abs(_tf32_mmv(x, c, v, sigma, passes=3) - want) / bound
    err1 = np.abs(_tf32_mmv(x, c, v, sigma, passes=1) - want) / bound
    assert err1.max() >= 10 * err3.max()
    if d == 256:
        assert (err1 > 1).any()


# --- the kernel's sums: two-level accumulation --------------------------

# the norms of the flagship training's detector mining rows and of their
# centers (median, 99th percentile, maximum), as chip_smoke.MINING_ROW_NORMS
_MINING_NORMS = {"rows": (2.875, 16.80, 18.00), "centers": (8.053, 16.57, 18.00)}


def _mining_rows(rng, cosine, n=64, m=48, d=2048):
    """Rows and centers with the mining rows' norms (log-normal with their
    median and 99th percentile, cut at the maximum, which the first row and
    the first center take), each at ``cosine`` to one common direction, as
    a class's rows are; v >= 0. chip_smoke.mining_rows at a small size."""
    e = rng.normal(size=d)
    e /= np.linalg.norm(e)

    def draw(k, median, p99, top):
        spread = np.log(p99 / median) / 2.3263
        r = np.minimum(np.exp(np.log(median) + spread * rng.normal(size=k)), top)
        r[0] = top
        u = rng.normal(size=(k, d))
        u -= (u @ e)[:, None] * e
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        return ((cosine * e + np.sqrt(1 - cosine ** 2) * u) * r[:, None]).astype(np.float32)

    c = draw(m, *_MINING_NORMS["centers"])
    x = draw(n, *_MINING_NORMS["rows"])
    return x, c, np.abs(rng.normal(size=m)).astype(np.float32)


def _round_toward_zero(a):
    """float64 -> float32, rounded toward zero."""
    f = a.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(a)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _tensor_core_cross(x, c, stage_cols=None):
    """x.c as the kernel forms it on a model of the tensor cores: per k-step
    of 8 columns, 3 wgmma (x_lo c_hi, x_hi c_lo, x_hi c_hi), each adding its
    8 exact products into an fp32 accumulator rounded toward zero. With
    ``stage_cols`` (two-level), each stage of that many columns starts from
    zero and its partial is added into an IEEE fp32 sum; without, one
    accumulator runs over all of d (the kernel before the fault C5 repair)."""
    xh, ch = _tf32(x), _tf32(c)
    xl, cl = _tf32(x - xh), _tf32(c - ch)
    acc = np.zeros((len(x), len(c)), np.float32)
    total = np.zeros_like(acc)
    for k0 in range(0, x.shape[1], 8):
        cols = slice(k0, k0 + 8)
        fresh = stage_cols is not None and k0 % stage_cols == 0
        for i, (a, b) in enumerate(((xl, ch), (xh, cl), (xh, ch))):
            products = a[:, cols].astype(np.float64) @ b[:, cols].astype(np.float64).T
            acc = _round_toward_zero(products + (0.0 if fresh and i == 0 else acc))
        if stage_cols is not None and (k0 + 8) % stage_cols == 0:
            total = total + acc
    return acc if stage_cols is None else total


def _mmv_of_cross(x, c, v, sigma, cross):
    xn, cn = (x * x).sum(1, dtype=np.float32), (c * c).sum(1, dtype=np.float32)
    sq = xn[:, None] + cn[None] - np.float32(2) * cross
    return np.exp(-np.maximum(sq, 0) / np.float32(2 * sigma * sigma)) @ v


def _rel_to_terms(got, x, c, v, sigma):
    """max |got - float64| / sum |terms| (float64)."""
    x64, c64 = x.astype(np.float64), c.astype(np.float64)
    sq = (x64 * x64).sum(1)[:, None] + (c64 * c64).sum(1)[None] - 2 * x64 @ c64.T
    k = np.exp(-np.maximum(sq, 0) / (2 * sigma * sigma))
    return np.max(np.abs(got - k @ v) / (k @ np.abs(v)))


@pytest.mark.parametrize("cosine", [0.0, 0.95])
def test_mmv_matches_mmv_xla_at_mining_norms(rng, cosine):
    """The plain version agrees with ``mmv_xla`` within the stated bound on
    rows with the norms of the flagship training's detector mining rows (d
    2048, sigma 15), with and without a common direction."""
    x, c, v = _mining_rows(rng, cosine)
    want = np.asarray(mmv_xla(jnp.asarray(x), jnp.asarray(c), jnp.asarray(v), 15.0))
    got = mmv(torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(v), 15.0).numpy()
    assert (np.abs(got - want) <= _bound(x, c, v, 15.0)[:, 0]).all()


@pytest.mark.parametrize("stage_cols,within", [(None, False), (32, True)],
                         ids=["one_accumulator", "two_level"])
def test_tensor_core_sums_on_mining_rows(rng, stage_cols, within):
    """Fault C5 on a model of the tensor cores' fp32 sums. The cause lies in
    the card's accumulation, which no CPU computes; this emulates it as each
    wgmma's sum rounded toward zero, a model that gives the size of the
    error the card showed (6e-3 in x.c on the training's mining rows,
    tools/b1_variants.py; chip_smoke.py holds the kernel itself). On rows at
    the mining rows' largest norm along one direction, the kernel's old
    order (one accumulator over all 2048 columns) falls outside 1e-5 of the
    sum of the terms' magnitudes, and its two-level order (a stage's 32
    columns from zero, the partials summed in IEEE fp32) within 1e-6."""
    x, c, v = _mining_rows(rng, 1.0)
    err = _rel_to_terms(_mmv_of_cross(x, c, v, 15.0, _tensor_core_cross(x, c, stage_cols)),
                        x, c, v, 15.0)
    assert (err <= 1e-6) if within else (err > 1e-5)


@pytest.mark.parametrize("d,sigma", _ROLES)
def test_two_level_ieee_sums_match_mmv_xla(rng, d, sigma):
    """The kernel's order with IEEE sums in place of the tensor cores' (each
    stage's three tf32 products from zero, the partials summed in fp32) is
    as close to ``mmv_xla`` as the stated bound, on rows next to their
    centers at each role's width."""
    x, c, v = _near_centers(rng, d, sigma)
    xh, ch = _tf32(x), _tf32(c)
    xl, cl = _tf32(x - xh), _tf32(c - ch)
    cross = np.zeros((len(x), len(c)), np.float32)
    for k0 in range(0, d, 32):
        cols = slice(k0, k0 + 32)
        cross += sum(a[:, cols] @ b[:, cols].T for a, b in ((xl, ch), (xh, cl), (xh, ch)))
    want = np.asarray(mmv_xla(jnp.asarray(x), jnp.asarray(c), jnp.asarray(v), sigma))
    got = _mmv_of_cross(x, c, v, sigma, cross)
    assert (np.abs(got - want) <= _bound(x, c, v, sigma)[:, 0]).all()
