"""Port's device reservoirs (``engine/device_accumulate.py``) vs the JAX
package's, on the CPU: the batch fold gives the same pools, counts and drop
accounting (saturation included); the splits give the same batches, with
the JAX package's uniforms fed to ``shuffle_split``; the feature statistics
agree with its draws fed in. Rows are copies, so they must be equal;
statistics within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.engine import device_accumulate as jd
from online_detection_tpu.engine import harvest as jh
from online_detection_tpu_torch.engine import device_accumulate as d
from online_detection_tpu_torch.engine import harvest as h

torch.set_num_threads(2)

B, A, C, G, NPICK, PPOS, CCAP, PIX = 2, 3, 4, 3, 5, 4, 6, 7
DIMS = dict(rpn_dim=6, det_dim=8, mask_dim=5)
SPEC = dict(num_anchor_classes=A, num_classes=C, neg_cap=12, rpn_pos_cap=9, det_pos_cap=4,
            coxy_cap=10, mask_cap=20, mask_pos_cap=15,
            chunk_sizes={"npick": NPICK, "rpn_pos": PPOS, "gt_cap": G, "coxy": CCAP,
                         "mask_pix": PIX}, batch_size=B, **DIMS)


def _valid_first(rng, shape):
    n = shape[-1]
    return np.arange(n) < rng.integers(0, n + 1, size=shape[:-1] + (1,))


def _chunk(rng):
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    rpn = (f(B, A, NPICK, 6), _valid_first(rng, (B, A, NPICK)), f(B, A, PPOS, 6),
           _valid_first(rng, (B, A, PPOS)), f(B, A, PPOS, 4),
           rng.integers(0, 3, size=(B, A)).astype(np.int32))
    det = (f(B, G, 8), rng.integers(1, C + 1, size=(B, G)).astype(np.int32),
           rng.uniform(size=(B, G)) < 0.7, f(B, C, NPICK, 8), _valid_first(rng, (B, C, NPICK)),
           f(B, CCAP, 8), f(B, CCAP, 4), rng.integers(1, C + 1, size=(B, CCAP)).astype(np.float32),
           _valid_first(rng, (B, CCAP)), rng.integers(0, 2, size=(B,)).astype(np.int32))
    mask = (f(B, G, PIX, 5), _valid_first(rng, (B, G, PIX)), f(B, G, PIX, 5),
            _valid_first(rng, (B, G, PIX)), rng.integers(1, C + 1, size=(B, G)).astype(np.int32),
            rng.uniform(size=(B, G)) < 0.8, rng.integers(0, 3, size=(B,)).astype(np.int32))
    ar = rng.uniform(size=(B,)).astype(np.float32)

    def build(mod, conv):
        return mod.HarvestChunk(mod.RPNChunk(*map(conv, rpn)), mod.DetChunk(*map(conv, det)),
                                mod.MaskChunk(*map(conv, mask)), conv(ar))

    return build(h, torch.from_numpy), build(jh, jnp.asarray)


_POOLS = ("rpn_neg", "rpn_pos", "rpn_coxy_y", "det_neg", "det_pos", "det_coxy", "mask_pos",
          "mask_neg")


def test_accumulate_batch_matches_jax(rng):
    state = d.init_reservoirs(**SPEC)
    jstate = jd.init_reservoirs(**SPEC)
    for step in range(4):  # enough batches to saturate the small pools
        chunk, jchunk = _chunk(rng)
        img_valid = np.array([True, step != 2])  # a padded tail image once
        state = d.accumulate_batch(state, chunk, torch.from_numpy(img_valid), C)
        jstate = jd.accumulate_batch(jstate, jchunk, jnp.asarray(img_valid), C)
    for k in _POOLS:
        got, want = getattr(state, k), getattr(jstate, k)
        np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts), err_msg=k)
        np.testing.assert_array_equal(got.attempted.numpy(), np.asarray(want.attempted),
                                      err_msg=k)
        valid = got.valid_mask().numpy()
        np.testing.assert_array_equal(got.rows.numpy()[valid], np.asarray(want.rows)[valid],
                                      err_msg=k)
    assert sum(getattr(state, k).dropped() for k in _POOLS) > 0  # saturated
    assert int(state.n_images) == int(jstate.n_images) == 7
    assert int(state.harvest_dropped) == int(jstate.harvest_dropped)
    np.testing.assert_allclose(float(state.ar_sum), float(jstate.ar_sum), rtol=1e-6)


def _pool(rng, c=3, cap=11, dim=2):
    rows = rng.normal(size=(c, cap, dim)).astype(np.float32)
    counts = np.array([cap - 3, 0, 5][:c])
    return (d.Pool(torch.from_numpy(rows), torch.from_numpy(counts)),
            jd.Pool(jnp.asarray(rows), jnp.asarray(counts.astype(np.int32))))


@pytest.mark.parametrize("split", ["interleave_split", "arrival_split"])
def test_deterministic_splits_match_jax(rng, split):
    pool, jpool = _pool(rng)
    got = getattr(d, split)(pool, 3, 4)
    want = getattr(jd, split)(jpool, 3, 4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_shuffle_split_with_jax_uniforms(rng):
    pool, jpool = _pool(rng)
    key = jax.random.key(5)
    keys = jax.random.split(key, 3)
    u = np.stack([np.asarray(jax.random.uniform(k, (11,))) for k in keys])
    got = d.shuffle_split(pool, 2, 5, uniforms=u)
    want = jd.shuffle_split(key, jpool, 2, 5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_feature_stats_pool_with_jax_draws(rng):
    pos, jpos = _pool(rng, c=3, cap=40, dim=6)
    neg, jneg = _pool(rng, c=3, cap=40, dim=6)
    key = jax.random.key(2)
    num, frac = 60, 0.8
    take_pos, take_neg = int(np.ceil(num / 3 * frac)), int(np.ceil(num / 3 * (1 - frac)))
    kp, kn = jax.random.split(key)

    def draws(k, counts, take):
        return np.stack([np.asarray(jax.random.randint(kk, (take,), 0, max(int(n), 1)))
                         for kk, n in zip(jax.random.split(k, 3), counts)])

    got = d.device_feature_stats_pool(pos, neg, num, frac, draws=(
        draws(kp, pos.counts, take_pos), draws(kn, neg.counts, take_neg)))
    want = jd.device_feature_stats_pool(key, jpos, jneg, num, frac)
    for g, w in zip((got.mean, got.std, got.mean_norm), (want.mean, want.std, want.mean_norm)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
