"""Port's solver fit side (``solvers/falkon.py``, ``minibootstrap.py``,
``rls.py``) vs the JAX package's, on the CPU.

FALKON is compared by scores on held-out rows, never by ``alpha`` (a
Cholesky-conditioned solution whose summation order differs): within 1e-4
of the scores' scale with the same centers, 1e-3 against the dense
``direct_nystrom_solve``. Nystrom centers with the JAX package's draws fed
in: identical indices. Minibootstrap: identical cache membership at every
iteration with a stub classifier, and 1e-3 on scores when both train
FALKON on pools under their quotas (no draws). RLS: predictions within
1e-3 at lambda 1000, 2e-2 at lambda 0.01 on an underdetermined class (the
JAX package's own tolerance for that regime)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.solvers import falkon as jf
from online_detection_tpu.solvers import minibootstrap as jmb
from online_detection_tpu.solvers import rls as jr
from online_detection_tpu_torch.solvers import falkon as f
from online_detection_tpu_torch.solvers import minibootstrap as mb
from online_detection_tpu_torch.solvers import rls as r

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _blobs(rng, n, d, shift=1.5):
    y = np.where(rng.uniform(size=n) < 0.4, 1.0, -1.0).astype(np.float32)
    x = (rng.normal(size=(n, d)) + shift * y[:, None] * np.eye(d)[0]).astype(np.float32)
    return x, y


@pytest.mark.parametrize("lam", [1e-3, 1e-6])
def test_falkon_fit_scores_match_jax(rng, lam):
    c, n, d, m, sigma = 2, 120, 6, 24, 3.0
    xs, ys, ws, cs = [], [], [], []
    for _ in range(c):
        x, y = _blobs(rng, n, d)
        xs.append(x)
        ys.append(y)
        ws.append((rng.uniform(size=n) < 0.85).astype(np.float32))
        cs.append(x[rng.choice(n, m, replace=True)])  # duplicates: K_MM has a null space
    x, y, w, cen = map(np.stack, (xs, ys, ws, cs))
    alpha = f.falkon_fit(_t(x), _t(y), _t(w), _t(cen), sigma, lam)
    probe = rng.normal(size=(40, d)).astype(np.float32)
    for i in range(c):
        want_alpha = jf.falkon_fit(jnp.asarray(x[i]), jnp.asarray(y[i]), jnp.asarray(w[i]),
                                   jnp.asarray(cen[i]), sigma, lam)
        want = np.asarray(jf.mmv(jnp.asarray(probe), jnp.asarray(cen[i]), want_alpha, sigma))
        got = f.mmv(_t(probe), _t(cen[i]), alpha[i], sigma).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max() + 1e-5)


def test_falkon_fit_agrees_with_direct_solve(rng):
    n, d, m, sigma, lam = 150, 5, 20, 2.5, 1e-3
    x, y = _blobs(rng, n, d)
    w = np.ones(n, np.float32)
    cen = x[:m].copy()
    alpha = f.falkon_fit(_t(x)[None], _t(y)[None], _t(w)[None], _t(cen)[None], sigma, lam)[0]
    direct = f.direct_nystrom_solve(_t(x), _t(y), _t(w), _t(cen), sigma, lam)
    jdirect = jf.direct_nystrom_solve(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                                      jnp.asarray(cen), sigma, lam)
    probe = _t(rng.normal(size=(30, d)).astype(np.float32))
    s_fit, s_dir = (f.mmv(probe, _t(cen), a, sigma).numpy() for a in (alpha, direct))
    s_jax = np.asarray(jf.mmv(jnp.asarray(probe.numpy()), jnp.asarray(cen), jdirect, sigma))
    np.testing.assert_allclose(s_fit, s_dir, atol=1e-3)
    np.testing.assert_allclose(s_dir, s_jax, atol=1e-3)


@pytest.mark.parametrize("n_pos,n_neg", [(3, 5), (30, 4), (3, 40), (0, 0)])
def test_select_nystrom_centers_with_jax_draws(rng, n_pos, n_neg):
    n, m = 60, 16
    is_pos = np.zeros(n, bool)
    is_pos[rng.choice(n, n_pos, replace=False)] = True
    valid = is_pos.copy()
    valid[rng.choice(np.flatnonzero(~is_pos), n_neg, replace=False)] = True
    key = jax.random.key(3)
    kp, kn = jax.random.split(key)
    dp = np.array(jax.random.randint(kp, (m,), 0, max(n_pos, 1)))
    dn = np.array(jax.random.randint(kn, (m,), 0, max(n_neg, 1)))
    want = jf.select_nystrom_centers(key, jnp.asarray(is_pos), jnp.asarray(valid), m)
    got = f.select_nystrom_centers(_t(is_pos), _t(valid)[None], m, draws=(dp[None], dn[None]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


# ---- minibootstrap

COUPLING = 0.002


def _stub_fit_j(key, cache_x, y, cache_is_pos, cache_valid, params):
    return jnp.sum(cache_valid.astype(jnp.float32))


def _stub_score_j(model, x, params):
    return x[:, 0] + COUPLING * model


def _stub_init_j(p_cap, d, params):
    return jnp.float32(0.0)


def _stub_fit_t(j, cache_x, y, cache_is_pos, cache_valid, params, generator):
    return cache_valid.float().sum(1)


def _stub_score_t(model, x, params):
    return x[..., 0] + COUPLING * model[:, None]


def _stub_init_t(c, p_cap, d, params, device):
    return torch.zeros(c)


def _pools(rng, c, p_cap, n_iter, b, d, pos_counts, neg_counts):
    pos = rng.normal(size=(c, p_cap, d)).astype(np.float32)
    pv = np.arange(p_cap)[None] < np.asarray(pos_counts)[:, None]
    neg = rng.normal(size=(c, n_iter, b, d)).astype(np.float32)
    neg[..., 0] = rng.uniform(-1.5, 0.5, size=(c, n_iter, b))  # the stub's score channel
    nv = np.arange(b)[None, None] < np.asarray(neg_counts)[..., None]
    return pos * pv[..., None], pv, neg * nv[..., None], nv


def test_minibootstrap_trace_matches_jax_with_stub(rng):
    c, p_cap, n_iter, b, d = 3, 6, 4, 8, 3
    pos, pv, neg, nv = _pools(rng, c, p_cap, n_iter, b, d, [4, 6, 0],
                              [[8, 5, 8, 3], [6, 8, 4, 8], [2, 0, 7, 8]])
    params = mb.MinibootstrapParams(hard_thresh=-0.7, easy_thresh=-0.9)
    _, jexists, (jcache, jneg) = jmb.minibootstrap_trace(
        jax.random.split(jax.random.key(0), c), jnp.asarray(pos), jnp.asarray(pv),
        jnp.asarray(neg), jnp.asarray(nv), jmb.MinibootstrapParams(**params._asdict()),
        fit_fn=_stub_fit_j, score_fn=_stub_score_j, init_fn=_stub_init_j)
    _, exists, (cache, negm) = mb.minibootstrap_trace(
        _t(pos), _t(pv), _t(neg), _t(nv), params, fit_fn=_stub_fit_t, score_fn=_stub_score_t,
        init_fn=_stub_init_t)
    np.testing.assert_array_equal(exists.numpy(), np.asarray(jexists))
    np.testing.assert_array_equal(cache.numpy(), np.asarray(jcache))
    np.testing.assert_array_equal(negm.numpy(), np.asarray(jneg))
    # mining and pruning both happened
    assert 0 < cache[:, -1, p_cap:].sum() < nv.sum()


def test_train_classifiers_minibootstrap_scores_match_jax(rng):
    """FALKON in the loop, pools under their quotas (M >= 2 * positives and
    M >= positives + negatives), so neither side draws; two class windows."""
    c, p_cap, n_iter, b, d = 3, 5, 2, 10, 4
    pos, pv, neg, nv = _pools(rng, c, p_cap, n_iter, b, d, [5, 3, 4],
                              [[10, 6], [9, 10], [4, 8]])
    pos[..., 0] += 2.0 * pv
    p = dict(m=32, sigma=2.0, lam=1e-3, hard_thresh=-0.7, easy_thresh=-0.9)
    want = jmb.train_classifiers_minibootstrap(
        jax.random.key(1), jnp.asarray(pos), jnp.asarray(pv), jnp.asarray(neg),
        jnp.asarray(nv), jmb.MinibootstrapParams(**p))
    got = mb.train_classifiers_minibootstrap(_t(pos), _t(pv), _t(neg), _t(nv),
                                             mb.MinibootstrapParams(**p), class_chunk=2)
    np.testing.assert_array_equal(got.exists.numpy(), np.asarray(want.exists))
    probe = rng.normal(size=(25, d)).astype(np.float32)
    s_want = np.asarray(jf.falkon_predict_classes(want, jnp.asarray(probe)))
    s_got = f.falkon_predict_classes(got, _t(probe)).numpy()
    np.testing.assert_allclose(s_got, s_want, atol=1e-3)


def _drawn_pools(rng, c, p_cap=10, n_iter=2, b=12, d=8):
    """Pools above the center quotas (10 positives > M/2, 24 negatives), so
    every update draws its Nystrom centers."""
    pos = rng.normal(size=(c, p_cap, d)).astype(np.float32) + 1.0
    neg = rng.normal(size=(c, n_iter, b, d)).astype(np.float32) - 1.0
    return pos, np.ones((c, p_cap), bool), neg, np.ones((c, n_iter, b), bool)


def test_class_chunk_does_not_change_drawn_models(rng):
    """Fault C4: each class's center draws are its own rows of one up-front
    block, so the chunk width changes no score (it moved them by 0.76 when
    each chunk drew from the shared generator in turn)."""
    pos, pv, neg, nv = (_t(a) for a in _drawn_pools(rng, 6))
    params = mb.MinibootstrapParams(m=8, sigma=3.0, lam=1e-2)
    probe = _t(rng.normal(size=(32, 8)).astype(np.float32))
    scores = {}
    for chunk in (None, 2, 3):
        model = mb.train_classifiers_minibootstrap(
            pos, pv, neg, nv, params, class_chunk=chunk,
            generator=torch.Generator().manual_seed(5))
        scores[chunk] = f.falkon_predict_classes(model, probe).numpy()
    for chunk in (2, 3):
        np.testing.assert_allclose(scores[chunk], scores[None], atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["shuffle", "interleave"])
def test_head_window_slide_does_not_change_drawn_models(rng, mode):
    """Fault C4 on the device route: 21 classes in windows of 8, whose last
    window slides back over classes 13-15, train the models of one window
    of 21 (the shuffle's uniforms and the centers' are drawn per class, up
    front)."""
    from online_detection_tpu_torch.engine import device_accumulate as dacc
    from online_detection_tpu_torch.pipelines.device_pipeline import _train_head_chunked

    c, n_iter, b, d = 21, 2, 12, 8
    pos, pv, neg, _ = _drawn_pools(rng, c, n_iter=n_iter, b=b, d=d)
    rows = np.concatenate([neg.reshape(c, -1, d), np.zeros((c, 5, d), np.float32)], 1)
    counts = rng.integers(n_iter * b - 6, n_iter * b + 1, size=c)
    pool = dacc.Pool(_t(rows), _t(counts))
    params = mb.MinibootstrapParams(m=8, sigma=3.0, lam=1e-2)
    probe = _t(rng.normal(size=(32, d)).astype(np.float32))
    scores = {}
    for chunk in (None, 8):
        model = _train_head_chunked(pool, _t(pos), _t(pv), params, None, n_iter, b, mode,
                                    chunk, torch.Generator().manual_seed(3))
        assert bool(model.exists.all())
        scores[chunk] = f.falkon_predict_classes(model, probe).numpy()
    np.testing.assert_allclose(scores[8], scores[None], atol=1e-5, rtol=0)


# ---- RLS


def _rls_data(rng, n, d, c, scale=1.0):
    x = (rng.normal(size=(n, d)) * scale).astype(np.float32)
    wtrue = rng.normal(size=(d, 4)) * 0.1
    y = (x @ wtrue + 0.05 * rng.normal(size=(n, 4))).astype(np.float32)
    cls1 = rng.integers(1, c + 1, n).astype(np.float32)
    return x, y, cls1


def _predict_both(model, jmodel, probe):
    return (r.rls_predict(model, _t(probe)).numpy(),
            np.asarray(jr.rls_predict(jmodel, jnp.asarray(probe))))


@pytest.mark.parametrize("device_solve", [True, False])
def test_rls_fit_grouped_lambda_1000(rng, device_solve):
    x, y, cls1 = _rls_data(rng, 300, 12, 3)
    w = (rng.uniform(size=300) < 0.9).astype(np.float32)
    cls1[cls1 == 3] = 1  # class 3 has no rows
    args = (x, y, cls1, w)
    model = r.rls_fit_grouped(*map(_t, args), 3, 1000.0, device_solve=device_solve)
    jmodel = jr.rls_fit_grouped(*map(jnp.asarray, args), 3, 1000.0, device_solve=device_solve)
    np.testing.assert_array_equal(model.exists.numpy(), np.asarray(jmodel.exists))
    got, want = _predict_both(model, jmodel, rng.normal(size=(16, 12)).astype(np.float32))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(model.mean_losses.numpy(), np.asarray(jmodel.mean_losses),
                               rtol=1e-3, atol=1e-5)


def test_rls_fit_grouped_underdetermined_lambda_001(rng):
    """n << d at lambda 0.01, the flagship RPN refiner's regime."""
    n, d, c = 5, 64, 3
    x = (rng.normal(size=(n, d)) * 3.0).astype(np.float32)
    y = rng.normal(size=(n, 4)).astype(np.float32)
    cls1 = np.asarray([1, 1, 2, 2, 2], np.float32)
    w = np.ones(n, np.float32)
    model = r.rls_fit_grouped(_t(x), _t(y), _t(cls1), _t(w), c, 0.01, device_solve=True)
    jmodel = jr.rls_fit_grouped(*map(jnp.asarray, (x, y, cls1, w)), c, 0.01, device_solve=True)
    assert torch.isfinite(model.beta).all()
    got, want = _predict_both(model, jmodel, rng.normal(size=(8, d)).astype(np.float32))
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_device_solve_escalates_on_an_indefinite_gram(rng):
    """A Gram pushed past PSD (one eigenvalue at -0.1): the plain factor
    fails on both sides and the jitter escalation picks the same level."""
    d, lam = 32, 0.01
    x = rng.normal(size=(6, d)).astype(np.float32)
    g_xx = x.T @ x
    evals, evecs = np.linalg.eigh(g_xx)
    g_xx = g_xx - (evals[0] + 0.1) * np.outer(evecs[:, 0], evecs[:, 0])
    g = np.zeros((1, d + 1, d + 1), np.float32)
    g[0, :d, :d] = g_xx
    g[0, :d, d] = g[0, d, :d] = x.sum(0)
    g[0, d, d] = 6.0
    y = rng.normal(size=(6, 4)).astype(np.float32)
    b = np.concatenate([x.T @ y, y.sum(0, keepdims=True)], 0)[None]
    stats = (g, b, y.sum(0)[None], (y.T @ y)[None], np.array([6.0], np.float32))
    assert not bool(torch.linalg.cholesky_ex(_t(g[0]) + lam * torch.eye(d + 1))[1] == 0)
    got = r._device_solve_from_stats(*map(_t, stats), lam)
    want = jr._device_solve_from_stats(*map(jnp.asarray, stats), jnp.asarray(lam, jnp.float32))
    assert torch.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=2e-3, atol=2e-3)


def test_rls_fit_matches_jax_host_solve(rng):
    c, n, d = 2, 40, 6
    x = rng.normal(size=(c, n, d)).astype(np.float32)
    y = rng.normal(size=(c, n, 4)).astype(np.float32)
    w = (rng.uniform(size=(c, n)) < 0.7).astype(np.float32)
    w[1] = 0.0  # a class with no rows: zeros, exists False
    model = r.rls_fit(_t(x), _t(y), _t(w), 5.0)
    jmodel = jr.rls_fit(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), 5.0)
    for name in ("beta", "t_inv", "t", "mu", "mean_losses"):
        np.testing.assert_allclose(getattr(model, name).numpy(), np.asarray(getattr(jmodel, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(model.exists.numpy(), np.asarray(jmodel.exists))
