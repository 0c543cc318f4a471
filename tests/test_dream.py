"""DREAM sampler tests (feature the reference README promised, readme.md:44)."""
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.dream import DreamSampler, dream_run
from corrla_rs_tpu.ops.samplers import (
    constr_dirichlet_sample,
    ln_like_dirichlet,
    ln_like_sum,
    ln_prior_uniform,
)

BOUNDS = np.array([[0.0, 0.0026], [0.1955, 0.1995], [0.80, 0.825]])


def test_dream_gaussian_1d():
    mu, std = 2.0, 3.0

    def lnp(x):
        return -0.5 * ((x[0] - mu) / std) ** 2

    heads0 = jnp.zeros((10, 1)) + jnp.linspace(-1, 1, 10)[:, None]
    sampler = DreamSampler(lnp, heads0, n_adapt=500, key=0)
    sampler.sample_mcmc(4000)
    tail = np.asarray(sampler.get_samples(1500))
    assert abs(tail.mean() - mu) < 5e-1
    assert abs(tail.std(ddof=1) - std) < 5e-1
    assert sampler.accept_ratio() > 0.15


def test_dream_gaussian_highdim():
    # Correlated 5-D Gaussian: DREAM's subspace sampling shines here.
    d = 5
    rng = np.random.default_rng(0)
    a = rng.standard_normal((d, d))
    cov = a @ a.T + d * np.eye(d)
    prec = jnp.asarray(np.linalg.inv(cov))

    def lnp(x):
        return -0.5 * x @ prec @ x

    heads0 = jnp.asarray(rng.standard_normal((20, d)))
    hist, state = dream_run(heads0, lnp, 6000, key=1, n_adapt=1000)
    tail = np.asarray(hist[2500:]).reshape(-1, d)
    emp_cov = np.cov(tail, rowvar=False)
    # covariance recovered within 15% (MCMC noise)
    assert np.abs(emp_cov - cov).max() / np.abs(cov).max() < 0.15


def test_dream_adapts_crossover():
    def lnp(x):
        return -0.5 * jnp.sum(x**2)

    heads0 = jnp.asarray(np.random.default_rng(1).standard_normal((12, 3)))
    _hist, state = dream_run(heads0, lnp, 800, key=2, n_adapt=800)
    p_cr = np.asarray(state.p_cr)
    assert abs(p_cr.sum() - 1.0) < 1e-6
    assert (p_cr > 0.0).all()
    # adaptation actually moved the probabilities off uniform
    assert np.abs(p_cr - 1.0 / 3.0).max() > 1e-3


def test_dream_adaptation_threads_across_blocks():
    # DreamSampler used to restart adaptation at
    # every block boundary, so the adapted p_cr was lost after burn-in.
    # Now the full DreamState persists: t accumulates, p_cr adapts across
    # blocks, and freezes (not resets) once t >= n_adapt.
    def lnp(x):
        return -0.5 * jnp.sum(x**2)

    heads0 = jnp.asarray(np.random.default_rng(2).standard_normal((12, 3)))
    s = DreamSampler(lnp, heads0, n_adapt=400, key=5, outlier_correct=True,
                     outlier_every=100)
    s.sample_mcmc(400)  # burn-in runs in 100-gen blocks (outlier window)
    assert int(s._state.t) == 400
    p_adapted = np.asarray(s._state.p_cr)
    # adaptation survived the block boundaries (moved off uniform)
    assert np.abs(p_adapted - 1.0 / 3.0).max() > 1e-3
    s.sample_mcmc(300)  # stationary phase: adapted p_cr must be FROZEN
    assert int(s._state.t) == 700
    np.testing.assert_array_equal(np.asarray(s._state.p_cr), p_adapted)
    # accept accounting stayed consistent through state threading
    assert 0.0 < s.accept_ratio() <= 1.0
    assert s.n_total == 700 * 12


def test_dream_run_resume_from_state():
    from corrla_rs_tpu.ops.dream import make_dream_state

    def lnp(x):
        return -0.5 * jnp.sum(x**2)

    heads0 = jnp.asarray(np.random.default_rng(3).standard_normal((10, 2)))
    # one 200-gen run vs 2 x 100-gen runs resumed via init_state: the
    # adaptation statistics must carry (t, n_id counts keep growing)
    _h1, s_split = dream_run(heads0, lnp, 100, key=7, n_adapt=150)
    _h2, s_split = dream_run(None, lnp, 100, key=8, n_adapt=150,
                             init_state=s_split)
    assert int(s_split.t) == 200
    assert float(np.asarray(s_split.n_id).sum()) == 200 * 10
    # p_cr frozen after n_adapt inside the second block
    assert abs(float(jnp.sum(s_split.p_cr)) - 1.0) < 1e-6


def test_dream_dirichlet_simplex():
    seeds = constr_dirichlet_sample(BOUNDS, 8, 500, 20000, 1.0, key=3)
    lnp = ln_like_sum(
        ln_like_dirichlet(jnp.ones(3)), ln_prior_uniform(BOUNDS)
    )

    def fixup(x):
        return x / jnp.sum(x)

    sampler = DreamSampler(
        lnp, seeds, delta_max=3, n_adapt=300, prop_fixup_fn=fixup, key=4
    )
    sampler.sample_mcmc(1500)
    tail = np.asarray(sampler.get_samples(200))
    np.testing.assert_allclose(tail.sum(axis=1), 1.0, atol=1e-6)
    assert (tail > BOUNDS[:, 0][None, :] - 1e-12).all()
    assert (tail < BOUNDS[:, 1][None, :] + 1e-12).all()


def test_dream_midsize_schedule_branch():
    # The round-5 scatter-free body ships with a size-dependent
    # (chunk, unroll) schedule (_sched_for); 2048 < n <= 16384 takes the
    # chunk-10/unroll-8 branch. Exercise it end-to-end with a remainder
    # chunk (23 = 2 x 10 + 3) and an explicit-unroll override.
    from corrla_rs_tpu.ops.dream import _sched_for

    assert _sched_for(4096) == (10, 8)
    assert _sched_for(512)[1] == 4
    assert _sched_for(32768) == (5, 4)

    def lnp(x):
        return -0.5 * jnp.sum(x**2)

    heads0 = jnp.asarray(
        np.random.default_rng(4).standard_normal((4096, 2)), jnp.float32
    )
    hist, state = dream_run(heads0, lnp, 23, key=9)
    assert hist.shape == (23, 4096, 2)
    assert np.isfinite(np.asarray(hist)).all()
    assert int(state.t) == 23
    assert 0 < int(state.n_accept) <= 23 * 4096
    # explicit unroll still honored (None just defers to the schedule)
    hist1, _ = dream_run(heads0, lnp, 7, key=9, unroll=1)
    assert hist1.shape == (7, 4096, 2)


def test_zero_steps_returns_empty_history():
    # review finding: n_steps=0 used to crash in jnp.concatenate([]) —
    # all three chunked run loops (DREAM, DEMC, stretch) now return an
    # empty (0, n, d) history with the state untouched.
    from corrla_rs_tpu.ops.ensemble_mcmc import stretch_run
    from corrla_rs_tpu.ops.samplers import demc_run

    def lnp(x):
        return -0.5 * jnp.sum(x**2)

    heads0 = jnp.asarray(np.random.default_rng(5).standard_normal((10, 2)))
    h, state = dream_run(heads0, lnp, 0, key=1)
    assert h.shape == (0, 10, 2)
    np.testing.assert_array_equal(np.asarray(state.heads),
                                  np.asarray(heads0))
    h, _ = demc_run(heads0, lnp, 0, gamma=0.8, var_epsilon=1e-6, key=1)
    assert h.shape == (0, 10, 2)
    h, _ = stretch_run(heads0, lnp, 0, key=1)
    assert h.shape == (0, 10, 2)


def test_dream_requires_enough_chains():
    def lnp(x):
        return -0.5 * jnp.sum(x**2)

    import pytest

    with pytest.raises(AssertionError):
        dream_run(jnp.zeros((4, 2)), lnp, 10, delta_max=3)


def test_outlier_chain_correction():
    from corrla_rs_tpu.ops.dream import DreamSampler, outlier_reset

    # direct unit check: an obviously stuck chain relocates to the best
    heads = jnp.asarray(np.vstack([np.random.default_rng(0).standard_normal((9, 2)),
                                   [[50.0, 50.0]]]))
    lnp = jnp.asarray(np.concatenate([np.full(9, -1.0), [-5000.0]]))
    new_heads, new_lnp, n_reset = outlier_reset(heads, lnp)
    assert int(n_reset) == 1
    best = int(jnp.argmax(lnp))
    np.testing.assert_allclose(np.asarray(new_heads[-1]),
                               np.asarray(heads[best]))

    # end-to-end: a chain started far in the tail gets rescued during
    # burn-in and the sampler still converges
    def lnp_fn(x):
        return -0.5 * jnp.sum(x**2)

    heads0 = np.random.default_rng(1).standard_normal((12, 2)) * 0.5
    heads0[0] = [500.0, 500.0]  # stuck far away
    s = DreamSampler(lnp_fn, jnp.asarray(heads0), n_adapt=600,
                     outlier_correct=True, outlier_every=50, key=0)
    s.sample_mcmc(2000)
    assert s.n_outlier_resets >= 1
    tail = np.asarray(s.get_samples(500))
    assert abs(tail.mean()) < 0.3
    assert abs(tail.std() - 1.0) < 0.3
    # adaptation window is global across calls: further sampling is pure
    g_before = s._gens
    s.sample_mcmc(100)
    assert s._gens == g_before + 100
