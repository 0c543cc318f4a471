"""Particle filter + UKF (ops/particle) tests.

Oracles: a time-varying Kalman filter written out in numpy (exact for
linear-Gaussian models — the UKF must match it to near machine
precision, the particle filter statistically); a dense-GRID exact
Bayes filter for a 1-d non-Gaussian stochastic-volatility model (the
particle filter must match its posterior means).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from corrla_rs_tpu.ops.particle import particle_filter, ukf_filter


def _kf_exact(a, c_obs, q, r, m0, p0, ys):
    """Time-varying (non-steady-state) Kalman filter, numpy f64."""
    m, p_cov = m0.copy(), p0.copy()
    ll = 0.0
    means = []
    n_y = c_obs.shape[0]
    for y in ys:
        m = a @ m
        p_cov = a @ p_cov @ a.T + q
        s = c_obs @ p_cov @ c_obs.T + r
        innov = y - c_obs @ m
        si = np.linalg.inv(s)
        ll += -0.5 * (n_y * np.log(2 * np.pi)
                      + np.linalg.slogdet(s)[1] + innov @ si @ innov)
        k = p_cov @ c_obs.T @ si
        m = m + k @ innov
        p_cov = p_cov - k @ c_obs @ p_cov
        means.append(m.copy())
    return np.asarray(means), ll


def _linear_fixture(t_len=40, seed=0):
    rng = np.random.default_rng(seed)
    th = 0.4
    a = 0.97 * np.array([[np.cos(th), -np.sin(th)],
                         [np.sin(th), np.cos(th)]])
    c_obs = np.array([[1.0, 0.5]])
    q = 0.05 * np.eye(2)
    r = np.array([[0.2]])
    x = np.array([1.5, -0.5])
    ys = []
    for _ in range(t_len):
        x = a @ x + rng.multivariate_normal(np.zeros(2), q)
        ys.append(c_obs @ x + rng.multivariate_normal(np.zeros(1), r))
    return a, c_obs, q, r, np.asarray(ys)


class TestUkf:
    def test_linear_matches_kalman_exactly(self):
        a, c_obs, q, r, ys = _linear_fixture()
        m0 = np.zeros(2)
        p0 = np.eye(2)
        means_ref, ll_ref = _kf_exact(a, c_obs, q, r, m0, p0, ys)
        a_j, c_j = jnp.asarray(a), jnp.asarray(c_obs)
        out = ukf_filter(
            jnp.asarray(m0), jnp.asarray(p0), jnp.asarray(ys),
            lambda x: a_j @ x, lambda x: c_j @ x,
            jnp.asarray(q), jnp.asarray(r))
        np.testing.assert_allclose(
            np.asarray(out["means"]), means_ref, atol=1e-8)
        assert abs(out["loglik"] - ll_ref) < 1e-6

    def test_pd_breakdown_surfaces_as_nan(self):
        """If the innovation covariance loses positive-definiteness the
        loglik must be NaN, not a silently sign-dropped value
        (slogdet's sign must not be discarded)."""
        a, c_obs, q, _r, ys = _linear_fixture(t_len=5)
        a_j, c_j = jnp.asarray(a), jnp.asarray(c_obs)
        out = ukf_filter(
            jnp.zeros(2), jnp.eye(2), jnp.asarray(ys),
            lambda x: a_j @ x, lambda x: c_j @ x,
            jnp.asarray(q), -10.0)  # negative R forces s not PD
        assert np.isnan(out["loglik"])

    def test_nonlinear_tracks(self):
        # mildly nonlinear range-like observation of a rotating state
        rng = np.random.default_rng(3)
        th = 0.25
        a = 0.99 * np.array([[np.cos(th), -np.sin(th)],
                             [np.sin(th), np.cos(th)]])
        x = np.array([2.0, 0.0])
        xs, ys = [], []
        for _ in range(60):
            x = a @ x + 0.02 * rng.normal(size=2)
            xs.append(x.copy())
            ys.append(np.array([np.hypot(x[0] + 3.0, x[1] + 3.0)
                                + 0.05 * rng.normal()]))
        a_j = jnp.asarray(a)
        out = ukf_filter(
            jnp.asarray([1.0, 1.0]), 2.0 * jnp.eye(2),
            jnp.asarray(ys),
            lambda s: a_j @ s,
            lambda s: jnp.hypot(s[0] + 3.0, s[1] + 3.0)[None],
            0.02**2, 0.05**2)
        means = np.asarray(out["means"])
        rmse = np.sqrt(np.mean((means[20:] - np.asarray(xs)[20:]) ** 2))
        assert np.isfinite(out["loglik"])
        assert rmse < 0.2

    def test_validates_shapes(self):
        with pytest.raises(ValueError, match="x0_cov"):
            ukf_filter(jnp.zeros(2), jnp.eye(3), jnp.zeros((4, 1)),
                       lambda x: x, lambda x: x[:1], 0.1, 0.1)


class TestParticleFilter:
    def test_linear_loglik_matches_exact(self):
        a, c_obs, q, r, ys = _linear_fixture()
        m0 = np.zeros(2)
        p0 = np.eye(2)
        _, ll_ref = _kf_exact(a, c_obs, q, r, m0, p0, ys)
        means_ref, _ = _kf_exact(a, c_obs, q, r, m0, p0, ys)

        n_part = 8000
        rng = np.random.default_rng(1)
        x0 = jnp.asarray(rng.multivariate_normal(m0, p0, size=n_part))
        a_j, c_j = jnp.asarray(a), jnp.asarray(c_obs)
        chol_q = jnp.asarray(np.linalg.cholesky(q))
        r_val = float(r[0, 0])

        def propagate(key, x):
            return a_j @ x + chol_q @ jax.random.normal(key, (2,), x.dtype)

        def loglik_obs(x, y):
            resid = y[0] - (c_j @ x)[0]
            return -0.5 * (jnp.log(2 * jnp.pi * r_val)
                           + resid**2 / r_val)

        out = particle_filter(x0, jnp.asarray(ys), propagate,
                              loglik_obs, jax.random.key(0))
        assert abs(out["loglik"] - ll_ref) < 0.5
        np.testing.assert_allclose(
            np.asarray(out["means"]), means_ref, atol=0.15)
        assert np.all(np.asarray(out["ess"]) > 1.0)

    def test_stochastic_volatility_vs_grid_filter(self):
        # y_t ~ N(0, exp(x_t)), x' = mu + phi (x - mu) + sigma eps —
        # non-Gaussian observation density; oracle = exact Bayes filter
        # on a dense grid
        mu, phi, sig = -1.0, 0.95, 0.3
        rng = np.random.default_rng(7)
        t_len = 50
        x = mu
        xs, ys = [], []
        for _ in range(t_len):
            x = mu + phi * (x - mu) + sig * rng.normal()
            xs.append(x)
            ys.append(np.exp(x / 2) * rng.normal())
        ys = np.asarray(ys)

        # dense-grid exact filter (f64): 4001 points over +-6 stds
        grid = np.linspace(mu - 6, mu + 6, 4001)
        dx = grid[1] - grid[0]
        trans = np.exp(-0.5 * ((grid[None, :] - (mu + phi *
                       (grid[:, None] - mu))) / sig) ** 2)
        trans /= trans.sum(axis=1, keepdims=True)
        prior_sd = sig / np.sqrt(1 - phi**2)
        dens = np.exp(-0.5 * ((grid - mu) / prior_sd) ** 2)
        dens /= dens.sum()
        grid_means = []
        for y in ys:
            dens = dens @ trans
            like = np.exp(-0.5 * (grid + y**2 * np.exp(-grid)))
            dens = dens * like
            dens /= dens.sum()
            grid_means.append(np.sum(grid * dens))
        grid_means = np.asarray(grid_means)

        n_part = 16000
        x0 = jnp.asarray(
            mu + prior_sd * rng.normal(size=(n_part, 1)))

        def propagate(key, x):
            return mu + phi * (x - mu) \
                + sig * jax.random.normal(key, (1,), x.dtype)

        def loglik_obs(x, y):
            return -0.5 * (jnp.log(2 * jnp.pi) + x[0]
                           + y[0] ** 2 * jnp.exp(-x[0]))

        out = particle_filter(x0, jnp.asarray(ys)[:, None], propagate,
                              loglik_obs, jax.random.key(2))
        pf_means = np.asarray(out["means"])[:, 0]
        assert np.max(np.abs(pf_means - grid_means)) < 0.08

    def test_resampling_controls_ess(self):
        a, c_obs, q, r, ys = _linear_fixture(t_len=25)
        rng = np.random.default_rng(4)
        x0 = jnp.asarray(rng.normal(size=(500, 2)))
        a_j, c_j = jnp.asarray(a), jnp.asarray(c_obs)
        chol_q = jnp.asarray(np.linalg.cholesky(q))

        def propagate(key, x):
            return a_j @ x + chol_q @ jax.random.normal(key, (2,), x.dtype)

        def loglik_obs(x, y):
            resid = y[0] - (c_j @ x)[0]
            return -0.5 * resid**2 / 0.2

        never = particle_filter(x0, jnp.asarray(ys), propagate,
                                loglik_obs, jax.random.key(1),
                                resample_threshold=0.0)
        always = particle_filter(x0, jnp.asarray(ys), propagate,
                                 loglik_obs, jax.random.key(1),
                                 resample_threshold=1.0)
        # without resampling the weights degenerate; with it ESS stays up
        assert float(never["ess"][-1]) < float(always["ess"][-1])
        assert float(np.min(np.asarray(always["ess"]))) > 50.0

    def test_validates(self):
        with pytest.raises(ValueError, match="threshold"):
            particle_filter(jnp.zeros((10, 1)), jnp.zeros((3, 1)),
                            lambda k, x: x, lambda x, y: 0.0,
                            jax.random.key(0), resample_threshold=2.0)
        with pytest.raises(ValueError, match="x0_particles"):
            particle_filter(jnp.zeros(10), jnp.zeros((3, 1)),
                            lambda k, x: x, lambda x, y: 0.0,
                            jax.random.key(0))
