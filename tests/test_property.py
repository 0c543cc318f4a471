"""Property-style sweeps: random shapes/configs against exact oracles.

Catches shape-handling and dtype edge cases the fixed fixtures miss.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from corrla_rs_tpu.ops.interp import RbfInterp
from corrla_rs_tpu.ops.random_svd import random_svd
from corrla_rs_tpu.ops.samplers import constr_dirichlet_sample


def _seeds(n, n_default=2):
    """Seed grid tiering: the first `n_default` random configs run in the
    default lane; the rest of the sweep runs with -m slow."""
    return [
        s if s < n_default else pytest.param(s, marks=pytest.mark.slow)
        for s in range(n)
    ]


@pytest.mark.parametrize("seed", _seeds(6))
def test_rsvd_random_configs(seed):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(8, 300))
    n = int(rng.integers(8, 300))
    rank = int(rng.integers(1, min(m, n, 12) + 1))
    n_iter = int(rng.integers(4, 16))
    n_over = int(rng.integers(2, 12))
    a = jnp.asarray(rng.standard_normal((m, n)))
    u, s, vt = random_svd(a, rank, n_iter, n_over, key=seed)
    assert u.shape == (m, rank) and s.shape == (rank,) and vt.shape == (rank, n)
    assert bool(jnp.all(jnp.isfinite(u))) and bool(jnp.all(jnp.isfinite(vt)))
    s_exact = np.linalg.svd(np.asarray(a), compute_uv=False)
    # leading singular value always well converged; all estimates bounded
    np.testing.assert_allclose(float(s[0]), s_exact[0], rtol=1e-2)
    assert (np.asarray(s) <= s_exact[0] * (1 + 1e-6)).all()
    assert (np.asarray(s) >= -1e-9).all()


@pytest.mark.parametrize("seed", _seeds(4))
def test_rsvd_exact_low_rank_random(seed):
    rng = np.random.default_rng(100 + seed)
    m = int(rng.integers(30, 200))
    n = int(rng.integers(30, 200))
    r = int(rng.integers(1, 6))
    a = jnp.asarray(
        rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
    )
    u, s, vt = random_svd(a, r, 12, 8, key=seed)
    recon = np.asarray(u) @ np.diag(np.asarray(s)) @ np.asarray(vt)
    np.testing.assert_allclose(recon, np.asarray(a), atol=1e-6)


@pytest.mark.parametrize("seed", _seeds(4))
def test_dirichlet_random_feasible_bounds(seed):
    rng = np.random.default_rng(200 + seed)
    d = int(rng.integers(2, 6))
    # build feasible bounds around a random simplex point
    center = rng.dirichlet(np.ones(d))
    width = rng.uniform(0.05, 0.3)
    bounds = np.stack(
        [np.clip(center - width, 0, 1), np.clip(center + width, 0, 1)],
        axis=1,
    )
    s = constr_dirichlet_sample(bounds, 32, 500, 200_000, 1.0, key=seed)
    arr = np.asarray(s)
    np.testing.assert_allclose(arr.sum(axis=1), 1.0, atol=1e-6)
    assert (arr >= bounds[:, 0][None, :] - 1e-12).all()
    assert (arr <= bounds[:, 1][None, :] + 1e-12).all()


def test_dirichlet_c_scale_device():
    bounds = np.array([[0.0, 0.01], [0.7, 0.9], [0.2, 0.4]]) * 2.0
    s = constr_dirichlet_sample(bounds, 16, 500, 100_000, 2.0, key=0)
    np.testing.assert_allclose(np.asarray(s).sum(axis=1), 2.0, atol=1e-6)


def test_rbf_duplicate_support_points(rng):
    # exact duplicate rows make the kernel matrix singular; the LU default
    # cannot solve it, but the reference-parity pinv path must survive
    # (interp_utils.rs:131-144 uses pinv unconditionally).
    x = jnp.asarray(rng.standard_normal((20, 2)))
    x = jnp.concatenate([x, x[:3]], axis=0)  # 3 duplicates
    y = jnp.sin(x[:, :1])
    rbf = RbfInterp(2, 1.0, 2, 1, method="pinv").fit(x, y)
    pred = rbf.predict(x[:5])
    assert bool(jnp.all(jnp.isfinite(pred)))
    # interpolation quality still reasonable away from the degeneracy
    assert float(jnp.max(jnp.abs(pred - y[:5]))) < 0.2


def test_rsvd_zero_matrix():
    a = jnp.zeros((40, 10))
    u, s, vt = random_svd(a, 3, 8, 5, key=0)
    np.testing.assert_allclose(np.asarray(s), 0.0, atol=1e-12)
    assert bool(jnp.all(jnp.isfinite(u)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rsvd_dtypes(dtype, rng):
    a = jnp.asarray(rng.standard_normal((100, 30)), dtype=dtype)
    u, s, vt = random_svd(a, 4, 10, 8, key=0)
    assert u.dtype == jnp.dtype(dtype)
    s_exact = np.linalg.svd(np.asarray(a, np.float64), compute_uv=False)
    # f64 with the reference skip-QR heuristic converges trailing sigmas
    # only to ~1e-5 rel on gapless Gaussian spectra (same as the reference)
    rtol = 1e-3 if dtype == "float32" else 1e-5
    np.testing.assert_allclose(np.asarray(s, np.float64), s_exact[:4],
                               rtol=rtol)


@pytest.mark.parametrize("seed", _seeds(6, n_default=1))
def test_eig_device_random_configs(seed):
    from corrla_rs_tpu.ops.eig_device import eig_device

    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(2, 40))
    scale = 10.0 ** rng.integers(-3, 4)
    a = rng.standard_normal((n, n)) * scale
    lr, li, vr, vi = eig_device(jnp.asarray(a))
    lam = np.asarray(lr) + 1j * np.asarray(li)
    ref = np.sort_complex(np.linalg.eigvals(a))
    np.testing.assert_allclose(
        np.sort_complex(lam) / (scale * max(n, 1)),
        ref / (scale * max(n, 1)), atol=1e-12,
    )
    v = np.asarray(vr) + 1j * np.asarray(vi)
    resid = np.abs(a @ v - v * lam[None, :]).max()
    assert resid < 1e-10 * scale * n, (n, scale, resid)


@pytest.mark.parametrize("seed", _seeds(4))
def test_era_random_stable_systems(seed):
    # random stable (A, B, C) of random sizes: ERA recovers the poles
    # from the Markov stack at f64 tolerance
    from corrla_rs_tpu import era

    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(2, 6))
    p = int(rng.integers(1, 3))
    q = int(rng.integers(1, 3))
    qm, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = rng.uniform(-0.9, 0.9, n)
    a = qm @ np.diag(lam) @ qm.T
    b = rng.standard_normal((n, p))
    c = rng.standard_normal((q, n))
    hs = np.empty((30, q, p))
    ca = c.copy()
    for k in range(30):
        hs[k] = ca @ b
        ca = ca @ a
    fit = era(hs, rank=n)
    np.testing.assert_allclose(np.sort_complex(fit.lambdas),
                               np.sort_complex(lam.astype(complex)),
                               atol=1e-6)


@pytest.mark.parametrize("seed", _seeds(4))
def test_sketched_lstsq_random_shapes(seed):
    from corrla_rs_tpu import sketched_lstsq

    rng = np.random.default_rng(200 + seed)
    n = int(rng.integers(4, 40))
    m = int(rng.integers(4 * n + 16, 2000))
    a = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    x, _ = sketched_lstsq(a, b, key=seed)
    x_ref, *_ = np.linalg.lstsq(a, b, rcond=None)
    np.testing.assert_allclose(np.asarray(x), x_ref, atol=1e-8)


@pytest.mark.parametrize("seed", _seeds(3))
def test_pidmd_orthogonal_random_shapes(seed):
    from corrla_rs_tpu import PiDmd

    rng = np.random.default_rng(300 + seed)
    n = int(rng.integers(4, 24))
    m = int(rng.integers(3 * n, 6 * n))
    qm, _ = np.linalg.qr(rng.standard_normal((n, n)))
    x = np.empty((n, m))
    x[:, 0] = rng.standard_normal(n)
    for k in range(1, m):
        x[:, k] = qm @ x[:, k - 1]
    fit = PiDmd(x + 0.01 * rng.standard_normal(x.shape), n_modes=n,
                family="orthogonal")
    np.testing.assert_allclose(np.abs(fit.lambdas), 1.0, atol=1e-9)


@pytest.mark.parametrize("seed", _seeds(3))
def test_spod_random_shapes_orthonormal(seed):
    from corrla_rs_tpu import spod

    rng = np.random.default_rng(400 + seed)
    n_x = int(rng.integers(2, 20))
    n_fft = int(2 ** rng.integers(4, 7))
    n_t = n_fft * int(rng.integers(4, 9))
    fit = spod(rng.standard_normal((n_x, n_t)), n_fft=n_fft)
    e = np.asarray(fit.energies)
    assert np.all(np.isfinite(e)) and np.all(e >= 0)
    assert np.all(np.isfinite(np.asarray(fit.modes_re)))
    # energetic modes orthonormal at a random interior bin
    bin_i = int(rng.integers(1, n_fft // 2))
    phi = (np.asarray(fit.modes_re[bin_i])
           + 1j * np.asarray(fit.modes_im[bin_i]))
    norms = np.linalg.norm(phi, axis=0)
    good = norms > 0.5
    if np.any(good):
        g = phi[:, good].conj().T @ phi[:, good]
        np.testing.assert_allclose(g, np.eye(int(good.sum())),
                                   atol=1e-7)


@pytest.mark.parametrize("seed", _seeds(3))
def test_cp_random_exact_rank(seed):
    from corrla_rs_tpu import cp_als

    rng = np.random.default_rng(500 + seed)
    d = int(rng.integers(3, 5))
    shape = tuple(int(rng.integers(4, 12)) for _ in range(d))
    r = int(rng.integers(1, 4))
    factors = [rng.standard_normal((s, r)) for s in shape]
    subs = "abcdefgh"[:d]
    spec = ",".join(f"{s}r" for s in subs) + "->" + subs
    t = np.einsum(spec, *factors)
    _, _, fits = cp_als(t, r, n_sweeps=120, key=seed)
    assert float(fits[-1]) > 1 - 1e-6


# ---------------------------------------------------------------------------
# Randomized invariants for the statistical
# families — enkf, smc, psis, quadrature.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", _seeds(4))
def test_enkf_mean_is_sample_kalman_mean(seed):
    """Deterministic identity (stronger than the N->inf limit): with
    CENTERED perturbations and a linear h, both the stochastic EnKF and
    the ETKF analysis MEAN equal the exact Kalman update built from the
    SAMPLE covariances, for every random shape/fixture."""
    import jax

    from corrla_rs_tpu.ops.enkf import enkf_analysis, etkf_analysis

    rng = np.random.default_rng(300 + seed)
    n_ens = int(rng.integers(8, 64))
    n = int(rng.integers(2, 20))
    p = int(rng.integers(1, min(n, 6) + 1))
    x_ens = rng.standard_normal((n_ens, n))
    h = rng.standard_normal((p, n))
    y = rng.standard_normal(p)
    r_diag = rng.uniform(0.1, 1.0, p)

    xbar = x_ens.mean(0)
    xa = x_ens - xbar
    pb = xa.T @ xa / (n_ens - 1)
    s = h @ pb @ h.T + np.diag(r_diag)
    gain = pb @ h.T @ np.linalg.inv(s)
    mean_exact = xbar + gain @ (y - h @ xbar)

    a_sto = enkf_analysis(x_ens, y, h, r_diag, jax.random.key(seed))
    a_det = etkf_analysis(x_ens, y, h, r_diag)
    np.testing.assert_allclose(np.asarray(a_sto).mean(0), mean_exact,
                               atol=1e-8)
    np.testing.assert_allclose(np.asarray(a_det).mean(0), mean_exact,
                               atol=1e-8)


@pytest.mark.parametrize("seed", _seeds(3))
def test_enkf_woodbury_random_shapes(seed):
    """The ensemble-space (Woodbury) kernel must agree with the
    obs-space kernel on random p > N problems with diagonal R."""
    from corrla_rs_tpu.ops.enkf import (
        _enkf_kernel_ens_space, _enkf_kernel_obs_space,
    )

    rng = np.random.default_rng(330 + seed)
    n_ens = int(rng.integers(4, 16))
    n = int(rng.integers(2, 12))
    p = n_ens + int(rng.integers(1, 40))
    x_ens = jnp.asarray(rng.standard_normal((n_ens, n)))
    y_ens = jnp.asarray(rng.standard_normal((n_ens, p)))
    d_pert = jnp.asarray(rng.standard_normal((n_ens, p)))
    r_diag = rng.uniform(0.2, 2.0, p)
    a1 = _enkf_kernel_obs_space(x_ens, y_ens, d_pert, jnp.diag(
        jnp.asarray(r_diag)))
    a2 = _enkf_kernel_ens_space(x_ens, y_ens, d_pert,
                                jnp.asarray(1.0 / r_diag))
    np.testing.assert_allclose(np.asarray(a2), np.asarray(a1),
                               rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("seed", _seeds(3))
def test_smc_evidence_random_gaussian(seed):
    """SMC log-evidence vs the analytic normalizer of a random
    linear-Gaussian model: prior N(0, a^2 I), unnormalized Gaussian
    likelihood exp(-|x-mu|^2 / (2 b^2)). The adaptive ladder differs
    per seed (random anneal ladders)."""
    import jax

    from corrla_rs_tpu.ops.smc import smc_sample

    rng = np.random.default_rng(400 + seed)
    d = int(rng.integers(1, 4))
    a = float(rng.uniform(0.8, 2.0))
    b = float(rng.uniform(0.3, 1.0))
    mu = rng.uniform(-1.0, 1.0, d)
    mu_j = jnp.asarray(mu)

    def ln_like(x):
        return -0.5 * jnp.sum((x - mu_j) ** 2) / b**2

    def ln_prior(x):
        return (-0.5 * jnp.sum(x**2) / a**2
                - 0.5 * d * jnp.log(2.0 * jnp.pi * a**2))

    logz_true = float(np.sum(
        np.log(b) - 0.5 * np.log(a**2 + b**2)
        - mu**2 / (2.0 * (a**2 + b**2))))
    init = jnp.asarray(rng.standard_normal((1024, d)) * a)
    res = smc_sample(ln_like, ln_prior, init, n_mcmc=4, key=seed)
    assert abs(res.log_evidence - logz_true) < 0.15 + 0.05 * abs(logz_true)
    # posterior moments: N(mu * a^2/(a^2+b^2), (a^-2 + b^-2)^-1 I)
    post_mean = mu * a**2 / (a**2 + b**2)
    post_std = (1.0 / a**2 + 1.0 / b**2) ** -0.5
    parts = np.asarray(res.particles)
    np.testing.assert_allclose(parts.mean(0), post_mean,
                               atol=5.0 * post_std / np.sqrt(1024) * 4)
    np.testing.assert_allclose(parts.std(0), post_std, rtol=0.25)


@pytest.mark.parametrize("seed", _seeds(3))
def test_psis_khat_regimes(seed):
    """k-hat must separate the importance-weight regimes: near-uniform
    (finite-variance) weights => k_hat < 0.5; Pareto(alpha<1.4) weights
    (infinite variance, tail index 1/alpha > 0.7) => k_hat > 0.6 and
    near the true index. Smoothed weights stay normalized and
    rank-ordered."""
    from corrla_rs_tpu.ops.psis import psis

    rng = np.random.default_rng(500 + seed)
    n = 4000
    # light regime: lognormal weights, all moments finite
    lw_light = rng.normal(0.0, rng.uniform(0.2, 0.6), n)
    r_light = psis(lw_light)
    assert r_light.k_hat < 0.5
    # heavy regime: w = u^(-1/alpha) is Pareto with tail index 1/alpha
    alpha = float(rng.uniform(1.0, 1.4))
    lw_heavy = -np.log(rng.uniform(size=n)) / alpha
    r_heavy = psis(lw_heavy)
    assert r_heavy.k_hat > 0.6
    assert abs(r_heavy.k_hat - 1.0 / alpha) < 0.3
    for r in (r_light, r_heavy):
        w = np.exp(np.asarray(r.log_weights))
        np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-10)
        assert 1.0 <= r.ess <= n + 1e-9
    assert r_heavy.ess < r_light.ess


@pytest.mark.parametrize("seed", _seeds(4))
def test_gauss_legendre_random_poly_exact(seed):
    """n-point Gauss-Legendre integrates random polynomials of degree
    2n-1 exactly on random intervals."""
    from corrla_rs_tpu.ops.quadrature import gauss_legendre, integrate

    rng = np.random.default_rng(600 + seed)
    n = int(rng.integers(2, 12))
    deg = 2 * n - 1
    coeffs = rng.standard_normal(deg + 1)
    a = float(rng.uniform(-3.0, 0.0))
    b = a + float(rng.uniform(0.5, 4.0))
    rule = gauss_legendre(n, a, b)
    got = integrate(
        lambda x: jnp.polyval(jnp.asarray(coeffs), x[0]), rule)
    k = np.arange(deg, -1, -1)
    exact = float(np.sum(coeffs * (b ** (k + 1) - a ** (k + 1)) / (k + 1)))
    scale = max(1.0, abs(exact))
    assert abs(got - exact) < 1e-9 * scale


@pytest.mark.parametrize("seed", _seeds(3))
def test_gauss_hermite_random_moments(seed):
    """n-point Gauss-Hermite (standard-normal weight) reproduces
    E[X^k] = 0 (odd) / (k-1)!! (even) for every k <= 2n-1."""
    from corrla_rs_tpu.ops.quadrature import gauss_hermite, integrate

    rng = np.random.default_rng(650 + seed)
    n = int(rng.integers(3, 10))
    rule = gauss_hermite(n)
    for k in range(2 * n):
        got = integrate(lambda x, k=k: x[0] ** k, rule)
        exact = 0.0 if k % 2 else float(
            np.prod(np.arange(k - 1, 0, -2))) if k else 1.0
        assert abs(got - exact) < 1e-8 * max(1.0, abs(exact)), (n, k)


@pytest.mark.parametrize("seed", _seeds(3))
def test_clenshaw_curtis_random_poly_exact(seed):
    """n-point Clenshaw-Curtis is exact for degree <= n-1 on a random
    interval."""
    from corrla_rs_tpu.ops.quadrature import clenshaw_curtis, integrate

    rng = np.random.default_rng(700 + seed)
    n = int(rng.integers(2, 16))
    deg = n - 1
    coeffs = rng.standard_normal(deg + 1)
    a = float(rng.uniform(-2.0, 0.0))
    b = a + float(rng.uniform(0.5, 3.0))
    rule = clenshaw_curtis(n, a, b)
    got = integrate(
        lambda x: jnp.polyval(jnp.asarray(coeffs), x[0]), rule)
    k = np.arange(deg, -1, -1)
    exact = float(np.sum(coeffs * (b ** (k + 1) - a ** (k + 1)) / (k + 1)))
    assert abs(got - exact) < 1e-9 * max(1.0, abs(exact))


@pytest.mark.parametrize("seed", _seeds(3))
def test_smolyak_random_monomial_exact(seed):
    """Smolyak-CC at level L integrates random monomials of total
    degree <= 2L+1 exactly over [-1,1]^d (Novak-Ritter exactness)."""
    from corrla_rs_tpu.ops.quadrature import integrate, smolyak_quadrature

    rng = np.random.default_rng(750 + seed)
    d = int(rng.integers(2, 5))
    level = 2
    rule = smolyak_quadrature(d, level)
    max_total = 2 * level + 1
    for _ in range(4):
        # random exponents with total degree <= 2L+1
        e = np.zeros(d, np.int64)
        budget = max_total
        for i in rng.permutation(d):
            e[i] = rng.integers(0, budget + 1)
            budget -= e[i]
        got = integrate(
            lambda x, e=jnp.asarray(e): jnp.prod(x ** e), rule)
        exact = float(np.prod(
            [0.0 if k % 2 else 2.0 / (k + 1) for k in e]))
        assert abs(got - exact) < 1e-9, (d, e.tolist())
