"""Gaussian mixture (ops/gmm) tests: EM ascent, sklearn-optimum
agreement, cluster recovery, density normalization, sampling
round-trip, and BIC order selection."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from corrla_rs_tpu.ops.gmm import (
    GmmFit, gmm_fit, gmm_logpdf, gmm_sample, gmm_select,
)


def _three_blobs(n_per=300, seed=0):
    rng = np.random.default_rng(seed)
    mus = np.array([[0.0, 0.0], [6.0, 1.0], [-1.0, 7.0]])
    covs = [np.array([[1.0, 0.3], [0.3, 0.7]]),
            np.array([[0.5, -0.2], [-0.2, 1.2]]),
            np.array([[0.8, 0.0], [0.0, 0.4]])]
    xs, labels = [], []
    for j, (mu, c) in enumerate(zip(mus, covs)):
        xs.append(rng.multivariate_normal(mu, c, size=n_per))
        labels.append(np.full(n_per, j))
    x = np.concatenate(xs)
    perm = rng.permutation(len(x))
    return x[perm], np.concatenate(labels)[perm], mus


class TestFit:
    def test_recovers_separated_clusters(self):
        x, _, mus = _three_blobs()
        fit = gmm_fit(x, 3, key=1)
        got = np.sort(np.asarray(fit.means), axis=0)
        want = np.sort(mus, axis=0)
        np.testing.assert_allclose(got, want, atol=0.25)
        np.testing.assert_allclose(
            np.sort(np.asarray(fit.weights)), [1 / 3] * 3, atol=0.05)
        assert int(fit.n_iter) < 200

    def test_monotone_and_matches_sklearn(self):
        x, _, _ = _three_blobs(n_per=200, seed=3)
        fit = gmm_fit(x, 3, key=0)
        try:
            from sklearn.mixture import GaussianMixture
        except ImportError:
            pytest.skip("sklearn unavailable")
        sk = GaussianMixture(3, covariance_type="full", n_init=5,
                             random_state=0, reg_covar=1e-6).fit(x)
        ll_sk = sk.score(x) * len(x)
        # same optimum (per-sample average within 1e-3 nats)
        assert abs(float(fit.log_likelihood) - ll_sk) / len(x) < 1e-3

    def test_diag_cov_type(self):
        x, _, _ = _three_blobs(n_per=150, seed=5)
        fit = gmm_fit(x, 3, key=2, cov_type="diag")
        covs = np.asarray(fit.covs)
        off = covs - np.stack([np.diag(np.diag(c)) for c in covs])
        assert np.max(np.abs(off)) == 0.0

    def test_diag_bic_counts_diag_params(self):
        """A diag fit must be penalized for k*d covariance params, not
        k*d*(d+1)/2: on identical log-likelihoods the diag
        BIC/AIC must be strictly smaller by the off-diagonal count."""
        x, _, _ = _three_blobs(n_per=150, seed=6)
        k, d = 3, 2
        full = gmm_fit(x, k, key=2, cov_type="full")
        diag = gmm_fit(x, k, key=2, cov_type="diag")
        assert full.cov_type == "full" and diag.cov_type == "diag"
        delta_params = k * d * (d - 1) // 2
        n = x.shape[0]
        # compare the penalty terms directly: bic + 2*ll = n_params*log(n)
        pen_full = full.bic() + 2.0 * float(full.log_likelihood)
        pen_diag = diag.bic() + 2.0 * float(diag.log_likelihood)
        np.testing.assert_allclose(
            pen_full - pen_diag, delta_params * np.log(n), rtol=1e-12)
        aicp_full = full.aic() + 2.0 * float(full.log_likelihood)
        aicp_diag = diag.aic() + 2.0 * float(diag.log_likelihood)
        np.testing.assert_allclose(
            aicp_full - aicp_diag, 2.0 * delta_params, rtol=1e-12)

    def test_numpy_integer_seed(self):
        """np.int64 seeds must coerce through utils.prng.as_key
        (an inline check used to pass them raw to split)."""
        x, _, _ = _three_blobs(n_per=60, seed=7)
        fit = gmm_fit(x, 2, key=np.int64(3), n_iter=20)
        assert np.isfinite(float(fit.log_likelihood))
        s = gmm_sample(fit, np.int64(5), 64)
        assert s.shape == (64, 2)

    def test_single_component_is_sample_moments(self):
        rng = np.random.default_rng(8)
        x = rng.multivariate_normal([1.0, -2.0],
                                    [[2.0, 0.5], [0.5, 1.0]], 500)
        fit = gmm_fit(x, 1, key=0, reg=0.0)
        np.testing.assert_allclose(
            np.asarray(fit.means)[0], x.mean(0), atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(fit.covs)[0], np.cov(x.T, bias=True), atol=1e-6)

    def test_validates(self):
        with pytest.raises(ValueError, match="n_components"):
            gmm_fit(np.zeros((5, 2)), 9)
        with pytest.raises(ValueError, match="cov_type"):
            gmm_fit(np.zeros((5, 2)), 2, cov_type="spherical")


class TestDensityAndSampling:
    def test_logpdf_normalizes(self):
        # grid-integrate the 1-d mixture density to 1
        rng = np.random.default_rng(2)
        x = np.concatenate([rng.normal(-2, 0.5, 400),
                            rng.normal(3, 1.0, 400)])
        fit = gmm_fit(x, 2, key=0)
        grid = np.linspace(-10, 12, 4001)
        dens = np.exp(np.asarray(gmm_logpdf(fit, grid)))
        total = np.trapezoid(dens, grid)
        assert abs(total - 1.0) < 1e-6

    @pytest.mark.slow
    def test_sample_matches_fit_moments(self):
        x, _, _ = _three_blobs(n_per=300, seed=1)
        fit = gmm_fit(x, 3, key=0)
        draws = np.asarray(gmm_sample(fit, jax.random.key(4), 40000))
        # mixture mean / covariance from the fitted parameters
        w = np.asarray(fit.weights)
        mus = np.asarray(fit.means)
        covs = np.asarray(fit.covs)
        mean_th = w @ mus
        cov_th = sum(w[j] * (covs[j] + np.outer(mus[j] - mean_th,
                                                mus[j] - mean_th))
                     for j in range(3))
        np.testing.assert_allclose(draws.mean(0), mean_th, atol=0.05)
        np.testing.assert_allclose(np.cov(draws.T), cov_th, atol=0.15)

    @pytest.mark.slow
    def test_is_proposal_roundtrip(self):
        # the intended use: a GMM fitted to posterior draws is a valid
        # importance proposal — self-normalized IS with it recovers a
        # known expectation
        rng = np.random.default_rng(6)
        target_draws = np.concatenate(
            [rng.normal(-1.5, 0.6, (1500, 1)),
             rng.normal(2.0, 0.8, (1500, 1))], axis=0)
        fit = gmm_fit(target_draws, 2, key=0)
        prop = gmm_sample(fit, jax.random.key(7), 20000)
        lq = np.asarray(gmm_logpdf(fit, prop))

        def ln_target(v):
            return np.logaddexp(
                -0.5 * ((v + 1.5) / 0.6) ** 2 - np.log(0.6),
                -0.5 * ((v - 2.0) / 0.8) ** 2 - np.log(0.8),
            )

        lw = ln_target(np.asarray(prop)[:, 0]) - lq
        w = np.exp(lw - lw.max())
        w /= w.sum()
        est = float(w @ np.asarray(prop)[:, 0])
        assert abs(est - 0.25) < 0.05   # mixture mean = (-1.5+2)/2


class TestSelect:
    def test_bic_picks_true_order(self):
        x, _, _ = _three_blobs(n_per=250, seed=4)
        _, best_k, scores = gmm_select(x, range(1, 6), key=0)
        assert best_k == 3
        assert scores[3] < scores[1] and scores[3] < scores[5]

    def test_validates_criterion(self):
        with pytest.raises(ValueError, match="criterion"):
            gmm_select(np.zeros((20, 2)), [1], criterion="waic")
