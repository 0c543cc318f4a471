"""Rotated pair-copulas and the R-vine (Dissmann) structure learner."""
import jax.numpy as jnp
import numpy as np
import pytest

from corrla_rs_tpu.ops import vine as v
from corrla_rs_tpu.ops.rvine import RVineCopula, _swap
from corrla_rs_tpu.ops.vine import FAMILIES, kendall_tau


ROTATED = [f for f in FAMILIES if f[-1].isdigit()]
# The Student-t members pay an iterative (Newton) h-inverse per point —
# they dominate this module's wall, so they run in the slow lane; the
# archimedean rotations keep the default-lane coverage of the rotation
# machinery (test_vine keeps a default-lane t-density rep).
ROTATED_TIERED = [
    pytest.param(f, marks=pytest.mark.slow) if f.startswith("t") else f
    for f in ROTATED
]


@pytest.mark.parametrize("fam", ROTATED_TIERED)
def test_rotated_h_roundtrip_and_pdf(rng, fam):
    _base, rot = v._split_rotation(fam)
    tau = -0.5 if rot in (90, 270) else 0.5
    th = v._theta_from_tau(fam, tau)
    w = jnp.asarray(rng.uniform(0.02, 0.98, 300))
    vv = jnp.asarray(rng.uniform(0.02, 0.98, 300))
    u = v._HINV[fam](w, vv, th)
    np.testing.assert_allclose(
        np.asarray(v._H[fam](u, vv, th)), np.asarray(w), atol=1e-9
    )
    # dh/du == copula density (the h-function is the conditional CDF)
    eps = 1e-6
    num = (v._H[fam](u + eps, vv, th) - v._H[fam](u - eps, vv, th)) / (
        2 * eps
    )
    ana = jnp.exp(v._LOGPDF[fam](u, vv, th))
    np.testing.assert_allclose(
        np.asarray(num), np.asarray(ana),
        atol=1e-5 * float(jnp.abs(ana).max()),
    )


@pytest.mark.parametrize("fam", ROTATED_TIERED)
def test_rotated_tau_sign(rng, fam):
    _base, rot = v._split_rotation(fam)
    tau = -0.45 if rot in (90, 270) else 0.45
    th = v._theta_from_tau(fam, tau)
    ww = rng.uniform(1e-6, 1 - 1e-6, (3000, 2))
    us = np.asarray(
        v._HINV[fam](jnp.asarray(ww[:, 1]), jnp.asarray(ww[:, 0]), th)
    )
    tau_hat = float(kendall_tau(us, ww[:, 0]))
    assert abs(tau_hat - tau) < 0.06


def test_swap_family_is_argument_exchange(rng):
    # C_fam(u, v) has conditional-of-second-given-first equal to
    # _H[_swap(fam)] with swapped arguments; verify via the density
    # symmetry c_fam(u, v) == c_swap(fam)(v, u)
    for fam in ("clayton90", "gumbel270", "clayton", "gumbel180"):
        th = v._theta_from_tau(
            fam, -0.4 if v._split_rotation(fam)[1] in (90, 270) else 0.4
        )
        u = jnp.asarray(rng.uniform(0.05, 0.95, 100))
        w = jnp.asarray(rng.uniform(0.05, 0.95, 100))
        np.testing.assert_allclose(
            np.asarray(v._LOGPDF[fam](u, w, th)),
            np.asarray(v._LOGPDF[_swap(fam)](w, u, th)),
            atol=1e-9,
        )


def test_fit_pair_selects_rotation_on_negative_tail_data(rng):
    # lower-upper tail dependent, negative tau: clayton90 data
    th = v._theta_from_tau("clayton90", -0.5)
    ww = rng.uniform(1e-6, 1 - 1e-6, (1500, 2))
    us = np.asarray(
        v._HINV["clayton90"](jnp.asarray(ww[:, 1]), jnp.asarray(ww[:, 0]),
                             th)
    )
    fam, theta, tau = v._fit_pair(jnp.asarray(us), jnp.asarray(ww[:, 0]))
    assert tau < -0.4
    assert fam in ("clayton90", "clayton270")  # rotated, not gauss/frank
    assert fam == "clayton90"  # AIC resolves the corner correctly
    assert abs(theta - 2.0) < 0.35


def test_bivariate_copula_rotated_families(rng):
    from corrla_rs_tpu.ops.copula import BivariateCopula

    th = v._theta_from_tau("gumbel90", -0.5)
    ww = rng.uniform(1e-6, 1 - 1e-6, (1500, 2))
    u0 = np.asarray(
        v._HINV["gumbel90"](jnp.asarray(ww[:, 1]), jnp.asarray(ww[:, 0]),
                            th)
    )
    x = np.stack([u0, ww[:, 0]], axis=1)
    m = BivariateCopula("gumbel90").fit(x)
    assert m.tau < -0.4
    s = np.asarray(m.sample(1500, key=2))
    tau_s = float(kendall_tau(s[:1500, 0], s[:1500, 1]))
    assert abs(tau_s - m.tau) < 0.09
    # base gumbel on negative-tau data raises with a rotation hint
    with pytest.raises(ValueError, match="90/270"):
        BivariateCopula("gumbel").fit(x)


def _markov_chain_data(rng, n=1500):
    z = rng.standard_normal((n, 4))
    x0 = z[:, 0]
    x1 = 0.9 * x0 + np.sqrt(1 - 0.81) * z[:, 1]
    x2 = 0.85 * x1 + np.sqrt(1 - 0.7225) * z[:, 2]
    x3 = 0.8 * x2 + np.sqrt(1 - 0.64) * z[:, 3]
    return np.stack([x0, x1, x2, x3], axis=1)


@pytest.mark.slow
def test_rvine_recovers_markov_chain_structure(rng):
    data = _markov_chain_data(rng)
    m = RVineCopula().fit(data)
    # tree 1 must be the chain 0-1-2-3 (the three strongest pairs)
    t1 = {frozenset((a, b)) for (a, b, _c, _f, _t) in m.trees[0]}
    assert t1 == {frozenset((0, 1)), frozenset((1, 2)), frozenset((2, 3))}
    for (_a, _b, _c, fam, _th) in m.trees[0]:
        # the near-gaussian Student-t grid members (nu >= 8) can
        # legitimately edge out gaussian by AIC on n=1500 rank-transformed
        # gaussian data; any of the three is a correct elliptical call
        assert fam in ("gaussian", "t8", "t15"), fam
    # deeper trees: conditional independence detected
    for lvl in m.trees[1:]:
        for (_a, _b, _c, fam, _th) in lvl:
            assert fam == "independent"


@pytest.mark.slow
def test_rvine_sampling_roundtrips_tau(rng):
    data = _markov_chain_data(rng)
    m = RVineCopula().fit(data)
    s = np.asarray(m.sample(1500, key=1))
    assert s.shape == (1500, 4)
    for (i, j) in [(0, 1), (1, 2), (2, 3), (0, 3)]:
        td = float(kendall_tau(data[:1500, i], data[:1500, j]))
        ts = float(kendall_tau(s[:1500, i], s[:1500, j]))
        assert abs(td - ts) < 0.09, (i, j, td, ts)


@pytest.mark.slow
def test_rvine_matches_cvine_on_cvine_data(rng):
    # star dependence (all through variable 0) IS a C-vine; the R-vine
    # learner must find the star and match the C-vine's density
    n = 1500
    z = rng.standard_normal((n, 4))
    x0 = z[:, 0]
    xs = [x0] + [
        0.8 * x0 + np.sqrt(1 - 0.64) * z[:, j] for j in range(1, 4)
    ]
    data = np.stack(xs, axis=1)
    mr = RVineCopula().fit(data)
    t1 = {frozenset((a, b)) for (a, b, _c, _f, _t) in mr.trees[0]}
    assert t1 == {frozenset((0, j)) for j in range(1, 4)}

    mc = v.CVineCopula().fit(data)
    # compare log-density on held-out uniforms
    u = rng.uniform(0.05, 0.95, (500, 4))
    lr = np.asarray(mr.logpdf_uniform(u))
    # CVine has no public logpdf; compare first-tree taus instead
    s_r = np.asarray(mr.sample(3000, key=5))
    s_c = np.asarray(mc.sample(3000, key=5))
    for j in range(1, 4):
        tr = float(kendall_tau(s_r[:2000, 0], s_r[:2000, j]))
        tc = float(kendall_tau(s_c[:2000, 0], s_c[:2000, j]))
        assert abs(tr - tc) < 0.07, (j, tr, tc)
    assert np.all(np.isfinite(lr))


@pytest.mark.slow
def test_rvine_negative_dependence_lower_tail(rng):
    # negative/opposite-tail dependence used to fall
    # back to gaussian/frank; now the rotated family must win in-vine
    n = 2000
    th = v._theta_from_tau("clayton90", -0.55)
    ww = rng.uniform(1e-6, 1 - 1e-6, (n, 2))
    u01 = np.asarray(
        v._HINV["clayton90"](jnp.asarray(ww[:, 1]), jnp.asarray(ww[:, 0]),
                             th)
    )
    extra = rng.uniform(0, 1, n)
    data = np.stack([u01, ww[:, 0], extra], axis=1)
    m = RVineCopula().fit(data)
    fams = {(a, b): f for (a, b, _c, f, _t) in m.trees[0]}
    fam01 = fams.get((0, 1), fams.get((1, 0)))
    assert fam01 is not None and fam01.startswith("clayton")
    assert fam01.endswith(("90", "270"))


@pytest.mark.slow
def test_rvine_truncation(rng):
    data = _markov_chain_data(rng)
    m = RVineCopula(truncate_level=1).fit(data)
    for lvl in m.trees[1:]:
        for (_a, _b, _c, fam, th) in lvl:
            assert fam == "independent" and th == 0.0
    s = np.asarray(m.sample(1000, key=3))
    assert np.all(np.isfinite(s))


@pytest.mark.slow
def test_rvine_checkpoint_roundtrip(rng, tmp_path):
    from corrla_rs_tpu.utils.checkpoint import load_model, save_model

    data = _markov_chain_data(rng, n=800)
    m = RVineCopula().fit(data)
    p = str(tmp_path / "rvine.npz")
    save_model(p, m)
    m2 = load_model(p)
    assert m2.trees == m.trees
    s1 = np.asarray(m.sample(500, key=9))
    s2 = np.asarray(m2.sample(500, key=9))
    np.testing.assert_allclose(s2, s1, atol=1e-12)


def test_rvine_validates_input(rng):
    with pytest.raises(ValueError, match="at least 2"):
        RVineCopula().fit(rng.standard_normal((50, 1)))
