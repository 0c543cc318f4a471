"""Multi-chip tests on the faked 8-device CPU backend.

The multi-chip correctness story (SURVEY.md §4): sharded kernels must match
their single-device counterparts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from corrla_rs_tpu.ops.random_svd import random_svd
from corrla_rs_tpu.ops.samplers import ln_like_sum, ln_prior_uniform
from corrla_rs_tpu.parallel.mesh import (
    CHAINS_AXIS,
    make_mesh,
    row_sharding,
    shard_rows,
)
from corrla_rs_tpu.parallel.sharded_rsvd import sharded_random_svd
from corrla_rs_tpu.parallel.sharded_samplers import demc_run_sharded


def _require_8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")


def test_mesh_and_sharding():
    _require_8()
    mesh = make_mesh(8)
    assert mesh.devices.size == 8
    a = jnp.ones((16, 4))
    a_sh = shard_rows(a, mesh)
    assert a_sh.sharding == row_sharding(mesh)


def test_sharded_rsvd_matches_single_device(rng):
    _require_8()
    mesh = make_mesh(8)
    a = jnp.asarray(rng.standard_normal((240, 32)))
    u_s, s_s, vt_s = sharded_random_svd(a, 5, 10, 8, key=0, mesh=mesh)
    # exact singular values from LAPACK as ground truth
    s_exact = np.linalg.svd(np.asarray(a), compute_uv=False)[:5]
    np.testing.assert_allclose(np.asarray(s_s), s_exact, rtol=1e-3)
    # and the single-device rsvd agrees at the same tolerance
    _u1, s_1, _vt1 = random_svd(a, 5, 10, 8, key=0, stabilize="always")
    np.testing.assert_allclose(np.asarray(s_s), np.asarray(s_1), rtol=1e-3)


def test_sharded_rsvd_f32_sigma_parity(rng):
    # Multi-chip f32 sigma parity, same bar as the single-chip Householder
    # final QR (< 1e-6): on an exactly rank-16 matrix whose spectrum fits
    # the sketch, RSVD is exact up to arithmetic, so the residual sigma
    # error isolates the final distributed TSQR's floating-point quality.
    _require_8()
    n, m, r = 800, 64, 16
    uu = np.linalg.qr(rng.standard_normal((n, r)))[0]
    vv = np.linalg.qr(rng.standard_normal((m, r)))[0]
    sig = 10.0 * 0.7 ** np.arange(r)
    a64 = (uu * sig) @ vv.T
    mesh = make_mesh(8)
    _u, s32, _vt = sharded_random_svd(
        jnp.asarray(a64, jnp.float32), 8, 10, 8, key=0, mesh=mesh
    )
    s_exact = np.linalg.svd(a64, compute_uv=False)[:8]
    rel = np.max(np.abs(np.asarray(s32, np.float64) - s_exact) / s_exact)
    assert rel < 1e-6, rel


def test_sharded_rsvd_reconstruction_lowrank(rng):
    _require_8()
    mesh = make_mesh(8)
    b = rng.standard_normal((160, 6)) @ rng.standard_normal((6, 40))
    a = jnp.asarray(b)
    u, s, vt = sharded_random_svd(a, 6, 10, 8, key=1, mesh=mesh)
    recon = np.asarray(u) @ np.diag(np.asarray(s)) @ np.asarray(vt)
    np.testing.assert_allclose(recon, b, atol=1e-7)


def test_sharded_rsvd_output_sharded(rng):
    _require_8()
    mesh = make_mesh(8)
    a = jnp.asarray(rng.standard_normal((80, 16)))
    u, _s, _vt = sharded_random_svd(a, 3, 6, 5, key=0, mesh=mesh)
    assert u.shape == (80, 3)
    # U comes back row-sharded over the mesh
    assert u.sharding.spec[0] == mesh.axis_names[0]


def test_sharded_rsvd_validates_shapes(rng):
    _require_8()
    mesh = make_mesh(8)
    with pytest.raises(ValueError):
        sharded_random_svd(jnp.ones((10, 20)), 2, 4, 4, mesh=mesh)  # fat
    with pytest.raises(ValueError):
        sharded_random_svd(jnp.ones((30, 4)), 2, 4, 4, mesh=mesh)  # 30 % 8


def test_sharded_demc_gaussian():
    _require_8()
    mesh = make_mesh(8, axis_name=CHAINS_AXIS)
    mu, std = 2.0, 3.0

    def lnp_like(x):
        return -0.5 * ((x[0] - mu) / std) ** 2 - jnp.log(std)

    lnp = ln_like_sum(lnp_like, ln_prior_uniform(np.array([[-20.0, 20.0]])))
    heads0 = jnp.zeros((16, 1))  # 2 chains per device
    hist, final_heads, ar = demc_run_sharded(
        heads0, lnp, 1600, gamma=0.8, var_epsilon=1e-10, key=0, mesh=mesh
    )
    assert hist.shape == (1600, 16, 1)
    assert final_heads.shape == (16, 1)
    tail = np.asarray(hist[-800:]).reshape(-1)
    assert abs(tail.mean() - mu) < 5e-1
    assert abs(tail.std(ddof=1) - std) < 5e-1
    assert ar > 0.2


def test_sharded_pca_matches_single(rng):
    _require_8()
    import jax.numpy as jnp

    from corrla_rs_tpu import PcaRsvd

    mesh = make_mesh(8)
    x = jnp.asarray(rng.standard_normal((800, 16)))
    p1 = PcaRsvd(x, 4)
    p2 = PcaRsvd(x, 4, mesh=mesh)
    np.testing.assert_allclose(
        np.asarray(p2.singular_values), np.asarray(p1.singular_values),
        rtol=1e-6,
    )


def test_sharded_pod_matches_single(rng):
    _require_8()
    import jax.numpy as jnp

    from corrla_rs_tpu import PodI

    mesh = make_mesh(8)
    nx, ns = 400, 12
    xg = np.linspace(0, 10, nx)
    tg = np.linspace(1, 9, ns)[:, None]
    p = jnp.asarray((0.5 * tg) * np.exp(-((xg[None, :] - tg) ** 2) / 4.0))
    t = jnp.asarray(tg)
    pod1 = PodI(p, t, 4)
    pod2 = PodI(p, t, 4, mesh=mesh)
    tq = jnp.array([[5.0]])
    # modes have sign freedom; compare predictions
    np.testing.assert_allclose(
        np.asarray(pod2.predict(tq)), np.asarray(pod1.predict(tq)),
        rtol=1e-5, atol=1e-8,
    )


def test_sharded_active_subspace_matches_single(rng):
    # Component 6 long-axis scaling: N sample/query axis sharded, support
    # replicated, psum'd C reduction via GSPMD.
    _require_8()
    from corrla_rs_tpu.models.active_subspaces import (
        ActiveSsRsvd,
        PolyGradientEstimator,
    )

    mesh = make_mesh(8)
    n, k = 160, 3
    x = rng.uniform(-1.0, 1.0, (n, k))
    y = 0.1 * x[:, 0] + 5.0 * x[:, 1] + 0.3 * x[:, 2] + 2.0 * x[:, 1] ** 2
    ge = PolyGradientEstimator(jnp.asarray(x), jnp.asarray(y), 2, 16)
    est = ActiveSsRsvd(ge, 2)
    f1 = est.fit(jnp.asarray(x))
    f2 = est.fit(jnp.asarray(x), mesh=mesh)
    np.testing.assert_allclose(
        np.asarray(f2.singular_vals), np.asarray(f1.singular_vals),
        rtol=1e-8,
    )
    np.testing.assert_allclose(
        np.abs(np.asarray(f2.components)), np.abs(np.asarray(f1.components)),
        atol=1e-8,
    )
    np.testing.assert_allclose(
        np.asarray(f2.var_diag_evd_sensi()),
        np.asarray(f1.var_diag_evd_sensi()), rtol=1e-8,
    )
    # the dominant direction is x2 (largest variability)
    assert int(np.abs(np.asarray(f2.components)[:, 0]).argmax()) == 1
    # fit_svd path too
    s1 = est.fit_svd(jnp.asarray(x), key=2)
    s2 = est.fit_svd(jnp.asarray(x), key=2, mesh=mesh)
    np.testing.assert_allclose(
        np.diagonal(np.asarray(s2.singular_vals_)),
        np.diagonal(np.asarray(s1.singular_vals_)), rtol=1e-6,
    )
    with pytest.raises(ValueError, match="divide the mesh"):
        est.fit(jnp.asarray(x[:156]), mesh=mesh)


def test_sharded_dream_gaussian():
    _require_8()
    import jax.numpy as jnp

    from corrla_rs_tpu.parallel.sharded_samplers import dream_run_sharded

    mesh = make_mesh(8, axis_name=CHAINS_AXIS)
    mu, std = 2.0, 3.0

    def lnp(x):
        return -0.5 * ((x[0] - mu) / std) ** 2

    heads0 = jnp.linspace(-1, 1, 16)[:, None]  # 16 chains, 2 per device
    hist, final_heads, ar = dream_run_sharded(
        heads0, lnp, 1600, key=0, n_adapt=300, mesh=mesh
    )
    assert hist.shape == (1600, 16, 1)
    tail = np.asarray(hist[-800:]).reshape(-1)
    assert abs(tail.mean() - mu) < 5e-1
    assert abs(tail.std(ddof=1) - std) < 5e-1
    assert ar > 0.15


def test_sharded_stats_autopartition(rng):
    # Data-parallel stats come free from GSPMD: pearson on a row-sharded
    # matrix equals the unsharded result.
    _require_8()
    import jax
    import jax.numpy as jnp

    from corrla_rs_tpu.ops.stats_corr import mat_cov_centered, pearson_corr

    mesh = make_mesh(8)
    x = jnp.asarray(rng.standard_normal((4000, 6)))
    x_sh = shard_rows(x, mesh)
    p1 = pearson_corr(x)
    p2 = jax.jit(pearson_corr)(x_sh)
    np.testing.assert_allclose(np.asarray(p2), np.asarray(p1), atol=1e-10)
    c1 = mat_cov_centered(x)
    c2 = jax.jit(mat_cov_centered)(x_sh)
    np.testing.assert_allclose(np.asarray(c2), np.asarray(c1), atol=1e-10)


def test_sharded_nll_matches_single(rng):
    # SURVEY §2.2 row 4: the reference's Rayon-parallel NLL reduction maps
    # to a vectorized logpdf sum that GSPMD reduces with a psum when the
    # samples are row-sharded.
    _require_8()
    import jax

    from corrla_rs_tpu import NormalRv

    mesh = make_mesh(8)
    rv = NormalRv(2.0, 3.0)
    x = jnp.asarray(rng.normal(2.0, 3.0, (4000,)))
    n1 = rv.nll(x)
    x_sh = jax.device_put(
        x, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("rows"))
    )
    n2 = jax.jit(rv.nll)(x_sh)
    np.testing.assert_allclose(float(n2), float(n1), rtol=1e-12)


def test_sharded_dmdc_matches_single():
    _require_8()
    import jax.numpy as jnp

    from corrla_rs_tpu import DMDc

    mesh = make_mesh(8)
    nx, nt = 160, 30
    xg = np.linspace(0, 10, nx)
    tg = np.linspace(0, 10, nt)
    u = np.exp(0.2 * tg)[None, :].astype(np.float32)
    snaps = (np.sin(xg[:, None] + 0.2 * tg[None, :]) * u).astype(np.float32)
    m1 = DMDc(jnp.asarray(snaps), jnp.asarray(u), 8, 20, key=3)
    m2 = DMDc(jnp.asarray(snaps), jnp.asarray(u), 8, 20, key=3, mesh=mesh)
    # Tighter-than-rollout operator checks. Raw A~ is
    # basis-dependent: the fixture is effectively rank ~4, so the sketch's
    # junk directions are arbitrary and rotate under the sharded reduction
    # order. Compare basis-INVARIANT quantities instead:
    # (a) the dominant DMD eigenvalues (the fixture's growing oscillation —
    # the conjugate pair; trailing lambdas live in the junk subspace),
    lam1 = np.asarray(m1.lambdas)
    lam2 = np.asarray(m2.lambdas)
    top1 = lam1[np.argsort(-np.abs(lam1))][:2]
    top2 = lam2[np.argsort(-np.abs(lam2))][:2]
    np.testing.assert_allclose(
        np.sort_complex(top2), np.sort_complex(top1), rtol=1e-4
    )
    # (b) one application of the full-state (A, B) operators to a state ON
    # the data manifold (a mid-trajectory snapshot) — no rollout
    # compounding; the operators are only identifiable there (a random
    # state excites the junk subspace, where any two fits legitimately
    # disagree).
    v = jnp.asarray(snaps[:, 12:13])
    w = jnp.asarray(u[:, 12:13])
    one1 = np.asarray(m1.predict(v, w))
    one2 = np.asarray(m2.predict(v, w))
    scale = np.abs(one1).max()
    np.testing.assert_allclose(one2, one1, atol=2e-3 * scale)
    # and it matches the actual next snapshot (physics check, no rollout)
    np.testing.assert_allclose(one1[:, 0], snaps[:, 13], atol=5e-2)
    x0 = jnp.asarray(snaps[:, 0:1])
    p1 = m1.predict_multiple(x0, jnp.asarray(u))
    p2 = m2.predict_multiple(x0, jnp.asarray(u))
    np.testing.assert_allclose(
        np.asarray(p2), np.asarray(p1), rtol=1e-2, atol=1e-2
    )
    # both accurate vs truth at the reference tolerance
    np.testing.assert_allclose(
        np.asarray(p2)[:, 19], snaps[:, 20], atol=5e-2
    )


def test_sharded_dmdc_rejects_nondivisible():
    from corrla_rs_tpu import DMDc

    _require_8()
    mesh = make_mesh(8)
    snaps = np.random.default_rng(0).standard_normal((30, 10)).astype(np.float32)
    u = np.ones((1, 10), np.float32)
    with pytest.raises(ValueError, match="divide the mesh"):
        DMDc(jnp.asarray(snaps), jnp.asarray(u), 4, 8, mesh=mesh)


def test_sharded_single_pass_svd_matches_single(rng):
    # single_pass_svd is pure matmul + small QR/solve/SVD: GSPMD
    # partitions it for free when A arrives row-sharded. Same answer as
    # the replicated run (identical sketch => identical arithmetic up to
    # reduction order).
    _require_8()
    from corrla_rs_tpu.ops.random_svd import single_pass_svd

    mesh = make_mesh(8)
    b = rng.standard_normal((640, 9)) @ rng.standard_normal((9, 120))
    a = jnp.asarray(b)
    u1, s1, vt1 = single_pass_svd(a, 9, 8, key=5)
    u2, s2, vt2 = single_pass_svd(shard_rows(a, mesh), 9, 8, key=5)
    np.testing.assert_allclose(np.asarray(s2), np.asarray(s1), rtol=1e-9)
    rec = np.asarray(u2) @ np.diag(np.asarray(s2)) @ np.asarray(vt2)
    np.testing.assert_allclose(rec, b, atol=1e-8)


@pytest.mark.slow
def test_sharded_sparse_gp_matches_single(rng):
    # SGPR's heavy factors (K_mn solve, A A^T via tall-skinny QR, A y) are
    # matmul/QR-shaped over the sample axis: GSPMD partitions them when
    # the training data arrives row-sharded. Same answer as replicated.
    _require_8()
    from jax.sharding import NamedSharding, PartitionSpec as P

    from corrla_rs_tpu.ops.gp import SparseGpRegressor

    mesh = make_mesh(8)
    n = 512
    x = np.sort(rng.uniform(0, 6, n))[:, None]
    y = np.sin(2 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    sp1 = SparseGpRegressor("rbf", inducing=24, key=3).fit(
        jnp.asarray(x), jnp.asarray(y)
    )
    y_sh = jax.device_put(jnp.asarray(y), NamedSharding(mesh, P("rows")))
    sp2 = SparseGpRegressor("rbf", inducing=24, key=3).fit(
        shard_rows(jnp.asarray(x), mesh), y_sh
    )
    xq = jnp.asarray(np.linspace(0.3, 5.7, 21)[:, None])
    m1, v1 = sp1.predict(xq)
    m2, v2 = sp2.predict(xq)
    np.testing.assert_allclose(np.asarray(m2), np.asarray(m1), atol=1e-7)
    np.testing.assert_allclose(np.asarray(v2), np.asarray(v1), atol=1e-9)


def test_member_sharded_ensemble_dmdc(rng):
    # the ensemble (vmap) axis is embarrassingly parallel: members shard
    # across the mesh via GSPMD (each device fits its own DMDc models,
    # incl. the batched Francis-QR eig), same answer as replicated
    _require_8()
    from jax.sharding import NamedSharding, PartitionSpec as P

    from corrla_rs_tpu.models.dmd import dmdc_fit_ensemble, rollout_ensemble
    from corrla_rs_tpu.ops.mat_utils import mat_linspace

    x = mat_linspace(0.0, 10.0, 20)[:, 0]
    t = mat_linspace(0.0, 10.0, 40)[:, 0]
    u = jnp.exp(0.2 * t)[None, :]
    base = jnp.sin(x[:, None] + 0.2 * t[None, :]) * u
    B = 8
    batch = base[None] + 1e-3 * jnp.asarray(
        rng.standard_normal((B,) + base.shape)
    )
    u_b = jnp.broadcast_to(u, (B,) + u.shape)
    fit1 = dmdc_fit_ensemble(batch, u_b, n_modes=6, n_iters=15, key=4)

    mesh = make_mesh(8)
    sh = NamedSharding(mesh, P("rows"))
    fit2 = dmdc_fit_ensemble(
        jax.device_put(batch, sh), jax.device_put(jnp.asarray(u_b), sh),
        n_modes=6, n_iters=15, key=4,
    )
    np.testing.assert_allclose(
        np.asarray(fit2["lambdas_re"]), np.asarray(fit1["lambdas_re"]),
        atol=1e-12,
    )
    pred = rollout_ensemble(fit2, batch[:, :, 0:1], u, method="reduced")
    err = np.abs(np.asarray(pred[:, :, 19]) - np.asarray(batch[:, :, 20]))
    assert err.max() < 5e-2


def test_sharded_hosvd_matches_single_device(rng):
    _require_8()
    from corrla_rs_tpu.ops.hosvd import hosvd, tucker_reconstruct
    from corrla_rs_tpu.parallel.sharded_hosvd import sharded_hosvd

    mesh = make_mesh(8)
    # multilinear-rank (3, 2, 2) tensor, long axis 0 divisible by 8
    g = rng.standard_normal((3, 2, 2))
    u0 = np.linalg.qr(rng.standard_normal((160, 3)))[0]
    u1 = np.linalg.qr(rng.standard_normal((6, 2)))[0]
    u2 = np.linalg.qr(rng.standard_normal((5, 2)))[0]
    t = np.einsum("abc,ia,jb,kc->ijk", g, u0, u1, u2)
    t = t + 1e-9 * rng.standard_normal(t.shape)

    core_s, fac_s = sharded_hosvd(t, (3, 2, 2), mesh=mesh)
    assert core_s.shape == (3, 2, 2)
    assert fac_s[0].shape == (160, 3)
    for f, r in zip(fac_s, (3, 2, 2)):
        np.testing.assert_allclose(
            np.asarray(f).T @ np.asarray(f), np.eye(r), atol=1e-8
        )
    core_m, fac_m = hosvd(jnp.asarray(t), (3, 2, 2))
    rec_s = np.asarray(tucker_reconstruct(core_s, fac_s))
    rec_m = np.asarray(tucker_reconstruct(core_m, fac_m))
    np.testing.assert_allclose(rec_s, rec_m, atol=1e-7)
    np.testing.assert_allclose(rec_s, t, atol=1e-7)


def test_sharded_hosvd_validates(rng):
    _require_8()
    from corrla_rs_tpu.parallel.sharded_hosvd import sharded_hosvd

    mesh = make_mesh(8)
    with pytest.raises(ValueError, match="divide"):
        sharded_hosvd(rng.standard_normal((42, 3, 2)), (2, 2, 2),
                      mesh=mesh)
    with pytest.raises(ValueError, match="long"):
        sharded_hosvd(rng.standard_normal((16, 30, 2)), (2, 2, 2),
                      mesh=mesh)


def test_sharded_hosvd_mode0_rank_validated(rng):
    _require_8()
    from corrla_rs_tpu.parallel.sharded_hosvd import sharded_hosvd

    mesh = make_mesh(8)
    with pytest.raises(ValueError, match="prod"):
        sharded_hosvd(rng.standard_normal((160, 2, 2)), (8, 2, 2),
                      mesh=mesh)


@pytest.mark.slow
def test_sharded_stretch_gaussian():
    """Walker-sharded stretch sampler recovers a Gaussian on the
    8-device mesh (statistical; the exact-contract check stays in the
    default lane below)."""
    from corrla_rs_tpu.parallel.sharded_samplers import stretch_run_sharded

    _require_8()
    mesh = make_mesh(8, axis_name=CHAINS_AXIS)
    mu = jnp.array([1.5, -2.0])
    sig = jnp.array([0.7, 1.3])

    def lnp(x):
        return -0.5 * jnp.sum(((x - mu) / sig) ** 2)

    w0 = jax.random.normal(jax.random.key(0), (32, 2), jnp.float64)
    hist, final_w, ar = stretch_run_sharded(w0, lnp, 2500, key=1,
                                            mesh=mesh)
    assert hist.shape == (2500, 32, 2)
    assert final_w.shape == (32, 2)
    tail = np.asarray(hist[800:]).reshape(-1, 2)
    np.testing.assert_allclose(tail.mean(0), np.asarray(mu), atol=0.12)
    np.testing.assert_allclose(tail.std(0), np.asarray(sig), atol=0.12)
    assert 0.2 < ar < 0.9


def test_sharded_stretch_invariance():
    """The sharded stretch sampler's bit-exact power-of-two affine
    equivariance (same collectives, scaled state) — the cheap exact
    contract kept in the default lane."""
    from corrla_rs_tpu.parallel.sharded_samplers import stretch_run_sharded

    _require_8()
    mesh = make_mesh(8, axis_name=CHAINS_AXIS)
    w0 = jax.random.normal(jax.random.key(0), (32, 2), jnp.float64)
    # bit-exact diagonal affine equivariance survives the sharded path
    scale = jnp.array([4.0, 0.5])
    inv = jnp.array([0.25, 2.0])

    def lnp_iso(x):
        return -0.5 * jnp.sum(x ** 2)

    def lnp_skew(y):
        return -0.5 * jnp.sum((y * inv) ** 2)

    h1, _, _ = stretch_run_sharded(w0, lnp_iso, 100, key=2, mesh=mesh)
    h2, _, _ = stretch_run_sharded(w0 * scale, lnp_skew, 100, key=2,
                                   mesh=mesh)
    np.testing.assert_array_equal(np.asarray(h2), np.asarray(h1 * scale))

    with pytest.raises(ValueError, match="divide"):
        stretch_run_sharded(jnp.zeros((6, 2)), lnp_iso, 3, mesh=mesh)


def test_sharded_hmc_matches_single():
    """HMC chains are independent: the mesh= path is pure GSPMD data
    parallelism. The adapted step size differs only at float-rounding
    level (the dual-averaging statistic is a cross-chain sum whose
    order reassociates under sharding), and the sampled distribution
    matches statistically."""
    from corrla_rs_tpu.ops.hmc import hmc_run

    _require_8()
    mesh = make_mesh(8, axis_name=CHAINS_AXIS)
    sig = jnp.asarray([0.5, 2.0])

    def lnp(x):
        return -0.5 * jnp.sum((x / sig) ** 2)

    x0 = jax.random.normal(jax.random.key(3), (16, 2), jnp.float64)
    r1 = hmc_run(x0, lnp, n_steps=200, n_warmup=100, key=4)
    r2 = hmc_run(x0, lnp, n_steps=200, n_warmup=100, key=4, mesh=mesh)
    assert r2.step_size == pytest.approx(r1.step_size, rel=0.15)
    t1 = np.asarray(r1.history[50:]).reshape(-1, 2)
    t2 = np.asarray(r2.history[50:]).reshape(-1, 2)
    np.testing.assert_allclose(t2.std(0), np.asarray(sig), rtol=0.25)
    np.testing.assert_allclose(t2.std(0), t1.std(0), rtol=0.15)
    with pytest.raises(ValueError, match="divide"):
        hmc_run(jnp.zeros((6, 2)), lnp, 5, mesh=mesh)


# ---------------------------------------------------------------------------
# Ensemble-axis families sharded over the mesh
# ---------------------------------------------------------------------------


def test_sharded_enkf_analysis_matches_single():
    """Member-sharded stochastic EnKF: same key => same perturbations,
    so the sharded analysis must equal the single-device one at
    reduction-order (f64) tolerance."""
    from corrla_rs_tpu.ops.enkf import enkf_analysis

    _require_8()
    mesh = make_mesh(8)
    rng = np.random.default_rng(0)
    n_ens, n, p = 32, 24, 3
    x_ens = jnp.asarray(rng.standard_normal((n_ens, n)))
    h = jnp.asarray(rng.standard_normal((p, n)))
    y = jnp.asarray(rng.standard_normal(p))
    key = jax.random.key(5)
    a1 = enkf_analysis(x_ens, y, h, 0.3, key)
    a2 = enkf_analysis(x_ens, y, h, 0.3, key, mesh=mesh)
    np.testing.assert_allclose(np.asarray(a2), np.asarray(a1),
                               rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError, match="divide"):
        enkf_analysis(x_ens[:6], y, h, 0.3, key, mesh=mesh)


def test_sharded_etkf_matches_single():
    from corrla_rs_tpu.ops.enkf import etkf_analysis

    _require_8()
    mesh = make_mesh(8)
    rng = np.random.default_rng(1)
    n_ens, n, p = 16, 40, 4
    x_ens = jnp.asarray(rng.standard_normal((n_ens, n)))
    h = jnp.asarray(rng.standard_normal((p, n)))
    y = jnp.asarray(rng.standard_normal(p))
    a1 = etkf_analysis(x_ens, y, h, 0.5)
    a2 = etkf_analysis(x_ens, y, h, 0.5, mesh=mesh)
    np.testing.assert_allclose(np.asarray(a2), np.asarray(a1),
                               rtol=1e-10, atol=1e-12)


def test_sharded_enkf_filter_matches_single():
    from corrla_rs_tpu.ops.enkf import enkf_filter

    _require_8()
    mesh = make_mesh(8)
    rng = np.random.default_rng(2)
    a = 0.9 * np.eye(3) + 0.05 * rng.standard_normal((3, 3))
    aj = jnp.asarray(a)
    h = jnp.asarray(np.eye(3)[:2])
    ys = jnp.asarray(rng.standard_normal((12, 2)))
    x0 = jnp.asarray(rng.standard_normal((16, 3)))
    key = jax.random.key(9)
    r1 = enkf_filter(x0, ys, lambda x: aj @ x, h, 0.2, key,
                     method="etkf", inflation=1.02)
    r2 = enkf_filter(x0, ys, lambda x: aj @ x, h, 0.2, key,
                     method="etkf", inflation=1.02, mesh=mesh)
    np.testing.assert_allclose(np.asarray(r2["means"]),
                               np.asarray(r1["means"]),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(r2["spread"]),
                               np.asarray(r1["spread"]),
                               rtol=1e-9, atol=1e-11)


def test_sharded_esmda_matches_single():
    from corrla_rs_tpu.ops.enkf import esmda

    _require_8()
    mesh = make_mesh(8)
    rng = np.random.default_rng(3)
    g = jnp.asarray(rng.standard_normal((5, 4)))  # linear forward
    theta_true = jnp.asarray(rng.standard_normal(4))
    y = g @ theta_true
    x0 = jnp.asarray(rng.standard_normal((24, 4)))
    key = jax.random.key(11)
    r1 = esmda(x0, lambda th: g @ th, y, 0.05, key, n_mda=4)
    r2 = esmda(x0, lambda th: g @ th, y, 0.05, key, n_mda=4, mesh=mesh)
    np.testing.assert_allclose(np.asarray(r2["ensemble"]),
                               np.asarray(r1["ensemble"]),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(r2["data_misfit"], r1["data_misfit"],
                               rtol=1e-8)


def test_sharded_smc_matches_single():
    """Particle-sharded SMC: same keys drive the identical math; the
    ESS/evidence reductions reassociate, so parity is f64-tight on the
    ladder/evidence and on the final population."""
    from corrla_rs_tpu.ops.smc import smc_sample

    _require_8()
    mesh = make_mesh(8, axis_name=CHAINS_AXIS)
    rng = np.random.default_rng(4)
    mu = jnp.asarray([1.0, -0.5])

    def ln_like(x):
        return -0.5 * jnp.sum((x - mu) ** 2) / 0.3**2

    def ln_prior(x):
        return -0.5 * jnp.sum(x**2 / 4.0)

    init = jnp.asarray(rng.standard_normal((128, 2)) * 2.0)
    r1 = smc_sample(ln_like, ln_prior, init, n_mcmc=3, key=7)
    r2 = smc_sample(ln_like, ln_prior, init, n_mcmc=3, key=7, mesh=mesh)
    assert r2.n_stages == r1.n_stages
    np.testing.assert_allclose(np.asarray(r2.betas),
                               np.asarray(r1.betas), atol=1e-9)
    assert r2.log_evidence == pytest.approx(r1.log_evidence, abs=1e-8)
    np.testing.assert_allclose(np.asarray(r2.particles),
                               np.asarray(r1.particles),
                               rtol=1e-8, atol=1e-10)
    with pytest.raises(ValueError, match="divide"):
        smc_sample(ln_like, ln_prior, init[:6], key=7, mesh=mesh)


def test_sharded_nuts_matches_single():
    """NUTS chains are independent: the mesh= path is pure GSPMD data
    parallelism (same contract as hmc_run's). The cross-chain
    dual-averaging statistic reassociates, so parity is statistical."""
    from corrla_rs_tpu.ops.nuts import nuts_run

    _require_8()
    mesh = make_mesh(8, axis_name=CHAINS_AXIS)
    sig = jnp.asarray([0.5, 2.0])

    def lnp(x):
        return -0.5 * jnp.sum((x / sig) ** 2)

    x0 = jax.random.normal(jax.random.key(3), (16, 2), jnp.float64)
    r1 = nuts_run(x0, lnp, n_steps=150, n_warmup=100, key=4)
    r2 = nuts_run(x0, lnp, n_steps=150, n_warmup=100, key=4, mesh=mesh)
    assert r2.step_size == pytest.approx(r1.step_size, rel=0.15)
    t1 = np.asarray(r1.history[25:]).reshape(-1, 2)
    t2 = np.asarray(r2.history[25:]).reshape(-1, 2)
    np.testing.assert_allclose(t2.std(0), np.asarray(sig), rtol=0.25)
    np.testing.assert_allclose(t2.std(0), t1.std(0), rtol=0.2)
    with pytest.raises(ValueError, match="divide"):
        nuts_run(jnp.zeros((6, 2)), lnp, 5, mesh=mesh)


def test_sharded_cma_matches_single():
    """CMA-ES mesh= population-shards the candidate evaluations; the
    distribution updates are replicated, so the sharded run is the SAME
    deterministic algorithm — identical up to float reassociation in
    the fitness gather (f64: tight tolerance)."""
    from corrla_rs_tpu.ops.cma import cma_es

    _require_8()
    mesh = make_mesh(8)

    def rosen(x):
        return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                       + (1.0 - x[:-1]) ** 2)

    x0 = jnp.asarray([-1.2, 1.0, 0.7], jnp.float64)
    r1 = cma_es(rosen, x0, sigma0=0.4, n_gens=120, pop_size=16, key=5)
    r2 = cma_es(rosen, x0, sigma0=0.4, n_gens=120, pop_size=16, key=5,
                mesh=mesh)
    np.testing.assert_allclose(np.asarray(r2.x_best),
                               np.asarray(r1.x_best), rtol=1e-8, atol=1e-8)
    assert r2.f_best == pytest.approx(r1.f_best, rel=1e-8, abs=1e-10)
    assert r2.f_best < 1e-3  # actually optimizes
    with pytest.raises(ValueError, match="divide"):
        cma_es(rosen, x0, n_gens=5, pop_size=6, mesh=mesh)
    with pytest.raises(ValueError, match="traceable"):
        cma_es(lambda p: float(np.sum(p**2)), np.zeros(3), n_gens=5,
               pop_size=16, mesh=mesh)


def test_sharded_gmm_matches_single():
    """Row-sharded GMM EM: the E-step density matrix is shard-local and
    the M-step sufficient statistics (nk, resp.T @ x, weighted Grams)
    are psum'd — same keys, so parity is reduction-order f64 tight."""
    from corrla_rs_tpu.ops.gmm import gmm_fit

    _require_8()
    mesh = make_mesh(8)
    rng = np.random.default_rng(6)
    centers = np.array([[-3.0, 0.0], [3.0, 0.0], [0.0, 4.0]])
    x = np.concatenate([
        rng.standard_normal((80, 2)) * 0.5 + c for c in centers
    ])
    f1 = gmm_fit(x, 3, key=2, n_iter=60)
    f2 = gmm_fit(x, 3, key=2, n_iter=60, mesh=mesh)
    np.testing.assert_allclose(np.asarray(f2.means),
                               np.asarray(f1.means),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(f2.weights),
                               np.asarray(f1.weights),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(f2.covs), np.asarray(f1.covs),
                               rtol=1e-7, atol=1e-9)
    assert float(f2.log_likelihood) == pytest.approx(
        float(f1.log_likelihood), rel=1e-9)
    with pytest.raises(ValueError, match="divide"):
        gmm_fit(x[:6], 2, mesh=mesh)


def test_sharded_particle_filter_matches_single():
    """Particle-sharded bootstrap filter: propagation/likelihoods are
    shard-local, evidence/ESS psum to scalars, and the systematic
    resample gathers the (N,) weights — same keys => f64 parity."""
    from corrla_rs_tpu.ops.particle import particle_filter

    _require_8()
    mesh = make_mesh(8)
    rng = np.random.default_rng(7)
    n_part, t_len = 64, 15
    ys = jnp.asarray(rng.standard_normal((t_len, 1)))
    x0 = jnp.asarray(rng.standard_normal((n_part, 1)))

    def propagate(k, x):
        return 0.8 * x + 0.3 * jax.random.normal(k, x.shape, x.dtype)

    def loglik(x, y):
        return -0.5 * jnp.sum((y - x) ** 2) / 0.25

    key = jax.random.key(3)
    r1 = particle_filter(x0, ys, propagate, loglik, key)
    r2 = particle_filter(x0, ys, propagate, loglik, key, mesh=mesh)
    np.testing.assert_allclose(np.asarray(r2["means"]),
                               np.asarray(r1["means"]),
                               rtol=1e-9, atol=1e-11)
    assert r2["loglik"] == pytest.approx(r1["loglik"], rel=1e-9)
    np.testing.assert_allclose(np.asarray(r2["ess"]),
                               np.asarray(r1["ess"]), rtol=1e-9)
    with pytest.raises(ValueError, match="divide"):
        particle_filter(x0[:6], ys, propagate, loglik, key, mesh=mesh)
