"""DMDc parity tests (fixture from reference dmd_rom.rs:228-311)."""
import jax.numpy as jnp
import numpy as np
import pytest

from corrla_rs_tpu.models.dmd import DMDc
from corrla_rs_tpu.ops.eig import eig
from corrla_rs_tpu.ops.mat_utils import mat_linspace
from corrla_rs_tpu.utils.testing import assert_mat_approx_eq


def _sine_fixture(nx, nt):
    # Forced sine field with exponentially growing control,
    # parity with dmd_rom.rs:243-267.
    x = mat_linspace(0.0, 10.0, nx)[:, 0]
    t = mat_linspace(0.0, 10.0, nt)[:, 0]
    u = jnp.exp(0.2 * t)[None, :]                      # (1, nt)
    p = jnp.sin(x[:, None] + 0.2 * t[None, :]) * u     # (nx, nt)
    return p, u


@pytest.mark.parametrize("nx,nt", [(20, 40), (50, 40), (200, 40)])
def test_dmdc_prediction(nx, nt):
    p, u = _sine_fixture(nx, nt)
    model = DMDc(p, u, n_modes=14, n_iters=40)

    a_op = model.est_a_til()
    b_op = model.est_b_til()
    assert a_op.shape == (nx, nx)
    assert b_op.shape == (nx, 1)
    assert model.lambdas.shape == (14,)

    x0 = p[:, 0:1]
    pred = model.predict_multiple(x0, u)
    # 20th snapshot vs 19th prediction (0th state was the IC), tol 5e-2
    # matching dmd_rom.rs:309.
    assert_mat_approx_eq(pred[:, 19:20], p[:, 20:21], 5e-2)


def test_dmdc_single_step_matches_rollout():
    p, u = _sine_fixture(20, 40)
    model = DMDc(p, u, n_modes=14, n_iters=40)
    x0 = p[:, 0:1]
    one = model.predict(x0, u[:, 0:1])
    many = model.predict_multiple(x0, u)
    assert_mat_approx_eq(one[:, 0], many[:, 0], 1e-9)


def test_eig_matches_numpy(rng):
    a = jnp.asarray(rng.standard_normal((12, 12)))
    vals, vecs = eig(a)
    vals_np = np.linalg.eigvals(np.asarray(a))
    # compare as sorted complex sets
    np.testing.assert_allclose(
        np.sort_complex(np.asarray(vals)), np.sort_complex(vals_np), rtol=1e-9
    )
    # eigen equation holds
    resid = np.asarray(a) @ np.asarray(vecs) - np.asarray(vecs) * np.asarray(
        vals
    )
    assert np.abs(resid).max() < 1e-9


def test_eig_under_jit(rng):
    import jax

    a = jnp.asarray(rng.standard_normal((6, 6)))
    vals, _ = jax.jit(eig)(a)
    vals_np = np.linalg.eigvals(np.asarray(a))
    np.testing.assert_allclose(
        np.sort_complex(np.asarray(vals)), np.sort_complex(vals_np), rtol=1e-9
    )


def test_eig_host_and_support_probe(rng):
    from corrla_rs_tpu.ops.eig import eig_host, jittable_eig_supported

    a = rng.standard_normal((8, 8))
    vals, vecs = eig_host(a)
    assert isinstance(vals, np.ndarray) and np.iscomplexobj(vals)
    resid = a @ vecs - vecs * vals
    assert np.abs(resid).max() < 1e-9
    # CPU backend supports the jittable callback path
    assert jittable_eig_supported("cpu") is True


@pytest.mark.gpu
def test_eig_on_product_backend_subprocess(gpu_device):
    # eig() must work (eagerly) on the GPU, the default backend of a fresh
    # process on a host with a card.
    import os
    import subprocess
    import sys

    script = (
        "import numpy as np\n"
        "from corrla_rs_tpu.ops.eig import eig\n"
        "a = np.random.default_rng(0).standard_normal((9, 9))\n"
        "vals, vecs = eig(a)\n"
        "resid = np.abs(np.asarray(a) @ np.asarray(vecs)"
        " - np.asarray(vecs) * np.asarray(vals)).max()\n"
        "assert resid < 1e-6, resid\n"
        "print('EIG_OK')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=600,
        env={k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"},
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "EIG_OK" in res.stdout


def test_mat_pinv_comp_parity_and_cutoff(rng):
    from corrla_rs_tpu.ops.mat_utils import mat_pinv_comp

    x = rng.standard_normal((6, 4)) + 1j * rng.standard_normal((6, 4))
    # reference mode on a full-rank input matches numpy pinv
    p_ref = mat_pinv_comp(x, eps=1e-16, mode="reference")
    np.testing.assert_allclose(p_ref, np.linalg.pinv(x), atol=1e-10)
    # Moore-Penrose identity
    np.testing.assert_allclose(x @ p_ref @ x, x, atol=1e-10)
    # rank-deficient input: reference mode blows up (parity with
    # mat_utils.rs:56-71 semantics), cutoff mode stays bounded
    xd = np.concatenate([x[:, :2], x[:, :2]], axis=1)  # rank 2
    p_blow = mat_pinv_comp(xd, eps=1e-16, mode="reference")
    p_cut = mat_pinv_comp(xd, eps=1e-10, mode="cutoff")
    assert np.abs(p_blow).max() > 1e12
    assert np.abs(p_cut).max() < 1e3
    np.testing.assert_allclose(xd @ p_cut @ xd, xd, atol=1e-8)


def test_factored_rollout_matches_dense():
    p, u = _sine_fixture(50, 40)
    model = DMDc(p, u, n_modes=14, n_iters=40)
    x0 = p[:, 0:1]
    dense = model.predict_multiple(x0, u)
    fact = model.predict_multiple(x0, u, method="modes")
    assert_mat_approx_eq(fact, dense, 1e-6)


def test_dmdc_multiple_control_inputs():
    # n_u = 2 control rows (the reference supports arbitrary n_u,
    # dmd_rom.rs:49). The snapshot family has numerical rank 2, so the
    # well-posed fit uses n_modes <= rank; the over-parameterized fit must
    # stay bounded (the reference's additive-eps complex pinv explodes to
    # 1e26+ there — our rank-cutoff pinv keeps it finite).
    nx, nt = 40, 50
    x = np.linspace(0, 10, nx)
    t = np.linspace(0, 10, nt)
    u = np.stack([np.exp(0.15 * t), np.sin(0.5 * t) + 2.0])  # (2, nt)
    snaps = (
        np.sin(x[:, None] + 0.2 * t[None, :]) * u[0][None, :]
        + 0.3 * np.cos(x[:, None]) * u[1][None, :]
    )
    model = DMDc(jnp.asarray(snaps), jnp.asarray(u), 4, 30)
    assert model.n_u == 2
    assert model.est_b_til().shape == (nx, 2)
    x0 = jnp.asarray(snaps[:, 0:1])
    pred = model.predict_multiple(x0, jnp.asarray(u))
    assert_mat_approx_eq(pred[:, 19:20], snaps[:, 20:21], 5e-2)

    over = DMDc(jnp.asarray(snaps), jnp.asarray(u), 12, 30)
    pred_over = over.predict_multiple(x0, jnp.asarray(u))
    assert bool(jnp.all(jnp.isfinite(pred_over)))
    assert float(jnp.max(jnp.abs(pred_over))) < 1e3  # bounded, no blow-up

def test_reduced_rollout_matches_dense():
    # the eig-free on-device rollout (method='reduced') agrees with the
    # eigendecomposition-based dense rollout on the reference fixture
    p, u = _sine_fixture(50, 40)
    model = DMDc(p, u, n_modes=14, n_iters=40)
    x0 = p[:, 0:1]
    dense = model.predict_multiple(x0, u)
    red = model.predict_multiple(x0, u, method="reduced")
    assert_mat_approx_eq(red[:, :25], dense[:, :25], 1e-4)
    # and it is accurate vs truth at the reference tolerance
    assert_mat_approx_eq(red[:, 19:20], p[:, 20:21], 5e-2)


def _autonomous_fixture(n_x=24, n_t=60):
    # known linear dynamics: damped rotations + a decaying mode
    rng = np.random.default_rng(11)
    q, _ = np.linalg.qr(rng.standard_normal((n_x, n_x)))
    th1, th2 = 0.35, 0.12
    blocks = [
        0.98 * np.array([[np.cos(th1), -np.sin(th1)],
                         [np.sin(th1), np.cos(th1)]]),
        0.92 * np.array([[np.cos(th2), -np.sin(th2)],
                         [np.sin(th2), np.cos(th2)]]),
        np.diag([0.85]),
    ]
    import scipy.linalg as sla

    core = sla.block_diag(*blocks)
    a_true = q[:, :5] @ core @ q[:, :5].T + 1e-3 * np.eye(n_x)
    x = np.zeros((n_x, n_t))
    x[:, 0] = q[:, :5] @ rng.standard_normal(5)
    for k in range(1, n_t):
        x[:, k] = a_true @ x[:, k - 1]
    return x, a_true


@pytest.mark.parametrize("backend", ["host", "device"])
def test_plain_dmd_recovers_spectrum_and_predicts(backend):
    from corrla_rs_tpu.models.dmd import DMD

    x, a_true = _autonomous_fixture()
    m = DMD(jnp.asarray(x), n_modes=5, n_iters=20, eig_backend=backend)
    # the 5 dynamic eigenvalues of a_true restricted to the trajectory
    # subspace (the rest of a_true's spectrum is the 1e-3 floor)
    lam_fit = np.sort_complex(m.lambdas)
    ref = np.linalg.eigvals(a_true)
    ref5 = np.sort_complex(ref[np.argsort(-np.abs(ref))[:5]])
    np.testing.assert_allclose(lam_fit, ref5, atol=1e-6)
    # rollout continues the trajectory
    for meth in ("modes", "reduced"):
        pred = np.asarray(m.predict_multiple(x[:, 0:1], 30, method=meth))
        np.testing.assert_allclose(
            pred, x[:, 1:31], atol=1e-6 * np.abs(x).max(), err_msg=meth
        )
    # reconstruction matches the training data
    rec = np.asarray(m.reconstruct())
    np.testing.assert_allclose(rec, x[:, 1:], atol=1e-6 * np.abs(x).max())
    # continuous-time eigenvalues: growth rates negative (stable system)
    ct = m.eigs_continuous(dt=0.1)
    assert np.all(ct.real < 0)


def test_plain_dmd_validates():
    from corrla_rs_tpu.models.dmd import DMD

    with pytest.raises(ValueError, match="eig_backend"):
        DMD(jnp.ones((4, 6)), 2, eig_backend="gpu")
    x, _ = _autonomous_fixture()
    m = DMD(jnp.asarray(x), 3)
    with pytest.raises(ValueError, match="method"):
        m.predict_multiple(jnp.asarray(x[:, 0:1]), 5, method="banana")
