"""On-device nonsymmetric eigendecomposition (ops/eig_device).

The reference's only nonsymmetric eigensolve is faer's host LAPACK-class
``Eigendecomposition<c64>`` (reference dmd_rom.rs:112-125); this module
tests the rebuild's pure-JAX Francis-QR replacement, which has no
reference analogue (jit/vmap-safe, complex-free).

Main suite runs f64 on the faked-CPU backend (machine-precision oracles vs
numpy LAPACK); an f32 lane lives in tests/test_f32_smoke.py and a GPU
lane (``-m gpu``) in the subprocess test below.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from corrla_rs_tpu.ops.eig_device import (
    eig_device,
    eigvals_device,
    hessenberg,
    schur,
)
from corrla_rs_tpu.ops.mat_utils import pinv_comp_parts


def _sorted_complex(re, im):
    return np.sort_complex(np.asarray(re) + 1j * np.asarray(im))


def _fixtures(rng):
    import scipy.linalg as sla

    ths = rng.uniform(0.1, 3.0, 8)
    rs = rng.uniform(0.5, 2.0, 8)
    blocks = [
        r * np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
        for t, r in zip(ths, rs)
    ]
    qq, _ = np.linalg.qr(rng.standard_normal((16, 16)))
    return {
        "randn12": rng.standard_normal((12, 12)),
        "diag8": np.diag(np.arange(1.0, 9.0)),
        "rotations16": qq @ sla.block_diag(*blocks) @ qq.T,
        "jordan10": np.eye(10) * 2.0 + np.diag(np.ones(9), 1),
        "repeated12": np.kron(np.eye(4), rng.standard_normal((3, 3))),
        "scaled": 1e6 * rng.standard_normal((9, 9)),
        "tiny2": rng.standard_normal((2, 2)),
        "one1": rng.standard_normal((1, 1)),
    }


def test_hessenberg_properties(rng):
    a = jnp.asarray(rng.standard_normal((15, 15)))
    h, q = hessenberg(a)
    h, q = np.asarray(h), np.asarray(q)
    assert np.max(np.abs(np.tril(h, -2))) == 0.0
    np.testing.assert_allclose(q.T @ q, np.eye(15), atol=1e-13)
    np.testing.assert_allclose(q @ h @ q.T, np.asarray(a), atol=1e-12)


def test_schur_properties(rng):
    for name, a_np in _fixtures(rng).items():
        a = jnp.asarray(a_np)
        n = a.shape[0]
        t, q, ok = schur(a)
        t, q = np.asarray(t), np.asarray(q)
        scale = max(np.max(np.abs(a_np)), 1.0)
        assert bool(ok), name
        np.testing.assert_allclose(
            q.T @ q, np.eye(n), atol=1e-12, err_msg=name
        )
        np.testing.assert_allclose(
            q @ t @ q.T, a_np, atol=1e-12 * scale, err_msg=name
        )
        if n > 2:
            assert np.max(np.abs(np.tril(t, -2))) == 0.0, name


def test_eigvals_match_numpy(rng):
    for name, a_np in _fixtures(rng).items():
        lam = _sorted_complex(*eigvals_device(jnp.asarray(a_np)))
        ref = np.sort_complex(np.linalg.eigvals(a_np))
        scale = max(np.max(np.abs(ref)), 1e-30)
        # jordan10's eigenvalue is defective (condition ~eps^(-9/10));
        # numpy agrees with us only to the same intrinsic limit
        tol = 5e-2 if name == "jordan10" else 1e-11
        np.testing.assert_allclose(
            lam / scale, ref / scale, atol=tol, err_msg=name
        )


@pytest.mark.slow
def test_eigenvectors_satisfy_eigen_equation(rng):
    for name, a_np in _fixtures(rng).items():
        lr, li, vr, vi = eig_device(jnp.asarray(a_np))
        lam = np.asarray(lr) + 1j * np.asarray(li)
        v = np.asarray(vr) + 1j * np.asarray(vi)
        scale = max(np.max(np.abs(a_np)), 1.0)
        resid = np.max(np.abs(a_np @ v - v * lam[None, :]))
        assert resid < 1e-11 * scale, (name, resid)
        # unit columns
        np.testing.assert_allclose(
            np.linalg.norm(v, axis=0), np.ones(a_np.shape[0]), atol=1e-12,
            err_msg=name,
        )


def test_eig_device_real_eigenvectors_are_real(rng):
    # symmetric matrix: all eigenvalues real -> eigenvectors come out with
    # zero imaginary part (the inverse-iteration start is zeroed there)
    a_np = rng.standard_normal((9, 9))
    a_np = a_np + a_np.T
    lr, li, vr, vi = eig_device(jnp.asarray(a_np))
    assert np.max(np.abs(np.asarray(li))) == 0.0
    assert np.max(np.abs(np.asarray(vi))) == 0.0


def test_eig_device_under_jit_and_vmap(rng):
    batch = jnp.asarray(rng.standard_normal((5, 8, 8)))
    f = jax.jit(jax.vmap(eigvals_device))
    blr, bli = f(batch)
    for i in range(5):
        lam = _sorted_complex(blr[i], bli[i])
        ref = np.sort_complex(np.linalg.eigvals(np.asarray(batch[i])))
        np.testing.assert_allclose(lam, ref, atol=1e-11)


def test_schur_reports_convergence_flag(rng):
    a = jnp.asarray(rng.standard_normal((12, 12)))
    _t, _q, ok = schur(a, max_iters=1)   # 1 sweep cannot deflate 12 eigs
    assert not bool(ok)
    _t, _q, ok = schur(a)
    assert bool(ok)


def test_pinv_comp_parts_matches_numpy(rng):
    xr = rng.standard_normal((10, 4))
    xi = rng.standard_normal((10, 4))
    pr, pi = pinv_comp_parts(jnp.asarray(xr), jnp.asarray(xi))
    p = np.asarray(pr) + 1j * np.asarray(pi)
    ref = np.linalg.pinv(xr + 1j * xi)
    np.testing.assert_allclose(p, ref, atol=1e-12)
    # rank-deficient: cutoff zeroes the junk direction instead of blowing up
    xr_low = np.concatenate([xr[:, :2], xr[:, :2]], axis=1)
    xi_low = np.concatenate([xi[:, :2], xi[:, :2]], axis=1)
    pr, pi = pinv_comp_parts(jnp.asarray(xr_low), jnp.asarray(xi_low))
    ref = np.linalg.pinv(xr_low + 1j * xi_low)
    np.testing.assert_allclose(
        np.asarray(pr) + 1j * np.asarray(pi), ref, atol=1e-11
    )


def test_dmdc_device_eig_backend_matches_host():
    from corrla_rs_tpu.models.dmd import DMDc
    from corrla_rs_tpu.ops.mat_utils import mat_linspace

    x = mat_linspace(0.0, 10.0, 20)[:, 0]
    t = mat_linspace(0.0, 10.0, 40)[:, 0]
    u = jnp.exp(0.2 * t)[None, :]
    p = jnp.sin(x[:, None] + 0.2 * t[None, :]) * u

    m_host = DMDc(p, u, n_modes=6, n_iters=40)
    m_dev = DMDc(p, u, n_modes=6, n_iters=40, eig_backend="device")
    np.testing.assert_allclose(
        np.sort_complex(m_dev.lambdas), np.sort_complex(m_host.lambdas),
        atol=1e-9,
    )
    x0 = p[:, 0:1]
    pred_h = np.asarray(m_host.predict_multiple(x0, u, method="modes"))
    pred_d = np.asarray(m_dev.predict_multiple(x0, u, method="modes"))
    scale = np.max(np.abs(pred_h))
    np.testing.assert_allclose(pred_d / scale, pred_h / scale, atol=1e-8)


@pytest.mark.gpu
def test_eig_device_on_product_backend_subprocess(gpu_device):
    # eig_device runs jitted on the GPU, the default backend of a fresh
    # process on a host with a card. Residual tolerance is f32 QR-grade.
    import os
    import subprocess
    import sys

    script = (
        "from corrla_rs_tpu.utils.cache import enable_persistent_cache\n"
        "enable_persistent_cache()\n"
        "import numpy as np\n"
        "import jax, jax.numpy as jnp\n"
        "from corrla_rs_tpu.ops.eig_device import eig_device\n"
        "a = np.random.default_rng(0).standard_normal((12, 12))\n"
        "lr, li, vr, vi = jax.jit(eig_device)(jnp.asarray(a, jnp.float32))\n"
        "lam = np.asarray(lr) + 1j * np.asarray(li)\n"
        "v = np.asarray(vr) + 1j * np.asarray(vi)\n"
        "resid = np.abs(a @ v - v * lam[None, :]).max()\n"
        "assert resid < 1e-4, resid\n"
        "ref = np.sort_complex(np.linalg.eigvals(a))\n"
        "err = np.abs(np.sort_complex(lam) - ref).max() / np.abs(ref).max()\n"
        "assert err < 1e-4, err\n"
        "print('EIG_DEVICE_OK')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", script], capture_output=True,
        text=True, timeout=900,
        env={k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"},
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "EIG_DEVICE_OK" in res.stdout


def test_dmdc_eig_backend_validation():
    from corrla_rs_tpu.models.dmd import DMDc

    with pytest.raises(ValueError, match="eig_backend"):
        DMDc(jnp.ones((4, 5)), jnp.ones((1, 5)), 2, 2, eig_backend="nope")


@pytest.mark.slow
def test_dmdc_fit_ensemble_matches_single():
    from corrla_rs_tpu.models.dmd import (
        DMDc, dmdc_fit_ensemble, rollout_ensemble,
    )
    from corrla_rs_tpu.ops.mat_utils import mat_linspace
    import jax

    x = mat_linspace(0.0, 10.0, 20)[:, 0]
    t = mat_linspace(0.0, 10.0, 40)[:, 0]
    u = jnp.exp(0.2 * t)[None, :]
    base = jnp.sin(x[:, None] + 0.2 * t[None, :]) * u
    rng = np.random.default_rng(6)
    batch = jnp.stack(
        [base + 1e-3 * jnp.asarray(rng.standard_normal(base.shape)) * float(i)
         for i in range(3)]
    )
    u_batch = jnp.broadcast_to(u, (3,) + u.shape)

    fit = dmdc_fit_ensemble(batch, u_batch, n_modes=6, n_iters=40, key=9)
    assert fit["lambdas_re"].shape == (3, 6)
    assert fit["modes_re"].shape == (3, 20, 6)

    # member 0 (unperturbed) spectra match a single device-backend fit with
    # the same per-member key
    k0 = jax.random.split(jnp.asarray(
        jax.random.key(9) if hasattr(jax.random, "key") else 9), 3)[0]
    m0 = DMDc(base, u, n_modes=6, n_iters=40, key=k0, eig_backend="device")
    lam_b = np.sort_complex(
        np.asarray(fit["lambdas_re"][0]) + 1j * np.asarray(fit["lambdas_im"][0])
    )
    np.testing.assert_allclose(
        lam_b, np.sort_complex(m0.lambdas), atol=1e-9
    )

    # every member's rollout tracks its own (slightly perturbed) truth
    x0 = batch[:, :, 0:1]
    pred = rollout_ensemble(fit, x0, u, method="reduced")
    assert pred.shape == (3, 20, 40)
    err = np.abs(np.asarray(pred[:, :, 19]) - np.asarray(batch[:, :, 20]))
    assert err.max() < 5e-2  # reference tolerance dmd_rom.rs:309

    # the 'modes' (eigendynamics) rollout is a different operator
    # representation than 'reduced' — on noisy members they agree only to
    # model error; each must track the truth, and member 0 must match the
    # single-model factored rollout exactly (same pipeline)
    pred_m = rollout_ensemble(fit, x0, u, method="modes")
    err_m = np.abs(np.asarray(pred_m[:, :, 19]) - np.asarray(batch[:, :, 20]))
    assert err_m.max() < 5e-2
    single_m = m0.predict_multiple(base[:, 0:1], u, method="modes")
    np.testing.assert_allclose(
        np.asarray(pred_m[0]), np.asarray(single_m),
        atol=1e-8 * float(jnp.max(jnp.abs(single_m))),
    )


def test_dmdc_fit_ensemble_validation():
    from corrla_rs_tpu.models.dmd import dmdc_fit_ensemble

    with pytest.raises(ValueError, match="batches"):
        dmdc_fit_ensemble(jnp.ones((4, 5)), jnp.ones((1, 5)), 2, 2)


def test_balancing_recovers_graded_matrix(rng):
    # D A D^-1 with 12 orders of magnitude of grading: the unbalanced QR
    # iteration is hopeless (measured rel err ~1e3); exact power-of-two
    # balancing recovers machine precision (LAPACK xGEEV behavior)
    n = 12
    base = rng.standard_normal((n, n))
    d = 10.0 ** np.linspace(-6, 6, n)
    graded = (d[:, None] * base) / d[None, :]
    ref = np.sort_complex(np.linalg.eigvals(base))

    lr, li = eigvals_device(jnp.asarray(graded), balance=False)
    err_raw = np.abs(_sorted_complex(lr, li) - ref).max() / np.abs(ref).max()
    lr, li = eigvals_device(jnp.asarray(graded), balance=True)
    err_bal = np.abs(_sorted_complex(lr, li) - ref).max() / np.abs(ref).max()
    assert err_bal < 1e-11
    assert err_bal < err_raw * 1e-6

    # eigenvectors of the graded matrix satisfy the eigen equation too
    lr, li, vr, vi = eig_device(jnp.asarray(graded))
    lam = np.asarray(lr) + 1j * np.asarray(li)
    v = np.asarray(vr) + 1j * np.asarray(vi)
    resid = np.abs(graded @ v - v * lam[None, :]).max()
    assert resid < 1e-9 * np.abs(graded).max()


def test_non_convergence_poisons_with_nan(rng):
    # max_iters too small -> NaN eigenvalues, never plausible garbage
    a = jnp.asarray(rng.standard_normal((12, 12)))
    lr, li = eigvals_device(a, max_iters=1)
    assert np.isnan(np.asarray(lr)).all()
    assert np.isnan(np.asarray(li)).all()
    lr, li = eigvals_device(a)
    assert np.isfinite(np.asarray(lr)).all()


def test_batched_stack_auto_vmaps(rng):
    b = jnp.asarray(rng.standard_normal((3, 7, 7)))
    lr, li = eigvals_device(b)
    assert lr.shape == (3, 7)
    lr2, li2, vr, vi = eig_device(b)
    assert vr.shape == (3, 7, 7)
    for i in range(3):
        lam = _sorted_complex(lr[i], li[i])
        ref = np.sort_complex(np.linalg.eigvals(np.asarray(b[i])))
        np.testing.assert_allclose(lam, ref, atol=1e-11)
        lamc = np.asarray(lr2[i]) + 1j * np.asarray(li2[i])
        vc = np.asarray(vr[i]) + 1j * np.asarray(vi[i])
        resid = np.abs(np.asarray(b[i]) @ vc - vc * lamc[None, :]).max()
        assert resid < 1e-11


@pytest.mark.parametrize("mult", [2, 3])
@pytest.mark.parametrize("trial", [0, 1, 2])
def test_eig_device_clustered_eigenvalues_orthonormal(mult, trial):
    # multiplicity-m eigenvalues must yield an
    # orthonormal eigenbasis (not m copies of the dominant direction).
    # Symmetric case: exactly semisimple, LAPACK-comparable.
    rng = np.random.default_rng(100 + trial)
    n = 10
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    vals = np.concatenate([
        np.full(mult, 2.0),
        np.linspace(1.0, 0.2, n - mult),
    ])
    a = (q * vals) @ q.T
    lr, li, vr, vi = eig_device(jnp.asarray(a))
    lam = np.asarray(lr) + 1j * np.asarray(li)
    v = np.asarray(vr) + 1j * np.asarray(vi)
    # eigen residual for every vector
    resid = np.abs(a @ v - v * lam[None, :]).max()
    assert resid < 1e-8, resid
    # cluster members must be mutually orthonormal: smallest singular
    # value of the cluster block well away from 0 (dependent vectors
    # would give ~0)
    members = np.where(np.abs(lam - 2.0) < 1e-6)[0]
    assert len(members) == mult
    sv = np.linalg.svd(v[:, members], compute_uv=False)
    assert sv[-1] > 0.9, sv
    # and they span the true eigenspace (principal angles ~ 0)
    true_basis = q[:, :mult]
    overlap = np.linalg.svd(true_basis.T @ v[:, members],
                            compute_uv=False)
    assert overlap[-1] > 1 - 1e-8


def test_eig_device_clustered_nonsymmetric():
    # diagonalizable non-normal matrix with a double eigenvalue
    rng = np.random.default_rng(7)
    n = 8
    s = rng.standard_normal((n, n)) + 3.0 * np.eye(n)  # cond ~ moderate
    vals = np.array([1.5, 1.5, 1.0, 0.7, 0.5, 0.3, 0.2, 0.1])
    a = s @ np.diag(vals) @ np.linalg.inv(s)
    lr, li, vr, vi = eig_device(jnp.asarray(a))
    lam = np.asarray(lr) + 1j * np.asarray(li)
    v = np.asarray(vr) + 1j * np.asarray(vi)
    resid = np.abs(a @ v - v * lam[None, :]).max() / np.abs(vals).max()
    assert resid < 1e-7, resid
    members = np.where(np.abs(lam - 1.5) < 1e-6)[0]
    assert len(members) == 2
    # linearly independent members (orthogonalized in the solver, so the
    # pair is orthonormal even though the matrix is non-normal)
    sv = np.linalg.svd(v[:, members], compute_uv=False)
    assert sv[-1] > 0.9, sv
    # spans the same invariant subspace as LAPACK's eigenvectors
    wl, vl = np.linalg.eig(a)
    ml = np.where(np.abs(wl - 1.5) < 1e-8)[0]
    bl = np.linalg.qr(vl[:, ml])[0]
    overlap = np.linalg.svd(bl.conj().T @ v[:, members],
                            compute_uv=False)
    assert overlap[-1] > 1 - 1e-7


def test_eig_device_distinct_eigs_unaffected_by_orthogonalization():
    # well-separated spectrum: the cluster mask is empty and results
    # must match LAPACK exactly as before
    rng = np.random.default_rng(3)
    a = rng.standard_normal((9, 9))
    lr, li, vr, vi = eig_device(jnp.asarray(a))
    lam = np.asarray(lr) + 1j * np.asarray(li)
    v = np.asarray(vr) + 1j * np.asarray(vi)
    resid = np.abs(a @ v - v * lam[None, :]).max()
    assert resid < 1e-9
    ref = np.sort_complex(np.linalg.eigvals(a))
    np.testing.assert_allclose(np.sort_complex(lam), ref, atol=1e-9)
