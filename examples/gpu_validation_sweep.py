"""On-chip validation sweep: one f32 run of each family on the GPU.

Runs each family ONCE on the GPU at small-but-honest shapes and asserts
f32 sanity against a float64 oracle computed in-process with numpy.
CPU-green is not GPU-correct for f32 numerics (an f32 matmul without a
stated precision runs as TF32 on the GPU), so every family must execute
on the card.

Output: one markdown table row per family (wall, error metric, PASS/FAIL).
Exit code 1 if any family fails, 3 if JAX finds no GPU.
``CORRLA_SWEEP_ALLOW_CPU=1`` runs the stages on the CPU instead (a
shake-out of the script itself; its numbers say nothing about the GPU).

Usage:  timeout 1800 python examples/gpu_validation_sweep.py [stage ...]
"""
from __future__ import annotations

import os
import sys
import time
import traceback

# runnable as `python examples/gpu_validation_sweep.py` from the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from corrla_rs_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import numpy as np


def _require_gpu() -> None:
    import jax

    if os.environ.get("CORRLA_SWEEP_ALLOW_CPU"):
        # shake-out mode: must be set before the first backend use
        jax.config.update("jax_platforms", "cpu")
        return
    plat = jax.devices()[0].platform
    if plat != "gpu":
        print(f"validation sweep: default backend is {plat!r}, not a GPU",
              file=sys.stderr)
        raise SystemExit(3)


RESULTS = []


def stage(name):
    def deco(fn):
        fn._stage_name = name
        RESULTS.append(fn)
        return fn
    return deco


# ---------------------------------------------------------------------------
# fixtures (numpy f64 ground truth; f32 copies go to the device)
# ---------------------------------------------------------------------------
RNG = np.random.default_rng(42)


def lowrank(n, m, r, noise=0.0):
    a = RNG.standard_normal((n, r)) @ RNG.standard_normal((r, m))
    if noise:
        a += noise * RNG.standard_normal((n, m))
    return a


@stage("streaming gram/cov")
def s_streaming_gram():
    from corrla_rs_tpu.ops.streaming import streamed_cov, streamed_gram

    a = lowrank(4096, 24, 8, 0.1)
    g, _sums, _n = streamed_gram(a.astype(np.float32), block_rows=1024)
    g = np.asarray(g)
    cov = np.asarray(streamed_cov(a.astype(np.float32), block_rows=1024))
    g_ref = a.T @ a
    c_ref = np.cov(a, rowvar=False)
    return max(
        np.max(np.abs(g - g_ref)) / np.max(np.abs(g_ref)),
        np.max(np.abs(cov - c_ref)) / np.max(np.abs(c_ref)),
    ), 1e-4


@stage("streaming power-iter rsvd")
def s_streaming_rsvd():
    from corrla_rs_tpu.ops.streaming import streamed_random_svd

    a = lowrank(4096, 32, 6)
    _u, s, _vt = streamed_random_svd(
        a.astype(np.float32), 4, 6, 4, key=1, block_rows=1024
    )
    s_ref = np.linalg.svd(a, compute_uv=False)[:4]
    return float(np.max(np.abs(np.asarray(s) - s_ref) / s_ref)), 1e-4


@stage("streaming single-pass svd")
def s_streaming_single_pass():
    from corrla_rs_tpu.ops.streaming import streamed_single_pass_svd

    a = lowrank(4096, 32, 4)
    _u, s, _vt = streamed_single_pass_svd(
        a.astype(np.float32), 4, 8, key=2, block_rows=1024
    )
    s_ref = np.linalg.svd(a, compute_uv=False)[:4]
    return float(np.max(np.abs(np.asarray(s) - s_ref) / s_ref)), 5e-3


@stage("spod")
def s_spod():
    from corrla_rs_tpu.models.spod import spod

    t = np.arange(512) * 0.1
    x = np.sin(2 * np.pi * 0.5 * t)[None, :] * RNG.standard_normal(
        (16, 1)
    ) + 0.05 * RNG.standard_normal((16, 512))
    f = spod(x.astype(np.float32), n_fft=64, overlap=0.5, n_modes=2)
    e = np.asarray(f.energies)
    # the 0.5 Hz line (bin 0.5/(1/(64*0.1)) = 3.2 -> peak near bin 3)
    peak = int(np.argmax(e[:, 0]))
    ok = abs(peak - 3) <= 1 and np.all(np.isfinite(e))
    return (0.0 if ok else 1.0), 0.5


@stage("era/okid")
def s_era_okid():
    from corrla_rs_tpu.models.era import era_okid

    # stable 2-state SISO system
    a = np.array([[0.9, 0.2], [0.0, 0.7]])
    b = np.array([[1.0], [0.5]])
    c = np.array([[1.0, -0.4]])
    d = np.array([[0.1]])
    n = 400
    u = RNG.standard_normal((1, n))
    x = np.zeros((2,))
    y = np.zeros((1, n))
    for k in range(n):
        y[:, k] = c @ x + d @ u[:, k]
        x = a @ x + b @ u[:, k]
    fit = era_okid(u.astype(np.float32), y.astype(np.float32), rank=2,
                   n_markov=30)
    # compare predicted markov params (impulse response)
    a_h, b_h, c_h = (np.asarray(fit.a), np.asarray(fit.b),
                     np.asarray(fit.c))
    d_h = np.atleast_2d(np.asarray(fit.d))
    errs = [abs(float(d_h[0, 0]) - 0.1)]
    ak = np.eye(2)
    akh = np.eye(a_h.shape[0])
    for _ in range(12):
        errs.append(abs(float((c_h @ akh @ b_h).item()) - float((c @ ak @ b).item())))
        ak = a @ ak
        akh = a_h @ akh
    return float(np.max(errs)), 5e-2


@stage("kalman filter+smoother")
def s_kalman():
    from corrla_rs_tpu.ops.kalman import kalman_filter, kalman_smooth

    a = np.array([[1.0, 0.1], [0.0, 1.0]])
    b = np.zeros((2, 1))
    c = np.array([[1.0, 0.0]])
    d = np.zeros((1, 1))
    q = 0.01 * np.eye(2)
    r = np.array([[0.25]])
    n = 200
    x = np.zeros(2)
    xs = np.zeros((n, 2))
    ys = np.zeros((1, n))          # (n_y, T) layout
    for k in range(n):
        x = a @ x + RNG.multivariate_normal(np.zeros(2), q)
        xs[k] = x
        ys[0, k] = (c @ x)[0] + RNG.normal(0, 0.5)
    u = np.zeros((1, n))           # (n_u, T)
    mats = tuple(m.astype(np.float32) for m in (a, b, c, d, q, r))
    filt = kalman_filter(*mats, u.astype(np.float32),
                         ys.astype(np.float32))
    sm = kalman_smooth(*mats, u.astype(np.float32), ys.astype(np.float32))
    xf = np.asarray(filt["x_filt"])     # (n_state, T)
    xsm = np.asarray(sm["x_smooth"])
    rms_f = float(np.sqrt(np.mean((xf[0] - xs[:, 0]) ** 2)))
    rms_s = float(np.sqrt(np.mean((xsm[0] - xs[:, 0]) ** 2)))
    raw = float(np.sqrt(np.mean((ys[0] - xs[:, 0]) ** 2)))
    ok = rms_f < raw and rms_s <= rms_f * 1.05 and np.isfinite(rms_s)
    return (0.0 if ok else max(rms_f, rms_s)), 0.5


@stage("rvine fit+sample")
def s_rvine():
    from corrla_rs_tpu.ops.rvine import RVineCopula
    from corrla_rs_tpu.ops.vine import kendall_tau

    z = RNG.standard_normal((800, 3))
    x0 = z[:, 0]
    x1 = 0.85 * x0 + np.sqrt(1 - 0.7225) * z[:, 1]
    x2 = 0.8 * x1 + np.sqrt(1 - 0.64) * z[:, 2]
    data = np.stack([x0, x1, x2], axis=1).astype(np.float32)
    m = RVineCopula().fit(data)
    s = np.asarray(m.sample(1500, key=1))
    td = float(kendall_tau(data[:, 0], data[:, 1]))
    ts = float(kendall_tau(s[:, 0], s[:, 1]))
    return abs(td - ts), 0.1


@stage("cp als")
def s_cp():
    from corrla_rs_tpu.ops.cp import cp_als

    a = RNG.standard_normal((48, 3))
    b = RNG.standard_normal((6, 3))
    c = RNG.standard_normal((5, 3))
    t = np.einsum("ir,jr,kr->ijk", a, b, c)
    _w, _f, fits = cp_als(t.astype(np.float32), 3, n_sweeps=30, key=1)
    return float(1.0 - fits[-1]), 5e-3  # f32 fit floor ~1e-3


@stage("nmf hals")
def s_nmf():
    from corrla_rs_tpu.ops.nmf import nmf

    x = RNG.uniform(0, 1, (80, 4)) @ RNG.uniform(0, 1, (4, 10))
    _w, _h, errs = nmf(x.astype(np.float32), 4, n_sweeps=150, key=2)
    return float(errs[-1]), 2e-2  # HALS converges slowly; cliff detector


@stage("matrix completion")
def s_completion():
    from corrla_rs_tpu.ops.completion import matrix_complete

    m = lowrank(96, 12, 2)
    mask = RNG.uniform(size=m.shape) < 0.6
    l_hat, _u, _v, _hist = matrix_complete(
        (m * mask).astype(np.float32), mask, 2, n_sweeps=40, key=3
    )
    err = np.linalg.norm(np.asarray(l_hat) - m) / np.linalg.norm(m)
    return float(err), 5e-2


@stage("robust pca")
def s_rpca():
    from corrla_rs_tpu.ops.robust_pca import robust_pca

    l_true = lowrank(96, 12, 2)
    s_true = np.zeros_like(l_true)
    idx = RNG.choice(l_true.size, size=l_true.size // 20, replace=False)
    s_true.flat[idx] = 5.0 * RNG.standard_normal(idx.size)
    l_hat, _s, _info = robust_pca((l_true + s_true).astype(np.float32),
                                  max_iter=100, tol=1e-6)
    err = np.linalg.norm(np.asarray(l_hat) - l_true) / np.linalg.norm(l_true)
    return float(err), 1e-1  # partial recovery on this aspect; cliff detector


@stage("spdmd")
def s_spdmd():
    from corrla_rs_tpu.models.dmd import DMD
    from corrla_rs_tpu.ops.spdmd import spdmd

    t = np.linspace(0, 4 * np.pi, 60)
    x = (np.outer(np.ones(16), np.sin(t))
         + 0.5 * np.outer(np.linspace(0, 1, 16), np.cos(2 * t)))
    fit = DMD(x.astype(np.float32), n_modes=6, n_iters=20)
    out = spdmd(fit, x.astype(np.float32), gammas=np.logspace(-3, 1, 8))
    nz = np.asarray(out["nnz"])
    pl = np.asarray(out["ploss_pct"])
    ok = nz[0] >= nz[-1] and nz[0] >= 3 and np.isfinite(pl).all()
    return (0.0 if ok else 1.0), 0.5


@stage("optdmd/bop-dmd")
def s_optdmd():
    from corrla_rs_tpu.models.optdmd import bop_dmd

    t = np.linspace(0, 6, 80)
    # two distinct spatial shapes so the POD rank matches the 2 modes
    u1 = np.linspace(0.5, 1.5, 12)
    u2 = np.sin(np.linspace(0, 3, 12))
    x = (np.outer(u1, np.exp(-0.2 * t) * np.cos(3 * t))
         + np.outer(u2, np.exp(-0.2 * t) * np.sin(3 * t))
         + 0.005 * RNG.standard_normal((12, 80)))
    fit = bop_dmd(x.astype(np.float32), 2, t=t, n_members=8, key=4)
    ev = np.asarray(fit.alphas_mean).astype(complex).ravel()
    err = np.min(np.abs(ev - (-0.2 + 3j))) / np.abs(-0.2 + 3j)
    return float(err), 5e-2


@stage("mrdmd")
def s_mrdmd():
    from corrla_rs_tpu.models.mrdmd import mrdmd

    # traveling waves (sin/cos quadrature pairs with distinct spatial
    # shapes): a standing wave's oscillation lives outside the snapshot
    # column space and no exact-DMD variant can represent it
    t = np.linspace(0, 8, 256)
    xs = np.linspace(0, 1, 10)
    slow = (np.outer(np.cos(2 * xs), np.sin(0.5 * t))
            + np.outer(np.sin(2 * xs), np.cos(0.5 * t)))
    gate = (t > 4).astype(float)
    fast = 0.5 * (np.outer(xs, np.sin(20 * t) * gate)
                  + np.outer(xs[::-1], np.cos(20 * t) * gate))
    x = (slow + fast).astype(np.float32)
    # level-4 windows (16 samples): 0.628 rad/sample * 16 = 10 rad fits
    # under the 4*pi max_cycles=2 gate, so the fast pair is captured
    fit = mrdmd(x, n_modes=4, max_levels=5, max_cycles=2.0)
    rec = np.asarray(fit.reconstruct())
    err = np.linalg.norm(rec - (slow + fast)) / np.linalg.norm(slow + fast)
    return float(err), 5e-2


@stage("hankel dmd")
def s_hankel():
    from corrla_rs_tpu.models.hankel_dmd import HankelDmd

    t = np.linspace(0, 8 * np.pi, 300)
    x = np.sin(t[:260])[None, :].astype(np.float32)  # scalar series
    fit = HankelDmd(x, n_modes=2, n_delays=8, n_iters=20)
    pred = np.asarray(fit.forecast(40))
    err = np.max(np.abs(pred[0] - np.sin(t[260:300])))
    return float(err), 5e-2


@stage("online dmd")
def s_online():
    from corrla_rs_tpu.models.online_dmd import OnlineDmd

    a_true = np.array([[0.95, 0.1], [-0.1, 0.95]])
    x = np.zeros((2, 120))
    x[:, 0] = [1.0, 0.0]
    # noise keeps the Gram full-rank (a pure rotation trajectory is
    # 2-d anyway, but keep the regression honest)
    for k in range(119):
        x[:, k + 1] = a_true @ x[:, k] + 1e-3 * RNG.standard_normal(2)
    od = OnlineDmd(2)
    for k in range(119):
        od.update(x[:, k].astype(np.float32), x[:, k + 1].astype(np.float32))
    err = np.max(np.abs(np.asarray(od.a) - a_true))
    return float(err), 1e-2


@stage("aPC pce")
def s_pce():
    from corrla_rs_tpu.ops.pce import PolynomialChaos

    x = RNG.uniform(-1, 1, (300, 2))
    y = 1.0 + 2.0 * x[:, 0] + 0.5 * x[:, 0] * x[:, 1]
    pce = PolynomialChaos(order=2,
                          bounds=np.array([[-1.0, 1.0], [-1.0, 1.0]]))
    pce.fit(x.astype(np.float32), y.astype(np.float32))
    yh = np.asarray(pce.predict(x.astype(np.float32)))
    err = float(np.max(np.abs(yh - y)) / np.max(np.abs(y)))
    return err, 1e-2


@stage("sketched lstsq")
def s_sketch():
    from corrla_rs_tpu.ops.sketch_solve import sketched_lstsq

    a = RNG.standard_normal((2048, 24))
    x_true = RNG.standard_normal(24)
    b = a @ x_true
    x_hat, _hist = sketched_lstsq(a.astype(np.float32),
                                  b.astype(np.float32), key=5)
    x_hat = np.asarray(x_hat)
    return float(np.max(np.abs(x_hat.ravel() - x_true))), 1e-2


@stage("eig_device (clustered)")
def s_eig_device():
    from corrla_rs_tpu.ops.eig_device import eig_device

    # clustered eigenvalues: the round-2 hard case
    lam = np.array([2.0, 1.001, 1.0, 0.5])
    q, _ = np.linalg.qr(RNG.standard_normal((4, 4)))
    a = (q * lam) @ q.T + 0.01 * RNG.standard_normal((4, 4))
    wr, wi, _vr, _vi = eig_device(a.astype(np.float32))
    ev = np.sort_complex(np.asarray(wr) + 1j * np.asarray(wi))
    ev_ref = np.sort_complex(np.linalg.eigvals(a))
    return float(np.max(np.abs(ev - ev_ref))), 1e-2


@stage("smallpath routing")
def s_smallpath():
    import jax

    from corrla_rs_tpu.utils.smallpath import (
        maybe_route_small, set_small_path_threshold, small_path_threshold,
    )

    if jax.default_backend() == "cpu":
        return 0.0, 0.5  # routing is a no-op on CPU-only hosts
    prev = small_path_threshold()
    set_small_path_threshold(1 << 20)  # routing is off by default
    try:
        small = np.ones((8, 8), np.float32)
        (routed,) = maybe_route_small(small)
        plat = list(routed.devices())[0].platform
        ok = plat == "cpu"  # sub-threshold input must land on CPU
        big = jax.numpy.ones((2048, 1024), jax.numpy.float32)
        (kept,) = maybe_route_small(big)
        plat_big = list(kept.devices())[0].platform
        ok = ok and plat_big != "cpu"
    finally:
        set_small_path_threshold(prev)
    return (0.0 if ok else 1.0), 0.5


# ---------------------------------------------------------------------------
# further families
# ---------------------------------------------------------------------------

@stage("sindy (lorenz f32)")
def s_sindy():
    import jax
    import jax.numpy as jnp
    from jax import lax

    from corrla_rs_tpu.models.sindy import Sindy

    def lorenz(x):
        return jnp.stack([10.0 * (x[..., 1] - x[..., 0]),
                          x[..., 0] * (28.0 - x[..., 2]) - x[..., 1],
                          x[..., 0] * x[..., 1] - (8.0 / 3.0) * x[..., 2]],
                         axis=-1)

    dt = 0.002

    def step(x, _):
        k1 = lorenz(x)
        k2 = lorenz(x + 0.5 * dt * k1)
        k3 = lorenz(x + 0.5 * dt * k2)
        k4 = lorenz(x + dt * k3)
        xn = x + (dt / 6) * (k1 + 2 * k2 + 2 * k3 + k4)
        return xn, xn

    x0 = jnp.array([-8.0, 8.0, 27.0], jnp.float32)
    _, traj = jax.jit(lambda z: lax.scan(step, z, None, length=1500))(x0)
    x = jnp.concatenate([x0[None], traj])
    m = Sindy(degree=2, threshold=0.5).fit(x, x_dot=lorenz(x))
    w = np.asarray(m.coefficients_)
    idx = {nm: j for j, nm in enumerate(m.feature_names_)}
    errs = [abs(w[idx["x0"], 0] + 10.0) / 10.0,
            abs(w[idx["x0 x2"], 1] + 1.0),
            abs(w[idx["x0 x1"], 2] - 1.0),
            abs(w[idx["x2"], 2] + 8.0 / 3.0) / (8.0 / 3.0)]
    return float(max(errs)), 5e-3


@stage("stretch ensemble mcmc")
def s_stretch():
    import jax
    import jax.numpy as jnp

    from corrla_rs_tpu.ops.ensemble_mcmc import stretch_run

    mu = jnp.array([1.5, -2.0], jnp.float32)
    sig = jnp.array([0.7, 1.3], jnp.float32)

    def lnp(x):
        return -0.5 * jnp.sum(((x - mu) / sig) ** 2)

    w0 = jax.random.normal(jax.random.key(0), (512, 2), jnp.float32)
    hist, _state = stretch_run(w0, lnp, 1500, key=1)
    tail = np.asarray(hist[500:]).reshape(-1, 2)
    return float(max(np.max(np.abs(tail.mean(0) - np.asarray(mu))),
                     np.max(np.abs(tail.std(0) - np.asarray(sig))))), 0.1


@stage("tempered smc evidence")
def s_smc():
    import jax
    import jax.numpy as jnp

    from corrla_rs_tpu.ops.smc import smc_sample

    d, s0, s = 3, 2.0, 0.5

    def ln_prior(x):
        return (-0.5 * jnp.sum(x ** 2) / s0 ** 2
                - 0.5 * d * jnp.log(2 * jnp.pi * s0 ** 2))

    def ln_like(x):
        return (-0.5 * jnp.sum(x ** 2) / s ** 2
                - 0.5 * d * jnp.log(2 * jnp.pi * s ** 2))

    init = s0 * jax.random.normal(jax.random.key(2), (4096, d), jnp.float32)
    res = smc_sample(ln_like, ln_prior, init, n_mcmc=5, key=3)
    logz_true = -0.5 * d * np.log(2 * np.pi * (s0 ** 2 + s ** 2))
    return float(abs(res.log_evidence - logz_true)), 0.2


@stage("slq logdet")
def s_slq():
    from corrla_rs_tpu.ops.slq import slq_logdet

    q, _ = np.linalg.qr(RNG.standard_normal((1024, 1024)))
    eigs = np.logspace(0, -3, 1024)
    a = (q * eigs) @ q.T
    truth = float(np.linalg.slogdet(a)[1])
    est = slq_logdet(a.astype(np.float32), n_probes=24, n_lanczos=50, key=4)
    return float(abs(est - truth) / abs(truth)), 5e-3


@stage("mfmc estimator")
def s_mfmc():
    import jax
    import jax.numpy as jnp

    from corrla_rs_tpu.ops.multifidelity import mfmc_estimate

    f1 = jax.jit(lambda x: x[:, 0] ** 2)
    f2 = jax.jit(lambda x: x[:, 0] ** 2 + 0.5 * x[:, 0])

    def sample_inputs(key, n):
        return jax.random.normal(key, (n, 1), jnp.float32)

    res = mfmc_estimate([f1, f2], sample_inputs, [1.0, 0.01],
                        budget=4000.0, n_pilot=2000, key=5)
    return float(abs(res.mean - 1.0)), 0.1


@stage("opinf rom")
def s_opinf():
    import jax
    import jax.numpy as jnp
    from jax import lax

    from corrla_rs_tpu.models.opinf import OpInf, kron2_compressed

    r = 3
    rng = np.random.default_rng(7)
    c = jnp.asarray(0.1 * rng.standard_normal(r), jnp.float32)
    a = jnp.asarray(-np.eye(r) + 0.2 * rng.standard_normal((r, r)),
                    jnp.float32)
    h = jnp.asarray(0.3 * rng.standard_normal((r, r * (r + 1) // 2)),
                    jnp.float32)

    def rhs(z):
        return c + a @ z + h @ kron2_compressed(z)

    dt = 0.005

    def step(z, _):
        k1 = rhs(z)
        k2 = rhs(z + 0.5 * dt * k1)
        k3 = rhs(z + 0.5 * dt * k2)
        k4 = rhs(z + dt * k3)
        zn = z + (dt / 6) * (k1 + 2 * k2 + 2 * k3 + k4)
        return zn, zn

    z0 = jnp.array([0.8, -0.5, 0.3], jnp.float32)
    _, traj = jax.jit(lambda z: lax.scan(step, z, None, length=600))(z0)
    z = jnp.concatenate([z0[None], traj])
    v, _ = np.linalg.qr(rng.standard_normal((256, r)))
    x = z @ jnp.asarray(v.T, jnp.float32)
    # analytic derivatives: the sweep checks the DEVICE regression +
    # rollout path, not finite-difference noise (f32 FD derivatives of a
    # fast trajectory are a documented accuracy limit — use x_dot= or f64
    # for production fits from coarse samples)
    xdot = jax.vmap(rhs)(z) @ jnp.asarray(v.T, jnp.float32)
    m = OpInf(n_modes=r, reg_quadratic=1e-6).fit(x, dt=dt, x_dot=xdot,
                                                 key=8)
    pred = m.predict(x[0], 600, dt)
    return float(jnp.max(jnp.abs(pred - x))), 5e-2


@stage("grassmann rom interp")
def s_grassmann():
    import jax.numpy as jnp

    from corrla_rs_tpu.ops.grassmann import GrassmannInterp, subspace_angles

    # anchor bases: smoothly rotating 2-dim subspaces of R^32
    def basis(theta):
        b = np.zeros((32, 2))
        b[0, 0], b[1, 0] = np.cos(theta), np.sin(theta)
        b[2, 1], b[3, 1] = np.cos(2 * theta), np.sin(2 * theta)
        return b

    thetas = np.array([0.0, 0.2, 0.4, 0.6])
    bases = jnp.asarray(np.stack([basis(t) for t in thetas]), jnp.float32)
    gi = GrassmannInterp(bases, jnp.asarray(thetas[:, None], jnp.float32))
    mid = gi(jnp.asarray([0.3], jnp.float32))  # single query -> (n, r)
    ang = subspace_angles(mid, jnp.asarray(basis(0.3), jnp.float32))
    return float(np.max(np.asarray(ang))), 5e-2


@stage("gappy pod reconstruct")
def s_gappy():
    import jax.numpy as jnp

    from corrla_rs_tpu.ops.gappy import gappy_reconstruct

    a = lowrank(512, 20, 4)
    u, _, _ = np.linalg.svd(a, full_matrices=False)
    modes = jnp.asarray(u[:, :4], jnp.float32)
    pts = jnp.asarray(RNG.choice(512, 12, replace=False))
    field = a[:, 3].astype(np.float32)
    rec, _coeffs = gappy_reconstruct(modes, pts, jnp.asarray(field)[pts])
    return (float(np.max(np.abs(np.asarray(rec) - field)))
            / float(np.max(np.abs(field)))), 1e-3


@stage("hmc (50-dim gaussian)")
def s_hmc():
    import jax
    import jax.numpy as jnp

    from corrla_rs_tpu.ops.hmc import hmc_run

    d = 50
    sig = jnp.asarray(np.geomspace(0.1, 3.0, d), jnp.float32)

    def lnp(x):
        return -0.5 * jnp.sum((x / sig) ** 2)

    x0 = jax.random.normal(jax.random.key(10), (16, d), jnp.float32)
    res = hmc_run(x0, lnp, n_steps=300, n_warmup=300, key=11)
    draws = np.asarray(res.history).reshape(-1, d)
    return float(np.max(np.abs(draws.std(0) - np.asarray(sig))
                        / np.asarray(sig))), 0.3


@stage("batched pcg")
def s_cg():
    import jax.numpy as jnp

    from corrla_rs_tpu.ops.cg import cg_solve

    q, _ = np.linalg.qr(RNG.standard_normal((1024, 1024)))
    a = (q * np.logspace(0, -3, 1024)) @ q.T
    xt = RNG.standard_normal((1024, 4))
    b = a @ xt
    res = cg_solve(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32),
                   n_iters=200, tol=1e-5)
    return float(np.max(np.abs(np.asarray(res.x) - xt))), 2e-2


@stage("nuts (8-dim gaussian)")
def s_nuts():
    import jax
    import jax.numpy as jnp

    from corrla_rs_tpu.ops.nuts import nuts_run

    sig = jnp.asarray(np.geomspace(0.2, 2.0, 8), jnp.float32)

    def lnp(x):
        return -0.5 * jnp.sum((x / sig) ** 2)

    x0 = jax.random.normal(jax.random.key(12), (16, 8), jnp.float32)
    res = nuts_run(x0, lnp, n_steps=300, n_warmup=300, key=13)
    d = np.asarray(res.history[50:]).reshape(-1, 8)
    return float(np.max(np.abs(d.std(0) - np.asarray(sig))
                        / np.asarray(sig))), 0.25


@stage("laplace approx")
def s_laplace():
    import jax.numpy as jnp

    from corrla_rs_tpu.ops.laplace import laplace_approx

    mu = jnp.array([1.0, -2.0, 0.5], jnp.float32)
    cv = jnp.array([1.0, 0.5, 2.0], jnp.float32)

    def lnp(x):
        return -0.5 * jnp.sum((x - mu) ** 2 / cv)

    res = laplace_approx(lnp, jnp.zeros(3, jnp.float32))
    logz_true = 1.5 * np.log(2 * np.pi) + 0.5 * float(
        np.sum(np.log(np.asarray(cv))))
    return float(max(np.max(np.abs(np.asarray(res.x_map - mu))),
                     abs(res.log_evidence - logz_true))), 1e-3


@stage("smolyak quadrature")
def s_quadrature():
    import jax.numpy as jnp

    from corrla_rs_tpu.ops.quadrature import integrate, smolyak_quadrature

    r = smolyak_quadrature(6, 3)
    c = np.full(6, 0.3)

    def f(x):
        return jnp.cos(0.5 + jnp.dot(jnp.asarray(c, jnp.float32),
                                     x.astype(jnp.float32)))

    truth = np.cos(0.5) * np.prod(2 * np.sin(c) / c)
    got = integrate(f, r)
    return float(abs(got - truth) / abs(truth)), 1e-3


@stage("cma-es (rosenbrock)")
def s_cma():
    import jax.numpy as jnp

    from corrla_rs_tpu.ops.cma import cma_es

    def f(x):
        return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                       + (1.0 - x[:-1]) ** 2)

    res = cma_es(f, jnp.full(4, -1.0, jnp.float32), sigma0=0.3,
                 n_gens=400, pop_size=12, key=20)
    return float(res.f_best), 1e-3


@stage("shapley effects")
def s_shapley():
    import jax.numpy as jnp

    from corrla_rs_tpu.ops.shapley import (
        shapley_effects,
        shapley_effects_linear,
    )

    rho = 0.6
    cov = np.array([[1.0, rho, 0.0], [rho, 1.0, 0.0], [0.0, 0.0, 0.5]])
    beta = np.array([1.0, -0.7, 1.5])
    truth = shapley_effects_linear(beta, cov)

    def model(x):
        return x @ jnp.asarray(beta, jnp.float32)

    sh = shapley_effects(model, np.zeros(3), cov, n_outer=512,
                         n_inner=128, key=21)
    return float(np.max(np.abs(np.asarray(sh) - truth))), 0.05


@stage("mlmc")
def s_mlmc():
    import jax
    import jax.numpy as jnp

    from corrla_rs_tpu.ops.mlmc import mlmc_estimate

    def level_fn(lvl):
        def f(x):
            return x[:, 0] ** 2 + 0.5 ** lvl * jnp.sin(7.0 * x[:, 0])
        return f

    def sample_inputs(key, n):
        return jax.random.normal(key, (n, 1), jnp.float32)

    r = mlmc_estimate([level_fn(l) for l in range(3)], sample_inputs,
                      [1.0, 2.0, 4.0], target_se=0.02, key=22)
    return float(abs(r.mean - 1.0)), 0.1


@stage("etkf analysis (sample-kalman identity)")
def s_etkf():
    import jax.numpy as jnp

    from corrla_rs_tpu.ops.enkf import etkf_analysis

    n, p, n_ens = 8, 3, 32
    x_ens = RNG.standard_normal((n_ens, n))
    h = RNG.standard_normal((p, n))
    r_diag = RNG.uniform(0.3, 1.0, size=p)
    y_obs = RNG.standard_normal(p)
    # f64 oracle: exact Kalman mean from the sample covariances
    xbar = x_ens.mean(0)
    xa = x_ens - xbar
    ya = xa @ h.T
    cyy = ya.T @ ya / (n_ens - 1) + np.diag(r_diag)
    gain = np.linalg.solve(cyy, (xa.T @ ya / (n_ens - 1)).T).T
    mean_ref = xbar + gain @ (y_obs - h @ xbar)
    out = etkf_analysis(
        jnp.asarray(x_ens, jnp.float32), jnp.asarray(y_obs, jnp.float32),
        jnp.asarray(h, jnp.float32), jnp.asarray(r_diag, jnp.float32))
    got = np.asarray(out, np.float64).mean(0)
    return float(np.max(np.abs(got - mean_ref))), 1e-4


@stage("es-mda (nonlinear inversion)")
def s_esmda():
    import jax
    import jax.numpy as jnp

    from corrla_rs_tpu.ops.enkf import esmda

    theta_true = np.array([1.2, -0.7])
    t_grid = jnp.linspace(0.0, 1.0, 16).astype(jnp.float32)
    y_clean = theta_true[0] * np.exp(theta_true[1]
                                     * np.asarray(t_grid, np.float64))
    y_obs = (y_clean + 0.01 * RNG.standard_normal(16)).astype(np.float32)
    prior = (np.array([1.0, -0.5])
             + 0.3 * RNG.standard_normal((256, 2))).astype(np.float32)
    sol = esmda(jnp.asarray(prior),
                lambda t: t[0] * jnp.exp(t[1] * t_grid),
                jnp.asarray(y_obs), 0.01**2, jax.random.key(3), n_mda=8)
    return float(np.max(np.abs(np.asarray(sol["mean"]) - theta_true))), 0.1


@stage("ukf (linear = exact kalman)")
def s_ukf():
    import jax.numpy as jnp

    from corrla_rs_tpu.ops.particle import ukf_filter

    th = 0.4
    a = 0.97 * np.array([[np.cos(th), -np.sin(th)],
                         [np.sin(th), np.cos(th)]])
    c_obs = np.array([[1.0, 0.5]])
    q = 0.05 * np.eye(2)
    r = np.array([[0.2]])
    x = np.array([1.5, -0.5])
    ys = []
    for _ in range(40):
        x = a @ x + RNG.multivariate_normal(np.zeros(2), q)
        ys.append(c_obs @ x + RNG.multivariate_normal(np.zeros(1), r))
    ys = np.asarray(ys)
    m, p_cov = np.zeros(2), np.eye(2)
    means_ref = []
    for y in ys:
        m = a @ m
        p_cov = a @ p_cov @ a.T + q
        s = c_obs @ p_cov @ c_obs.T + r
        k = p_cov @ c_obs.T @ np.linalg.inv(s)
        m = m + k @ (y - c_obs @ m)
        p_cov = p_cov - k @ c_obs @ p_cov
        means_ref.append(m.copy())
    import jax.lax

    a_j = jnp.asarray(a, jnp.float32)
    c_j = jnp.asarray(c_obs, jnp.float32)
    # user-supplied dynamics pin HIGHEST precision: an f32 matmul without
    # one runs as TF32 on the GPU
    hi = jax.lax.Precision.HIGHEST
    from corrla_rs_tpu.utils.smallpath import (
        set_small_path_threshold, small_path_threshold,
    )
    prev = small_path_threshold()
    set_small_path_threshold(0)   # exercise the chip, not the CPU route
    try:
        out = ukf_filter(jnp.zeros(2, jnp.float32),
                         jnp.eye(2, dtype=jnp.float32),
                         jnp.asarray(ys, jnp.float32),
                         lambda v: jnp.matmul(a_j, v, precision=hi),
                         lambda v: jnp.matmul(c_j, v, precision=hi),
                         jnp.asarray(q, jnp.float32),
                         jnp.asarray(r, jnp.float32))
    finally:
        set_small_path_threshold(prev)
    return float(np.max(np.abs(np.asarray(out["means"], np.float64)
                               - np.asarray(means_ref)))), 5e-3


@stage("gmm em (3 blobs)")
def s_gmm():
    from corrla_rs_tpu.ops.gmm import gmm_fit

    mus = np.array([[0.0, 0.0], [6.0, 1.0], [-1.0, 7.0]])
    xs = [RNG.multivariate_normal(mu, 0.6 * np.eye(2), size=250)
          for mu in mus]
    x = np.concatenate(xs).astype(np.float32)
    fit = gmm_fit(x, 3, key=1)
    got = np.sort(np.asarray(fit.means, np.float64), axis=0)
    return float(np.max(np.abs(got - np.sort(mus, axis=0)))), 0.3


@stage("bridge-sampling evidence")
def s_bridge():
    import jax.numpy as jnp

    from corrla_rs_tpu.ops.bridge import bridge_sampling_evidence

    # 2-d Gaussian pseudo-posterior with known normalizer:
    # ln q = -|x|^2 / (2 s^2)  =>  log Z = (d/2) log(2 pi s^2)
    s, d = 0.7, 2
    draws = jnp.asarray(RNG.standard_normal((4000, d)) * s, jnp.float32)

    def ln_post(x):
        return -0.5 * jnp.sum(x * x) / s**2

    br = bridge_sampling_evidence(ln_post, draws, key=3)
    logz_true = 0.5 * d * np.log(2.0 * np.pi * s**2)
    err = abs(float(br.log_evidence) - logz_true)
    if not br.converged:
        err += 1.0
    return float(err), 0.1


@stage("psis regimes (device log-weights)")
def s_psis():
    import jax
    import jax.numpy as jnp

    from corrla_rs_tpu.ops.psis import psis

    # importance weights computed ON DEVICE: N(0, 1) proposal draws
    # reweighted to N(0, s^2) targets. s < 1 (light tail, bounded
    # weights): k-hat must read safe; s > 1 (w has infinite variance
    # for s^2 > 2... use s = 2: tail index 1 - 1/s^2 scaled): must be
    # flagged. Regime separation is the assertion.
    x = jnp.asarray(RNG.standard_normal(4000), jnp.float32)

    def lw_for(s):
        return np.asarray(
            jax.vmap(lambda v: -0.5 * v * v / s**2 + 0.5 * v * v)(x),
            np.float64)

    r_light = psis(lw_for(0.8))
    r_heavy = psis(lw_for(2.5))
    err = 0.0
    if not r_light.k_hat < 0.5:
        err += 1.0
    if not r_heavy.k_hat > 0.6:
        err += 1.0
    w = np.exp(np.asarray(r_light.log_weights))
    err += abs(float(w.sum()) - 1.0)
    return float(err), 1e-6


def main():
    _require_gpu()
    import jax

    # optional argv substrings select a subset of stages (re-runs after
    # a fix without paying for the whole sweep)
    sel = [s.lower() for s in sys.argv[1:]]
    stages = [fn for fn in RESULTS
              if not sel or any(s in fn._stage_name.lower() for s in sel)]
    if sel and not stages:
        print(f"no stage matches {sel}", file=sys.stderr)
        raise SystemExit(2)

    print(f"backend: {jax.default_backend()}, device: {jax.devices()[0]}")
    print()
    print("| family | wall (s) | error | tol | status |")
    print("|---|---|---|---|---|")
    n_fail = 0
    for fn in stages:
        name = fn._stage_name
        t0 = time.perf_counter()
        try:
            err, tol = fn()
            wall = time.perf_counter() - t0
            ok = err < tol and np.isfinite(err)
            status = "PASS" if ok else "FAIL"
            if not ok:
                n_fail += 1
            print(f"| {name} | {wall:.2f} | {err:.2e} | {tol:g} "
                  f"| {status} |", flush=True)
        except Exception as exc:  # keep sweeping; report at the end
            wall = time.perf_counter() - t0
            n_fail += 1
            print(f"| {name} | {wall:.2f} | exception: "
                  f"{type(exc).__name__}: {exc} | — | FAIL |", flush=True)
            traceback.print_exc(file=sys.stderr)
    print(f"\n{len(stages) - n_fail}/{len(stages)} families PASS")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
