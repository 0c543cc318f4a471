"""End-to-end UQ pipeline on the GPU — the capstone demo.

One command composes the library's whole surface on a single coherent
problem (the workflow the reference aspired to across readme.md:29-54,
delivered working):

    snapshot data -> streamed POD -> DMDc ROM -> SINDYc consistency
    check -> active-subspace reduction -> DREAM calibration -> SMC +
    bridge-sampling evidence (PSIS-validated) -> Shapley attribution
    (cross-checked against pick-freeze Sobol' indices)

The physical problem: a damped traveling wave with an exponentially
growing control forcing,

    u(x, t; theta) = g e^{-lam t} sin(3x - 4c t) + 0.25 sin(5x) e^{0.25 t}

observed at 16 sensors with Gaussian noise. theta = (lam, c, g) is
calibrated from the sensor record; the field is EXACTLY a rank-2
linear system plus linear control response, so the ROM stages have an
analytic truth to be judged against.

Run: ``python examples/demo_pipeline.py`` (JAX's default backend; any
backend works). Prints one table: stage, wall,
key metric, PASS/FAIL. Exit code 0 iff every stage passes. Walls
include first-compile time unless the persistent cache is warm.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from corrla_rs_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import time

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------- problem
NX, NT, DT = 8192, 160, 0.02
N_SENSORS = 16
NOISE_STD = 0.05
THETA_TRUE = np.array([0.8, 1.2, 1.5])            # (lam, c, g)
PRIOR_MEAN = np.array([1.0, 1.0, 1.0])
PRIOR_STD = np.array([0.35, 0.35, 0.5])

X_GRID = np.linspace(0.0, 2.0 * np.pi, NX, endpoint=False)
T_GRID = DT * np.arange(NT)
U_CTRL = np.exp(0.25 * T_GRID)                    # known forcing signal
SENSOR_IDX = np.linspace(0, NX - 1, N_SENSORS).astype(int)

# numpy on purpose: module-scope jnp constants are EAGER device
# dispatches. As numpy they fold into each jitted executable as
# compile-time constants instead.
_xg = X_GRID.astype(np.float32)
_tg = T_GRID.astype(np.float32)
_uc = U_CTRL.astype(np.float32)
_xs = X_GRID[SENSOR_IDX].astype(np.float32)


def field(theta, x):
    """(len(x), NT) snapshot matrix at parameters theta — jax-traceable
    (every downstream consumer differentiates or vmaps through it)."""
    lam, c, g = theta[0], theta[1], theta[2]
    wave = (g * jnp.exp(-lam * _tg)[None, :]
            * jnp.sin(3.0 * x[:, None] - 4.0 * c * _tg[None, :]))
    forced = 0.25 * jnp.sin(5.0 * x)[:, None] * _uc[None, :]
    return wave + forced


def sensor_forward(theta):
    """(N_SENSORS, NT) sensor record — the calibration forward model."""
    return field(theta, _xs)


results = []


def stage(name):
    def deco(fn):
        def run():
            t0 = time.perf_counter()
            metric, value, ok = fn()
            wall = time.perf_counter() - t0
            results.append((name, wall, metric, value, ok))
            print(f"  {name:<28} {wall:7.2f} s  {metric:<30} "
                  f"{value:<12} {'PASS' if ok else 'FAIL'}", flush=True)
        return run
    return deco


# ------------------------------------------------------------- the stages
rng = np.random.default_rng(0)
snapshots = None          # (NX, NT) f32, on device
y_obs = None              # (N_SENSORS, NT) noisy sensor record
pod_fit = None
dream_draws = None
ln_post = None
log_z_smc = None


@stage("1 snapshot data (on device)")
def s1_data():
    global snapshots, y_obs
    # ONE jitted executable + one dispatch instead of an eager op chain
    snapshots = jax.jit(lambda th: field(th, _xg))(
        jnp.asarray(THETA_TRUE, jnp.float32))
    snapshots.block_until_ready()
    y_clean = np.asarray(snapshots)[SENSOR_IDX]
    y_obs = jnp.asarray(
        y_clean + NOISE_STD * rng.standard_normal(y_clean.shape),
        jnp.float32)
    ok = bool(jnp.all(jnp.isfinite(snapshots)))
    return "field elements", f"{snapshots.size:,}", ok


@stage("2 streamed POD (2 passes)")
def s2_pod():
    global pod_fit
    from corrla_rs_tpu.ops.streaming import streamed_pod

    # streamed layout: rows = snapshots, columns = the huge point axis
    x_snap = np.asarray(snapshots).T                      # (NT, NX)
    pod_fit = streamed_pod(x_snap, T_GRID[:, None], n_modes=6)
    recon = np.asarray(pod_fit.predict(T_GRID[:, None]))  # (NX, NT)
    err = (np.linalg.norm(recon - x_snap.T)
           / np.linalg.norm(x_snap))
    return "recon rel err", f"{err:.2e}", err < 1e-3


@stage("3 DMDc ROM")
def s3_dmdc():
    from corrla_rs_tpu.models.dmd import DMDc

    u_row = jnp.asarray(U_CTRL[None, :], jnp.float32)
    # n_modes = the field's exact rank (2 wave + 1 forced): extra modes
    # would fit f32 rounding noise and destabilize the 159-step rollout
    model = DMDc(snapshots, u_row, n_modes=3, n_iters=20, key=1)
    x0 = snapshots[:, :1]
    pred = model.predict_multiple(x0, u_row[:, :-1])      # (NX, NT-1)
    truth = np.asarray(snapshots)[:, 1:]
    err = (np.linalg.norm(np.asarray(pred) - truth)
           / np.linalg.norm(truth))
    return "rollout rel err", f"{err:.2e}", err < 5e-2


@stage("4 SINDYc consistency check")
def s4_sindy():
    from corrla_rs_tpu.models.sindy import Sindy

    # reduced coordinates: POD mode weights over time (NT, r)
    w = np.asarray(pod_fit.mode_weights)[:, :4]
    u = U_CTRL[:, None]
    model = Sindy(degree=1, threshold=0.02, ridge=1e-8)
    model.fit(w, u=u, dt=DT)
    # consistency: identified RHS vs centered finite-diff derivative
    wd_fd = (w[2:] - w[:-2]) / (2.0 * DT)
    pred = np.asarray(model.predict(w[1:-1], u=u[1:-1]))
    err = np.linalg.norm(pred - wd_fd) / np.linalg.norm(wd_fd)
    return "dw/dt rel err", f"{err:.2e}", err < 5e-2


@stage("5 active subspace (exact AD)")
def s5_active():
    from corrla_rs_tpu.models.active_subspaces import (
        ActiveSsRsvd, AdGradientEstimator,
    )

    def qoi(theta):
        return jnp.mean(sensor_forward(theta) ** 2)

    est = AdGradientEstimator(qoi)
    thetas = jnp.asarray(
        PRIOR_MEAN + PRIOR_STD * rng.standard_normal((256, 3)),
        jnp.float32)
    fit = ActiveSsRsvd(est, 1).fit(thetas)
    evals = np.asarray(fit.singular_vals_).ravel()
    share = float(evals[0] / evals.sum())
    return "lambda1 share", f"{share:.3f}", share > 0.5


@stage("6 DREAM calibration (1024ch)")
def s6_dream():
    global dream_draws, ln_post
    from corrla_rs_tpu.ops.dream import dream_run

    y = y_obs
    inv_var = 1.0 / NOISE_STD**2
    pm = jnp.asarray(PRIOR_MEAN, jnp.float32)
    ps = jnp.asarray(PRIOR_STD, jnp.float32)

    def _ln_post(theta):
        resid = sensor_forward(theta) - y
        ll = -0.5 * inv_var * jnp.sum(resid * resid)
        lp = -0.5 * jnp.sum(((theta - pm) / ps) ** 2) \
            - jnp.sum(jnp.log(ps)) - 1.5 * jnp.log(2.0 * jnp.pi)
        return ll + lp

    ln_post = _ln_post
    heads0 = jnp.asarray(
        PRIOR_MEAN + PRIOR_STD * rng.standard_normal((1024, 3)),
        jnp.float32)
    hist, state = dream_run(heads0, _ln_post, 1200, key=3, n_adapt=300)
    draws = np.asarray(hist[400:]).reshape(-1, 3)
    dream_draws = draws[:: max(1, draws.shape[0] // 8192)]
    post_mean = draws.mean(0)
    err = float(np.abs(post_mean - THETA_TRUE).max())
    return "post mean abs err", f"{err:.2e}", err < 5e-2


@stage("7 SMC evidence (1024 particles)")
def s7_smc():
    global log_z_smc
    from corrla_rs_tpu.ops.smc import smc_sample

    y = y_obs
    inv_var = 1.0 / NOISE_STD**2
    pm = jnp.asarray(PRIOR_MEAN, jnp.float32)
    ps = jnp.asarray(PRIOR_STD, jnp.float32)

    def ln_like(theta):
        resid = sensor_forward(theta) - y
        return -0.5 * inv_var * jnp.sum(resid * resid)

    def ln_prior(theta):
        return (-0.5 * jnp.sum(((theta - pm) / ps) ** 2)
                - jnp.sum(jnp.log(ps)) - 1.5 * jnp.log(2.0 * jnp.pi))

    init = jnp.asarray(
        PRIOR_MEAN + PRIOR_STD * rng.standard_normal((1024, 3)),
        jnp.float32)
    res = smc_sample(ln_like, ln_prior, init, n_mcmc=5, key=5)
    log_z_smc = float(res.log_evidence)
    ok = np.isfinite(log_z_smc) and res.n_stages >= 2
    return "log Z (SMC)", f"{log_z_smc:.2f}", bool(ok)


@stage("8 bridge evidence + PSIS k-hat")
def s8_bridge_psis():
    from corrla_rs_tpu.ops.bridge import bridge_sampling_evidence
    from corrla_rs_tpu.ops.psis import psis

    br = bridge_sampling_evidence(ln_post, dream_draws, key=7)
    gap = abs(br.log_evidence - log_z_smc)
    # PSIS validation of the moment-matched Gaussian proposal: draw from
    # it, weight to the posterior, check the tail index
    n_val = 4096
    d = 3
    z = np.random.default_rng(11).standard_normal((n_val, d))
    mu = np.asarray(br.proposal_mean)
    chol = np.asarray(br.proposal_chol)
    xs = jnp.asarray(mu + z @ chol.T, jnp.float32)
    ln_gauss = (-0.5 * np.sum(z * z, axis=1)
                - 0.5 * d * np.log(2.0 * np.pi)
                - np.sum(np.log(np.diag(chol))))
    lw = np.asarray(jax.vmap(ln_post)(xs), np.float64) - ln_gauss
    k_hat = psis(lw).k_hat
    ok = bool(br.converged) and gap < 1.0 and k_hat < 0.7
    return "|dlogZ|, k-hat", f"{gap:.3f}, {k_hat:.3f}", ok


@stage("9 Shapley vs Sobol sandwich")
def s9_shapley():
    from corrla_rs_tpu.ops.shapley import shapley_effects_quadrature
    from corrla_rs_tpu.ops.sobol import sobol_indices

    def qoi_batch(thetas):
        return jax.vmap(lambda th: jnp.mean(sensor_forward(th) ** 2)
                        )(thetas)

    # the prior is independent Gaussian and d=3, so ALL 2^d subset
    # variances — hence exact Shapley effects AND exact S1/ST — come
    # from ONE 16^3-point Gauss-Hermite grid evaluated in a single
    # device batch. The earlier MC-vs-MC version of this stage was an
    # estimator-noise coin flip: the nested-MC Shapley scatters +-0.15
    # per share on this skewed QoI at n_outer=512 (measured, f64), so
    # Owen's sandwich flipped FAIL on noise. On the quadrature values
    # the sandwich is a mathematical identity — violating it means the
    # implementation (or the chip) is wrong, which is what a validation
    # stage should test.
    quad = shapley_effects_quadrature(
        qoi_batch, PRIOR_MEAN, PRIOR_STD, n_quad=16)
    shares, s1_q, st_q = quad["shapley"], quad["s1"], quad["st"]
    # f32 grid evaluations leave ~1e-6-relative noise in the f64
    # contractions; 1e-3 slack is 1000x that
    sandwiched = bool(np.all(shares >= s1_q - 1e-3)
                      and np.all(shares <= st_q + 1e-3))

    # cross-check the INDEPENDENT pick-freeze Sobol estimator against
    # quadrature truth computed on the SAME measure it samples. The
    # PPF-of-uniform-box plan truncates the Gaussian at +-3.09 sigma,
    # and on this QoI the tail carries real variance (untruncated
    # ST_lam 0.50 vs truncated 0.39 — the small-lam tail is where
    # e^{-2 lam t} blows up), so comparing pick-freeze to UNtruncated
    # truth would cross two different measures and fail on a real,
    # correctly-estimated difference. Gauss-Legendre rules through the
    # same PPF give the truncated measure's exact indices.
    pm = jnp.asarray(PRIOR_MEAN, jnp.float32)
    ps = jnp.asarray(PRIOR_STD, jnp.float32)
    trunc = 1e-3

    def f_u(us):
        from jax.scipy.stats import norm
        return qoi_batch(pm + ps * norm.ppf(us))

    from scipy.stats import norm as spnorm
    xg, wg = np.polynomial.legendre.leggauss(24)
    u_nodes = (xg + 1.0) / 2.0 * (1.0 - 2.0 * trunc) + trunc
    rules = [(PRIOR_MEAN[i] + PRIOR_STD[i] * spnorm.ppf(u_nodes), wg)
             for i in range(3)]
    tq = shapley_effects_quadrature(qoi_batch, rules=rules)
    sob = sobol_indices(f_u, np.array([[trunc, 1.0 - trunc]] * 3),
                        n_base=32768, key=17)
    mc_err = max(
        float(np.max(np.abs(np.asarray(sob["s1"]) - tq["s1"]))),
        float(np.max(np.abs(np.asarray(sob["st"]) - tq["st"]))),
    )
    ok = (sandwiched and abs(float(shares.sum()) - 1.0) < 1e-6
          and mc_err < 0.08)
    top = ["lam", "c", "g"][int(shares.argmax())]
    return (f"top={top}, shapley_g, pickfreeze dev",
            f"{shares[2]:.3f}, {mc_err:.3f}", ok)


def main():
    print(f"demo_pipeline: backend={jax.default_backend()}, "
          f"field {NX}x{NT}, {N_SENSORS} sensors, "
          f"theta_true={THETA_TRUE.tolist()}", flush=True)
    print(f"  {'stage':<28} {'wall':>9}  {'metric':<30} "
          f"{'value':<12} status", flush=True)
    for fn in (s1_data, s2_pod, s3_dmdc, s4_sindy, s5_active,
               s6_dream, s7_smc, s8_bridge_psis, s9_shapley):
        fn()
    n_pass = sum(1 for r in results if r[4])
    total_wall = sum(r[1] for r in results)
    print(f"demo_pipeline: {n_pass}/{len(results)} stages PASS, "
          f"total {total_wall:.1f} s", flush=True)
    raise SystemExit(0 if n_pass == len(results) else 1)


if __name__ == "__main__":
    main()
