"""f32 end-to-end smoke lane.

The main suite runs f64 (x64) to match the reference's tolerances — but
every f32-only regression of round 1 (power-iteration collapse, saddle
pinv blow-up, CholeskyQR NaNs) was invisible in f64 and only surfaced on
the accelerator. This lane reruns the critical flows in f32 in a subprocess (x64 is a
process-wide switch), so CPU CI catches that class.
"""
import json
import subprocess
import sys

import pytest

SCRIPT = r"""
import jax
jax.config.update("jax_platforms", "cpu")
from corrla_rs_tpu.utils.cache import enable_persistent_cache
enable_persistent_cache()
import json
import numpy as np
import jax.numpy as jnp
from corrla_rs_tpu.ops.random_svd import random_svd
from corrla_rs_tpu import PodI, DMDc, RbfInterp
from corrla_rs_tpu.ops.samplers import constr_dirichlet_sample

out = {}

# decaying-spectrum POD family (the f32 collapse fixture)
nx, ns, sigma = 1000, 20, 2.0
x = np.linspace(0, 10, nx); t = np.linspace(1, 9, ns)[:, None]
p = ((0.5 * t) * np.exp(-((x[None, :] - t) ** 2) / sigma**2)).astype(np.float32)
u, s, vt = random_svd(jnp.asarray(p), 4, 10, 10, key=0)
s_exact = np.linalg.svd(p.astype(np.float64), compute_uv=False)[:4]
out["pod_sigma_rel"] = float(np.max(np.abs(np.asarray(s, np.float64) - s_exact) / s_exact))

pod = PodI(jnp.asarray(p), jnp.asarray(t.astype(np.float32)), 4)
pred = pod.predict(jnp.asarray([[5.2]], dtype=jnp.float32))
truth = (0.5 * 5.2) * np.exp(-((x - 5.2) ** 2) / sigma**2)
out["pod_field_rel"] = float(
    np.linalg.norm(np.asarray(pred)[:, 0] - truth) / np.linalg.norm(truth)
)

# DMDc sine fixture
xp = np.linspace(0, 10, 200); tp = np.linspace(0, 10, 40)
useq = np.exp(0.2 * tp)[None, :].astype(np.float32)
snaps = (np.sin(xp[:, None] + 0.2 * tp[None, :]) * useq).astype(np.float32)
m = DMDc(jnp.asarray(snaps), jnp.asarray(useq), 12, 20)
pm = m.predict_multiple(jnp.asarray(snaps[:, :1]), jnp.asarray(useq))
out["dmd_err"] = float(np.abs(np.asarray(pm)[:, 19] - snaps[:, 20]).max())

# RBF saddle solve
xi = np.random.default_rng(0).standard_normal((40, 2)).astype(np.float32)
yi = (np.sin(xi[:, :1]) + np.sin(xi[:, 1:2])).astype(np.float32)
rbf = RbfInterp(2, 1.0, 2, 1).fit(xi, yi)
out["rbf_support_err"] = float(np.abs(np.asarray(rbf.predict(xi)) - yi).max())

# rejection sampler in f32
bounds = np.array([[0.0, 0.0026], [0.1955, 0.1995], [0.80, 0.825]],
                  dtype=np.float32)
smp = constr_dirichlet_sample(bounds, 16, 500, 50000, 1.0, key=0)
out["sampler_sum_err"] = float(np.abs(np.asarray(smp).sum(1) - 1.0).max())

print(json.dumps(out))
"""


def test_f32_end_to_end():
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT], capture_output=True, text=True,
        timeout=900,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["pod_sigma_rel"] < 1e-4, out
    assert out["pod_field_rel"] < 0.1, out
    assert out["dmd_err"] < 5e-2, out
    assert out["rbf_support_err"] < 1e-2, out
    assert out["sampler_sum_err"] < 1e-5, out


SCRIPT_WAVE3 = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import json
import numpy as np
import jax.numpy as jnp
from corrla_rs_tpu import (
    HankelDmd, OptDmd, era, sketched_lstsq, spod,
)

out = {}
rng = np.random.default_rng(0)

# spod: on-bin tone in f32 snapshots
n_fft = 128
t = np.arange(4096.0)
s = np.linspace(0, 1, 16)
xs = (np.outer(np.sin(np.pi * s), np.cos(2 * np.pi * (16 / n_fft) * t))
      + 0.01 * rng.standard_normal((16, 4096))).astype(np.float32)
fit = spod(xs, n_fft=n_fft, overlap=0.5, n_modes=4)
out["spod_peak"] = float(fit.peak_frequencies(1)[0])
out["spod_finite"] = bool(np.all(np.isfinite(np.asarray(fit.modes_re))))

# HankelDmd: scalar two-tone in f32
dt = 0.1
tt = dt * np.arange(400)
sig = (np.sin(0.5 * tt) + 0.7 * np.sin(1.3 * tt)).astype(np.float32)
h = HankelDmd(sig, n_delays=16, n_modes=4)
freqs = np.sort(np.abs(np.imag(h.eigs_continuous(dt))))
out["hankel_freq_err"] = float(np.max(np.abs(freqs - [0.5, 0.5, 1.3, 1.3])))

# OptDmd: f32 snapshots (host varpro itself runs f64)
alphas = np.array([-0.05 + 1.1j, -0.05 - 1.1j])
phi = rng.standard_normal((12, 2)) + 1j * rng.standard_normal((12, 2))
phi[:, 1] = np.conj(phi[:, 0])
ts = 0.1 * np.arange(120)
xo = np.real(phi @ np.exp(np.outer(alphas, ts))).astype(np.float32)
o = OptDmd(xo, 2, dt=0.1)
out["optdmd_alpha_err"] = float(
    np.max(np.abs(np.sort(o.alphas.imag) - [-1.1, 1.1])))

# era: f32 Markov stack
a = np.array([[0.9, 0.2, 0.0], [0.0, 0.7, 0.3], [0.0, 0.0, 0.5]])
b = np.array([[1.0], [0.5], [-0.3]]); c = np.array([[1.0, -0.4, 0.2]])
hs = np.empty((40, 1, 1), np.float32)
ca = c.copy()
for k in range(40):
    hs[k] = ca @ b
    ca = ca @ a
e = era(hs, rank=3)
out["era_pole_err"] = float(
    np.max(np.abs(np.sort(e.lambdas.real) - [0.5, 0.7, 0.9])))

# sketched least squares at f32 (modest conditioning)
m, n = 3000, 32
u, _ = np.linalg.qr(rng.standard_normal((m, n)))
v, _ = np.linalg.qr(rng.standard_normal((n, n)))
af = ((u * np.logspace(0, -3, n)) @ v.T).astype(np.float32)
bf = rng.standard_normal(m).astype(np.float32)
x32, _ = sketched_lstsq(af, bf, n_iters=40, key=1)
r32 = np.linalg.norm(af.astype(np.float64) @ np.asarray(x32, np.float64)
                     - bf.astype(np.float64))
r_ref = np.linalg.norm(
    af.astype(np.float64)
    @ np.linalg.lstsq(af.astype(np.float64), bf.astype(np.float64),
                      rcond=None)[0]
    - bf.astype(np.float64))
out["lstsq_rel_excess"] = float(r32 / r_ref - 1.0)

# robust PCA in f32: PRECISION=HIGHEST matmuls keep the split exact
from corrla_rs_tpu import robust_pca
lr = (rng.standard_normal((60, 3)) @ rng.standard_normal((3, 40)))
msk = rng.random((60, 40)) < 0.05
mm32 = (lr + np.where(msk, 8.0, 0.0)).astype(np.float32)
l32, s32, info32 = robust_pca(mm32, tol=1e-5)
out["rpca_l_rel"] = float(np.linalg.norm(np.asarray(l32, np.float64) - lr)
                          / np.linalg.norm(lr))

print(json.dumps(out))
"""


@pytest.mark.slow
def test_f32_wave3_end_to_end():
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT_WAVE3], capture_output=True,
        text=True, timeout=900,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert abs(out["spod_peak"] - 16 / 128) < 1e-9, out
    assert out["spod_finite"], out
    assert out["hankel_freq_err"] < 1e-2, out
    assert out["optdmd_alpha_err"] < 1e-3, out
    assert out["era_pole_err"] < 1e-3, out
    assert out["lstsq_rel_excess"] < 1e-4, out
    assert out["rpca_l_rel"] < 1e-2, out
