"""Demo: system identification and mode selection on synthetic data.

Runs on whatever backend is default (the GPU if present, else CPU).
Walks the identification chain the reference cannot do at all:
operating input-output data -> OKID Markov parameters -> ERA balanced
realization -> validated forced-response prediction; then optimized
DMD on unequally sampled snapshots and sparsity-promoting mode
selection on an overfit DMD.
"""
import numpy as np

from corrla_rs_tpu import DMD, OptDmd, era_okid, spdmd
from corrla_rs_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()
rng = np.random.default_rng(0)

# --- a hidden 3-state SISO plant, driven by noise -----------------------
a = np.array([[0.9, 0.2, 0.0], [0.0, 0.7, 0.3], [0.0, 0.0, 0.5]])
b = np.array([[1.0], [0.5], [-0.3]])
c = np.array([[1.0, -0.4, 0.2]])
d = np.array([[0.3]])
u = rng.standard_normal((1, 1000))
x = np.zeros(3)
y = np.empty((1, 1000))
for t in range(1000):
    y[:, t] = c @ x + d @ u[:, t]
    x = a @ x + b @ u[:, t]

fit = era_okid(u, y, rank=3, n_markov=30, n_obs=15)
print("ERA/OKID identified poles:", np.round(np.sort(fit.lambdas.real), 6))
print("          true poles:     ", [0.5, 0.7, 0.9])
print("Hankel singular values:   ", np.round(np.asarray(fit.hsv), 4))
u2 = rng.standard_normal((1, 100))
x = np.zeros(3)
y2 = np.empty((1, 100))
for t in range(100):
    y2[:, t] = c @ x + d @ u2[:, t]
    x = a @ x + b @ u2[:, t]
print("held-out response err:    ",
      float(np.max(np.abs(np.asarray(fit.predict(u2)) - y2))))

# --- optimized DMD on unequally sampled snapshots -----------------------
gaps = 0.05 + 0.1 * rng.random(150)
ts = np.concatenate([[0.0], np.cumsum(gaps)])
alphas = np.array([-0.05 + 1.2j, -0.05 - 1.2j])
phi = rng.standard_normal((16, 2)) + 1j * rng.standard_normal((16, 2))
phi[:, 1] = np.conj(phi[:, 0])
snaps = np.real(phi @ np.exp(np.outer(alphas, ts)))
ofit = OptDmd(snaps, 2, t=ts)
print("\nOptDmd on jittered sampling -> alphas:",
      np.round(ofit.alphas[np.argsort(ofit.alphas.imag)], 6))

# --- sparsity-promoting selection on an overfit DMD ---------------------
t_eq = np.arange(160)
lam3 = np.array([0.99 * np.exp(1j * 0.4), 0.99 * np.exp(-1j * 0.4), 0.9])
phi3 = rng.standard_normal((20, 3)) + 1j * rng.standard_normal((20, 3))
phi3[:, 1] = np.conj(phi3[:, 0])
xx = np.real(phi3 @ lam3[:, None] ** t_eq[None, :])
xx += 1e-5 * rng.standard_normal(xx.shape)
dfit = DMD(xx, 8)
sel = spdmd(dfit, xx, gammas=np.logspace(-8, 4, 13))
print("\nspDMD Pareto front (gamma -> nnz @ loss%):")
for g, k, p in zip(sel["gammas"], sel["nnz"], sel["ploss_pct"]):
    print(f"  {g:10.2e} -> {k} @ {p:.4f}%")
