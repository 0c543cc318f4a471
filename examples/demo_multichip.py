"""Multi-chip workflows on a device mesh.

Runs on any device population; when fewer than 8 devices are attached
(e.g. a single-GPU host) it provisions a virtual 8-device
CPU backend, exactly like tests/conftest.py — the shardings, collectives
and numerics are identical to a real 8-device mesh, only the transport
differs.

Demonstrates every sharded path in the library:
  1. row-sharded randomized SVD (psum Gram + distributed TSQR)
  2. PCA / POD / DMDc fits with ``mesh=``
  3. chain-sharded DEMC and DREAM (per-generation head all_gather)
  4. sample-sharded active subspaces
  5. GSPMD data-parallel stats (no dedicated kernel needed)
"""
import jax

# Must run before any backend use (jax.devices() would lock the platform).
try:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
except RuntimeError:
    # backend already initialized (e.g. interactive use) — proceed if it
    # has enough devices
    if len(jax.devices()) < 8:
        raise SystemExit("need 8 devices (or run this script standalone)")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from corrla_rs_tpu import DMDc, PcaRsvd, PodI  # noqa: E402
from corrla_rs_tpu.models.active_subspaces import (  # noqa: E402
    ActiveSsRsvd,
    PolyGradientEstimator,
)
from corrla_rs_tpu.ops.samplers import ln_like_sum, ln_prior_uniform  # noqa: E402
from corrla_rs_tpu.ops.stats_corr import pearson_corr  # noqa: E402
from corrla_rs_tpu.parallel.mesh import (  # noqa: E402
    CHAINS_AXIS,
    make_mesh,
    shard_rows,
)
from corrla_rs_tpu.parallel.sharded_rsvd import sharded_random_svd  # noqa: E402
from corrla_rs_tpu.parallel.sharded_samplers import (  # noqa: E402
    demc_run_sharded,
    dream_run_sharded,
)

rng = np.random.default_rng(0)
mesh = make_mesh(8)
print(f"mesh: {mesh.shape} over {jax.default_backend()}")

# 1) row-sharded RSVD — the tall sample axis lives across chips
a = jnp.asarray(rng.standard_normal((4000, 64)), jnp.float32)
u, s, vt = sharded_random_svd(a, 8, 8, 8, key=0, mesh=mesh)
print(f"sharded rsvd: U row-sharded as {u.sharding.spec}, s[0]={float(s[0]):.3f}")

# 2) models take mesh= directly
pca = PcaRsvd(a, 4, mesh=mesh)
print(f"sharded PCA:  explained var {np.asarray(pca.explained_var()).round(2)}")

nx, ns = 800, 16
xg = np.linspace(0, 10, nx)
tg = np.linspace(1, 9, ns)[:, None]
snaps = jnp.asarray((0.5 * tg) * np.exp(-((xg[None, :] - tg) ** 2) / 4.0))
pod = PodI(snaps, jnp.asarray(tg), 4, mesh=mesh)
print(f"sharded POD:  predict(5.0) -> field of {pod.predict(jnp.array([[5.0]])).shape}")

tp = np.linspace(0, 10, 30)
useq = np.exp(0.2 * tp)[None, :].astype(np.float32)
dm_snaps = (np.sin(np.linspace(0, 10, 160)[:, None] + 0.2 * tp[None, :])
            * useq).astype(np.float32)
dmd = DMDc(jnp.asarray(dm_snaps), jnp.asarray(useq), 8, 20, mesh=mesh)
print(f"sharded DMDc: dominant |lambda| = {np.abs(dmd.lambdas).max():.4f}")

# 3) chain-sharded MCMC — heads all_gather per generation over "chains"
cmesh = make_mesh(8, axis_name=CHAINS_AXIS)
lnp = ln_like_sum(
    lambda x: -0.5 * jnp.sum(((x - 2.0) / 3.0) ** 2),
    ln_prior_uniform(np.array([[-20.0, 20.0]])),
)
heads0 = jnp.zeros((64, 1), jnp.float32)
hist, heads, ar = demc_run_sharded(heads0, lnp, 500, gamma=0.8,
                                   var_epsilon=1e-10, key=0, mesh=cmesh)
print(f"sharded DEMC:  64 chains x 500 gens, accept {ar:.2f}, "
      f"mean {float(jnp.mean(hist[-200:])):.2f}")
hist_d, _, ar_d = dream_run_sharded(heads0 + jnp.linspace(-1, 1, 64)[:, None],
                                    lnp, 500, key=1, n_adapt=200, mesh=cmesh)
print(f"sharded DREAM: accept {ar_d:.2f}, "
      f"mean {float(jnp.mean(hist_d[-200:])):.2f}")

# 4) sample-sharded active subspaces
x = rng.uniform(-1, 1, (320, 3))
y = 0.1 * x[:, 0] + 5.0 * x[:, 1] + 0.3 * x[:, 2] + 2.0 * x[:, 1] ** 2
ge = PolyGradientEstimator(jnp.asarray(x), jnp.asarray(y), 2, 16)
fitted = ActiveSsRsvd(ge, 2).fit(jnp.asarray(x), mesh=mesh)
print(f"sharded active-ss: dominant dir "
      f"{np.abs(np.asarray(fitted.components)[:, 0]).argmax()} (want 1)")

# 5) data-parallel stats come free from GSPMD
x_sh = shard_rows(jnp.asarray(rng.standard_normal((8000, 6))), mesh)
corr = jax.jit(pearson_corr)(x_sh)
print(f"GSPMD pearson on row-sharded data: diag = {np.diagonal(corr).round(6)}")
print("multichip demo OK")
