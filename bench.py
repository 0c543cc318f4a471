"""Benchmark: one JSON line per metric, on the GPU.

The headline, a rank-100 randomized SVD of a 100k x 10k f32 matrix, runs
first and its line is printed again as the last line. Every other metric
prints one line in between. A phase that raises ends the bench with a
non-zero exit code, and so does a run whose first device is not a GPU.

Metrics:
- rsvd_100kx10k_f32_rank100_wall (headline, first and last)
- cs_mcmc_3000x12_wall (the reference's own hybrid-MCMC workload)
- dream_samples_per_sec_8192ch
- ensemble_dmdc_16x_wall
- single_pass_svd_100kx10k_wall

``CORRLA_BENCH_SMOKE=1`` runs tiny shapes on the CPU so the emission
contract can be tested without a GPU; its numbers mean nothing.
"""
from __future__ import annotations

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
from jax import lax

N_ROWS, N_COLS, RANK, N_ITER, N_OVERSAMPLES = 100_000, 10_000, 100, 8, 10

# Arguments of the headline random_svd call. On the GPU, Precision.HIGH
# means TF32 and missed the 1e-6 sigma bar against a float64 run on the
# same sketch (2.1e-6 on an H100); HIGHEST met it (1.4e-7). chip_smoke.py's
# rsvd phase checks this setting.
HEADLINE_KW = dict(
    stabilize="always", qr_method="cholesky",
    power_precision=lax.Precision.HIGHEST,
)

_SMOKE = bool(os.environ.get("CORRLA_BENCH_SMOKE"))
if _SMOKE:
    N_ROWS, N_COLS, RANK, N_ITER = 2000, 256, 8, 2


def _emit_line(line: dict) -> None:
    print(json.dumps(line), flush=True)


def _metric_line(metric, value, unit) -> dict:
    return {
        "metric": metric,
        "value": round(float(value), 6),
        "unit": unit,
        "vs_baseline": None,
        "baseline": None,
    }


def _min_wall(fn, reps=5):
    jax.block_until_ready(fn())  # compile
    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return min(times)


def bench_headline_rsvd() -> dict:
    from corrla_rs_tpu.ops.random_svd import random_svd

    a = jax.block_until_ready(jax.random.normal(
        jax.random.key(0), (N_ROWS, N_COLS), dtype=jnp.float32))
    key = jax.random.key(7)
    wall = _min_wall(lambda: random_svd(
        a, RANK, N_ITER, N_OVERSAMPLES, key=key, **HEADLINE_KW))
    return _metric_line("rsvd_100kx10k_f32_rank100_wall", wall, "s")


def bench_small_mcmc() -> dict:
    """The reference's benchmark workload (benchmark_dirichlet_sampler.py):
    cs_mcmc_dirichlet_sample, 3000 generations x 12 chains."""
    import numpy as np

    from corrla_rs_tpu.api import cs_mcmc_dirichlet_sample

    bounds = np.array([[0.0, 0.0026], [0.1955, 0.1995], [0.80, 0.825]])

    def run():
        s, _ar = cs_mcmc_dirichlet_sample(
            bounds, 3000, 12, 500, 10_000, 1.0, 0.6, 0.8, 1e-12, seed=7
        )
        return s

    wall = _min_wall(run, reps=3)
    return _metric_line("cs_mcmc_3000x12_wall", wall, "s")


def bench_dream() -> dict:
    import numpy as np

    from corrla_rs_tpu.ops.dream import dream_run

    n_chains, ndim, n_steps = (64, 3, 20) if _SMOKE else (8192, 3, 500)

    def lnp(x):
        return -0.5 * jnp.sum(x * x)

    heads0 = jnp.asarray(
        np.random.default_rng(0).standard_normal((n_chains, ndim)),
        jnp.float32,
    )
    wall = _min_wall(lambda: dream_run(heads0, lnp, n_steps, key=1)[0],
                     reps=3)
    return _metric_line("dream_samples_per_sec_8192ch",
                        n_chains * n_steps / wall, "samples/s")


def bench_ensemble_dmdc() -> dict:
    from corrla_rs_tpu.models.dmd import dmdc_fit_ensemble

    n_mem, nx, nt = (2, 20, 40) if _SMOKE else (16, 20, 40)
    t = jnp.linspace(0.0, 1.0, nt, dtype=jnp.float32)
    uc = jnp.exp(t)[None, :]
    snap = jnp.sin(
        jnp.linspace(0, 3, nx, dtype=jnp.float32)[:, None] + t[None, :]
    ) * uc
    ens = jnp.broadcast_to(snap, (n_mem, nx, nt)) * (
        1.0 + 1e-3 * jnp.arange(n_mem, dtype=jnp.float32)[:, None, None]
    )
    u_b = jnp.broadcast_to(uc, (n_mem,) + uc.shape)
    wall = _min_wall(
        lambda: dmdc_fit_ensemble(ens, u_b, n_modes=6, n_iters=20, key=2))
    return _metric_line("ensemble_dmdc_16x_wall", wall, "s")


def bench_single_pass() -> dict:
    from corrla_rs_tpu.ops.random_svd import single_pass_svd

    a = jax.block_until_ready(jax.random.normal(
        jax.random.key(0), (N_ROWS, N_COLS), dtype=jnp.float32))
    wall = _min_wall(lambda: single_pass_svd(a, RANK, N_OVERSAMPLES, key=4))
    return _metric_line("single_pass_svd_100kx10k_wall", wall, "s")


PHASES = [bench_small_mcmc, bench_dream, bench_ensemble_dmdc,
          bench_single_pass]


def main() -> int:
    if _SMOKE:
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        print(f"bench.py: needs a GPU, JAX found {jax.devices()[0].platform}",
              file=sys.stderr)
        return 2
    from corrla_rs_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    headline = bench_headline_rsvd()
    _emit_line(headline)
    for phase in PHASES:
        _emit_line(phase())
    _emit_line(headline)
    return 0


if __name__ == "__main__":
    sys.exit(main())
