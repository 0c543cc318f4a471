"""Measure the tables the code keeps for the GPU.

1. The XLA RBF matvec ``rbf_kernel_eval(pairwise_dists(q, s)) @ c`` at
   16,384 queries x 65,536 support points (d=3, f32): median wall and the
   (M, N) intermediate it materialises. This is the bar a fused kernel
   would have to beat.
2. The headline RSVD (100k x 10k f32, rank 100, 8 iterations) with each
   power-iteration precision: sigma error against a float64 run on the
   same sketch, and median wall.
3. The small-problem routing crossover (utils/smallpath): ``api.rsvd`` at
   three sizes below 1M elements and ``dream_run`` at 64, 512 and 2048
   chains, with the inputs committed to the CPU versus left on the GPU.

    python examples/measure_gpu_tables.py [--only rbf,precision,routing]

Every wall is the median of several calls after a warm-up call, each
ended by ``jax.block_until_ready``. Needs a GPU.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def median_wall(fn, reps=7):
    import jax

    jax.block_until_ready(fn())
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def measure_rbf():
    import jax
    import jax.numpy as jnp

    from corrla_rs_tpu.ops.interp import pairwise_dists, rbf_kernel_eval
    from corrla_rs_tpu.ops.mat_utils import PRECISION

    m, n = 16_384, 65_536
    kq, ks, kc = jax.random.split(jax.random.key(0), 3)
    q = jax.random.uniform(kq, (m, 3), jnp.float32)
    s = jax.random.uniform(ks, (n, 3), jnp.float32)
    c = jax.random.normal(kc, (n, 1), jnp.float32)

    @jax.jit
    def matvec(q, s, c):
        k = rbf_kernel_eval(pairwise_dists(q, s), "multiquadric", 1.0)
        return jnp.matmul(k, c, precision=PRECISION)

    mem = matvec.lower(q, s, c).compile().memory_analysis()
    wall = median_wall(lambda: matvec(q, s, c), reps=10)
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")
    # float64 check on 256 query rows
    with jax.enable_x64(True):
        q64 = jnp.asarray(q[:256], jnp.float64)
        s64 = jnp.asarray(s, jnp.float64)
        d = jnp.sqrt(jnp.sum((q64[:, None, :] - s64[None, :, :]) ** 2, -1))
        ref = np.asarray(jnp.sqrt(1.0 + d * d) @ jnp.asarray(c, jnp.float64))
    got = np.asarray(matvec(q, s, c)[:256], np.float64)
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    print(f"[rbf] XLA multiquadric matvec {m}x{n} d=3 f32: median "
          f"{wall * 1e3:.3f} ms; temp_size_in_bytes="
          f"{mem.temp_size_in_bytes}; peak_bytes_in_use={peak}; "
          f"rel err vs float64 {err:.2e}", flush=True)


def measure_precision():
    import jax
    import jax.numpy as jnp
    from jax import lax

    import bench
    import chip_smoke
    from corrla_rs_tpu.ops.random_svd import random_svd

    a = jax.block_until_ready(jax.random.normal(
        jax.random.key(0), (100_000, 10_000), jnp.float32))
    key = jax.random.key(7)
    omega = jax.random.normal(key, (10_000, 110), jnp.float32)
    s_ref = chip_smoke.rsvd_reference_f64(a, omega, 8)[:100]
    options = [lax.Precision.HIGH, lax.Precision.HIGHEST,
               lax.DotAlgorithmPreset.BF16_BF16_F32_X3,
               lax.DotAlgorithmPreset.TF32_TF32_F32_X3]
    for prec in options:
        kw = dict(bench.HEADLINE_KW, power_precision=prec)
        try:
            fn = lambda: random_svd(a, 100, 8, 10, key=key, **kw)  # noqa: E731
            wall = median_wall(fn, reps=5)
        except Exception as exc:  # an algorithm XLA cannot lower here
            print(f"[precision] {prec}: not available "
                  f"({type(exc).__name__}: {str(exc)[:160]})", flush=True)
            continue
        s = np.asarray(fn()[1], np.float64)
        err = np.max(np.abs(s - s_ref) / s_ref)
        print(f"[precision] {prec}: max rel sigma err {err:.3e}; median "
              f"{wall * 1e3:.3f} ms", flush=True)


def measure_routing():
    import jax
    import jax.numpy as jnp

    from corrla_rs_tpu import api
    from corrla_rs_tpu.ops.dream import dream_run
    from corrla_rs_tpu.utils import smallpath

    cpu = jax.devices("cpu")[0]
    smallpath.set_small_path_threshold(0)  # placement decides, not routing
    rng = np.random.default_rng(0)
    for rows, cols in ((1_000, 100), (2_000, 250), (1_000, 1_000)):
        a = rng.standard_normal((rows, cols)).astype(np.float32)
        a_cpu = jax.device_put(a, cpu)
        t_gpu = median_wall(lambda: api.rsvd(a, 10, 8, 10, 0))
        t_cpu = median_wall(lambda: api.rsvd(a_cpu, 10, 8, 10, 0))
        print(f"[routing] api.rsvd {rows}x{cols} ({rows * cols} elements), "
              f"rank 10: gpu {t_gpu * 1e3:.3f} ms, cpu {t_cpu * 1e3:.3f} ms",
              flush=True)

    def lnp(x):
        return -0.5 * jnp.sum(x * x)

    for chains in (64, 512, 2048):
        h = rng.standard_normal((chains, 3)).astype(np.float32)
        h_cpu = jax.device_put(h, cpu)
        t_gpu = median_wall(lambda: dream_run(h, lnp, 500, key=1)[0], reps=5)
        t_cpu = median_wall(lambda: dream_run(h_cpu, lnp, 500, key=1)[0],
                            reps=5)
        print(f"[routing] dream_run {chains} chains x 3 dims x 500 gens: "
              f"gpu {t_gpu * 1e3:.3f} ms, cpu {t_cpu * 1e3:.3f} ms",
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="rbf,precision,routing")
    args = ap.parse_args()
    try:
        info = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        info = f"unavailable ({exc})"
    print(f"nvidia-smi: {info}", flush=True)

    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit("measure_gpu_tables.py needs a GPU")
    from corrla_rs_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    todo = args.only.split(",")
    # rbf first: its peak_bytes_in_use is then its own
    for name, fn in (("rbf", measure_rbf), ("precision", measure_precision),
                     ("routing", measure_routing)):
        if name in todo:
            fn()


if __name__ == "__main__":
    main()
