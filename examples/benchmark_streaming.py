"""Out-of-core streamed RSVD benchmark (matrices larger than HBM).

Streams an n x 10k f32 matrix that never resides on device (nor, with
the tiled source, on host) through ops/streaming's drivers on one GPU, and verifies the rank-100 singular values against the exact
identity sigma(A) = sqrt(n_tiles) * sigma(B) for A = [B; B; ...; B].

Usage: python examples/benchmark_streaming.py [--tiles 128] [--gb-only]

The reference factorizes anything fitting host RAM
(random_svd.rs:63-110); this driver is bounded by host *storage*.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

try:
    from corrla_rs_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
except Exception:
    pass

import jax



from corrla_rs_tpu.ops.streaming import (
    RowBlockSource,
    streamed_random_svd,
    streamed_single_pass_svd,
)

BLOCK_ROWS = 3200          # x 10k f32 = 128 MB/block
N_COLS = 10_000
RANK, N_ITER, N_OS = 100, 8, 10


def tiled_source(block: np.ndarray, n_tiles: int) -> RowBlockSource:
    """A = [B; B; ...; B] without materializing A anywhere."""
    b = block.shape[0]

    def fn(start, stop):
        # rows [start, stop) of the tiled matrix == block rows modulo b
        out = np.empty((stop - start, block.shape[1]), block.dtype)
        for i in range(start, stop):
            out[i - start] = block[i % b]
        return out

    return RowBlockSource(fn, (b * n_tiles, block.shape[1]), block.dtype)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", type=int, default=128,
                    help="number of 128 MB tiles (128 -> 16 GB)")
    ap.add_argument("--methods", default="gram,power,single",
                    help="comma list from {gram, power, single}")
    args = ap.parse_args()
    methods = set(args.methods.split(","))

    # block with an exactly known decaying spectrum: B = Ql diag(s) Qr^T
    # (sigma_i(B) = s_i by construction), so sigma_i(A) =
    # sqrt(n_tiles) * s_i analytically — a machine-exact oracle at scale
    rng = np.random.default_rng(0)
    r_spec = 150
    ql = np.linalg.qr(rng.standard_normal((BLOCK_ROWS, r_spec)))[0]
    qr_ = np.linalg.qr(rng.standard_normal((N_COLS, r_spec)))[0]
    s_true = 100.0 / np.arange(1, r_spec + 1, dtype=np.float64)
    block = ((ql * s_true[None, :]) @ qr_.T).astype(np.float32)
    src = tiled_source(block, args.tiles)
    n = src.shape[0]
    gb = n * N_COLS * 4 / 1e9
    print(f"matrix: {n} x {N_COLS} f32 = {gb:.1f} GB (streamed, "
          f"never device- or host-resident; spectrum i^-1, rank {r_spec})")
    s_oracle = np.sqrt(args.tiles) * s_true[:RANK]

    for method, passes in (("gram", 3), ("power", N_ITER + 2)):
        if method not in methods:
            continue
        t0 = time.perf_counter()
        _u, s, _vt = streamed_random_svd(
            src, RANK, N_ITER, N_OS, key=3, block_rows=BLOCK_ROWS,
            method=method,
        )
        s = np.asarray(s)          # sync
        wall = time.perf_counter() - t0
        rel = np.abs(s - s_oracle).max() / s_oracle.max()
        print(f"streamed_random_svd[{method:5s}]: {wall:7.2f} s "
              f"({passes} passes = {passes * gb:.0f} GB streamed, "
              f"{passes * gb / wall:.2f} GB/s effective)  "
              f"sigma rel err vs oracle {rel:.2e}")

    if "single" in methods:
        t0 = time.perf_counter()
        _u, s, _vt = streamed_single_pass_svd(
            src, RANK, N_OS, key=3, block_rows=BLOCK_ROWS
        )
        s = np.asarray(s)
        wall = time.perf_counter() - t0
        rel = np.abs(s - s_oracle).max() / s_oracle.max()
        print(f"streamed_single_pass_svd  : {wall:7.2f} s "
              f"(1 pass = {gb:.0f} GB streamed, {gb / wall:.2f} GB/s "
              f"effective)  sigma rel err vs oracle {rel:.2e} "
              f"(sketch-grade; tiled spectrum is rank-{N_COLS} gapless)")


if __name__ == "__main__":
    main()
