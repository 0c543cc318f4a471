"""Batched on-device k-nearest-neighbor search.

Replaces the reference's KdTree (active_subspaces.rs:24,71-77,90-112) with
a dense pairwise-distance + ``lax.top_k`` formulation: O(N^2) FLOPs but matmul-
fast, fully vmappable, and exact. Memory is bounded on BOTH axes:

- ``query_chunk``: queries are processed in fixed-size chunks.
- ``support_chunk``: the support set streams through in chunks with a
  running top-k merge (concat the incumbent k best with the new chunk's
  candidates, re-top-k) — the full (n_q, n_s) distance matrix is never
  materialized, so million-point support sets fit on device. This is the
  SURVEY §7 "KdTree -> dense kNN memory at large N" answer: streaming
  tiles + top-k, XLA-fused (a hand-written Pallas variant was not needed
  — the merge is top_k/matmul-shaped and matmul/elementwise-bound already).

The C++ host kd-tree (native/) remains the better choice for huge-N,
*low-dimensional*, latency-sensitive single queries; this module wins for
batched queries on-device (no host round-trip, vmappable).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from corrla_rs_tpu.ops.interp import pairwise_dists

__all__ = ["knn"]


@functools.partial(
    jax.jit, static_argnames=("k", "query_chunk", "support_chunk")
)
def knn(x_query: jnp.ndarray, x_support: jnp.ndarray, k: int,
        query_chunk: int | None = None, support_chunk: int | None = None):
    """k nearest support points for each query point.

    Args:
      x_query: (n_q, d); x_support: (n_s, d); k: neighbors.
      query_chunk: process queries in chunks of this size (defaults to all
        at once). Bounds peak memory at (query_chunk, n_s or support_chunk).
      support_chunk: stream the support set in chunks of this size with a
        running top-k merge (defaults to all at once). Bounds peak memory
        at (n_q or query_chunk, support_chunk) — use for support sets too
        large for a dense distance matrix.
    Returns:
      (dists (n_q, k), idx (n_q, k)) sorted ascending by distance — matching
      the KdTree query order of active_subspaces.rs:90-112.
    """
    n_q = x_query.shape[0]
    n_s = x_support.shape[0]
    if k > n_s:
        raise ValueError(f"k={k} exceeds the support size {n_s}")

    if support_chunk is None or support_chunk >= n_s:
        def chunk_knn(xq):
            d = pairwise_dists(xq, x_support)
            neg_d, idx = lax.top_k(-d, k)
            return -neg_d, idx
    else:
        s_chunks = -(-n_s // support_chunk)
        s_pad = s_chunks * support_chunk - n_s
        xs_pad = jnp.pad(x_support, ((0, s_pad), (0, 0)))
        xs_blocks = xs_pad.reshape(s_chunks, support_chunk, -1)
        offsets = jnp.arange(s_chunks, dtype=jnp.int32) * support_chunk
        big = jnp.asarray(jnp.finfo(x_support.dtype).max, x_support.dtype)

        def chunk_knn(xq):
            nq = xq.shape[0]

            def merge(carry, blk):
                best_d, best_i = carry
                xs_blk, off = blk
                d = pairwise_dists(xq, xs_blk)          # (nq, support_chunk)
                col = off + jnp.arange(support_chunk, dtype=jnp.int32)
                # padded support rows must never win
                d = jnp.where((col < n_s)[None, :], d, big)
                cat_d = jnp.concatenate([best_d, d], axis=1)
                cat_i = jnp.concatenate(
                    [best_i, jnp.broadcast_to(col, (nq, support_chunk))],
                    axis=1,
                )
                neg_d, sel = lax.top_k(-cat_d, k)
                best_i = jnp.take_along_axis(cat_i, sel, axis=1)
                return (-neg_d, best_i), None

            init = (
                jnp.full((nq, k), big, x_support.dtype),
                jnp.zeros((nq, k), jnp.int32),
            )
            (best_d, best_i), _ = lax.scan(
                merge, init, (xs_blocks, offsets)
            )
            return best_d, best_i

    if query_chunk is None or query_chunk >= n_q:
        return chunk_knn(x_query)

    # pad to a multiple of query_chunk, scan over chunks
    n_chunks = -(-n_q // query_chunk)
    pad = n_chunks * query_chunk - n_q
    xq_pad = jnp.pad(x_query, ((0, pad), (0, 0)))
    xq_chunks = xq_pad.reshape(n_chunks, query_chunk, -1)
    d_chunks, i_chunks = lax.map(chunk_knn, xq_chunks)
    d_all = d_chunks.reshape(n_chunks * query_chunk, k)[:n_q]
    i_all = i_chunks.reshape(n_chunks * query_chunk, k)[:n_q]
    return d_all, i_all
