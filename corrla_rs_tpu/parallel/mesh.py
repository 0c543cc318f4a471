"""Device-mesh construction and sharding vocabulary.

This is the rebuild's communication backend (the reference has none — its
only parallelism is single-process Rayon threading, SURVEY.md §2.2). One
module owns:

- mesh construction (`make_mesh`) over one host's devices or several
  hosts (multi-host via jax.distributed, handled transparently by jax),
- canonical axis names: ``"rows"`` for sharding the tall/sample dimension
  of data matrices (RSVD/PCA/POD/DMD), ``"chains"`` for sharding MCMC
  chain populations,
- helpers for row-sharded placement of big matrices.

Collectives used by the sharded kernels: ``psum`` for Gram-product
reductions over the interconnect, ``all_gather`` for per-step DEMC chain heads.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROWS_AXIS = "rows"
CHAINS_AXIS = "chains"

__all__ = [
    "ROWS_AXIS",
    "CHAINS_AXIS",
    "init_distributed",
    "make_mesh",
    "make_mesh_2d",
    "row_sharding",
    "replicated_sharding",
    "shard_rows",
]


def init_distributed(**kwargs) -> None:
    """Initialize multi-host JAX (DCN) — thin passthrough to
    ``jax.distributed.initialize``. Call once per host before building
    meshes; single-host/single-process setups don't need it."""
    jax.distributed.initialize(**kwargs)


def make_mesh(n_devices: int | None = None, axis_name: str = ROWS_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def make_mesh_2d(config=None, rows: int | None = None,
                 chains: int | None = None) -> Mesh:
    """2-D ("rows", "chains") mesh from a utils.config.MeshConfig (or
    explicit axis sizes). rows * chains must not exceed the device count;
    axis names follow config.axis_names."""
    from corrla_rs_tpu.utils.config import MeshConfig

    cfg = config or MeshConfig(
        rows=rows or 1, chains=chains or 1
    )
    rows = rows if rows is not None else cfg.rows
    chains = chains if chains is not None else cfg.chains
    devs = jax.devices()
    if rows * chains > len(devs):
        raise ValueError(
            f"mesh {rows}x{chains} needs {rows * chains} devices, "
            f"have {len(devs)}"
        )
    grid = np.array(devs[: rows * chains]).reshape(rows, chains)
    return Mesh(grid, tuple(cfg.axis_names))


def row_sharding(mesh: Mesh, axis_name: str | None = None) -> NamedSharding:
    """Sharding that splits axis 0 of a matrix across the mesh."""
    axis_name = axis_name or mesh.axis_names[0]
    return NamedSharding(mesh, P(axis_name, None))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_rows(a, mesh: Mesh):
    """Place a matrix row-sharded on the mesh (device_put)."""
    return jax.device_put(a, row_sharding(mesh))
