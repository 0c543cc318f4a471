"""Frozen configuration dataclasses — the library's single source of
hyperparameter defaults.

The reference scatters hardcoded hyperparameters at call sites (SURVEY.md
§5 "Config/flag system: none"; §2.4 item 9 lists them). These dataclasses
centralize the same defaults, env-independent, and the library CONSUMES
them: models.pca/pod/dmd/active_subspaces derive their module constants
from here and accept ``config=`` overrides; ops.dream and ops.samplers
take their signature defaults from DreamConfig / DemcConfig /
DirichletSamplerConfig; parallel.mesh.make_mesh_2d builds meshes from
MeshConfig.

- PCA: 20 power iterations, min(n_dim, 10) oversamples (pca_rsvd.rs:65-66)
- POD: 10 iterations, 10 oversamples (pod_rom.rs:56)
- DMDc: 12 oversamples (dmd_rom.rs:72,82)
- active-subspace fit_svd: 8 iterations, 10 oversamples
  (active_subspaces.rs:243)
- rejection sampler chunking (space_samplers.rs:98, benchmark defaults)
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RsvdConfig:
    n_iter: int = 10
    n_oversamples: int = 10
    # 'auto' resolves per-dtype: 'always' for f32, 'reference' for f64
    # (see ops.random_svd.power_iter)
    stabilize: str = "auto"
    qr_method: str = "auto"   # 'householder' (safest) / 'cholesky' (fast)


@dataclass(frozen=True)
class PcaConfig:
    n_iter: int = 20
    max_oversamples: int = 10
    stabilize: str = "auto"


@dataclass(frozen=True)
class PodConfig:
    n_iter: int = 10
    n_oversamples: int = 10


@dataclass(frozen=True)
class DmdConfig:
    n_oversamples: int = 12
    dt: float = 1.0


@dataclass(frozen=True)
class ActiveSsConfig:
    n_iter: int = 8
    n_oversamples: int = 10


@dataclass(frozen=True)
class DirichletSamplerConfig:
    max_zshots: int = 500
    chunk_size: int = 20000
    c_scale: float = 1.0


@dataclass(frozen=True)
class DemcConfig:
    gamma: float = 0.8
    var_epsilon: float = 1e-12


@dataclass(frozen=True)
class DreamConfig:
    delta_max: int = 3
    n_cr: int = 3
    gamma_jump_prob: float = 0.2
    b: float = 0.05
    b_star: float = 1e-6
    n_adapt: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """Multi-chip layout: rows axis for tall matrices, chains for MCMC."""
    rows: int = 1
    chains: int = 1
    axis_names: tuple = ("rows", "chains")
