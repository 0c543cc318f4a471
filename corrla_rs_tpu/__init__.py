"""corrla_rs_tpu — JAX/XLA rebuild of wgurecky/CORRLA_RS for the GPU.

A library for correlation analysis, randomized linear algebra, reduced-order
modeling (PCA / POD / DMDc), active-subspace identification, RBF
interpolation, constrained sampling, and DEMC/DREAM MCMC — designed
for an accelerator: every numeric path is jit-compiled XLA, and
tall-matrix / many-chain workloads shard over a ``jax.sharding.Mesh``.

The public surface mirrors the reference pyo3 module ``corrla_rs``
(reference: src/lib_math_utils_py.rs:17-176) so a user of the reference can
switch directly:

- ``rsvd(a, n_rank, n_iters, n_oversamples)``  -> (U, S, Vt)
- ``rpca(a, n_rank, n_iters, n_oversamples)``  -> (S, components)
- ``active_ss(x, y, order, n_nbr, n_comps)``   -> (comps, vals, sensi)
- ``cs_dirichlet_sample(bounds, n_samples, max_zshots, chunk_size, c_scale,
  alphas)``
- ``cs_mcmc_dirichlet_sample(bounds, n_samples, n_seed_samples, max_zshots,
  chunk_size, c_scale, alphas, gamma, var_epsilon)`` -> (samples, accept_ratio)
- classes ``RbfInterp`` (= PyRbfInterp), ``PodI`` (= PyPodI),
  ``DMDc`` (= PyDMDc), ``PcaRsvd``

Improvement over the reference: every routine takes an explicit ``seed`` /
``key`` argument (the reference uses unseedable ``thread_rng()`` throughout,
see reference mat_utils.rs:171).
"""

from corrla_rs_tpu.api import (
    rsvd,
    rpca,
    active_ss,
    cs_dirichlet_sample,
    cs_mcmc_dirichlet_sample,
)
from corrla_rs_tpu.models.pca import PcaRsvd
from corrla_rs_tpu.models.pod import PodI
from corrla_rs_tpu.models.dmd import DMD, DMDc
from corrla_rs_tpu.models.active_subspaces import (
    ActiveSsRsvd,
    AdGradientEstimator,
    FittedActiveSsRsvd,
    PolyGradientEstimator,
)
from corrla_rs_tpu.models.dmd import dmdc_fit_ensemble, rollout_ensemble
from corrla_rs_tpu.ops.copula import BivariateCopula, GaussianCopula
from corrla_rs_tpu.ops.deim import deim_points, deim_reconstruct
from corrla_rs_tpu.ops.gappy import (
    gappy_pod_fill,
    gappy_reconstruct,
    oversample_points,
)
from corrla_rs_tpu.ops.grassmann import (
    GrassmannInterp,
    grassmann_distance,
    grassmann_exp,
    grassmann_log,
    subspace_angles,
)
from corrla_rs_tpu.ops.id_cur import column_id, cur, row_id
from corrla_rs_tpu.ops.nystrom import nystrom_approx, nystrom_eigh
from corrla_rs_tpu.ops.tt import (
    tt_dot,
    tt_norm,
    tt_reconstruct,
    tt_round,
    tt_svd,
)
from corrla_rs_tpu.ops.design import (
    halton_sample,
    latin_hypercube,
    sobol_sample,
)
from corrla_rs_tpu.ops.eig import eig, eig_host
from corrla_rs_tpu.models.edmd import Edmd
from corrla_rs_tpu.models.kernel_dmd import KernelDmd
from corrla_rs_tpu.models.online_dmd import OnlineDmd
from corrla_rs_tpu.models.bop_dmd import BaggedDmd, bagged_dmd
from corrla_rs_tpu.ops.incremental import IncrementalPca, IncrementalSvd
from corrla_rs_tpu.ops.cca import Cca, cca
from corrla_rs_tpu.ops.pls import PlsRegressor, pls_fit
from corrla_rs_tpu.models.hankel_dmd import HankelDmd, hankel_embed
from corrla_rs_tpu.models.mrdmd import MrDmd, mrdmd
from corrla_rs_tpu.models.optdmd import BopDmd, OptDmd, bop_dmd
from corrla_rs_tpu.models.spod import Spod, spod
from corrla_rs_tpu.models.pidmd import PiDmd
from corrla_rs_tpu.models.era import Era, era, era_okid, okid
from corrla_rs_tpu.ops.completion import matrix_complete
from corrla_rs_tpu.ops.cp import cp_als, cp_reconstruct
from corrla_rs_tpu.ops.nmf import nmf
from corrla_rs_tpu.ops.kalman import dare, dlqr, kalman_filter, kalman_smooth
from corrla_rs_tpu.ops.robust_pca import robust_pca
from corrla_rs_tpu.ops.sketch_solve import sketched_lstsq
from corrla_rs_tpu.ops.trace_est import hutchinson_trace, hutchpp_trace
from corrla_rs_tpu.ops.spdmd import spdmd
from corrla_rs_tpu.ops.rank_select import (
    adaptive_random_svd,
    range_error_estimate,
    select_rank,
    svht_threshold,
)
from corrla_rs_tpu.ops.hosvd import (
    hooi,
    hosvd,
    mode_multiply,
    tucker_reconstruct,
)
from corrla_rs_tpu.ops.eig_device import eig_device, eigvals_device, schur
from corrla_rs_tpu.ops.morris import morris_screening, morris_trajectories
from corrla_rs_tpu.ops.pce import PolynomialChaos
from corrla_rs_tpu.ops.sobol import saltelli_plan, sobol_indices
from corrla_rs_tpu.ops.rvine import RVineCopula
from corrla_rs_tpu.ops.vine import CVineCopula
from corrla_rs_tpu.ops.diagnostics import (
    effective_sample_size,
    gelman_rubin,
    rank_normalized_rhat,
)
from corrla_rs_tpu.ops.dream import DreamSampler, dream_run
from corrla_rs_tpu.ops.ensemble_mcmc import EnsembleSampler, stretch_run
from corrla_rs_tpu.ops.bayes_opt import BayesOpt, bayes_opt_minimize
from corrla_rs_tpu.ops.bridge import bridge_sampling_evidence
from corrla_rs_tpu.ops.cma import CmaResult, cma_es
from corrla_rs_tpu.ops.cg import (
    cg_solve,
    jacobi_preconditioner,
    nystrom_preconditioner,
)
from corrla_rs_tpu.ops.hmc import hmc_run
from corrla_rs_tpu.ops.laplace import laplace_approx, laplace_sample
from corrla_rs_tpu.ops.nuts import nuts_run
from corrla_rs_tpu.ops.psis import importance_resample, psis
from corrla_rs_tpu.ops.shapley import (
    shapley_effects,
    shapley_effects_linear,
    shapley_effects_quadrature,
)
from corrla_rs_tpu.ops.quadrature import (
    clenshaw_curtis,
    gauss_hermite,
    gauss_legendre,
    integrate,
    smolyak_quadrature,
    tensor_quadrature,
)
from corrla_rs_tpu.ops.mlmc import MlmcResult, mlmc_estimate
from corrla_rs_tpu.ops.multifidelity import (
    control_variate_estimate,
    mfmc_design,
    mfmc_estimate,
)
from corrla_rs_tpu.ops.slq import (
    lanczos_fn_apply,
    lanczos_tridiag,
    slq_logdet,
    slq_spectral_sum,
)
from corrla_rs_tpu.ops.smc import smc_sample
from corrla_rs_tpu.ops.particle import particle_filter, ukf_filter
from corrla_rs_tpu.ops.gmm import (
    GmmFit,
    gmm_fit,
    gmm_logpdf,
    gmm_sample,
    gmm_select,
)
from corrla_rs_tpu.ops.enkf import (
    enkf_analysis,
    enkf_filter,
    esmda,
    etkf_analysis,
)
from corrla_rs_tpu.models.opinf import OpInf, kron2_compressed
from corrla_rs_tpu.models.sindy import Sindy
from corrla_rs_tpu.ops.gp import GpRegressor, SparseGpRegressor
from corrla_rs_tpu.ops.interp import RbfInterp
from corrla_rs_tpu.ops.random_svd import (
    block_krylov_svd,
    power_iter,
    random_svd,
    single_pass_svd,
)
from corrla_rs_tpu.ops.samplers import DeMcSampler, constr_dirichlet_sample
from corrla_rs_tpu.ops.streaming import (
    RowBlockSource,
    streamed_cov,
    streamed_dmdc,
    streamed_hosvd,
    streamed_pca,
    streamed_pearson_corr,
    streamed_pod,
    streamed_random_svd,
    streamed_single_pass_svd,
)
from corrla_rs_tpu.ops.univariate_rv import (
    BetaRv,
    ExponentialRv,
    KdeRv,
    NormalRv,
    build_kde,
)
from corrla_rs_tpu.utils.checkpoint import load_model, save_model
from corrla_rs_tpu.utils.debug import NonFiniteError, debug_enabled, set_debug

# Aliases matching the exact pyo3 class names (lib_math_utils_py.rs:179-283)
PyRbfInterp = RbfInterp
PyPodI = PodI


class PyDMDc(DMDc):
    """Binding-parity wrapper: the pyo3 PyDMDc's ``predict`` rolls the
    dynamics over a whole control sequence (it calls predict_multiple,
    lib_math_utils_py.rs:273-282). ``DMDc.predict`` keeps the Rust-core
    single-step semantics (dmd_rom.rs:185-194)."""

    def predict(self, x_0, u_seq, method: str = "dense"):
        return self.predict_multiple(x_0, u_seq, method=method)

__version__ = "0.3.0"

__all__ = [
    "rsvd",
    "rpca",
    "active_ss",
    "cs_dirichlet_sample",
    "cs_mcmc_dirichlet_sample",
    "random_svd",
    "power_iter",
    "block_krylov_svd",
    "single_pass_svd",
    "PcaRsvd",
    "PodI",
    "DMD",
    "DMDc",
    "RbfInterp",
    "ActiveSsRsvd",
    "FittedActiveSsRsvd",
    "PolyGradientEstimator",
    "AdGradientEstimator",
    "DeMcSampler",
    "DreamSampler",
    "dream_run",
    "EnsembleSampler",
    "stretch_run",
    "hmc_run",
    "nuts_run",
    "gauss_legendre",
    "gauss_hermite",
    "clenshaw_curtis",
    "tensor_quadrature",
    "smolyak_quadrature",
    "integrate",
    "shapley_effects",
    "psis",
    "importance_resample",
    "shapley_effects_linear",
    "shapley_effects_quadrature",
    "laplace_approx",
    "laplace_sample",
    "cg_solve",
    "jacobi_preconditioner",
    "nystrom_preconditioner",
    "lanczos_fn_apply",
    "BayesOpt",
    "cma_es",
    "bayes_opt_minimize",
    "smc_sample",
    "particle_filter",
    "GmmFit",
    "gmm_fit",
    "gmm_logpdf",
    "gmm_sample",
    "gmm_select",
    "ukf_filter",
    "enkf_analysis",
    "enkf_filter",
    "esmda",
    "etkf_analysis",
    "bridge_sampling_evidence",
    "slq_logdet",
    "slq_spectral_sum",
    "lanczos_tridiag",
    "mfmc_design",
    "mlmc_estimate",
    "mfmc_estimate",
    "control_variate_estimate",
    "Sindy",
    "OpInf",
    "kron2_compressed",
    "constr_dirichlet_sample",
    "NormalRv",
    "BetaRv",
    "ExponentialRv",
    "KdeRv",
    "build_kde",
    "GpRegressor",
    "SparseGpRegressor",
    "latin_hypercube",
    "sobol_sample",
    "halton_sample",
    "GaussianCopula",
    "BivariateCopula",
    "CVineCopula",
    "RVineCopula",
    "eig",
    "eig_host",
    "eig_device",
    "eigvals_device",
    "schur",
    "sobol_indices",
    "saltelli_plan",
    "morris_screening",
    "morris_trajectories",
    "column_id",
    "row_id",
    "cur",
    "nystrom_eigh",
    "nystrom_approx",
    "tt_svd",
    "tt_reconstruct",
    "tt_round",
    "tt_dot",
    "tt_norm",
    "deim_points",
    "deim_reconstruct",
    "gappy_reconstruct",
    "gappy_pod_fill",
    "oversample_points",
    "GrassmannInterp",
    "grassmann_log",
    "grassmann_exp",
    "subspace_angles",
    "grassmann_distance",
    "PolynomialChaos",
    "hosvd",
    "hooi",
    "tucker_reconstruct",
    "mode_multiply",
    "dmdc_fit_ensemble",
    "rollout_ensemble",
    "RowBlockSource",
    "streamed_random_svd",
    "streamed_single_pass_svd",
    "streamed_pca",
    "streamed_pod",
    "streamed_dmdc",
    "streamed_cov",
    "streamed_pearson_corr",
    "streamed_hosvd",
    "IncrementalSvd",
    "IncrementalPca",
    "OnlineDmd",
    "Edmd",
    "KernelDmd",
    "BaggedDmd",
    "bagged_dmd",
    "Cca",
    "cca",
    "PlsRegressor",
    "pls_fit",
    "HankelDmd",
    "hankel_embed",
    "MrDmd",
    "mrdmd",
    "OptDmd",
    "BopDmd",
    "bop_dmd",
    "Spod",
    "spod",
    "PiDmd",
    "Era",
    "era",
    "okid",
    "era_okid",
    "spdmd",
    "sketched_lstsq",
    "dare",
    "kalman_filter",
    "kalman_smooth",
    "dlqr",
    "robust_pca",
    "cp_als",
    "cp_reconstruct",
    "nmf",
    "matrix_complete",
    "hutchinson_trace",
    "hutchpp_trace",
    "svht_threshold",
    "select_rank",
    "range_error_estimate",
    "adaptive_random_svd",
    "gelman_rubin",
    "rank_normalized_rhat",
    "effective_sample_size",
    "save_model",
    "load_model",
    "set_debug",
    "debug_enabled",
    "NonFiniteError",
    "PyRbfInterp",
    "PyPodI",
    "PyDMDc",
]
