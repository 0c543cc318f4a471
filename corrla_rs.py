"""Drop-in compatibility shim: ``import corrla_rs`` works unchanged.

Users of the reference pyo3 module (reference lib_math_utils_py.rs:17-176)
can keep their imports; every name resolves to the JAX
implementation in corrla_rs_tpu.
"""
from corrla_rs_tpu import (  # noqa: F401
    DMDc,
    PcaRsvd,
    PodI,
    PyDMDc,
    PyPodI,
    PyRbfInterp,
    RbfInterp,
    active_ss,
    cs_dirichlet_sample,
    cs_mcmc_dirichlet_sample,
    rpca,
    rsvd,
)
