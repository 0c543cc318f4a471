"""Functional public API mirroring the reference pyo3 module ``corrla_rs``.

Signatures and return shapes match reference lib_math_utils_py.rs:17-176
exactly (singular values returned as (r, 1) column matrices, as the pyo3
layer does via ``s_diagonal().as_2d()``), with one strict improvement: an
optional trailing ``seed`` argument makes every routine reproducible.
"""
from __future__ import annotations

import jax.numpy as jnp

from corrla_rs_tpu.ops.random_svd import random_svd
from corrla_rs_tpu.utils.debug import guard_finite
from corrla_rs_tpu.utils.prng import as_key


@guard_finite
def rsvd(a_mat, n_rank: int, n_iters: int, n_oversamples: int, seed=0):
    """Randomized SVD. Parity with pyfn rsvd (lib_math_utils_py.rs:21-36).

    Returns (U (m, r), S (r, 1), Vt (r, n)).
    """
    from corrla_rs_tpu.utils.smallpath import maybe_route_small

    (a_mat,) = maybe_route_small(a_mat)
    a = jnp.asarray(a_mat)
    u, s, vt = random_svd(a, n_rank, n_iters, n_oversamples, key=as_key(seed))
    return u, s[:, None], vt


@guard_finite
def rpca(a_mat, n_rank: int, n_iters: int = None, n_oversamples: int = None,
         seed=0):
    """PCA via RSVD. Parity with pyfn rpca (lib_math_utils_py.rs:38-55).

    Note: like the reference binding, ``n_iters``/``n_oversamples`` are
    accepted but the PCA model uses its own hardcoded defaults
    (PcaRsvd::new ignores them; pca_rsvd.rs:65-66). Returns
    (singular_values (r, 1), components (r, n_dim)).
    """
    from corrla_rs_tpu.models.pca import PcaRsvd

    # raw input straight through: PcaRsvd.fit routes small problems to
    # the CPU backend BEFORE any device placement (an eager jnp.asarray
    # here would transfer to the accelerator just to come back)
    pca = PcaRsvd(a_mat, n_rank, key=as_key(seed))
    return pca.singular_values[:, None], pca.components


@guard_finite
def active_ss(x, y, order: int, n_nbr: int, n_comps: int):
    """Active-subspace id + sensitivity. Parity with pyfn active_ss
    (lib_math_utils_py.rs:57-87): local-poly gradient estimator, the EVD
    ``fit`` path (not fit_svd — lib_math_utils_py.rs:75-76), Constantine-
    Diaz sensitivities.

    Returns (components (k, n_comps), singular_vals (k, n_comps),
    sensi (k,)).
    """
    from corrla_rs_tpu.models.active_subspaces import (
        ActiveSsRsvd,
        PolyGradientEstimator,
    )
    from corrla_rs_tpu.utils.smallpath import maybe_route_small

    # the kNN distance matrix is the dominant shape
    n = jnp.shape(x)[0] if hasattr(x, "shape") else len(x)
    x, y = maybe_route_small(x, y, work_elems=n * n)
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    grad_est = PolyGradientEstimator(x, y, order, n_nbr)
    fitted = ActiveSsRsvd(grad_est, n_comps).fit(x)
    return fitted.components, fitted.singular_vals, fitted.var_diag_evd_sensi()


@guard_finite
def cs_dirichlet_sample(bounds, n_samples: int, max_zshots: int,
                        chunk_size: int, c_scale: float, alphas, seed=0):
    """Constrained Dirichlet rejection sampling. Parity with pyfn
    cs_dirichlet_sample (lib_math_utils_py.rs:89-105)."""
    from corrla_rs_tpu.ops.samplers import constr_dirichlet_sample

    return constr_dirichlet_sample(
        bounds, n_samples, max_zshots, chunk_size, c_scale, alphas,
        key=as_key(seed),
    )


@guard_finite
def cs_mcmc_dirichlet_sample(bounds, n_samples: int, n_seed_samples: int,
                             max_zshots: int, chunk_size: int, c_scale: float,
                             alphas, gamma: float, var_epsilon: float, seed=0):
    """Hybrid rejection-seeded DEMC sampling of the bounded simplex.

    Full-pipeline parity with pyfn cs_mcmc_dirichlet_sample
    (lib_math_utils_py.rs:107-168): rejection seeds -> Dirichlet(1) target
    x uniform box prior -> simplex-renormalizing proposal fixup -> parallel
    DEMC -> (interleaved samples, acceptance ratio). Seeds form the chains
    (one chain per seed), so n_seed_samples >= 3.

    Small populations (n_seed_samples below ``smallpath.SAMPLER_CHAINS``)
    with an integer seed run the compiled C++ host pipeline
    (native.demc_dirichlet_host): at reference scale (12 chains x 3000
    samples) per-generation kernel launches dominate on any device, and
    the host loop takes 12 ms on the H100's host. Same statistical
    contract; draws differ from the JAX path (different RNG).
    """
    import numpy as np

    from corrla_rs_tpu.ops.samplers import (
        DeMcSampler,
        constr_dirichlet_sample,
        ln_like_dirichlet,
        ln_like_sum,
        ln_prior_uniform,
    )
    from corrla_rs_tpu.utils.prng import split_key

    # host numpy: the array is only consumed as trace-time constants and
    # by the (internally routed) samplers — a jnp constant here would
    # cost an accelerator dispatch per call
    bounds = np.asarray(bounds, dtype=np.float64)
    from corrla_rs_tpu import native
    from corrla_rs_tpu.utils.smallpath import SAMPLER_CHAINS

    if (
        isinstance(seed, (int, np.integer))
        and int(n_seed_samples) < SAMPLER_CHAINS
        and native.available()
    ):
        seeds = native.cs_dirichlet_rejection_host(
            bounds, int(n_seed_samples), int(max_zshots), int(chunk_size),
            float(c_scale), alphas, seed=int(seed) * 2 + 1,
        )
        samples, ar = native.demc_dirichlet_host(
            bounds, seeds, int(n_samples), gamma=float(gamma),
            var_epsilon=float(var_epsilon), c_scale=float(c_scale),
            alphas=np.ones(bounds.shape[0]),  # Dirichlet(1) target
            seed=int(seed) * 2 + 2,
        )
        return samples, ar

    k_seed, k_mcmc = split_key(seed)
    seeds = constr_dirichlet_sample(
        bounds, n_seed_samples, max_zshots, chunk_size, c_scale, alphas,
        key=k_seed,
    )
    # target is uniform-in-z Dirichlet(1,...,1) (lib_math_utils_py.rs:129)
    ndim = bounds.shape[0]
    ln_post = ln_like_sum(
        ln_like_dirichlet(np.ones(ndim)), ln_prior_uniform(bounds)
    )

    def fixup(x):
        return c_scale * x / jnp.sum(x)

    sampler = DeMcSampler(
        ln_post, seeds, gamma, var_epsilon, prop_fixup_fn=fixup, key=k_mcmc
    )
    sampler.sample_mcmc(n_samples)
    return sampler.get_samples(n_samples), sampler.accept_ratio()
