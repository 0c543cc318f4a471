"""Multi-chip DEMC: chain population sharded over the mesh.

Each DEMC proposal reads the heads of two random *other* chains
(space_samplers.rs:326-347), so chains can't advance independently: per
step the (n_chains, ndim) head block — tiny — is ``all_gather``-ed over
the interconnect while histories stay sharded. This is the SURVEY.md §2.2 row-3 design:
"chains sharded with all_gather of head states per step".

Statistically identical to ops.samplers.demc_run (same proposal/accept
math); RNG streams differ only in key-split layout.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from corrla_rs_tpu.ops.dream import _cr_histogram
from corrla_rs_tpu.ops.samplers import _pick_two_others
from corrla_rs_tpu.parallel.mesh import CHAINS_AXIS, make_mesh
from corrla_rs_tpu.utils.prng import as_key

__all__ = ["demc_run_sharded", "dream_run_sharded", "stretch_run_sharded"]


@functools.partial(
    jax.jit,
    static_argnames=("ln_prob_fn", "n_steps", "prop_fixup_fn", "mesh",
                     "axis_name"),
)
def _demc_sharded_jit(heads, ln_prob_fn, n_steps, gamma, var_epsilon, key,
                      prop_fixup_fn, mesh, axis_name):
    n_chains, ndim = heads.shape
    n_dev = mesh.shape[axis_name]
    n_local = n_chains // n_dev

    def kernel(heads_l, key):
        my_shard = lax.axis_index(axis_name)
        offset = my_shard * n_local
        lnp_l = jax.vmap(ln_prob_fn)(heads_l)

        def step(carry, step_key):
            heads_l, lnp_l, n_acc = carry
            all_heads = lax.all_gather(heads_l, axis_name, tiled=True)
            chain_keys = jax.random.split(step_key, n_chains)
            local_keys = lax.dynamic_slice_in_dim(
                chain_keys, offset, n_local
            )

            def one_chain(c_global, ck, x_cur, lnp_cur):
                k_pick, k_jit, k_acc = jax.random.split(ck, 3)
                a, b = _pick_two_others(k_pick, c_global, n_chains)
                delta = all_heads[a] - all_heads[b]
                jitter = jax.random.uniform(
                    k_jit, (ndim,), x_cur.dtype, 0.0, var_epsilon
                )
                prop = x_cur + gamma * delta + jitter
                if prop_fixup_fn is not None:
                    prop = prop_fixup_fn(prop)
                lnp_prop = ln_prob_fn(prop)
                alpha = jnp.exp(jnp.minimum(lnp_prop - lnp_cur, 0.0))
                alpha = jnp.where(jnp.isnan(alpha), 0.0, alpha)
                accept = jax.random.uniform(k_acc, (), x_cur.dtype) < alpha
                return (
                    jnp.where(accept, prop, x_cur),
                    jnp.where(accept, lnp_prop, lnp_cur),
                    accept,
                )

            c_globals = offset + jnp.arange(n_local)
            xs, lnps, accepts = jax.vmap(one_chain)(
                c_globals, local_keys, heads_l, lnp_l
            )
            n_acc = n_acc + jnp.sum(accepts, dtype=jnp.int32)
            return (xs, lnps, n_acc), xs

        step_keys = jax.random.split(key, n_steps)
        # the accept counter becomes device-varying inside the scan body;
        # mark the init value varying over the chains axis to match
        n_acc0 = lax.pcast(jnp.zeros((), jnp.int32), (axis_name,), to="varying")
        (heads_l, _lnp_l, n_acc), hist_l = lax.scan(
            step, (heads_l, lnp_l, n_acc0), step_keys,
            unroll=min(4, max(n_steps, 1)),
        )
        n_acc_total = lax.psum(n_acc, axis_name)
        return hist_l, heads_l, n_acc_total

    return jax.shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(axis_name, None), P()),
        out_specs=(P(None, axis_name, None), P(axis_name, None), P()),
    )(heads, key)


@functools.partial(
    jax.jit,
    static_argnames=("ln_prob_fn", "n_steps", "delta_max", "n_cr",
                     "prop_fixup_fn", "n_adapt", "mesh", "axis_name"),
)
def _dream_sharded_jit(heads, ln_prob_fn, n_steps, key, delta_max, n_cr,
                       gamma_jump_prob, b, b_star, n_adapt, prop_fixup_fn,
                       mesh, axis_name):
    from corrla_rs_tpu.ops.samplers import pick_others_batched as _pick

    n_chains, d = heads.shape
    n_dev = mesh.shape[axis_name]
    n_local = n_chains // n_dev

    def kernel(heads_l, key):
        my_shard = lax.axis_index(axis_name)
        offset = my_shard * n_local
        lnp_l = jax.vmap(ln_prob_fn)(heads_l)
        dtype = heads_l.dtype
        p_cr0 = lax.pcast(jnp.ones((n_cr,), dtype) / n_cr, (axis_name,), to="varying")
        stats0 = lax.pcast(jnp.zeros((n_cr,), dtype), (axis_name,), to="varying")
        acc0 = lax.pcast(jnp.zeros((), jnp.int32), (axis_name,), to="varying")
        t0 = lax.pcast(jnp.zeros((), jnp.int32), (axis_name,), to="varying")

        def step(carry, step_key):
            heads_l, lnp_l, p_cr, jump_dist, n_id, n_acc, t = carry
            all_heads = lax.all_gather(heads_l, axis_name, tiled=True)
            chain_std = jnp.std(all_heads, axis=0) + 1e-30

            ks = jax.random.split(step_key, 10)
            # global batched draws; every shard computes the full-population
            # randomness identically (replicated keys) and slices its rows —
            # keeps the proposal distribution identical to the single-chip
            # dream_run generation
            pairs = _pick(ks[1], n_chains, 2 * delta_max)
            delta = jax.random.randint(ks[2], (n_chains,), 1, delta_max + 1)
            cr_ids = jax.random.categorical(
                ks[3], jnp.log(p_cr), shape=(n_chains,)
            )
            z = jax.random.uniform(ks[4], (n_chains, d), dtype)
            force = jax.random.randint(ks[5], (n_chains,), 0, d)
            unit_jump = (
                jax.random.uniform(ks[6], (n_chains,), dtype) < gamma_jump_prob
            )
            e = jax.random.uniform(ks[7], (n_chains, d), dtype, -b, b)
            eps = b_star * jax.random.normal(ks[8], (n_chains, d), dtype)
            u_acc = jax.random.uniform(ks[9], (n_chains,), dtype)

            sl = lambda a: lax.dynamic_slice_in_dim(a, offset, n_local)
            pair_mask = (
                jnp.arange(delta_max)[None, :] < sl(delta)[:, None]
            ).astype(dtype)[..., None]
            a_idx = sl(pairs)[:, :delta_max]
            b_idx = sl(pairs)[:, delta_max:]
            diff = jnp.sum(
                (all_heads[a_idx] - all_heads[b_idx]) * pair_mask, axis=1
            )
            cr_l = sl(cr_ids)
            cr = (cr_l.astype(dtype) + 1.0) / n_cr
            mask = sl(z) < cr[:, None]
            # one-hot OR instead of a scatter (see ops/dream.py)
            mask = mask | (jnp.arange(d)[None, :] == sl(force)[:, None])
            d_eff = jnp.sum(mask.astype(dtype), axis=1)
            gamma = 2.38 / jnp.sqrt(2.0 * sl(delta).astype(dtype) * d_eff)
            gamma = jnp.where(sl(unit_jump), jnp.asarray(1.0, dtype), gamma)
            step_v = (1.0 + sl(e)) * gamma[:, None] * diff + sl(eps)
            prop = jnp.where(mask, heads_l + step_v, heads_l)
            if prop_fixup_fn is not None:
                prop = jax.vmap(prop_fixup_fn)(prop)
            lnp_prop = jax.vmap(ln_prob_fn)(prop)
            alpha = jnp.exp(jnp.minimum(lnp_prop - lnp_l, 0.0))
            alpha = jnp.where(jnp.isnan(alpha), 0.0, alpha)
            accepts = sl(u_acc) < alpha
            xs = jnp.where(accepts[:, None], prop, heads_l)
            lnps = jnp.where(accepts, lnp_prop, lnp_l)
            jds = jnp.sum(((xs - heads_l) / chain_std) ** 2, axis=1)

            # crossover adaptation from globally-reduced jump statistics
            # (scatter-free histogram shared with ops.dream)
            jd_loc, id_loc = _cr_histogram(cr_l, jds, n_cr, dtype)
            jd_add = lax.psum(jd_loc, axis_name)
            id_add = lax.psum(id_loc, axis_name)
            jump_dist = jump_dist + jd_add
            n_id = n_id + id_add
            mean_jump = jump_dist / jnp.maximum(n_id, 1.0)
            p_new = mean_jump / jnp.maximum(jnp.sum(mean_jump), 1e-30)
            p_new = jnp.maximum(p_new, 0.05 / n_cr)
            p_new = p_new / jnp.sum(p_new)
            p_cr = jnp.where(t < n_adapt, p_new, p_cr)

            n_acc = n_acc + jnp.sum(accepts, dtype=jnp.int32)
            return (xs, lnps, p_cr, jump_dist, n_id, n_acc, t + 1), xs

        step_keys = jax.random.split(key, n_steps)
        (heads_l, _l, _p, _j, _n, n_acc, _t), hist_l = lax.scan(
            step, (heads_l, lnp_l, p_cr0, stats0, stats0, acc0, t0), step_keys,
            unroll=min(4, max(n_steps, 1)),
        )
        return hist_l, heads_l, lax.psum(n_acc, axis_name)

    return jax.shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(axis_name, None), P()),
        out_specs=(P(None, axis_name, None), P(axis_name, None), P()),
    )(heads, key)


def dream_run_sharded(init_heads, ln_prob_fn, n_steps: int, key=0,
                      delta_max: int = 3, n_cr: int = 3,
                      gamma_jump_prob: float = 0.2, b: float = 0.05,
                      b_star: float = 1e-6, n_adapt: int = 0,
                      prop_fixup_fn=None, mesh=None, axis_name=None):
    """DREAM over a chain-sharded mesh (see ops.dream for the algorithm).

    Heads all_gather per generation; crossover-adaptation statistics are
    psum-reduced so every shard adapts identically. Returns
    (history (n_steps, n_chains, d), final_heads, accept_ratio).
    """
    mesh = mesh or make_mesh(axis_name=CHAINS_AXIS)
    axis_name = axis_name or mesh.axis_names[0]
    heads = jnp.asarray(init_heads)
    n_dev = mesh.shape[axis_name]
    if heads.shape[0] % n_dev != 0:
        raise ValueError(
            f"mesh axis size ({n_dev}) must divide n_chains "
            f"({heads.shape[0]})"
        )
    assert heads.shape[0] >= 2 * delta_max + 1
    heads = jax.device_put(
        heads, jax.sharding.NamedSharding(mesh, P(axis_name, None))
    )
    hist, final_heads, n_acc = _dream_sharded_jit(
        heads, ln_prob_fn, int(n_steps), as_key(key), delta_max, n_cr,
        gamma_jump_prob, b, b_star, n_adapt, prop_fixup_fn, mesh, axis_name,
    )
    accept_ratio = float(n_acc) / (int(n_steps) * heads.shape[0])
    return hist, final_heads, accept_ratio


@functools.partial(
    jax.jit,
    static_argnames=("ln_prob_fn", "n_steps", "mesh", "axis_name"),
)
def _stretch_sharded_jit(halves, ln_prob_fn, n_steps, a, key, mesh,
                         axis_name):
    """halves: (2, half, d) — the red-black groups, each sharded over the
    walker axis so EVERY device updates rows in BOTH stages (a flat
    (n, d) sharding would idle half the mesh per stage). Per stage the
    frozen complementary group is all_gather-ed (tiny: half x d);
    randomness is drawn replicated from the step key and row-sliced, so
    the proposal distribution matches ops.ensemble_mcmc.stretch_run
    (streams differ only in key-split layout, same contract as
    demc_run_sharded)."""
    _, half, d = halves.shape
    n_dev = mesh.shape[axis_name]
    n_local = half // n_dev

    def kernel(halves_l, key):
        my_shard = lax.axis_index(axis_name)
        offset = my_shard * n_local
        lnp_l = jax.vmap(ln_prob_fn)(halves_l.reshape(2 * n_local, d))
        lnp_l = lnp_l.reshape(2, n_local)
        acc0 = lax.pcast(jnp.zeros((), jnp.int32), (axis_name,),
                         to="varying")

        def half_update(walkers_l, lnp_w, other_full, rp, rz, racc):
            z = ((a - 1.0) * rz + 1.0) ** 2 / a
            partners = other_full[rp]
            prop = partners + z[:, None] * (walkers_l - partners)
            lnp_prop = jax.vmap(ln_prob_fn)(prop)
            ln_q = (d - 1.0) * jnp.log(z) + lnp_prop - lnp_w
            alpha = jnp.exp(jnp.minimum(ln_q, 0.0))
            alpha = jnp.where(jnp.isnan(alpha), 0.0, alpha)
            acc = racc < alpha
            return (jnp.where(acc[:, None], prop, walkers_l),
                    jnp.where(acc, lnp_prop, lnp_w),
                    jnp.sum(acc, dtype=jnp.int32))

        def step(carry, step_key):
            halves_l, lnp_l, n_acc = carry
            ks = jax.random.split(step_key, 6)
            dtype = halves_l.dtype
            sl = lambda arr: lax.dynamic_slice_in_dim(arr, offset, n_local)

            out_halves = []
            out_lnps = []
            for g in range(2):
                other_full = lax.all_gather(
                    halves_l[1 - g] if g == 0 else out_halves[0],
                    axis_name, tiled=True)
                rp = sl(jax.random.randint(ks[3 * g], (half,), 0, half))
                rz = sl(jax.random.uniform(ks[3 * g + 1], (half,), dtype))
                racc = sl(jax.random.uniform(ks[3 * g + 2], (half,),
                                             dtype))
                w, l, n_a = half_update(halves_l[g], lnp_l[g], other_full,
                                        rp, rz, racc)
                out_halves.append(w)
                out_lnps.append(l)
                n_acc = n_acc + n_a
            halves_l = jnp.stack(out_halves)
            lnp_l = jnp.stack(out_lnps)
            return (halves_l, lnp_l, n_acc), halves_l

        step_keys = jax.random.split(key, n_steps)
        (halves_l, _lnp, n_acc), hist_l = lax.scan(
            step, (halves_l, lnp_l, acc0), step_keys,
            unroll=min(4, max(n_steps, 1)),
        )
        return hist_l, halves_l, lax.psum(n_acc, axis_name)

    return jax.shard_map(
        kernel,
        mesh=mesh,
        in_specs=(P(None, axis_name, None), P()),
        out_specs=(P(None, None, axis_name, None),
                   P(None, axis_name, None), P()),
    )(halves, key)


def stretch_run_sharded(init_walkers, ln_prob_fn, n_steps: int,
                        a: float = 2.0, key=0, mesh=None, axis_name=None):
    """Affine-invariant stretch sampler over a walker-sharded mesh
    (see ops.ensemble_mcmc for the algorithm).

    Both red-black groups are sharded over the mesh axis so every device
    updates rows in both half-stages; the frozen complementary group is
    all_gather-ed per stage. n_walkers must divide 2 * mesh-axis size.
    Returns (history (n_steps, n_walkers, d), final_walkers,
    accept_ratio) with the single-chip walker ordering (first half, then
    second half).
    """
    mesh = mesh or make_mesh(axis_name=CHAINS_AXIS)
    axis_name = axis_name or mesh.axis_names[0]
    walkers = jnp.asarray(init_walkers)
    n, d = walkers.shape
    n_dev = mesh.shape[axis_name]
    if n < 4 or n % 2:
        raise ValueError(f"need an even n_walkers >= 4, got {n}")
    if (n // 2) % n_dev != 0:
        raise ValueError(
            f"mesh axis size ({n_dev}) must divide n_walkers/2 "
            f"({n // 2})")
    halves = walkers.reshape(2, n // 2, d)
    halves = jax.device_put(
        halves, jax.sharding.NamedSharding(mesh, P(None, axis_name, None))
    )
    hist, final_halves, n_acc = _stretch_sharded_jit(
        halves, ln_prob_fn, int(n_steps), float(a), as_key(key), mesh,
        axis_name,
    )
    n_steps = int(n_steps)
    hist = hist.reshape(n_steps, n, d)
    accept_ratio = float(n_acc) / (n_steps * n)
    return hist, final_halves.reshape(n, d), accept_ratio


def demc_run_sharded(init_heads, ln_prob_fn, n_steps: int, gamma: float,
                     var_epsilon: float, key=0, prop_fixup_fn=None,
                     mesh=None, axis_name=None):
    """DEMC over a chain-sharded mesh.

    Returns (history (n_steps, n_chains, ndim), final_heads, accept_ratio).
    n_chains must divide the mesh axis size.
    """
    mesh = mesh or make_mesh(axis_name=CHAINS_AXIS)
    axis_name = axis_name or mesh.axis_names[0]
    heads = jnp.asarray(init_heads)
    n_dev = mesh.shape[axis_name]
    if heads.shape[0] % n_dev != 0:
        raise ValueError(
            f"mesh axis size ({n_dev}) must divide n_chains "
            f"({heads.shape[0]})"
        )
    heads = jax.device_put(
        heads, jax.sharding.NamedSharding(mesh, P(axis_name, None))
    )
    hist, final_heads, n_acc = _demc_sharded_jit(
        heads, ln_prob_fn, int(n_steps), gamma, var_epsilon, as_key(key),
        prop_fixup_fn, mesh, axis_name,
    )
    accept_ratio = float(n_acc) / (int(n_steps) * heads.shape[0])
    return hist, final_heads, accept_ratio
