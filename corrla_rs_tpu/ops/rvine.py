"""Regular-vine (R-vine) copula with Dissmann structure selection.

Completes the reference README's "Pair-Copula constructions
(Vine-Copula)" roadmap item (readme.md:54) beyond the C-vine special
case of ``ops.vine.CVineCopula``: the tree structure itself is learned
from the data by the greedy maximum-spanning-tree algorithm of Dissmann,
Brechmann, Czado & Kurowicka (2013), "Selecting and estimating regular
vine copulae and application to financial returns":

- Tree 1: maximum spanning tree over the complete graph with |Kendall
  tau| edge weights (capture the strongest dependencies explicitly).
- Tree t: nodes are the edges of tree t-1; two nodes are joinable iff
  their complete (conditioned + conditioning) sets share exactly t-1
  variables (the proximity condition); MST by |tau| of the conditional
  pseudo-observations.
- Every selected edge fits a pair-copula by AIC over the full rotated
  family set (``ops.vine.FAMILIES`` incl. clayton/gumbel 90/180/270).

Sampling and log-density use the generic conditional-CDF recursion on
the fitted edge list (memoized by (variable, conditioning-set)): for a
variable x eliminated at matrix position k, the R-vine structure
guarantees its edges are (x, b_t | {b_1..b_{t-1}}) with nested
conditioning sets, so the inverse-Rosenblatt chain of the C-vine
algorithm applies tree-by-tree, and every conditional F(b_t | b_<t) the
chain needs is reachable through some fitted edge (this is exactly the
property the classic R-vine-matrix "maximum matrix" encodes; the
memoized search finds the same edges without the matrix bookkeeping).

Accelerator notes: as in ops/vine, every h / h-inverse / log-pdf is an
elementwise jax expression vectorized over the whole sample; tree
selection is tiny host graph work over d(d-1)/2 scalars.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.ops.vine import (
    _EPS,
    _H,
    _HINV,
    _LOGPDF,
    FAMILIES,
    _fit_pair,
    kendall_tau,
)
from corrla_rs_tpu.utils.prng import as_key

__all__ = ["RVineCopula"]


def _swap(fam: str) -> str:
    """Family whose C(u,v) equals fam's C(v,u).

    The base families are exchangeable, but argument exchange maps the
    90-degree rotation to the 270 one (C_90(u,v) = v - C(1-u,v) and
    C_90(v,u) = u - C(1-v,u) = C_270(u,v) by base exchangeability), so
    the conditional of the FIRST argument given the second for the
    swapped orientation is ``_H[_swap(fam)]``.
    """
    if fam.endswith("90"):
        return fam[:-2] + "270"
    if fam.endswith("270"):
        return fam[:-3] + "90"
    return fam


@dataclasses.dataclass
class _Edge:
    """One pair-copula edge: conditioned pair (a, b) given ``cond``."""

    a: int
    b: int
    cond: frozenset
    family: str = "independent"
    theta: float = 0.0
    # pseudo-observations produced while fitting (training scale):
    # ua = F(a | {b} u cond), ub = F(b | {a} u cond)
    ua: np.ndarray | None = None
    ub: np.ndarray | None = None

    @property
    def full(self) -> frozenset:
        return self.cond | {self.a, self.b}


def _mst_max(n_nodes: int, weights: dict) -> list:
    """Maximum spanning tree by Prim over an (possibly incomplete) graph.

    weights: {(i, j): w} with i < j. Returns list of chosen (i, j).
    Raises if the graph is disconnected (cannot happen for tree 1; for
    deeper trees the proximity condition always leaves a connected
    graph on any valid vine — a failure here is a structural bug).
    """
    in_tree = {0}
    chosen = []
    while len(in_tree) < n_nodes:
        best, best_w = None, -np.inf
        for (i, j), w in weights.items():
            if (i in in_tree) != (j in in_tree) and w > best_w:
                best, best_w = (i, j), w
        if best is None:
            raise RuntimeError("proximity graph disconnected")
        chosen.append(best)
        in_tree.update(best)
    return chosen


class RVineCopula:
    """R-vine copula over empirical marginals with learned structure.

    ``fit(samples)``: rank-transform to uniforms, select the vine
    structure tree-by-tree (Dissmann MST on |tau|), fit each pair-copula
    by AIC over ``families``. ``sample(n, key)`` / ``logpdf_uniform(u)``
    evaluate the fitted vine. ``trees`` exposes the learned structure as
    ``[(a, b, sorted(cond), family, theta), ...]`` per tree level.
    """

    def __init__(self, families=FAMILIES, truncate_level: int | None = None,
                 refine=False):
        self.families = tuple(families)
        # refine=True: golden-section MLE of each pair's theta seeded by
        # the tau inversion (sequential MLE, Dissmann et al. 2013 §2.3)
        self.refine = bool(refine)
        # fit only the first ``truncate_level`` trees (deeper pairs become
        # independence copulas) — the standard truncated-vine economy for
        # high d where deep-tree dependence is noise
        self.truncate_level = truncate_level

    # -- fitting ---------------------------------------------------------

    def fit(self, samples):
        x = jnp.asarray(samples)
        n, d = x.shape
        if d < 2:
            raise ValueError(f"need at least 2 variables, got {d}")
        order_ = jnp.argsort(x, axis=0)
        ranks = jnp.zeros_like(order_).at[
            order_, jnp.arange(d)[None, :]
        ].set(jnp.arange(n)[:, None])
        u = np.asarray((ranks + 0.5) / n)

        # ---- tree 1: MST on |tau| over the complete variable graph
        tau = np.zeros((d, d))
        for i in range(d):
            for j in range(i + 1, d):
                tau[i, j] = tau[j, i] = float(
                    kendall_tau(u[:, i], u[:, j])
                )
        w1 = {(i, j): abs(tau[i, j]) for i in range(d)
              for j in range(i + 1, d)}
        chosen = _mst_max(d, w1)

        levels: list[list[_Edge]] = []
        lvl = []
        for (i, j) in chosen:
            e = _Edge(i, j, frozenset())
            self._fit_edge(e, u[:, i], u[:, j], level=0)
            lvl.append(e)
        levels.append(lvl)

        # ---- trees 2..d-1: nodes = previous edges, proximity + MST
        for t in range(1, d - 1):
            prev = levels[-1]
            cand = {}   # (idx_i, idx_j) -> (edge template, wa, wb)
            weights = {}
            for ii in range(len(prev)):
                for jj in range(ii + 1, len(prev)):
                    e1, e2 = prev[ii], prev[jj]
                    inter = e1.full & e2.full
                    if len(inter) != t:          # proximity condition
                        continue
                    (a,) = tuple(e1.full - inter)
                    (b,) = tuple(e2.full - inter)
                    if a not in (e1.a, e1.b) or b not in (e2.a, e2.b):
                        # node-sharing proximity additionally requires the
                        # new conditioned variables to be conditioned in
                        # their parent edges (their F(.|rest) pseudo-obs
                        # exist); set-intersection size alone admits a few
                        # invalid pairs in deep trees
                        continue
                    wa = self._outgoing(e1, a)
                    wb = self._outgoing(e2, b)
                    tau_ab = float(kendall_tau(wa, wb))
                    cand[(ii, jj)] = (a, b, frozenset(inter), wa, wb)
                    weights[(ii, jj)] = abs(tau_ab)
            chosen = _mst_max(len(prev), weights)
            lvl = []
            for key in chosen:
                a, b, inter, wa, wb = cand[key]
                e = _Edge(a, b, inter)
                self._fit_edge(e, wa, wb, level=t)
                lvl.append(e)
            levels.append(lvl)

        self.n, self.d = n, d
        # persistable structure spec (checkpoint-friendly: plain nested
        # primitives; the runtime _Edge lists rebuild from it on access)
        self.levels_spec = [
            [[e.a, e.b, sorted(e.cond), e.family, float(e.theta)]
             for e in lvl]
            for lvl in levels
        ]
        self._marginals = jnp.sort(x, axis=0)
        # validate the structure once (raises on an invalid vine)
        self._elimination_order()
        return self

    @property
    def levels(self):
        """Runtime edge lists rebuilt from ``levels_spec`` (so fitted
        models round-trip through utils.checkpoint, which persists only
        arrays and nested primitives)."""
        return [
            [_Edge(a, b, frozenset(c), fam, float(th))
             for (a, b, c, fam, th) in lvl]
            for lvl in self.levels_spec
        ]

    def _fit_edge(self, e: _Edge, ua, ub, level: int):
        ua = np.asarray(ua)
        ub = np.asarray(ub)
        if self.truncate_level is not None and level >= self.truncate_level:
            e.family, e.theta = "independent", 0.0
        else:
            fam, th, _tau = _fit_pair(
                jnp.asarray(ua), jnp.asarray(ub), families=self.families,
                refine=self.refine,
            )
            e.family, e.theta = fam, th
        # outgoing pseudo-observations for the next tree; the copula was
        # fitted with orientation (a first, b second), so F(b | a u cond)
        # uses the exchange-swapped family (see _swap)
        e.ua = np.asarray(
            _H[e.family](jnp.asarray(ua), jnp.asarray(ub), e.theta)
        )  # F(a | b u cond)
        e.ub = np.asarray(
            _H[_swap(e.family)](jnp.asarray(ub), jnp.asarray(ua), e.theta)
        )  # F(b | a u cond)

    @staticmethod
    def _outgoing(e: _Edge, var: int) -> np.ndarray:
        """Pseudo-obs F(var | everything else in e.full) from edge e."""
        if var == e.a:
            return e.ua
        if var == e.b:
            return e.ub
        raise KeyError(f"{var} is not a conditioned member of {e}")

    # -- structure exposure ---------------------------------------------

    @property
    def trees(self):
        return [
            [(e.a, e.b, tuple(sorted(e.cond)), e.family, float(e.theta))
             for e in lvl]
            for lvl in self.levels
        ]

    # -- conditional-CDF machinery --------------------------------------

    def _find_edge(self, target: int, given: frozenset) -> _Edge:
        """The fitted edge whose conditioned pair contains ``target`` with
        partner + conditioning set == ``given`` (exists for every
        conditional the sampling recursion requests — vine property)."""
        lvl = len(given) - 1
        for e in self.levels[lvl]:
            if target == e.a and (e.cond | {e.b}) == given:
                return e
            if target == e.b and (e.cond | {e.a}) == given:
                return e
        raise KeyError(
            f"no edge for F({target} | {sorted(given)}) — invalid vine"
        )

    def _cond_cdf(self, target, given, cols, memo):
        """F(target | given) evaluated on sample columns ``cols``
        (dict var -> uniform array), via the h-function recursion."""
        key = (target, given)
        if key in memo:
            return memo[key]
        if not given:
            out = cols[target]
        else:
            e = self._find_edge(target, given)
            partner = e.b if target == e.a else e.a
            u_t = self._cond_cdf(target, e.cond, cols, memo)
            u_p = self._cond_cdf(partner, e.cond, cols, memo)
            fam = e.family if target == e.a else _swap(e.family)
            out = _H[fam](u_t, u_p, e.theta)
        memo[key] = out
        return out

    # -- log-density -----------------------------------------------------

    def logpdf_uniform(self, u) -> jnp.ndarray:
        """Vine copula log-density at uniform-scale points ``u`` (n, d)."""
        u = jnp.clip(jnp.asarray(u), _EPS, 1.0 - _EPS)
        cols = {j: u[:, j] for j in range(self.d)}
        memo = {}
        total = jnp.zeros(u.shape[0], u.dtype)
        for lvl in self.levels:
            for e in lvl:
                ua = self._cond_cdf(e.a, e.cond, cols, memo)
                ub = self._cond_cdf(e.b, e.cond, cols, memo)
                total = total + _LOGPDF[e.family](ua, ub, e.theta)
        return total

    def aic(self, u) -> float:
        """AIC at uniform-scale data ``u`` (n, d): -2 log-likelihood
        + 2 * (number of non-independent pair copulas)."""
        ll = float(jnp.sum(self.logpdf_uniform(u)))
        k = sum(1 for lvl in self.levels for e in lvl
                if e.family != "independent")
        return -2.0 * ll + 2.0 * k

    # -- sampling --------------------------------------------------------

    def _elimination_order(self):
        """Peel conditioned-leaf variables off the vine: returns
        [(var, [(edge in tree 1), ..., (edge in deepest tree var
        appears in)]), ...] in elimination order; the last remaining
        variable closes the list with an empty edge chain."""
        # working copy of edge references per level
        levels = [list(lvl) for lvl in self.levels]
        order = []
        while levels:
            top = levels[-1][0]
            x = top.a  # either conditioned member of the top edge works
            chain = []
            for lvl in levels:
                matches = [e for e in lvl
                           if x in (e.a, e.b)]
                # x is a conditioned member of exactly one edge per level
                # (the defining property of an elimination variable).
                # Real exceptions, not asserts: fit() relies on this
                # validation raising for invalid structures, and asserts
                # vanish under python -O
                if len(matches) != 1:
                    raise RuntimeError(
                        f"invalid vine: variable {x} is conditioned in "
                        f"{len(matches)} edges of one tree (expected 1)"
                    )
                chain.append(matches[0])
            # the R-vine column property the sampler relies on: the
            # conditioning set at tree t is exactly x's partners from
            # trees 1..t-1
            partners = [e.b if e.a == x else e.a for e in chain]
            for t_lvl, e in enumerate(chain):
                if e.cond != frozenset(partners[:t_lvl]):
                    raise RuntimeError(
                        f"invalid vine: edge {e} breaks the nested-"
                        f"conditioning column property for variable {x}"
                    )
            for lvl, e in zip(levels, chain):
                lvl.remove(e)
            # only the (single-edge) top level empties each round
            if levels[-1]:
                raise RuntimeError(
                    "invalid vine: top tree did not empty after "
                    "eliminating its conditioned variable"
                )
            levels.pop()
            order.append((x, chain))
        remaining = set(range(self.d)) - {x for x, _ in order}
        if len(remaining) != 1:
            raise RuntimeError(
                f"invalid vine: {len(remaining)} variables left after "
                "elimination (expected exactly 1)"
            )
        order.append((remaining.pop(), []))
        return order

    def sample_uniform(self, n_samples: int, key=0) -> jnp.ndarray:
        """(n, d) uniform-scale draws by inverse Rosenblatt over the
        learned structure (reverse elimination order; each variable's
        uniform is pushed through its edge chain's inverse h-functions
        from the deepest tree up)."""
        w = jax.random.uniform(
            as_key(key), (n_samples, self.d), minval=_EPS,
            maxval=1.0 - _EPS,
        )
        cols = {}
        memo = {}
        order = self._elimination_order()
        for idx, (x, chain) in enumerate(reversed(order)):
            t_i = w[:, idx]
            for e in reversed(chain):
                partner = e.b if x == e.a else e.a
                v_t = self._cond_cdf(partner, e.cond, cols, memo)
                fam = e.family if x == e.a else _swap(e.family)
                t_i = _HINV[fam](t_i, v_t, e.theta)
            cols[x] = t_i
        return jnp.stack([cols[j] for j in range(self.d)], axis=1)

    def sample(self, n_samples: int, key=0) -> jnp.ndarray:
        """Samples on the data scale via empirical-marginal inversion."""
        us = self.sample_uniform(n_samples, key=key)
        us = jnp.clip(us, 0.5 / self.n, 1.0 - 0.5 / self.n)
        grid = (jnp.arange(self.n) + 0.5) / self.n
        cols = [
            jnp.interp(us[:, j], grid, self._marginals[:, j])
            for j in range(self.d)
        ]
        return jnp.stack(cols, axis=1)
