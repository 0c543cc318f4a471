"""Canonical (C-) vine copula with bivariate pair-copula families.

The reference README lists "copulas / vine copulas" as a roadmap item it
never implemented (readme.md:49-54; SURVEY.md §2.4 item 5). This module is
the vine half (ops/copula.py has the plain Gaussian copula): a C-vine
pair-copula construction per Aas, Czado, Frigessi & Bakken (2009),
"Pair-copula constructions of multiple dependence".

Families: gaussian, clayton, gumbel, frank, independent, the 90/180/270
rotations of clayton/gumbel, and Student-t on a df grid (t3/t5/t8/t15).
Fitting inverts Kendall's tau per pair (closed form for the ellipticals
and clayton/gumbel, bisection on the Debye-function relation for frank)
and selects the family by AIC; conditioning uses the h-functions
(conditional CDFs), sampling the inverse h-functions (closed form except
gumbel and t, which use fixed-iteration bisection — jit-friendly, no
data-dependent control flow).

Accelerator notes: Kendall's tau is the O(n^2) sign-product mean computed as
two broadcasted comparisons (elementwise); every h/h-inverse/log-pdf is an
elementwise expression vectorized over the whole sample; the tree
recursion is a Python loop over the (small) dimension, everything inside
is jittable.
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from corrla_rs_tpu.utils.prng import as_key

__all__ = ["CVineCopula", "kendall_tau", "FAMILIES", "BASE_FAMILIES"]

BASE_FAMILIES = ("independent", "gaussian", "clayton", "gumbel", "frank")

# Full family set including the 90/180/270-degree rotations of the
# asymmetric (single-tail) archimedean families. Rotations complete the
# reference README's Clayton/Gumbel roadmap item (readme.md:49-53): the
# base families only represent POSITIVE dependence with one active tail;
# the 180-degree (survival) rotation moves the tail to the opposite
# corner, and the 90/270 rotations represent NEGATIVE dependence
# (previously such pairs silently fell back to gaussian/frank).
#
# The Student-t family (t3/t5/t8/t15) covers SYMMETRIC dependence with
# both tails active — the elliptical family the gaussian copula misses
# (it has zero tail dependence) and the archimedeans can only fake one
# tail at a time. The degrees of freedom are a discrete grid, the
# standard practice for tau-inversion fitting: each grid member is a
# one-parameter (rho) family, and AIC picks the df alongside the family
# (with a 2-parameter penalty — rho plus the df choice).
FAMILIES = (
    "independent", "gaussian", "frank",
    "clayton", "clayton90", "clayton180", "clayton270",
    "gumbel", "gumbel90", "gumbel180", "gumbel270",
    "t3", "t5", "t8", "t15",
)

# df grid for the Student-t families ("t5" -> nu = 5)
_T_NU = {"t3": 3.0, "t5": 5.0, "t8": 8.0, "t15": 15.0}

_SQRT2 = math.sqrt(2.0)
_EPS = 1e-6


def _norm_cdf(z):
    return 0.5 * (1.0 + jax.scipy.special.erf(z / _SQRT2))


def _norm_ppf(u):
    return _SQRT2 * jax.scipy.special.erfinv(2.0 * u - 1.0)


def _clip_u(u):
    return jnp.clip(u, _EPS, 1.0 - _EPS)


# above this, the O(n^2) broadcasted device comparison stops being the
# right tool (the (n, n) sign matrices reach ~0.5 GB at 12k points)
_TAU_DEVICE_MAX_N = 8192


def kendall_tau(x, y, method: str = "auto"):
    """Kendall's tau.

    method='device': O(n^2) broadcasted sign-product mean on the
    accelerator (elementwise-friendly, exact for tie-free data).
    method='host': Knight's O(n log n) merge-sort algorithm in the C++
    runtime (native/corrla_host.cpp) — use for large n.
    method='auto' (default): device up to 8192 points, host beyond when
    the native runtime is available.
    """
    if method == "auto":
        n = np.asarray(x).shape[0] if not hasattr(x, "shape") else x.shape[0]
        if n > _TAU_DEVICE_MAX_N:
            from corrla_rs_tpu import native

            if native.available():
                method = "host"
        if method == "auto":
            method = "device"
    if method == "host":
        from corrla_rs_tpu import native

        return native.kendall_tau_host(np.asarray(x), np.asarray(y))
    return _tau_device_kernel(jnp.asarray(x), jnp.asarray(y))


@jax.jit
def _tau_device_kernel(x, y):
    sx = jnp.sign(x[:, None] - x[None, :])
    sy = jnp.sign(y[:, None] - y[None, :])
    n = x.shape[0]
    return jnp.sum(sx * sy) / (n * (n - 1.0))


# ---------------------------------------------------------------------------
# pair-copula families: tau->param, log-pdf, h, h-inverse
# h(u | v; th) = dC(u, v)/dv  (conditional CDF of u given v)
# ---------------------------------------------------------------------------

def _gauss_logpdf(u, v, rho):
    x, y = _norm_ppf(_clip_u(u)), _norm_ppf(_clip_u(v))
    r2 = rho * rho
    return (
        -0.5 * jnp.log(1.0 - r2)
        - (r2 * (x * x + y * y) - 2.0 * rho * x * y) / (2.0 * (1.0 - r2))
    )


def _gauss_h(u, v, rho):
    x, y = _norm_ppf(_clip_u(u)), _norm_ppf(_clip_u(v))
    return _norm_cdf((x - rho * y) / jnp.sqrt(1.0 - rho * rho))


def _gauss_hinv(w, v, rho):
    y = _norm_ppf(_clip_u(v))
    x = _norm_ppf(_clip_u(w)) * jnp.sqrt(1.0 - rho * rho) + rho * y
    return _norm_cdf(x)


def _clayton_logpdf(u, v, th):
    u, v = _clip_u(u), _clip_u(v)
    lu, lv = jnp.log(u), jnp.log(v)
    s = jnp.exp(-th * lu) + jnp.exp(-th * lv) - 1.0
    return (
        jnp.log1p(th) - (th + 1.0) * (lu + lv)
        - (2.0 + 1.0 / th) * jnp.log(s)
    )


def _clayton_h(u, v, th):
    u, v = _clip_u(u), _clip_u(v)
    s = u ** (-th) + v ** (-th) - 1.0
    return v ** (-th - 1.0) * s ** (-1.0 - 1.0 / th)


def _clayton_hinv(w, v, th):
    w, v = _clip_u(w), _clip_u(v)
    t = (w * v ** (th + 1.0)) ** (-th / (th + 1.0))
    return (t + 1.0 - v ** (-th)) ** (-1.0 / th)


def _gumbel_logpdf(u, v, th):
    u, v = _clip_u(u), _clip_u(v)
    lu, lv = -jnp.log(u), -jnp.log(v)   # positive
    a, b = lu**th, lv**th
    s = a + b
    spow = s ** (1.0 / th)
    logc = -spow
    return (
        logc + lu + lv
        + (th - 1.0) * (jnp.log(lu) + jnp.log(lv))
        + (1.0 / th - 2.0) * jnp.log(s)
        + jnp.log(spow + th - 1.0)
    )


def _gumbel_h(u, v, th):
    u, v = _clip_u(u), _clip_u(v)
    lu, lv = -jnp.log(u), -jnp.log(v)
    s = lu**th + lv**th
    spow = s ** (1.0 / th)
    c = jnp.exp(-spow)
    return c / v * s ** (1.0 / th - 1.0) * lv ** (th - 1.0)


def _gumbel_hinv(w, v, th, n_bisect: int = 50):
    """No closed form: fixed-iteration bisection on u (jit-friendly)."""
    w, v = _clip_u(w), _clip_u(v)
    lo = jnp.full_like(w, _EPS)
    hi = jnp.full_like(w, 1.0 - _EPS)

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        too_big = _gumbel_h(mid, v, th) > w
        hi = jnp.where(too_big, mid, hi)
        lo = jnp.where(too_big, lo, mid)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, n_bisect, body, (lo, hi))
    return 0.5 * (lo + hi)


def _frank_logpdf(u, v, th):
    u, v = _clip_u(u), _clip_u(v)
    et = jnp.expm1(-th)
    eu = jnp.expm1(-th * u)
    ev = jnp.expm1(-th * v)
    den = et + eu * ev
    return (
        jnp.log(jnp.abs(th)) + jnp.log(jnp.abs(et))
        - th * (u + v) - 2.0 * jnp.log(jnp.abs(den))
    )


def _frank_h(u, v, th):
    u, v = _clip_u(u), _clip_u(v)
    et = jnp.expm1(-th)
    eu = jnp.expm1(-th * u)
    ev = jnp.expm1(-th * v)
    return (jnp.exp(-th * v) * eu) / (et + eu * ev)


def _frank_hinv(w, v, th):
    # solve w = e^{-th v}(e^{-th u}-1) / [(e^{-th}-1)+(e^{-th u}-1)(e^{-th v}-1)]
    # for u: (e^{-th u}-1) = w (e^{-th}-1) / (e^{-th v}(1-w) + w)
    w, v = _clip_u(w), _clip_u(v)
    et = jnp.expm1(-th)
    ev = jnp.exp(-th * v)
    u = -jnp.log1p(w * et / (ev * (1.0 - w) + w)) / th
    return _clip_u(u)


# ---------------------------------------------------------------------------
# Student-t copula (elliptical, symmetric tail dependence in both tails).
# theta = rho; the degrees of freedom nu are fixed per family ("t5" etc.).
# All kernels are closed forms in the univariate t CDF/quantile:
#   logpdf: bivariate-t density over the product of the marginals
#   h(u|v) = T_{nu+1}( (x - rho y) / sqrt((1-rho^2)(nu+y^2)/(nu+1)) )
#   (Aas et al. 2009, eq. 10-12), with x = T_nu^{-1}(u), y = T_nu^{-1}(v)
# ---------------------------------------------------------------------------

def _t_cdf(x, nu):
    """Student-t CDF via the regularized incomplete beta function.

    Two algebraically identical forms of the tail mass P(T > |x|), picked
    by region: I_z(nu/2, 1/2) with z = nu/(nu+x^2) is accurate in the
    tails but z rounds to 1.0 for |x| < ~sqrt(eps*nu), flattening the CDF
    around the median (which stalls the ppf bisection there); the
    complementary identity I_z(a,b) = 1 - I_{1-z}(b,a) with
    1-z = x^2/(nu+x^2) computed directly (no cancellation) resolves the
    center down to machine precision.
    """
    x2 = x * x
    z = nu / (nu + x2)
    w = x2 / (nu + x2)
    tail_far = 0.5 * jax.scipy.special.betainc(nu / 2.0, 0.5, z)
    tail_near = 0.5 * (1.0 - jax.scipy.special.betainc(0.5, nu / 2.0, w))
    tail = jnp.where(x2 > nu, tail_far, tail_near)
    return jnp.where(x >= 0, 1.0 - tail, tail)


def _t_logpdf_uni(x, nu):
    return (
        jax.scipy.special.gammaln((nu + 1.0) / 2.0)
        - jax.scipy.special.gammaln(nu / 2.0)
        - 0.5 * jnp.log(nu * math.pi)
        - (nu + 1.0) / 2.0 * jnp.log1p(x * x / nu)
    )


# Quantile: Cornish-Fisher-seeded safeguarded Newton (jit/vmap-safe,
# fixed iteration count). The betainc inside _t_cdf dominates the t-grid
# kernels' cost; the previous 64-iteration bisection paid 64 betainc
# sweeps per call (measured 750 ms per family score at n=1500 on the
# 1-core host). The expansion seed t ~ z + (z^3+z)/(4 nu) + ... lands
# within ~1e-2 in the bulk, Newton doubles digits per step, and the
# bisection bracket (maintained from the Newton iterates' own signs,
# starting at +-1e3 >> T_3^{-1}(_EPS) ~ 72) catches any step that
# escapes — 12 iterations match the old bisection to ~1e-12. The custom
# JVP supplies the exact implicit-function derivative
# d ppf/du = 1/pdf(ppf) so the copula kernels stay differentiable.
@functools.partial(jax.custom_jvp, nondiff_argnums=(1,))
def _t_ppf(u, nu):
    u = _clip_u(u)
    z = _norm_ppf(u)
    x0 = (
        z
        + (z**3 + z) / (4.0 * nu)
        + (5.0 * z**5 + 16.0 * z**3 + 3.0 * z) / (96.0 * nu * nu)
    )
    lo = jnp.full_like(u, -1e3)
    hi = jnp.full_like(u, 1e3)
    x0 = jnp.clip(x0, lo, hi)

    def body(_, state):
        x, lo, hi = state
        f = _t_cdf(x, nu) - u
        lo = jnp.where(f < 0, x, lo)   # cdf too small -> x below root
        hi = jnp.where(f > 0, x, hi)   # cdf too big   -> x above root
        pdf = jnp.exp(_t_logpdf_uni(x, nu))
        x_new = x - f / jnp.maximum(pdf, 1e-300)
        # STRICT bracket test: at convergence the degenerate step
        # x_new == x == hi (f ~ +0 rounds the update away) must not be
        # flagged "bad" — the midpoint fallback would hurl a converged
        # lane to (lo+hi)/2 with lo still at the initial -1e3.
        bad = (
            (x_new < lo) | (x_new > hi) | ~jnp.isfinite(x_new)
        )
        x_new = jnp.where(bad, 0.5 * (lo + hi), x_new)
        return x_new, lo, hi

    x, _lo, _hi = jax.lax.fori_loop(0, 12, body, (x0, lo, hi))
    return x


@_t_ppf.defjvp
def _t_ppf_jvp(nu, primals, tangents):
    (u,) = primals
    (du,) = tangents
    x = _t_ppf(u, nu)
    return x, du / jnp.exp(_t_logpdf_uni(x, nu))


def _t_logpdf(u, v, rho, nu):
    x, y = _t_ppf(u, nu), _t_ppf(v, nu)
    r2 = rho * rho
    q = (x * x - 2.0 * rho * x * y + y * y) / (1.0 - r2)
    gl = jax.scipy.special.gammaln
    return (
        gl((nu + 2.0) / 2.0) + gl(nu / 2.0) - 2.0 * gl((nu + 1.0) / 2.0)
        - 0.5 * jnp.log(1.0 - r2)
        - (nu + 2.0) / 2.0 * jnp.log1p(q / nu)
        + (nu + 1.0) / 2.0 * (jnp.log1p(x * x / nu) + jnp.log1p(y * y / nu))
    )


def _t_h(u, v, rho, nu):
    x, y = _t_ppf(u, nu), _t_ppf(v, nu)
    scale = jnp.sqrt((1.0 - rho * rho) * (nu + y * y) / (nu + 1.0))
    return _t_cdf((x - rho * y) / scale, nu + 1.0)


def _t_hinv(w, v, rho, nu):
    y = _t_ppf(v, nu)
    scale = jnp.sqrt((1.0 - rho * rho) * (nu + y * y) / (nu + 1.0))
    x = _t_ppf(w, nu + 1.0) * scale + rho * y
    return _t_cdf(x, nu)


def _debye1(t, n_grid: int = 200):
    """D1(t) = (1/t) int_0^t x/(e^x - 1) dx via fixed trapezoid grid."""
    xs = jnp.linspace(1e-8, 1.0, n_grid) * t
    f = xs / jnp.expm1(xs)
    return jnp.trapezoid(f, xs) / t


def _frank_tau(th):
    return 1.0 - 4.0 / th * (1.0 - _debye1(th))


def _frank_theta_from_tau(tau, n_bisect: int = 60):
    """Invert tau(theta) by bisection (|theta| <= 50 covers |tau| < 0.94)."""
    sign = jnp.sign(tau)
    at = jnp.abs(tau)
    lo, hi = jnp.asarray(1e-4), jnp.asarray(50.0)

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        small = _frank_tau(mid) < at
        lo = jnp.where(small, mid, lo)
        hi = jnp.where(small, hi, mid)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, n_bisect, body, (lo, hi))
    return sign * 0.5 * (lo + hi)


_H = {
    "gaussian": _gauss_h, "clayton": _clayton_h, "gumbel": _gumbel_h,
    "frank": _frank_h, "independent": lambda u, v, th: u,
}
_HINV = {
    "gaussian": _gauss_hinv, "clayton": _clayton_hinv,
    "gumbel": _gumbel_hinv, "frank": _frank_hinv,
    "independent": lambda w, v, th: w,
}
_LOGPDF = {
    "gaussian": _gauss_logpdf, "clayton": _clayton_logpdf,
    "gumbel": _gumbel_logpdf, "frank": _frank_logpdf,
    "independent": lambda u, v, th: jnp.zeros_like(u),
}


def _install_rotations():
    """Derive the 90/180/270-degree rotated kernels from the base ones.

    With C_90(u,v) = v - C(1-u, v), C_180(u,v) = u + v - 1 + C(1-u, 1-v)
    (the survival copula) and C_270(u,v) = u - C(u, 1-v):

      h_90(u|v)  = 1 - h(1-u | v)        hinv_90(w|v)  = 1 - hinv(1-w | v)
      h_180(u|v) = 1 - h(1-u | 1-v)      hinv_180(w|v) = 1 - hinv(1-w | 1-v)
      h_270(u|v) = h(u | 1-v)            hinv_270(w|v) = hinv(w | 1-v)
      c_rot(u,v) = c(arguments reflected the same way)

    and tau_90 = tau_270 = -tau_base, tau_180 = tau_base.
    """
    for base in ("clayton", "gumbel"):
        h0, hinv0, lp0 = _H[base], _HINV[base], _LOGPDF[base]

        def h90(u, v, th, h0=h0):
            return 1.0 - h0(1.0 - u, v, th)

        def hinv90(w, v, th, hinv0=hinv0):
            return 1.0 - hinv0(1.0 - w, v, th)

        def lp90(u, v, th, lp0=lp0):
            return lp0(1.0 - u, v, th)

        def h180(u, v, th, h0=h0):
            return 1.0 - h0(1.0 - u, 1.0 - v, th)

        def hinv180(w, v, th, hinv0=hinv0):
            return 1.0 - hinv0(1.0 - w, 1.0 - v, th)

        def lp180(u, v, th, lp0=lp0):
            return lp0(1.0 - u, 1.0 - v, th)

        def h270(u, v, th, h0=h0):
            return h0(u, 1.0 - v, th)

        def hinv270(w, v, th, hinv0=hinv0):
            return hinv0(w, 1.0 - v, th)

        def lp270(u, v, th, lp0=lp0):
            return lp0(u, 1.0 - v, th)

        _H[base + "90"], _HINV[base + "90"] = h90, hinv90
        _LOGPDF[base + "90"] = lp90
        _H[base + "180"], _HINV[base + "180"] = h180, hinv180
        _LOGPDF[base + "180"] = lp180
        _H[base + "270"], _HINV[base + "270"] = h270, hinv270
        _LOGPDF[base + "270"] = lp270


_install_rotations()


def _install_t_families():
    """Register the Student-t grid families ("t3".."t15", theta = rho)."""
    for name, nu in _T_NU.items():
        _H[name] = functools.partial(_t_h, nu=nu)
        _HINV[name] = functools.partial(_t_hinv, nu=nu)
        _LOGPDF[name] = functools.partial(_t_logpdf, nu=nu)


_install_t_families()


def _split_rotation(family: str):
    """('clayton270') -> ('clayton', 270); base families -> (fam, 0)."""
    for rot in (90, 180, 270):
        s = str(rot)
        if family.endswith(s) and family[: -len(s)] in _H:
            return family[: -len(s)], rot
    return family, 0


def _theta_from_tau(family: str, tau: float):
    base, rot = _split_rotation(family)
    t = float(tau)
    if rot in (90, 270):
        t = -t  # the rotation's tau is the negated base tau
    if base == "gaussian" or base in _T_NU:
        # ellipticals share tau = (2/pi) arcsin(rho)
        return math.sin(math.pi * t / 2.0)
    if base == "clayton":
        # clayton models positive dependence; clamp away from 0
        return max(2.0 * t / max(1.0 - t, 1e-6), 1e-4)
    if base == "gumbel":
        return max(1.0 / max(1.0 - t, 1e-6), 1.0 + 1e-4)
    if base == "frank":
        return float(_frank_theta_from_tau(jnp.asarray(t)))
    return 0.0


def _family_admissible(family: str, tau: float) -> bool:
    """Can ``family`` represent dependence of this sign at all?"""
    base, rot = _split_rotation(family)
    if base not in ("clayton", "gumbel"):
        return True
    if rot in (0, 180):
        return tau > 0.0
    return tau < 0.0


_GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0


def _theta_transform(base: str):
    """(to_theta, from_theta, span): unconstrained parameterization z of
    each family's theta domain, plus the golden-section half-bracket
    width around the tau-inversion initializer (tau inversion is
    consistent, so the MLE is near it; spans are generous)."""
    if base == "gaussian" or base in _T_NU:
        return jnp.tanh, lambda th: jnp.arctanh(jnp.clip(th, -1 + 1e-7,
                                                         1 - 1e-7)), 1.0
    if base == "clayton":
        return jnp.exp, jnp.log, 1.5
    if base == "gumbel":
        return (lambda z: 1.0 + jnp.exp(z),
                lambda th: jnp.log(jnp.maximum(th - 1.0, 1e-8)), 1.5)
    if base == "frank":
        return (lambda z: z), (lambda th: th), None  # span set from |z0|
    return None


@functools.partial(jax.jit, static_argnames=("fam",))
def _loglik_kernel(u, v, th, fam):
    """Jitted pair log-likelihood sum for one family.

    The t-grid and archimedean logpdfs run fixed-iteration bisections;
    dispatched eagerly those re-trace their fori_loop bodies on every
    call (measured: a 15-family _fit_pair cost 4.25 s warm on the 1-core
    host). One compiled program per (family, shape) makes the scoring
    sub-millisecond after the first call.
    """
    return jnp.sum(_LOGPDF[fam](u, v, th))


@functools.partial(jax.jit, static_argnames=("fam", "n_steps"))
def _mle_refine_kernel(u, v, theta0, fam, n_steps=40):
    """Maximize the pair log-likelihood over theta by golden-section
    search in the unconstrained z-space, bracketed around the
    tau-inversion initializer. Derivative-free (no Hessians through
    betainc/bisection kernels), jit-safe (fixed iteration count), and
    the 1-D pair NLLs are unimodal in practice. 40 halvings shrink the
    bracket by 0.618^40 ~ 4e-9. Returns (theta_hat, loglik_hat)."""
    base, _rot = _split_rotation(fam)
    to_theta, from_theta, span = _theta_transform(base)
    logpdf = _LOGPDF[fam]

    def nll(z):
        return -jnp.sum(logpdf(u, v, to_theta(z)))

    z0 = from_theta(theta0)
    if span is None:  # frank: theta is unbounded, scale with the init
        span = jnp.maximum(2.0, 0.6 * jnp.abs(z0))

    def body(_, lohi):
        lo, hi = lohi
        c = hi - _GOLDEN * (hi - lo)
        d = lo + _GOLDEN * (hi - lo)
        shrink_hi = nll(c) < nll(d)
        return jnp.where(shrink_hi, lo, c), jnp.where(shrink_hi, d, hi)

    lo, hi = jax.lax.fori_loop(
        0, n_steps, body, (z0 - span, z0 + span)
    )
    z_hat = 0.5 * (lo + hi)
    # keep the initializer if the search somehow did worse (bracket edge)
    better = nll(z_hat) < nll(z0)
    z_hat = jnp.where(better, z_hat, z0)
    return to_theta(z_hat), -nll(z_hat)


def _fit_pair(u, v, families=FAMILIES, refine=False):
    """Fit each family by tau inversion; select by AIC (the one-parameter
    families pay a 1-nat penalty). Rotated clayton/gumbel compete for
    their admissible tau sign (90/270: negative; base/180: positive).

    refine=True additionally maximizes each admissible family's
    log-likelihood over theta (golden-section MLE seeded by the tau
    inversion — the standard sequential-MLE vine fit, e.g. Dissmann et
    al. 2013 §2.3) and selects by the MAXIMIZED AIC, which is its
    proper definition.

    Family selection is preceded by the standard Kendall-tau independence
    test (Dissmann et al. 2013 use exactly this gate before every pair
    fit): under independence tau is asymptotically N(0, 2(2n+5)/(9n(n-1))),
    and a noise-level tau routinely wins ~2 nats of spurious
    log-likelihood — the AIC penalty alone cannot reject it, which shows
    up as phantom dependence in the deep trees of a vine.
    """
    n = int(np.shape(u)[0])
    if n < 2:
        raise ValueError(
            f"pair-copula fitting needs at least 2 samples, got {n}"
        )
    tau = float(kendall_tau(u, v))
    tau_sd = math.sqrt(2.0 * (2 * n + 5) / (9.0 * n * (n - 1.0)))
    if abs(tau) < 1.96 * tau_sd:
        return "independent", 0.0, tau
    best = ("independent", 0.0, 0.0)
    for fam in families:
        if fam == "independent":
            continue  # the baseline, score 0
        if not _family_admissible(fam, tau):
            continue
        th = _theta_from_tau(fam, tau)
        if refine:
            th_j, ll_raw = _mle_refine_kernel(
                jnp.asarray(u), jnp.asarray(v), jnp.asarray(float(th)), fam
            )
            th, ll_raw = float(th_j), float(ll_raw)
        else:
            ll_raw = float(_loglik_kernel(
                jnp.asarray(u), jnp.asarray(v), jnp.asarray(float(th)), fam
            ))
        # AIC penalty of k nats: 1 for the one-parameter families, 2 for
        # the Student-t grid (rho plus the df picked by the selection)
        k = 2.0 if _split_rotation(fam)[0] in _T_NU else 1.0
        ll = ll_raw - k
        if ll > best[1]:
            best = (fam, ll, th)
    return best[0], best[2], tau


class CVineCopula:
    """Canonical vine copula over empirical marginals.

    ``fit(samples)``: rank-transform each column to uniforms, order the
    variables by total |tau| (strongest-dependence root first, the
    standard C-vine heuristic), then fit tree after tree: tree t pairs the
    root-t variable with every later variable conditional on the first
    t-1 roots, conditioning via h-functions.

    ``sample(n, key)``: Aas et al. (2009) Algorithm 1 — independent
    uniforms pushed through inverse h-functions down the vine — then each
    uniform column is inverted through the stored empirical marginal.
    """

    def __init__(self, families=FAMILIES, refine=False):
        self.families = tuple(families)
        self.refine = bool(refine)

    def fit(self, samples):
        x = jnp.asarray(samples)
        n, d = x.shape
        order_ = jnp.argsort(x, axis=0)
        ranks = jnp.zeros_like(order_).at[
            order_, jnp.arange(d)[None, :]
        ].set(jnp.arange(n)[:, None])
        u = (np.asarray(ranks) + 0.5) / n

        # C-vine variable order: root = max sum |tau| against the rest
        taus = np.zeros((d, d))
        for i in range(d):
            for j in range(i + 1, d):
                taus[i, j] = taus[j, i] = float(
                    kendall_tau(u[:, i], u[:, j])
                )
        self.var_order = list(np.argsort(-np.abs(taus).sum(axis=0)))
        u = u[:, self.var_order]

        # tree-by-tree pair fits; v[t][j] are the pseudo-observations of
        # variable j conditional on roots 0..t-1
        self.pairs = []          # pairs[t][j] = (family, theta)
        v = jnp.asarray(u)
        for t in range(d - 1):
            row = []
            for j in range(t + 1, d):
                fam, th, _tau = _fit_pair(
                    v[:, j], v[:, t], families=self.families,
                    refine=self.refine,
                )
                row.append((fam, th))
            self.pairs.append(row)
            if t == d - 2:
                break
            # condition every later variable on the current root
            new_cols = [
                _H[row[j - t - 1][0]](v[:, j], v[:, t], row[j - t - 1][1])
                for j in range(t + 1, d)
            ]
            v = jnp.concatenate(
                [v[:, : t + 1], jnp.stack(new_cols, axis=1)], axis=1
            )
        self._marginals = jnp.sort(x, axis=0)
        self.n, self.d = n, d
        return self

    def sample_uniform(self, n_samples: int, key=0) -> jnp.ndarray:
        """Uniform-scale samples (columns in the ORIGINAL variable order).

        Aas et al. (2009) Algorithm 1: maintain cond[k] =
        F(x_k | x_0..x_{k-1}); each new variable inverts the h-chain from
        its deepest tree up to tree 0, then its own conditional
        pseudo-observation is built by chaining h back down.
        """
        d = self.d
        w = jax.random.uniform(
            as_key(key), (n_samples, d), minval=_EPS, maxval=1.0 - _EPS
        )
        cols = [w[:, 0]]
        cond = [w[:, 0]]         # cond[k] = F(x_k | roots 0..k-1)
        for i in range(1, d):
            t_i = w[:, i]
            for k in range(i - 1, -1, -1):
                fam, th = self.pairs[k][i - k - 1]
                t_i = _HINV[fam](t_i, cond[k], th)
            cols.append(t_i)
            if i < d - 1:
                v = t_i
                for k in range(i):
                    fam, th = self.pairs[k][i - k - 1]
                    v = _H[fam](v, cond[k], th)
                cond.append(v)
        us = jnp.stack(cols, axis=1)
        inv = np.argsort(self.var_order)
        return us[:, jnp.asarray(inv)]

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
