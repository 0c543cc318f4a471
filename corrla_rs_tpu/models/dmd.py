"""Dynamic Mode Decomposition with control (DMDc).

Proctor / Brunton / Kutz, "Dynamic Mode Decomposition with Control".
Represents x_{t+1} = A x_t + B u_t. Parity with reference dmd_rom.rs:20-225:

- Omega = vstack(X; U), input space Omega[:, :-1], output space X'
  (dmd_rom.rs:66,149-162)
- RSVD of both spaces with 12 oversamples (dmd_rom.rs:72,82)
- A~ from eq. 29, B~ from eq. 30 (dmd_rom.rs:90-106)
- complex eigendecomposition of A~ (dmd_rom.rs:112-125) — the r x r
  nonsymmetric eigensolve runs eagerly on host LAPACK between the two
  jitted stages via ops.eig.eig_host; everything else is on-device XLA
- DMD modes from eq. 36 kept as real/imag parts (dmd_rom.rs:128-146)
- est_a_til reconstructs A = Phi Lambda Phi^+ in complex arithmetic
  (dmd_rom.rs:165-175)

Deltas from the reference: the rollout in ``predict_multiple`` is a ``lax.scan``
with A precomputed once (the reference rebuilds A from the
eigendecomposition on every ``predict`` call, dmd_rom.rs:191,204).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from corrla_rs_tpu.ops.eig import eig_host
from corrla_rs_tpu.ops.mat_utils import PRECISION, mat_pinv_comp, pinv_diag
from corrla_rs_tpu.ops.random_svd import random_svd
from corrla_rs_tpu.utils.config import DmdConfig
from corrla_rs_tpu.utils.prng import as_key

# Reference default oversamples for both RSVDs (dmd_rom.rs:72,82).
# Single source of truth: utils.config.
DMD_N_OVERSAMPLES = DmdConfig().n_oversamples


def _pinv_complex_np(x: np.ndarray, rtol: float = 1.0e-10) -> np.ndarray:
    """Rank-cutoff complex pinv — deliberate deviation from the reference's
    additive-eps mat_pinv_comp (mat_utils.rs:56-71): when DMDc is over-
    parameterized (n_modes > numerical rank — routine in practice), the
    junk mode columns of Phi are *near*-zero, and 1/(s + 1e-16) amplifies
    them by ~1e16; the resulting A operator carries O(1)-to-huge garbage
    and rollouts explode (reproduced: rank-2 data with n_modes=6 gives
    rollout error 1e26 under the reference formula, 2e-2 with the cutoff).
    The parity-exact reference semantics remain available as
    ``mat_utils.mat_pinv_comp(x, mode="reference")``.
    """
    return mat_pinv_comp(x, eps=rtol, mode="cutoff")


@functools.partial(
    jax.jit,
    static_argnames=("n_x", "n_u", "n_modes", "n_iters", "n_oversamples"),
)
def _dmdc_reduce_kernel(x_data, u_data, n_x, n_u, n_modes, n_iters,
                        n_oversamples, key):
    """On-device stage 1: both RSVDs + reduced operators (eqs. 29-30)."""
    omega = jnp.concatenate([x_data, u_data], axis=0)
    x_in = omega[:, :-1]            # input space (state + control)
    y_out = omega[:n_x, 1:]         # output space (state only)

    k1, k2 = jax.random.split(key)
    u_til, s_til, vt_til = random_svd(
        x_in, n_modes, n_iters, n_oversamples, key=k1
    )
    v_til = vt_til.T                # ((n_t - 1), r)
    u_til_1 = u_til[:n_x, :]
    u_til_2 = u_til[n_x : n_x + n_u, :]

    u_hat, _s_hat, _vt_hat = random_svd(
        y_out, n_modes, n_iters, n_oversamples, key=k2
    )

    s_til_diag = jnp.diag(s_til)
    s_til_inv = pinv_diag(s_til_diag)

    # eq. 29 (dmd_rom.rs:90-97)
    mm = functools.partial(jnp.matmul, precision=PRECISION)
    tmp_op_scale = mm(mm(mm(u_hat.T, y_out), v_til), s_til_inv)
    a_til = mm(mm(tmp_op_scale, u_til_1.T), u_hat)
    # eq. 30 (dmd_rom.rs:100-106)
    b_til = mm(tmp_op_scale, u_til_2.T)
    b_op = mm(u_hat, b_til)

    # eq. 36 mode prefactor (dmd_rom.rs:134-139)
    tmp_modes_scale = mm(
        mm(mm(mm(y_out, v_til), pinv_diag(s_til_diag)), u_til_1.T), u_hat
    )
    return a_til, b_op, tmp_modes_scale, u_hat


@jax.jit
def _dmdc_modes_kernel(tmp_modes_scale, w_re, w_im):
    """On-device stage 2: project eigenvectors to DMD modes (eq. 36)."""
    mm = functools.partial(jnp.matmul, precision=PRECISION)
    return mm(tmp_modes_scale, w_re), mm(tmp_modes_scale, w_im)


@jax.jit
def _rollout(a_op, b_op, x0, u_seq):
    """x <- A x + B u over the columns of u_seq via lax.scan."""
    def step(x, u_col):
        x_next = (
            jnp.matmul(a_op, x, precision=PRECISION)
            + jnp.matmul(b_op, u_col[:, None], precision=PRECISION)
        )
        return x_next, x_next[:, 0]

    _, xs = lax.scan(step, x0, u_seq.T)
    return xs.T  # (n_x, n_times)


@jax.jit
def _rollout_reduced(u_hat, a_til, b_op, x0, u_seq):
    """Eig-free rollout in the reduced basis:
    x_{t+1} = U_hat (A~ (U_hat^T x_t)) + B u_t — fully on-device (no host
    eigendecomposition anywhere in the chain), O(n_x * r) per step. This
    is the standard projected DMDc surrogate; it matches the
    eigendecomposition-based rollout to fp precision whenever the
    dynamics are captured by the reduced basis (tested on the reference
    fixture), and avoids the host sync entirely."""
    mm = functools.partial(jnp.matmul, precision=PRECISION)

    def step(x, u_col):
        x_next = mm(u_hat, mm(a_til, mm(u_hat.T, x))) + mm(b_op, u_col[:, None])
        return x_next, x_next[:, 0]

    _, xs = lax.scan(step, x0, u_seq.T)
    return xs.T


@jax.jit
def _rollout_factored(phi_re, phi_im, w_re, w_im, b_op, x0, u_seq):
    """Rollout with A applied in factored form:
    A x = Phi_r (W_r x) - Phi_i (W_i x) — O(n_x * r) per step instead of
    the dense O(n_x^2); avoids ever materializing the (n_x, n_x) operator.
    """
    mm = functools.partial(jnp.matmul, precision=PRECISION)

    def step(x, u_col):
        ax = mm(phi_re, mm(w_re, x)) - mm(phi_im, mm(w_im, x))
        x_next = ax + mm(b_op, u_col[:, None])
        return x_next, x_next[:, 0]

    _, xs = lax.scan(step, x0, u_seq.T)
    return xs.T


class DMDc:
    """DMD with control. Constructor mirrors PyDMDc
    (lib_math_utils_py.rs:262-271): ``DMDc(x_data, u_data, n_modes,
    n_iters)`` with dt fixed at 1.0 like the binding (lib_math_utils_py.rs:269).

    x_data: (n_x, n_t) snapshot columns; u_data: (n_u, n_t) control columns.

    eig_backend: 'host' (default — host LAPACK for the tiny r x r
    nonsymmetric eigensolve, eager between the two jitted stages) or
    'device' (ops/eig_device's pure-JAX Francis-QR Schur solver — the fit
    runs end-to-end on device with no host sync; same API surface, f32
    eigenvalues accurate to ~eps*||A~||*cond like any QR method).
    """

    def __init__(self, x_data, u_data, n_modes: int, n_iters: int,
                 dt: float | None = None, key=0, mesh=None,
                 config: DmdConfig | None = None, eig_backend: str = "host"):
        cfg = config or DmdConfig()
        if eig_backend not in ("host", "device"):
            # validate BEFORE the expensive reduce kernel runs: a typo like
            # 'Device' must not waste a full fit before raising
            raise ValueError(
                f"eig_backend must be 'host' or 'device', got {eig_backend!r}"
            )
        if mesh is None:
            # Small fits may route to the in-process CPU backend below
            # the dispatch-bound crossover (utils/smallpath).
            from corrla_rs_tpu.utils.smallpath import maybe_route_small

            x_data, u_data = maybe_route_small(x_data, u_data)
        x = jnp.asarray(x_data)
        u = jnp.asarray(u_data)
        if mesh is not None:
            # Row-shard the state dimension; GSPMD partitions the whole
            # jitted reduce kernel (the fast-QR path is Gram-based, so the
            # big contractions become psums over the mesh axis). The time
            # axis (n_t) is small and stays replicated.
            from corrla_rs_tpu.parallel.mesh import shard_rows

            if x.shape[0] % mesh.devices.size != 0:
                raise ValueError(
                    f"DMDc mesh= requires the state dimension "
                    f"({x.shape[0]}) to divide the mesh size "
                    f"({mesh.devices.size}); pad the snapshots or drop "
                    "mesh= (silently falling back to one chip would hide "
                    "a large performance cliff)"
                )
            x = shard_rows(x, mesh)
        self.n_snapshots = x.shape[1]
        self.n_x = x.shape[0]
        self.n_u = u.shape[0]
        self.n_modes = int(n_modes)
        self.dt_snapshots = float(dt if dt is not None else cfg.dt)
        # Stage 1 on device; the tiny r x r nonsymmetric eigensolve on host
        # LAPACK (ops.eig.eig_host runs eagerly between the two jitted
        # stages); stage 2 back on device.
        self._A, self._B, tmp_modes_scale, self._u_hat = _dmdc_reduce_kernel(
            x, u, self.n_x, self.n_u, self.n_modes, int(n_iters),
            int(cfg.n_oversamples), as_key(key),
        )
        if eig_backend == "device":
            # Fully on-device eigendecomposition (ops/eig_device: implicit
            # Francis QR -> real Schur + batched inverse iteration) — no
            # host sync anywhere in the fit chain, so the whole constructor
            # pipeline can run inside jit/pjit programs and batch under
            # vmap. Complex algebra is carried as (re, im) real pairs.
            from corrla_rs_tpu.ops.eig_device import eig_device
            from corrla_rs_tpu.ops.mat_utils import pinv_comp_parts

            lam_re, lam_im, w_re, w_im = eig_device(self._A)
            self.modes_re, self.modes_im = _dmdc_modes_kernel(
                tmp_modes_scale, w_re, w_im
            )
            self._a_full = None
            # W = diag(lambda) Phi^+ via the real-embedded complex pinv
            # (rank-cutoff semantics matching _pinv_complex_np)
            p_re, p_im = pinv_comp_parts(self.modes_re, self.modes_im)
            self._w_re = lam_re[:, None] * p_re - lam_im[:, None] * p_im
            self._w_im = lam_re[:, None] * p_im + lam_im[:, None] * p_re
            # public surface parity: lambdas is a host numpy complex array
            # in both backends (one small stacked fetch)
            both = np.asarray(jnp.stack([lam_re, lam_im]))
            self.lambdas = both[0] + 1j * both[1]
            return
        lam, w = eig_host(self._A)
        # lambdas stay a host numpy array (the public surface)
        self.lambdas = lam
        self.modes_re, self.modes_im = _dmdc_modes_kernel(
            tmp_modes_scale,
            jnp.asarray(np.real(w), x.dtype),
            jnp.asarray(np.imag(w), x.dtype),
        )
        # The dense (n_x, n_x) A operator is built lazily (first dense
        # predict / est_a_til call): at large n_x it costs O(n_x^2) host
        # memory + compute that the factored rollout never needs.
        self._a_full = None
        # Factored dynamics for the O(n_x * r) rollout (method='modes'):
        # A = Re(Phi Lambda Phi^+) = Phi_r W_r - Phi_i W_i with
        # W = diag(lambda) Phi^+ (host complex, tiny). One stacked fetch
        # instead of two device->host transfers.
        both = np.asarray(jnp.stack([self.modes_re, self.modes_im]))
        phi = both[0] + 1j * both[1]
        w = lam[:, None] * _pinv_complex_np(phi)
        self._w_re = jnp.asarray(np.real(w), x.dtype)
        self._w_im = jnp.asarray(np.imag(w), x.dtype)

    def est_a_til(self) -> jnp.ndarray:
        """Full-state A estimated from the eigendecomposition
        (dmd_rom.rs:165-175). Built once, lazily — reconstruct with the
        factored form A = Re(Phi Lambda Phi^+) computed as
        (Phi_r W_r - Phi_i W_i) on device, O(n_x^2 r) as dense matmuls instead
        of host complex algebra."""
        if self._a_full is None:
            mm = functools.partial(jnp.matmul, precision=PRECISION)
            self._a_full = (
                mm(self.modes_re, self._w_re) - mm(self.modes_im, self._w_im)
            ).astype(self.modes_re.dtype)
        return self._a_full

    def est_b_til(self) -> jnp.ndarray:
        """Full-state B operator. dmd_rom.rs:178-180."""
        return self._B

    def predict(self, x_0, u_input) -> jnp.ndarray:
        """One step: A x_0 + B u. Parity with dmd_rom.rs:185-194."""
        x0 = jnp.asarray(x_0)
        u = jnp.asarray(u_input)
        assert x0.shape == (self.n_x, 1)
        assert u.shape == (self.n_u, 1)
        return (
            jnp.matmul(self.est_a_til(), x0, precision=PRECISION)
            + jnp.matmul(self._B, u, precision=PRECISION)
        )

    def predict_multiple(self, x_0, u_seq, method: str = "dense") -> jnp.ndarray:
        """Roll the dynamics over the columns of u_seq. dmd_rom.rs:199-225.

        Returns (n_x, n_times); column j is the state after stepping with
        u_seq[:, j] (matching the reference's output layout).

        method='modes' applies A in factored form (O(n_x * r) per step,
        never materializing the dense (n_x, n_x) operator) — use for large
        state dimensions; numerically identical up to fp rounding.
        method='reduced' rolls in the POD basis U_hat A~ U_hat^T — also
        O(n_x * r) and the only variant with NO host eigendecomposition
        anywhere in its chain (fully on-device end to end).
        """
        x0 = jnp.asarray(x_0)
        u = jnp.asarray(u_seq)
        assert x0.shape == (self.n_x, 1)
        assert u.shape[0] == self.n_u
        if method == "modes":
            return _rollout_factored(
                self.modes_re, self.modes_im, self._w_re, self._w_im,
                self._B, x0, u,
            )
        if method == "reduced":
            return _rollout_reduced(self._u_hat, self._A, self._B, x0, u)
        return _rollout(self.est_a_til(), self._B, x0, u)


def dmdc_fit_ensemble(x_batch, u_batch, n_modes: int, n_iters: int, key=0,
                      config: DmdConfig | None = None):
    """Vmapped DMDc fits over an ensemble of snapshot families — fully
    on-device (EXTENSION; no reference analogue).

    Enabled by ops/eig_device: with the r x r eigensolve on device, the
    entire fit chain (two RSVDs -> reduced operators -> Francis-QR eig ->
    modes -> factored dynamics) is one jit+vmap program, so B ensemble
    members (bootstrap resamples, parameter sweeps, perturbed ICs) fit in
    a single batched dispatch instead of B host round-trips. The host-eig
    path can never batch this way.

    x_batch: (B, n_x, n_t) snapshot ensembles; u_batch: (B, n_u, n_t).
    Returns a dict of batched device arrays:
      ``lambdas_re/lambdas_im`` (B, r) — DMD eigenvalue spectra,
      ``modes_re/modes_im``     (B, n_x, r),
      ``a_til`` (B, r, r), ``b_op`` (B, n_x, n_u), ``u_hat`` (B, n_x, r),
      ``w_re/w_im`` (B, r, n_x) — factored dynamics (A = Phi_r W_r -
      Phi_i W_i), ready for ``rollout_ensemble``.
    """
    cfg = config or DmdConfig()
    x_batch = jnp.asarray(x_batch)
    u_batch = jnp.asarray(u_batch)
    if x_batch.ndim != 3 or u_batch.ndim != 3:
        raise ValueError(
            f"expected (B, n_x, n_t) and (B, n_u, n_t) batches, got "
            f"{x_batch.shape} and {u_batch.shape}"
        )
    b, n_x, _n_t = x_batch.shape
    n_u = u_batch.shape[1]
    keys = jax.random.split(as_key(key), b)
    fitter = _ensemble_fitter(
        n_x, n_u, int(n_modes), int(n_iters), int(cfg.n_oversamples)
    )
    return fitter(x_batch, u_batch, keys)


@functools.lru_cache(maxsize=64)
def _ensemble_fitter(n_x, n_u, n_modes, n_iters, n_os):
    """Cached jit(vmap(...)) for the full batched fit graph.

    One compiled executable, one dispatch, STABLE function identity: a
    fresh ``jax.jit(jax.vmap(f))`` per call would re-trace every time
    (the persistent cache only skips the XLA compile, not the trace),
    while an unjitted vmap eagerly dispatches each stage.
    """
    from corrla_rs_tpu.ops.eig_device import eig_device
    from corrla_rs_tpu.ops.mat_utils import pinv_comp_parts

    def fit_one(x, u, k):
        a_til, b_op, tmp_modes_scale, u_hat = _dmdc_reduce_kernel(
            x, u, n_x, n_u, n_modes, n_iters, n_os, k
        )
        lam_re, lam_im, v_re, v_im = eig_device(a_til)
        modes_re, modes_im = _dmdc_modes_kernel(tmp_modes_scale, v_re, v_im)
        p_re, p_im = pinv_comp_parts(modes_re, modes_im)
        w_re = lam_re[:, None] * p_re - lam_im[:, None] * p_im
        w_im = lam_re[:, None] * p_im + lam_im[:, None] * p_re
        return dict(
            lambdas_re=lam_re, lambdas_im=lam_im,
            modes_re=modes_re, modes_im=modes_im,
            a_til=a_til, b_op=b_op, u_hat=u_hat, w_re=w_re, w_im=w_im,
        )

    return jax.jit(jax.vmap(fit_one))


def rollout_ensemble(fit, x0_batch, u_seq, method: str = "reduced"):
    """Roll every ensemble member forward in one vmapped dispatch.

    fit: output of ``dmdc_fit_ensemble``; x0_batch: (B, n_x, 1);
    u_seq: (n_u, n_times) shared controls or (B, n_u, n_times) per-member.
    method: 'reduced' (POD-basis rollout, eig-free) or 'modes' (factored
    eigendynamics). Returns (B, n_x, n_times).
    """
    x0_batch = jnp.asarray(x0_batch)
    u_seq = jnp.asarray(u_seq)
    b = x0_batch.shape[0]
    if u_seq.ndim == 2:
        u_seq = jnp.broadcast_to(u_seq, (b,) + u_seq.shape)
    if method == "reduced":
        return _ROLLOUT_REDUCED_BATCHED(
            fit["u_hat"], fit["a_til"], fit["b_op"], x0_batch, u_seq
        )
    if method == "modes":
        return _ROLLOUT_FACTORED_BATCHED(
            fit["modes_re"], fit["modes_im"], fit["w_re"], fit["w_im"],
            fit["b_op"], x0_batch, u_seq,
        )
    raise ValueError(f"method must be 'reduced' or 'modes', got {method!r}")


# stable-identity batched rollouts (see _ensemble_fitter docstring)
_ROLLOUT_REDUCED_BATCHED = jax.jit(jax.vmap(_rollout_reduced))
_ROLLOUT_FACTORED_BATCHED = jax.jit(jax.vmap(_rollout_factored))


# ---------------------------------------------------------------------------
# Plain (uncontrolled) DMD — EXTENSION, no reference analogue
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit, static_argnames=("n_modes", "n_iters", "n_oversamples",
                              "rank_rtol")
)
def _dmd_reduce_kernel(x_data, n_modes, n_iters, n_oversamples, key,
                       rank_rtol=0.0):
    """Exact DMD stage 1 (Tu et al. 2014): rank-r RSVD of X1 and the
    reduced operator A~ = U^T X2 V S^{-1}; also returns the exact-mode
    prefactor X2 V S^{-1} (modes Phi = X2 V S^{-1} W).

    rank_rtol=0 keeps the reference's eps-pinv of S (dmd_rom.rs parity:
    near-zero singular values invert to huge factors when the requested
    rank exceeds the data's numerical rank). rank_rtol>0 zeroes
    directions with s < rank_rtol * s_max instead; their columns of the
    operator/modes vanish and they surface as lambda ~= 0 modes —
    harmless and easy to filter (mrdmd relies on this)."""
    x1 = x_data[:, :-1]
    x2 = x_data[:, 1:]
    u_r, s_r, vt_r = random_svd(x1, n_modes, n_iters, n_oversamples,
                                key=key)
    v_r = vt_r.T
    if rank_rtol > 0.0:
        inv = jnp.where(s_r > rank_rtol * s_r[0],
                        1.0 / jnp.maximum(s_r, 1e-300), 0.0)
        s_inv = jnp.diag(inv.astype(x_data.dtype))
    else:
        s_inv = pinv_diag(jnp.diag(s_r))
    mm = functools.partial(jnp.matmul, precision=PRECISION)
    proj = mm(mm(x2, v_r), s_inv)          # (n_x, r) exact-mode prefactor
    a_til = mm(u_r.T, proj)
    return a_til, proj, u_r


@functools.partial(
    jax.jit, static_argnames=("n_modes", "n_iters", "n_oversamples")
)
def _dmd_reduce_tls(x_data, n_modes, n_iters, n_oversamples, key):
    """Total-least-squares DMD stage 1 (Hemati et al. 2017) — EXTENSION,
    no reference analogue (dmd_rom.rs is ordinary-LS only).

    Ordinary LS treats X1 as exact and attributes all noise to X2, which
    biases the spectrum toward the unit-disk interior. TLS projects both
    onto a rank-r POD basis of the full snapshot set, then takes the
    leading left singular subspace of the STACKED [X1r; X2r]: with
    U_z = [U11; U21], A~ = U21 U11^{-1} is the TLS operator (errors in
    both variables). The (2r, 2r) subspace comes from one eigh of the
    stacked Gram — small, on-device, jittable."""
    x1 = x_data[:, :-1]
    x2 = x_data[:, 1:]
    u_pod, _, _ = random_svd(x_data, n_modes, n_iters, n_oversamples,
                             key=key)
    mm = functools.partial(jnp.matmul, precision=PRECISION)
    x1r = mm(u_pod.T, x1)
    x2r = mm(u_pod.T, x2)
    z = jnp.concatenate([x1r, x2r], axis=0)           # (2r, m-1)
    g = mm(z, z.T)                                    # (2r, 2r)
    _, evecs = jnp.linalg.eigh(g)                     # ascending
    uz = evecs[:, ::-1][:, :n_modes]                  # leading r
    u11 = uz[:n_modes]
    u21 = uz[n_modes:]
    # A~ = U21 U11^{-1}  <=>  A~^T = solve(U11^T, U21^T)
    a_til = jnp.linalg.solve(u11.T, u21.T).T
    return a_til, u_pod, u_pod


def _sqrtm_db(a, n_steps: int = 30):
    """Principal matrix square root via the Denman-Beavers iteration:
    Y <- (Y + Z^{-1})/2, Z <- (Z + Y^{-1})/2 with Y0=A, Z0=I; Y -> A^{1/2}
    (quadratic convergence for A with no eigenvalue on R^-). Real
    arithmetic throughout — the principal root of a real matrix with no
    real-negative eigenvalue is real — so it is jit/vmap-safe on backends
    with no complex dtypes."""
    eye = jnp.eye(a.shape[0], dtype=a.dtype)

    def step(_, yz):
        y, z = yz
        return 0.5 * (y + jnp.linalg.inv(z)), 0.5 * (z + jnp.linalg.inv(y))

    y, _ = lax.fori_loop(0, n_steps, step, (a, eye))
    return y


@functools.partial(
    jax.jit, static_argnames=("n_modes", "n_iters", "n_oversamples")
)
def _dmd_reduce_fb(x_data, n_modes, n_iters, n_oversamples, key):
    """Forward-backward DMD stage 1 (Dawson et al. 2016) — EXTENSION.

    Sensor noise biases the forward LS operator toward the unit-disk
    interior and the backward one outward; their geometric mean
    A = (A_f A_b^{-1})^{1/2} cancels the leading-order bias. Both
    operators are fit in ONE shared POD basis of the full snapshot set
    (so the product is meaningful), and the square root is the real
    Denman-Beavers principal root — fully on-device, no complex algebra.

    Branch caveat (inherent to every fb-DMD): the principal root flips
    eigenvalues of A_f A_b^{-1} that lie on the negative real axis
    (true lambda ~= +-i); prefer solver='tls' for such spectra."""
    x1 = x_data[:, :-1]
    x2 = x_data[:, 1:]
    u_pod, _, _ = random_svd(x_data, n_modes, n_iters, n_oversamples,
                             key=key)
    mm = functools.partial(jnp.matmul, precision=PRECISION)
    x1r = mm(u_pod.T, x1)
    x2r = mm(u_pod.T, x2)
    g11 = mm(x1r, x1r.T)
    g22 = mm(x2r, x2r.T)
    g21 = mm(x2r, x1r.T)
    # forward A_f = G21 G11^{-1}; backward A_b = G21^T G22^{-1}
    a_f = jnp.linalg.solve(g11.T, g21.T).T
    a_b = jnp.linalg.solve(g22.T, g21).T
    # A^2 = A_f A_b^{-1}  <=>  (A^2)^T = solve(A_b^T, A_f^T)
    a_sq = jnp.linalg.solve(a_b.T, a_f.T).T
    return _sqrtm_db(a_sq), u_pod, u_pod


@jax.jit
def _rollout_plain(phi_re, phi_im, w_re, w_im, x0, n_ones):
    """x <- Re(Phi Lambda Phi^+) x via the factored form, O(n_x r)/step.
    ``n_ones`` is a length-n_steps dummy scanned for its length only."""
    mm = functools.partial(jnp.matmul, precision=PRECISION)

    def step(x, _):
        ax = mm(phi_re, mm(w_re, x)) - mm(phi_im, mm(w_im, x))
        return ax, ax[:, 0]

    _, xs = lax.scan(step, x0, n_ones)
    return xs.T


class DMD:
    """Exact Dynamic Mode Decomposition (no control input) — EXTENSION
    (the reference only implements DMDc; this completes the ROM family
    with the Tu / Rowley / Luchtenburg / Brunton / Kutz 2014 exact DMD).

    x_data: (n_x, n_t) snapshot columns of an autonomous system
    x_{t+1} ~= A x_t. Rank-r fit via the library's randomized SVD of X1;
    A~ = U_r^T X2 V_r S_r^{-1}; exact DMD modes Phi = X2 V_r S_r^{-1} W.

    eig_backend: 'host' (LAPACK, eager between jitted stages) or
    'device' (ops/eig_device Francis-QR — zero host sync, vmappable).

    rank_rtol (solver='exact' only): 0 (default) = reference eps-pinv
    semantics; > 0 truncates singular values below rank_rtol * s_max so
    a requested rank beyond the data's numerical rank degrades to inert
    lambda ~= 0 modes instead of amplifying noise (use on possibly
    rank-deficient snapshots, e.g. mrDMD window residuals).

    solver: 'exact' (Tu et al. 2014 ordinary LS, exact modes),
    'tls' (total-least-squares operator, Hemati et al. 2017 — errors in
    both X1 and X2, debiased spectrum under sensor noise) or 'fb'
    (forward-backward geometric mean, Dawson et al. 2016 — same goal;
    principal-root branch assumes no eigenvalue of A^2 on R^-, see
    :func:`_dmd_reduce_fb`). 'tls'/'fb' return PROJECTED modes
    Phi = U_pod W (the exact-mode prefactor is an OLS construct).

    Attributes after fit: ``lambdas`` (complex host array),
    ``modes_re``/``modes_im`` (n_x, r), ``amplitudes`` (complex host —
    b = Phi^+ x_0, the spectral content of the first snapshot).
    ``eigs_continuous(dt)`` returns log(lambda)/dt (growth rate +
    i*frequency).
    """

    def __init__(self, x_data, n_modes: int, n_iters: int = 10, key=0,
                 eig_backend: str = "host", solver: str = "exact",
                 config: DmdConfig | None = None,
                 rank_rtol: float = 0.0):
        # rank_rtol sits AFTER config so pre-existing positional
        # callers (x, r, iters, key, backend, solver, config) keep
        # binding config correctly
        cfg = config or DmdConfig()
        if eig_backend not in ("host", "device"):
            raise ValueError(
                f"eig_backend must be 'host' or 'device', got {eig_backend!r}"
            )
        if solver not in ("exact", "tls", "fb"):
            raise ValueError(
                f"solver must be 'exact', 'tls' or 'fb', got {solver!r}"
            )
        if rank_rtol and solver != "exact":
            raise ValueError(
                "rank_rtol is only meaningful for solver='exact' (tls/fb "
                "regularize through their POD projection instead)"
            )
        from corrla_rs_tpu.utils.smallpath import maybe_route_small

        (x_data,) = maybe_route_small(x_data)
        x = jnp.asarray(x_data)
        self.n_x, self.n_t = x.shape
        self.n_modes = int(n_modes)
        self.solver = solver
        if solver == "exact":
            a_til, proj, u_r = _dmd_reduce_kernel(
                x, self.n_modes, int(n_iters), int(cfg.n_oversamples),
                as_key(key), rank_rtol=float(rank_rtol),
            )
        else:
            reduce_kernel = {"tls": _dmd_reduce_tls,
                             "fb": _dmd_reduce_fb}[solver]
            a_til, proj, u_r = reduce_kernel(
                x, self.n_modes, int(n_iters), int(cfg.n_oversamples),
                as_key(key),
            )
        self._A = a_til
        self._u_r = u_r
        if eig_backend == "device":
            from corrla_rs_tpu.ops.eig_device import eig_device
            from corrla_rs_tpu.ops.mat_utils import pinv_comp_parts

            lam_re, lam_im, v_re, v_im = eig_device(a_til)
            mm = functools.partial(jnp.matmul, precision=PRECISION)
            self.modes_re = mm(proj, v_re)
            self.modes_im = mm(proj, v_im)
            p_re, p_im = pinv_comp_parts(self.modes_re, self.modes_im)
            self._w_re = lam_re[:, None] * p_re - lam_im[:, None] * p_im
            self._w_im = lam_re[:, None] * p_im + lam_im[:, None] * p_re
            both = np.asarray(jnp.stack([lam_re, lam_im]))
            self.lambdas = both[0] + 1j * both[1]
            # amplitudes via the real-embedded pinv: b = Phi^+ x0
            x0 = np.asarray(x[:, 0:1])
            pr, pi = np.asarray(p_re), np.asarray(p_im)
            b = (pr + 1j * pi) @ x0
            self.amplitudes = b[:, 0]
            return
        lam, w = eig_host(a_til)
        self.lambdas = lam
        mm = functools.partial(jnp.matmul, precision=PRECISION)
        self.modes_re = mm(proj, jnp.asarray(np.real(w), x.dtype))
        self.modes_im = mm(proj, jnp.asarray(np.imag(w), x.dtype))
        both = np.asarray(jnp.stack([self.modes_re, self.modes_im]))
        phi = both[0] + 1j * both[1]
        phi_pinv = _pinv_complex_np(phi)
        wfac = lam[:, None] * phi_pinv
        self._w_re = jnp.asarray(np.real(wfac), x.dtype)
        self._w_im = jnp.asarray(np.imag(wfac), x.dtype)
        self.amplitudes = (phi_pinv @ np.asarray(x[:, 0:1]))[:, 0]

    def eigs_continuous(self, dt: float = 1.0) -> np.ndarray:
        """Continuous-time eigenvalues log(lambda)/dt: real part = growth
        rate, imaginary part = angular frequency."""
        return np.log(self.lambdas.astype(np.complex128)) / float(dt)

    def predict_multiple(self, x_0, n_steps: int,
                         method: str = "modes") -> jnp.ndarray:
        """Roll x <- A x for ``n_steps`` from x_0 (n_x, 1); returns
        (n_x, n_steps), column j = state after j+1 steps.

        method='modes' (default): factored A = Re(Phi Lambda Phi^+),
        O(n_x r)/step. method='reduced': U_r A~ U_r^T rollout — no host
        eigendecomposition anywhere in its chain.
        """
        x0 = jnp.asarray(x_0)
        assert x0.shape == (self.n_x, 1)
        dummy = jnp.zeros((int(n_steps),), x0.dtype)
        if method == "reduced":
            mm = functools.partial(jnp.matmul, precision=PRECISION)

            def step(xc, _):
                xn = mm(self._u_r, mm(self._A, mm(self._u_r.T, xc)))
                return xn, xn[:, 0]

            _, xs = lax.scan(step, x0, dummy)
            return xs.T
        if method != "modes":
            raise ValueError(
                f"method must be 'modes' or 'reduced', got {method!r}"
            )
        return _rollout_plain(
            self.modes_re, self.modes_im, self._w_re, self._w_im, x0, dummy
        )

    def reconstruct(self, n_steps: int | None = None) -> jnp.ndarray:
        """Best-fit reconstruction of the training trajectory from the
        fitted spectrum: columns 1..n_steps regenerated from snapshot 0."""
        n = self.n_t - 1 if n_steps is None else int(n_steps)
        # training x0 is embedded in the amplitudes; rebuild from modes
        phi = np.asarray(self.modes_re) + 1j * np.asarray(self.modes_im)
        ks = np.arange(1, n + 1)
        lam_pow = self.lambdas[None, :] ** ks[:, None]      # (n, r)
        states = (lam_pow * self.amplitudes[None, :]) @ phi.T
        return jnp.asarray(np.real(states).T)
