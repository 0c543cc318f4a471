"""Checkpoint / resume for fitted model objects.

The reference keeps all fitted state in in-memory structs with no
persistence (SURVEY.md §5 "Checkpoint/resume: none"). Here every fitted
object is a flat bag of arrays + scalars, so (de)serialization is a single
``.npz``:

    save_model("pca.npz", pca)
    pca2 = load_model("pca.npz")

MCMC samplers are resumable by construction — a DeMcSampler/DreamSampler is
a pure function of (chain heads, key); persist ``sampler.chain_history`` and
re-seed chains from its tail.
"""
from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np

__all__ = [
    "save_model", "load_model", "register_model_class",
    "save_dream_state", "load_dream_state",
]

_REGISTRY: dict[str, type] = {}


def register_model_class(cls):
    """Register a class for checkpointing (used as a decorator or call)."""
    _REGISTRY[cls.__name__] = cls
    return cls


def _builtin_registry():
    # lazy import to avoid cycles
    from corrla_rs_tpu.models.active_subspaces import FittedActiveSsRsvd
    from corrla_rs_tpu.models.dmd import DMD, DMDc
    from corrla_rs_tpu.models.pca import PcaRsvd
    from corrla_rs_tpu.models.pod import PodI
    from corrla_rs_tpu.ops.copula import BivariateCopula, GaussianCopula
    from corrla_rs_tpu.ops.gp import GpRegressor, SparseGpRegressor
    from corrla_rs_tpu.ops.interp import RbfInterp
    from corrla_rs_tpu.ops.univariate_rv import (
        BetaRv,
        ExponentialRv,
        KdeRv,
        NormalRv,
    )
    from corrla_rs_tpu.models.edmd import Edmd  # noqa: F401 (decorator registers)
    from corrla_rs_tpu.models.kernel_dmd import KernelDmd  # noqa: F401
    from corrla_rs_tpu.models.bop_dmd import BaggedDmd
    from corrla_rs_tpu.ops.cca import Cca
    from corrla_rs_tpu.ops.pls import PlsRegressor
    from corrla_rs_tpu.models.hankel_dmd import HankelDmd
    from corrla_rs_tpu.models.mrdmd import MrDmd
    from corrla_rs_tpu.models.optdmd import BopDmd, OptDmd
    from corrla_rs_tpu.models.spod import Spod
    from corrla_rs_tpu.models.pidmd import PiDmd
    from corrla_rs_tpu.models.era import Era
    from corrla_rs_tpu.models.online_dmd import OnlineDmd
    from corrla_rs_tpu.models.sindy import Sindy  # noqa: F401 (decorator registers)
    from corrla_rs_tpu.models.opinf import OpInf  # noqa: F401
    from corrla_rs_tpu.ops.incremental import IncrementalPca, IncrementalSvd
    from corrla_rs_tpu.ops.rvine import RVineCopula
    from corrla_rs_tpu.ops.vine import CVineCopula

    for cls in (PcaRsvd, PodI, DMD, DMDc, RbfInterp, FittedActiveSsRsvd,
                NormalRv, BetaRv, ExponentialRv, KdeRv,
                GpRegressor, SparseGpRegressor, GaussianCopula,
                BivariateCopula, CVineCopula, RVineCopula,
                OnlineDmd, IncrementalSvd, IncrementalPca, BaggedDmd,
                Cca, PlsRegressor, HankelDmd, MrDmd, OptDmd, BopDmd,
                Spod, PiDmd, Era):
        _REGISTRY.setdefault(cls.__name__, cls)


def _coerce(v):
    """json default= hook: numpy scalar types -> python scalars."""
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    raise TypeError(f"not JSON-coercible: {type(v)}")


def save_model(path: str, model) -> None:
    """Serialize a fitted model's attributes to an .npz file.

    Round-trip coercions (JSON fallback for nested primitive structures):
    tuples come back as lists, and int-keyed dicts come back str-keyed.
    Every current consumer unpacks both identically; a future attribute
    whose semantics depend on tuple-ness or int keys needs its own
    explicit encoding here.
    """
    import jax.sharding

    arrays = {}
    scalars = {}
    for name, val in vars(model).items():
        if isinstance(val, jax.sharding.Mesh):
            # device meshes are machine-specific; persisted as None —
            # reattach (model._mesh = mesh) after load_model if refitting
            scalars[name] = None
        elif isinstance(val, (jnp.ndarray, np.ndarray)):
            arrays[f"arr_{name}"] = np.asarray(val)
        elif isinstance(val, (int, float, bool, str)) or val is None:
            scalars[name] = val
        elif isinstance(val, dict) and all(
            isinstance(v, (int, float, bool, str)) for v in val.values()
        ):
            scalars[name] = {"__dict__": val}
        elif isinstance(val, list) and all(
            isinstance(v, (jnp.ndarray, np.ndarray)) for v in val
        ):
            for i, v in enumerate(val):
                arrays[f"lst_{name}_{i}"] = np.asarray(v)
            scalars[f"__len_{name}"] = len(val)
        else:
            # nested primitive structure (e.g. CVineCopula.pairs — a list
            # of lists of (family, theta) tuples)? JSON round-trips it;
            # numpy scalars coerce via default=. Tuples come back as
            # lists, which every consumer unpacks identically.
            try:
                scalars[name] = {
                    "__json__": json.loads(json.dumps(val, default=_coerce))
                }
            except TypeError:
                # non-serializable state (e.g. ln_prob closures)
                raise TypeError(
                    f"cannot checkpoint attribute {name!r} of type "
                    f"{type(val)}"
                ) from None
    np.savez(
        path,
        __class__=np.asarray(type(model).__name__),
        __scalars__=np.asarray(json.dumps(scalars)),
        **arrays,
    )


def save_dream_state(path: str, state) -> None:
    """Persist a DreamState (ops.dream) — the resume unit for DREAM runs:
    heads, log-probs, PRNG key, adapted crossover probabilities, jump
    statistics and the generation counter all round-trip, so a reloaded
    state continues (or stays frozen) exactly where it left off via
    ``dream_run(..., init_state=state)``."""
    import jax

    fields = {f: np.asarray(v) for f, v in state._asdict().items()
              if f != "key"}
    fields["key_data"] = np.asarray(jax.random.key_data(state.key))
    np.savez(path, **fields)


def load_dream_state(path: str):
    """Reload a DreamState saved by ``save_dream_state``."""
    import jax

    from corrla_rs_tpu.ops.dream import DreamState

    data = np.load(path)
    key = jax.random.wrap_key_data(jnp.asarray(data["key_data"]))
    return DreamState(
        heads=jnp.asarray(data["heads"]),
        head_lnp=jnp.asarray(data["head_lnp"]),
        key=key,
        p_cr=jnp.asarray(data["p_cr"]),
        jump_dist=jnp.asarray(data["jump_dist"]),
        n_id=jnp.asarray(data["n_id"]),
        n_accept=jnp.asarray(data["n_accept"]),
        t=jnp.asarray(data["t"]),
    )


def load_model(path: str):
    """Reconstruct a model saved by ``save_model`` (no __init__ re-run)."""
    _builtin_registry()
    data = np.load(path, allow_pickle=False)
    cls_name = str(data["__class__"])
    cls = _REGISTRY.get(cls_name)
    if cls is None:
        raise KeyError(f"unknown model class {cls_name!r}; register it first")
    model = cls.__new__(cls)
    scalars = json.loads(str(data["__scalars__"]))
    lists: dict[str, int] = {}
    for name, val in scalars.items():
        if name.startswith("__len_"):
            lists[name[len("__len_"):]] = int(val)
        elif isinstance(val, dict) and "__dict__" in val:
            setattr(model, name, val["__dict__"])
        elif isinstance(val, dict) and "__json__" in val:
            setattr(model, name, val["__json__"])
        else:
            setattr(model, name, val)
    for key in data.files:
        if key.startswith("arr_"):
            val = data[key]
            # complex arrays stay host-side (DMDc.lambdas is deliberately
            # a host numpy array)
            setattr(
                model, key[4:],
                val if np.iscomplexobj(val) else jnp.asarray(val),
            )
    for name, ln in lists.items():
        setattr(
            model, name,
            [jnp.asarray(data[f"lst_{name}_{i}"]) for i in range(ln)],
        )
    return model
