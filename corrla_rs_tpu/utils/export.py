"""Serialized compiled-model artifacts for serving (extension).

Production deployments want to ship a *compiled artifact*, not a Python
library: ``jax.export`` lowers a jitted function to versioned StableHLO
that a fresh process (or a different serving binary) deserializes and
calls without this package installed. The reference has no serving story
at all (in-memory structs only, SURVEY.md §5).

- ``export_fn(fn, example_args, path)``: jit + lower + serialize to a
  file. Shapes/dtypes are pinned to the example arguments (XLA semantics:
  one artifact per signature).
- ``load_exported(path)``: deserialize; returns a callable.
- ``export_model_call(model, method, example_args, path)``: convenience
  for fitted-model methods — closes the model's arrays into the artifact
  as constants, so the file is self-contained (e.g. a PCA transform or a
  DMDc rollout ships as one .stablehlo blob).

Artifacts record the lowering platform; export on the platform you serve
on (a CPU-exported artifact will not run on the GPU and vice versa — jax
raises a clear error).
"""
from __future__ import annotations

import jax

__all__ = ["export_fn", "load_exported", "export_model_call"]


def export_fn(fn, example_args, path: str):
    """Serialize ``jit(fn)`` at the example arguments' signature to
    ``path``. Returns the in-memory exported object."""
    exp = jax.export.export(jax.jit(fn))(*example_args)
    with open(path, "wb") as f:
        f.write(exp.serialize())
    return exp


def load_exported(path: str):
    """Deserialize an artifact written by ``export_fn``; returns a
    callable (``jax.export.Exported.call``)."""
    with open(path, "rb") as f:
        exp = jax.export.deserialize(f.read())
    return exp.call


def export_model_call(model, method: str, example_args, path: str):
    """Export ``model.<method>(*example_args)`` as a self-contained
    artifact: the fitted arrays become constants inside the program, so
    the serving side needs only jax (not corrla_rs_tpu, not the model
    object)."""
    bound = getattr(model, method)

    def call(*args):
        return bound(*args)

    return export_fn(call, example_args, path)
