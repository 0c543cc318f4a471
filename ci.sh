#!/usr/bin/env bash
# CI entry point: both CPU test lanes + the multi-device dry run.
#
# Lane layout (pyproject.toml addopts deselect `slow` and `gpu`):
#   default lane  — one representative per family
#   slow lane     — the exhaustive grids (full rotated vine families,
#                   the reference's 7-case Beta matrix, statistical
#                   sweeps), opt-in via -m slow
# Tests marked `gpu` need a card and skip without one; on a GPU host run
# `python -m pytest tests/ -m gpu` and `python chip_smoke.py`.
set -euo pipefail
cd "$(dirname "$0")"

echo "== default lane =="
JAX_PLATFORMS=cpu python -m pytest tests/ -q

echo "== slow lane =="
JAX_PLATFORMS=cpu python -m pytest tests/ -q -m "slow and not gpu"

echo "== multi-device dryrun (8 virtual CPU devices) =="
JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python -c "import __graft_entry__ as g; g.dryrun_multichip(8)"

echo "CI GREEN"
