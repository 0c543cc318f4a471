"""Executable-documentation guard: the backend-agnostic demo runs.

examples/demo_sysid.py is referenced from the docs; running it in a
subprocess (CPU-forced) keeps the documented API calls from rotting.
The benchmark examples are excluded — they target the GPU.
"""
import pathlib
import subprocess
import sys

_REPO = pathlib.Path(__file__).resolve().parent.parent


def test_demo_sysid_runs():
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        "jax.config.update('jax_enable_x64', True); "
        f"exec(open(r'{_REPO / 'examples' / 'demo_sysid.py'}').read())"
    )
    try:
        res = subprocess.run(
            [sys.executable, "-c", code], capture_output=True,
            text=True, timeout=900, cwd=str(_REPO),
        )
    except subprocess.TimeoutExpired as exc:  # cold-cache compiles can
        import pytest                          # dominate on a small host

        pytest.fail(
            "demo timed out (cold compile cache?); partial stdout:\n"
            + str(exc.stdout)[-2000:]
        )
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    assert "ERA/OKID identified poles" in out
    assert "spDMD Pareto front" in out
