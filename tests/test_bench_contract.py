"""bench.py emission contract, run in its CPU smoke mode.

``CORRLA_BENCH_SMOKE=1`` runs every phase at tiny shapes on the CPU: the
headline line comes first and last, every line has the same keys, and a
phase that raises makes the bench exit non-zero.
"""
import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
HEADLINE = "rsvd_100kx10k_f32_rank100_wall"
KEYS = {"metric", "value", "unit", "vs_baseline", "baseline"}


def _run(code: str):
    env = dict(os.environ, CORRLA_BENCH_SMOKE="1", JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=600, env=env, cwd=str(REPO),
    )


def _json_lines(stdout: str):
    return [json.loads(s) for s in stdout.splitlines() if s.startswith("{")]


def test_smoke_headline_first_and_last():
    proc = _run("import bench, sys; sys.exit(bench.main())")
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = _json_lines(proc.stdout)
    assert len(lines) == 6, proc.stdout
    assert lines[0]["metric"] == lines[-1]["metric"] == HEADLINE
    assert lines[0] == lines[-1]
    for ln in lines:
        assert set(ln) == KEYS
        assert ln["value"] > 0


def test_phase_error_exits_nonzero():
    code = (
        "import bench, sys\n"
        "def broken():\n"
        "    raise RuntimeError('phase failed on purpose')\n"
        "bench.PHASES.insert(0, broken)\n"
        "sys.exit(bench.main())\n"
    )
    proc = _run(code)
    assert proc.returncode != 0
    assert "phase failed on purpose" in proc.stderr
    # the headline printed once, and was not repeated as a last line
    assert [ln["metric"] for ln in _json_lines(proc.stdout)] == [HEADLINE]
