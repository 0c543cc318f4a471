"""chip_smoke.py on the CPU: it refuses to pass without a GPU, its float64
references are right, and every phase's checks hold at tiny sizes."""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        timeout=300, env=env, cwd=str(REPO),
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "[rsvd]" not in proc.stdout  # no phase ran


def test_rsvd_reference_matches_numpy_svd(rng):
    # with a sketch as wide as the matrix the range finder is exact, so the
    # float64 reference must reproduce LAPACK's singular values
    a = rng.standard_normal((2000, 300)).astype(np.float32)
    omega = rng.standard_normal((300, 300)).astype(np.float32)
    s = chip_smoke.rsvd_reference_f64(a, omega, 2)
    want = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    np.testing.assert_allclose(s, want, rtol=1e-10)


@pytest.mark.parametrize("phase", sorted(chip_smoke.PHASES))
def test_phase_passes_on_cpu_at_tiny_size(phase):
    chip_smoke.PHASES[phase](chip_smoke.TINY, "cpu")


@pytest.mark.parametrize("phase", sorted(chip_smoke.SHARDED_PHASES))
def test_sharded_phase_on_four_virtual_devices(phase):
    assert len(jax.devices()) >= 4
    chip_smoke.SHARDED_PHASES[phase](chip_smoke.TINY, "cpu", n_dev=4)


def test_check_raises_on_wrong_platform():
    out = jnp.zeros(3)
    with pytest.raises(chip_smoke.SmokeFailure, match="expected gpu"):
        chip_smoke.check("t", "n", 0.0, 1.0, "r", out, (0.0, 0.0), "gpu")
    with pytest.raises(chip_smoke.SmokeFailure, match="error"):
        chip_smoke.check("t", "n", 2.0, 1.0, "r", out, (0.0, 0.0), "cpu")
