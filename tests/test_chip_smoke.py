"""chip_smoke.py: its phases at a tiny size on the CPU, and its refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

PHASES = dict(chip_smoke.PHASES + [("four", chip_smoke.phase_four)])


@pytest.mark.parametrize("name", list(PHASES))
def test_phase_at_tiny_size(name, tmp_path):
    """Every phase runs end to end at TINY and passes its own checks (on
    the CPU its 'device' and reference runs coincide)."""
    res = PHASES[name](chip_smoke.TINY, str(tmp_path))
    assert res["ok"], res


def test_refuses_cpu(capsys):
    """No GPU: exit code 1 and an ok=false last line, never a CPU run."""
    assert chip_smoke.main([]) == 1
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["ok"] is False


def test_fails_without_the_repo(tmp_path):
    """Alone in a directory the script cannot import the package: it exits
    non-zero and prints no passing result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.fixture
def gpu():
    import jax
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run with -m gpu on the card)")
    return devs[0]


@pytest.mark.gpu
def test_reference_phase_on_gpu(gpu, tmp_path):
    """On the card: the small ini on the GPU matches the CPU run."""
    res = chip_smoke.phase_reference(chip_smoke.TINY, str(tmp_path))
    assert res["ok"], res
