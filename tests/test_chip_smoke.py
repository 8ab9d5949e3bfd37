"""chip_smoke.py refuses a host without a GPU: nonzero exit, no result."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("args", [["--n3", "4"], ["--four", "--n3", "4"]])
def test_exits_nonzero_without_gpu(args):
    r = _run(args, ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr


def test_exits_nonzero_without_the_package(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run([], tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
