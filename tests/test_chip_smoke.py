"""chip_smoke.py and bench.py refuse to run without a GPU: a non-zero
exit and no result line, on this CPU-only backend and in a directory
that holds the script and nothing else of the repository."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_require_gpu_refuses_cpu():
    sys.path.insert(0, REPO)
    import chip_smoke

    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu()
    assert e.value.code != 0


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_exits_nonzero_on_cpu(script):
    out = _run(os.path.join(REPO, script), REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout and '"value"' not in out.stdout


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run("chip_smoke.py", str(tmp_path))
    assert out.returncode != 0 and '"ok": true' not in out.stdout
