"""``python -m repro_torch.dev``: the usage error and the sharded smoke on
the CPU (``verify`` itself is not run here: it runs this test suite)."""

import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _dev(*args, timeout=120, env=None):
    env = {**os.environ, **(env or {})}
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "repro_torch.dev", *args],
                          capture_output=True, text=True, env=env,
                          timeout=timeout)


@pytest.mark.parametrize("args", [(), ("bench",)])
def test_usage_error_exits_2(args):
    out = _dev(*args)
    assert out.returncode == 2
    assert "usage: python -m repro_torch.dev" in out.stderr
    assert "sharded-smoke" in out.stderr


def test_sharded_smoke_on_the_cpu():
    out = _dev("sharded-smoke", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "sharded 2-shard smoke: OK (mesh ['cpu', 'cpu']" in out.stdout
    assert "bit-identical" in out.stdout


def test_sharded_smoke_raises_without_a_card_unless_asked_for_the_cpu():
    """``--device cuda`` is the default and has no CPU fallback."""
    env = {"CUDA_VISIBLE_DEVICES": ""}
    out = _dev("sharded-smoke", env=env)
    assert out.returncode != 0
    assert "OK" not in out.stdout
    assert "torch.cuda.is_available() is False" in out.stderr
