"""chip_smoke.py's refusals: it runs on a GPU or not at all."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _no_json_result(stdout):
    for line in stdout.strip().splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(obj, dict) and obj.get("ok")), line


def test_device_check_refuses_cpu():
    cs = _load()
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(cs.SmokeFailure, match="no GPU"):
        cs.require_gpu(jax)


def test_script_exits_nonzero_on_cpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    _no_json_result(out.stdout)


def test_script_alone_exits_nonzero(tmp_path):
    """Without the package beside it the script fails and prints no
    result (whatever the device)."""
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    _no_json_result(out.stdout)
