"""GPU-only entry points refuse the CPU, and the persistent compile cache
goes where JAX_COMPILATION_CACHE_DIR says or to the checkout's fixed
path."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(args, cwd, env_extra=None, drop=()):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO)
    for k in drop:
        env.pop(k, None)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=240,
    )


def _printed_result(stdout: str) -> bool:
    return '"ok"' in stdout


def test_chip_smoke_fails_without_gpu():
    res = _run(["chip_smoke.py"], cwd=REPO)
    assert res.returncode != 0
    assert not _printed_result(res.stdout)
    assert "no GPU" in res.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert res.returncode != 0
    assert not _printed_result(res.stdout)


@pytest.mark.parametrize("script", ["bench.py", "tools/solve_paths.py"])
def test_measurement_scripts_fail_without_gpu(script):
    res = _run([script], cwd=REPO)
    assert res.returncode != 0
    assert "no GPU" in res.stderr
    assert not res.stdout.strip()  # no result line


_PRINT_CACHE = (
    "import jax, tpu_amg; "
    "print(jax.config.jax_compilation_cache_dir)"
)


def test_compile_cache_honours_env(tmp_path):
    res = _run(["-c", _PRINT_CACHE], cwd=tmp_path,
               env_extra={"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == str(tmp_path)


def test_compile_cache_defaults_to_checkout(tmp_path):
    from tpu_amg.utils.platform import CACHE_DIR

    res = _run(["-c", _PRINT_CACHE], cwd=tmp_path,
               drop=("JAX_COMPILATION_CACHE_DIR",))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == str(CACHE_DIR)
    assert CACHE_DIR == REPO / ".jax_cache"
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_require_gpu_rejects_cpu():
    from tpu_amg.utils.platform import require_gpu

    with pytest.raises(SystemExit, match="no GPU"):
        require_gpu()


@pytest.mark.parametrize(
    "smi, card",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W\n",
         "NVIDIA H100 80GB HBM3, 700.00 W"),
        ("H100, 400.00 W\n" * 4, "H100, 400.00 W x 4"),
        ("H100, 400.00 W\nH100, 700.00 W\n",
         "H100, 400.00 W; H100, 700.00 W"),
    ],
    ids=["one", "four_same", "mixed"],
)
def test_card_line(smi, card, monkeypatch):
    """One card prints as nvidia-smi gives it; several stay on one line."""
    from unittest import mock

    from tpu_amg.utils import platform

    monkeypatch.setattr(
        platform.subprocess, "run",
        lambda *a, **k: mock.Mock(stdout=smi),
    )
    assert platform.gpu_name_and_power_limit() == card
