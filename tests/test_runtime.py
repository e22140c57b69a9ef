"""Per-platform choices (graph_framework_tpu/runtime.py) and the
chip_smoke.py contract off the card."""

import os
import pathlib
import subprocess
import sys

import pytest

from graph_framework_tpu import runtime

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("platform,interpret", [("cpu", True),
                                                ("gpu", False)])
def test_kernels_compile_on_gpu_and_interpret_on_cpu(platform, interpret):
    assert runtime.interpret_kernels(platform) is interpret


def test_kernels_refuse_other_platforms():
    with pytest.raises(RuntimeError, match="no Pallas kernel route"):
        runtime.interpret_kernels("metal")


def test_production_stack_is_the_gpu_default():
    assert runtime.production_platform("gpu")
    assert not runtime.production_platform("cpu")


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compile_cache_dir() == str(tmp_path)


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert runtime.compile_cache_dir() == str(REPO / ".jax_cache")


def test_chip_smoke_refuses_the_cpu(tmp_path):
    """Without a GPU the smoke script exits non-zero and prints no
    result - in the checkout, and as a lone file outside it."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (lone, tmp_path)):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_chip_smoke_checks_survive_python_O():
    """Every check of the smoke script raises through ``check``; a bare
    ``assert`` would vanish under ``python -O`` and let a failed phase
    print its result."""
    import ast
    import chip_smoke

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    assert not [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Assert)]
    chip_smoke.check(True, "holds")
    with pytest.raises(RuntimeError, match="check failed: broken"):
        chip_smoke.check(False, "broken")
