"""chip_smoke.py and the compile-cache helper, off the card.

chip_smoke.py must refuse to report a result without a CUDA device, and
without the rest of the repository beside it."""

import os
import shutil
import subprocess
import sys

import pytest

from sdslam_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("alone", [False, True], ids=["cpu", "script-alone"])
def test_chip_smoke_fails_without_card(tmp_path, alone):
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(script)], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0, proc.stdout
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    monkeypatch.delenv("SDSLAM_JAX_CACHE", raising=False)
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert compile_cache.cache_dir() == want
    # the fixed default sits inside the checkout, where .gitignore lists it
    assert compile_cache.DEFAULT_DIR.parent == compile_cache.CHECKOUT
    monkeypatch.setenv("SDSLAM_JAX_CACHE", "0")
    assert compile_cache.cache_dir() is None
    assert compile_cache.enable() is None
