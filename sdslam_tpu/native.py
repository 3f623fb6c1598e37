"""The optional C extension (native/*.c), built from source at first use.

`load()` returns the extension module, or None when it cannot be built (no
C compiler or libpng headers, or an installed package without the native/
sources); every caller has a pure-Python fallback. The shared library is
written to build/native/ inside the checkout (listed in .gitignore), under
a file lock so that concurrent processes (pytest-xdist workers) build it
once. To build it ahead of time:

    python -m sdslam_tpu.native
"""

from __future__ import annotations

import fcntl
import importlib.util
import os
import subprocess
import sysconfig
from pathlib import Path
from typing import Optional

_ROOT = Path(__file__).resolve().parents[1]
_SOURCES = (_ROOT / "native" / "native.c", _ROOT / "native" / "loader.c")
BUILD_DIR = _ROOT / "build" / "native"

_module = None
_tried = False


def build() -> Path:
    """Compile the extension if it is missing or older than its sources."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / ("_native" + sysconfig.get_config_var("EXT_SUFFIX"))
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        newest = max(p.stat().st_mtime for p in _SOURCES)
        if not target.exists() or target.stat().st_mtime < newest:
            tmp = target.with_name(f".{target.name}.{os.getpid()}")
            subprocess.run(
                [os.environ.get("CC", "cc"), "-O3", "-std=c11", "-shared",
                 "-fPIC", "-I" + sysconfig.get_paths()["include"],
                 *map(str, _SOURCES), "-lpng", "-lpthread", "-o", str(tmp)],
                check=True, capture_output=True,
            )
            os.replace(tmp, target)
    return target


def load() -> Optional[object]:
    """The extension module, built on first use; None if unavailable."""
    global _module, _tried
    if not _tried:
        _tried = True
        try:
            path = build()
            spec = importlib.util.spec_from_file_location(
                "sdslam_tpu._native", path
            )
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _module = mod
        except (OSError, subprocess.CalledProcessError, ImportError):
            _module = None
    return _module


if __name__ == "__main__":
    print(build())
