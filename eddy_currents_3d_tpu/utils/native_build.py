"""Build-and-load for the native helper libraries (native/*.cpp).

A library is named after a hash of its source, ``_lib<stem>.<sha16>.so``
next to the module that loads it, so a library built from an older source
is never picked up: an edited ``.cpp`` gets a new name and is rebuilt on
first use.  The build writes a temporary file and renames it into place,
so concurrent first uses do not load a half-written library."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

__all__ = ["NATIVE_DIR", "lib_path", "load"]

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")


def lib_path(src: str, out_dir: str, stem: str) -> str:
    """The library file for the current contents of ``src``."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(out_dir, f"_lib{stem}.{digest}.so")


def load(src_name: str, out_dir: str, stem: str) -> Optional[ctypes.CDLL]:
    """The library built from ``native/<src_name>``, building it first if
    no library of this source exists.  None when the source or a compiler
    is missing, or the build fails (callers fall back to numpy)."""
    src = os.path.join(NATIVE_DIR, src_name)
    if not os.path.exists(src):
        return None
    path = lib_path(src, out_dir, stem)
    if not os.path.exists(path):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            subprocess.run(
                ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
                 "-o", tmp, src],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, path)
        except (OSError, subprocess.SubprocessError):
            return None
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None
