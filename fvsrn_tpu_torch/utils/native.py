"""Build the port's host libraries (``native/*.cpp``) with ``g++``.

Each library is compiled on first use into
``build/fvsrn_tpu_torch/<name>-<hash>.so`` at the repository root, keyed
by a hash of the flags and the source, and written to a temporary file
first and moved into place, so processes that build at once each find a
whole library. A failed build raises with the compiler's output: nothing
falls back.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(PKG_DIR, "native")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "fvsrn_tpu_torch")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


def source_path(name: str) -> str:
    return os.path.join(NATIVE_DIR, f"{name}.cpp")


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(source_path(name), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``native/<name>.cpp`` unless it is built already; returns
    the library's path."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    src = source_path(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {src} failed (g++ exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out
