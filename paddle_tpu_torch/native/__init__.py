"""Native (C++) host components of the port, built on first use with g++
(``paddle_tpu/native/__init__.py``).

``kv_store.cc`` (the sharded host KV table with its sparse optimizers)
and ``kv_server.cc`` (its TCP pserver) are this package's own copies of
the reference's sources, byte for byte, so that both packages compute the
same rows from the same seed and read each other's files and wire. Each
library compiles with the local ``g++`` into ``build/paddle_tpu_torch/
native/`` next to the package (``build/`` is not committed), named by a
hash of its sources and flags as the CUDA kernels' libraries are
(:func:`paddle_tpu_torch.kernels.build.library_path`): a changed source
or flag builds a new library, an unchanged one is loaded as it is.

The native runner (``aoti_runner.cc`` with ``ptt_ops.cc``, :mod:`.runner`)
is an executable linked against the installed PyTorch's libtorch: the
same build with ``executable=True`` and the include and library flags of
:func:`.runner.torch_flags`.

A build writes a temporary file and renames it into place, so processes
that build the same library at once (test workers) never load a
half-written one. Libraries load with ctypes' default ``RTLD_LOCAL``: a
process that also loads the reference's libraries, which export the
same C symbols, resolves each library's calls to its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parents[1] / "build" / "paddle_tpu_torch" / "native"
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
#: an executable's flags (the runner: libtorch's headers want C++20)
EXE_FLAGS = ("-O2", "-std=c++20", "-pthread")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def source_paths(sources: Sequence[str]) -> list:
    """The files a library builds from: every one inside this package."""
    return [_DIR / s for s in sources]


def library_path(name: str, sources: Sequence[str],
                 extra_flags: Sequence[str] = (),
                 executable: bool = False,
                 headers: Sequence[str] = ()) -> Path:
    """Where ``lib<name>`` (or the executable ``<name>``) built from
    ``sources`` with these flags lives. The hash covers the sources, the
    ``headers`` of this package they include, and the flags."""
    h = hashlib.sha256()
    for src in source_paths(sources) + source_paths(headers):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    flags = EXE_FLAGS if executable else FLAGS
    h.update(" ".join((*flags, *extra_flags)).encode())
    if executable:
        return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}"
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_library(name: str, sources: Sequence[str],
                  extra_flags: Sequence[str] = (),
                  executable: bool = False,
                  headers: Sequence[str] = ()) -> str:
    """Compile ``sources`` (names of files in this package) into a shared
    library, or with ``executable=True`` an executable, unless it is
    built already; returns its path. ``headers`` names the package's
    headers the sources include, so that a changed one rebuilds."""
    out = library_path(name, sources, extra_flags, executable, headers)
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(
        f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    flags = EXE_FLAGS if executable else FLAGS
    cmd = ["g++", *flags, *(str(p) for p in source_paths(sources)),
           *extra_flags, "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed: {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return str(out)


def load_library(name: str, sources: Sequence[str],
                 extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library (built on first use), kept for the process."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(
                build_library(name, sources, extra_flags))
        return _libs[name]
