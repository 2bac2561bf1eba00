"""Build the port's CUDA sources with ``nvcc`` at first use.

Every ``paddle_tpu_torch/csrc/<name>.cu`` compiles into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), under ``build/paddle_tpu_torch/`` next to the package, and is
loaded with ``ctypes``. A library is rebuilt only when the content hash
of its source and the compiler flags changes. Nothing is prebuilt and
nothing is downloaded: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"

#: sm_90a keeps Hopper-only instructions (wgmma, setmaxnreg) available
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, spills, shared memory) of the last build
build_logs: Dict[str, str] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (CUDA toolkit missing): the port's "
                       "kernels build from source and cannot run without it")


def sources() -> Sequence[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(stem: str) -> Path:
    src = CSRC / f"{stem}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build_all(stems: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Compile every stale source, one ``nvcc`` per source, all started
    together. Returns ``{stem: seconds}`` (0.0 for an up-to-date
    library). Raises ``RuntimeError`` with the compiler output on
    failure. ``build_logs`` gets each stem's compiler output, kept beside
    its library so an up-to-date library still has it."""
    stems = list(stems or sources())
    todo = {s: library_path(s) for s in stems if not library_path(s).exists()}
    out = {s: 0.0 for s in stems}
    for stem in set(stems) - set(todo):
        saved = library_path(stem).with_suffix(".log")
        if saved.is_file():
            build_logs[stem] = saved.read_text()
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.monotonic()
    for stem, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for stem, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        out[stem] = time.monotonic() - t0
        build_logs[stem] = log
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            target.with_suffix(".log").write_text(log)
            os.replace(tmp, target)      # atomic against a concurrent build
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(stem: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<stem>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            build_all([stem])
            lib = _libs[stem] = ctypes.CDLL(str(library_path(stem)))
        return lib


_bound: Dict[str, Callable] = {}


def bind(stem: str, name: str, argtypes) -> Callable:
    """The C function ``name`` of ``csrc/<stem>.cu`` with its ctypes
    signature (``argtypes``, an ``int`` result), built, loaded and bound
    on first use and kept, so a launch pays none of that again."""
    fn = _bound.get(name)
    if fn is None:
        fn = getattr(load(stem), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return fn


def launch(fn: Callable, device, *args) -> int:
    """Call a bound kernel entry with ``args`` and the raw handle of
    ``device``'s current stream; returns its ``cudaError_t``. The entry
    launches on the calling thread's current device, so a tensor on
    another card switches to it for the call."""
    import torch
    idx = device.index
    if idx == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(device):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
