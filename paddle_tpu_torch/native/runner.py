"""The native runner of frozen programs (the reference's
``paddle_tpu/native/pjrt.py``, whose ``NativePredictor`` binds
``pjrt_runner.cc``).

``save_inference_model(..., freeze_native=True)`` compiles the exported
program ahead of time with AOTInductor into ``__model__frozen__.pt2``.
``aoti_runner.cc`` serves that package from C++: a C ABI over
``torch::inductor::AOTIModelPackageLoader`` and a main that answers
requests over two pipes, so no Python runs in the serving process;
outputs come back through a shared memory file (``os.memfd_create``)
that the runner fills straight from the device. The
program's flash attention is the op ``ptt::flash_fwd``, registered in
that process by ``ptt_ops.cc``: on the card it launches K5 from the
library :mod:`paddle_tpu_torch.kernels.build` builds with nvcc (the same
compiled kernel the Python op launches) and counts each launch.

The runner is one executable, built with g++ at first use against the
installed PyTorch's libtorch (:func:`torch_flags`) into
``build/paddle_tpu_torch/native/``, named by a hash of its sources and
flags (:func:`paddle_tpu_torch.native.build_library`). Where the
installed PyTorch has no AOTInductor loader header, or g++ fails, the
build raises: nothing serves through the Python ``Predictor`` instead.

:class:`NativePredictor` starts the runner on a model directory and
hands it numpy arrays; :func:`flash_fwd_files` runs the C++ op once in a
runner process on tensors passed as files (the Python op and the C++ op
are one name, so the two never share a process); :func:`runner_schema`
is the C++ op's schema as the runner's dispatcher holds it.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from paddle_tpu_torch import native
from paddle_tpu_torch.inference import FROZEN_FILE

SOURCES = ("aoti_runner.cc", "ptt_ops.cc")
HEADERS = ("ptt_ops.h",)
_LOADER_HEADER = ("torch", "csrc", "inductor", "aoti_package",
                  "model_package_loader.h")
#: reply frame: int32 code, int64 payload length
_HEAD = struct.Struct("=iq")
#: a run's reply payload starts with: K5 launches, device us, copy-out us
_RUN_HEAD = struct.Struct("=qqq")
_NUMPY = {"float32": np.float32, "float64": np.float64,
          "float16": np.float16, "int64": np.int64, "int32": np.int32,
          "int16": np.int16, "int8": np.int8, "uint8": np.uint8,
          "bool": np.bool_}


def _missing(what: str) -> RuntimeError:
    return RuntimeError(
        f"native runner (the C++ runner over AOTInductor, ROADMAP Queue 1 "
        f"item 2): {what}")


def torch_flags() -> List[str]:
    """g++ flags that compile and link against the installed PyTorch:
    its include and library paths (``torch.utils.cpp_extension``), its
    C++ ABI, an rpath to its libraries, ``-ltorch -ltorch_cpu -lc10`` and,
    where PyTorch has CUDA, ``-ltorch_cuda -lc10_cuda`` (linked even
    though no symbol of theirs is named: they register the CUDA
    kernels)."""
    import torch
    from torch.utils import cpp_extension
    includes = cpp_extension.include_paths()
    if not any(Path(d, *_LOADER_HEADER).is_file() for d in includes):
        raise _missing(f"PyTorch {torch.__version__} ships no "
                       f"{'/'.join(_LOADER_HEADER)} (AOTInductor's package "
                       "loader)")
    libs = cpp_extension.library_paths()
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    flags = [f"-I{d}" for d in includes]
    flags += [f"-D_GLIBCXX_USE_CXX11_ABI={abi}"]
    flags += [f"-L{d}" for d in libs] + [f"-Wl,-rpath,{d}" for d in libs]
    flags += ["-Wl,--no-as-needed", "-ltorch", "-ltorch_cpu", "-lc10"]
    if torch.version.cuda:
        flags += ["-ltorch_cuda", "-lc10_cuda"]
    return flags + ["-Wl,--as-needed", "-ldl"]


def build_runner() -> str:
    """Path of the runner executable, built on first use."""
    try:
        return native.build_library("aoti_runner", SOURCES, torch_flags(),
                                     executable=True, headers=HEADERS)
    except (RuntimeError, OSError) as err:
        raise _missing(f"the build failed: {err}") from err


def _flash_library(device: str) -> List[str]:
    """``--flash-lib PATH`` for a card's program: K5's library, built by
    nvcc at first use."""
    if not device.startswith("cuda"):
        return []
    from paddle_tpu_torch.kernels import build
    build.build_all(["flash_attention"])
    return ["--flash-lib", str(build.library_path("flash_attention"))]


def _to_numpy(raw, spec) -> np.ndarray:
    """A copy of an output's bytes as an array; bfloat16 widens to float32
    (exact; numpy has no bfloat16)."""
    import torch
    if spec["dtype"] == "bfloat16":
        return torch.frombuffer(raw, dtype=torch.bfloat16).float().reshape(
            spec["shape"]).numpy()
    return np.frombuffer(raw, _NUMPY[spec["dtype"]]).reshape(
        spec["shape"]).copy()


def _input_bytes(x, spec, name) -> bytes:
    """``x`` (a numpy array or a tensor) as the bytes of ``spec``'s dtype
    and shape; raises on another shape, or on a dtype that does not
    convert exactly (floats to floats, integers to integers)."""
    import torch
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    if list(t.shape) != list(spec["shape"]):
        raise ValueError(f"input {name!r} must be {spec['shape']}, got "
                         f"{list(t.shape)}")
    want = getattr(torch, spec["dtype"])
    if t.dtype.is_floating_point != want.is_floating_point:
        raise TypeError(f"input {name!r} must be {spec['dtype']}, got "
                        f"{t.dtype}")
    t = t.detach().to("cpu", want).contiguous()
    return t.view(torch.uint8).numpy().tobytes() if t.numel() else b""


class NativePredictor:
    """A frozen package served by the C++ runner in its own process.

    ``NativePredictor(model_dir)`` builds the runner if needed and starts
    it on ``model_dir`` (``__model__frozen__.pt2`` and ``meta.json``); a
    card's package also builds K5's library and hands the runner its
    path. A missing package, a card's package without CUDA, or a package
    the runner cannot load raises ``RuntimeError`` with the runner's
    error. ``run(*inputs)`` takes numpy arrays (or host tensors) in
    ``meta.json``'s shapes and returns the outputs as numpy arrays
    (bfloat16 widened to float32). ``device`` is the device the runner
    serves on; after each run, ``last_call`` holds the runner's K5 launch
    count and its device and copy-out microseconds. ``close()`` (or
    ``__del__``) ends the process."""

    def __init__(self, model_dir: str):
        import torch
        self._proc = None
        self.model_dir = str(model_dir)
        with open(os.path.join(self.model_dir, "meta.json")) as f:
            self.meta = json.load(f)
        if not os.path.isfile(os.path.join(self.model_dir, FROZEN_FILE)):
            raise RuntimeError(f"{self.model_dir} holds no {FROZEN_FILE}: "
                               "export with freeze_native=True")
        device = self.meta.get("device", "cpu")
        if device.startswith("cuda") and not torch.cuda.is_available():
            raise RuntimeError(
                f"{self.model_dir} was frozen for {device}, and no CUDA "
                "device is available here: the runner serves a package on "
                "the device it was compiled for")
        self.input_names = self.meta["input_names"]
        self.input_specs = self.meta["inputs"]
        self.output_specs = self.meta["outputs"]
        self.last_call: Dict[str, int] = {}
        exe = build_runner()
        self._sizes = [int(np.prod(s["shape"], dtype=np.int64))
                       * _itemsize(s["dtype"]) for s in self.output_specs]
        cmd_r, self._cmd = os.pipe()
        self._reply, reply_w = os.pipe()
        self._shm_fd = os.memfd_create("aoti_runner_outputs")
        os.ftruncate(self._shm_fd, sum(self._sizes))
        self._shm = (mmap.mmap(self._shm_fd, sum(self._sizes))
                     if sum(self._sizes) else None)
        self._stderr = tempfile.TemporaryFile()
        try:
            self._proc = subprocess.Popen(
                [exe, "serve", self.model_dir, str(cmd_r), str(reply_w),
                 str(self._shm_fd), *_flash_library(device)],
                pass_fds=(cmd_r, reply_w, self._shm_fd),
                stdin=subprocess.DEVNULL, stdout=self._stderr,
                stderr=self._stderr)
        finally:
            os.close(cmd_r)
            os.close(reply_w)
        code, text = self._reply_frame()
        if code != 0:
            self.close()
            raise RuntimeError(f"the native runner could not load "
                               f"{self.model_dir}: {text.decode()}")
        n_in, n_out, self.device = text.decode().split()
        if (int(n_in), int(n_out)) != (len(self.input_specs),
                                       len(self.output_specs)):
            self.close()
            raise RuntimeError(f"runner reports {n_in} inputs and {n_out} "
                               "outputs, meta.json lists "
                               f"{len(self.input_specs)} and "
                               f"{len(self.output_specs)}")

    def _read(self, n: int) -> bytearray:
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            k = os.readv(self._reply, [view[got:]])
            if k == 0:
                raise RuntimeError("the native runner exited: "
                                   + self._runner_stderr())
            got += k
        return buf

    def _runner_stderr(self) -> str:
        if self._proc is not None:
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass
        self._stderr.seek(0)
        return self._stderr.read().decode(errors="replace")[-4000:]

    def _reply_frame(self):
        code, length = _HEAD.unpack(self._read(_HEAD.size))
        return code, self._read(length)

    def _send(self, code: int, payload: bytes = b""):
        data = _HEAD.pack(code, len(payload)) + payload
        view = memoryview(data)
        while view:
            view = view[os.write(self._cmd, view):]

    def run(self, *inputs) -> List[np.ndarray]:
        """Run the package once; returns the outputs in order."""
        if self._proc is None:
            raise RuntimeError("NativePredictor is closed")
        if len(inputs) != len(self.input_specs):
            raise ValueError(f"expected {len(self.input_specs)} inputs "
                             f"{self.input_names}, got {len(inputs)}")
        payload = b"".join(_input_bytes(x, s, n) for x, s, n in zip(
            inputs, self.input_specs, self.input_names))
        self._send(1, payload)
        code, body = self._reply_frame()
        if code != 0:
            raise RuntimeError(f"native runner: {body.decode()}")
        launches, device_us, copy_us = _RUN_HEAD.unpack_from(body)
        self.last_call = {"k5_launches_total": launches,
                          "device_us": device_us, "copy_us": copy_us}
        outs, off = [], 0
        view = memoryview(self._shm) if self._shm is not None else b""
        for spec, n in zip(self.output_specs, self._sizes):
            outs.append(_to_numpy(view[off:off + n], spec))
            off += n
        return outs

    def close(self):
        """End the runner process and release its pipes and buffer."""
        proc, self._proc = self._proc, None
        if proc is not None:
            try:
                self._send(0)
            except OSError:
                pass
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        shm, self._shm = getattr(self, "_shm", None), None
        if shm is not None:
            shm.close()
        for name in ("_cmd", "_reply", "_shm_fd"):
            fd = getattr(self, name, None)
            setattr(self, name, None)
            if fd is not None:
                os.close(fd)
        stderr, self._stderr = getattr(self, "_stderr", None), None
        if stderr is not None:
            stderr.close()

    def __del__(self):
        try:
            self.close()
        except Exception:   # noqa: BLE001 - interpreter shutdown
            pass


def _itemsize(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else np.dtype(_NUMPY[dtype]).itemsize


def _write_tensor(d: Path, name: str, t) -> str:
    import torch
    t = t.detach().cpu().contiguous()
    (d / f"{name}.bin").write_bytes(
        t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
    dtype = str(t.dtype).replace("torch.", "")
    return " ".join([name, dtype, str(t.dim()), *map(str, t.shape)])


def flash_fwd_files(q, k, v, bias=None, *, causal: bool = False,
                    scale: Optional[float] = None, device="cuda",
                    workdir: Optional[str] = None, reps: int = 0) -> Dict:
    """``ptt::flash_fwd`` as the runner registers it, run once in a runner
    process on ``device`` (the card unless the caller asks for the CPU):
    the tensors go in as files and ``(out, lse)`` come back as CPU
    tensors, with the runner's K5 launches (``{"out", "lse", "launches"}``). ``reps > 0`` also times
    that many calls back to back in the runner (``"ms"``: the mean, host
    clock from the first call to the device's end of the last)."""
    import torch
    from paddle_tpu_torch.core.device import resolve_device
    device = str(resolve_device(device))
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        d = Path(tmp)
        lines = [_write_tensor(d, n, t) for n, t in
                 (("q", q), ("k", k), ("v", v), ("bias", bias))
                 if t is not None]
        lines += [f"causal {int(bool(causal))}",
                  f"scale {'none' if scale is None else repr(float(scale))}"]
        (d / "args.txt").write_text("\n".join(lines) + "\n")
        res = subprocess.run([build_runner(), "flash_fwd", str(d), device,
                              *([str(reps)] if reps else []),
                              *_flash_library(device)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"runner flash_fwd failed: {res.stderr}")
        out = torch.frombuffer(bytearray((d / "out.bin").read_bytes()),
                               dtype=q.dtype).reshape(q.shape)
        lse = torch.frombuffer(bytearray((d / "lse.bin").read_bytes()),
                               dtype=torch.float32).reshape(q.shape[:3])
        said = dict(line.split() for line in res.stdout.splitlines())
    return {"out": out, "lse": lse, "launches": int(said["launches"]),
            **({"ms": float(said["ms"])} if reps else {})}


def runner_schema() -> str:
    """``ptt::flash_fwd``'s schema as the runner's dispatcher holds it."""
    res = subprocess.run([build_runner(), "schema"], capture_output=True,
                         text=True, timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"runner schema failed: {res.stderr}")
    return res.stdout.strip()


__all__ = ["NativePredictor", "build_runner", "flash_fwd_files",
           "runner_schema", "torch_flags", "FROZEN_FILE", "SOURCES",
           "HEADERS"]
