"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` on its own into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). The library lands in ``kernels/build/`` (git-ignored) under
a name that hashes the source, the shared headers and the flags, so an
edited source is rebuilt and an unchanged one is reused. :func:`build_all`
starts one ``nvcc`` per source, all at once, and waits for them.

Every C entry point returns the ``cudaError_t`` of its launch; the Python
wrappers raise when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
KERNELS = ("lora_matmul", "flash_attention", "flash_decode",
           "lora_bgmv_rows", "lora_bgmv_seq")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (PATH or {cuda_home}/bin): the "
                           "CUDA kernels are built on the GPU machine only")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start the build of one kernel; None if its library is current."""
    out = _target(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)              # atomic: concurrent builders agree
    return log


def build_all(names=KERNELS) -> dict[str, str]:
    """Build every listed kernel in parallel; returns {name: nvcc log}
    (empty for a library that was already current)."""
    jobs = {n: _start(n) for n in names}
    logs = {}
    for n, job in jobs.items():
        logs[n] = "" if job is None else _finish(n, job)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return lib


def bind(name: str, argtypes: list) -> ctypes.CDLL:
    """Load ``name`` and declare its ``<name>_launch(...) -> int`` and
    ``<name>_error_string(int) -> char*`` C signatures."""
    lib = load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        es = getattr(lib, f"{name}_error_string")
        es.argtypes, es.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def checked_args(name: str, tensors: dict, dtype: torch.dtype) -> int:
    """Validate what a kernel takes before its pointers are passed: every
    tensor on one CUDA device, contiguous, of ``dtype`` (f32 or bf16) —
    int32 for names ending in ``pos`` or ``ids``. Returns the csrc
    ``DTypeCode``."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or "
                        f"bfloat16, not {dtype}")
    dev = None
    for key, t in tensors.items():
        want = torch.int32 if key.endswith(("pos", "ids")) else dtype
        if not t.is_cuda or t.dtype != want or not t.is_contiguous():
            raise ValueError(
                f"{name}: {key} must be a contiguous {want} CUDA tensor, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, not {dev}")
        dev = t.device
    return codes[dtype]


def stream(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
