"""Build and load the hand-written CUDA kernels of `csrc/`.

At first use every `csrc/*.cu` is compiled by its own `nvcc`, all started
together, and the objects are linked into one shared library with a plain C
interface, under `orbslam3_tpu_torch/_build/`, named by a hash of the
sources (a changed source builds anew; an unchanged one is loaded). The
assembler's report of each kernel's registers and shared memory
(`-Xptxas -v`) is kept beside the library (`resource_report()`). The
library is bound with `ctypes`: each entry point takes raw device pointers,
sizes and the CUDA stream, launches on that stream, and returns
`cudaGetLastError()`. Nothing here runs at import.

`use_kernel(x)` is the one dispatch rule of the port's kernel wrappers:
a CPU tensor takes the plain PyTorch version, any other tensor the kernel
(which raises where it cannot run). `force_plain()` is a test-only switch
that sends CUDA tensors to the plain versions too, so a whole frame can be
compared kernel against plain on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points in csrc/ (all return cudaError_t as int).
SIGNATURES = {
    # img, score, ini, H, W, min_th, ini_th, stream
    "fast_nms_launch": [_P, _P, _P, _I, _I, _F, _F, _P],
    # a, b, valid_b, uvq, uvk, rad, rad_stride, octk, lo, hi, windowed, N, M, d1, d2, j1, stream
    "hamming_top2_launch": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
}

_lib = None
build_seconds = None  # wall time of the last build (None: loaded, not built)
_FORCE_PLAIN = False


def use_kernel(x: torch.Tensor) -> bool:
    """True when `x`'s wrapper must launch its kernel (any non-CPU tensor,
    unless `force_plain()` is active)."""
    return x.device.type != "cpu" and not _FORCE_PLAIN


@contextlib.contextmanager
def force_plain():
    """Test-only: run the plain versions on CUDA tensors inside the block."""
    global _FORCE_PLAIN
    prev, _FORCE_PLAIN = _FORCE_PLAIN, True
    try:
        yield
    finally:
        _FORCE_PLAIN = prev


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _library_path() -> Path:
    h = hashlib.sha256()
    for s in _sources() + [Path(__file__)]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libkernels-{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    """One `nvcc -c` per source, all at once, then one link into `out`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    srcs = _sources()
    objs = [out.with_name(f"{s.stem}.{tag}.o") for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        for s, p, log in zip(srcs, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s.name}:\n{log}")
        tmp = out.with_suffix(f".{tag}")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{res.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    out.with_suffix(".ptxas.txt").write_text("".join(logs))
    os.replace(tmp, out)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if the sources changed."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    out = _library_path()
    if not out.exists():
        t0 = time.perf_counter()
        _compile(out)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def resource_report() -> str:
    """The assembler's lines (`ptxas info`) of the loaded library's build:
    each kernel's registers, shared memory and spills."""
    library()
    log = _library_path().with_suffix(".ptxas.txt")
    return "".join(ln for ln in log.read_text().splitlines(keepends=True) if "ptxas info" in ln)


def launch(name: str, *args) -> None:
    """Call entry point `name` on the current CUDA stream; raise if the
    launch was refused."""
    fn = getattr(library(), name)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()
