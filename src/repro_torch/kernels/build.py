"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source compiles with its own ``nvcc`` process (all
started together) for ``sm_90a`` into an object file; the objects link
into one shared library with a plain C interface, loaded with ``ctypes``.
The build runs at first use, into ``build/repro_torch_kernels`` at the
repository root, from the sources in the checkout only; it is skipped
when the library is newer than every source. Nothing here runs at import
time: the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
LIB_NAME = "liblsketch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every pointer and the stream as c_void_p, every size as int
SIGNATURES = {
    "lsk_sketch_insert": [_P] * 18 + [_I] * 9 + [_P],
    "lsk_pool_pass": [_P] * 13 + [_I] * 7 + [_P],
    "lsk_sketch_query": [_P] * 10 + [_I] * 5 + [_P],
    "lsk_edge_query": [_P] * 14 + [_I] * 12 + [_P],
    "lsk_vertex_scan": [_P] * 9 + [_I] * 7 + [_P],
    "lsk_cell_decode": [_P] * 5 + [_I] * 5 + [_P],
    "lsk_flash_attention": [_P] * 4 + [_I] * 8 + [_P],
}

_lib = None
PTXAS_LOG: dict = {}  # source name -> nvcc/ptxas output of the last build


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def build(force: bool = False) -> Path:
    """Compile every source in parallel and link the library; returns its
    path. ``PTXAS_LOG`` receives each compile's ``-Xptxas -v`` report."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    lib = BUILD_DIR / LIB_NAME
    newest = max(p.stat().st_mtime for p in sources + headers)
    if not force and lib.exists() and lib.stat().st_mtime >= newest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for src in sources:
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
               "-Xcompiler", "-fPIC", "-c", str(src), "-o", str(obj)]
        procs[src.name] = (obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (_, proc) in procs.items():
        out, _ = proc.communicate()
        PTXAS_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = BUILD_DIR / (LIB_NAME + ".tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for obj, _ in procs.values()]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib)
    return lib


def load_library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def call(name: str, *args) -> None:
    """Launch C entry ``name`` on PyTorch's current stream; tensors pass as
    device pointers (``None`` as a null pointer), ints as ints. Raises on
    a non-zero ``cudaGetLastError``."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    conv = [None if a is None else
            (a.data_ptr() if isinstance(a, torch.Tensor) else int(a))
            for a in args]
    rc = getattr(load_library(), name)(*conv, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def check_cuda(*tensors) -> None:
    """Validate what a kernel takes: contiguous int32 tensors on one card.
    (Reads only cheap tensor properties: it runs on every launch.)"""
    import torch

    dev = None
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda or t.dtype is not torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"kernel input must be a contiguous int32 CUDA "
                             f"tensor, got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
        if dev is None:
            dev = t.get_device()
        elif t.get_device() != dev:
            raise ValueError("kernel inputs lie on different devices")
