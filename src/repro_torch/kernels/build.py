"""Build and load the hand-written CUDA kernels.

Every kernel is compiled by `nvcc` for `sm_90a` into a shared library
with a plain C interface and loaded with `ctypes`; no PyTorch header is
compiled.  Sources are the fixed files under `csrc/` and the per-predicate
files `codegen.py` generates.  A library is named by a hash of its source,
the headers it can include and the compiler flags, and built into
`_build/` beside this module at first use, so one build serves every
later call (and every binding of a query's parameters).  `build_all`
starts one `nvcc` per missing library, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no contraction of a*b+c into one FMA: generated predicates must
    # round every float operation as the plain torch evaluator does
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_LIBS: dict[Path, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _digest(source: str) -> str:
    h = hashlib.sha256(source.encode())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def static_source(name: str) -> str:
    """The text of a fixed kernel source under `csrc/`."""
    return (CSRC / f"{name}.cu").read_text()


def static_sources() -> list[tuple[str, str]]:
    """(name, source) of every fixed kernel library."""
    return [(p.stem, p.read_text()) for p in sorted(CSRC.glob("*.cu"))]


def library_path(name: str, source: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(source)}.so"


def build_all(sources: list[tuple[str, str]]) -> list[Path]:
    """Build every (name, source) not built yet, one `nvcc` each, all
    started together; return the library paths in order.  A failed build
    raises with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths, procs = [], []
    for name, source in sources:
        lib = library_path(name, source)
        paths.append(lib)
        if lib.exists() or any(p == lib for p, *_ in procs):
            continue
        cu = lib.with_suffix(".cu")
        cu.write_text(source)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        log = lib.with_suffix(".log")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(cu)]
        procs.append((lib, tmp, log, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for lib, tmp, log, proc in procs:
        out, _ = proc.communicate()
        log.write_bytes(out)
        if proc.returncode != 0:
            failed.append(f"{lib.name}:\n{out.decode(errors='replace')}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load(name: str, source: str) -> ctypes.CDLL:
    """The loaded library for (name, source), built first if needed."""
    lib_path = library_path(name, source)
    with _LOCK:
        lib = _LIBS.get(lib_path)
        if lib is None:
            build_all([(name, source)])
            lib = _LIBS[lib_path] = ctypes.CDLL(str(lib_path))
        return lib


def check_cuda_1d(name: str, t, dtype=None) -> None:
    """Raise unless `t` is a contiguous 1-D CUDA tensor (of `dtype`)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}, the kernel needs CUDA")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if t.ndim != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor")


def check(err: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)
