"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with :mod:`ctypes`
(no PyTorch headers, so a build takes seconds, not minutes).  Libraries
land in ``kernels/build/`` (git-ignored) under a name that carries a hash
of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source is rebuilt and an unchanged one is reused.  Nothing is
built when a module is imported: a kernel's first launch builds it, or
:func:`build` builds every source at once, one ``nvcc`` per source, all
started together.

Every C entry point returns the ``cudaError_t`` of its launch
(``cudaGetLastError()``); :func:`check` raises on anything but success,
because a refused launch (too many threads, too much shared memory)
never runs and ``torch.cuda.synchronize()`` would not report it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("sisa_gemm", "paged_attn", "grouped_gemm", "grouped_dw",
           "coexec", "moe_gemm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Launches of one kernel: its wrapper adds one per launch and
    nowhere else, so a run can show its main path went through the
    kernel."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0

    def reset(self) -> None:
        self.n = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "GPU host (CUDA toolkit under /usr/local/cuda)")


def library_path(name: str) -> Path:
    # Every header under csrc/ counts: a source may include any of them.
    parts = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha1(b"".join(p.read_bytes() for p in parts)
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source that has no up-to-date library, all
    in parallel.  Returns seconds per source actually compiled; the
    compiler's output (``ptxas`` registers, shared memory, spills) is
    kept beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, out, log,
            time.perf_counter())
    seconds, failed = {}, []
    for name, (proc, tmp, out, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (rc {rc}):\n"
                          + out.with_suffix(".log").read_text())
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    if name not in _LIBS:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        err_fn = getattr(lib, f"{name}_error_string")
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = getattr(load(name), f"{name}_error_string")(err)
        raise RuntimeError(f"{name} launch failed: cuda error {err} "
                           f"({msg.decode() if msg else 'unknown'})")
