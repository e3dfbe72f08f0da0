"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, bound with ``ctypes``.

The library is built from ``csrc/fused_block.cu`` on first use, into
``build/kernels/`` at the repository root, under a name that hashes the
source and the flags (an edited source never loads a stale build).  Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_block.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None
_build_info: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")
    return found


def ptxas_summary(log: str) -> list[dict]:
    """One entry per compiled kernel: registers and spills (shared memory
    is dynamic; ``plan()`` reports it)."""
    out = []
    for m in re.finditer(
        r"Compiling entry function '(\S+)'.*?Used (\d+) registers", log, re.S
    ):
        body = log[m.start() : m.end()]
        spill = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        out.append({
            "kernel": m.group(1),
            "registers": int(m.group(2)),
            "spill_store_bytes": int(spill[-1][0]) if spill else 0,
            "spill_load_bytes": int(spill[-1][1]) if spill else 0,
        })
    return out


def plan(l: int, c: int, hidden: int, lib: ctypes.CDLL | None = None) -> dict:
    """The kernel's tile plan for sequences of length ``l``: whole
    sequences per CTA, rows per CTA (padded to 16) and dynamic shared
    memory bytes — read from the library (``lib``, by default the loaded
    one), so it is the launch's own plan."""
    seqs, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = (lib or load()).tante_fused_block_plan(
        l, c, hidden, ctypes.byref(seqs), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"no tile plan for L={l}, C={c}, hidden={hidden} (cudaError {rc})")
    return {"seqs_per_cta": seqs.value, "rows_per_cta": (seqs.value * l + 15) // 16 * 16,
            "smem_bytes": smem.value}


def compile_library(name: str, extra_flags: tuple = ()) -> dict:
    """nvcc ``fused_block.cu`` into ``build/kernels/<name>_<hash>.so`` unless
    that exact source and flag set was built already.  Returns {"library",
    "seconds", "cached", "ptxas"}."""
    flags = [*NVCC_FLAGS, *extra_flags]
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"{name}_{tag}.so"
    log_path = so.with_suffix(".log")
    t0 = time.perf_counter()
    cached = so.exists() and log_path.exists()
    if not cached:
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    return {"library": str(so), "seconds": time.perf_counter() - t0, "cached": cached,
            "ptxas": ptxas_summary(log_path.read_text())}


def build() -> dict:
    """Compile the kernels if this source has not been built yet."""
    if not _build_info:
        _build_info.update(compile_library("fused_block"))
    return _build_info


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument and return types."""
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.tante_fused_block_fwd, lib.tante_fused_block_canon_t_fwd):
        fn.argtypes = [p, p, ctypes.POINTER(p), i, i, i, i, i, i, i, p]
        fn.restype = i
    lib.tante_fused_chain_fwd.argtypes = [
        p, p, p, p, ctypes.POINTER(p), ctypes.POINTER(i), i, i, i, i, i, p]
    lib.tante_fused_chain_fwd.restype = i
    lib.tante_fused_block_plan.argtypes = [i, i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.tante_fused_block_plan.restype = i
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(build()["library"]))
    return _lib
