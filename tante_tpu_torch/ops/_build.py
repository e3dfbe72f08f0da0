"""Build and load the port's CUDA kernels: ``nvcc`` into shared libraries
with a plain C interface, bound with ``ctypes``.

One library per source file of ``csrc/`` (``KERNELS``), each built on first
use into ``build/kernels/`` at the repository root under a name that hashes
its own source, the headers of ``csrc/`` and the flags: an edited source
never loads a stale build, and an edit of one kernel file does not rebuild
another.  ``build()`` starts
one ``nvcc`` per source that still has to be built, all together.  Nothing
here runs at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Sequence

from tante_tpu_torch.utils.profiling import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: dict[str, ctypes.CDLL] = {}
_build_info: dict[str, dict] = {}


def build_tag(text: bytes, flags: Sequence[str]) -> str:
    """The part of a library's name that hashes its source and flags."""
    return hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]


@contextlib.contextmanager
def build_lock(build_dir: Path):
    """Processes that share the checkout (the ranks of a process group, the
    workers of a test run) build one after the other under this lock: the
    later ones find the first one's libraries."""
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


def temporary(path: Path) -> Path:
    """A build writes here and is renamed to ``path`` when whole, so a
    half-written file never carries a final name."""
    return path.with_suffix(f".tmp{os.getpid()}{path.suffix}")


def compile_once(so: Path, command: Callable[[Path], list]) -> Path:
    """Run ``command(output path)`` (a compiler's argv) to build ``so``
    under its directory's lock, unless it exists; raises RuntimeError with
    the compiler's output when the build fails."""
    with build_lock(so.parent):
        if not so.exists():
            tmp = temporary(so)
            argv = command(tmp)
            try:
                subprocess.run(argv, check=True, capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError(f"{argv[0]} not found: {e}") from e
            except subprocess.CalledProcessError as e:
                raise RuntimeError(f"{argv[0]} failed:\n{e.stderr[-4000:]}") from e
            os.replace(tmp, so)
    return so


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")
    return found


def ptxas_summary(log: str) -> list[dict]:
    """One entry per compiled kernel: registers and spills (the block
    kernels' shared memory is dynamic; ``plan()`` reports it)."""
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
    """The block kernel's tile plan for sequences of length ``l``: whole
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


def _start(kernel: str, name: str, extra_flags: Sequence[str], source=None) -> dict:
    """Start nvcc on ``csrc/<kernel>.cu`` (or ``source``) into
    ``build/kernels/<name>_<hash>.so`` unless that exact source and flag set
    was built already."""
    source = Path(source) if source else CSRC / f"{kernel}.cu"
    flags = [*NVCC_FLAGS, *extra_flags]
    # The headers beside a source count as part of it: it may include them.
    text = source.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"{name}_{build_tag(text, flags)}.so"
    job = {"so": so, "log": so.with_suffix(".log"), "t0": time.perf_counter(), "proc": None}
    job["cached"] = so.exists() and job["log"].exists()
    if not job["cached"]:
        # nvcc writes library and log under temporary names; _finish renames
        # them, so a half-written file never carries a final name.
        job["tmp"] = temporary(so)
        job["tmp_log"] = temporary(job["log"])
        with open(job["tmp_log"], "w") as log:
            job["proc"] = subprocess.Popen(
                [_nvcc(), *flags, "-o", str(job["tmp"]), str(source)],
                stdout=log, stderr=subprocess.STDOUT)
    return job


def _finish(job: dict) -> dict:
    """Wait for a started build; {"library", "seconds", "cached", "ptxas"},
    ``seconds`` from the build's start until this call returned."""
    proc = job["proc"]
    if proc is not None:
        rc = proc.wait()
        text = job["tmp_log"].read_text()
        if rc != 0:
            job["tmp_log"].unlink()
            raise RuntimeError(f"nvcc failed ({rc}):\n{text[-8000:]}")
        os.replace(job["tmp_log"], job["log"])
        os.replace(job["tmp"], job["so"])
    return {"library": str(job["so"]), "seconds": time.perf_counter() - job["t0"],
            "cached": job["cached"], "ptxas": ptxas_summary(job["log"].read_text())}


def compile_library(kernel: str, name: str | None = None, extra_flags: tuple = (),
                    source=None) -> dict:
    """Build ``csrc/<kernel>.cu`` (a measurement copy under another ``name``
    and with extra flags, or another tree's ``source`` file, if given) and
    wait for it."""
    return _finish(_start(kernel, name or kernel, extra_flags, source))


def compile_libraries(specs: Sequence[tuple]) -> list[dict]:
    """``compile_library`` for each (kernel, name, extra_flags[, source]),
    one nvcc each, all started together."""
    jobs = [_start(*spec) for spec in specs]
    return [_finish(job) for job in jobs]


def build(kernels: Sequence[str] | None = None) -> dict[str, dict]:
    """Compile every kernel source (or ``kernels``) not built yet in this
    process, one nvcc each, all started together; per-kernel build info."""
    wanted = [k for k in (kernels or KERNELS) if k not in _build_info]
    failures = []
    with build_lock(BUILD_DIR):
        jobs = {k: _start(k, k, ()) for k in wanted}
        # Quickest first (the smallest source), so that each build's seconds
        # are its own; all are waited for, so that no nvcc is left running.
        for k, job in sorted(jobs.items(), key=lambda kv: (CSRC / f"{kv[0]}.cu").stat().st_size):
            try:
                _build_info[k] = _finish(job)
            except RuntimeError as e:
                failures.append(f"{k}: {e}")
    if failures:
        raise RuntimeError("\n".join(failures))
    return {k: _build_info[k] for k in (kernels or KERNELS)}


def _bind_fused_block(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tante_fused_block_canon_t_fwd.argtypes = [p, p, ctypes.POINTER(p), i, i, i, i, i, i, i, p]
    lib.tante_fused_block_canon_t_fwd.restype = i
    lib.tante_fused_chain_fwd.argtypes = [
        p, p, p, p, ctypes.POINTER(p), ctypes.POINTER(i), i, i, i, i, i, i, p]
    lib.tante_fused_chain_fwd.restype = i
    lib.tante_fused_block_plan.argtypes = [i, i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.tante_fused_block_plan.restype = i
    lib.tante_attn_half_fwd.argtypes = [p, p, ctypes.POINTER(p), i, i, i, i, i, i, i, i, p]
    lib.tante_attn_half_fwd.restype = i
    lib.tante_mlp_half_fwd.argtypes = [p, p, ctypes.POINTER(p), i, i, i, i, p]
    lib.tante_mlp_half_fwd.restype = i


def _bind_fused_block_sm90(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in ("", "_f32"):  # the bf16 and f32 entries take the same arguments
        block = getattr(lib, f"tante_fused_block_sm90{dt}_fwd")
        block.argtypes = [p, p, ctypes.POINTER(p), ctypes.POINTER(i), i, i, i, i, i, i, i, i, p]
        block.restype = i
        canon = getattr(lib, f"tante_fused_block_canon_t_sm90{dt}_fwd")
        canon.argtypes = [
            p, p, ctypes.POINTER(p), ctypes.POINTER(i), ctypes.POINTER(i), i, i, i, i, i, i, p]
        canon.restype = i


def _bind_fused_block_long_sm90(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in ("", "_f32"):  # the bf16 and f32 entries take the same arguments
        qkv = getattr(lib, f"tante_block_long_qkv_sm90{dt}_fwd")
        qkv.argtypes = [p, p, ctypes.POINTER(p), ctypes.POINTER(i), i, i, i, i, i, p]
        qkv.restype = i
        attn = getattr(lib, f"tante_block_long_attn_sm90{dt}_fwd")
        attn.argtypes = [p, p, p, ctypes.POINTER(p), ctypes.POINTER(i), i, i, i, i, i, i, i, i, p]
        attn.restype = i
    lib.tante_block_long_smem.argtypes = [
        ctypes.POINTER(i), i, i, i, ctypes.POINTER(ctypes.c_longlong)]
    lib.tante_block_long_smem.restype = i
    if hasattr(lib, "tante_block_long_attn_items"):  # an older build of the source has none
        lib.tante_block_long_attn_items.argtypes = [
            ctypes.POINTER(i), i, i, i, i, i, i, ctypes.POINTER(i)]
        lib.tante_block_long_attn_items.restype = i


def _bind_fused_half_long_sm90(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in ("", "_f32"):  # the bf16 and f32 entries take the same arguments
        qkv = getattr(lib, f"tante_attn_half_long_qkv_sm90{dt}_fwd")
        qkv.argtypes = [p, p, ctypes.POINTER(p), ctypes.POINTER(i), i, i, i, i, i, p]
        qkv.restype = i
        attn = getattr(lib, f"tante_attn_half_long_attn_sm90{dt}_fwd")
        attn.argtypes = [p, p, ctypes.POINTER(p), ctypes.POINTER(i), i, i, i, i, i, i, i, i, p]
        attn.restype = i
    lib.tante_attn_half_long_smem.argtypes = [
        ctypes.POINTER(i), i, i, i, ctypes.POINTER(ctypes.c_longlong)]
    lib.tante_attn_half_long_smem.restype = i
    if hasattr(lib, "tante_attn_half_long_attn_items"):  # an older build of the source has none
        lib.tante_attn_half_long_attn_items.argtypes = [
            ctypes.POINTER(i), i, i, i, i, i, i, ctypes.POINTER(i)]
        lib.tante_attn_half_long_attn_items.restype = i


def _bind_fused_chain_sm90(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in ("", "_f32"):
        chain = getattr(lib, f"tante_fused_chain_sm90{dt}_fwd")
        chain.argtypes = [
            p, p, p, p, ctypes.POINTER(p), ctypes.POINTER(i), ctypes.POINTER(i), i, i, i, i, i, p,
            i, i, p]
        chain.restype = i
    lib.tante_chain_sm90_args_bytes.argtypes = []
    lib.tante_chain_sm90_args_bytes.restype = i


def _bind_fused_half_sm90(lib: ctypes.CDLL, dt: str = "") -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    attn = getattr(lib, f"tante_attn_half_sm90{dt}_fwd")
    attn.argtypes = [p, p, ctypes.POINTER(p), ctypes.POINTER(i), i, i, i, i, i, i, i, i, p]
    attn.restype = i
    mlp = getattr(lib, f"tante_mlp_half_sm90{dt}_fwd")
    mlp.argtypes = [p, p, ctypes.POINTER(p), ctypes.POINTER(i), i, i, i, i, p]
    mlp.restype = i


def _bind_fused_half_sm90_f32(lib: ctypes.CDLL) -> None:
    _bind_fused_half_sm90(lib, "_f32")  # the f32 entries take the bf16 ones' arguments


def _bind_spectral_matmul(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tante_spectral_mode_matmul.argtypes = [
        p, p, p, p, p, p, ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(i), i, p]
    lib.tante_spectral_mode_matmul.restype = i


def _bind_packed_attention(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tante_packed_attention.argtypes = [
        p, p, p, p, ctypes.POINTER(ctypes.c_longlong), i, ctypes.c_float, i, i, p]
    lib.tante_packed_attention.restype = i
    lib.tante_packed_attention_plan.argtypes = [
        ctypes.POINTER(ctypes.c_longlong), i, i, ctypes.POINTER(ctypes.c_longlong)]
    lib.tante_packed_attention_plan.restype = i


# Source file stem under csrc/ -> the declaration of its C entry points.
KERNELS: dict[str, Callable[[ctypes.CDLL], None]] = {
    "fused_block": _bind_fused_block,
    "fused_block_sm90": _bind_fused_block_sm90,
    "fused_block_long_sm90": _bind_fused_block_long_sm90,
    "fused_chain_sm90": _bind_fused_chain_sm90,
    "fused_half_sm90": _bind_fused_half_sm90,
    "fused_half_sm90_f32": _bind_fused_half_sm90_f32,
    "fused_half_long_sm90": _bind_fused_half_long_sm90,
    "spectral_matmul": _bind_spectral_matmul,
    "packed_attention": _bind_packed_attention,
}


def bind(lib: ctypes.CDLL, kernel: str = "fused_block") -> ctypes.CDLL:
    """Declare the C entry points' argument and return types."""
    KERNELS[kernel](lib)
    return lib


def load(kernel: str = "fused_block") -> ctypes.CDLL:
    """The loaded library of one kernel source (built on first call)."""
    if kernel not in _libs:
        with span("ops.load"):
            _libs[kernel] = bind(ctypes.CDLL(build([kernel])[kernel]["library"]), kernel)
    return _libs[kernel]
