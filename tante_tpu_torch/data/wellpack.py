"""WellPack: the native (C++) batch assembly over a flat cache (counterpart of
``tante_tpu/data/wellpack.py``).

1. ``build_cache(dataset, path)``: decode and normalise every trajectory of a
   ``TanteDataset`` split once into a flat float32 file (a header, then the
   contiguous (n_traj, T, H, W, C) payload).  Sliding windows overlap T-fold,
   so the HDF5 chunks are decoded once instead of once per window.  The
   decode is native (``native/wellpack_h5.cpp``: H5Dread, normalise,
   interleave; h5py reads only attribute metadata) and falls back to the
   h5py reader's ``_reconstruct_fields`` where that cannot run (no g++, no
   HDF5 runtime library, a remote file).  Both write the same bytes, through
   ``write_cache``.
2. ``WellPackLoader``: the ctypes front end of ``native/wellpack.cpp``, a C++
   thread pool that assembles (input, output) window batches from the mmapped
   cache into a ring of host buffers outside the GIL.  Each ready slot is
   copied out (into pinned memory on the card's host) before it is released,
   and sent to the device with ``non_blocking=True``, ``prefetch`` batches
   ahead of the consumer.

The libraries are compiled with g++ into ``build/native/`` at the repository
root, one per source under a name that hashes the source and the flags, never
into ``native/``.  ``TanteDataModule(use_wellpack=True)`` falls back to the
Python ``DataLoader`` when the loader's library cannot be built.
"""

from __future__ import annotations

import ctypes
import glob
import logging
import os
import struct
from collections import deque
from pathlib import Path
from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from tante_tpu_torch.data.synthetic import compute_windows
from tante_tpu_torch.ops._build import build_tag, compile_once
from tante_tpu_torch.ops.backend import resolve_device

logger = logging.getLogger(__name__)

_MAGIC = 0x57454C4C5041434B  # "WELLPACK"
_HEADER = struct.Struct("<Qqqqqq")  # magic, n_traj, T, H, W, C

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "native"

_libs: Dict[str, ctypes.CDLL] = {}


def _compile(source: str, flags: list, libs: list) -> Path:
    """g++ ``native/<source>`` into ``build/native/<stem>_<hash>.so`` unless
    that source and flag set was built already (``ops/_build.py``'s tag,
    lock and rename); raises RuntimeError with the compiler's output when it
    cannot be built."""
    src = NATIVE_DIR / source
    if not src.exists():
        raise RuntimeError(f"{src} is missing")
    so = BUILD_DIR / f"{src.stem}_{build_tag(src.read_bytes(), flags + libs)}.so"
    return compile_once(so, lambda out: ["g++", *flags, "-o", str(out), str(src), *libs])


def _bind_loader(lib: ctypes.CDLL) -> None:
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fp = ctypes.POINTER(ctypes.c_float)
    lib.wp_open.restype = p
    lib.wp_open.argtypes = [ctypes.c_char_p]
    lib.wp_shape.restype = None
    lib.wp_shape.argtypes = [p, ctypes.POINTER(i64)]
    lib.wp_close.restype = None
    lib.wp_close.argtypes = [p]
    lib.wp_loader_create.restype = p
    lib.wp_loader_create.argtypes = [p, ctypes.POINTER(i64), ctypes.POINTER(i64), i64, i64, i64,
                                     i64, i64, i, i]
    lib.wp_loader_next.restype = i
    lib.wp_loader_next.argtypes = [p]
    lib.wp_loader_buffers.restype = None
    lib.wp_loader_buffers.argtypes = [p, i, ctypes.POINTER(fp), ctypes.POINTER(fp)]
    lib.wp_loader_release.restype = None
    lib.wp_loader_release.argtypes = [p, i]
    lib.wp_loader_n_batches.restype = i64
    lib.wp_loader_n_batches.argtypes = [p]
    lib.wp_loader_destroy.restype = None
    lib.wp_loader_destroy.argtypes = [p]


def _bind_h5(lib: ctypes.CDLL) -> None:
    i64, fp = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
    lib.wph5_init.restype = ctypes.c_int
    lib.wph5_init.argtypes = [ctypes.c_char_p]
    lib.wph5_open.restype = i64
    lib.wph5_open.argtypes = [ctypes.c_char_p]
    lib.wph5_close.restype = None
    lib.wph5_close.argtypes = [i64]
    lib.wph5_decode_field.restype = ctypes.c_int
    lib.wph5_decode_field.argtypes = [i64, ctypes.c_char_p, i64, i64, i64, i64, i64, fp, fp, fp,
                                      i64, i64]


def get_library() -> Optional[ctypes.CDLL]:
    """The batch-assembly engine (``native/wellpack.cpp``), built on first
    use; None, with the reason logged, when it cannot be built or loaded."""
    if "wellpack" not in _libs:
        try:
            so = _compile("wellpack.cpp", ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"],
                          [])
            lib = ctypes.CDLL(str(so))
        except (RuntimeError, OSError) as e:
            logger.warning("native wellpack loader unavailable: %s", e)
            return None
        _bind_loader(lib)
        _libs["wellpack"] = lib
    return _libs["wellpack"]


def _find_hdf5_soname() -> Optional[str]:
    """h5py's bundled HDF5 (the version that wrote these files) if h5py is
    installed, else the system's serial library."""
    try:
        import h5py
    except ImportError:
        h5py = None
    if h5py is not None:
        bundled = glob.glob(os.path.join(os.path.dirname(h5py.__file__), "..", "h5py.libs",
                                         "libhdf5-*.so*"))
        if bundled:
            return os.path.abspath(bundled[0])
    for name in ("libhdf5_serial.so.103", "libhdf5_serial.so", "libhdf5.so"):
        try:
            ctypes.CDLL(name)
            return name
        except OSError:
            continue
    return None


def get_h5_library() -> Optional[ctypes.CDLL]:
    """The native HDF5 decode (``native/wellpack_h5.cpp``), bound to a
    dlopened libhdf5; None, with the reason logged, when the toolchain or an
    HDF5 runtime library is missing."""
    if "wellpack_h5" not in _libs:
        try:
            so = _compile("wellpack_h5.cpp", ["-O3", "-std=c++17", "-fPIC", "-shared"], ["-ldl"])
            lib = ctypes.CDLL(str(so))
        except (RuntimeError, OSError) as e:
            logger.warning("native HDF5 decode unavailable: %s", e)
            return None
        soname = _find_hdf5_soname()
        if soname is None:
            logger.warning("native HDF5 decode unavailable: no libhdf5 found")
            return None
        _bind_h5(lib)
        if lib.wph5_init(soname.encode()) != 0:
            logger.warning("native HDF5 decode unavailable: %s did not load", soname)
            return None
        _libs["wellpack_h5"] = lib
    return _libs["wellpack_h5"]


# ---------------------------------------------------------------------------
# The cache file


def write_cache(path: str, trajectories: Iterable[np.ndarray], n_traj: int, t_total: int,
                h: int, w: int, c: int) -> str:
    """Write a WellPack cache: the header (magic, n_traj, T, H, W, C), then
    each (T, H, W, C) float32 trajectory in order.  Written under a
    temporary name and renamed, so a cache that exists is whole."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        n = 0
        with open(tmp, "wb") as f:
            f.write(_HEADER.pack(_MAGIC, n_traj, t_total, h, w, c))
            for traj in trajectories:
                if traj.shape != (t_total, h, w, c) or traj.dtype != np.float32:
                    raise ValueError(f"trajectory {n}: {traj.dtype} {traj.shape}, want float32 "
                                     f"{(t_total, h, w, c)}")
                f.write(np.ascontiguousarray(traj).tobytes())
                n += 1
        if n != n_traj:
            raise ValueError(f"{n} trajectories written, the header says {n_traj}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def read_cache_shape(path: str) -> tuple:
    """(n_traj, T, H, W, C) of a cache, checked against its size: the
    native loader trusts the header."""
    with open(path, "rb") as f:
        raw = f.read(_HEADER.size)
    if len(raw) != _HEADER.size:
        raise IOError(f"{path} is not a WellPack cache (short header)")
    magic, *shape = _HEADER.unpack(raw)
    want = _HEADER.size + 4 * int(np.prod(shape))
    if magic != _MAGIC or min(shape) <= 0 or os.path.getsize(path) != want:
        raise IOError(f"{path} is not a whole WellPack cache (magic {magic:#x}, shape {shape}, "
                      f"{os.path.getsize(path)} bytes, want {want})")
    return tuple(shape)


def _cache_shape(dataset) -> tuple:
    md = dataset.metadata
    steps = set(md.n_steps_per_trajectory)
    if len(steps) != 1:
        raise ValueError(f"WellPack needs one trajectory length, the split has {sorted(steps)}")
    h, w = md.spatial_resolution
    return sum(md.n_trajectories_per_file), steps.pop(), h, w, md.n_fields


class _NoNativeDecode(Exception):
    """The native decode cannot read this split: use the h5py route."""


def _native_field_plan(dataset, hf) -> list:
    """Per time-varying field: (dataset path, sample_varying, components,
    mean, std, channel offset).  Metadata reads only; the bulk read,
    normalisation and interleave are C++."""
    d = dataset.metadata.n_spatial_dims
    plan, c_off = [], 0
    for order in range(3):
        group = hf[f"t{order}_fields"]
        for name in group.attrs["field_names"]:
            field = group[name]
            if not field.attrs["time_varying"]:
                continue
            ncomp = d**order

            def stat(table, default):
                if name not in table:
                    return np.full((ncomp,), default, np.float32)
                v = np.asarray(table[name], np.float32).reshape(-1)
                if v.size not in (1, ncomp):
                    raise _NoNativeDecode(f"stats of {name} have {v.size} entries")
                return np.ascontiguousarray(np.broadcast_to(v, (ncomp,)))

            plan.append((f"t{order}_fields/{name}".encode(), bool(field.attrs["sample_varying"]),
                         ncomp, stat(dataset.means, 0.0), stat(dataset.stds, 1.0), c_off))
            c_off += ncomp
    if c_off != dataset.metadata.n_fields:
        raise _NoNativeDecode(f"{c_off} channels planned for {dataset.metadata.n_fields}")
    return plan


def _native_trajectories(dataset, lib, shape) -> Iterator[np.ndarray]:
    """Each trajectory decoded by ``wph5_decode_field`` into one reused
    buffer (the writer consumes it before the next)."""
    _, t_total, h, w, c = shape
    md = dataset.metadata
    fp = ctypes.POINTER(ctypes.c_float)
    traj = np.empty((t_total, h, w, c), np.float32)
    for file_idx in range(md.n_files):
        plan = _native_field_plan(dataset, dataset._file(file_idx))
        handle = lib.wph5_open(dataset.files_paths[file_idx].encode())
        if not handle:
            raise _NoNativeDecode(f"wph5_open failed on {dataset.files_paths[file_idx]}")
        try:
            for sample_idx in range(md.n_trajectories_per_file[file_idx]):
                for dset, sample_varying, ncomp, mean, std, c_off in plan:
                    rc = lib.wph5_decode_field(
                        handle, dset, sample_idx if sample_varying else -1, t_total, h, w, ncomp,
                        mean.ctypes.data_as(fp), std.ctypes.data_as(fp), traj.ctypes.data_as(fp),
                        c, c_off)
                    if rc != 0:
                        raise _NoNativeDecode(f"wph5_decode_field returned {rc} on {dset!r}")
                yield traj
        finally:
            lib.wph5_close(handle)


def _h5py_trajectories(dataset, shape) -> Iterator[np.ndarray]:
    t_total = shape[1]
    md = dataset.metadata
    for file_idx in range(md.n_files):
        hf = dataset._file(file_idx)
        for sample_idx in range(md.n_trajectories_per_file[file_idx]):
            blocks = dataset._reconstruct_fields(hf, sample_idx, 0, t_total, 1)
            yield np.concatenate(blocks, axis=-1).astype(np.float32)


def _build_cache_native(dataset, path: str) -> Optional[str]:
    """The native decode of the whole split into ``path``; None where it
    cannot run (the h5py route then writes the same bytes)."""
    lib = get_h5_library()
    if lib is None or any(not os.path.exists(p) for p in dataset.files_paths):
        return None  # no toolchain / libhdf5, or a remote (fsspec) dataset
    shape = _cache_shape(dataset)
    try:
        return write_cache(path, _native_trajectories(dataset, lib, shape), *shape)
    except _NoNativeDecode as e:
        logger.warning("native HDF5 decode of %s skipped: %s", dataset, e)
        return None


def build_cache(dataset, path: str) -> str:
    """Decode and normalise every trajectory of a ``TanteDataset`` split into
    a WellPack cache (one uniform (T, H, W, C)): natively where it can, else
    through h5py; the same bytes either way."""
    native = _build_cache_native(dataset, path)
    if native is not None:
        return native
    shape = _cache_shape(dataset)
    return write_cache(path, _h5py_trajectories(dataset, shape), *shape)


# ---------------------------------------------------------------------------
# The loader


class WellPackLoader:
    """Native drop-in for ``DataLoader`` over a WellPack cache: the same
    batches in the same order (``np.random.default_rng(seed + epoch)``
    shuffles the item range, the ragged batch is dropped), as tensors on
    ``device`` (CUDA unless the caller passes "cpu").  ``sharding`` (a
    ``parallel.mesh.BatchSlice``, set by the Trainer under a mesh) keeps this
    rank's part of each global batch."""

    def __init__(self, cache_path: str, n_steps_input: int, n_steps_output: int,
                 dt_stride: int = 1, batch_size: int = 4, shuffle: bool = False, seed: int = 0,
                 num_threads: int = 4, ring_slots: int = 3, sharding: Optional[Any] = None,
                 prefetch: int = 2, device=None):
        self.device = resolve_device(device)
        lib = get_library()
        if lib is None:
            raise RuntimeError("the native wellpack library is unavailable (see the log)")
        self._lib = lib
        self.n_traj, self.t_total, self.h, self.w, self.c = read_cache_shape(cache_path)
        self._cache = lib.wp_open(cache_path.encode())
        if not self._cache:
            raise IOError(f"cannot open WellPack cache {cache_path}")
        self.n_steps_input = n_steps_input
        self.n_steps_output = n_steps_output
        self.dt_stride = dt_stride
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.ring_slots = max(1, ring_slots)
        self.sharding = sharding
        self.prefetch = max(1, prefetch)
        self._epoch = 0
        self.windows_per_traj = compute_windows(self.t_total, n_steps_input, n_steps_output,
                                                dt_stride)
        if self.windows_per_traj <= 0:
            raise ValueError(f"{self.t_total} steps do not fit {n_steps_input} input and "
                             f"{n_steps_output} output steps with stride {dt_stride}")
        self.n_items = self.n_traj * self.windows_per_traj

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        return self.n_items // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        """The copy to the device is asynchronous, so the next batches'
        copies are issued before the previous one is yielded: staging
        overlaps the consumer's work and the C++ assembly."""
        pending: deque = deque()
        for batch in self._produce():
            pending.append(batch)
            if len(pending) > self.prefetch:
                yield pending.popleft()
        while pending:
            yield pending.popleft()

    def _to_device(self, view: np.ndarray) -> torch.Tensor:
        """A copy of a ring slot's batch (this rank's part of it) on the
        device: the slot is reused once released, so it is never aliased."""
        if self.sharding is not None:
            view = self.sharding(view)
        src = torch.from_numpy(view)
        if self.device.type != "cuda":
            return src.clone(memory_format=torch.contiguous_format)
        staged = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        staged.copy_(src)
        return staged.to(self.device, non_blocking=True)

    def _produce(self) -> Iterator[Dict[str, torch.Tensor]]:
        order = np.arange(self.n_items, dtype=np.int64)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        # Both index arrays stay referenced here while the C++ loader runs.
        traj = (order // self.windows_per_traj).astype(np.int64)
        time = (order % self.windows_per_traj).astype(np.int64)
        lib, i64p = self._lib, ctypes.POINTER(ctypes.c_int64)
        loader = lib.wp_loader_create(
            self._cache, traj.ctypes.data_as(i64p), time.ctypes.data_as(i64p), self.n_items,
            self.batch_size, self.n_steps_input, self.n_steps_output, self.dt_stride,
            self.num_threads, self.ring_slots)
        frame = (self.h, self.w, self.c)
        in_shape = (self.batch_size, self.n_steps_input, *frame)
        out_shape = (self.batch_size, self.n_steps_output, *frame)
        try:
            for _ in range(lib.wp_loader_n_batches(loader)):
                slot = lib.wp_loader_next(loader)
                if slot < 0:
                    break
                in_p = ctypes.POINTER(ctypes.c_float)()
                out_p = ctypes.POINTER(ctypes.c_float)()
                lib.wp_loader_buffers(loader, slot, ctypes.byref(in_p), ctypes.byref(out_p))
                batch = {"input": self._to_device(np.ctypeslib.as_array(in_p, shape=in_shape)),
                         "output": self._to_device(np.ctypeslib.as_array(out_p, shape=out_shape))}
                lib.wp_loader_release(loader, slot)
                yield batch
        finally:
            lib.wp_loader_destroy(loader)

    def close(self) -> None:
        if self._cache:
            self._lib.wp_close(self._cache)
            self._cache = None

    def __del__(self):  # best effort: close() is the way to release the mmap
        try:
            self.close()
        except Exception:
            pass
