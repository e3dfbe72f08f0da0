"""Port parity: the WellPack front end (``tante_tpu_torch/data/wellpack.py``)
against the JAX package's (the counterpart of ``tests/test_wellpack.py``), on
the CPU: the cache the port writes, by the native decode and by h5py, is
byte-equal to JAX's ``build_cache``; the native loader's batches equal JAX's
``WellPackLoader``'s, max abs 0; the libraries are built into ``build/``,
never into ``native/``."""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from tante_tpu.data.dataset import TanteDataset as JaxDataset
from tante_tpu.data.synthetic import make_well_dataset as jax_make_well_dataset
from tante_tpu.data.wellpack import WellPackLoader as JaxWellPackLoader
from tante_tpu.data.wellpack import build_cache as jax_build_cache
from tante_tpu_torch.data import TanteDataModule, TanteDataset
from tante_tpu_torch.data import wellpack as wp
from tante_tpu_torch.data.loader import DataLoader
from tante_tpu_torch.parallel.mesh import BatchSlice

NAME = "synthetic_waves"
ROOT = Path(__file__).resolve().parents[1]


def datasets(base, name=NAME, **kw):
    kw = {"n_steps_input": 4, "n_steps_output": 2, **kw}
    return (JaxDataset(base_path=base, dataset_name=name, split_name="train", **kw),
            TanteDataset(base_path=base, dataset_name=name, split_name="train", **kw))


@pytest.fixture(scope="module")
def caches(well_root, tmp_path_factory):
    """(JAX's cache, the port's cache) of the train split."""
    ref, got = datasets(well_root)
    d = tmp_path_factory.mktemp("wpk")
    return jax_build_cache(ref, str(d / "jax.wpk")), wp.build_cache(got, str(d / "port.wpk"))


def read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("route", ["native", "h5py"])
@pytest.mark.parametrize("with_t2", [False, True])
def test_cache_is_byte_equal_to_jax(tmp_path, monkeypatch, route, with_t2):
    jax_make_well_dataset(str(tmp_path), dataset_name="c", n_files_per_split=2,
                          n_trajectories=2, n_steps=9, resolution=(8, 16), with_t2=with_t2,
                          with_pressure=not with_t2)
    ref, got = datasets(str(tmp_path), name="c", n_steps_input=2, n_steps_output=2)
    want = read(jax_build_cache(ref, str(tmp_path / "jax.wpk")))
    path = str(tmp_path / "port.wpk")
    if route == "native":
        assert wp._build_cache_native(got, path) == path  # the C++ decode ran
    else:
        monkeypatch.setattr(wp, "get_h5_library", lambda: None)
        assert wp.build_cache(got, path) == path
    assert read(path) == want
    md = got.metadata
    shape = (4, 9, 8, 16, md.n_fields)
    assert wp.read_cache_shape(path) == shape
    payload = np.frombuffer(read(path)[wp._HEADER.size:], np.float32).reshape(shape)
    for i in range(4):  # trajectory i, frames 0-3 (window 0 of a 2-in, 2-out split)
        file_traj = (i // 2) * got.metadata.n_trajectories_per_file[0] * 6 + (i % 2) * 6
        item = got[file_traj]
        np.testing.assert_array_equal(payload[i, :2], item["input"])
        np.testing.assert_array_equal(payload[i, 2:4], item["output"])


def test_default_cache_route_is_byte_equal(caches):
    assert read(caches[1]) == read(caches[0])


@pytest.mark.parametrize("batch_size,shuffle,seed,threads", [
    (1, False, 0, 2), (4, True, 3, 4), (5, True, 11, 3), (8, False, 0, 1)])
def test_loader_batches_equal_jax(caches, batch_size, shuffle, seed, threads):
    kw = dict(n_steps_input=4, n_steps_output=2, batch_size=batch_size, shuffle=shuffle,
              seed=seed, num_threads=threads)
    jl, tl = JaxWellPackLoader(caches[0], **kw), wp.WellPackLoader(caches[1], device="cpu", **kw)
    assert len(tl) == len(jl) > 0 and tl.n_items == jl.n_items
    firsts = []
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb) == len(tl)
        for a, b in zip(jb, tb):
            for k in ("input", "output"):
                assert isinstance(b[k], torch.Tensor) and b[k].dtype == torch.float32
                np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))
        firsts.append(tb[0]["input"].numpy())
    assert shuffle == (not np.array_equal(*firsts))
    jl.close()
    tl.close()


def test_loader_batches_equal_the_python_loader(well_root, caches):
    """The same windows in the same order as ``DataLoader`` over the dataset."""
    _, got = datasets(well_root)
    kw = dict(batch_size=4, shuffle=True, seed=5)
    tl = wp.WellPackLoader(caches[1], 4, 2, device="cpu", num_threads=3, **kw)
    pl = DataLoader(got, device="cpu", num_workers=2, **kw)
    for a, b in zip(pl, tl, strict=True):
        for k in ("input", "output"):
            np.testing.assert_array_equal(b[k].numpy(), a[k].numpy())


@pytest.mark.parametrize("n_in,n_out,stride", [(2, 1, 2), (3, 2, 3)])
def test_loader_dt_stride(well_root, tmp_path, n_in, n_out, stride):
    ref, got = datasets(well_root, n_steps_input=n_in, n_steps_output=n_out, dt_stride=stride)
    kw = dict(n_steps_input=n_in, n_steps_output=n_out, dt_stride=stride, batch_size=3,
              shuffle=True, seed=2)
    jl = JaxWellPackLoader(jax_build_cache(ref, str(tmp_path / "j.wpk")), **kw)
    tl = wp.WellPackLoader(wp.build_cache(got, str(tmp_path / "t.wpk")), device="cpu", **kw)
    for a, b in zip(jl, tl, strict=True):
        for k in ("input", "output"):
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))
    first = next(iter(wp.WellPackLoader(str(tmp_path / "t.wpk"), n_in, n_out, stride,
                                        batch_size=1, device="cpu")))
    np.testing.assert_array_equal(first["input"][0].numpy(), got[0]["input"])
    np.testing.assert_array_equal(first["output"][0].numpy(), got[0]["output"])


def test_tensor_fields(tmp_path):
    jax_make_well_dataset(str(tmp_path), dataset_name="tens", n_trajectories=2, n_steps=8,
                          resolution=(8, 16), with_t2=True)
    _, got = datasets(str(tmp_path), name="tens", n_steps_input=2, n_steps_output=2)
    path = wp.build_cache(got, str(tmp_path / "t.wpk"))
    assert wp.read_cache_shape(path) == (2, 8, 8, 16, 7)
    loader = wp.WellPackLoader(path, 2, 2, batch_size=1, device="cpu")
    for i, batch in enumerate(loader):
        np.testing.assert_array_equal(batch["input"][0].numpy(), got[i]["input"])
        np.testing.assert_array_equal(batch["output"][0].numpy(), got[i]["output"])
    assert i + 1 == len(got)


def test_loader_sharding_keeps_this_ranks_part(caches):
    kw = dict(n_steps_input=4, n_steps_output=2, batch_size=4, shuffle=True, seed=1,
              device="cpu")
    whole = list(wp.WellPackLoader(caches[1], **kw))
    parts = [list(wp.WellPackLoader(caches[1], sharding=BatchSlice(2, i, 2, 0), **kw))
             for i in range(2)]
    for i, full in enumerate(whole):
        for k in ("input", "output"):
            assert parts[0][i][k].shape[:3] == (2, full[k].shape[1], 16)
            np.testing.assert_array_equal(torch.cat([p[i][k] for p in parts]).numpy(),
                                          full[k][:, :, :16].numpy())


def test_datamodule_wellpack_integration(well_root, tmp_path):
    kw = dict(base_path=well_root, dataset_name=NAME, batch_size=2, n_steps_input=4,
              n_steps_output=2, eval_steps_output=4, data_workers=2, seed=4)
    dm = TanteDataModule(use_wellpack=True, wellpack_cache_dir=str(tmp_path / "cache"),
                         device="cpu", **kw)
    plain = TanteDataModule(device="cpu", **kw)
    for split in ("train", "val", "test"):
        loader = getattr(dm, f"{split}_dataloader")()
        assert isinstance(loader, wp.WellPackLoader)
        for a, b in zip(getattr(plain, f"{split}_dataloader")(), loader, strict=True):
            for k in ("input", "output"):
                np.testing.assert_array_equal(b[k].numpy(), a[k].numpy())
    assert sorted(p.name for p in (tmp_path / "cache").iterdir()) == [
        "test_4.wpk", "train_2.wpk", "valid_4.wpk"]
    assert next(iter(dm.val_dataloader()))["output"].shape == (2, 4, 32, 64, 3)


def test_datamodule_falls_back_to_the_python_loader(well_root, tmp_path, monkeypatch):
    monkeypatch.setattr(wp, "get_library", lambda: None)
    dm = TanteDataModule(base_path=well_root, dataset_name=NAME, batch_size=2, n_steps_input=4,
                         n_steps_output=2, use_wellpack=True, device="cpu",
                         wellpack_cache_dir=str(tmp_path / "cache"))
    assert isinstance(dm.train_dataloader(), DataLoader)
    with pytest.raises(RuntimeError, match="native wellpack"):
        wp.WellPackLoader(str(tmp_path / "none.wpk"), 4, 2, device="cpu")


def test_a_partial_cache_is_refused(caches, tmp_path):
    raw = read(caches[1])
    for name, data in (("short.wpk", raw[:-4]), ("header.wpk", raw[:20]),
                       ("magic.wpk", b"\0" * 8 + raw[8:])):
        (tmp_path / name).write_bytes(data)
        with pytest.raises(IOError):
            wp.WellPackLoader(str(tmp_path / name), 4, 2, device="cpu")


def test_loader_runs_on_the_card_unless_asked_for_the_cpu(caches):
    if torch.cuda.is_available():
        assert wp.WellPackLoader(caches[1], 4, 2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            wp.WellPackLoader(caches[1], 4, 2)


def test_libraries_build_into_build_and_leave_native_alone(caches):
    tracked = ("wellpack.cpp", "wellpack_h5.cpp", "Makefile")
    sources = {name: hashlib.sha256((ROOT / "native" / name).read_bytes()).hexdigest()
               for name in tracked}
    wp._libs.clear()  # load again through the build step
    libs = [wp.get_library(), wp.get_h5_library()]
    for lib, stem in zip(libs, ("wellpack", "wellpack_h5")):
        assert lib is not None
        path = Path(lib._name)
        assert path.parent == ROOT / "build" / "native" == wp.BUILD_DIR
        assert path.name.startswith(stem + "_") and path.exists()
        assert not (ROOT / "native" / path.name).exists()
    after = {name: hashlib.sha256((ROOT / "native" / name).read_bytes()).hexdigest()
             for name in tracked}
    assert after == sources
