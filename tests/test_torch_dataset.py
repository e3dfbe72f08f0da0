"""Port parity: the HDF5 data layer (``tante_tpu_torch/data/dataset.py``,
``datamodule.py:TanteDataModule``, ``synthetic.py:make_well_dataset``)
against the JAX package's (the counterpart of ``tests/test_data.py``), on the
CPU.  Everything is exact: the same h5py reads and the same numpy arithmetic,
so every item and batch equals JAX's, max abs 0."""

import os

import numpy as np
import pytest
import torch

from tante_tpu.data.datamodule import TanteDataModule as JaxDataModule
from tante_tpu.data.dataset import TanteDataset as JaxDataset
from tante_tpu.data.synthetic import make_well_dataset as jax_make_well_dataset
from tante_tpu_torch.data import TanteDataModule, TanteDataset, compute_windows, make_well_dataset
from tante_tpu_torch.data.loader import DataLoader
from tante_tpu_torch.parallel.mesh import BatchSlice

NAME = "synthetic_waves"


def both(base, split="train", name=NAME, **kw):
    return (JaxDataset(base_path=base, dataset_name=name, split_name=split, **kw),
            TanteDataset(base_path=base, dataset_name=name, split_name=split, **kw))


def assert_same_items(ref, got, indices=None):
    assert len(got) == len(ref) > 0
    for i in range(len(ref)) if indices is None else indices:
        a, b = ref[i], got[i]
        assert a.keys() == b.keys() == {"input", "output"}
        for k in a:
            assert b[k].dtype == np.float32 and b[k].shape == a[k].shape
            np.testing.assert_array_equal(b[k], a[k])


@pytest.mark.parametrize("split,n_in,n_out,stride", [
    ("train", 4, 2, 1), ("valid", 4, 4, 1), ("test", 2, 1, 2), ("train", 3, 2, 3)])
def test_items_and_metadata_equal_jax(well_root, split, n_in, n_out, stride):
    ref, got = both(well_root, split, n_steps_input=n_in, n_steps_output=n_out,
                    dt_stride=stride)
    assert vars(got.metadata) == vars(ref.metadata)
    assert got.metadata.n_fields == 3 and got.metadata.spatial_resolution == (32, 64)
    assert got.metadata.field_names == {0: ["density"], 1: ["velocity_x", "velocity_y"], 2: []}
    assert len(got) == 3 * compute_windows(24, n_in, n_out, stride)
    assert got.files_paths == ref.files_paths
    assert_same_items(ref, got)
    with pytest.raises(IndexError):
        got[len(got)]


def test_dt_stride_takes_every_other_frame(well_root):
    _, strided = both(well_root, n_steps_input=2, n_steps_output=1, dt_stride=2)
    _, dense = both(well_root, n_steps_input=4, n_steps_output=1, dt_stride=1)
    np.testing.assert_array_equal(strided[0]["input"][1], dense[0]["input"][2])
    np.testing.assert_array_equal(strided[0]["output"][0], dense[0]["output"][0])


def test_multi_file_indexing(tmp_path):
    jax_make_well_dataset(str(tmp_path), dataset_name="multi", splits=("train",),
                          n_files_per_split=3, n_trajectories=2, n_steps=12, resolution=(8, 16),
                          seed=5)
    ref, got = both(str(tmp_path), name="multi", n_steps_input=2, n_steps_output=1)
    windows = compute_windows(12, 2, 1, 1)
    assert len(got) == 3 * 2 * windows and got.metadata.n_files == 3
    assert got.file_index_offsets == ref.file_index_offsets
    assert_same_items(ref, got)
    assert not np.allclose(got[0]["input"], got[2 * 2 * windows]["input"])  # third file


@pytest.mark.parametrize("include,exclude,n_files", [
    ([], [], 3), (["train_0"], [], 1), ([], ["train_0"], 2), (["train_1", "train_2"], [], 2),
    (["train_1", "train_2"], ["train_2"], 1)])
def test_include_exclude_filters(tmp_path, include, exclude, n_files):
    jax_make_well_dataset(str(tmp_path), dataset_name="filt", splits=("train",),
                          n_files_per_split=3, n_trajectories=1, n_steps=8, resolution=(8, 16))
    kw = dict(n_steps_input=2, n_steps_output=1, include_filters=include,
              exclude_filters=exclude)
    ref, got = both(str(tmp_path), name="filt", **kw)
    assert got.metadata.n_files == ref.metadata.n_files == n_files
    assert got.files_paths == ref.files_paths
    assert_same_items(ref, got)
    with pytest.raises(FileNotFoundError):
        TanteDataset(base_path=str(tmp_path), dataset_name="filt", include_filters=["nothing"])


@pytest.mark.parametrize("resolution", [(8, 16), (4, 6, 5)])
def test_t2_tensor_fields(tmp_path, resolution):
    jax_make_well_dataset(str(tmp_path), dataset_name="t2set", splits=("train",),
                          n_trajectories=2, n_steps=8, resolution=resolution, with_t2=True)
    ref, got = both(str(tmp_path), name="t2set", n_steps_input=2, n_steps_output=1)
    d = len(resolution)
    assert got.metadata.n_fields == 1 + d + d * d
    assert vars(got.metadata) == vars(ref.metadata)
    if d == 2:
        assert got.metadata.field_names[2] == ["stress_xx", "stress_xy", "stress_yx", "stress_yy"]
    assert_same_items(ref, got)


def test_normalisation_by_stats_with_clipped_std(tmp_path):
    """Non-trivial stats.yaml: per-field means, a per-component std and one
    std below ``min_std`` (clipped)."""
    import yaml

    jax_make_well_dataset(str(tmp_path), dataset_name="st", splits=("train",),
                          n_trajectories=2, n_steps=8, resolution=(8, 16), with_pressure=True)
    stats = {"mean": {"density": 0.25, "pressure": -0.5, "velocity": [0.1, -0.2]},
             "std": {"density": 2.0, "pressure": 1e-7, "velocity": [0.5, 3.0]}}
    with open(os.path.join(tmp_path, "st", "stats.yaml"), "w") as f:
        yaml.safe_dump(stats, f)
    ref, got = both(str(tmp_path), name="st", n_steps_input=3, n_steps_output=2)
    assert float(got.stds["pressure"]) == pytest.approx(1e-4)
    assert_same_items(ref, got)


def test_remote_uri_through_fsspec(well_root):
    """A non-local path reads through an fsspec blockcache (here memory://)."""
    import fsspec

    mem = fsspec.filesystem("memory")
    base = os.path.join(well_root, NAME)
    for root, _dirs, files in os.walk(base):
        for fname in files:
            src = os.path.join(root, fname)
            with open(src, "rb") as f:
                mem.pipe_file("/torch_remote_well/" + NAME + src[len(base):], f.read())
    local, _ = both(well_root, n_steps_input=4, n_steps_output=2)
    remote = TanteDataset(base_path="memory://torch_remote_well", dataset_name=NAME,
                          split_name="train", n_steps_input=4, n_steps_output=2)
    assert all(p.startswith("memory://") for p in remote.files_paths)
    assert_same_items(local, remote, indices=[0, 3, len(local) - 1])
    remote.close()


def dm_kw(root, **kw):
    return dict(base_path=root, dataset_name=NAME, batch_size=2, n_steps_input=4,
                n_steps_output=2, eval_steps_output=4, data_workers=2, seed=3, **kw)


def test_datamodule_loaders_equal_jax_and_shuffle_deterministically(well_root):
    ref, got = JaxDataModule(**dm_kw(well_root)), TanteDataModule(**dm_kw(well_root),
                                                                   device="cpu")
    assert got.val_dataset.n_steps_output == got.test_dataset.n_steps_output == 4
    assert got.train_dataset.n_steps_output == 2
    for split in ("train", "val", "test"):
        jl, tl = getattr(ref, f"{split}_dataloader")(), getattr(got, f"{split}_dataloader")()
        assert isinstance(tl, DataLoader) and len(tl) == len(jl) > 0
        epochs = []
        for epoch in (1, 2):
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            jb, tb = list(jl), list(tl)
            assert len(tb) == len(jb) == len(tl)
            for a, b in zip(jb, tb):
                for k in ("input", "output"):
                    assert isinstance(b[k], torch.Tensor) and b[k].device.type == "cpu"
                    np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))
            epochs.append(np.concatenate([b["input"].numpy().ravel() for b in tb]))
        # train and val shuffle per epoch (the reference shuffles val too); test does not
        assert (split != "test") == (not np.array_equal(epochs[0], epochs[1]))


def test_datamodule_sharding_slices_each_global_batch(well_root):
    """Under a mesh each rank's loader keeps its block of every global batch
    (and of H over 'sp'); the ranks' parts reassemble the global batch."""
    whole = TanteDataModule(**dm_kw(well_root, rank=0), device="cpu")
    parts = []
    for dp_index in range(2):
        dm = TanteDataModule(**dm_kw(well_root), device="cpu")
        dm.sharding = BatchSlice(dp=2, dp_index=dp_index, sp=2, sp_index=1)
        parts.append(list(dm.train_dataloader()))
    for i, full in enumerate(whole.train_dataloader()):
        for k in ("input", "output"):
            assert parts[0][i][k].shape[0] == 1 and parts[0][i][k].shape[2] == 16
            np.testing.assert_array_equal(
                torch.cat([parts[0][i][k], parts[1][i][k]]).numpy(), full[k][:, :, 16:].numpy())


def test_datamodule_runs_on_the_card_unless_asked_for_the_cpu(well_root):
    if torch.cuda.is_available():
        assert TanteDataModule(**dm_kw(well_root)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TanteDataModule(**dm_kw(well_root))


def test_too_short_trajectories_raise(well_root):
    with pytest.raises(ValueError, match="not enough"):
        TanteDataset(base_path=well_root, dataset_name=NAME, n_steps_input=20, n_steps_output=8)


CASES = {
    "2d_pressure_3_files": dict(n_files_per_split=3, n_trajectories=2, n_steps=10,
                                resolution=(8, 12), with_pressure=True, seed=3),
    "2d_t2_ramp": dict(n_trajectories=3, n_steps=9, resolution=(6, 8), with_t2=True,
                       difficulty_ramp=True, seed=1),
    "3d_t2": dict(n_trajectories=2, n_steps=8, resolution=(4, 6, 5), with_t2=True, seed=7),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_writer_read_back_by_jax(tmp_path, case):
    """The port's ``make_well_dataset`` writes the JAX writer's tree: every
    dataset, attribute and ``stats.yaml`` the same, so JAX's reader gives the
    same items from either."""
    import h5py
    import yaml

    kw = CASES[case]
    a = jax_make_well_dataset(str(tmp_path / "jax"), dataset_name="w", **kw)
    b = make_well_dataset(str(tmp_path / "port"), dataset_name="w", **kw)
    with open(os.path.join(a, "stats.yaml")) as fa, open(os.path.join(b, "stats.yaml")) as fb:
        assert yaml.safe_load(fb) == yaml.safe_load(fa)
    for split in ("train", "valid", "test"):
        names = sorted(os.listdir(os.path.join(a, "data", split)))
        assert sorted(os.listdir(os.path.join(b, "data", split))) == names
        for name in names:
            with h5py.File(os.path.join(a, "data", split, name)) as fa, \
                    h5py.File(os.path.join(b, "data", split, name)) as fb:
                seen = []

                def same(path, obj):
                    seen.append(path)
                    other = fb[path]
                    assert set(other.attrs) == set(obj.attrs), path
                    for key in obj.attrs:
                        np.testing.assert_array_equal(other.attrs[key], obj.attrs[key])
                    if isinstance(obj, h5py.Dataset):
                        assert other.dtype == obj.dtype and other.shape == obj.shape, path
                        np.testing.assert_array_equal(other[()], obj[()])

                same("/", fa["/"])
                fa.visititems(same)
                count = []
                fb.visit(count.append)
                assert len(count) == len(seen) - 1  # no object the JAX file lacks
        ref = JaxDataset(base_path=str(tmp_path / "jax"), dataset_name="w", split_name=split,
                         n_steps_input=2, n_steps_output=2)
        got = JaxDataset(base_path=str(tmp_path / "port"), dataset_name="w", split_name=split,
                         n_steps_input=2, n_steps_output=2)
        assert vars(got.metadata) == vars(ref.metadata)
        assert_same_items(ref, got)
