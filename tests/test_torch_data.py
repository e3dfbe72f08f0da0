"""Port parity: the in-memory synthetic data layer (``tante_tpu_torch.data``)
against the JAX package's HDF5 one, on the CPU.  Everything here is exact:
the port draws the same random numbers in the same order, builds the same
f32 fields and uses the same window and shuffle arithmetic."""

import numpy as np
import pytest
import torch

from tante_tpu.data.dataset import TanteDataset
from tante_tpu.data.loader import DataLoader as JaxLoader
from tante_tpu.data.synthetic import make_well_dataset
from tante_tpu_torch.data.datamodule import WaveDataModule, get_formatter
from tante_tpu_torch.data.loader import DataLoader
from tante_tpu_torch.data.synthetic import (
    WaveDataset, compute_windows, make_well_arrays, wave_field_names,
)

CASES = {
    "2d_pressure": dict(resolution=(8, 12), n_trajectories=3, n_steps=10, with_pressure=True,
                        n_files_per_split=2, seed=3),
    "2d_t2_ramp": dict(resolution=(6, 8), n_trajectories=2, n_steps=9, with_t2=True,
                       difficulty_ramp=True, seed=1),
    "3d": dict(resolution=(4, 6, 5), n_trajectories=2, n_steps=8, seed=7),
}


def both(tmp_path, kw, split, n_in, n_out, stride):
    make_well_dataset(str(tmp_path), dataset_name="waves", **kw)
    ref = TanteDataset(str(tmp_path), "waves", split, n_steps_input=n_in, n_steps_output=n_out,
                       dt_stride=stride)
    arrays = make_well_arrays(**kw)
    names = wave_field_names(len(kw["resolution"]), kw.get("with_t2", False),
                             kw.get("with_pressure", False))
    return ref, WaveDataset(arrays[split], names, n_in, n_out, stride, "waves")


@pytest.mark.parametrize("case,split,n_in,n_out,stride", [
    ("2d_pressure", "train", 4, 2, 1),
    ("2d_pressure", "test", 2, 1, 2),   # the last split drawn: the rng order matters most
    ("2d_t2_ramp", "valid", 3, 2, 1),
    ("3d", "valid", 2, 2, 2),
])
def test_wave_dataset_equals_hdf5_dataset_item_by_item(tmp_path, case, split, n_in, n_out, stride):
    ref, got = both(tmp_path, CASES[case], split, n_in, n_out, stride)
    assert len(got) == len(ref) > 0
    assert vars(got.metadata) == vars(ref.metadata)
    for i in range(len(ref)):
        a, b = ref[i], got[i]
        assert a.keys() == b.keys()
        for k in a:
            assert b[k].dtype == np.float32 and b[k].shape == a[k].shape
            np.testing.assert_array_equal(b[k], a[k])
    with pytest.raises(IndexError):
        got[len(ref)]


def test_window_count_and_too_short_trajectory():
    assert compute_windows(10, 4, 2, 1) == 5
    assert compute_windows(10, 2, 1, 2) == 6
    arrays = make_well_arrays(splits=("train",), n_steps=5, resolution=(4, 4))
    with pytest.raises(ValueError):
        WaveDataset(arrays["train"], wave_field_names(2), 4, 2)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_loader_batch_order_matches_jax_loader(tmp_path, shuffle, drop_last):
    ref, got = both(tmp_path, CASES["2d_pressure"], "train", 4, 2, 1)
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last, num_workers=2, seed=5)
    jl, tl = JaxLoader(ref, **kw), DataLoader(got, device="cpu", **kw)
    assert len(tl) == len(jl)
    seen = []
    for epoch in (1, 2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb) == len(tl)
        for a, b in zip(jb, tb):
            for k in ("input", "output"):
                assert isinstance(b[k], torch.Tensor) and b[k].dtype == torch.float32
                np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))
        seen.append(np.concatenate([b["input"].numpy().ravel() for b in tb]))
    assert shuffle == (not np.array_equal(seen[0], seen[1]))  # set_epoch reshuffles


def test_loader_needs_a_card_unless_asked_for_the_cpu():
    arrays = make_well_arrays(splits=("train",), resolution=(4, 4), n_steps=8)
    ds = WaveDataset(arrays["train"], wave_field_names(2), 2, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            DataLoader(ds, batch_size=2)
        with pytest.raises(RuntimeError):
            WaveDataModule(batch_size=2, waves=dict(resolution=(4, 4), n_steps=8))
    assert len(DataLoader(ds, batch_size=2, device="cpu")) == len(ds) // 2


def test_loader_hands_a_worker_error_to_the_consumer_and_stops_early():
    class Broken:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise KeyError("item 5")
            return {"input": np.full((1, 2), i, np.float32)}

    with pytest.raises(KeyError):
        list(DataLoader(Broken(), batch_size=2, device="cpu", num_workers=2))
    it = iter(DataLoader(Broken(), batch_size=2, device="cpu", prefetch=1))
    assert next(it)["input"].shape == (2, 1, 2)
    it.close()  # abandoning the iterator must not hang on the bounded queue


def test_datamodule_splits_and_formatter():
    dm = WaveDataModule(batch_size=2, n_steps_input=4, n_steps_output=1, eval_steps_output=3,
                        device="cpu", waves=dict(resolution=(8, 8), n_trajectories=2,
                                                 n_steps=12, with_pressure=True, seed=2))
    assert dm.train_dataset.n_steps_output == 1 and dm.val_dataset.n_steps_output == 3
    assert dm.train_dataset.metadata.n_fields == 4
    batch = next(iter(dm.test_dataloader()))
    assert batch["input"].shape == (2, 4, 8, 8, 4) and batch["output"].shape == (2, 3, 8, 8, 4)
    np.testing.assert_array_equal(batch["input"][1].numpy(), dm.test_dataset[1]["input"])
    fmt = get_formatter("channels_last_default", dm.train_dataset.metadata)
    bad = {"input": torch.tensor([[float("nan"), 1.0]]), "output": torch.tensor([[2.0, float("nan")]])}
    (x,), y = fmt.process_input(bad)
    assert x.tolist() == [[0.0, 1.0]] and y.tolist() == [[2.0, 0.0]]
    assert type(get_formatter("channels_first_default", None)).__name__.endswith("FirstFormatter")
    with pytest.raises(ValueError):
        get_formatter("nchw", None)
