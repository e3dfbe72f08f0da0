"""The plain reference against the port at a tiny size on the CPU (this test
may import the port; the reference may not)."""

from __future__ import annotations

import ast

import numpy as np
import pytest
import torch

from conftest import BENCH, WORKLOADS, tiny

from models import tante as adapter
from reference import tante as ref


def _model(cfg):
    from tante_tpu_torch.convert import load_jax_params

    return adapter._program_model(cfg), load_jax_params


@pytest.mark.parametrize("workload", WORKLOADS)
def test_parameters_are_the_ports(workload):
    _, cfg, _, _ = tiny(workload)
    res, n_fields = adapter.geometry(cfg)
    model, _ = _model(cfg)
    own = {k.replace(".", "/"): tuple(v.shape) for k, v in model.state_dict().items()}
    assert own == ref.param_shapes(cfg["model"], res, n_fields)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_rollout_matches_the_port(workload):
    _, cfg, tf, _ = tiny(workload)
    w = adapter.weights(cfg, 7, "cpu")
    pred = adapter.predictor(cfg, w, "cpu")
    res, _ = adapter.geometry(cfg)
    g = torch.Generator().manual_seed(3)
    hist = torch.rand((2, 4, *res, 4), generator=g) * 2 - 1
    got = adapter.rollout_call(pred, tf)(hist)
    want = adapter.reference_rollout(cfg, w, hist, tf)
    numbers = adapter.compare_rollout(got, want)
    assert numbers["frames_rel_l2"] < 1e-6
    if tf["api"] == "rollout_adaptive":
        assert numbers["calls_gap"] == 0 and numbers["rt_gap"] < 1e-6


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -12, 3.0e-20])
    y = ref.tf32_round(x)
    assert y.tolist()[:4] == [1.0, 1.0, 1.0 + 4 * 2 ** -11, -1.0]
    bits = y.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    z = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    rel = ((ref.tf32_round(z) - z).abs() / z.abs()).max()
    assert 0 < float(rel) <= 2 ** -11


def test_reference_imports_nothing_of_the_program():
    """The reference and its counts import torch, numpy and the standard
    library alone."""
    allowed = {"__future__", "contextlib", "math", "typing", "torch", "numpy"}
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in allowed, f"{path.name} imports {name}"


def test_weights_follow_the_seed():
    _, cfg, _, _ = tiny("tante-fixed16-trl")
    a, b, c = (adapter.weights(cfg, s, "cpu") for s in (2 ** 40 + 1, 2 ** 40 + 1, 2 ** 40 + 2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks_0/block_0/wq"], c["blocks_0/block_0/wq"])
    assert np.allclose(float(a["blocks_0/block_0/ln1_scale"].mean()), 1.0, atol=0.05)
