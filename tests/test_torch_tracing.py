"""The port's spans and counters (``tante_tpu_torch/utils/profiling.py``) on
the serving, model-call and set-up paths, on the CPU, on a tiny TANTE.

Off (no ``record()``), a span is one shared null context and a rollout's
outputs are those of a recorded one, bit for bit.  On, each rollout is one
``serve.rollout`` tree whose spans nest inside their parents' intervals,
with the model-call and host-sync counts the rollout makes."""

import math
import sys
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

from tante_tpu_torch.config import instantiate
from tante_tpu_torch.convert import seeded_jax_params
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.ops import _build
from tante_tpu_torch.serve import Predictor
from tante_tpu_torch.train.rollout import rollout_adaptive_eval_tante
from tante_tpu_torch.utils import profiling
from tante_tpu_torch.utils.profiling import count, record, span

torch.set_num_threads(2)

B, T, H, W, F = 2, 4, 32, 64, 4
NODE = {"_target_": "models.TANTE", "in_T": T, "taylor_order": 1, "attn_axes": "THW",
        "embed_dim": 32, "patch_scale": 8, "n_head": 4, "mlp_ratio": 1.0}
# Adaptive: r_t = clip(2.6, 0, K - 1) + 1.001 = 3.601 -> 3 frames a call at K 4,
# so 7 frames take 3 calls (2 with the whole 4-frame block forced).
RT_BIAS, K, N_ADAPTIVE = 2.6, 4, 7
HEAD_PARTS = ("tante.embed", "tante.blocks", "tante.decode", "tante.taylor")


def _metadata():
    return TanteMetadata(dataset_name="t", n_spatial_dims=2, spatial_resolution=(H, W),
                         field_names={0: ["f"] * F, 1: [], 2: []},
                         boundary_condition_types=["PERIODIC"], n_files=1,
                         n_trajectories_per_file=[1], n_steps_per_trajectory=[32], n_fields=F)


def _predictor(deg: bool, output_length: int = 2) -> Predictor:
    model = instantiate({**NODE, "deg": deg, "output_length": output_length},
                        dset_metadata=_metadata(), seed=0, device="cpu")
    flat = seeded_jax_params(model, 3)
    if not deg:
        flat["interprators_0/TorchDense_2/Dense_0/kernel"][:] = 0.0
        flat["interprators_0/TorchDense_2/Dense_0/bias"][:] = RT_BIAS
    return Predictor.from_numpy(model, flat, device="cpu")


def _history(seed=5):
    return torch.from_numpy(
        np.random.default_rng(seed).normal(size=(B, T, H, W, F)).astype(np.float32))


def _names(spans):
    return [s.name for s in spans]


def _check_nesting(spans):
    """Every span closed, inside its parent's interval, its parent opened
    before it; -> each span's root index (its request id)."""
    roots = []
    for i, s in enumerate(spans):
        assert s.end_ns is not None and s.start_ns <= s.end_ns, s
        if s.parent < 0:
            roots.append(i)
            continue
        p = spans[s.parent]
        assert s.parent < i and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
        roots.append(roots[s.parent])
    return roots


def test_span_off_is_one_null_context_and_records_nothing():
    assert profiling._record is None
    assert span("a") is span("b") is profiling._NULL
    count("model_calls")
    with span("a"), span("b"):
        pass
    with record() as rec:
        pass
    assert rec.spans == [] and not rec.counters
    assert span("a") is profiling._NULL


@pytest.mark.parametrize("deg", [True, False])
def test_recording_leaves_the_outputs_bit_identical(deg):
    pred = _predictor(deg)
    x = _history()
    call = ((lambda: pred.rollout(x, 5)) if deg
            else (lambda: pred.rollout_adaptive(x, N_ADAPTIVE, max_frames_per_call=K)[0]))
    off = call()
    with record() as rec:
        on = call()
    assert rec.spans and torch.equal(off, on)


def test_fixed_rollout_spans_and_counts():
    pred = _predictor(True, output_length=2)
    n_steps, calls = 5, math.ceil(5 / 2)
    with record() as rec:
        y = pred.rollout(_history(), n_steps)
    spans, counters = rec.take()
    assert y.shape == (B, n_steps, H, W, F)
    names = _names(spans)
    assert names[0] == "serve.rollout" and names.count("serve.rollout") == 1
    assert names.count("tante.head") == calls
    assert names.count("tante.encode") == calls + 1
    assert "tante.interprator" not in names and "rollout.read_rt" not in names
    assert set(_check_nesting(spans)) == {0}  # one request: the serve.rollout root
    for i, s in enumerate(spans):
        if s.name == "tante.head":
            parts = [c.name for c in spans if c.parent == i]
            assert parts == list(HEAD_PARTS)
        if s.name in ("tante.head", "tante.encode"):
            assert s.parent == 0
    assert counters["model_calls"] == calls and counters["host_syncs"] == 0


def test_adaptive_rollout_spans_and_counts():
    pred = _predictor(False)
    with record() as rec:
        y, rt, n_calls = pred.rollout_adaptive(_history(), N_ADAPTIVE, max_frames_per_call=K)
    spans, counters = rec.take()
    assert n_calls == 3 and y.shape == (B, N_ADAPTIVE, H, W, F) and len(rt) == 3
    names = _names(spans)
    assert names.count("serve.rollout") == 1 and names.count("serve.read_log") == 1
    assert names.count("tante.head") == names.count("tante.interprator") == n_calls
    assert names.count("tante.encode") == n_calls  # the window is re-encoded each call
    assert names.count("rollout.read_rt") == n_calls
    assert set(_check_nesting(spans)) == {0}
    for i, s in enumerate(spans):
        if s.name == "tante.head":
            assert [c.name for c in spans if c.parent == i] == [
                "tante.embed", "tante.blocks", "tante.interprator", "tante.decode",
                "tante.taylor"]
        if s.name in ("rollout.read_rt", "serve.read_log"):
            assert spans[s.parent].name == "serve.rollout"
    # r_t read after each call, and the log read once.
    assert counters["model_calls"] == n_calls and counters["host_syncs"] == n_calls + 1


def test_force_budget_reads_nothing():
    pred = _predictor(False)
    with record() as rec, torch.inference_mode():
        _, _, n_calls = rollout_adaptive_eval_tante(pred.model, _history(), N_ADAPTIVE, K,
                                                    force_budget=True)
    spans, counters = rec.take()
    assert n_calls == 2 and "rollout.read_rt" not in _names(spans)
    assert counters["host_syncs"] == 0 and counters["model_calls"] == n_calls


def test_setup_spans_once_each():
    with record() as rec:
        _predictor(True)
    spans, counters = rec.take()
    names = _names(spans)
    for name in ("tante.init", "serve.load_weights", "serve.place"):
        assert names.count(name) == 1, names
    assert all(s.parent == -1 for s in spans)
    assert not counters


def test_ops_load_spans_a_library_once(monkeypatch):
    built = []

    def build(kernels):
        built.extend(kernels)
        return {k: {"library": f"/nowhere/{k}.so"} for k in kernels}

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: mock.MagicMock(name=path))
    with record() as rec:
        first = _build.load("fused_block_sm90")
        assert _build.load("fused_block_sm90") is first
        _build.load("spectral_matmul")
        _build.load("fused_block_sm90")
    spans, _ = rec.take()
    assert _names(spans) == ["ops.load", "ops.load"]
    assert built == ["fused_block_sm90", "spectral_matmul"]


def test_spans_are_on_the_wall_clock():
    t0 = time.time_ns()
    with record() as rec, span("outer"):
        time.sleep(0.001)
    t1 = time.time_ns()
    (s,) = rec.spans
    assert t0 <= s.start_ns and s.end_ns <= t1 and s.end_ns - s.start_ns >= 1_000_000


def test_take_cuts_the_record_and_refuses_an_open_span():
    with record() as rec:
        with span("a"):
            with pytest.raises(RuntimeError):
                rec.take()
            count("c", 2)
        first = rec.take()
        with span("b"), span("c"):
            pass
        second = rec.take()
        with pytest.raises(RuntimeError):
            with record():
                pass
    assert _names(first[0]) == ["a"] and first[1] == {"c": 2}
    assert [tuple(s)[::3] for s in second[0]] == [("b", -1), ("c", 0)] and not second[1]
    assert profiling._record is None and span("x") is profiling._NULL


def test_threads_keep_their_own_parents():
    """More threads than cores, a short switch interval: every child's
    parent is its own thread's outer span, and no count is lost."""
    n_threads, n_iter = 12, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with record() as rec:
            def work(t):
                for _ in range(n_iter):
                    with span(f"outer{t}"):
                        count("n")
                        with span(f"inner{t}"):
                            pass

            threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
            spans, counters = rec.take()
    finally:
        sys.setswitchinterval(interval)
    assert counters["n"] == n_threads * n_iter and len(spans) == 2 * n_threads * n_iter
    for s in spans:
        if s.name.startswith("inner"):
            assert spans[s.parent].name == "outer" + s.name[len("inner"):]
        else:
            assert s.parent == -1
