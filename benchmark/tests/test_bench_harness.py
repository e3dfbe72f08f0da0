"""The harness: discovery by name, the statistics, the import check, the
trace's reduction, and BENCHMARK.json against its contract."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest
import torch
import yaml

from conftest import BENCH, WORKLOADS, tiny

from harness import core, trace, waves

ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def spec():
    return core.load_spec()


# -- discovery ------------------------------------------------------------------

@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_finds_its_files(spec, workload):
    cell = core.find_cell(spec, workload)
    config, traffic = core.config_of(cell), core.traffic_of(cell)
    assert config["family"] == "tante" and traffic["kind"] == "rollout"
    adapter, runner = core.adapter_of(config), core.runner_of(traffic)
    assert callable(adapter.weights) and callable(runner.run)
    assert core.limits_of(workload)
    for trace_on in (False, True):
        for m in core.metrics_for(spec, workload, trace_on):
            assert callable(core.reader_of(m["name"]).read)


def test_metrics_for_selects_by_cell(spec):
    fixed, adaptive = WORKLOADS
    names = lambda w, t, sp=spec: {m["name"] for m in core.metrics_for(sp, w, t)}  # noqa: E731
    assert names(fixed, False) == {"frames_per_s", "rollout_p95_ms", "setup_s"}
    assert {"block_roofline.rollout", "mfu.rollout"} <= names(fixed, True)
    assert names(adaptive, False) == {"frames_per_s.adaptive", "setup_s"}
    assert {"rollout_p95_ms.adaptive", "mfu.adaptive"} <= names(adaptive, True)
    # A per-layer metric that lists no cells applies where the end-to-end
    # metric it moves is reported.
    extra = dict(spec, end_to_end=spec["end_to_end"] + [
        {"name": "y_ms", "unit": "ms", "better": "lower", "bound": 0.05, "source": "host_clock",
         "workloads": [adaptive]}], per_layer=spec["per_layer"] + [
        {"name": "x", "unit": "%", "better": "higher", "source": "device_trace", "layer": "l",
         "moves": "y_ms"}])
    assert "y_ms" in names(adaptive, False, extra) and "y_ms" not in names(fixed, False, extra)
    assert "x" in names(adaptive, True, extra) and "x" not in names(fixed, True, extra)


def test_a_split_metric_finds_its_quantitys_reader():
    assert core.reader_of("frames_per_s.adaptive").__file__.endswith("frames_per_s.py")
    assert core.reader_of("mfu.rollout").__file__.endswith("mfu.py")
    with pytest.raises(FileNotFoundError):
        core.reader_of("no_such_metric.rollout")


def test_unknown_workload(spec):
    with pytest.raises(KeyError):
        core.find_cell(spec, "no-such-cell")


@pytest.mark.parametrize("name", ["tante", "tante_adaptive"])
def test_configuration_is_the_shipped_yaml(name):
    """The file's nodes are the repository YAML's but for the keys it lists
    as reduced."""
    cfg = core.read_json(BENCH / "configs" / f"{name}.json")
    shipped = yaml.safe_load(open(ROOT / cfg["yaml"]))
    for node in ("model", "optimizer", "lr_scheduler", "trainer"):
        for key in set(shipped[node]) | set(cfg[node]):
            if key not in cfg["reduced"]:
                assert cfg[node].get(key) == shipped[node].get(key), (node, key)
    assert cfg["seed"] == shipped["seed"]


# -- statistics -------------------------------------------------------------------

def test_percentile_and_rate_with_a_stall():
    """199 rollouts of 200 ms and one stalled for 2 s: the rate counts all
    the window's time, the p95 sits on the plain rollouts, the p99.9 on the
    stall."""
    lat = [0.2] * 199 + [2.0]
    run = core.Run(kind="rollout", config={}, traffic={}, adapter=None, peaks=None,
                   attempted=200, latencies_s=lat, window_s=sum(lat), frames_per_unit=256)
    fps = core.load_module(BENCH / "metrics" / "frames_per_s.py").read(run)
    p95 = core.load_module(BENCH / "metrics" / "rollout_p95_ms.py").read(run)
    assert fps == pytest.approx(200 * 256 / 41.8)
    assert p95 == pytest.approx(200.0)
    assert core.percentile(lat, 99.9) == pytest.approx(0.2 + 0.801 * 1.8)
    assert core.percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5


def test_worst_keeps_nan():
    assert core.worst(1.0, 2.0) == 2.0
    assert core.worst(1.0, float("nan")) != core.worst(1.0, float("nan"))


def test_derived_seeds():
    big = 2 ** 31 + 12345
    assert core.derived_seed(big, "a") == core.derived_seed(big, "a")
    assert core.derived_seed(big, "a") != core.derived_seed(big, "b")
    assert 0 <= core.derived_seed(-5, "a") < 2 ** 63 and 0 <= core.derived_seed(2 ** 80, "a")


# -- traffic -----------------------------------------------------------------------

def test_traffic_follows_the_seed(spec):
    tf = dict(core.traffic_of(core.find_cell(spec, WORKLOADS[0])), batch=3)
    a, b, c = (waves.trajectories(tf, s, (8, 16), 4, "cpu")
               for s in (2 ** 31 + 3, 2 ** 31 + 3, 2 ** 33 + 9))
    assert len(a) == tf["batches"] and a[0].shape == (3, 4, 8, 16, 4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not any(torch.equal(x, y) for x, y in zip(a, c))


def test_calls_survey_counts_every_rollout():
    _, cfg, tf, _ = tiny(WORKLOADS[1])
    survey = core.load_module(BENCH / "calibrate.py").calls_survey(cfg, tf, 2, 2 ** 31 + 1, "cpu")
    assert survey["rollouts"] == 2 * tf["batches"] == sum(survey["calls_per_rollout"].values())
    assert all(1 <= int(c) <= tf["n_steps"] for c in survey["calls_per_rollout"])


# -- the import check -------------------------------------------------------------

def test_forbidden_names_are_whole_words():
    names = ["tante_tpu_torch", "tante_tpu_torch.ops", "jaxtyping", "flaxen", "numpy",
             "tante_tpu", "tante_tpu.ops.pallas_block", "jax", "jax.numpy", "jaxlib", "flax.linen"]
    assert core.forbidden_modules(names) == sorted(
        ["tante_tpu", "tante_tpu.ops.pallas_block", "jax", "jax.numpy", "jaxlib", "flax.linen"])


def test_a_whole_run_loads_no_forbidden_module():
    """A run of every cell (tiny, on the CPU) in a fresh process: nothing it
    loads has a forbidden top-level name, and the reference loads nothing
    of the port."""
    code = f"""
import sys
sys.path[:0] = [{str(BENCH / 'tests')!r}]
import conftest
for w in conftest.WORKLOADS:
    assert conftest.run_tiny(w, seconds=0.05)["correct"], w
from harness import core
print(core.forbidden_modules(sys.modules))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    ref_only = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path[:0] = [{str(BENCH)!r}]; "
         "import reference.tante, models.tante_count; "
         "print(sorted(m for m in sys.modules if m.split('.')[0].startswith(('tante', 'jax', "
         "'flax'))))"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert ref_only.returncode == 0, ref_only.stderr[-3000:]
    assert ref_only.stdout.strip() == "[]"


def test_run_exits_without_a_card():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "tante-fixed16-trl", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


# -- the trace's reduction ------------------------------------------------------

def test_reduce_events():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "fused_block_sm90_f32_kernel<1>", "ts": 10.0,
         "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 25.0, "dur": 15.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 70.0, "dur": 10.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 41.0, "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 150.0, "dur": 10.0},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 50.0},
    ]
    host = [("bench.rollout", 0.0, 60.0), ("bench.head", 5.0, 25.0), ("bench.sync", 60.0, 95.0)]
    t = trace.reduce_events(ev, 1, (0.0, 100.0), host)
    assert t.window_s == pytest.approx(100e-6) and t.busy_s == pytest.approx(40e-6)
    assert t.device_s == pytest.approx(45e-6) and t.kernel_count == 2
    assert t.kernels == {"fused_block_sm90_f32_kernel<1>": pytest.approx(20e-6),
                         "elementwise": pytest.approx(15e-6)}
    # Idle gaps: 0-10 (midpoint 5, the head has just begun), 40-70 (in the
    # rollout), 80-100 (midpoint 90, in the sync).
    assert t.idle == {"bench.head": pytest.approx(10e-6), "bench.rollout": pytest.approx(30e-6),
                      "bench.sync": pytest.approx(20e-6)}
    assert t.breakdown()["device_ops"][0][0] == "fused_block_sm90_f32_kernel<1>"
    # Without a window: the span of the device operations, every gap outside a span.
    t = trace.reduce_events(ev, 1)
    assert t.window_s == pytest.approx(150e-6) and set(t.idle) == {trace.LOOP}
    assert trace.reduce_events(ev[3:4], 1) is None


def test_result_line_orders_its_keys():
    line = json.loads(core.result_line(True, 3, 0, {}, {"platform": "gpu"},
                                       {"a": {"value": 0.0, "limit": 0}}, {"device_ops": []},
                                       {"block_kernels": "operations"}))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "roofline_bounds", "checks"]
    assert "roofline_bounds" not in json.loads(core.result_line(True, 1, 0, {}, {}, {}))


def test_spans_wrap_and_unwrap():
    class M:
        def head(self, x):
            return x + 1, torch.tensor([2.5, 3.0])

        def encode(self, x):
            return x

    m = M()
    spans = trace.Spans(m)
    with spans.span("unit"):
        m.encode(1)
        m.head(1)
    assert [s[0] for s in spans.spans] == ["bench.encode", "bench.head", "bench.unit"]
    assert [float(h[0]) for h in spans.take()] == [2.5] and spans.take() == []
    spans.remove()
    assert "head" not in vars(m) and m.head(1)[0] == 2


# -- BENCHMARK.json against the contract ------------------------------------

def test_benchmark_json_contract(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and 1 <= spec["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in spec["command"])
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    metrics = spec["end_to_end"] + spec["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert sorted(c["reduced"]) == sorted(core.read_json(ROOT / c["file"])["reduced"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert all(w in e2e[m["moves"]].get("workloads", [w]) for w in m["workloads"])
        layers.add(m["layer"])
    for m in metrics:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"]) and m["better"] in (
            "lower", "higher")
    for w in spec["workloads"]:
        reported = [m for m in spec["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in spec["per_layer"])
    assert len(json.dumps(spec)) < 64 * 1024
