"""Drive the PyTorch/H100 port of TANTE on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (a failing phase is reported and the
script exits non-zero without the final result line):

1. build    nvcc builds the fused-block kernels from this checkout
            (``tante_tpu_torch/ops/csrc/fused_block.cu``); build seconds,
            the ``-Xptxas -v`` summary and each tile plan.
2. kernel   each kernel against its plain PyTorch version (f32 from the
            same bf16 inputs) at the serving path's shapes; max abs error,
            tolerance, kernel / plain time (CUDA events) and the bound.
3. fixed    flagship TANTE (deg=True, bf16, seeded random weights), B=8,
            16-step latent rollout through ``Predictor.rollout``; launch
            counts (exactly 96 + 48 per rollout), frames/s, and a check
            against the CPU f32 model on one sample.
4. adaptive the trained asset ``tante_tpu/assets/tante_flagship.npz``
            (deg=False) through ``Predictor.rollout_adaptive`` with K=8 on
            the synthetic-waves input; n_calls, r_t, frames/s, VRMSE and
            L2RE on the held-out trajectory, checked against the CPU f32
            model.
5. kernels  one {"kernels": [...]} line.

Then the card's name and power limit (``nvidia-smi``) and, last, the
result line {"ok": true, "device": {...}}.  Exits non-zero when no CUDA
device is available.  Imports no JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tante_tpu_torch.convert import seeded_jax_params
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.tante import TANTE
from tante_tpu_torch.ops import _build
from tante_tpu_torch.ops import fused_block as fb
from tante_tpu_torch.serve import Predictor

ROOT = Path(__file__).resolve().parent
ASSET = ROOT / "tante_tpu" / "assets" / "tante_flagship.npz"
SOURCE = "tante_tpu_torch/ops/csrc/fused_block.cu"
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet, 700 W)
PEAK_HBM_BYTES = 3.35e12
BATCH, IN_T, RES, FIELDS, N_STEPS, K = 8, 4, (128, 384), 4, 16, 8
C, HEADS = 256, 8
# Kernel vs plain: bf16 rounding of q, k, v, attention, fc1 and the
# residuals (a CPU emulation of the kernel's rounding points gives 0.032).
ATOL, RTOL = 5e-2, 2e-2
# Rollouts in bf16 on the card vs the f32 model on the CPU: relative L2
# error of the predicted change (the CPU in bf16 gives 2.5e-3), and the
# relative VRMSE gap of the adaptive lane.
ROLLOUT_REL_TOL = 5e-2

FAILURES: list[str] = []


def emit(obj: dict):
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str):
    if not cond:
        FAILURES.append(what)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def metadata() -> TanteMetadata:
    return TanteMetadata(
        dataset_name="bench", n_spatial_dims=2, spatial_resolution=RES,
        field_names={0: ["f"] * FIELDS, 1: [], 2: []}, boundary_condition_types=["PERIODIC"],
        n_files=1, n_trajectories_per_file=[1], n_steps_per_trajectory=[32], n_fields=FIELDS,
    )


def flagship(deg: bool, dtype, device) -> TANTE:
    return TANTE(in_T=IN_T, dset_metadata=metadata(), taylor_order=1, attn_axes="THWTHWTHW",
                 embed_dim=C, patch_scale=8, n_head=HEADS, mlp_ratio=1.0, output_length=1,
                 deg=deg, dtype=dtype, device=device)


def wave_input(batch=BATCH, t0: int = 0, n_frames: int = IN_T, seed: int = 7) -> np.ndarray:
    """``bench.py:_wave_input``: the synthetic-waves fields (4-field
    turbulent-radiative-layer schema) the trained asset was trained on."""
    h, w = RES
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(0, 2 * np.pi, h, endpoint=False),
                         np.linspace(0, 2 * np.pi, w, endpoint=False), indexing="ij")
    phase = rng.uniform(0, 2 * np.pi, size=(batch, 1, 1, 1)).astype(np.float32)
    speed = rng.uniform(0.1, 0.3, size=(batch, 1, 1, 1)).astype(np.float32)
    t = (t0 + np.arange(n_frames, dtype=np.float32)).reshape(1, n_frames, 1, 1)

    def wave(kx, ky, amp=1.0):
        return amp * np.sin(kx * gx + ky * gy + phase + speed * t).astype(np.float32)

    k1, k2 = (1, 2), (3, 1)
    return np.stack([wave(*k1) + 0.5 * wave(*k2), wave(*k2) + 0.25 * wave(*k1), wave(*k1),
                     wave(k1[1], k1[0], amp=0.7)], axis=-1)


def vrmse(x: torch.Tensor, y: torch.Tensor) -> float:
    """The Well's VRMSE (``tante_tpu/train/metrics.py:VRMSE``), mean over B, T, C."""
    mse = ((x - y) ** 2).mean(dim=(2, 3))
    var = y.var(dim=(2, 3), unbiased=True)
    return float(torch.sqrt(mse / (var + 1e-7)).mean())


def l2re(x: torch.Tensor, y: torch.Tensor) -> float:
    """Per (B, C) vector-norm ratio over (T, H, W) (``metrics.py:L2RE``), mean."""
    b, c = x.shape[0], x.shape[-1]
    xf, yf = x.reshape(b, -1, c), y.reshape(b, -1, c)
    return float((torch.linalg.norm(xf - yf, dim=1) / (torch.linalg.norm(yf, dim=1) + 1e-7)).mean())


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


# ---------------------------------------------------------------------------


def phase_build() -> dict:
    info = _build.build()
    _build.load()
    plans = {f"L={l}": _build.plan(l, C, C) for l in (4, 16, 48)}
    emit({"phase": "build", "seconds": info["seconds"], "cached": info["cached"],
          "nvcc_flags": " ".join(_build.NVCC_FLAGS), "ptxas": info["ptxas"], "tile_plans": plans})
    return info


def block_params(seed: int, device) -> fb.BlockParams:
    rng = np.random.default_rng(seed)

    def u(*shape, fan_in=None, scale=1.0, offset=0.0):
        bound = 1.0 / math.sqrt(fan_in or shape[0])
        a = offset + scale * rng.uniform(-bound, bound, size=shape)
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)

    return fb.BlockParams(
        ln1_scale=u(C, scale=0.1, offset=1.0), ln1_bias=u(C, scale=0.1),
        wq=u(C, C), bq=u(C), wk=u(C, C), bk=u(C), wv=u(C, C), bv=u(C), wo=u(C, C), bo=u(C),
        ln2_scale=u(C, scale=0.1, offset=1.0), ln2_bias=u(C, scale=0.1),
        w1=u(C, C), b1=u(C), w2=u(C, C), b2=u(C),
    )


def bound(rows: int, l: int, causal: bool, p: fb.BlockParams) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, flops, bytes) for one block launch:
    matmuls 2*M*(4C^2 + 2C*hidden) plus attention 4*C per (query, key)
    pair this mask admits; bytes = x in + y out + every weight once."""
    hidden = p.w1.shape[-1]
    pairs = rows * (l + 1) / 2 if causal else rows * l
    flops = 2 * rows * (4 * C * C + 2 * C * hidden) + 4 * C * pairs
    nbytes = 2 * rows * C * 2 + sum(t.numel() * t.element_size() for t in p)
    t_ops, t_mem = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes"), flops, nbytes


def phase_kernels(dev) -> dict[str, list[dict]]:
    cases = [
        ("fused_block_fwd", "H", (1536, 16, C), False),
        ("fused_block_fwd", "W", (512, 48, C), False),
        ("fused_block_fwd", "W causal", (512, 48, C), True),
        ("fused_block_canon_t_fwd", "T", (BATCH, IN_T, 16, 48, C), True),
    ]
    results: dict[str, list[dict]] = {}
    for i, (name, label, shape, causal) in enumerate(cases):
        p = block_params(100 + i, dev)
        pf = fb.BlockParams(*(t.float() for t in p))
        x = torch.from_numpy(np.random.default_rng(i).normal(size=shape).astype(np.float32))
        x = x.to(dev, torch.bfloat16)
        if name == "fused_block_fwd":
            s, l, _ = shape
            run = lambda: fb.fused_block_apply(x, p, l, HEADS, causal)  # noqa: E731
            plain = lambda: fb.block_ref(x.float(), pf, l, HEADS, causal)  # noqa: E731
        else:
            l = shape[1]
            run = lambda: fb.fused_block_canon_t(x, p, HEADS)  # noqa: E731
            plain = lambda: fb.canon_t_ref(x.float(), pf, HEADS)  # noqa: E731
        got = run()
        torch.cuda.synchronize()
        want = plain()
        err = (got.float() - want).abs()
        ok = bool(torch.isfinite(got).all()) and bool((err <= ATOL + RTOL * want.abs()).all())
        check(ok, f"kernel {name} {label} disagrees with its plain version")
        rows = x.numel() // C
        b_ms, b_by, flops, nbytes = bound(rows, l, causal, p)
        k_ms = cuda_ms(run, iters=50)
        p_ms = cuda_ms(plain, iters=10, warmup=1)
        res = {"phase": "kernel", "name": name, "case": label, "shape": list(shape),
               "causal": causal, "max_abs_err": float(err.max()),
               "tolerance": f"|k - plain| <= {ATOL} + {RTOL}*|plain|", "ok": ok,
               "kernel_ms": k_ms, "plain_ms": p_ms, "bound_us": 1e3 * b_ms, "bound_by": b_by,
               "flops": flops, "bytes": nbytes, "achieved_tflops": flops / k_ms / 1e9}
        emit(res)
        results.setdefault(name, []).append(res)
    return results


def trace(fn, top: int = 8) -> dict:
    """One call of ``fn`` under ``torch.profiler``: host wall time, device
    kernel time and busy share, kernel launches, and the kernels that take
    the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {
        "wall_ms": wall_us / 1e3, "device_kernel_ms": busy_us / 1e3,
        "device_busy_share": busy_us / wall_us,
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels": [{"name": e.key[:90], "count": e.count,
                         "ms": e.self_device_time_total / 1e3} for e in kernels[:top]],
    }


def timed_rollouts(fn, n: int = 5, windows: int = 5) -> dict:
    """Seconds per call of ``fn``: CUDA events around ``windows`` windows of
    ``n`` back-to-back calls; the median window and the spread (the host
    is shared, so single windows vary)."""
    per = sorted(cuda_ms(fn, iters=n, warmup=0) / 1e3 for _ in range(windows))
    return {"median_s": per[len(per) // 2], "min_s": per[0], "max_s": per[-1],
            "calls": n * windows}


def host_split(fn) -> dict:
    """Host time to enqueue one call of ``fn`` against its wall time to
    completion: equal values mean the host, not the card, sets the pace
    (or that the call waits on the card inside)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return {"host_enqueue_ms": 1e3 * enqueued, "host_wall_ms": 1e3 * (time.perf_counter() - t0)}


def lane_speed(tm: dict) -> dict:
    frames = BATCH * N_STEPS
    return {"ms_per_rollout": 1e3 * tm["median_s"], "frames_per_s": frames / tm["median_s"],
            "frames_per_s_range": [frames / tm["max_s"], frames / tm["min_s"]],
            "timed_rollouts": tm["calls"]}


def phase_fixed(dev) -> dict:
    model = flagship(True, torch.bfloat16, dev)
    flat = seeded_jax_params(model, seed=0)
    pred = Predictor.from_numpy(model, flat)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(BATCH, IN_T, *RES, FIELDS)).astype(np.float32)).to(dev)
    for _ in range(2):
        pred.rollout(x, N_STEPS, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    fb.reset_launches()
    y = pred.rollout(x, N_STEPS, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    launches = {"fused_block_fwd": fb.fused_block_apply.launches,
                "fused_block_canon_t_fwd": fb.fused_block_canon_t.launches}
    check(launches == {"fused_block_fwd": 96, "fused_block_canon_t_fwd": 48},
          f"fixed lane launches {launches}, want 96 + 48")
    shape_ok = tuple(y.shape) == (BATCH, N_STEPS, *RES, FIELDS)
    finite = bool(torch.isfinite(y).all())
    check(shape_ok and finite, "fixed lane output shape / finiteness")
    tm = timed_rollouts(lambda: pred.rollout(x, N_STEPS, out_dtype=torch.bfloat16))

    prof = trace(lambda: pred.rollout(x, N_STEPS, out_dtype=torch.bfloat16))
    prof.update(host_split(lambda: pred.rollout(x, N_STEPS, out_dtype=torch.bfloat16)))

    # The same weights in f32 on the CPU (plain path), one sample, 2 steps:
    # relative L2 error of the predicted change from the last input frame.
    ref_model = flagship(True, torch.float32, "cpu")
    u = x[:1, -1:].cpu()
    ref = Predictor.from_numpy(ref_model, flat, device="cpu").rollout(x[:1].cpu(), 2)
    err = rel_l2(pred.rollout(x[:1], 2).cpu() - u, ref - u)
    check(err <= ROLLOUT_REL_TOL, f"fixed lane vs CPU f32: rel L2 {err}")
    res = {"phase": "fixed", "batch": BATCH, "n_steps": N_STEPS, "dtype": "bf16",
           "weights": "seeded (numpy seed 0)", "output_shape": list(y.shape), "finite": finite,
           "launches_per_rollout": launches, **lane_speed(tm),
           "change_vs_cpu_f32_rel_l2": err, "rel_l2_tolerance": ROLLOUT_REL_TOL, "trace": prof}
    emit(res)
    return res


def phase_adaptive(dev) -> dict:
    flat = dict(np.load(ASSET))
    pred = Predictor.from_numpy(flagship(False, torch.bfloat16, dev), flat)
    x = torch.from_numpy(wave_input()).to(dev)
    pred.rollout_adaptive(x, N_STEPS, max_frames_per_call=K, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    fb.reset_launches()
    y, rt, n_calls = pred.rollout_adaptive(x, N_STEPS, max_frames_per_call=K,
                                           out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    launches = {"fused_block_fwd": fb.fused_block_apply.launches,
                "fused_block_canon_t_fwd": fb.fused_block_canon_t.launches}
    check(launches == {"fused_block_fwd": 6 * n_calls, "fused_block_canon_t_fwd": 3 * n_calls},
          f"adaptive lane launches {launches} for {n_calls} calls")
    tm = timed_rollouts(lambda: pred.rollout_adaptive(
        x, N_STEPS, max_frames_per_call=K, out_dtype=torch.bfloat16))

    prof = trace(lambda: pred.rollout_adaptive(
        x, N_STEPS, max_frames_per_call=K, out_dtype=torch.bfloat16))
    prof.update(host_split(lambda: pred.rollout_adaptive(
        x, N_STEPS, max_frames_per_call=K, out_dtype=torch.bfloat16)))

    # Accuracy on the held-out trajectory (bench.py:_adaptive_accuracy),
    # on the card and for the f32 model on the CPU.
    traj = wave_input(n_frames=IN_T + N_STEPS, seed=123)
    hist, target = torch.from_numpy(traj[:, :IN_T]), torch.from_numpy(traj[:, IN_T:])
    ya, rt_a, calls_a = pred.rollout_adaptive(hist, N_STEPS, max_frames_per_call=K)
    ya = ya.float().cpu()
    ref_pred = Predictor.from_numpy(flagship(False, torch.float32, "cpu"), flat, device="cpu")
    yr, rt_r, calls_r = ref_pred.rollout_adaptive(hist, N_STEPS, max_frames_per_call=K)
    v_gpu, l_gpu = vrmse(ya, target), l2re(ya, target)
    v_ref, l_ref = vrmse(yr, target), l2re(yr, target)
    check(bool(torch.isfinite(y).all()) and tuple(y.shape) == (BATCH, N_STEPS, *RES, FIELDS),
          "adaptive lane output shape / finiteness")
    check(calls_a == calls_r, f"adaptive n_calls {calls_a} on the card, {calls_r} in f32 on the CPU")
    check(abs(v_gpu - v_ref) <= ROLLOUT_REL_TOL * v_ref,
          f"adaptive VRMSE {v_gpu} on the card vs {v_ref} in f32 on the CPU")
    res = {"phase": "adaptive", "batch": BATCH, "n_steps": N_STEPS, "K": K, "dtype": "bf16",
           "weights": "trained (tante_tpu/assets/tante_flagship.npz)", "n_calls": n_calls,
           "rt_log": [float(r) for r in rt], "launches_per_rollout": launches,
           **lane_speed(tm), "trace": prof,
           "heldout": {"n_calls": calls_a, "rt_log": [float(r) for r in rt_a],
                       "vrmse": v_gpu, "l2re": l_gpu},
           "heldout_cpu_f32": {"n_calls": calls_r, "rt_log": [float(r) for r in rt_r],
                               "vrmse": v_ref, "l2re": l_ref},
           "tpu_v5e_history_not_a_port_figure": {"n_calls": 3, "vrmse": 1.0722, "l2re": 1.1336}}
    emit(res)
    return res


def phase_summary(kernels: dict[str, list[dict]], fixed: dict) -> list[dict]:
    replaces = {"fused_block_fwd": "tante_tpu/ops/pallas_block.py:163",
                "fused_block_canon_t_fwd": "tante_tpu/ops/pallas_block.py:401"}
    out = []
    for name, cases in kernels.items():
        # Headline numbers: mean over the main path's shapes (the H and W
        # blocks for fused_block_fwd; the causal W case is a check only).
        main = [c for c in cases if c["case"] != "W causal"]
        mean = lambda k: sum(c[k] for c in main) / len(main)  # noqa: E731
        out.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces[name],
            "launches": fixed["launches_per_rollout"][name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_us") / 1e3, "bound_by": main[0]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a whole block
            "ok": all(c["ok"] for c in cases),
            "per_shape": [{k: c[k] for k in ("case", "shape", "kernel_ms", "plain_ms",
                                              "bound_us", "max_abs_err")} for c in cases],
        })
    emit({"kernels": out})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions stay f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    phase_build()
    kernels = phase_kernels(dev)
    fixed = phase_fixed(dev)
    phase_adaptive(dev)
    phase_summary(kernels, fixed)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)  # name, power limit: as nvidia-smi prints them
    if FAILURES:
        emit({"failures": FAILURES, "seconds": time.perf_counter() - t0})
        return 1
    emit({"seconds": time.perf_counter() - t0})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
