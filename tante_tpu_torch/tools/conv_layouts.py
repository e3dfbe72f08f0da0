"""How the zoo's f32 convolutions should reach the card: time and error of
``F.conv2d`` through cuDNN for AttentionUNet's 3x3 convs and UNetConvNext's
7x7 depthwise convs at the zoo lanes' shapes (B 4, 256x256 frames and the
pyramid below), f32 with TF32 off, each operand either a channels-last view
of the port's (B, H, W, C) fields ("nhwc") or a contiguous NCHW copy
("nchw"); then one AttentionUNet call at ``configs/unet_att.yaml`` (seeded
weights) under each.

    python3 -m tante_tpu_torch.tools.conv_layouts [--model]

``--model`` instead times every convolution of an AttentionUNet call (B 4 and
B 1) on its own with the operands the model passes, through cuDNN (marking
those it runs by an FFT algorithm) and through PyTorch's own im2col + GEMM,
and one call and one forward + backward with each route and with the port's
(``ops/convs.py:conv_nhwc``: the forward without cuDNN, the backward with it).

Prints one JSON line: per case the forward and forward + backward
milliseconds (CUDA events, 10 calls after 3), the maximum error against the
same convolution in float64 relative to the largest output, and the kernels
the profiler lists.  Needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import json

import torch
import torch.nn.functional as F

from tante_tpu_torch.ops import convs

# (name, B, H, W, Cin, Cout, k, groups)
CASES = [
    ("unet_att Conv1.Conv_1", 4, 256, 256, 64, 64, 3, 1),
    ("unet_att Conv2.Conv_1", 4, 128, 128, 128, 128, 3, 1),
    ("unet_att Conv3.Conv_1", 4, 64, 64, 256, 256, 3, 1),
    ("unet_att Conv5.Conv_1", 4, 16, 16, 1024, 1024, 3, 1),
    ("unet_convnext dwconv stage 0", 4, 256, 256, 15, 15, 7, 15),
    ("unet_convnext dwconv stage 2", 4, 64, 64, 60, 60, 7, 60),
]


def operands(layout: str, x: torch.Tensor, w: torch.Tensor):
    xi, wi = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    if layout == "nchw":
        xi, wi = xi.contiguous(), wi.contiguous()
    return xi, wi


def events_ms(fn, iters: int = 10) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def kernels(fn) -> list:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: -e.self_device_time_total)
    return [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in ev[:3]]


def conv_case(name, b, h, w, ci, co, k, groups, layout) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(b, h, w, ci, device="cuda", generator=gen)
    wt = torch.randn(k, k, ci // groups, co, device="cuda", generator=gen) * (k * k * ci) ** -0.5
    xi, wi = operands(layout, x, wt)
    y = F.conv2d(xi, wi, padding=k // 2, groups=groups)
    ref = F.conv2d(xi.double(), wi.double(), padding=k // 2, groups=groups)
    err = float((y.double() - ref).abs().max() / ref.abs().max())
    xg = xi.detach().requires_grad_(True)
    wg = wi.detach().requires_grad_(True)

    def fwd_bwd():
        F.conv2d(xg, wg, padding=k // 2, groups=groups).sum().backward()

    return {"case": name, "layout": layout,
            "fwd_ms": events_ms(lambda: F.conv2d(xi, wi, padding=k // 2, groups=groups)),
            "fwd_bwd_ms": events_ms(fwd_bwd), "max_err_rel_to_max": err,
            "kernels": kernels(lambda: F.conv2d(xi, wi, padding=k // 2, groups=groups))}


def routed(layout: str = "nhwc"):
    """``conv_nhwc`` as the global cuDNN flags route it (no switch of its
    own), with the operands in ``layout``."""
    def conv(x, kernel, bias, stride, padding, groups):
        (pt, pb), (pl, pr) = padding
        pad = (pt, pl)
        if pt != pb or pl != pr:
            x = F.pad(x, (0, 0, pl, pr, pt, pb))
            pad = (0, 0)
        xi, wi = operands(layout, x, kernel)
        return F.conv2d(xi, wi, bias, stride=stride, padding=pad,
                        groups=groups).permute(0, 2, 3, 1)

    return conv


@contextlib.contextmanager
def conv_route(fn):
    """Every conv of the zoo models through ``fn`` for the block."""
    from tante_tpu_torch.models import unet_att

    plain = convs.conv_nhwc
    convs.conv_nhwc = unet_att.conv_nhwc = fn
    try:
        yield
    finally:
        convs.conv_nhwc = unet_att.conv_nhwc = plain


@contextlib.contextmanager
def cudnn_enabled(on: bool):
    before = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = on
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = before


def unet_att_model():
    from tante_tpu_torch.config import instantiate, load_config
    from tante_tpu_torch.convert import load_jax_params, seeded_jax_params
    from tante_tpu_torch.data.metadata import TanteMetadata

    md = TanteMetadata(dataset_name="t", n_spatial_dims=2, spatial_resolution=(256, 256),
                       field_names={0: ["f"] * 8, 1: [], 2: []},
                       boundary_condition_types=["PERIODIC"], n_files=1,
                       n_trajectories_per_file=[1], n_steps_per_trajectory=[8], n_fields=8)
    model = instantiate(load_config("unet_att").model, dset_metadata=md, device="cuda")
    load_jax_params(model, seeded_jax_params(model, 0))
    return model


def model_call(layout: str) -> dict:
    """One AttentionUNet call (B 4, 256x256x8, eval) through cuDNN with the
    operands in ``layout``."""
    model = unet_att_model()
    x = torch.randn(4, 4, 256, 256, 8, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    with conv_route(routed(layout)), torch.no_grad():
        ms = events_ms(lambda: model(x), iters=3)
        return {"layout": layout, "unet_att_call_ms": ms, "kernels": kernels(lambda: model(x))}


def model_convs(batch: int = 4) -> list:
    """Every convolution of one AttentionUNet call (B ``batch``) on its own,
    with the operands the model hands ``conv_nhwc`` (strides included),
    through cuDNN and through PyTorch's own convolution: forward and forward
    + backward ms, and whether cuDNN took an FFT algorithm (complex GEMM
    kernels)."""
    model = unet_att_model()
    seen, conv = {}, routed()

    def record(x, kernel, bias, stride, padding, groups):
        key = (tuple(x.shape), tuple(kernel.shape), kernel.stride(), bias is not None)
        seen.setdefault(key, (x.detach().clone(), kernel.detach().clone(), bias, stride,
                              padding, groups))
        return conv(x, kernel, bias, stride, padding, groups)

    with conv_route(record), torch.no_grad():
        model(torch.randn(batch, 4, 256, 256, 8, device="cuda"))
    out = []
    for (shape, kshape, kstride, has_bias), (x, k, b, stride, pad, groups) in seen.items():
        k = torch.empty_strided(k.shape, kstride, device="cuda").copy_(k)
        xg = x.clone().requires_grad_(True)

        def fwd():
            return conv(x, k, b, stride, pad, groups)

        def fwd_bwd():
            conv(xg, k, b, stride, pad, groups).sum().backward()

        ks = kernels(fwd_bwd)
        with cudnn_enabled(False):
            native = {"fwd_ms": events_ms(fwd, iters=3), "fwd_bwd_ms": events_ms(fwd_bwd, iters=3)}
        out.append({"input": list(shape), "kernel": list(kshape), "kernel_strides": list(kstride),
                    "bias": has_bias, "fwd_ms": events_ms(fwd, iters=3),
                    "fwd_bwd_ms": events_ms(fwd_bwd, iters=3),
                    "fft": any("cf32" in e[0] or "fft" in e[0].lower() for e in ks),
                    "kernels": ks, "without_cudnn": native})
    return out


def model_step(route: str) -> dict:
    """One AttentionUNet call (B 4) and one forward + backward: "cudnn" (every
    conv through cuDNN), "native" (none) or "port" (``conv_nhwc`` as shipped)."""
    model = unet_att_model()
    x = torch.randn(4, 4, 256, 256, 8, device="cuda")

    def step():
        model(x, deterministic=False).square().mean().backward()

    route_ctx = conv_route(routed()) if route != "port" else contextlib.nullcontext()
    with route_ctx, cudnn_enabled(route != "native"):
        with torch.no_grad():
            call = events_ms(lambda: model(x), iters=3)
        return {"route": route, "call_ms": call, "fwd_bwd_ms": events_ms(step, iters=3),
                "kernels": kernels(step)}


def main() -> None:
    import sys

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--model" in sys.argv:
        out = {"model_convs": {b: model_convs(b) for b in (4, 1)},
               "steps": [model_step(r) for r in ("cudnn", "native", "port")]}
    else:
        out = {"convs": [conv_case(*c, layout) for c in CASES for layout in ("nhwc", "nchw")],
               "model": [model_call(layout) for layout in ("nchw", "nhwc")]}
    out.update(cudnn=torch.backends.cudnn.version(), torch=torch.__version__)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
