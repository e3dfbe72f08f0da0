"""How the zoo's f32 convolutions should reach the card: time and error of
``F.conv2d`` through cuDNN for AttentionUNet's 3x3 convs and UNetConvNext's
7x7 depthwise convs at the zoo lanes' shapes (B 4, 256x256 frames and the
pyramid below), f32 with TF32 off, each operand either a channels-last view
of the port's (B, H, W, C) fields ("nhwc") or a contiguous NCHW copy
("nchw"); then one AttentionUNet call at ``configs/unet_att.yaml`` (seeded
weights) under each.

    python3 -m tante_tpu_torch.tools.conv_layouts [--model | --overlap]

``--model`` instead times every convolution of an AttentionUNet call (B 4 and
B 1) on its own with the operands the model passes, through cuDNN (marking
those it runs by an FFT algorithm) and through PyTorch's own im2col + GEMM,
and one call and one forward + backward with each route and with the port's
(``ops/convs.py:conv_nhwc``: the forward without cuDNN, the backward with it).

``--overlap`` times every operation of TANTE's overlapping patch pyramids
that is not a matmul, on its own, with the operands one model call passes:
the convs (``conv_nhwc``), transposed convs (``conv_transpose_nhwc``),
pools and resizes of the flagship (``configs/tante.yaml`` width, B 8 of
128x384x4, seeded weights) at overlap 0.5 and of TANTE-FNO (modes 32) at
0.25, in f32 and bf16; each conv and transposed conv through cuDNN and
without it (PyTorch's own kernels), with whether cuDNN took an FFT
algorithm; each bf16 pool also on the bf16 view without the f32 copy (time,
and whether it gives the same bits); each f32 conv and transposed conv's
largest error against float64, relative to its largest output, as the port
runs it under PyTorch's default flags (cuDNN's TF32 on) and through cuDNN
itself with TF32 on.

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


# The operations of the patch convs that are not matmuls (``ops/convs.py``).
PATCH_OPS = ("conv_nhwc", "conv_transpose_nhwc", "adaptive_avg_pool2d", "resize_bilinear")


@contextlib.contextmanager
def wrapped_patch_ops(wrap):
    """Each of ``PATCH_OPS``, as the patch convs call it, replaced by
    ``wrap(name, fn)`` while the block is open."""
    plain = {n: getattr(convs, n) for n in PATCH_OPS}
    for n, fn in plain.items():
        setattr(convs, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in plain.items():
            setattr(convs, n, fn)


def recorded(seen: dict):
    """Every conv, transposed conv, pool and resize the patch convs call
    while the block is open, once per (kind, operand shapes), in ``seen``."""
    def wrap(name, fn):
        def call(x, *args):
            key = (name, tuple(x.shape), *(tuple(a.shape) for a in args if torch.is_tensor(a)))
            seen.setdefault(key, (fn, x.detach().clone(), args))
            return fn(x, *args)
        return call

    return wrapped_patch_ops(wrap)


def tf32_errors(name: str, fn, xin: torch.Tensor, args: tuple) -> dict:
    """An f32 conv (``conv_nhwc``) or transposed conv (``conv_transpose_nhwc``)
    against float64 on the CPU: the largest error relative to the largest
    output, of ``fn`` (the port's) and of cuDNN's own call, both with
    ``cudnn.allow_tf32`` on as PyTorch sets it by default."""
    if name == "conv_nhwc":
        raw = routed()
    else:
        def raw(x, kernel, bias, stride):
            return F.conv_transpose2d(x.permute(0, 3, 1, 2), kernel.flip(0, 1).permute(2, 3, 0, 1),
                                      bias, stride=stride).permute(0, 2, 3, 1)
    with torch.no_grad():
        ref = fn(xin.cpu().double(), *(a.cpu().double() if torch.is_tensor(a) else a for a in args))

    def err(f):
        return float((f(xin, *args).cpu().double() - ref).abs().max() / ref.abs().max())

    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with cudnn_enabled(True), torch.no_grad():
            return {"err_port_default_flags": err(fn), "err_cudnn_tf32": err(raw)}
    finally:
        torch.backends.cudnn.allow_tf32 = before


def overlap_ops(kind: str, dtype: torch.dtype) -> list:
    """One model call of the overlap lane ``kind`` ("cnn" at overlap 0.5,
    "fno" at 0.25) in ``dtype``: its encode of 8 frames and its decode of
    one derivative each, every recorded operation timed alone."""
    from tante_tpu_torch.convert import load_jax_params, seeded_jax_params
    from tante_tpu_torch.data.metadata import TanteMetadata
    from tante_tpu_torch.models.tante import TANTE

    md = TanteMetadata(dataset_name="t", n_spatial_dims=2, spatial_resolution=(128, 384),
                       field_names={0: ["f"] * 4, 1: [], 2: []},
                       boundary_condition_types=["PERIODIC"], n_files=1,
                       n_trajectories_per_file=[1], n_steps_per_trajectory=[8], n_fields=4)
    kw = dict(enc_dec_type="fno", modes1=32, modes2=32, overlap_ratio=0.25) if kind == "fno" \
        else dict(overlap_ratio=0.5)
    model = TANTE(in_T=4, dset_metadata=md, attn_axes="THWTHWTHW", embed_dim=256, patch_scale=8,
                  n_head=8, dtype=dtype, device="cuda", **kw)
    load_jax_params(model, seeded_jax_params(model, 0))
    x = torch.randn(8, 1, 128, 384, 4, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    seen = {}
    with recorded(seen), torch.no_grad():
        lat = model.encode(x.to(dtype))
        model.decoders_0(lat)
    out = []
    for (name, *shapes), (fn, xin, args) in seen.items():
        row = {"op": name, "shapes": [list(s) for s in shapes], "ms": events_ms(lambda: fn(xin, *args))}
        if name == "conv_nhwc":
            cudnn_fn = routed()
        elif name == "conv_transpose_nhwc":
            cudnn_fn = fn
        else:
            if name == "adaptive_avg_pool2d" and xin.dtype == torch.bfloat16:
                # PyTorch's pool on the bf16 view itself, without the f32 copy.
                direct = lambda: F.adaptive_avg_pool2d(  # noqa: E731
                    xin.permute(0, 3, 1, 2), args[0]).permute(0, 2, 3, 1)  # noqa: B023
                row.update(direct_bf16_ms=events_ms(direct),
                           direct_bf16_equal=bool(torch.equal(direct(), fn(xin, *args))))
            out.append(row)
            continue
        with cudnn_enabled(True):  # conv_nhwc turns cuDNN off itself for dense f32
            row["cudnn_ms"] = events_ms(lambda: cudnn_fn(xin, *args))  # noqa: B023
            ks = kernels(lambda: cudnn_fn(xin, *args))  # noqa: B023
        with cudnn_enabled(False):
            row["without_cudnn_ms"] = events_ms(lambda: cudnn_fn(xin, *args))  # noqa: B023
        row.update(cudnn_kernels=ks, fft=any("cf32" in k[0] or "fft" in k[0].lower() for k in ks))
        if xin.dtype == torch.float32:
            row.update(tf32_errors(name, fn, xin, args))
        out.append(row)
    return out


def main() -> None:
    import sys

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--overlap" in sys.argv:
        out = {f"{kind}_{str(dt)[6:]}": overlap_ops(kind, dt) for kind in ("cnn", "fno")
               for dt in (torch.float32, torch.bfloat16)}
    elif "--model" in sys.argv:
        out = {"model_convs": {b: model_convs(b) for b in (4, 1)},
               "steps": [model_step(r) for r in ("cudnn", "native", "port")]}
    else:
        out = {"convs": [conv_case(*c, layout) for c in CASES for layout in ("nhwc", "nchw")],
               "model": [model_call(layout) for layout in ("nchw", "nhwc")]}
    out.update(cudnn=torch.backends.cudnn.version(), torch=torch.__version__)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
