"""Plain float32 TANTE: the benchmark's reference for the TANTE cells.

Written from the model's equations (Wu et al., "TANTE: Time-Adaptive
Operator Learning via Neural Taylor Expansion", J. Comput. Phys. 562, 2026),
with flax-keyed weights (``"a/b/c"`` -> tensor, Dense kernels ``(in, out)``,
conv kernels HWIO).  It imports torch alone: nothing of the program under
test and nothing of the JAX package.  Every product is a plain matmul or
einsum in float32 with TF32 off; ``precision="tf32"`` rounds both operands
of every product to TF32 (10 mantissa bits, round to nearest even) and keeps
float32 accumulation, the step below float32 that the correctness control
takes.

  encode: three patch convs (stride == patch, no padding), exact GELU
          between them, each frame on its own
  FiLM time code (relative times [-2, -1, 0, 0] for four frames), plus the
  space and time embeddings
  backbone: residual Linear-GELU-Linear mixers along H, W and T, then one
          pre-LN transformer block per letter of ``attn_axes`` (T causal),
          tanh GELU in the block MLP
  derivative = the last frame of the backbone's output; adaptive models
          read r_t off it (``interprator``) and FiLM-modulate it by r_t
  decode: three transposed patch convs (the flax kernel mirrored), exact
          GELU between them
  Taylor sum: u(t_i) = u(0) + sum_k d_k (i dt)^k / k!
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch

# patch_scale -> the encoder's per-stage patch sizes.
PATCH_MAP = {64: (4, 4, 4), 32: (4, 4, 2), 16: (4, 2, 2), 8: (2, 2, 2), 4: (2, 2, 1),
             2: (2, 1, 1)}
LN_EPS = 1e-5
RT_EPS = 1.001  # the interprator's offset


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties to even),
    kept in float32."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def f32_products():
    """TF32 off for matmuls and cuDNN inside the block (restored after)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def param_shapes(model: dict, resolution: Tuple[int, int], n_fields: int) -> Dict[str, tuple]:
    """Every parameter of the model ``model`` (the config's model node) at
    ``resolution`` with ``n_fields`` fields, flax-keyed."""
    c, t_in = model["embed_dim"], model["in_T"]
    p = PATCH_MAP[model["patch_scale"]]
    hp, wp = (r // model["patch_scale"] for r in resolution)
    hidden = int(c * model["mlp_ratio"])
    out: Dict[str, tuple] = {"t_emb": (1, t_in, c), "s_emb": (1, hp, wp, c)}
    widths = (n_fields, c // 4, c // 2, c)
    for i in range(3):
        out[f"encoder/RealConv2d_{i}/Conv_0/kernel"] = (p[i], p[i], widths[i], widths[i + 1])
        out[f"encoder/RealConv2d_{i}/Conv_0/bias"] = (widths[i + 1],)

    def dense(prefix, n_in, n_out):
        out[f"{prefix}/Dense_0/kernel"] = (n_in, n_out)
        out[f"{prefix}/Dense_0/bias"] = (n_out,)

    def film(prefix):
        for j, (a, b) in enumerate(((1, c // 2), (c // 2, c), (1, c // 2), (c // 2, c))):
            dense(f"{prefix}/TorchDense_{j}", a, b)

    film("t_encode")
    for k in range(model["taylor_order"]):
        for i, (co, ci) in enumerate(zip(widths[:0:-1], widths[-2::-1])):
            pi = p[2 - i]
            out[f"decoders_{k}/RealTransConv2d_{i}/ConvTranspose_0/kernel"] = (pi, pi, co, ci)
            out[f"decoders_{k}/RealTransConv2d_{i}/ConvTranspose_0/bias"] = (ci,)
        bb = f"blocks_{k}"
        for name, a in (("vertical", hp), ("horizontal", wp), ("temporal", t_in)):
            out[f"{bb}/{name}_propagator/w1"] = (a, a)
            out[f"{bb}/{name}_propagator/b1"] = (a,)
            out[f"{bb}/{name}_propagator/w2"] = (a, a)
            out[f"{bb}/{name}_propagator/b2"] = (a,)
        for i, _ in enumerate(_axes(model)[k]):
            blk = f"{bb}/block_{i}"
            for name in ("ln1_scale", "ln1_bias", "bq", "bk", "bv", "bo", "ln2_scale",
                         "ln2_bias", "b2"):
                out[f"{blk}/{name}"] = (c,)
            for name in ("wq", "wk", "wv", "wo"):
                out[f"{blk}/{name}"] = (c, c)
            out[f"{blk}/w1"], out[f"{blk}/b1"], out[f"{blk}/w2"] = (c, hidden), (hidden,), (
                hidden, c)
        if not model["deg"]:
            dense(f"interprators_{k}/TorchDense_0", c, c // 2)
            dense(f"interprators_{k}/TorchDense_1", c // 2, c // 4)
            dense(f"interprators_{k}/TorchDense_2", c // 4, 1)
            film(f"modifiers_{k}")
    return out


def _axes(model: dict) -> List[str]:
    axes = [a.strip() for a in model["attn_axes"].replace(" ", "").split("-")]
    if len(axes) != model["taylor_order"] or set("".join(axes)) - set("THW"):
        raise ValueError(f"the reference runs T/H/W axes, one part per Taylor order: "
                         f"{model['attn_axes']!r}")
    return axes


class PlainTANTE:
    """TANTE's forward pass on a flax-keyed dict of float32 tensors."""

    def __init__(self, model: dict, params: Dict[str, torch.Tensor], precision: str = "f32"):
        if precision not in ("f32", "tf32"):
            raise ValueError(f"precision {precision!r}: 'f32' or 'tf32'")
        if model.get("enc_dec_type", "cnn") != "cnn" or model.get("overlap_ratio", 0.0) != 0.0:
            raise ValueError("the reference runs the CNN encoder and decoder without overlap")
        self.cfg = model
        self.P = params
        self.tf32 = precision == "tf32"
        self.in_t = model["in_T"]
        self.order = model["taylor_order"]
        self.dt = float(model["frame_interval"])
        self.heads = model["n_head"]
        self.deg = bool(model["deg"])
        self.patches = PATCH_MAP[model["patch_scale"]]
        self.axes = _axes(model)

    # -- products ---------------------------------------------------------
    def _op(self, t: torch.Tensor) -> torch.Tensor:
        return tf32_round(t) if self.tf32 else t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._op(a) @ self._op(b)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, self._op(a), self._op(b))

    def dense(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        return self.mm(x, self.P[f"{prefix}/Dense_0/kernel"]) + self.P[f"{prefix}/Dense_0/bias"]

    # -- layers -------------------------------------------------------------
    @staticmethod
    def gelu_erf(x: torch.Tensor) -> torch.Tensor:
        return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))

    @staticmethod
    def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
        return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))

    @staticmethod
    def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + LN_EPS) * scale + bias

    def film(self, x: torch.Tensor, cond: torch.Tensor, prefix: str) -> torch.Tensor:
        """x + x * scale(cond) + shift(cond); cond (N, 1) -> (N, C)."""
        scale = self.dense(torch.relu(self.dense(cond, f"{prefix}/TorchDense_0")),
                           f"{prefix}/TorchDense_1")
        shift = self.dense(torch.relu(self.dense(cond, f"{prefix}/TorchDense_2")),
                           f"{prefix}/TorchDense_3")
        return x + (x * scale + shift)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, F) -> (B, T, H/s, W/s, C): patch convs, stride == patch."""
        z = frames
        for i, p in enumerate(self.patches):
            k = self.P[f"encoder/RealConv2d_{i}/Conv_0/kernel"]
            *lead, h, w, ci = z.shape
            z = z.reshape(*lead, h // p, p, w // p, p, ci)
            z = self.einsum("...iajbc,abcd->...ijd", z, k) + self.P[
                f"encoder/RealConv2d_{i}/Conv_0/bias"]
            if i < 2:
                z = self.gelu_erf(z)
        return z

    def decode(self, d: torch.Tensor, k: int) -> torch.Tensor:
        """(B, 1, H/s, W/s, C) -> (B, 1, H, W, F): transposed patch convs.
        flax's ConvTranspose (``transpose_kernel=False``) mirrors the kernel:
        output pixel (i p + a, j p + b) takes input pixel (i, j) through
        kernel tap (p-1-a, p-1-b)."""
        z = d
        for i, p in enumerate(reversed(self.patches)):
            pre = f"decoders_{k}/RealTransConv2d_{i}/ConvTranspose_0"
            kern = self.P[f"{pre}/kernel"].flip(0, 1)
            *lead, h, w, _ = z.shape
            z = self.einsum("...ijc,abcd->...iajbd", z, kern)
            z = z.reshape(*lead, h * p, w * p, kern.shape[-1]) + self.P[f"{pre}/bias"]
            if i < 2:
                z = self.gelu_erf(z)
        return z

    def propagate(self, x: torch.Tensor, prefix: str, axis: int) -> torch.Tensor:
        y = x.movedim(axis, -1)
        y = self.gelu_erf(self.mm(y, self.P[f"{prefix}/w1"]) + self.P[f"{prefix}/b1"])
        y = self.mm(y, self.P[f"{prefix}/w2"]) + self.P[f"{prefix}/b2"]
        return x + y.movedim(-1, axis)

    def block(self, x: torch.Tensor, prefix: str, axis: str) -> torch.Tensor:
        """Pre-LN transformer block along ``axis`` of (B, T, H, W, C)."""
        dim = {"T": 1, "H": 2, "W": 3}[axis]
        z = x.movedim(dim, -2)  # (..., L, C): every other axis indexes a sequence
        P = lambda n: self.P[f"{prefix}/{n}"]  # noqa: E731
        c = z.shape[-1]
        d = c // self.heads
        zn = self.layer_norm(z, P("ln1_scale"), P("ln1_bias"))
        q = (self.mm(zn, P("wq")) + P("bq")) * d ** -0.5
        k = self.mm(zn, P("wk")) + P("bk")
        v = self.mm(zn, P("wv")) + P("bv")
        split = lambda t: t.reshape(*t.shape[:-1], self.heads, d)  # noqa: E731
        s = self.einsum("...lhd,...mhd->...hlm", split(q), split(k))
        if axis == "T":
            n = s.shape[-1]
            keep = torch.ones((n, n), dtype=torch.bool, device=s.device).tril()
            s = s.masked_fill(~keep, float("-inf"))
        w = torch.softmax(s, dim=-1)
        a = self.einsum("...hlm,...mhd->...lhd", w, split(v)).reshape(z.shape)
        z = z + self.mm(a, P("wo")) + P("bo")
        h = self.gelu_tanh(self.mm(self.layer_norm(z, P("ln2_scale"), P("ln2_bias")), P("w1"))
                           + P("b1"))
        z = z + self.mm(h, P("w2")) + P("b2")
        return z.movedim(-2, dim)

    def backbone(self, x: torch.Tensor, k: int) -> torch.Tensor:
        bb = f"blocks_{k}"
        x = self.propagate(x, f"{bb}/vertical_propagator", 2)
        x = self.propagate(x, f"{bb}/horizontal_propagator", 3)
        x = self.propagate(x, f"{bb}/temporal_propagator", 1)
        for i, axis in enumerate(self.axes[k]):
            x = self.block(x, f"{bb}/block_{i}", axis)
        return x

    def interprator(self, tokens: torch.Tensor, out_t: float, k: int) -> torch.Tensor:
        """tokens (B, L, C) -> r_t (B,): the per-token values clipped to
        [0, out_T - 1], their mean, plus 1.001."""
        pre = f"interprators_{k}"
        t = torch.relu(self.dense(tokens, f"{pre}/TorchDense_0"))
        t = torch.relu(self.dense(t, f"{pre}/TorchDense_1"))
        t = self.dense(t, f"{pre}/TorchDense_2")[..., 0]
        return t.clamp(0.0, out_t - 1.0).mean(dim=1) + RT_EPS

    # -- the model call -------------------------------------------------------
    def head(self, latents: torch.Tensor, u_last: torch.Tensor, out_t: float = 1.0):
        """Backbone and Taylor frames from the window's latents (B, T, h, w, C)
        and the expansion point u_last (B, 1, H, W, F).  -> frames
        (B, n, H, W, F), and r_t (B,) for an adaptive model."""
        t = self.in_t
        seq = [0.0] + [-i * self.dt for i in range(t - 1)]  # T = 4: [-2d, -d, 0, 0]
        cond = torch.tensor(seq[::-1], dtype=torch.float32, device=latents.device)
        x = self.film(latents, cond.reshape(1, t, 1, 1, 1), "t_encode")
        x = x + self.P["s_emb"] + self.P["t_emb"][:, :, None, None, :]
        derivs, rts = [], []
        for k in range(self.order):
            x = self.backbone(x, k)
            d = x[:, -1:]
            if not self.deg:
                b, _, h, w, c = d.shape
                tokens = d.reshape(b, h * w, c)
                rt = self.interprator(tokens, out_t, k)
                rts.append(rt)
                d = self.film(tokens, rt[:, None, None], f"modifiers_{k}").reshape(d.shape)
            derivs.append(self.decode(d, k))
        n = 1 if self.deg else max(1, int(math.floor(out_t + 1e-3)))
        frames = u_last.expand(-1, n, -1, -1, -1)
        for k, dk in enumerate(derivs):
            steps = torch.arange(1, n + 1, dtype=torch.float32, device=dk.device) * self.dt
            coeff = steps ** (k + 1) / math.factorial(k + 1)
            frames = frames + coeff[None, :, None, None, None] * dk
        if self.deg:
            return frames, None
        return frames, torch.stack(rts, dim=1).mean(dim=1)

    def __call__(self, window: torch.Tensor, out_t: float = 1.0):
        window = window[:, -self.in_t:]
        return self.head(self.encode(window), window[:, -1:], out_t)


def rollout_fixed(model: PlainTANTE, history: torch.Tensor, n_steps: int) -> torch.Tensor:
    """One frame per call, the window sliding by it: (B, n_steps, H, W, F)."""
    window, ys = history[:, -model.in_t:], []
    for _ in range(n_steps):
        y, _ = model(window)
        ys.append(y)
        window = torch.cat([window, y], dim=1)[:, -model.in_t:]
    return torch.cat(ys, dim=1)


def rollout_adaptive(model: PlainTANTE, history: torch.Tensor, n_steps: int, k: int):
    """Each call computes K = k Taylor frames and emits clip(floor(r_t of the
    first sample), 1, K) of them.  -> (frames (B, n_steps, ...), mean r_t of
    each call, frames emitted by each call)."""
    window, ys, rts, emits, done = history[:, -model.in_t:], [], [], [], 0
    while done < n_steps:
        frames, rt = model(window, float(k))
        emit = min(max(int(math.floor(float(rt[0]))), 1), k)
        ys.append(frames[:, :emit])
        window = torch.cat([window, frames], dim=1)[:, emit:emit + model.in_t]
        rts.append(float(rt.mean()))
        emits.append(emit)
        done += emit
    return torch.cat(ys, dim=1)[:, :n_steps], rts, emits
