"""TANTE: Time-Adaptive Neural Taylor Expansion (counterpart of
``tante_tpu/models/tante.py``), with the CNN or the FNO encoder/decoder
(``enc_dec_type``).

  encode T frames -> latent grid (B, T, H_p, W_p, C)
  FiLM time-encode + position embeddings (added in the compute dtype)
  per Taylor order i: x = blocks_i(x); derivative = x[:, -1:]
    adaptive: r_t = interprator(tokens, out_T); tokens = FiLM(tokens, r_t)
  decode each derivative; Taylor sum u(t_i) = u(0) + sum_k d_k (i dt)^k / k!

Like the JAX model it always computes a static number of Taylor frames
(``output_length``, or ``n_frames(out_T)`` adaptive) and returns r_t; the
rollout decides how many are consumed.

``fused_blocks`` (as in the JAX model, default True) goes to every backbone
as ``AttnBackbone(fused=...)``: False runs the plain block math, no block
kernel, with the same parameters (a config sets ``model.fused_blocks=false``).

Parameters are created on the CPU from a seeded ``torch.Generator`` and the
module moves to ``device`` (CUDA unless the caller passes ``"cpu"``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.attn_backbone import AttnBackbone
from tante_tpu_torch.models.common import (
    Film,
    TorchDense,
    get_1d_sincos_pos_embed,
    get_2d_sincos_pos_embed,
    t_series,
)
from tante_tpu_torch.models.enc_dec_cnn import PATCH_MAP, DecCNN, EncCNN
from tante_tpu_torch.models.enc_dec_fno import DecFNO, EncFNO
from tante_tpu_torch.ops.backend import resolve_device
from tante_tpu_torch.ops.convs import morton_pyramid_ok, packed_patch_ok
from tante_tpu_torch.utils.profiling import count, span


class Interprator(nn.Module):
    """Confidence head: tokens (B, L, C) -> r_t (B,) in (ep, out_T - 1 + ep),
    with the straight-through clip of the per-token values."""

    def __init__(self, h_dim: int, ep: float = 1.001, dtype=torch.float32, gen=None):
        super().__init__()
        self.ep = ep
        self.TorchDense_0 = TorchDense(h_dim, h_dim // 2, dtype, gen)
        self.TorchDense_1 = TorchDense(h_dim // 2, h_dim // 4, dtype, gen)
        self.TorchDense_2 = TorchDense(h_dim // 4, 1, dtype, gen)

    def forward(self, x: torch.Tensor, out_T: float) -> torch.Tensor:
        t = torch.relu(self.TorchDense_0(x))
        t = torch.relu(self.TorchDense_1(t))
        t = self.TorchDense_2(t)[..., 0]  # (B, L)
        td = t.detach()
        t = t + torch.relu(-td) - torch.relu(td - (out_T - 1))
        return t.mean(dim=1) + self.ep


class TANTE(nn.Module):
    def __init__(
        self,
        in_T: int,
        dset_metadata: Optional[TanteMetadata] = None,
        taylor_order: int = 1,
        frame_interval: float = 1.0,
        output_length: int = 1,
        attn_axes: str = "THWTHWTHW",
        expanded_channel: int = 128,
        n_head: int = 8,
        mlp_ratio: float = 1.0,
        dropout: float = 0.0,
        enc_dec_type: str = "cnn",
        embed_dim: int = 256,
        patch_scale: int = 32,
        overlap_ratio: float = 0.0,
        modes1: int = 32,
        modes2: int = 32,
        deg: bool = True,
        fused_blocks: bool = True,
        fused_chain: int = 0,
        tp_mesh=None,
        dtype=torch.float32,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        with span("tante.init"):
            if enc_dec_type not in ("cnn", "fno"):
                raise ValueError(f"Unknown enc_dec_type '{enc_dec_type}'")
            dev = resolve_device(device)
            gen = torch.Generator().manual_seed(seed)
            md = dset_metadata
            shape = md.spatial_resolution if md else (128, 384)
            self.in_T = in_T
            self.taylor_order = taylor_order
            self.frame_interval = frame_interval
            self.output_length = output_length
            self.enc_dec_type = enc_dec_type
            self.patch_scale = patch_scale
            self.overlap_ratio = overlap_ratio
            self.deg = deg
            self.dtype = dtype
            self.H_p, self.W_p = shape[0] // patch_scale, shape[1] // patch_scale
            self.C = embed_dim

            axes = attn_axes.replace(" ", "")
            if set(axes) - set("THWLACXY-"):
                raise ValueError("There are invalid letters")
            blocks_axes = [p.strip() for p in axes.split("-")]
            if len(blocks_axes) != taylor_order:
                raise ValueError(
                    f"Block allocation doesn't match expansion order: expected "
                    f"{taylor_order} parts, got {len(blocks_axes)} (input='{axes}')."
                )

            enc_kw = dict(dset_metadata=md, embed_dim=embed_dim, patch_scale=patch_scale,
                          overlap_ratio=overlap_ratio, dtype=dtype, gen=gen)
            enc_cls, dec_cls = EncCNN, DecCNN
            if enc_dec_type == "fno":
                enc_cls, dec_cls = EncFNO, DecFNO
                enc_kw["modes"] = (modes1, modes2)
            self.encoder = enc_cls(**enc_kw)
            for i in range(taylor_order):
                self.add_module(f"decoders_{i}", dec_cls(**enc_kw))
            for i, block_axes in enumerate(blocks_axes):
                self.add_module(f"blocks_{i}", AttnBackbone(
                    (in_T, self.H_p, self.W_p, self.C), block_axes, n_head, mlp_ratio, dropout,
                    fused_chain=fused_chain, dtype=dtype, gen=gen, tp_mesh=tp_mesh,
                    fused=fused_blocks, expanded_channel=expanded_channel,
                ))
            self.t_emb = nn.Parameter(torch.from_numpy(get_1d_sincos_pos_embed(self.C, in_T)))
            self.s_emb = nn.Parameter(torch.from_numpy(
                get_2d_sincos_pos_embed(self.C, (self.H_p, self.W_p), flatten=False)
            ))
            self.register_buffer(
                "t_seq", torch.from_numpy(t_series(in_T, frame_interval)), persistent=False
            )
            self.t_encode = Film(self.C, 1, dtype, gen)
            if not deg:
                for i in range(taylor_order):
                    self.add_module(f"interprators_{i}", Interprator(self.C, dtype=dtype, gen=gen))
                    self.add_module(f"modifiers_{i}", Film(self.C, 1, dtype, gen))
            self.to(dev)

    @property
    def tp_mesh(self):
        return self.blocks_0.tp_mesh

    def set_tp_mesh(self, mesh) -> None:
        """Tensor parallelism for every block (the JAX model's ``tp_mesh``
        field, which its Trainer sets by ``clone``); ``parallel.shard_params``
        then leaves this rank's shards in the blocks."""
        for i in range(self.taylor_order):
            getattr(self, f"blocks_{i}").set_tp_mesh(mesh)

    @staticmethod
    def n_frames(out_T: float) -> int:
        """Static frame-slot count for adaptive calls with budget out_T."""
        return max(1, int(math.floor(out_T + 1e-3)))

    def packed_io_ok(self) -> bool:
        """Whether frames can stay in ``pack_patches(frames, p0)`` layout
        across a decode -> encode round trip: the CNN pyramid's stage 0 is a
        clean space-to-depth (stride == patch, no padding)."""
        return self.enc_dec_type == "cnn" and packed_patch_ok(
            PATCH_MAP[self.patch_scale][0], self.overlap_ratio)

    def morton_io_ok(self) -> bool:
        """Whether the Morton-packed fast path applies: the CNN pyramid with
        every stage a clean space-to-depth.  The FNO encoder/decoder works on
        physical frames only (its spectral layers need the grid)."""
        return self.enc_dec_type == "cnn" and morton_pyramid_ok(
            PATCH_MAP[self.patch_scale], self.overlap_ratio)

    def encode(self, inputs: torch.Tensor, packed=False) -> torch.Tensor:
        """(B, K, H, W, C) -> (B, K, H_p, W_p, C); packed=True takes
        ``pack_patches(frames, p0)`` (gate with ``packed_io_ok()``),
        packed="morton" ``morton_pack_grouped`` frames (``morton_io_ok()``)."""
        with span("tante.encode"):
            if packed:
                return self.encoder(inputs, packed_in=packed)
            return self.encoder(inputs)

    def head(self, latents: torch.Tensor, u_last: torch.Tensor, out_T: float = 1,
             deterministic: bool = True, packed=False,
             generator: torch.Generator | None = None):
        """Backbone + Taylor prediction from cached latents (B, T, H_p, W_p, C)
        and the expansion point u_last (B, 1, ...), in the decoders' layout:
        ``pack_patches`` frames if packed is True, morton rows if "morton"
        (the Taylor sum is elementwise, so any layout serves).
        ``deterministic=False`` turns the blocks' dropout on, drawn from
        ``generator``."""
        count("model_calls")
        with span("tante.head"):
            dt = self.dtype
            with span("tante.embed"):
                x = self.t_encode(latents, self.t_seq)
                x = x + self.s_emb.to(dt)
                x = x + self.t_emb[:, :, None, None, :].to(dt)

            derivatives, r_ts = [], []
            for i in range(self.taylor_order):
                with span("tante.blocks"):
                    x = getattr(self, f"blocks_{i}")(x, deterministic, generator)
                derivative = x[:, -1:]
                if not self.deg:
                    with span("tante.interprator"):
                        b = derivative.shape[0]
                        tokens = derivative.reshape(b, self.H_p * self.W_p, self.C)
                        rt = getattr(self, f"interprators_{i}")(tokens, out_T)
                        r_ts.append(rt)
                        tokens = getattr(self, f"modifiers_{i}")(tokens, rt)
                        derivative = tokens.reshape(b, 1, self.H_p, self.W_p, self.C)
                decoder = getattr(self, f"decoders_{i}")
                with span("tante.decode"):
                    derivatives.append(decoder(derivative, packed_out=packed) if packed
                                       else decoder(derivative))

            with span("tante.taylor"):
                n_out = self.output_length if self.deg else self.n_frames(out_T)
                derivs = torch.cat(derivatives, dim=1)
                # Taylor coefficients ((i+1) dt)^(k+1) / (k+1)!, built on the
                # device: a host-to-device copy here would block the host
                # every call.
                dev = derivs.device
                steps = torch.arange(1, n_out + 1, dtype=torch.float32,
                                     device=dev) * self.frame_interval
                orders = torch.arange(1, self.taylor_order + 1, dtype=torch.float32, device=dev)
                coeffs = (steps[:, None] ** orders / torch.cumprod(orders, 0)).to(derivs.dtype)
                outputs = torch.einsum("ik,bk...->bi...", coeffs, derivs) + u_last
                if self.deg:
                    return outputs
                return outputs, torch.stack(r_ts, dim=1).mean(dim=1)

    def forward(self, inputs: torch.Tensor, out_T: float = 1, deterministic: bool = True,
                generator: torch.Generator | None = None):
        """inputs (B, T, H, W, C) -> (B, n, H, W, C) [, r_t (B,) adaptive]."""
        if inputs.shape[1] != self.in_T:
            inputs = inputs[:, -self.in_T:]
        return self.head(self.encode(inputs), inputs[:, -1:], out_T, deterministic,
                         generator=generator)
