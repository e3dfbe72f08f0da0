"""The algorithm's work in TANTE, counted from the configuration's shapes.

Every multiply-add of a product is two operations, counted once, whatever
runs it (a 3xTF32 kernel issues three products for one: that is the
implementation's cost, not the algorithm's).  Elementwise work (norms,
softmax, activations, the Taylor sum) and the FiLM conditioning MLPs, which
take a few hundred thousand operations a call, are not counted.  A causal
block counts the query-key pairs its mask admits.  Bytes: each input of a
launch read once and each output written once, weights included.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

PATCH_MAP = {64: (4, 4, 4), 32: (4, 4, 2), 16: (4, 2, 2), 8: (2, 2, 2), 4: (2, 2, 1),
             2: (2, 1, 1)}
F32 = 4  # bytes


def block_work(seqs: int, length: int, c: int, hidden: int, causal: bool,
               itemsize: int = F32) -> Tuple[float, float]:
    """(operations, bytes) of one pre-LN transformer block over ``seqs``
    sequences of ``length`` tokens of width ``c``: q, k, v and the output
    projection, the MLP, and the scores and weighted sum of every admitted
    (query, key) pair; bytes of x in, y out and the block's 16 weights."""
    rows = seqs * length
    pairs = seqs * length * (length + 1) // 2 if causal else seqs * length * length
    ops = 2.0 * rows * (4 * c * c + 2 * c * hidden) + 2.0 * 2 * c * pairs
    weights = 4 * c * c + 2 * c * hidden + 9 * c + hidden
    return ops, float(itemsize * (2 * rows * c + weights))


def latent_grid(model: dict, resolution: Sequence[int]) -> Tuple[int, int]:
    return resolution[0] // model["patch_scale"], resolution[1] // model["patch_scale"]


def blocks_of_call(model: dict, resolution: Sequence[int], batch: int) -> List[tuple]:
    """(seqs, length, causal) of each block of one model call on ``batch``
    samples, in order."""
    t = model["in_T"]
    hp, wp = latent_grid(model, resolution)
    shape = {"T": (batch * hp * wp, t, True), "H": (batch * t * wp, hp, False),
             "W": (batch * t * hp, wp, False)}
    axes = model["attn_axes"].replace(" ", "").replace("-", "")
    return [shape[a] for a in axes]


def block_bound_s(model: dict, resolution: Sequence[int], batch: int, flops_peak: float,
                  bytes_peak: float) -> Tuple[float, str]:
    """The least time of one call's blocks, each launch bounded by the
    larger of its operations at ``flops_peak`` and its bytes at
    ``bytes_peak``; and which of the two bounds most of that time."""
    c, hidden = model["embed_dim"], int(model["embed_dim"] * model["mlp_ratio"])
    total, by_ops = 0.0, 0.0
    for seqs, length, causal in blocks_of_call(model, resolution, batch):
        ops, nbytes = block_work(seqs, length, c, hidden, causal)
        t_ops, t_mem = ops / flops_peak, nbytes / bytes_peak
        total += max(t_ops, t_mem)
        by_ops += max(t_ops, t_mem) if t_ops >= t_mem else 0.0
    return total, ("operations" if by_ops >= total / 2 else "bytes")


def encode_ops(model: dict, resolution: Sequence[int], n_fields: int) -> float:
    """One frame through the three patch convs."""
    p = PATCH_MAP[model["patch_scale"]]
    c = model["embed_dim"]
    widths = (n_fields, c // 4, c // 2, c)
    h, w = resolution
    ops = 0.0
    for i, pi in enumerate(p):
        h, w = h // pi, w // pi
        ops += 2.0 * h * w * pi * pi * widths[i] * widths[i + 1]
    return ops


def decode_ops(model: dict, resolution: Sequence[int], n_fields: int) -> float:
    """One derivative frame through the three transposed patch convs: the
    same products as the encoder's, in reverse."""
    return encode_ops(model, resolution, n_fields)


def head_ops(model: dict, resolution: Sequence[int]) -> float:
    """One sample's backbone per model call: the H, W and T mixers, the
    blocks, and an adaptive model's interprator; no decoder."""
    t, c = model["in_T"], model["embed_dim"]
    hidden = int(c * model["mlp_ratio"])
    hp, wp = latent_grid(model, resolution)
    tokens = t * hp * wp
    mixers = 2.0 * 2 * tokens * c * (hp + wp + t)  # two (a x a) products along each axis
    blocks = sum(block_work(s, l, c, hidden, causal)[0]
                 for s, l, causal in blocks_of_call(model, resolution, 1))
    interp = 0.0 if model["deg"] else 2.0 * hp * wp * (c * c // 2 + c // 2 * c // 4 + c // 4)
    return model["taylor_order"] * (mixers + blocks + interp)


def call_ops(model: dict, resolution: Sequence[int], n_fields: int) -> float:
    """One sample's model call on latents already encoded: backbone, head
    and one decoded derivative per Taylor order."""
    return (head_ops(model, resolution)
            + model["taylor_order"] * decode_ops(model, resolution, n_fields))


def rollout_ops(model: dict, resolution: Sequence[int], n_fields: int, batch: int,
                emits: Sequence[int]) -> float:
    """A rollout whose calls emitted ``emits`` frames each: every call, and
    the encoder over each distinct frame that enters a window (the history,
    then every emitted frame but the last call's)."""
    encodes = model["in_T"] + sum(emits[:-1])
    return batch * (len(emits) * call_ops(model, resolution, n_fields)
                    + encodes * encode_ops(model, resolution, n_fields))
