"""Repeated launches of the f32 tp halves and the f32 block kernels on the card:
launch-to-launch equality and agreement with the plain versions.

    python3 -m tante_tpu_torch.tools.half_repeat [--repeats N] [--csrc DIR]

For the flagship's H, W and causal T shapes at tp 2 and H at tp 4, both
softmax forms: ``N`` fresh inputs, and per input and shard two launches of
each f32 half (``attn_half_apply`` / ``mlp_half_apply``): whether the two are
equal bit for bit, and the worse one's relative L2 to the plain half (f32,
TF32 off).  Then the f32 block kernel (``fused_block_apply``) at H and W, two
launches per input.  Then the f32 long entry (``fused_block_long``) at the
flagship's C block (24,576 sequences of 256 channels, 128 wide, head dim 16;
plain on the first 512) and L block (32 x 768, C 256), two launches per
input; then, at the same shapes, the f32 long attention half
(``attn_half_apply`` at L > 64: ``fused_half_long_sm90.cu``) on every shard
at tp 2, two launches per input and shard.  Last the four qkv kernels of
the long pairs alone (``long_qkv_fwd``; ``half_long_qkv_fwd`` on both
shards at tp 2), bf16 and f32, at the same C and L blocks: two launches per
input, their workspaces compared bit for bit (a staging buffer written again
before its bulk store had read it would show here).  A race in a kernel
shows as unequal launch pairs.

``--csrc DIR`` builds the f32 halves and the block kernels from DIR's sources
(``fused_half_sm90_f32.cu``, ``fused_block_sm90.cu``, ``fused_block_long_sm90.cu``,
``fused_half_long_sm90.cu`` and the headers beside them) in place of this tree's: a copy of
``tante_tpu_torch/ops/csrc`` with one edit measures that edit (e.g. without the slab fence of
``block_sm90.cuh:gemm_f32``).  Prints one JSON line per kernel and shape, the
card's name and power limit first.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from tante_tpu_torch.ops import _build
from tante_tpu_torch.ops import fused_block as fb
from tante_tpu_torch.parallel.sharding import shard_block

C, HEADS = 256, 8  # the flagship's width and heads, MLP ratio 1
# (label, rows, L, causal, tp): the flagship's blocks (T rearranged) at tp 2, H at tp 4.
CASES = [("H", 1536, 16, False, 2), ("W", 512, 48, False, 2), ("T", 6144, 4, True, 2),
         ("H", 1536, 16, False, 4)]
# (label, sequences, L, width): the flagship's long blocks; plain on at most
# LONG_PLAIN_SEQS sequences.
LONG_CASES = [("C", 24576, 256, 128), ("L", 32, 768, 256)]
LONG_PLAIN_SEQS = 512


def block_params(seed: int, dev, c: int = C) -> fb.BlockParams:
    rng = np.random.default_rng(seed)

    def u(*shape, fan_in=None, scale=1.0, offset=0.0):
        bound = 1.0 / np.sqrt(fan_in or shape[0])
        a = offset + scale * rng.uniform(-bound, bound, size=shape)
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    return fb.BlockParams(
        ln1_scale=u(c, scale=0.1, offset=1.0), ln1_bias=u(c, scale=0.1),
        wq=u(c, c), bq=u(c), wk=u(c, c), bk=u(c), wv=u(c, c), bv=u(c), wo=u(c, c), bo=u(c),
        ln2_scale=u(c, scale=0.1, offset=1.0), ln2_bias=u(c, scale=0.1),
        w1=u(c, c), b1=u(c), w2=u(c, c), b2=u(c))


def halves(p: fb.BlockParams) -> tuple:
    return (fb.AttnHalfParams(*(getattr(p, f) for f in fb.AttnHalfParams._fields)),
            fb.MlpHalfParams(*(getattr(p, f) for f in fb.MlpHalfParams._fields)))


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def use_sources(csrc: Path) -> None:
    """Build the f32 halves and the block kernels from ``csrc`` and make the
    wrappers launch them (the loaded libraries ``_build.load`` hands out)."""
    kernels = ("fused_half_sm90_f32", "fused_block_sm90", "fused_block_long_sm90",
               "fused_half_long_sm90")
    built = _build.compile_libraries([(k, f"{k}_repeat", (), csrc / f"{k}.cu") for k in kernels])
    for k, info in zip(kernels, built):
        _build._libs[k] = _build.bind(ctypes.CDLL(info["library"]), k)


def pair(run, plain) -> tuple[bool, float]:
    a, b = run(), run()
    torch.cuda.synchronize()
    want = plain()
    return bool(torch.equal(a, b)), max(rel_l2(a, want), rel_l2(b, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--repeats", type=int, default=12, help="fresh inputs per shape")
    ap.add_argument("--csrc", type=Path, help="build the kernels from this source directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("half_repeat needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    if args.csrc:
        use_sources(args.csrc)
    for label, rows, l, causal, tp in CASES:
        p = block_params(l + tp, dev)
        for softmax in ("fast", "safe"):
            fb.set_block_tuning(softmax=softmax)
            stats = {"attn": [], "mlp": []}
            for it in range(args.repeats):
                x = torch.from_numpy(np.random.default_rng(it).normal(size=(rows, l, C)).astype(
                    np.float32)).to(dev)
                for r in range(tp):
                    ap_, mp = halves(shard_block(p, tp, r))
                    stats["attn"].append(pair(
                        lambda: fb.attn_half_apply(x, ap_, l, HEADS // tp, causal),
                        lambda: fb.attn_half_ref(x, ap_, l, HEADS // tp, causal)))
                    stats["mlp"].append(pair(lambda: fb.mlp_half_apply(x, mp),
                                             lambda: fb.mlp_half_ref(x, mp)))
            for kind, res in stats.items():
                print(json.dumps({"kernel": f"{kind}_half_fwd (f32)", "case": label, "tp": tp,
                                  "softmax": softmax, "launch_pairs": len(res),
                                  "pairs_unequal": sum(not eq for eq, _ in res),
                                  "worst_rel_l2": max(rel for _, rel in res),
                                  "median_rel_l2": float(np.median([rel for _, rel in res]))}),
                      flush=True)
    fb.set_block_tuning(softmax="fast")
    for label, rows, l, causal, _ in CASES[:2]:
        p = block_params(l, dev)
        res = []
        for it in range(args.repeats):
            x = torch.from_numpy(np.random.default_rng(100 + it).normal(size=(rows, l, C)).astype(
                np.float32)).to(dev)
            res.append(pair(lambda: fb.fused_block_apply(x, p, l, HEADS, causal),
                            lambda: fb.block_ref(x, p, l, HEADS, causal)))
        print(json.dumps({"kernel": "fused_block_fwd (f32)", "case": label,
                          "launch_pairs": len(res), "pairs_unequal": sum(not eq for eq, _ in res),
                          "worst_rel_l2": max(rel for _, rel in res)}), flush=True)
    for label, rows, l, c in LONG_CASES:
        p = block_params(l + c, dev, c)
        n = min(rows, LONG_PLAIN_SEQS)
        res = []
        gen = torch.Generator(device=dev)
        for it in range(args.repeats):
            gen.manual_seed(200 + it)  # 3.2 GB at C: drawn on the card
            x = torch.randn((rows, l, c), generator=gen, device=dev)
            a, b = (fb.fused_block_long(x, p, l, HEADS, False) for _ in range(2))
            torch.cuda.synchronize()
            want = fb.block_ref(x[:n], p, l, HEADS, False)
            res.append((bool(torch.equal(a, b)), max(rel_l2(a[:n], want), rel_l2(b[:n], want))))
            del x, a, b, want
        print(json.dumps({"kernel": "fused_block_long (f32)", "case": label,
                          "shape": [rows, l, c], "launch_pairs": len(res),
                          "pairs_unequal": sum(not eq for eq, _ in res),
                          "worst_rel_l2": max(rel for _, rel in res)}), flush=True)
        res = []
        for it in range(args.repeats):
            gen.manual_seed(300 + it)
            x = torch.randn((rows, l, c), generator=gen, device=dev)
            for r in range(2):
                ap = halves(shard_block(p, 2, r))[0]
                a, b = (fb.attn_half_apply(x, ap, l, HEADS // 2, False) for _ in range(2))
                torch.cuda.synchronize()
                want = fb.attn_half_ref(x[:n], ap, l, HEADS // 2, False)
                res.append((bool(torch.equal(a, b)),
                            max(rel_l2(a[:n], want), rel_l2(b[:n], want))))
                del a, b, want
            del x
        print(json.dumps({"kernel": "attn_half_long (f32)", "case": label, "tp": 2,
                          "shape": [rows, l, c], "launch_pairs": len(res),
                          "pairs_unequal": sum(not eq for eq, _ in res),
                          "worst_rel_l2": max(rel for _, rel in res)}), flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        for label, rows, l, c in LONG_CASES:
            p = fb.BlockParams(*(t.to(dtype) for t in block_params(l + c + 7, dev, c)))
            plan = fb.long_plan(c, c, HEADS, dtype)
            w = fb.sm90_weights(p, HEADS, plan)
            shards = []
            for r in range(2):
                ap = halves(shard_block(p, 2, r))[0]
                hplan = fb.half_long_plan(c, c // 2, HEADS // 2, dtype)
                shards.append((fb.half_long_weights(ap, HEADS // 2, hplan), hplan))
            block, half = [], []
            gen = torch.Generator(device=dev)
            for it in range(args.repeats):
                gen.manual_seed(400 + it)
                x = torch.randn((rows, l, c), generator=gen, device=dev).to(dtype)
                a, b = (fb.long_qkv_fwd(x, w, plan, l) for _ in range(2))
                torch.cuda.synchronize()
                block.append(bool(torch.equal(a, b)))
                del a, b
                for hw, hplan in shards:
                    a, b = (fb.half_long_qkv_fwd(x, hw, hplan, l, c // 2) for _ in range(2))
                    torch.cuda.synchronize()
                    half.append(bool(torch.equal(a, b)))
                    del a, b
                del x
            for kernel, res, pl in (("long_qkv_fwd", block, plan),
                                    ("half_long_qkv_fwd (tp 2, both shards)", half, hplan)):
                print(json.dumps({"kernel": f"{kernel} ({name})", "case": label,
                                  "shape": [rows, l, c], "launch_pairs": len(res),
                                  "pairs_unequal": sum(not eq for eq in res),
                                  "qkv_resident": pl.qkv_resident, "qkv_parts": pl.qkv_parts}),
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
