"""How far f32 can decide AttentionUNet's training numbers: the same
``Trainer``-like steps (rollout in train mode, MSE, backward, global-norm
clip 1.0, AdamW 5e-5 / 1e-5) from the same seeded weights in f32 and in
float64, at ``configs/unet_att.yaml`` (depth 5) on 256x256x8 waves.

    python3 -m tante_tpu_torch.tools.zoo_conditioning [--device cpu] [--batch 2]
        [--rollout 1] [--steps 2] [--res 256]

Prints one JSON line: per optimizer step the f32 and float64 loss and
gradient norm and their relative gaps, and the worst relative L2 gap of a
BatchNorm running-statistics tensor.  At random initialisation each rollout
step multiplies the gradient by ~10 (train-mode BatchNorm over a fed-back
frame), and AdamW's first step is lr * sign(g) for every parameter, also where
f32 rounding (ReLU inputs near 0) sets the sign: both show here, and they set
what a comparison between two f32 runs (card and CPU, one rank and a mesh)
can hold.  Runs on the CPU by default.
"""

from __future__ import annotations

import argparse
import json

import torch

from tante_tpu_torch.config import instantiate, load_config
from tante_tpu_torch.convert import load_jax_params, seeded_jax_params
from tante_tpu_torch.data.datamodule import WaveDataModule
from tante_tpu_torch.train.optimizers import AdamW
from tante_tpu_torch.train.rollout import rollout_fixed


def run(dtype, args) -> list:
    # chip_smoke.py's parallel AttentionUNet cell: 2 trajectories of 8 frames.
    waves = dict(resolution=(args.res, args.res), n_trajectories=2, n_steps=8, with_t2=True,
                 with_pressure=True, seed=0)
    dm = WaveDataModule(batch_size=args.batch, n_steps_input=4, n_steps_output=args.rollout,
                        eval_steps_output=args.rollout, data_workers=1, seed=0,
                        device=args.device, waves=waves)
    model = instantiate(load_config("unet_att").model, dset_metadata=dm.train_dataset.metadata,
                        device=args.device)
    load_jax_params(model, seeded_jax_params(model, 0))
    if dtype == torch.float64:
        model.double()
        for m in model.modules():
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = dtype
    opt, clip = AdamW(lr=5e-5, weight_decay=1e-5).make(model.parameters())
    loader = dm.train_dataloader()
    loader.set_epoch(1)
    out = []
    for step, batch in enumerate(loader):
        if step == args.steps:
            break
        opt.zero_grad(set_to_none=True)
        x, y = batch["input"].to(dtype), batch["output"].to(dtype)
        pred = rollout_fixed(lambda w: model(w, deterministic=False), x, args.rollout, 1)
        loss = ((pred - y) ** 2).mean()
        loss.backward()
        norm = float(clip(model.parameters()))
        opt.step()
        out.append({"loss": float(loss.detach()), "grad_norm": norm,
                    "stats": {k: b.detach().double().cpu().clone()
                              for k, b in model.named_buffers()}})
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cpu")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--rollout", type=int, default=1, help="model calls a step")
    p.add_argument("--steps", type=int, default=2, help="optimizer steps")
    p.add_argument("--res", type=int, default=256)
    args = p.parse_args(argv)
    if args.device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    f32, f64 = run(torch.float32, args), run(torch.float64, args)
    steps = []
    for a, b in zip(f32, f64):
        steps.append({
            "loss_f32": a["loss"], "loss_f64": b["loss"],
            "loss_rel_gap": abs(a["loss"] - b["loss"]) / b["loss"],
            "grad_norm_f32": a["grad_norm"], "grad_norm_f64": b["grad_norm"],
            "grad_norm_rel_gap": abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"],
            "stats_worst_rel_l2": max(float((a["stats"][k] - v).norm() / v.norm())
                                      for k, v in b["stats"].items())})
    print(json.dumps({"config": "configs/unet_att.yaml", **vars(args), "steps": steps}))


if __name__ == "__main__":
    main()
