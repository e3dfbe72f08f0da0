"""What each rank of a spawned CPU process group runs in
``tests/test_torch_parallel.py`` and ``tests/test_torch_tp_adaptive.py``
(gloo, ``file://`` rendezvous).  Torch and
the port only: the JAX side is computed in the test process.  Every case
runs in its own ``try`` and comes back as numpy arrays or as the traceback
that stopped it, so one failing case fails only its own test."""

from __future__ import annotations

import traceback
from pathlib import Path

import numpy as np
import torch

from tante_tpu_torch.convert import load_jax_params
from tante_tpu_torch.data.datamodule import WaveDataModule
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.common import FusedTransformerBlock
from tante_tpu_torch.models.fno import FNO
from tante_tpu_torch.models.tante import TANTE
from tante_tpu_torch.ops import fused_block as fb
from tante_tpu_torch.parallel import dp_tp_mesh, gather_params, make_mesh, replicated, shard_params
from tante_tpu_torch.models.unet_att import AttentionUNet
from tante_tpu_torch.ops.norms import BatchNorm
from tante_tpu_torch.parallel.halo import (
    halo_exchange,
    sharded_conv2d,
    sharded_irfft2,
    sharded_rfft2,
    sharded_spectral_conv2d_centered,
    spatial_sharding,
)
from tante_tpu_torch.parallel.collectives import psum
from tante_tpu_torch.parallel.sharding import shard_block
from tante_tpu_torch.train.metrics import L2RE, MSE
from tante_tpu_torch.train.optimizers import AdamW
from tante_tpu_torch.train.r_trainer import R_Trainer
from tante_tpu_torch.train.rollout import rollout_adaptive_train_vf
from tante_tpu_torch.train.trainer import Trainer

# The small TANTE of the tp model test (tests/test_parallel.py:613-672).
TP_TANTE = dict(in_T=4, taylor_order=1, attn_axes="THW", embed_dim=32, patch_scale=8, n_head=4,
                output_length=1, deg=True)
TP_RES, TP_FIELDS = (16, 32), 3
# A small TANTE with long axes under tp: the L block attends over 8 x 10 = 80
# latent tokens, the channel block over the 128 channels (64 wide, head dim
# 16): both past the short halves' 64.
LONG_TP_TANTE = dict(in_T=4, taylor_order=1, attn_axes="THWLC", embed_dim=128, patch_scale=8,
                     n_head=4, output_length=1, deg=True, expanded_channel=64)
LONG_TP_RES = (64, 80)
# AttentionUNet under sp / dp: depth 2 keeps 8 local rows even at sp 2.
UNET = dict(in_T=4, depth=2, out_T=1)
# Trainer cases: in-memory waves, global batch 2, two steps.
TRAIN_WAVES = dict(resolution=(16, 32), n_trajectories=2, n_steps=10, seed=0)
TRAIN_FNO = dict(in_T=2, modes1=4, modes2=4, hidden_channels=8, n_layers=2)


def tante_metadata(res=TP_RES, fields=TP_FIELDS, cls=TanteMetadata):
    """The port's metadata, or ``cls``'s (the JAX package's) with the same fields."""
    return cls(
        dataset_name="tp", n_spatial_dims=2, spatial_resolution=tuple(res),
        field_names={0: ["f"] * fields, 1: [], 2: []}, boundary_condition_types=["PERIODIC"],
        n_files=1, n_trajectories_per_file=[1], n_steps_per_trajectory=[8], n_fields=fields)


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(requires_grad)


def np_(t):
    return t.detach().float().cpu().numpy()


# ---- cases -----------------------------------------------------------------


# Megatron split of FusedTransformerBlock's flat parameters: the dimension
# cut over tp (parallel/sharding.py's rules).
SPLIT_DIM = {"wq": 1, "wk": 1, "wv": 1, "w1": 1, "bq": 0, "bk": 0, "bv": 0, "b1": 0, "wo": 0,
             "w2": 0}


def block_tp(mesh, x, params, l, heads, causal):
    """fused_block_apply_tp on this rank's rows (dp) and shards (tp), with
    gradients of sum(y**2) over the global rows."""
    tp, r, dp = mesh.size("tp"), mesh.index("tp"), mesh.index("dp")
    rows = x.shape[0] // mesh.size("dp")
    x_loc = _t(x[dp * rows:(dp + 1) * rows], True)
    p = fb.BlockParams(*(_t(a) for a in params))
    if fb.tp_fusable(x.shape[-1], heads, p.w1.shape[-1], tp):
        p = shard_block(p, tp, r)
    p = fb.BlockParams(*(t.clone().requires_grad_(True) for t in p))
    y = fb.fused_block_apply_tp(x_loc, p, l, heads, causal, mesh)
    (y ** 2).sum().backward()
    return {"y": np_(y), "gx": np_(x_loc.grad), "gp": [np_(t.grad) for t in p]}


def tp_model_forward(mesh, flat, x, long_axes=False):
    """The small TANTE with tp_mesh (``long_axes``: LONG_TP_TANTE at
    LONG_TP_RES), full JAX weights loaded then split; this rank's dp block
    of the batch."""
    md = tante_metadata(res=LONG_TP_RES) if long_axes else tante_metadata()
    model = TANTE(dset_metadata=md, tp_mesh=mesh, device="cpu",
                  **(LONG_TP_TANTE if long_axes else TP_TANTE))
    load_jax_params(model, flat, mesh)
    b = x.shape[0] // mesh.size("dp")
    xl = _t(x[mesh.index("dp") * b:(mesh.index("dp") + 1) * b])
    with torch.no_grad():
        y = model.eval()(xl)
    split = sorted(k for k, p in model.named_parameters() if hasattr(p, "tp_dim"))
    return {"y": np_(y), "split": split}


def tp_dropout_forward(mesh, flat, x, seed):
    """One training-mode forward with dropout 0.1 on the split weights."""
    model = TANTE(dset_metadata=tante_metadata(), tp_mesh=mesh, dropout=0.1, device="cpu",
                  **TP_TANTE)
    load_jax_params(model, flat, mesh)
    gen = torch.Generator().manual_seed(seed)
    y = model.train()(_t(x), deterministic=False, generator=gen)
    return {"y": np_(y)}


def spectral_sp(mesh, x, w, modes):
    n, i = mesh.size("sp"), mesh.index("sp")
    h = x.shape[1] // n
    y = sharded_spectral_conv2d_centered(mesh, _t(x[:, i * h:(i + 1) * h]), _t(w), modes, modes)
    return {"y": np_(y)}


def fno_sp_forward(mesh, flat, x, kw):
    md = tante_metadata(res=x.shape[2:4], fields=x.shape[-1])
    model = FNO(dset_metadata=md, sp_mesh=mesh, device="cpu", **kw)
    load_jax_params(model, flat)
    n, i = mesh.size("sp"), mesh.index("sp")
    h = x.shape[2] // n
    with torch.no_grad():
        y = model.eval()(_t(x[:, :, i * h:(i + 1) * h]))
    return {"y": np_(y)}


def train_run(mesh, workdir, model_kind, steps=2, dropout=0.0):
    """Two optimizer steps of the port's Trainer on in-memory waves; the
    step losses and gradient norms, rank 0's gathered parameters after
    them, and the checkpoint it saved."""
    dm = WaveDataModule(batch_size=2, n_steps_input=4 if model_kind == "tante" else 2,
                        n_steps_output=2, eval_steps_output=2, data_workers=1, seed=0,
                        device="cpu", waves=TRAIN_WAVES)
    md = dm.train_dataset.metadata
    if model_kind == "tante":
        kw = dict(TP_TANTE, dropout=dropout)
        model = TANTE(dset_metadata=md, device="cpu", **kw)
    else:
        model = FNO(dset_metadata=md, layout="wc", device="cpu", **TRAIN_FNO)
    def make(model, **kw):
        return Trainer(str(workdir), "channels_first_default", model, dm, AdamW(lr=1e-3),
                       MSE(), L2RE(), max_epoch=1, n_steps_output=2, n_steps_rollout=2, seed=0,
                       mesh=mesh, device="cpu", **kw)

    trainer = make(model)
    losses, norms = [], []
    for step, batch in enumerate(dm.train_dataloader()):
        if step == steps:
            break
        (x,), y = trainer.formatter.process_input(batch)
        losses.append(float(trainer.train_step(x, y)))
        norms.append(float(trainer.last_grad_norm))
    out = {"losses": losses, "norms": norms}
    if mesh is not None:
        out["split"] = sorted(k for k, p in trainer.model.named_parameters()
                              if hasattr(p, "tp_dim"))
        full = gather_params(trainer.model, mesh)
        out["params"] = {k: np_(v) for k, v in full.items()}
        out["local"] = {k: np_(v) for k, v in trainer.model.state_dict().items()}
        trainer.save_model(1, 0.5, "recent")
        out["ckpt"] = str(workdir / "recent")
        # Resume re-splits the full tensors: the same local parameters and moments.
        fresh = TANTE(dset_metadata=md, device="cpu", **kw) if model_kind == "tante" else FNO(
            dset_metadata=md, layout="wc", device="cpu", **TRAIN_FNO)
        resumed = make(fresh, checkpoint_path=out["ckpt"])
        out["resume_equal"] = all(
            torch.equal(a, b) for a, b in zip(trainer.model.state_dict().values(),
                                              resumed.model.state_dict().values())) and all(
            torch.equal(sa[k], sb[k])
            for sa, sb in zip(trainer.optimizer.state.values(), resumed.optimizer.state.values())
            for k in ("exp_avg", "exp_avg_sq"))
    return out


def r_train_run(mesh, workdir, flat, x, y, model_kw, rkw, steps=2):
    """The port's R_Trainer on one global batch (this rank's dp block of
    it): first its validation step (the loss, the r_t log and the model
    calls of the adaptive rollout at out_T = n_steps_rollout, and the first
    call's per-sample r_t), then ``steps`` optimizer steps: per step the
    loss and r_t statistics, then the parameters."""
    res, n_in, n_out = x.shape[2:4], x.shape[1], y.shape[1]
    waves = dict(TRAIN_WAVES, resolution=res, n_steps=12, with_pressure=x.shape[-1] == 4)
    dm = WaveDataModule(batch_size=x.shape[0], n_steps_input=n_in, n_steps_output=n_out,
                        device="cpu", waves=waves)
    model = TANTE(dset_metadata=tante_metadata(res, x.shape[-1]), device="cpu", **model_kw)
    load_jax_params(model, flat)
    trainer = R_Trainer(str(workdir), "channels_last_default", model, dm, AdamW(lr=1e-3),
                        MSE(), L2RE(), max_epoch=1, n_steps_output=n_out, n_steps_rollout=n_out,
                        seed=0, mesh=mesh, device="cpu", **rkw)
    dp, i = (1, 0) if mesh is None else (mesh.size("dp"), mesh.index("dp"))
    b = x.shape[0] // dp
    xl, yl = _t(x[i * b:(i + 1) * b]), _t(y[i * b:(i + 1) * b])
    with torch.no_grad():
        first_rt = trainer.model(xl, float(n_out))[1]
    loss, rt_log, n_calls = trainer.eval_step(xl, yl)
    val = {"loss": float(loss), "rt_log": np_(rt_log[:n_calls]), "n_calls": n_calls,
           "first_rt": np_(first_rt)}
    stats = [[float(v) for v in trainer.train_step(xl, yl)] for _ in range(steps)]
    return {"val": val, "stats": stats,
            "params": {k: np_(v) for k, v in trainer.model.state_dict().items()}}


def r_train_steps(mesh, workdir, flat, x, y, model_kw, rkw, steps=2, save=False, resume=""):
    """The port's R_Trainer on one batch that every rank holds whole (the
    tp ranks of one dp rank, or one device): ``steps`` optimizer steps, per
    step the loss, r_t mean and spread, calls, gradient norm and the
    rollout's cums and r_t; then its validation step (loss, r_t log, model
    calls); the full parameters after the steps; with ``save``, the
    checkpoint rank 0 wrote and one more step's statistics; with ``resume``
    (a checkpoint), the parameters it started from."""
    res, n_in, n_out = x.shape[2:4], x.shape[1], y.shape[1]
    waves = dict(TRAIN_WAVES, resolution=res, n_steps=12, with_pressure=x.shape[-1] == 4)
    dm = WaveDataModule(batch_size=x.shape[0], n_steps_input=n_in, n_steps_output=n_out,
                        device="cpu", waves=waves)
    model = TANTE(dset_metadata=tante_metadata(res, x.shape[-1]), device="cpu", **model_kw)
    load_jax_params(model, flat)
    trainer = R_Trainer(str(workdir), "channels_last_default", model, dm, AdamW(lr=1e-3),
                        MSE(), L2RE(), max_epoch=1, n_steps_output=n_out, n_steps_rollout=n_out,
                        seed=0, mesh=mesh, device="cpu", checkpoint_path=resume, **rkw)
    rollouts, objective = [], trainer._adaptive_loss

    def kept(*args):  # the objective, its rollout record kept
        out = objective(*args)
        rollouts.append(out[4])
        return out

    trainer._adaptive_loss = kept
    xt, yt = _t(x), _t(y)

    def step():
        stats = [float(v) for v in trainer.train_step(xt, yt)]
        r = rollouts[-1]
        return {"stats": stats, "grad_norm": float(trainer.last_grad_norm), "rts": np_(r["rts"]),
                "cums": None if r["cums"] is None else r["cums"].numpy()}

    # Copies: np_ of a CPU parameter shares its storage, which the steps update.
    out = ({"start": {k: np_(v).copy() for k, v in trainer.model.state_dict().items()}}
           if resume else {})
    out["steps"] = [step() for _ in range(steps)]
    loss, rt_log, n_calls = trainer.eval_step(xt, yt)
    out["val"] = {"loss": float(loss), "rt_log": np_(rt_log[:n_calls]), "n_calls": n_calls}
    out["split"] = sum(hasattr(p, "tp_dim") for p in trainer.model.parameters())
    full = gather_params(trainer.model, mesh) if mesh is not None else trainer.model.state_dict()
    out["params"] = {k: np_(v).copy() for k, v in full.items()}
    if save:
        trainer.save_model(1, 0.5, "recent")
        out["ckpt"] = str(Path(workdir) / "recent")
        out["next_step"] = step()
    return out


# Which samples of the stand-in rollout (test_torch_adaptive_train's
# engine_inputs: r_t centres 2.6, 3.4, 5.7) each rank holds: rank 0's sample
# consumes in slots 0-2, rank 1's two samples only in slots 0-1.
SLOT_SAMPLES = ([0], [1, 2])


def vf_slot_decision(mesh, x, wm, v, g, h, centres, k, n_steps, remat):
    """``rollout_adaptive_train_vf`` on this rank's samples of one batch,
    under the mesh's group, with a stand-in model (the engine test's
    ``torch_model``) whose every call all-reduces over the group, as a tp
    block's halves do.  The ranks' own ``active`` flags differ in slot 2; a
    rank that skipped a slot its peer calls would leave the peer's
    all-reduce waiting.  -> the rollout, the gradients of the engine test's
    loss on this rank's samples, the model calls made."""
    group = mesh.group(*mesh.axis_names)
    idx = SLOT_SAMPLES[mesh.rank]
    twm, tv = _t(wm, True), _t(v, True)
    calls = []

    def apply(win):
        calls.append(1)
        last = win[:, -1:]
        d = torch.einsum("bthwc,cd->bthwd", last, twm)
        d = d + 0.0 * psum(d.sum(), group)  # a collective in every call, forward and back
        frames = torch.cat([last + 0.1 * (j + 1) * d for j in range(k)], dim=1)
        rt = torch.from_numpy(centres[idx]) + 0.02 * torch.tanh((last * tv).mean(dim=(1, 2, 3, 4)))
        return frames, rt

    y, rts, act, cums = rollout_adaptive_train_vf(apply, _t(x[idx]), n_steps, k, remat=remat,
                                                  group=group)
    (torch.sum(y * _t(g[idx])) + torch.sum(rts * act * _t(h[:, idx]))).backward()
    return {"y": np_(y), "rts": np_(rts), "act": act.numpy(), "cums": cums.numpy(),
            "gwm": np_(twm.grad), "gv": np_(tv.grad), "calls": len(calls)}


def halo_case(mesh, x, r, halo, periodic):
    """halo_exchange of this rank's rows of x (B, H, W, C) and the gradient
    of sum(out * r_i), r_i this rank's slice of ``r`` (n, B, H/n + 2 halo, W, C)."""
    x_loc = _t(spatial_sharding(mesh)(x), True)
    y = halo_exchange(x_loc, halo, mesh, periodic=periodic)
    (y * _t(r[mesh.index("sp")])).sum().backward()
    return {"y": np_(y), "gx": np_(x_loc.grad)}


def sharded_ops(mesh, x, kernel, r):
    """sharded_conv2d (zero edges) with its input gradient against ``r``'s
    rows; sharded_rfft2; sharded_irfft2 of it, and the gradient of
    sum(irfft2(rfft2(x)) * r) (the round trip is the identity: r itself)."""
    rows = spatial_sharding(mesh)
    x_loc = _t(rows(x), True)
    y = sharded_conv2d(mesh, _t(kernel), x_loc)
    (y * _t(rows(r))[..., :y.shape[-1]]).sum().backward()
    out = {"conv": np_(y), "conv_gx": np_(x_loc.grad)}
    x_loc = _t(rows(x), True)
    xf = sharded_rfft2(mesh, x_loc)
    back = sharded_irfft2(mesh, xf, x.shape[2])
    (back * _t(rows(r))).sum().backward()
    out.update(spec=xf.detach().numpy(), back=np_(back), round_trip_gx=np_(x_loc.grad))
    return out


def unet_sp_forward(mesh, flat, x):
    """AttentionUNet on this rank's rows (its BatchNorm statistics over the
    whole mesh): the eval output, then the train-mode output and the
    statistics that call left."""
    model = AttentionUNet(dset_metadata=tante_metadata(res=x.shape[2:4], fields=x.shape[-1]),
                          device="cpu", **UNET)
    load_jax_params(model, flat)
    model.set_sp_mesh(mesh)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = mesh.group("dp", "sp")
    n, i = mesh.size("sp"), mesh.index("sp")
    h = x.shape[2] // n
    with torch.no_grad():
        y_eval = model(_t(x[:, :, i * h:(i + 1) * h]))
        y_train = model(_t(x[:, :, i * h:(i + 1) * h]), deterministic=False)
    return {"y_eval": np_(y_eval), "y_train": np_(y_train),
            "stats": {k: np_(b) for k, b in model.named_buffers()}}


def unet_train_run(mesh, workdir, flat, steps=2):
    """Two Trainer steps on AttentionUNet (seeded weights ``flat``): the
    losses, gradient norms and BatchNorm statistics of each step, the
    parameters after them, the validation loss, and the rows a batch holds
    here."""
    dm = WaveDataModule(batch_size=2, n_steps_input=4, n_steps_output=2, eval_steps_output=2,
                        data_workers=1, seed=0, device="cpu", waves=TRAIN_WAVES)
    model = AttentionUNet(dset_metadata=dm.train_dataset.metadata, device="cpu", **UNET)
    load_jax_params(model, flat)
    trainer = Trainer(str(workdir), "channels_first_default", model, dm, AdamW(lr=1e-3),
                      MSE(), L2RE(), max_epoch=1, n_steps_output=2, n_steps_rollout=2, seed=0,
                      mesh=mesh, device="cpu")
    losses, norms, stats, rows = [], [], [], 0
    for step, batch in enumerate(dm.train_dataloader()):
        if step == steps:
            break
        rows = batch["input"].shape[2]
        (x,), y = trainer.formatter.process_input(batch)
        losses.append(float(trainer.train_step(x, y)))
        norms.append(float(trainer.last_grad_norm))
        stats.append({k: np_(b).copy() for k, b in trainer.model.named_buffers()})
    val = trainer.validation_loop(dm.val_dataloader())
    return {"losses": losses, "norms": norms, "rows": rows, "val": val, "stats": stats,
            "params": {k: np_(p) for k, p in trainer.model.named_parameters()}}


def shard_round_trip(mesh):
    """shard_params then gather_params gives back every tensor exactly; a
    block whose geometry does not split keeps whole weights."""
    model = TANTE(dset_metadata=tante_metadata(), tp_mesh=mesh, device="cpu", **TP_TANTE)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    shard_params(model, mesh)
    after = gather_params(model, mesh)

    odd = FusedTransformerBlock(24, 3, 2.0, 0.0, tp_mesh=mesh)
    shard_params(odd, mesh)
    try:  # a mesh larger than the world is refused, as JAX's make_mesh refuses one
        make_mesh(mesh.size("tp") + 1, ("dp", "tp"), (1, mesh.size("tp") + 1), device="cpu")
        refused = False
    except ValueError:
        refused = True
    world = mesh.size(*mesh.axis_names)
    items = np.arange(2 * world)
    return {"equal": all(torch.equal(before[k], after[k]) for k in before),
            "keys": sorted(before) == sorted(after), "wrong_size_refused": refused,
            "dp_tp_mesh": [dp_tp_mesh(world, device="cpu").shape,
                           dp_tp_mesh(world, tp=1, device="cpu").shape],
            "replicated": replicated(mesh)(items).tolist(),
            "odd_split": [k for k, p in odd.named_parameters() if hasattr(p, "tp_dim")]}


CASES = {
    "block_tp": block_tp,
    "tp_model_forward": tp_model_forward,
    "tp_dropout_forward": tp_dropout_forward,
    "spectral_sp": spectral_sp,
    "fno_sp_forward": fno_sp_forward,
    "train_run": train_run,
    "r_train_run": r_train_run,
    "r_train_steps": r_train_steps,
    "vf_slot_decision": vf_slot_decision,
    "shard_round_trip": shard_round_trip,
    "halo_case": halo_case,
    "sharded_ops": sharded_ops,
    "unet_sp_forward": unet_sp_forward,
    "unet_train_run": unet_train_run,
}


def run(rank: int, world: int, tmpdir: str, jobs: list) -> dict:
    """``jobs``: (name, mesh axes, mesh shape, case, kwargs) tuples, run in
    order on one process group; -> {name: result or {"error": traceback}}."""
    out = {}
    for name, axes, shape, case, kw in jobs:
        try:
            mesh = make_mesh(world, axes, shape, device="cpu") if axes else None
            if "workdir" in kw:
                kw = dict(kw, workdir=Path(tmpdir) / kw["workdir"] / f"rank{rank}"
                          if mesh is None else Path(tmpdir) / kw["workdir"])
            out[name] = CASES[case](mesh, **kw)
            if mesh is not None:
                out[name]["coords"] = mesh.coords
        except Exception:  # reported to the test that owns the case
            out[name] = {"error": traceback.format_exc()}
    return out


def main(rank: int, world: int, tmpdir: str, jobs: list, queue) -> None:
    """Spawned process body: join the gloo group through a ``file://``
    rendezvous, run ``jobs``, hand the results to the parent."""
    import datetime

    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmpdir}/rendezvous", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=60))
        try:
            out = run(rank, world, tmpdir, jobs)
        finally:
            dist.destroy_process_group()
    except Exception:
        out = {"error": traceback.format_exc()}
    queue.put((rank, out))
