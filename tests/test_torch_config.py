"""Port parity: the config layer and the registry (``tante_tpu_torch/config.py``,
``registry.py``) against the JAX package's (the counterpart of
``tests/test_config.py`` and ``tests/test_configs_instantiate.py``), on the
CPU: every shipped config loads to the same dict; ``instantiate``,
``set_ckpt`` and the reference names behave as in JAX but resolve to the
port's classes; each shipped config whose model the port has gives one
forward equal to JAX's on the same weights (carried across with
``convert.py``) at the model tests' 1e-4."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import transplant

from tante_tpu import config as jconfig
from tante_tpu.data.dataset import TanteMetadata as JaxMetadata
from tante_tpu.train.metrics import VRMSE as JaxVRMSE
from tante_tpu_torch import config, registry
from tante_tpu_torch.data.datamodule import TanteDataModule
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models import (
    AFNO, DPOT, FNO, TANTE, TFNO, UNO, AttentionUNet, AViT, CViT, UNetConvNext,
)
from tante_tpu_torch.train import (
    L2RE, MSE, NMSE, NNMSE, NRMSE, RMSE, VMSE, VRMSE, AdamW, Evaler, LinearWarmupCosineAnnealingLR,
    R_Evaler, R_Trainer, Trainer,
)

CONFIGS = sorted(os.path.splitext(os.path.basename(p))[0]
                 for p in glob.glob(os.path.join(config.CONFIG_DIR, "*.yaml")))
PORTED = ("tante", "tante_adaptive", "fno", "fno3d", "tfno", "uno", "avit", "cvit", "afno",
          "dpot", "unet_convnext", "unet_att")

# tests/test_configs_instantiate.py's SHRINK: tiny widths for CPU forwards.
SHRINK = {
    "tante": ["model.embed_dim=32", "model.n_head=4", "model.attn_axes=TH"],
    "tante_adaptive": ["model.embed_dim=32", "model.n_head=4", "model.attn_axes=TH"],
    "fno": ["model.hidden_channels=8", "model.modes1=4", "model.modes2=4"],
    "fno3d": ["model.hidden_channels=8", "model.modes1=4", "model.modes2=4", "model.modes3=4"],
    "tfno": ["model.hidden_channels=8", "model.modes1=4", "model.modes2=4"],
    "uno": ["model.width=8"],
    "avit": ["model.embed_dim=32", "model.num_heads=4", "model.processor_blocks=1"],
    "cvit": ["model.emb_dim=32", "model.dec_emb_dim=32", "model.depth=1",
             "model.grid_size=[8, 8]", "model.latent_dim=16", "model.patch_size=[1, 16, 16]"],
    "afno": ["model.hidden_dim=32", "model.n_blocks=2"],
    "dpot": ["model.embed_dim=32", "model.depth=1", "model.patch_size=8", "model.modes=2"],
    "unet_convnext": ["model.init_features=4", "model.blocks_per_stage=2", "model.stages=2"],
    "unet_att": ["model.depth=2"],
}


def md(cls):
    return cls(dataset_name="synthetic", n_spatial_dims=2, spatial_resolution=(32, 64),
               field_names={0: ["a"], 1: ["v_x", "v_y"], 2: []},
               boundary_condition_types=["PERIODIC"], n_files=1, n_trajectories_per_file=[2],
               n_steps_per_trajectory=[24], n_fields=3)


def test_config_dir_is_the_repositorys():
    assert os.path.samefile(config.CONFIG_DIR, jconfig.CONFIG_DIR)
    assert len(CONFIGS) == 12


@pytest.mark.parametrize("name", CONFIGS)
def test_every_config_loads_to_jaxs_dict(name):
    overrides = ["data.batch_size=16", "seed=7", "trainer.max_epoch=3", "model.new.key=[1, 2]",
                 "optimizer.lr=1.0e-4", "data.use_wellpack=true", "experiment=E", "data.x=none"]
    got = config.load_config(name, overrides=overrides)
    want = jconfig.load_config(name, overrides=overrides)
    assert isinstance(got, config.Config) and got.to_dict() == want.to_dict()
    assert got.to_yaml() == want.to_yaml()
    assert got.seed == 7 and got.data.batch_size == 16 and got.model.new.key == [1, 2]
    assert got.data.use_wellpack is True and got.optimizer.lr == 1e-4
    by_path = config.load_config(os.path.join(config.CONFIG_DIR, name + ".yaml"))
    assert by_path.to_dict() == jconfig.load_config(name).to_dict()
    assert "_target_" in got.model and "_target_" in got.data


def test_config_access_and_copy():
    cfg = config.load_config("fno")
    assert cfg.select("model.modes1") == 20 and cfg.select("model.nothing", 5) == 5
    copy = cfg.copy()
    copy.model.modes1 = 3
    assert cfg.model.modes1 == 20 and copy.model.modes1 == 3
    with pytest.raises(AttributeError):
        cfg.nothing
    with pytest.raises(ValueError):
        config.load_config("fno", overrides=["no_equals_sign"])


def test_instantiate_recursive_and_extra_kwargs():
    node = {"a": [{"_target_": "trainer.VRMSE"}, 3],
            "opt": {"_target_": "torch.optim.AdamW", "lr": 1e-4, "weight_decay": 1e-5},
            "sched": {"_target_": "optim.schedulers.LinearWarmupCosineAnnealingLR",
                      "warmup_epochs": 2, "max_epochs": 9}}
    got = config.instantiate(node)
    assert isinstance(got["a"][0], VRMSE) and got["a"][1] == 3
    assert isinstance(got["opt"], AdamW) and got["opt"].lr == 1e-4
    sched = config.instantiate(node["sched"], max_epochs=34, lr=5e-5, warmup_start_lr=5e-6,
                               eta_min=5e-6)  # extra kwargs override the node's
    assert isinstance(sched, LinearWarmupCosineAnnealingLR) and sched.max_epochs == 34
    want = jconfig.instantiate(node["sched"], max_epochs=34, lr=5e-5, warmup_start_lr=5e-6,
                               eta_min=5e-6)
    assert [sched(e) for e in range(34)] == pytest.approx(
        [float(want(e)) for e in range(34)], rel=1e-6)  # JAX's schedule is f32
    x, y = (np.random.default_rng(0).normal(size=(2, 3, 4, 5, 2)).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(
        got["a"][0](torch.from_numpy(x), torch.from_numpy(y), None).numpy(),
        np.asarray(jconfig.instantiate({"_target_": "trainer.VRMSE"})(
            jnp.asarray(x), jnp.asarray(y), None)), rtol=1e-6)
    assert isinstance(jconfig.instantiate({"_target_": "trainer.VRMSE"}), JaxVRMSE)
    dm = config.instantiate({"_target_": "tante_tpu_torch.data.WaveDataModule", "batch_size": 2,
                             "waves": {"resolution": [8, 8], "n_steps": 8}}, device="cpu")
    assert type(dm).__name__ == "WaveDataModule" and dm.device.type == "cpu"


@pytest.mark.parametrize("choose", ["recent", "best"])
def test_set_ckpt_gives_jaxs_paths(tmp_path, choose):
    """A fresh experiment folder, then one holding the other checkpoint, then
    one holding the chosen one: the same paths as JAX's under each root."""
    def cfg(root):
        return config.Config({"root_path": str(root), "experiment": "exp1",
                              "trainer": config.Config({"checkpoint_path": None}),
                              "evaler": config.Config({"checkpoint_path": None})})

    other = "best" if choose == "recent" else "recent"
    for made in ((), (other,), (other, choose)):
        for root in ("t", "j"):
            for name in made:
                os.makedirs(tmp_path / root / "experiments" / "exp1" / name, exist_ok=True)
        got, folder = config.set_ckpt(cfg(tmp_path / "t"), choose=choose)
        want, jfolder = jconfig.set_ckpt(jconfig._wrap(cfg(tmp_path / "j")), choose=choose)
        assert folder == str(tmp_path / "t" / "experiments" / "exp1") and os.path.isdir(folder)
        assert os.path.relpath(folder, tmp_path / "t") == os.path.relpath(jfolder, tmp_path / "j")
        for node in ("trainer", "evaler"):
            g, w = got[node]["checkpoint_path"], want[node]["checkpoint_path"]
            assert (g and os.path.relpath(g, tmp_path / "t")) == (
                w and os.path.relpath(w, tmp_path / "j"))
            assert g == (os.path.join(folder, choose) if choose in made else "")


NAMES = {
    "data.TanteDataModule": TanteDataModule,
    **{f"models.{m.__name__}": m for m in (TANTE, FNO, TFNO, UNO, AViT, CViT)},
    **{f"trainer.{m.__name__}": m for m in (MSE, NMSE, L2RE, NNMSE, RMSE, NRMSE, VMSE, VRMSE,
                                           Trainer, R_Trainer, Evaler, R_Evaler)},
    "torch.optim.AdamW": AdamW,
    "optim.schedulers.LinearWarmupCosineAnnealingLR": LinearWarmupCosineAnnealingLR,
}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_reference_names_resolve_to_the_port(name):
    got = registry.resolve(name)
    assert got is NAMES[name]
    assert got.__module__.startswith("tante_tpu_torch.")


def test_adamw_is_the_ports_spec_not_torchs():
    opt = config.instantiate({"_target_": "torch.optim.AdamW", "lr": 1e-4, "weight_decay": 1e-5})
    assert type(opt) is AdamW and not isinstance(opt, torch.optim.Optimizer)
    assert opt.lr == 1e-4 and opt.weight_decay == 1e-5
    torch_opt, clip = opt.make([torch.nn.Parameter(torch.zeros(2))])
    assert isinstance(torch_opt, torch.optim.AdamW) and callable(clip)


ZOO = {"AFNO": ("afno", AFNO), "DPOT": ("dpot", DPOT),
       "UNetConvNext": ("unet_convnext", UNetConvNext),
       "AttentionUNet": ("unet_att", AttentionUNet)}


@pytest.mark.parametrize("name", ["AFNO", "DPOT", "UNetConvNext", "AttentionUNet"])
def test_unported_zoo_models_raise_keyerror(name):
    """The four zoo models the port took last (they raised KeyError before):
    each name resolves to the port's class, which builds from its shipped
    config's model node."""
    config_name, cls = ZOO[name]
    assert jconfig.resolve(f"models.{name}") is not None  # JAX has it
    assert registry.resolve(f"models.{name}") is cls
    assert cls.__module__.startswith("tante_tpu_torch.models.")
    cfg = config.load_config(config_name)
    assert cfg.model["_target_"] == f"models.{name}"
    with torch.device("meta"):
        model = config.instantiate(cfg.model, dset_metadata=md(TanteMetadata), device="meta")
    assert type(model) is cls and sum(p.numel() for p in model.parameters()) > 0


@pytest.mark.parametrize("target", ["nothing", "tante_tpu_torch.models.Nothing",
                                    "no_such_module.Thing"])
def test_unknown_targets_raise_keyerror(target):
    with pytest.raises(KeyError):
        registry.resolve(target)
    with pytest.raises(KeyError):
        jconfig.resolve(target)


@pytest.mark.parametrize("name", PORTED)
def test_shipped_config_forward_equals_jax(name):
    cfg = config.load_config(name, overrides=SHRINK[name])
    jcfg = jconfig.load_config(name, overrides=SHRINK[name])
    tm = config.instantiate(cfg.model, dset_metadata=md(TanteMetadata), device="cpu")
    jm = jconfig.instantiate(jcfg.model, dset_metadata=md(JaxMetadata))
    assert type(tm).__name__ == type(jm).__name__
    x = np.random.default_rng(1).normal(size=(1, cfg.data.n_steps_input, 32, 64, 3)).astype(
        np.float32)
    extra, adaptive = (), not getattr(tm, "deg", True)
    if cfg.trainer.get("cvit", False):
        extra = (np.random.default_rng(2).uniform(size=(8, 2)).astype(np.float32),)
    elif adaptive:
        extra = (1.5,)
    params, tm = transplant(jm, tm, x, *extra, seed=3)
    if name == "unet_att":  # BatchNorm: the init's running statistics too
        params["batch_stats"] = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["batch_stats"]
    want = jm.apply(params, jnp.asarray(x), *(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                              for a in extra))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), *(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                        for a in extra))
    if adaptive:
        (got, got_rt), (want, want_rt) = got, want
        assert got.shape == (1, 1, 32, 64, 3)
        np.testing.assert_allclose(got_rt.numpy(), np.asarray(want_rt), atol=1e-4, rtol=1e-4)
    assert got.shape == want.shape and got.shape[0] == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
