"""The ``fused_blocks`` switch (``TANTE(fused_blocks=...)`` ->
``AttnBackbone(fused=...)`` -> ``FusedTransformerBlock(use_kernel=...)``),
as the JAX package has it: False runs the plain block math everywhere (no
block, canonical T, chain or group wrapper is called), with the same
parameters.  f32 on the CPU against the JAX model under both settings, one
JAX ``init`` loaded into the port through ``convert.py``; 1e-4 as
``tests/test_torch_models.py`` (f32 through a dozen matmul layers summed in
another order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import KW, T, flatten, frames, metadata
from tante_tpu import config as jconfig
from tante_tpu.data.dataset import TanteMetadata as JaxMetadata
from tante_tpu.models.tante import TANTE as JaxTANTE
from tante_tpu_torch.config import instantiate, load_config
from tante_tpu_torch.convert import load_jax_params
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models import attn_backbone, common
from tante_tpu_torch.models.attn_backbone import AttnBackbone
from tante_tpu_torch.models.common import FusedTransformerBlock
from tante_tpu_torch.models.tante import TANTE

ATOL = RTOL = 1e-4
WRAPPERS = {attn_backbone: ("fused_block_canon_t", "fused_chain_apply", "fused_group_apply"),
            common: ("fused_block_apply", "fused_block_apply_tp")}


@functools.lru_cache(maxsize=None)
def jax_params():
    jm = JaxTANTE(dset_metadata=metadata(JaxMetadata), deg=True, **KW)
    return jm.init(jax.random.PRNGKey(5), jnp.zeros((1, T, 32, 64, 4), jnp.float32))


def port(fused: bool, **kw) -> TANTE:
    tm = TANTE(dset_metadata=metadata(TanteMetadata), deg=True, fused_blocks=fused,
               device="cpu", **KW, **kw)
    load_jax_params(tm, flatten(jax_params()))
    return tm.eval()


@pytest.mark.parametrize("jax_fused", [True, False])
@pytest.mark.parametrize("fused", [True, False])
def test_tante_matches_jax_under_both_settings(fused, jax_fused):
    jm = JaxTANTE(dset_metadata=metadata(JaxMetadata), deg=True, fused_blocks=jax_fused, **KW)
    x = frames(11, T + 1)
    want = jm.apply(jax_params(), jnp.asarray(x))
    with torch.no_grad():
        got = port(fused)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_both_settings_have_the_same_parameters():
    on, off = port(True), port(False)
    assert list(on.state_dict()) == list(off.state_dict())
    off.load_state_dict(on.state_dict(), strict=True)
    assert all(not b.fused for b in off.modules() if isinstance(b, AttnBackbone))
    assert all(not b.use_kernel for b in off.modules() if isinstance(b, FusedTransformerBlock))
    assert all(b.use_kernel for b in on.modules() if isinstance(b, FusedTransformerBlock))


@pytest.mark.parametrize("chain,group", [(0, False), (3, False), (0, True)])
def test_unfused_model_calls_no_kernel_wrapper(monkeypatch, chain, group):
    """fused=False: no wrapper runs, whatever the opt-in fusions say; the
    same model with fused=True reaches them (and agrees)."""
    calls = []
    for module, names in WRAPPERS.items():
        for name in names:
            real = getattr(module, name)

            def counted(*a, _real=real, _name=name, **k):
                calls.append(_name)
                return _real(*a, **k)

            monkeypatch.setattr(module, name, counted)
    x = torch.from_numpy(frames(12, T + 1))
    outs = {}
    for fused in (False, True):
        tm = port(fused, fused_chain=chain)
        for b in tm.modules():
            if isinstance(b, AttnBackbone):
                b.fused_group = group
        calls.clear()
        with torch.no_grad():
            outs[fused] = tm(x)
        if fused:
            assert calls, "the fused model reached no wrapper"
        else:
            assert calls == []
    np.testing.assert_allclose(outs[False].numpy(), outs[True].numpy(), atol=ATOL, rtol=RTOL)


def test_a_config_sets_fused_blocks_in_both_packages():
    ov = ["model.fused_blocks=false", "model.embed_dim=32", "model.n_head=4",
          "model.attn_axes=TH"]
    cfg = load_config("tante", overrides=ov)
    model = instantiate(cfg.model, dset_metadata=metadata(TanteMetadata), device="cpu")
    assert all(not b.fused for b in model.modules() if isinstance(b, AttnBackbone))
    jm = jconfig.instantiate(jconfig.load_config("tante", overrides=ov).model,
                             dset_metadata=metadata(JaxMetadata))
    assert jm.fused_blocks is False
    shipped = instantiate(load_config("tante", overrides=ov[1:]).model,
                          dset_metadata=metadata(TanteMetadata), device="cpu")
    assert all(b.fused for b in shipped.modules() if isinstance(b, AttnBackbone))


def test_plain_block_draws_no_mask_unless_dropout_is_active():
    """use_kernel=False at deterministic=True runs the plain math without
    touching the generator; with dropout active it draws as before."""
    gen = torch.Generator().manual_seed(0)
    blk = FusedTransformerBlock(32, 4, mlp_ratio=1.0, dropout=0.1, gen=gen, use_kernel=False)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 8, 32)).astype(np.float32))
    g = torch.Generator().manual_seed(7)
    state = g.get_state()
    with torch.no_grad():
        plain = blk(x, deterministic=True, generator=g)
        assert torch.equal(g.get_state(), state)
        blk.use_kernel = True
        kernel_path = blk(x, deterministic=True)
        blk.use_kernel = False
        a = blk(x, deterministic=False, generator=torch.Generator().manual_seed(3))
        blk.use_kernel = True
        b = blk(x, deterministic=False, generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(plain.numpy(), kernel_path.numpy(), atol=1e-5, rtol=1e-5)
    assert torch.equal(a, b) and not torch.equal(a, plain)
