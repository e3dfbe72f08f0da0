"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
one JAX ``init`` flattened to numpy and loaded into the port through
``tante_tpu_torch.convert``, at the small TANTE geometry the tests share;
seeded block weights for both packages; and a CPU walk of the chain
kernel's addressing plan."""

import functools
import multiprocessing
import queue
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
from flax import traverse_util

import torch

from tante_tpu.data.dataset import TanteMetadata as JaxMetadata
from tante_tpu.models.tante import TANTE as JaxTANTE
from tante_tpu.ops import pallas_block as jblock
from tante_tpu_torch.convert import load_jax_params, seeded_jax_params
from tante_tpu_torch.data.metadata import TanteMetadata
from tante_tpu_torch.models.tante import TANTE
from tante_tpu_torch.ops import fused_block as tblock

# The suite runs in several worker processes; PyTorch's default of one
# intra-op thread per core in each of them oversubscribes the host (a 2 s
# training test took 70 s under six workers).
torch.set_num_threads(2)

B, T, H, W, F = 2, 4, 32, 64, 4
KW = dict(in_T=T, taylor_order=1, attn_axes="THWTHW", embed_dim=128, patch_scale=8,
          n_head=4, mlp_ratio=1.0, output_length=1)
PS = (2, 2, 2)


def metadata(cls, res=(H, W)):
    return cls(dataset_name="t", n_spatial_dims=2, spatial_resolution=tuple(res),
               field_names={0: ["f"] * F, 1: [], 2: []}, boundary_condition_types=["PERIODIC"],
               n_files=1, n_trajectories_per_file=[1], n_steps_per_trajectory=[32],
               n_fields=F)


def flatten(params):
    return {k: np.array(v) for k, v in
            traverse_util.flatten_dict(params["params"], sep="/").items()}


@functools.lru_cache(maxsize=None)
def models(deg: bool, rt_bias: float | None = None):
    """(jax model, jax params, port model) sharing one init.  ``rt_bias``
    zeroes the interprator's last layer and sets its bias, so every call
    reports r_t = clip(rt_bias, 0, out_T - 1) + 1.001."""
    jm = JaxTANTE(dset_metadata=metadata(JaxMetadata), deg=deg, **KW)
    x = jnp.zeros((1, T, H, W, F), jnp.float32)
    params = jm.init(jax.random.PRNGKey(3), x, *(() if deg else (2.5,)))
    if rt_bias is not None:
        head = params["params"]["interprators_0"]["TorchDense_2"]["Dense_0"]
        head["kernel"] = jnp.zeros_like(head["kernel"])
        head["bias"] = jnp.full_like(head["bias"], rt_bias)
    tm = TANTE(dset_metadata=metadata(TanteMetadata), deg=deg, device="cpu", **KW)
    load_jax_params(tm, flatten(params))
    return jm, params, tm.eval()


def transplant(jmodel, tmodel, *inputs, seed=0):
    """Seeded weights for the port's model (``convert.seeded_jax_params``),
    loaded into it and handed to the JAX model as its param tree, checked
    against the tree ``jmodel.init(key, *inputs)`` gives (numpy inputs go in
    as arrays, anything else, such as a length, as it is)."""
    flat = seeded_jax_params(tmodel, seed)
    inputs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in inputs]
    init = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *inputs))
    shapes = {"/".join(p.key for p in path): leaf.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(init["params"])[0]}
    assert {k: v.shape for k, v in flat.items()} == shapes
    load_jax_params(tmodel, flat)
    return {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}, tmodel.eval()


def frames(seed, n=T):
    return np.random.default_rng(seed).normal(size=(B, n, H, W, F)).astype(np.float32)


def block_params(c, hidden, seed):
    """Seeded numpy weights for one block (non-trivial LN and biases)."""
    rng = np.random.default_rng(seed)

    def u(*shape, fan_in=None):
        bound = 1.0 / np.sqrt(fan_in or shape[0])
        return rng.uniform(-bound, bound, size=shape).astype(np.float32)

    return jblock.BlockParams(
        ln1_scale=1.0 + 0.1 * u(c), ln1_bias=0.1 * u(c),
        wq=u(c, c), bq=u(c), wk=u(c, c), bk=u(c), wv=u(c, c), bv=u(c),
        wo=u(c, c), bo=u(c),
        ln2_scale=1.0 + 0.1 * u(c), ln2_bias=0.1 * u(c),
        w1=u(c, hidden), b1=u(hidden, fan_in=c), w2=u(hidden, c), b2=u(c, fan_in=hidden),
    )


def to_jax(p):
    return jblock.BlockParams(*(jnp.asarray(a) for a in p))


def to_torch(p, requires_grad=False):
    return tblock.BlockParams(
        *(torch.from_numpy(np.array(a)).requires_grad_(requires_grad) for a in p))


def unarrange_weight(flat: torch.Tensor, k: int, n: int, np_: int) -> torch.Tensor:
    """The inverse of ``tblock.arrange_weight``: the (K, N) weight the
    kernel reads from ``flat``'s slabs (passes of ``np_`` columns)."""
    t = flat.reshape(n // np_, k // 32, np_ // 8, 4, 8, 8)
    return t.permute(1, 3, 5, 0, 2, 4).reshape(k, n)


def walk_chain_plan(x2, params_seq, plan, heads):
    """What the chain kernel does with ``chain_plan``'s ints, on the CPU:
    per block, gather each sequence's rows from the current buffer through
    the read map, run ``block_ref``, scatter through the write map into a
    fresh buffer.  x2: (B*T*H*W, C) rows in the first block's read order."""
    cur = x2
    for row, p in zip(plan, params_seq):
        l, causal, n_seqs = row[:3]

        def rows(m):
            per, n2, sb, s1, s2, sa = m
            seq = torch.arange(n_seqs)
            b, r = seq // per, seq % per
            return (b * sb + (r // n2) * s1 + (r % n2) * s2)[:, None] + torch.arange(l) * sa

        y = tblock.block_ref(cur[rows(row[3:9])], p, l, heads, bool(causal))
        nxt = torch.full_like(cur, float("nan"))
        nxt[rows(row[9:15]).reshape(-1)] = y.reshape(-1, y.shape[-1])
        cur = nxt
    return cur


def spawn_ranks(world: int, tmp_path, jobs: list, timeout: float = 60.0) -> list:
    """Run ``jobs`` (see ``_torch_ranks.run``) on ``world`` spawned CPU
    processes joined in one gloo group; -> each rank's results, in rank
    order.  The join is bounded: a rank stuck in a collective fails the
    test instead of holding the suite."""
    import _torch_ranks

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    rdv = tempfile.mkdtemp(dir=tmp_path)
    procs = [ctx.Process(target=_torch_ranks.main, args=(r, world, rdv, jobs, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            rank, out = results.get(timeout=max(1.0, deadline - time.monotonic()))
            got[rank] = out
    except queue.Empty:
        raise AssertionError(f"ranks {sorted(set(range(world)) - set(got))} did not finish "
                             f"within {timeout} s") from None
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    for rank, out in got.items():
        assert "error" not in out, f"rank {rank}:\n{out['error']}"
    return [got[r] for r in range(world)]
