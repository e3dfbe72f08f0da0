"""The adaptive training path under tensor parallelism, on the CPU.

``R_Trainer`` at (dp 1, tp 2) runs on two spawned ranks of one gloo group
(``_torch_parity.spawn_ranks``; the rank bodies are ``_torch_ranks.py``'s)
against the same port on one device, for both rollout engines and, for the
variable-frame engine, with remat on and off: every step's loss, r_t mean and
spread, calls and gradient norm, the rollout's cums, and the validation step.
The single-device port is held to JAX by ``test_torch_adaptive_train.py``.  On
the CPU each block's two halves run their plain versions with an all-reduce
after each, as the kernels do on the card.

Then the variable-frame engine's slot decision: two ranks whose samples finish
at different slots, with a stand-in model that all-reduces in every call,
decide each slot together and compute what JAX's engine computes on the whole
batch; and a checkpoint saved at tp 2 that resumes on one device."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as R
import test_torch_adaptive_train as AT
from _torch_parity import flatten, spawn_ranks
from tante_tpu.train import rollout as jroll

CASES = {
    "one_frame": {},
    "vf_remat": dict(AT.RKW["vf_growth"]),
    "vf_no_remat": dict(AT.RKW["vf_growth"], gradient_checkpointing=False),
}
# f32 over two tp shards, the partials summed by an all-reduce: every step's
# numbers within 1e-4 of one device, their order of sums the only difference.
RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def inputs(case):
    """The small adaptive TANTE of the JAX-parity tests with the r_t head
    set so that the two samples' r_t differ (and, in the variable-frame
    engine, their frame counts), one batch of two samples."""
    rkw = CASES[case]
    _, params = AT.jax_model_and_params()
    x, y = AT.step_batch(0)
    flat = flatten(AT.rt_head(params, x, rkw.get("train_out_T", 1.5)))
    return dict(flat=flat, x=x, y=y, model_kw=AT.KW, rkw=rkw)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    jobs = [(f"tp_{case}", ("dp", "tp"), (1, 2), "r_train_steps",
             dict(workdir=f"r_{case}", save=case == "vf_remat", **inputs(case)))
            for case in CASES]
    x, wm, v, g, h = AT.engine_inputs(2)
    for remat in (False, True):
        jobs.append((f"slot_remat{remat}", ("tp",), (2,), "vf_slot_decision",
                     dict(x=x, wm=wm, v=v, g=g, h=h, centres=AT.RT_CENTRES, k=AT.E_K,
                          n_steps=AT.E_STEPS, remat=remat)))
    return spawn_ranks(2, tmp_path_factory.mktemp("tp_adaptive"), jobs, timeout=240)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    root = tmp_path_factory.mktemp("single")
    return {case: R.r_train_steps(None, root / case, **inputs(case)) for case in CASES}


def assert_steps_close(got, want):
    assert len(got) == len(want)
    for n, (a, b) in enumerate(zip(got, want)):
        # loss, rt_avg, rt_var, calls
        np.testing.assert_allclose(a["stats"], b["stats"], rtol=RTOL, atol=1e-7, err_msg=n)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=RTOL, err_msg=n)
        np.testing.assert_allclose(a["rts"], b["rts"], rtol=RTOL, atol=1e-7, err_msg=n)
        if b["cums"] is None:
            assert a["cums"] is None
        else:
            np.testing.assert_array_equal(a["cums"], b["cums"], err_msg=n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_r_trainer_at_tp2_matches_one_device(world2, single, case):
    want = single[case]
    if case != "one_frame":  # the samples consume different counts: slots are skipped
        cums = want["steps"][0]["cums"]
        assert cums[:, 0].tolist() != cums[:, 1].tolist()
        assert want["steps"][0]["stats"][3] < AT.step_batch(0)[1].shape[1]
    for rank in world2:
        got = rank[f"tp_{case}"]
        assert got["split"] == 3 * 10  # the three blocks ran split over tp
        assert_steps_close(got["steps"], want["steps"])
        assert got["val"]["n_calls"] == want["val"]["n_calls"]
        np.testing.assert_allclose(got["val"]["rt_log"], want["val"]["rt_log"], rtol=RTOL,
                                   atol=1e-7)
        np.testing.assert_allclose(got["val"]["loss"], want["val"]["loss"], rtol=RTOL)
    a, b = (rank[f"tp_{case}"] for rank in world2)
    assert [s["stats"] for s in a["steps"]] == [s["stats"] for s in b["steps"]]
    for k in a["params"]:  # the gathered parameters agree on both ranks
        np.testing.assert_array_equal(a["params"][k], b["params"][k], err_msg=k)


@pytest.mark.parametrize("remat", [False, True])
def test_vf_slot_decision_is_shared_over_the_group(world2, remat):
    """Rank 0's sample consumes in slots 0-2, rank 1's two samples only in
    0-1: rank 1 calls the model in slot 2 too (its all-reduce would
    otherwise leave rank 0 waiting) and logs what JAX's engine logs there on
    the whole batch (one ``lax.cond`` over all three samples): the rollout,
    r_t, active flags and cums of its own samples, and the gradients, summed
    over the ranks, of the whole batch's loss."""
    x, wm, v, g, h = AT.engine_inputs(2)

    def jloss(wm_, v_):
        y, rts, act, cums = jroll.rollout_adaptive_train_vf(
            AT.jax_model(wm_, v_, AT.E_K), jnp.asarray(x), AT.E_STEPS, AT.E_K, remat=remat)
        return jnp.sum(y * g) + jnp.sum(rts * act * h), (y, rts, act, cums)

    import jax

    (_, (jy, jrts, jact, jcums)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(wm), jnp.asarray(v))
    got = [rank[f"slot_remat{remat}"] for rank in world2]
    for rank, idx in zip(got, R.SLOT_SAMPLES):
        np.testing.assert_array_equal(rank["act"], np.asarray(jact)[:, idx])
        np.testing.assert_array_equal(rank["cums"], np.asarray(jcums)[:, idx])
        np.testing.assert_allclose(rank["y"], np.asarray(jy)[idx], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(rank["rts"], np.asarray(jrts)[:, idx], rtol=1e-6, atol=1e-6)
        # three slots with a consuming sample somewhere: three calls on each
        # rank (and their recompute under remat)
        assert rank["calls"] == 3 * (2 if remat else 1)
    assert not got[1]["act"][2].any() and got[0]["act"][2].all()  # the flags differ in slot 2
    assert np.all(got[1]["rts"][2] != 0)  # a called slot: the model's r_t, as JAX logs it
    for name, want in zip(("gwm", "gv"), jg):
        np.testing.assert_allclose(got[0][name] + got[1][name], np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_tp2_checkpoint_resumes_on_one_device(world2, tmp_path):
    """Rank 0 saved the gathered parameters and optimizer moments after two
    steps at tp 2; one device resumes from them with the same parameters and
    takes the next step as the tp ranks took it."""
    tp = world2[0]["tp_vf_remat"]
    resumed = R.r_train_steps(None, tmp_path / "resumed", steps=1, resume=tp["ckpt"],
                              **inputs("vf_remat"))
    assert resumed["start"].keys() == tp["params"].keys()
    for k, v in tp["params"].items():
        np.testing.assert_array_equal(resumed["start"][k], v, err_msg=k)
    assert_steps_close(resumed["steps"], [tp["next_step"]])
