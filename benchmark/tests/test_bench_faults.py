"""A whole run of each cell (tiny, on the CPU, past the look for a card)
with the timed path broken underneath: ``correct`` comes out false for
every fault the cell can have, and true without one.  The cells run on one
card, so none has an exchange between cards to leave out."""

from __future__ import annotations

import pytest
import torch

from conftest import WORKLOADS, run_tiny


def _head_fault(monkeypatch, alter):
    from tante_tpu_torch.models.tante import TANTE

    head = TANTE.head

    def broken(self, latents, u_last, *args, **kwargs):
        out = head(self, latents, u_last, *args, **kwargs)
        frames, rest = (out[0], out[1:]) if isinstance(out, tuple) else (out, None)
        frames = alter(frames, u_last)
        return (frames, *rest) if rest is not None else frames

    monkeypatch.setattr(TANTE, "head", broken)


def _unchanged(frames, u_last):
    """The step returns its state unchanged: every frame the last one."""
    return torch.broadcast_to(u_last, frames.shape).clone()


def _half_batch(frames, u_last):
    """Half of the batch left out: its samples get the other half's frames."""
    h = frames.shape[0] // 2
    return torch.cat([frames[:h], frames[:h]] * 2)[: frames.shape[0]]


def _altered(frames, u_last):
    """One value of the answer altered where it is produced."""
    frames = frames.clone()
    frames.view(-1)[0] += 1.0
    return frames


ROLLOUT_FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered": _altered}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    line = run_tiny(workload)
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    assert all({"value", "limit"} == set(c) for c in line["checks"].values())


@pytest.mark.parametrize("fault", sorted(ROLLOUT_FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_rollout_faults_are_caught(monkeypatch, workload, fault):
    _head_fault(monkeypatch, ROLLOUT_FAULTS[fault])
    assert run_tiny(workload)["correct"] is False
