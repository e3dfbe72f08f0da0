"""Tracing and timing hooks (counterpart of ``tante_tpu/utils/profiling.py``).

- ``trace(logdir)``: a context manager around ``torch.profiler`` that
  writes a TensorBoard-loadable trace of host and device activity (CPU, and
  CUDA when a card is present) into ``logdir``;
- ``annotate(name)``: a named span in that trace (``record_function``);
- ``hard_sync(tree)``: wait until the devices of every tensor leaf of a
  nested structure have finished their queued work, for honest wall-clock
  timing (CUDA calls are asynchronous).
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof


def annotate(name: str):
    """Named span: ``with annotate("rollout"): ...``."""
    return torch.profiler.record_function(name)


def _leaves(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def hard_sync(tree: Any) -> None:
    """Synchronise every CUDA device that holds a tensor leaf of ``tree``
    (dicts, lists and tuples are walked; CPU tensors need nothing)."""
    for device in {t.device for t in _leaves(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)
