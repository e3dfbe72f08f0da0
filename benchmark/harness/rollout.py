"""Closed-loop rollouts: one client that sends the next rollout when the
last one has come back.

Set-up draws the weights and ``batches`` batches of histories on the device,
builds the program, and warms it up on the first ``warmup`` batches.  The
window then cycles over the batches, one rollout at a time, each ended by a
synchronise, until ``--seconds`` have passed; every rollout is timed from
its call to the end of its synchronise, and its return marks the host's
enqueue.  The last answer of every batch is kept for the check.

Traced runs (``--trace 1``) wrap the model's ``encode`` and ``head`` (host
spans, head calls and their r_t), and after the window profile
``trace_units`` more rollouts.
"""

from __future__ import annotations

import contextlib
import time

import torch

from harness import core, trace, waves


def run(ctx):
    """-> (the run's record, check): ``check(precision=None)`` compares a
    sample, drawn from the seed, of the batches' last answers (a batch's
    answer is missing where its last rollout failed) with the reference's
    (or, with ``precision``, the reference's own answers in that precision
    in the program's place) and returns the numbers compared."""
    cfg, tf, ad, dev = ctx.config, ctx.traffic, ctx.adapter, ctx.device
    res, _ = ad.geometry(cfg)
    w = ad.weights(cfg, ctx.seed, dev)
    program = ad.predictor(cfg, w, dev)
    hist = waves.trajectories(tf, ctx.seed, res, tf["history"], dev)
    n = len(hist)
    call = ad.rollout_call(program, tf)
    kept = [None] * n
    ran = [False] * n  # batches whose answer is due: warmed up or rolled out in the window
    for i in range(tf["warmup"]):
        ran[i % n] = True
        kept[i % n] = call(hist[i % n])
        core.synchronize(dev)
    rec = core.Run(kind="rollout", config=cfg, traffic=tf, adapter=ad, peaks=ctx.peaks,
                   frames_per_unit=tf["batch"] * tf["n_steps"])
    rec.setup_s = time.perf_counter() - ctx.t0

    spans = trace.Spans(program.model) if ctx.trace else None

    def span(name):
        return spans.span(name) if spans else contextlib.nullcontext()

    start = time.perf_counter()
    i = 0
    while True:
        b = i % n
        ran[b] = True
        t0 = time.perf_counter()
        try:
            with span("rollout"):
                out = call(hist[b])
            t1 = time.perf_counter()
            with span("sync"):
                core.synchronize(dev)
            kept[b] = out
        except RuntimeError as e:  # a failed rollout counts against the attempts
            print(f"rollout {i} failed: {e}", file=ctx.log, flush=True)
            rec.failed += 1
            kept[b] = None
            t1 = time.perf_counter()
        t2 = time.perf_counter()
        rec.attempted += 1
        rec.latencies_s.append(t2 - t0)
        rec.enqueue_s.append(t1 - t0)
        if spans:
            emits = ad.emits_of(spans.take(), tf)
            rec.calls.append(len(emits))
            rec.ops.append(ad.rollout_ops(cfg, tf, emits))
        i += 1
        if t2 - start >= ctx.seconds:
            break
    rec.window_s = t2 - start

    if spans:
        heads = []

        def unit(j):
            with span("rollout"):
                call(hist[j % n])
            with span("sync"):
                core.synchronize(dev)
            heads.append(spans.take())

        spans.take()
        m = tf["trace_units"]
        rec.trace = trace.profile_units(unit, m, spans)
        if ctx.peaks:
            bounds = [ad.block_bound_s(cfg, tf, len(h), ctx.peaks) for h in heads[-m:]]
            rec.trace_block_bound_s = sum(t for t, _ in bounds)
            rec.roofline_bounds["block_kernels"] = bounds[0][1]
        spans.remove()
    del program, call

    def check(precision=None):
        gen = torch.Generator().manual_seed(core.derived_seed(ctx.seed, "check"))
        due = [b for b in range(n) if ran[b]]
        sample = [due[j] for j in torch.randperm(len(due), generator=gen)[:tf["check_batches"]]]
        worst = {"answers_missing": float(sum(kept[b] is None for b in sample))}
        for b in sample:
            if kept[b] is None:
                continue
            want = ad.reference_rollout(cfg, w, hist[b], tf)
            got = (kept[b] if precision is None
                   else ad.reference_rollout(cfg, w, hist[b], tf, precision))
            for k, v in ad.compare_rollout(got, want).items():
                worst[k] = core.worst(worst.get(k, 0.0), v)
        return worst

    return rec, check
