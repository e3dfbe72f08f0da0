"""The readings that a cell's limits are set from, on the card, in one
process (the kernels build once):

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 [--seconds 2]
        [--control tf32] [--calls 512]

For each seed: the cell's set-up and a short window, then the numbers its
check compares for the program's answers and, with ``--control``, for the
reference's own answers in that precision put in the program's place.  One
JSON line per seed.  ``--calls N`` (adaptive cells) reads, once, how many
model calls a rollout takes over the traffic of N seeds from the first one
(``batches`` rollouts a seed).
"""

import time

T0 = time.perf_counter()  # noqa: E402

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def calls_survey(config: dict, traffic: dict, n: int, seed: int, dev: str = "cuda:0") -> dict:
    """Calls per rollout (a histogram) of an adaptive cell's program over
    the traffic of seeds ``seed`` .. ``seed + n - 1``."""
    from collections import Counter

    from harness import core, waves

    ad = core.adapter_of(config)
    res, _ = ad.geometry(config)
    call = ad.rollout_call(ad.predictor(config, ad.weights(config, seed, dev), dev), traffic)
    counts = Counter()
    for s in range(seed, seed + n):
        for h in waves.trajectories(traffic, s, res, traffic["history"], dev):
            counts[int(call(h)[2])] += 1
    return {"seeds": n, "rollouts": sum(counts.values()),
            "calls_per_rollout": {str(c): counts[c] for c in sorted(counts)}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", default=None, help="a precision of the reference: tf32")
    p.add_argument("--calls", type=int, default=0, help="seeds of traffic for the survey")
    args = p.parse_args(argv)
    import torch

    from harness import core

    if not torch.cuda.is_available():
        print("calibrate.py reads the card: no CUDA device", file=sys.stderr)
        return 2
    spec = core.load_spec()
    cell = core.find_cell(spec, args.workload)
    config, traffic = core.config_of(cell), core.traffic_of(cell)
    kind = torch.cuda.get_device_name(0)
    if args.calls:
        seed = int(args.seeds.split(",")[0])
        print(json.dumps(calls_survey(config, traffic, args.calls, seed)), flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = SimpleNamespace(config=config, traffic=traffic, adapter=core.adapter_of(config),
                              seed=seed, seconds=args.seconds, trace=False, device="cuda:0",
                              t0=t0, peaks=core.peaks_for(kind), log=sys.stderr)
        rec, check = core.runner_of(traffic).run(ctx)
        gc.collect()
        torch.cuda.empty_cache()
        line = {"workload": args.workload, "seed": seed, "units": rec.units, "program": check()}
        if args.control:
            line["control"] = check(args.control)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del rec, check
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
