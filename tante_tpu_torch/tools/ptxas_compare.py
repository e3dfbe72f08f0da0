"""The Hopper block sources' ``-Xptxas -v`` summaries against another tree's.

    python3 -m tante_tpu_torch.tools.ptxas_compare --baseline DIR

Builds ``fused_block_sm90.cu``, ``fused_chain_sm90.cu``,
``fused_half_sm90.cu`` and ``fused_half_sm90_f32.cu`` of this tree and of
the tree at ``DIR`` where it has the source (its
``tante_tpu_torch/ops/csrc/``; e.g. the parent commit unpacked with ``git
archive HEAD~1 | tar -x -C build/parent``), one nvcc each, all started
together, into ``build/kernels/``.  Prints one JSON line per source: whether
every kernel the baseline has compiles here to the same registers and
spills (kernel names compared without the per-file namespace hash), and the
kernels only this tree has with their registers and spills.  Exits 1 if a
baseline kernel changed.  Needs ``nvcc``; runs no kernel.
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

from tante_tpu_torch.ops import _build

SOURCES = ("fused_block_sm90", "fused_chain_sm90", "fused_half_sm90", "fused_half_sm90_f32")
FIELDS = ("registers", "spill_store_bytes", "spill_load_bytes")


def _name(kernel: str) -> str:
    """A kernel's mangled name without the anonymous namespace's hash."""
    return re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "", kernel)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--baseline", required=True, help="root of the tree to compare with")
    args = ap.parse_args(argv)
    trees = {"this": _build.CSRC,
             "baseline": Path(args.baseline) / "tante_tpu_torch" / "ops" / "csrc"}
    specs = [(src, f"{src}_{tag}", (), tree / f"{src}.cu")
             for src in SOURCES for tag, tree in trees.items() if (tree / f"{src}.cu").exists()]
    built = dict(zip([(spec[0], spec[1].rsplit("_", 1)[1]) for spec in specs],
                     _build.compile_libraries(specs)))
    same_all = True
    for src in SOURCES:
        # A source the baseline lacks: every kernel of it is new.
        this, base = ({_name(e["kernel"]): {f: e[f] for f in FIELDS}
                       for e in built.get((src, tag), {"ptxas": []})["ptxas"]} for tag in trees)
        changed = [{"kernel": k, "this": this.get(k), "baseline": v}
                   for k, v in base.items() if this.get(k) != v]
        same_all &= not changed
        print(json.dumps({
            "source": src, "baseline_kernels": len(base),
            "baseline_kernels_unchanged": not changed, "changed": changed,
            "new_kernels": [{"kernel": k, **e} for k, e in this.items() if k not in base],
        }), flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    raise SystemExit(main())
