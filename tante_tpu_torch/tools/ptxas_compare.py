"""The Hopper block sources' ``-Xptxas -v`` summaries against another tree's.

    python3 -m tante_tpu_torch.tools.ptxas_compare --baseline DIR [--sass TEXT]
        [--sources NAME ...] [--same-sass] [--changed TEXT ...]

Builds ``fused_block_sm90.cu``, ``fused_chain_sm90.cu``,
``fused_half_sm90.cu``, ``fused_half_sm90_f32.cu``,
``fused_block_long_sm90.cu`` and ``fused_half_long_sm90.cu`` of this tree and of
the tree at ``DIR`` where it has the source (its
``tante_tpu_torch/ops/csrc/``; e.g. the parent commit unpacked with ``git
archive HEAD~1 | tar -x -C build/parent``), one nvcc each, all started
together, into ``build/kernels/``.  Prints one JSON line per source: whether
every kernel the baseline has compiles here to the same registers and
spills (kernel names compared without the per-file namespace hash), and the
kernels only this tree has with their registers and spills.  Exits 1 if a
baseline kernel changed.  ``--sources``: only these of the sources above
(e.g. ``fused_block_long_sm90 fused_half_long_sm90``).  ``--same-sass``: per
source, the kernels both trees have whose SASS (``cuobjdump -sass``, addresses
and encodings left out) differs between them, and how many are the same;
exits 1 if one differs.  ``--changed TEXT ...``: the kernels a change means
to change, each a kernel whose name holds one of the TEXTs (e.g.
``long_qkv``): they are still reported (as "intended"), but only another
kernel's registers, spills or (with ``--same-sass``) SASS differing exits 1.
``--sass TEXT``: per kernel of this tree whose name holds TEXT, the counts of
its tensor-core (``HMMA``) and f32 FMA (``FFMA``) instructions in the SASS
``cuobjdump -sass`` prints (where the toolkit has it).  Needs ``nvcc``; runs
no kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
from pathlib import Path

from tante_tpu_torch.ops import _build

SOURCES = ("fused_block_sm90", "fused_chain_sm90", "fused_half_sm90", "fused_half_sm90_f32",
           "fused_block_long_sm90", "fused_half_long_sm90")
FIELDS = ("registers", "spill_store_bytes", "spill_load_bytes")


def _name(kernel: str) -> str:
    """A kernel's mangled name without the anonymous namespace's hash."""
    return re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "", kernel)


def sass_listing(library: str) -> dict[str, list[str]] | None:
    """Per kernel of ``library`` (name as ``_name``) its SASS instructions in
    order, as ``cuobjdump -sass`` prints them without addresses and
    encodings; None where the toolkit has no ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                         check=True).stdout
    found, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _name(m.group(1))
            found[name] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and name is not None:
            found[name].append(" ".join(m.group(1).split()))
    return found


def sass_counts(library: str, text: str) -> list[dict]:
    """Per kernel of ``library`` whose name holds ``text``: its HMMA and FFMA
    instruction counts from ``cuobjdump -sass`` (which opcodes of each)."""
    listing = sass_listing(library)
    if listing is None:
        return [{"error": "cuobjdump not found"}]
    found = []
    for name, code in listing.items():
        if text not in name:
            continue
        ops = {}
        for ins in code:
            op = re.sub(r"^@!?U?P\w+\s+", "", ins).split(" ")[0]
            ops[op] = ops.get(op, 0) + 1
        found.append({"kernel": name, "hmma": sum(
            v for k, v in ops.items() if k.startswith("HMMA")), "ffma": sum(
            v for k, v in ops.items() if k.startswith("FFMA")),
            "opcodes": {k: v for k, v in sorted(ops.items())
                        if k.startswith(("HMMA", "FFMA"))}})
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--baseline", required=True, help="root of the tree to compare with")
    ap.add_argument("--sass", help="count HMMA / FFMA in this tree's kernels holding this text")
    ap.add_argument("--sources", nargs="+", choices=SOURCES, default=SOURCES,
                    help="the sources to compare (default: all)")
    ap.add_argument("--same-sass", action="store_true",
                    help="compare the SASS of the kernels both trees have")
    ap.add_argument("--changed", nargs="+", default=[], metavar="TEXT",
                    help="kernels meant to change: names holding any of these")
    args = ap.parse_args(argv)
    meant = lambda k: any(t in k for t in args.changed)  # noqa: E731
    trees = {"this": _build.CSRC,
             "baseline": Path(args.baseline) / "tante_tpu_torch" / "ops" / "csrc"}
    specs = [(src, f"{src}_{tag}", (), tree / f"{src}.cu")
             for src in args.sources for tag, tree in trees.items()
             if (tree / f"{src}.cu").exists()]
    built = dict(zip([(spec[0], spec[1].rsplit("_", 1)[1]) for spec in specs],
                     _build.compile_libraries(specs)))
    same_all = True
    for src in args.sources:
        # A source the baseline lacks: every kernel of it is new.
        this, base = ({_name(e["kernel"]): {f: e[f] for f in FIELDS}
                       for e in built.get((src, tag), {"ptxas": []})["ptxas"]} for tag in trees)
        changed = [{"kernel": k, "this": this.get(k), "baseline": v, "intended": meant(k)}
                   for k, v in base.items() if this.get(k) != v]
        same_all &= all(e["intended"] for e in changed)
        line = {"source": src, "baseline_kernels": len(base),
                "baseline_kernels_unchanged": not changed,
                "others_unchanged": all(e["intended"] for e in changed), "changed": changed,
                "new_kernels": [{"kernel": k, **e, "intended": meant(k)}
                                for k, e in this.items() if k not in base]}
        if args.sass and (src, "this") in built:
            line["sass"] = sass_counts(built[(src, "this")]["library"], args.sass)
        if args.same_sass and all((src, tag) in built for tag in trees):
            this_sass, base_sass = (sass_listing(built[(src, tag)]["library"]) for tag in trees)
            if this_sass is None:
                line["sass_equal"] = "cuobjdump not found"
            else:
                both = sorted(set(this_sass) & set(base_sass))
                differ = [k for k in both if this_sass[k] != base_sass[k]]
                line["sass_equal"] = {"kernels_in_both": len(both), "same": len(both) - len(differ),
                                      "differ": differ,
                                      "differ_not_intended": [k for k in differ if not meant(k)]}
                same_all &= all(meant(k) for k in differ)
        print(json.dumps(line), flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    raise SystemExit(main())
