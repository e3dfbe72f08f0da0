"""``tools/ptxas_compare.py``'s verdict on the CPU, with the builds stubbed.

The tool builds each source of this tree and of a baseline tree and compares
the kernels' registers, spills and (``--same-sass``) SASS.  ``--changed TEXT``
names the kernels a change means to change: they are reported, and only
another kernel's difference exits 1.  Here ``_build.compile_libraries`` and
``sass_listing`` are replaced by fakes that return fixed summaries per tree,
so the comparison and the exit code are checked without nvcc."""

import json

import pytest

from tante_tpu_torch.tools import ptxas_compare as pc

NS = "_ZN57_GLOBAL__N__dde1f20e_24_fused_block_long_sm90_cu_3900b2b4"


def entry(name: str, regs: int, spill: int = 0) -> dict:
    return {"kernel": NS + name, "registers": regs, "spill_store_bytes": spill,
            "spill_load_bytes": spill}


def fake_builds(monkeypatch, tmp_path, this: list, base: list, sass_this=None, sass_base=None):
    """Both trees' (one source's) ptxas summaries and SASS listings."""
    (tmp_path / "tante_tpu_torch" / "ops" / "csrc").mkdir(parents=True)
    (tmp_path / "tante_tpu_torch" / "ops" / "csrc" / "fused_block_long_sm90.cu").write_text("")

    def compile_libraries(specs):
        return [{"library": spec[1], "ptxas": this if spec[1].endswith("_this") else base}
                for spec in specs]

    def sass_listing(library):
        return sass_this if library.endswith("_this") else sass_base

    monkeypatch.setattr(pc._build, "compile_libraries", compile_libraries)
    monkeypatch.setattr(pc, "sass_listing", sass_listing)


def run(capsys, tmp_path, *extra) -> tuple[int, dict]:
    rc = pc.main(["--baseline", str(tmp_path), "--sources", "fused_block_long_sm90", *extra])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return rc, line


@pytest.mark.parametrize("changed", [[], ["long_qkv"]])
def test_an_unchanged_tree_exits_0(monkeypatch, tmp_path, capsys, changed):
    kernels = [entry("21block_long_qkv_kernelENS_8LongArgsE", 168),
               entry("23block_long_attn_kernelILi16ELb0EEvNS_8LongArgsE", 168, 640)]
    sass = {pc._name(k["kernel"]): ["IMAD R1, R2, R3", "EXIT"] for k in kernels}
    fake_builds(monkeypatch, tmp_path, kernels, kernels, sass, sass)
    args = ["--same-sass"] + (["--changed", *changed] if changed else [])
    rc, line = run(capsys, tmp_path, *args)
    assert rc == 0 and line["baseline_kernels_unchanged"] and not line["changed"]
    assert line["sass_equal"]["same"] == 2


def test_an_intended_change_exits_0_and_is_reported(monkeypatch, tmp_path, capsys):
    """The qkv kernel's signature changed (a new parameter): the baseline's
    is gone and a new one appears, both named by --changed; the attention
    kernel's SASS is the parent's."""
    attn = entry("23block_long_attn_kernelILi16ELb0EEvNS_8LongArgsE", 168, 640)
    base = [entry("21block_long_qkv_kernelENS_8LongArgsE", 168, 568), attn]
    this = [entry("21block_long_qkv_kernelENS_8LongArgsENS_7QkvPlanE", 168), attn]
    sass = {pc._name(attn["kernel"]): ["HGMMA.64x64x16", "EXIT"]}
    fake_builds(monkeypatch, tmp_path, this, base, sass, sass)
    rc, line = run(capsys, tmp_path, "--same-sass", "--changed", "long_qkv")
    assert rc == 0 and line["others_unchanged"]
    assert [e["intended"] for e in line["changed"]] == [True]
    assert [e["intended"] for e in line["new_kernels"]] == [True]
    rc, _ = run(capsys, tmp_path, "--same-sass")  # without --changed the same trees exit 1
    assert rc == 1


@pytest.mark.parametrize("what", ["registers", "sass"])
def test_another_kernel_changing_exits_1(monkeypatch, tmp_path, capsys, what):
    """A kernel that --changed does not name moved: its registers, or (with
    --same-sass) its SASS alone."""
    qkv = entry("21block_long_qkv_kernelENS_8LongArgsENS_7QkvPlanE", 168)
    attn = entry("23block_long_attn_kernelILi16ELb0EEvNS_8LongArgsE", 168, 640)
    moved = entry("23block_long_attn_kernelILi16ELb0EEvNS_8LongArgsE",
                  166 if what == "registers" else 168, 640)
    name = pc._name(attn["kernel"])
    sass_base = {name: ["HGMMA.64x64x16", "EXIT"], pc._name(qkv["kernel"]): ["EXIT"]}
    sass_this = dict(sass_base)
    if what == "sass":
        sass_this[name] = ["HGMMA.64x64x16", "NOP", "EXIT"]
    fake_builds(monkeypatch, tmp_path, [qkv, moved], [qkv, attn], sass_this, sass_base)
    rc, line = run(capsys, tmp_path, "--same-sass", "--changed", "long_qkv")
    assert rc == 1
    if what == "sass":
        assert line["sass_equal"]["differ_not_intended"] == [name]
    else:
        assert not line["others_unchanged"]
