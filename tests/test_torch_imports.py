"""The port stands alone: importing ``tante_tpu_torch`` (every module) and
``chip_smoke``'s module-level code loads no JAX, flax or ``tante_tpu``
module, and ``chip_smoke`` refuses to run without a CUDA device."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, pkgutil, sys
import tante_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tante_tpu_torch.__path__, "tante_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "tante_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _run(code, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_and_chip_smoke_import_no_jax():
    proc = _run(PROBE)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "tante_tpu_torch.ops.fused_block" in out["modules"]
    assert "tante_tpu_torch.serve" in out["modules"]
    assert out["bad"] == []


def test_chip_smoke_fails_without_cuda():
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            "import chip_smoke; sys.exit(chip_smoke.main())")
    proc = _run(code)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
