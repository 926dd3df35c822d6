"""Nothing a run loads is JAX or the JAX package, by top-level names
compared whole."""

import os
import subprocess
import sys
import types

from portbench import run as R

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mfvi_dip_mia_tpu_torch.x",
                        types.ModuleType("x"))
    assert "mfvi_dip_mia_tpu" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mfvi_dip_mia_tpu.tasks",
                        types.ModuleType("tasks"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("np"))
    assert {"jax", "mfvi_dip_mia_tpu"} <= set(R.forbidden_modules())


def test_a_run_loads_no_jax():
    code = """
import sys, types
sys.path.insert(0, %r)
import pytest
from portbench import run as R
from portbench.tests import small
mp = pytest.MonkeyPatch()
cell = small.small_cell("ct_mfvi_bf16_256.fit")
cell.config["num_iter"] = 300
small.patch_port(mp, cell.config)
out = R.measure(cell, types.SimpleNamespace(seed=5, seconds=0.0, trace=0),
                "cpu")
print("FOUND", R.forbidden_modules(), out["correct"] is not None)
""" % ROOT
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FOUND [] True" in proc.stdout
