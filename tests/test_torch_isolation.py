"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
its entry points refuse to fall back to the CPU quietly, and its kernel
wrappers take the plain version only for a tensor on the CPU."""

import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import mfvi_dip_mia_tpu_torch
from mfvi_dip_mia_tpu_torch.ops import kernels
from mfvi_dip_mia_tpu_torch.ops.kernels import build
from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf
from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb
from mfvi_dip_mia_tpu_torch.ops.kernels import lrt_conv as tlrt
from mfvi_dip_mia_tpu_torch.ops.kernels import radon_banded as rb
from mfvi_dip_mia_tpu_torch.ops.kernels import radon_dense as rd
from mfvi_dip_mia_tpu_torch.ops.radon import FastRadonTransform
import mfvi_dip_mia_tpu_torch.tasks.problems as TP
import mfvi_dip_mia_tpu_torch.tasks.trainer as TT

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        mfvi_dip_mia_tpu_torch.__path__, "mfvi_dip_mia_tpu_torch."))


# Run in a fresh interpreter: block every JAX-side module already loaded (an
# interpreter may preload jax at start-up) and every future import of one,
# then import each module of the port.
_BLOCKED_IMPORT = r"""
import importlib, sys
blocked = ("jax", "jaxlib", "optax", "mfvi_dip_mia_tpu")
def is_blocked(name):
    return any(name == b or name.startswith(b + ".") for b in blocked)
for name in [n for n in sys.modules if is_blocked(n)]:
    del sys.modules[name]
for b in blocked:
    sys.modules[b] = None
for name in sys.argv[1:]:
    importlib.import_module(name)
leaked = [n for n, m in sys.modules.items() if is_blocked(n) and m is not None]
assert not leaked, leaked
print("imported", len(sys.argv) - 1)
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert len(mods) >= 30
    for name in ("ops.kernels.fused_block", "bayes.uncertainty",
                 "utils.config", "utils.viz", "tasks.runners",
                 "ops.kernels.lrt_conv", "ops.kernels.radon_dense"):
        assert f"mfvi_dip_mia_tpu_torch.{name}" in mods
    out = _run(["-c", _BLOCKED_IMPORT, *mods], REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"imported {len(mods)}" in out.stdout


def test_chip_smoke_imports_nothing_of_jax():
    import ast
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names.isdisjoint({"jax", "jaxlib", "optax", "mfvi_dip_mia_tpu"})
    assert "mfvi_dip_mia_tpu_torch" in names


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    for cwd, env_path in ((REPO, REPO), (str(tmp_path), str(tmp_path))):
        env = dict(os.environ, PYTHONPATH=env_path, OMP_NUM_THREADS="1")
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.build_problem("den", "mfvi", 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.fit(None, TT.Method("mfvi"), num_iter=1, lr=1e-3)
    theta = np.arange(0.0, 180.0, 30.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FastRadonTransform((1, 1, 32, 32), theta)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rb.prepare_banded_direct(theta, 32, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rd.prepare_matrix_bf16(np.zeros((4, 8), np.float32))


def test_wrappers_take_the_plain_version_for_cpu_tensors():
    kernels.reset_launches()
    rng = np.random.default_rng(0)
    xp = torch.from_numpy(rng.standard_normal((6, 12, 10)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 6, 3, 3)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((5, 10, 8)).astype(np.float32))
    assert torch.equal(tcf.conv_valid_fwd(xp, w), tcf.conv_valid_plain(xp, w))
    assert torch.equal(tcf.conv_dw(xp, g, 3, 3), tcf.conv_dw_plain(xp, g, 3, 3))
    assert torch.equal(tcf.conv_dx(g, w), tcf.conv_dx_plain(g, w))
    st = rb.prepare_banded_direct(np.arange(0.0, 180.0, 30.0), 32, 32,
                                  device="cpu")
    v = torch.from_numpy(rng.standard_normal((1, 32 * 32)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(
        (st.t_pad * 32, 1)).astype(np.float32))
    assert torch.equal(rb.radon_fwd(st, v), rb.radon_fwd_plain(st, v))
    assert torch.equal(rb.radon_adj(st, y), rb.radon_adj_plain(st, y))
    xf = torch.from_numpy(rng.standard_normal((1, 6, 8, 8)).astype(np.float32))
    gam, bet = torch.ones(5), torch.zeros(5)
    assert torch.equal(
        tfb.apply_fused(xf, w, gam, bet),
        tfb.fwd_plain(F.pad(xf, (1, 1, 1, 1), mode="reflect")[0], w, gam,
                      bet)[0][None])
    wv = w.abs()
    assert all(torch.equal(a, b) for a, b in zip(
        tlrt.double_conv_fwd(xp, w, wv), tlrt.fused_double_conv(xp, w, wv)))
    a = torch.from_numpy(rng.standard_normal((24, 64)).astype(np.float32)
                         ).to(torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((1, 64)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((1, 24)).astype(np.float32))
    assert torch.equal(rd.radon_dense_fwd(a, v), rd.radon_dense_fwd_plain(a, v))
    assert torch.equal(rd.radon_dense_adj(a, y), rd.radon_dense_adj_plain(a, y))
    assert [k.launches for k in kernels.KERNELS] == [0] * 11
    assert build._LIB is None          # nothing was built or loaded


def test_kernel_records_name_their_sources_and_tpu_kernels():
    names = [k.name for k in kernels.KERNELS]
    assert names == ["cf_conv_fwd", "cf_conv_dw", "radon_banded_fwd",
                     "radon_banded_adj", "fused_block_fwd",
                     "fused_block_bwd_dc", "fused_block_bwd_dw",
                     "fused_block_bwd_dx", "lrt_conv_fwd", "radon_dense_fwd",
                     "radon_dense_adj"]
    for k in kernels.KERNELS:
        assert os.path.isfile(os.path.join(REPO, k.source)), k.source
        path, line = k.replaces.split(" ")[0].split(":")
        with open(os.path.join(REPO, path)) as f:
            src = f.read().splitlines()
        fn = k.replaces.split("(")[1].rstrip(")")
        assert src[int(line) - 1].startswith(f"def {fn}("), k.replaces
    assert set(build._SIGNATURES) == set(names)
    with pytest.raises(ValueError, match="CUDA tensor"):
        build.require_cuda(torch.zeros(2), "x")
