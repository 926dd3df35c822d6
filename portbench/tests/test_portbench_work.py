"""The operation and byte counts of the bounds, against cases worked by
hand and the counts each configuration's reference module gives."""

import os

import numpy as np
import pytest
import torch

from portbench import spec
from portbench.reference import radon as R
from portbench.work import conv, peaks, radon

CFG = dict(task="ct", reference="step", imsize=256, input_depth=16,
           compute_dtype="bf16",
           theta_deg=dict(start=0, stop=180, step=4),
           net=dict(skip_n33d=[16, 32, 64, 128, 128],
                    skip_n33u=[16, 32, 64, 128, 128], skip_n11=4, n_out=1))
REF = spec.reference(CFG["reference"])


def test_one_site_by_hand():
    """levels.1.down2: 32 -> 32 channels, k3, stride 1, at 64 x 64 (level
    1's input is 128 x 128; down1 halves it)."""
    s = {x["name"]: x for x in conv.sites(CFG, REF)}["levels.1.down2"]
    assert s["flops"] == 2 * 32 * 32 * 9 * 64 * 64          # 75,497,472
    assert s["fwd_bytes"] == 2 * (32 * 64 * 64 + 32 * 32 * 9
                                  + 32 * 64 * 64)           # bf16
    assert s["needs_dx"]
    d1 = {x["name"]: x for x in conv.sites(CFG, REF)}["levels.0.down1"]
    # the net input needs no gradient; stride 2 halves the output
    assert not d1["needs_dx"]
    assert d1["flops"] == 2 * 16 * 16 * 9 * 128 * 128


def test_site_count_and_total():
    sites = conv.sites(CFG, REF)
    # 5 sites a level (skip, down1, down2, up, up1x1) and the output conv
    assert len(sites) == 26
    total = sum(s["flops"] * (3 if s["needs_dx"] else 2) for s in sites)
    assert conv.flops_per_iteration(CFG, REF) == total
    assert 8.9e9 < total < 9.1e9


# each configuration's sites, those with a dx, operations an iteration and
# least seconds an iteration, as the harness counted them before a
# configuration named its reference module
COUNTS = {"ct_mfvi_bf16_256.fit": (26, 24, 8972664832.0,
                                   2.9850834560705083e-05),
          "den_mfvi_f32_256.fit": (26, 24, 8978956288.0,
                                   5.993075696716421e-05)}


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_configurations_counts_and_totals(name):
    cell = spec.load_cell(os.path.dirname(spec.HERE), name)
    cfg, ref = cell.config, cell.reference()
    sites = conv.sites(cfg, ref)
    n, n_dx, flops, least = COUNTS[name]
    assert len(sites) == n and sum(s["needs_dx"] for s in sites) == n_dx
    assert conv.flops_per_iteration(cfg, ref) == flops
    assert conv.least_seconds_per_iteration(cfg, ref) == least


def test_least_time_is_the_larger_bound():
    assert peaks.least_seconds(989e12, 1.0, "bf16") == pytest.approx(1.0)
    assert peaks.least_seconds(1.0, 3.35e12, "f32") == pytest.approx(1.0)


def test_radon_nonzeros_of_a_tiny_operator():
    """At 0 degrees every rotated pixel centre is a pixel centre: one weight
    of 1 per pixel, and A x sums each column."""
    a = R.projection_matrix(np.array([0.0]), 4)
    assert a._nnz() == 16
    x = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    y = torch.sparse.mm(a, x.reshape(-1, 1)).reshape(4)
    assert torch.allclose(y, x.sum(dim=0))
    cfg = dict(CFG, imsize=4, theta_deg=dict(start=0, stop=1, step=4))
    flops, nbytes = radon.pass_work(cfg)
    assert flops == 2 * 16 and nbytes == 4 * (16 + 4)


def test_radon_adjoint_is_the_transpose():
    op = R.Radon(np.arange(0.0, 180.0, 30.0), 8)
    x = torch.randn(1, 1, 8, 8, requires_grad=True)
    y = torch.randn(1, 1, 6, 8)
    (g,) = torch.autograd.grad((op(x) * y).sum(), x)
    dense = op.a.to_dense()
    assert torch.allclose(g.reshape(-1), dense.t() @ y.reshape(-1),
                          atol=1e-5)
