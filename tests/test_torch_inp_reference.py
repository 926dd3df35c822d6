"""The port's inp / mfvi fit against the benchmark's plain reference of it
(portbench/reference/inp.py), on the CPU at a small size: the 6-scale
no-skip k5 / k3 net cut to 3 scales [16, 32, 64] at 64 x 64, its nearest
upsampling, no skip branch and 4 outputs kept. The initial parameters are
the reference's bit for bit; three steps' gradients, changes and rows lie
within the configuration's limits; the masked NLL and inp's transform
agree alone; and the step's encoder points are recorded in order, in a
marked step only. The port's fit is driven as the benchmark drives it
(portbench/run.py's ``measure`` on the CPU)."""

import math
import types

import numpy as np
import pytest
import torch

import mfvi_dip_mia_tpu_torch.tasks.problems as TP
import mfvi_dip_mia_tpu_torch.tasks.trainer as TT
from mfvi_dip_mia_tpu_torch.bayes import vi
from mfvi_dip_mia_tpu_torch.utils.profiling import TRACER
from portbench import run as PR
from portbench.reference import inp as RI
from portbench.reference import net as RN
from portbench.tests import small_inp

SEED = 2 ** 31 + 41


@pytest.fixture
def cfg():
    return small_inp.small_cell().config


@pytest.fixture
def problem(monkeypatch):
    small_inp.patch_port(monkeypatch)
    TRACER.reset()
    yield TP.build_problem("inp", "mfvi", 0, device="cpu",
                           rng=np.random.default_rng(SEED))
    TRACER.reset()


def _method(cfg):
    return TT.Method("mfvi", temp=cfg["temp"], sigma=cfg["sigma"])


def test_initial_parameters_are_the_references(cfg, problem):
    ours = vi.flatten(TT.init_params(problem, _method(cfg), SEED),
                      device="cpu").leaves()
    theirs = RN.init_params(RI.Net.of(cfg), SEED)
    assert list(ours) == list(RN.Layout.of(theirs).names)
    for k, v in theirs.items():
        assert torch.equal(ours[k], v), k


def test_three_steps_within_the_limits(cfg, monkeypatch):
    cell = small_inp.small_cell()
    small_inp.patch_port(monkeypatch)
    out = PR.measure(cell, types.SimpleNamespace(seed=SEED, seconds=0.0,
                                                 trace=0), "cpu")
    assert out["correct"], out["compared"]
    r = out["lines"]["readings"]
    # in f32 on the CPU the two differ by their sums' order alone
    assert r["init_gap"] == 0.0
    assert r["grad_diff"] < 1e-4 and r["rows_gap"] < 1e-5
    assert out["failed"] == 0 and out["attempted"] >= 2


@pytest.mark.parametrize("part", ["data_loss", "transform"])
def test_masked_nll_and_transform_alone(cfg, problem, part):
    fit = RI.Fit(cfg, cfg["temp"], cfg["sigma"], SEED)
    assert torch.equal(fit.mask, problem.mask)
    assert torch.equal(fit.gt, problem.target)
    gen = torch.Generator().manual_seed(SEED)
    # log variances past the clamp on both sides
    out = torch.randn((1, 4, small_inp.SIZE, small_inp.SIZE),
                      generator=gen) * 12
    ours = getattr(problem, part)(out).double()
    theirs = getattr(fit, part)(out).double()
    assert torch.allclose(ours, theirs, rtol=1e-6, atol=0)


def _recorded(marks) -> dict:
    """The host ns of each boundary and point ``marks`` recorded."""
    names = list(range(len(marks.regions) + 1)) + list(marks.points)
    return {k: marks._ns[marks._slot(k)] for k in names
            if marks._slot(k) in marks._seen}


def test_encoder_points_in_order_in_a_marked_step_only(cfg, problem):
    prep = TT.prepare_fit(problem, _method(cfg), iterations=4, lr=cfg["lr"],
                          seed=SEED, device="cpu")
    marks = prep.marks
    assert marks.clock == "host"
    prep.step(prep.state, True)
    assert _recorded(marks) == {}
    assert marks.between(1, "deep") is None
    with TT._marking():
        prep.step(prep.state, True)
    t = _recorded(marks)
    assert t[0] <= t[1] <= t["deep"] <= t[2] <= t["deep_grad"] \
        <= t["net_grad"] <= t[3] <= t[4] <= t[5]
    regions = marks.read()
    assert 0 < marks.between(1, "deep") <= regions["forward"]
    assert 0 < marks.between("deep_grad", "net_grad") \
        < marks.between("deep_grad", 3) <= regions["backward"]
    # a later unmarked step records nothing more
    prep.step(prep.state, True)
    assert _recorded(marks) == t


def test_net_grad_ends_the_nets_backward(cfg, problem, monkeypatch):
    """In a marked step's backward the net's matrix products all run
    before ``net_grad``, and after it only the leaves' gradients' gathering
    into the flat buffer and the draw's backward (one node: concatenations
    and the softplus backward, no slice backward), up to boundary 3."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from mfvi_dip_mia_tpu_torch.utils import profiling

    log = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            log.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    point, mark = profiling.Marks.point, profiling.Marks.mark

    def logged_point(self, name):
        log.append("@" + name)
        point(self, name)

    def logged_mark(self, k):
        log.append(f"@{k}")
        mark(self, k)

    monkeypatch.setattr(profiling.Marks, "point", logged_point)
    monkeypatch.setattr(profiling.Marks, "mark", logged_mark)
    prep = TT.prepare_fit(problem, _method(cfg), iterations=4, lr=cfg["lr"],
                          seed=SEED, device="cpu")
    with Ops(), TT._marking():
        prep.step(prep.state, True)
    a, b, c = (log.index(f"@{k}") for k in ("deep_grad", "net_grad", 3))
    products = {"mm", "bmm", "addmm", "im2col", "convolution",
                "convolution_backward"}
    assert products & set(log[a:b])
    assert not products & set(log[b:c])
    assert {"cat", "softplus_backward"} <= set(log[b:c])
    assert "slice_backward" not in log[b:c]


def test_chunk_spans_carry_the_encoders_share(cfg, problem):
    TT.fit(problem, _method(cfg), num_iter=9, lr=cfg["lr"], seed=SEED,
           show_every=5, device="cpu", collect_snapshots=False)
    chunks = TRACER.spans("chunk")
    assert len(chunks) == 2
    for c in chunks:
        r = c.attrs["regions_ms"]
        assert list(r) == list(TT.STEP_REGIONS) + list(TT.STEP_SUBREGIONS)
        assert 0 < r["forward_down"] <= r["forward"]
        assert 0 < r["backward_down"] <= r["backward"]
        assert 0 < r["backward_flat"] <= r["backward"] - r["backward_down"]
        assert all(math.isfinite(v) for v in r.values())


def test_split_forward_calls_no_deep_hook(cfg, problem):
    from mfvi_dip_mia_tpu_torch.nn import sp
    params = TT.init_params(problem, TT.Method("dip"), SEED)
    x = torch.rand((1, cfg["input_depth"], small_inp.SIZE, small_inp.SIZE))
    seen = []
    split = sp.RowSplit.of(["cpu"] * 2, small_inp.SIZE,
                           problem.net.n_scales)
    problem.net(params, x, deep=seen.append, split=split)
    assert seen == []
    whole = problem.net(params, x, deep=seen.append)
    assert len(seen) == 1
    last = small_inp.WIDTHS[-1]
    side = small_inp.SIZE >> len(small_inp.WIDTHS)
    assert seen[0].shape == (1, last, side, side)
    assert torch.isfinite(whole).all()


def test_reference_row_layout(cfg):
    """The reference's row: the EMA's MSE twice, then PSNR and SSIM of the
    whole image, of the masked output and of the masked EMA; a first
    step's EMA is its output, so the last two of each agree."""
    fit = RI.Fit(cfg, cfg["temp"], cfg["sigma"], SEED)
    row = fit.step()["row"]
    assert row.shape == (8,) and row[0] == row[1]
    assert row[3] == row[4] and row[6] == row[7]
