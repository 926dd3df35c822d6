"""The inp configuration and its cell: found by name, its conv sites as
the published net has them, a sound small run ``correct``, every planted
fault (inp's own ``half`` among them) not correct, and on the card the
control (the reference at TF32) failing the limits at the cell's size."""

import contextlib
import types

import pytest

from portbench import calibrate, check, harness, run as R, spec
from portbench.tests import small, small_inp
from portbench.work import conv

SEED = 2 ** 31 + 29
FAULTS = ["frozen", "params", "lr2", "sign", "rows", "half", "lr11"]


def measure(monkeypatch, fault="none"):
    cell = small_inp.small_cell()
    small_inp.patch_port(monkeypatch)
    monkeypatch.setitem(calibrate.UPDATE_FAULTS, *small_inp.LR11)
    port, _ = harness.import_port("cpu")
    planted = (small_inp.half(port) if fault == "half"
               else calibrate.fault(fault, port))
    with planted:
        return R.measure(cell, types.SimpleNamespace(seed=SEED, seconds=0.0,
                                                     trace=0), "cpu")


def test_cell_parses_and_is_found():
    cell = spec.load_cell(small.ROOT, small_inp.NAME)
    cfg = cell.config
    assert cfg["task"] == "inp" and cfg["reference"] == "inp"
    assert cell.reference().__file__.endswith("reference/inp.py")
    assert cell.traffic().candidates(cell) == [(cfg["temp"], cfg["sigma"])]
    assert cfg["reduced"] == ["num_iter"]
    assert set(cfg["limits"]) == {"init_gap", "grad_diff_med", "change_gap",
                                  "change_diff_med", "rows1_gap", "rows_gap"}
    names = [m["name"] for m in cell.per_layer]
    assert {"step_forward_down_ms", "step_backward_down_ms"} <= set(names)
    assert "radon_roofline" not in names
    for name in names:
        assert callable(spec.reader(name))


def test_conv_sites_are_the_published_nets():
    """6 levels of down1 (k5, stride 2), down2 (k5) and up (k3), and the
    1 x 1 output conv: 0.747 G multiply-adds in the 12 k5 sites and 1.104 G
    in the 6 k3 ones a forward at 256 x 256; level 0's down1 reads the net
    input."""
    cell = spec.load_cell(small.ROOT, small_inp.NAME)
    sites = cell.reference().conv_sites(cell.config)
    assert len(sites) == 19
    assert [s["name"] for s in sites if not s["needs_dx"]] == \
        ["levels.0.down1"]
    by_k = {}
    for s in sites:
        side = s["size_in"] // s["stride"]
        mac = s["c_in"] * s["c_out"] * s["k"] ** 2 * side * side
        by_k[s["k"]] = by_k.get(s["k"], 0) + mac
    assert by_k == {5: 747110400, 3: 1104150528, 1: 4194304}
    d1 = {s["name"]: s for s in sites}["levels.5.down1"]
    assert (d1["c_in"], d1["c_out"], d1["k"], d1["stride"],
            d1["size_in"]) == (128, 128, 5, 2, 8)
    # each forward MAC is 2 operations a pass: forward, dx where due, dw
    assert conv.flops_per_iteration(cell.config, cell.reference()) == sum(
        2 * (by_k[k]) for k in by_k) * 3 - 2 * 16 * 16 * 25 * 128 * 128


def test_sound_run_is_correct(monkeypatch):
    out = measure(monkeypatch)
    assert out["correct"], out["compared"]
    assert out["lines"]["readings"]["init_gap"] == 0.0


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(fault, monkeypatch):
    """frozen, params, lr2, sign, rows: calibrate.py's; half: the loss over
    the top half of the image, its target and mask cut alike; lr11: the
    update a tenth too large."""
    out = measure(monkeypatch, fault)
    assert not out["correct"], out["compared"]
    # by a number the check compares, not by a failed fit
    assert out["failed"] == 0
    assert any(c["value"] > c["limit"] for c in out["compared"].values())


@pytest.mark.card
def test_control_fails_the_limits(card):
    cell = spec.load_cell(small.ROOT, small_inp.NAME)
    cfg = cell.config
    (temp, sigma), = cell.traffic().candidates(cell)
    for seed in (SEED, SEED + 1, SEED + 2):
        low = check.reference_side(cell, temp, sigma, seed, card,
                                   cfg["control"])
        ref = check.reference_side(cell, temp, sigma, seed, card)
        ok, compared = check.judge(check.readings(low, ref), cfg["limits"])
        assert not ok, compared


def test_half_planter_restores_the_loss():
    port, _ = harness.import_port("cpu")
    loss = port["tasks.problems"].Problem.data_loss
    with contextlib.suppress(RuntimeError), small_inp.half(port):
        assert port["tasks.problems"].Problem.data_loss is not loss
        raise RuntimeError
    assert port["tasks.problems"].Problem.data_loss is loss
