"""``correct`` comes out false when the timed path is broken underneath: a
run driven as the benchmark drives it (the look for a card skipped, the
program's plain CPU path at a small size), with each fault a training cell
can have planted in the program, and the control (the reference computed a
precision lower than the configuration states) fails the limits on the
card at the cells' own sizes."""

import types

import pytest

from portbench import calibrate, check, harness, run as R, spec
from portbench.tests import small

SEED = 2 ** 31 + 23
CELLS = ["den_mfvi_f32_256.fit", "ct_mfvi_bf16_256.fit",
         "den_mfvi_f32_256.round4_interleaved"]


def measure(name, monkeypatch, fault="none"):
    cell = small.small_cell(name)
    cell.config["num_iter"] = 300
    small.patch_port(monkeypatch, cell.config)
    port, _ = harness.import_port("cpu")
    args = types.SimpleNamespace(seed=SEED, seconds=0.0, trace=0)
    with calibrate.fault(fault, port):
        return R.measure(cell, args, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, monkeypatch):
    out = measure(name, monkeypatch)
    assert out["correct"], out["compared"]


@pytest.mark.parametrize("fault", ["frozen", "params", "lr2", "sign",
                                   "half", "rows"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    """frozen: the step leaves the state unchanged; params: it leaves the
    parameters unchanged and moves Adam's moments; lr2, sign: the update
    doubled, or of the wrong sign; half: the loss's mean over half the
    image (ct: half the angles); rows: the metric rows (the fit's answer)
    altered where the step writes them."""
    out = measure(name, monkeypatch, fault)
    assert not out["correct"], out["compared"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name, card):
    cell = spec.load_cell(small.ROOT, name)
    cfg = cell.config
    for seed in (SEED, SEED + 1, SEED + 2):
        numbers = []
        for temp, sigma in cell.traffic().candidates(cell):
            low = check.reference_side(cell, temp, sigma, seed, card,
                                       cfg["control"])
            ref = check.reference_side(cell, temp, sigma, seed, card)
            numbers.append(check.readings(low, ref))
        ok, compared = check.judge(check.worst(numbers), cfg["limits"])
        assert not ok, compared
