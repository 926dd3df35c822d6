"""The plain reference against the program's CPU plain path at a small
size: the harness drives the program's fit as a run does and reads its
first three steps, and the reference works them out again from the seed."""

import types

import pytest

from portbench import run as R
from portbench.tests import small

SEED = 2 ** 31 + 11


def measure(name, monkeypatch, **over):
    cell = small.small_cell(name)
    cell.config.update(num_iter=300, **over)
    small.patch_port(monkeypatch, cell.config)
    args = types.SimpleNamespace(seed=SEED, seconds=0.0, trace=0)
    return R.measure(cell, args, "cpu")


@pytest.mark.parametrize("name", ["den_mfvi_f32_256.fit",
                                  "ct_mfvi_bf16_256.fit",
                                  "den_mfvi_f32_256.round4_interleaved"])
def test_reference_steps_agree_in_f32(name, monkeypatch):
    out = measure(name, monkeypatch, compute_dtype="f32")
    r = out["lines"]["readings"]
    assert r["init_gap"] == 0.0
    assert r["grad_diff"] < 1e-4
    assert r["grad_gap"] < 1e-5
    assert r["rows_gap"] < 1e-5
    assert out["failed"] == 0 and out["attempted"] >= 2

