"""Several fits on one thread: the probe gives each ``prepare_fit`` the next
candidate assigned to the thread and each ``capture_step`` the candidate
whose state it captures, and a candidate of an interleaved group reads as
its fit run alone."""

import collections
import types

import pytest
import torch

from portbench import fits, harness
from portbench.tests import small

SEED = 2 ** 31 + 29


def test_captures_go_to_the_candidate_whose_state_they_capture():
    prepared = collections.namedtuple("Prepared", "step state")
    trainer = types.SimpleNamespace(
        prepare_fit=lambda: prepared(lambda s, m: None,
                                     types.SimpleNamespace(
                                         flat=torch.zeros(1))),
        capture_step=lambda step, state, gen: {True: ("graph", id(state)),
                                               False: ("graph", 0)})
    a, b = fits.Candidate(0, 1.0, 1.0), fits.Candidate(1, 2.0, 2.0)
    with fits.probe(trainer):
        with fits.assigned([a, b]):
            pa, pb, extra = (trainer.prepare_fit() for _ in range(3))
            trainer.capture_step(pb.step, pb.state, None)
            trainer.capture_step(pa.step, pa.state, None)
            trainer.capture_step(extra.step, extra.state, None)
        outside = trainer.prepare_fit()
    assert a.prep.state is pa.state and b.prep.state is pb.state
    assert (a.launches, b.launches) == (id(pa.state), id(pb.state))
    assert a.t_capture and b.t_capture
    # calls beyond the assigned candidates, and outside, pass through
    assert type(extra.step) is type(outside.step) is types.FunctionType
    assert extra.step.__name__ == outside.step.__name__ == "<lambda>"


@pytest.mark.parametrize("n_devices, sigmas", [(1, [0.1, 1e-6]),
                                               (2, [0.1, 1e-6, 1e-3])])
def test_interleaved_candidates_read_as_lone_fits(monkeypatch, n_devices,
                                                  sigmas):
    """The round's traffic through the fanout: on one device, K = 2 fits
    interleaved on one thread; on two, groups of 2 and 1 on a thread each.
    Each candidate's initial parameters, first moment after step 1,
    parameters and rows after step 3 equal those of its fit alone."""
    cell = small.small_cell("den_mfvi_f32_256.round4_interleaved")
    cell.config.update(num_iter=300, devices=["cuda:0"] * n_devices)
    cell.workload["params"] = {"temp": [1e-3], "sigma": sigmas}
    small.patch_port(monkeypatch, cell.config)
    port, _ = harness.import_port("cpu")
    group = harness.run_cell(cell, SEED, 0.0, False, 0.0, "cpu", port=port)
    assert [(c.temp, c.sigma) for c in group.candidates] == [
        (1e-3, s) for s in sigmas]
    for c in group.candidates:
        lone = small.small_cell("den_mfvi_f32_256.fit")
        lone.config.update(num_iter=300, temp=c.temp, sigma=c.sigma)
        alone = harness.run_cell(lone, SEED, 0.0, False, 0.0, "cpu",
                                 port=port).candidates[0]
        for k in ("flat0", "m1", "flat3", "rows3"):
            assert torch.equal(getattr(c, k), getattr(alone, k)), k
        assert c.error is None and c.chunks
