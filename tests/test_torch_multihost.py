"""The port's multi-process BO fanout (mfvi_dip_mia_tpu_torch/parallel/
multihost.py) on a real two-process ``torch.distributed`` gloo group over
tcp://127.0.0.1 (tests/_torch_multihost_worker.py, one process per rank,
each on the CPU), against the JAX package with the same deterministic
runners:
* both ranks' ``run_candidates_multihost`` return the same kept lists,
  JAX's one-process ``run_candidates``'s with the scores rounded to
  float32 (they cross the processes as float32, as JAX's do), the crashed
  candidate dropped on both;
* ``bo``'s rank routing picks the multi-process fanout on both ranks and
  lets only rank 0 write: two rounds of ``bo`` give both ranks the same
  (X, Y), JAX's loop's (the runner's scores are float32 values, which
  cross unchanged), and write fig_data only in rank 0's
  ``bo_results_path``;
* a resume that resolved different rounds (rank 0's path holds two, rank
  1's none) raises on every rank."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from mfvi_dip_mia_tpu.parallel import fanout as JF
import mfvi_dip_mia_tpu.bo.loop as JL
import mfvi_dip_mia_tpu_torch.bo.loop as TL
from mfvi_dip_mia_tpu_torch.parallel import fanout as TF
from mfvi_dip_mia_tpu_torch.parallel import multihost as TM

from _torch_multihost_worker import BO_PARAMS, CANDIDATES, bo_runner, runner

_WORKER = os.path.join(os.path.dirname(__file__), "_torch_multihost_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_multihost")
    port = _free_port()
    outs = [tmp / f"rank{r}.json" for r in range(2)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(port), str(r), "2", str(outs[r]),
         str(tmp / f"bo{r}")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    fails = []
    for r, p in enumerate(procs):
        try:
            stdout, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate(timeout=30)
            fails.append(f"rank {r} timed out:\n{stdout.decode()}")
            continue
        if p.returncode != 0:
            fails.append(f"rank {r} rc={p.returncode}:\n{stdout.decode()}")
    assert not fails, "\n\n".join(fails)
    return [json.loads(o.read_text()) for o in outs]


def test_ranks_agree_with_jax(ranks):
    r0, r1 = ranks
    assert r0["kept_c"] == r1["kept_c"] and r0["kept_y"] == r1["kept_y"]
    jc, jy = JF.run_candidates("den", "mfvi", CANDIDATES, {}, runner=runner)
    assert r0["kept_c"] == [list(c) for c in jc]
    assert r0["kept_y"] == [float(np.float32(y)) for y in jy]
    assert [4.0, 4.0] not in r0["kept_c"] and len(r0["kept_c"]) == 4
    assert r0["kept_y"] != jy        # float32-rounded, as JAX's cross


def test_rank_routing(ranks):
    r0, r1 = ranks
    assert r0["routed_multihost"] and r1["routed_multihost"]
    assert r0["is_main"] is True and r1["is_main"] is False
    assert not r0["jax_imported"] and not r1["jax_imported"]


def test_resume_mismatch_raises_on_every_rank(ranks):
    for r in ranks:
        assert "resume mismatch" in r["mismatch"]
        assert "[0, 1]" in r["mismatch"]
        assert "resume mismatch" in r["bo_mismatch"]
        assert "[2, 0]" in r["bo_mismatch"]


def test_bo_over_two_processes(ranks, tmp_path):
    r0, r1 = ranks
    assert r0["bo_X"] == r1["bo_X"] and r0["bo_Y"] == r1["bo_Y"]
    assert r0["bo_written"] == ["0_fig_data.npz", "1_fig_data.npz"]
    assert r1["bo_written"] == []
    jx, jy = JL.bo("den", "mfvi", BO_PARAMS,
                   {"bo_results_path": str(tmp_path), "devices": None},
                   n_rounds=2, plot=False, runner=bo_runner, gp_iters=300)
    # round 0 exactly; round 1's candidates are refined by both loops'
    # GPs, which agree to ~1e-13 (tests/test_torch_bo_loop.py's tolerance)
    assert r0["bo_Y"][:4] == jy[:4]
    assert r0["bo_X"][:4] == [list(map(float, x)) for x in jx[:4]]
    assert len(r0["bo_X"]) == len(jx)
    np.testing.assert_allclose(np.log10(r0["bo_X"]), np.log10(jx),
                               atol=1e-4)
    np.testing.assert_allclose(r0["bo_Y"], jy, rtol=1e-6)


def test_one_process_is_the_plain_fanout():
    """No process group: the multi-process fanout is ``run_candidates``,
    ``bo`` routes to it and writes, and a resume needs no agreement."""
    got = TM.run_candidates_multihost("den", "mfvi", CANDIDATES, {},
                                      devices=["cpu"], runner=runner)
    assert got == TF.run_candidates("den", "mfvi", CANDIDATES, {},
                                    devices=["cpu"], runner=runner)
    assert TL._fanout_and_rank() == (TF.run_candidates, True)
    TM.check_resume_consistency(7)
