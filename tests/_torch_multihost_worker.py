"""One rank of tests/test_torch_multihost.py's two-process gloo group, on
the CPU: it evaluates ``CANDIDATES`` through the port's
``run_candidates_multihost`` with the deterministic ``runner`` (one
candidate crashes), checks ``_fanout_and_rank`` and
``check_resume_consistency``, runs two rounds of ``bo`` with the analytic
``bo_runner`` into a ``bo_results_path`` of its own, then resumes it
(rank 0's path holds rounds, rank 1's none, so the resume must fail), and
writes what it saw as JSON.

    python tests/_torch_multihost_worker.py PORT RANK WORLD OUT.json BO_DIR
"""

import json
import os
import sys

CANDIDATES = [(1.0, 1.0), (2.0, 2.0), (3.0, 3.0), (4.0, 4.0), (5.0, 5.0)]
BO_PARAMS = {
    "temp": {"logbounds": [-10.0, 0.0], "candidates": [1e-2, 1e-8]},
    "sigma": {"logbounds": [-10.0, 0.0], "candidates": [1e-2, 1e-8]},
}


def runner(idx, dev, cand):
    """10 * p1 + p2 + 0.1 (not a float32 value), except for (4, 4)."""
    if cand[0] == 4.0:
        raise ValueError("synthetic candidate failure")
    return 10.0 * cand[0] + cand[1] + 0.1


def bo_runner(idx, dev, cand):
    """A smooth objective of (temp, sigma), its peak inside the bounds, as
    a float32 value (so that crossing the processes as float32 leaves the
    scores, and the loop's next candidates, as one process has them)."""
    import numpy as np
    lt, ls = np.log10(cand[0]), np.log10(cand[1])
    return float(np.float32(30.0 - 0.5 * ((lt + 5.0) ** 2 + (ls + 4.0) ** 2)))


def main():
    port, rank, world, out_path, bo_dir = sys.argv[1:6]
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch.distributed as dist
    from mfvi_dip_mia_tpu_torch.bo.loop import _fanout_and_rank, bo
    from mfvi_dip_mia_tpu_torch.parallel.multihost import (
        check_resume_consistency, run_candidates_multihost)

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=int(world), rank=int(rank))
    try:
        kept_c, kept_y = run_candidates_multihost(
            "den", "mfvi", CANDIDATES, {}, devices=["cpu"], runner=runner)
        fanout_fn, is_main = _fanout_and_rank()
        check_resume_consistency(3)
        try:
            check_resume_consistency(int(rank))
            mismatch = None
        except RuntimeError as e:
            mismatch = str(e)
        rp = {"bo_results_path": bo_dir, "devices": ["cpu"]}
        X, Y = bo("den", "mfvi", BO_PARAMS, rp, n_rounds=2, plot=False,
                  runner=bo_runner, gp_iters=300)
        written = sorted(os.listdir(bo_dir))
        try:
            bo("den", "mfvi", BO_PARAMS, rp, n_rounds=3, plot=False,
               runner=bo_runner, gp_iters=300, resume=True)
            bo_mismatch = None
        except RuntimeError as e:
            bo_mismatch = str(e)
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump({"kept_c": [list(c) for c in kept_c], "kept_y": kept_y,
                   "is_main": bool(is_main),
                   "routed_multihost": fanout_fn is run_candidates_multihost,
                   "mismatch": mismatch, "bo_mismatch": bo_mismatch,
                   "bo_X": [list(map(float, x)) for x in X],
                   "bo_Y": [float(y) for y in Y], "bo_written": written,
                   "jax_imported": "jax" in sys.modules}, f)


if __name__ == "__main__":
    main()
