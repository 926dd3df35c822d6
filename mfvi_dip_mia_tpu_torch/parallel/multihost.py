"""The BO fanout over several processes (counterpart of
mfvi_dip_mia_tpu/parallel/multihost.py), on ``torch.distributed``.

Every process runs the same deterministic BO loop (the GP and the
acquisition draw nothing at random, so equal observations give equal next
candidates everywhere). Each round's candidates are split round-robin by
rank, each process runs its share on its own cards through
``fanout.run_candidates``, and the (index, score) pairs are exchanged with
two all-gathers. The payload is host floats, so the group's backend is
gloo: it needs no card per rank, and two ranks may share one card (NCCL
refuses two ranks on one GPU).

Start the same CLI in every process with ``--dist-coordinator host:port
--dist-nproc N --dist-pid i`` (cli.py); ``bo()`` sees the group, routes its
fanout here and writes its artifacts on rank 0 only.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import fanout


def _world() -> tuple:
    """(world size, rank): (1, 0) without a process group."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts)


def run_candidates_multihost(task: str, bayes: str, candidates: Sequence,
                             run_params: dict, devices=None, runner=None,
                             use_spmd: bool = False,
                             interleave: str | bool = "auto",
                             sp_split: int | bool = False):
    """Evaluate ``candidates`` across every process of the group; each
    returns the same (kept_candidates, kept_scores) in candidate order, NaN
    and crashed candidates dropped (printed by rank 0 only). Rank r runs
    candidates r, r + n, ... through ``fanout.run_candidates`` on
    ``devices`` (default: its own cards). The scores cross as float32, as
    JAX's do (multihost.py:46-47), so they come back float32-rounded. With
    no group, or a group of one, this is ``fanout.run_candidates``."""
    nproc, pid = _world()
    if nproc == 1:
        return fanout.run_candidates(task, bayes, candidates, run_params,
                                     devices, runner, use_spmd=use_spmd,
                                     sp_split=sp_split, interleave=interleave)
    mine_idx = list(range(pid, len(candidates), nproc))
    _, raw = fanout.run_candidates(
        task, bayes, [candidates[i] for i in mine_idx], run_params, devices,
        runner, keep_nan=True, use_spmd=use_spmd, sp_split=sp_split,
        interleave=interleave)

    # fixed-size slots, so every rank gives the gathers one shape; index -1
    # marks an empty slot
    slots = -(-len(candidates) // nproc)
    idx = torch.full((slots,), -1, dtype=torch.int32)
    score = torch.full((slots,), float("nan"), dtype=torch.float32)
    idx[:len(mine_idx)] = torch.tensor(mine_idx, dtype=torch.int32)
    score[:len(raw)] = torch.tensor(raw, dtype=torch.float32)
    all_idx, all_score = _all_gather(idx), _all_gather(score)

    by_index = {int(i): float(y)
                for i, y in zip(all_idx.reshape(-1).tolist(),
                                all_score.reshape(-1).tolist())
                if i >= 0}
    kept_c, kept_y = [], []
    for i in sorted(by_index):
        if np.isfinite(by_index[i]):
            kept_c.append(tuple(np.asarray(candidates[i], np.float64)))
            kept_y.append(by_index[i])
        elif pid == 0:
            print(f"[fanout/multihost] candidate {candidates[i]} "
                  "diverged/crashed; dropped", flush=True)
    return kept_c, kept_y


def check_resume_consistency(start_round: int) -> None:
    """A resumed sweep reads ``bo_results_path`` in every process, so across
    hosts it must be a shared filesystem: every process must have resolved
    the same resume round, or the processes' BO states would diverge
    silently. Raises on a mismatch (multihost.py:90-106)."""
    if _world()[0] == 1:
        return
    rounds = _all_gather(torch.tensor([start_round], dtype=torch.int32))
    rounds = rounds.reshape(-1).tolist()
    if len(set(rounds)) != 1:
        raise RuntimeError(
            "multi-host resume mismatch: processes resolved different resume "
            f"rounds {rounds} — bo_results_path must be a shared "
            "filesystem visible to every host")
