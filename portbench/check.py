"""What decides ``correct``: each candidate's first three steps, as the
program ran them in the timed fit, against the plain reference from the
same seed: the module the configuration names (``"reference"``,
portbench/reference/<module>.py).

Read from the program (the probe, ``fits.py``): its initial parameters, Adam's
first moment after step 1 (m1 = (1 - b1) g1, so the first gradient as the
optimizer got it is m1 / (1 - b1)), its parameters after step 3 and the
metric rows of steps 1-3, each leaf by name through the program's own flat
layout. The reference makes its own initial parameters, inputs, operator and
draws, and runs three steps in float32 with TF32 off. The numbers, each the
worst over the leaves (or rows) and over the candidates:

  init_gap     the largest |difference| of the initial parameters (exact: 0)
  grad_gap     |‖g_p‖ - ‖g_r‖| per leaf, over max(‖g_r‖, the median leaf's)
  grad_diff    ‖g_p - g_r‖ per leaf, over the same
  change_gap   |‖d_p‖ - ‖d_r‖| per leaf of the change d after three steps,
               over max(‖d_r‖, the median leaf's), the leaves whose
               reference gradient is under a thousandth of the median
               leaf's left out (they move by round-off alone)
  change_diff  ‖d_p - d_r‖ per leaf, over the same, the same leaves
  *_med        grad_diff and change_diff of the median leaf
  rows_gap     |row_p - row_r| / |row_r| of the rows' MSE columns
               (mse_corrupted, mse_gt), steps 1-3
  rows1_gap    the same of step 1's row alone

A configuration's ``limits`` name the numbers compared and their limits;
the others are printed beside them.
"""

from __future__ import annotations

import math

import torch

from .reference import precision

ADAM_B1 = 0.9
NOUGHT = 1e-3
ROW_COLUMNS = (0, 1)


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            leaves.items()}


def _median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


def readings(prog: dict, ref: dict) -> dict:
    """The numbers of one candidate. ``prog`` and ``ref`` each hold, by leaf
    name, 'flat0', 'g1' and 'flat3' (dicts of tensors) and 'rows' (3, 8)."""
    names = sorted(ref["g1"])
    if sorted(prog["g1"]) != names:
        raise ValueError("the program's leaves are not the reference's: "
                         f"{sorted(set(prog['g1']) ^ set(names))[:8]}")
    out = {"init_gap": max(float((prog["flat0"][k].double()
                                  - ref["flat0"][k].double()).abs().max())
                           for k in names)}
    gr, gp = ref["g1"], prog["g1"]
    ngr, ngp = _norms(gr), _norms(gp)
    med = _median(ngr.values())
    diff = _norms({k: gp[k].double() - gr[k].double() for k in names})
    out["grad_gap"] = max(abs(ngp[k] - ngr[k]) / max(ngr[k], med)
                          for k in names)
    out["grad_diff"] = max(diff[k] / max(ngr[k], med) for k in names)
    out["grad_diff_med"] = _median(diff[k] / max(ngr[k], med)
                                   for k in names)
    kept = [k for k in names if ngr[k] >= NOUGHT * med]
    dr = {k: ref["flat3"][k].double() - ref["flat0"][k].double()
          for k in kept}
    dp = {k: prog["flat3"][k].double() - prog["flat0"][k].double()
          for k in kept}
    ndr, ndp = _norms(dr), _norms(dp)
    dmed = _median(ndr.values())
    ddiff = _norms({k: dp[k] - dr[k] for k in kept})
    out["change_gap"] = max(abs(ndp[k] - ndr[k]) / max(ndr[k], dmed)
                            for k in kept)
    out["change_diff"] = max(ddiff[k] / max(ndr[k], dmed) for k in kept)
    out["change_diff_med"] = _median(ddiff[k] / max(ndr[k], dmed)
                                     for k in kept)
    rp = prog["rows"].double()[:, list(ROW_COLUMNS)]
    rr = ref["rows"].double()[:, list(ROW_COLUMNS)]
    rel = (rp - rr).abs() / rr.abs().clamp(min=1e-30)
    out["rows_gap"] = float(rel.max())
    out["rows1_gap"] = float(rel[0].max())
    out["left_out"] = len(names) - len(kept)
    return {k: (v if math.isfinite(v) else float("inf"))
            for k, v in out.items()}


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> dict:
    """The leaves behind the gradient numbers: the ``n`` largest by each,
    with the reference's norm and the median leaf's (for PERF.md)."""
    names = sorted(ref["g1"])
    ngr = _norms(ref["g1"])
    med = _median(ngr.values())
    rows = []
    for k in names:
        gp, gr = prog["g1"][k].double(), ref["g1"][k].double()
        d = float(torch.linalg.vector_norm(gp - gr))
        rows.append((d / max(ngr[k], med), k, ngr[k],
                     abs(float(torch.linalg.vector_norm(gp)) - ngr[k])
                     / max(ngr[k], med)))
    rows.sort(reverse=True)
    return {"median_grad_norm": med,
            "grad_diff_top": [[k, d, norm, gap] for d, k, norm, gap in
                              rows[:n]]}


def program_side(cand) -> dict:
    """A candidate's probe reads as ``readings`` takes them."""
    leaves = cand.prep.params.with_flat
    return {"flat0": leaves(cand.flat0).leaves(),
            "g1": {k: v / (1 - ADAM_B1)
                   for k, v in leaves(cand.m1).leaves().items()},
            "flat3": leaves(cand.flat3).leaves(),
            "rows": cand.rows3}


def reference_side(cell, temp: float, sigma: float, seed: int, device,
                   rounding: str | None = None) -> dict:
    """The three steps of ``cell``'s reference module from ``seed`` on
    ``device``; ``rounding`` computes its convs at a lower precision (the
    control)."""
    ref = cell.reference()
    with precision.turn_off_tf32():
        fit = ref.Fit(cell.config, temp, sigma, seed, device,
                      quant=precision.rounding(rounding))
        flat0 = fit.flat.clone()
        rows = []
        first = fit.step()
        rows.append(first["row"])
        for _ in range(2):
            rows.append(fit.step()["row"])
        lay = fit.layout
        return {"flat0": lay.leaves(flat0), "g1": lay.leaves(first["grad"]),
                "flat3": lay.leaves(fit.flat), "rows": torch.stack(rows)}


def worst(per_candidate: list) -> dict:
    """Each number's worst over the candidates."""
    keys = per_candidate[0].keys()
    return {k: max(r[k] for r in per_candidate) for k in keys}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {'value', 'limit'}}) for the numbers ``limits``
    names; a number above its limit, or missing, is not correct."""
    compared = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name, float("inf"))
        compared[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    return ok, compared
