#!/usr/bin/env python3
"""Time every tile plan of the tensor-core conv kernels at the U-Net's sites.

    python3 sweep_conv_plans.py [--out plans.json] [--check] [--dw | --inp-k5]
    python3 sweep_conv_plans.py --fit plans.json

On one NVIDIA GPU: for every launch of a 256^2 5-scale step (chip_smoke.py's
conv sites) -- ``cf_conv_fwd`` forward and FULL dx in bf16 (the CT path) and
f32 (den, the LRT backward's dx) and ``lrt_conv_fwd`` in f32 (path A) -- and
for ``fused_block_bwd_dx`` at the 19 fused sites that need a dx, in f32
(den) and bf16 (CT), the profiler's device time of each (tile, split of K)
the kernels can launch, beside the plan ``ops/kernels/cf_conv.py::
tile_plan`` picks (``fused_block.py::dx_plan``). With ``--dw`` instead:
``cf_conv_dw`` at every distinct conv-site shape of the CT and den nets in
bf16 and f32, and ``fused_block_bwd_dw`` at the 20 fused sites in f32 and
bf16, at each (tile, split of the pixels) of ``dw_candidates``, beside
``dw_plan``'s pick; and ``fused_block_fwd`` at the 20 fused sites in f32
and bf16 with each conv tile (no split of K), beside ``fused_block.py::
fwd_plan``'s pick (``FWD_TILE``, ``FWD_TILE_BF16``). With ``--inp-k5`` instead:
``cf_conv_fwd`` (forward and FULL dx) and ``lrt_conv_fwd`` in f32 at the
12 k5 sites of the 6-scale inpainting net on 256^2 (stride-2 down1 as k3
parity planes, stride-1 down2 as k5), the sites the cost model was not
fitted to. Its output is what the
plans' cost models are fitted to; the port never reads it. With ``--check``
it first holds the kernels it times against their plain versions at every
site shape (chip_smoke.py's phase-2 checks). Prints one JSON summary line.

``--fit`` (no card needed) reads such a file and grid-searches the cost
model's constants -- for the conv, LRT and fused dx rows
``_CHUNK_LATENCY``, ``_ROW_COST``, ``_MMA_COST``, ``_REMOTE_COST``; for the
dw and fused dw rows ``_DW_LATENCY``, ``_DW_MMA_COST``, ``_DW_GLOBAL_COST``
(ops/kernels/cf_conv.py) -- for the ones whose picks sum to the least
measured device time; it prints them beside the sums of the current
constants' picks and of the best plan of every launch, and those sums for
each kind of row.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import sys
import time

CONV_KINDS = ("conv", "lrt", "fused_dx")    # tile_plan's rows
DW_KINDS = ("dw", "fused_dw")               # dw_plan's rows


def candidates(tcf, h, w, n, i, dtype):
    chunks = -(-i // tcf.chunk_channels(dtype))
    return [tcf._plan(t, s, h, w, n, chunks)
            for t, (_, bn) in enumerate(tcf.TILES) if bn <= max(16, n)
            for s in (1, 2, 4, 8) if s <= min(tcf.MAX_SPLIT, chunks)]


def fit(path: str) -> dict:
    """The cost constants whose picks take the least measured time."""
    with open(path) as f:
        rows = json.load(f)["rows"]
    out = {}
    conv = [r for r in rows if r["kind"] in CONV_KINDS]
    if conv:
        out["conv"] = fit_conv(conv)
    dw = [r for r in rows if r["kind"] in DW_KINDS]
    if dw:
        out["dw"] = fit_dw(dw)
    for kind in sorted({r["kind"] for r in rows}):
        rs = [r for r in rows if r["kind"] == kind]
        out[f"sums_{kind}"] = dict(
            picked_ms=sum(r["picked"]["ms"] for r in rs),
            best_ms=sum(r["best"]["ms"] for r in rs), launches=len(rs))
    print(json.dumps(out))
    return out


def fit_dw(rows) -> dict:
    """The dw plan's constants whose picks take the least measured time."""
    import itertools
    import torch
    from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    names = ("_DW_LATENCY", "_DW_MMA_COST", "_DW_GLOBAL_COST")
    keep = {k: getattr(tcf, k) for k in names}

    def total(consts) -> float:
        lat, mma_bf16, mma_f32, glob = consts
        tcf._DW_LATENCY, tcf._DW_GLOBAL_COST = lat, glob
        tcf._DW_MMA_COST = {2: mma_bf16, 4: mma_f32}
        tcf.dw_plan.cache_clear()
        t = 0.0
        for r in rows:
            p = tcf.dw_plan(r["h"], r["w"], r["n"], r["i"],
                            dtypes[r["dtype"]], r["k"])
            t += next((c["ms"] or float("inf") for c in r["times"]
                       if (c["tile"], c["split"]) == (p.tile, p.split)),
                      float("inf"))
        return t

    try:
        current = total((keep["_DW_LATENCY"], keep["_DW_MMA_COST"][2],
                         keep["_DW_MMA_COST"][4], keep["_DW_GLOBAL_COST"]))
        grid = itertools.product((10.0, 30.0, 100.0, 300.0, 1000.0),
                                 (0.03, 0.1, 0.3, 1.0, 3.0),
                                 (0.1, 0.3, 1.0, 3.0, 10.0),
                                 (10.0, 30.0, 100.0, 300.0, 1000.0))
        best = min(grid, key=total)
        fitted = total(best)
    finally:
        for k, v in keep.items():
            setattr(tcf, k, v)
        tcf.dw_plan.cache_clear()
    return dict(current_ms=current, fitted_ms=fitted,
                best_plans_ms=sum(min(c["ms"] for c in r["times"] if c["ms"])
                                  for r in rows),
                constants=dict(zip(("_DW_LATENCY", "_DW_MMA_COST_bf16",
                                    "_DW_MMA_COST_f32", "_DW_GLOBAL_COST"),
                                   best)))


def fit_conv(rows) -> dict:
    """tile_plan's constants whose picks take the least measured time."""
    import itertools
    import torch
    from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    keep = {k: getattr(tcf, k) for k in ("_CHUNK_LATENCY", "_ROW_COST",
                                         "_MMA_COST", "_REMOTE_COST")}

    def total(consts) -> float:
        (tcf._CHUNK_LATENCY, tcf._ROW_COST, mma_bf16, mma_f32,
         tcf._REMOTE_COST) = consts
        tcf._MMA_COST = {2: mma_bf16, 4: mma_f32}
        tcf.tile_plan.cache_clear()
        t = 0.0
        for r in rows:
            p = tcf.tile_plan(r["h"], r["w"], r["n"], r["i"],
                              dtypes[r["dtype"]], r["k"], r["n_weights"])
            t += next(c["ms"] or float("inf") for c in r["times"]
                      if (c["tile"], c["split"]) == (p.tile, p.split))
        return t

    try:
        current = total((keep["_CHUNK_LATENCY"], keep["_ROW_COST"],
                         keep["_MMA_COST"][2], keep["_MMA_COST"][4],
                         keep["_REMOTE_COST"]))
        grid = itertools.product((30.0, 100.0, 300.0, 1000.0, 3000.0),
                                 (1.0,), (0.3, 1.0, 3.0), (1.0, 3.0, 10.0),
                                 (0.0, 1.0, 4.0, 16.0))
        best = min(grid, key=total)
        fitted = total(best)
    finally:
        for k, v in keep.items():
            setattr(tcf, k, v)
        tcf.tile_plan.cache_clear()
    # a profile that caught no kernel (0 ms) is no measurement
    return dict(current_ms=current, fitted_ms=fitted,
                best_plans_ms=sum(min(c["ms"] for c in r["times"] if c["ms"])
                                  for r in rows),
                constants=dict(zip(("_CHUNK_LATENCY", "_ROW_COST",
                                    "_MMA_COST_bf16",
                                    "_MMA_COST_f32", "_REMOTE_COST"),
                                   best)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--dw", action="store_true",
                    help="time the dw plans and the fused forward's tiles")
    ap.add_argument("--inp-k5", action="store_true",
                    help="time the conv and LRT plans at the inpainting "
                    "net's k5 sites")
    ap.add_argument("--fit", default=None,
                    help="fit the cost model to this sweep's output")
    args = ap.parse_args(argv)
    if args.fit:
        fit(args.fit)
        return 0

    import torch
    if not torch.cuda.is_available():
        print("sweep_conv_plans: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mfvi_dip_mia_tpu_torch.nn import build_skip_net
    from mfvi_dip_mia_tpu_torch.ops.kernels import build
    from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf
    from mfvi_dip_mia_tpu_torch.ops.kernels import lrt_conv as tlrt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    cs.log(smi)
    build.library()
    t0 = time.perf_counter()
    nets = {n: build_skip_net(16, n_channels=n, pad="reflection",
                              skip_n33d=[16, 32, 64, 128, 128],
                              skip_n33u=[16, 32, 64, 128, 128], skip_n11=4,
                              num_scales=5, upsample_mode="bilinear")
            for n in (1, 2)}
    sites = cs.conv_sites(nets[1], cs.SIZE)
    l_sites = cs.conv_sites(nets[2], cs.SIZE)
    f_sites = cs.fused_sites(nets[2], cs.SIZE)
    if args.dw:
        rows = sweep_dw(cs, sites + l_sites, f_sites, args.check)
        return report(cs, smi, rows, (("dw", "bf16"), ("dw", "f32"),
                                      ("fused_dw", "f32"), ("fused", "f32"),
                                      ("fused_dw", "bf16"),
                                      ("fused", "bf16")), args.out, t0)
    if args.check:
        results = {}
        cs.check_conv_kernels(sites, results)
        cs.check_lrt_kernel(l_sites, results)
        cs.check_fused_kernels(f_sites, results)
        cs.check_fused_kernels(f_sites, results, torch.bfloat16)

    groups = (("conv", torch.bfloat16, "bf16", sites),
              ("conv", torch.float32, "f32", sites),
              ("lrt", torch.float32, "f32", l_sites))
    if args.inp_k5:
        k5 = [s for s in cs.conv_sites(cs.sr_inp_nets()["inp"], 256)
              if s["name"].endswith(("down1", "down2"))]
        groups = (("conv", torch.float32, "f32", k5),
                  ("lrt", torch.float32, "f32", k5))
    chosen = tcf.tile_plan
    forced = {}
    tcf.tile_plan = lambda *a, **kw: forced.get("plan") or chosen(*a, **kw)
    gen = torch.Generator(device=cs.DEVICE).manual_seed(12)
    rows = []
    try:
        for kind, dtype, dname, group in groups:
            for s in group:
                i, hp, wp = s["xp"]
                o, _, k, _ = s["w"]
                if kind == "lrt":
                    xp, w_mu, w_var, _ = cs.lrt_operands(s, dtype, gen)
                    calls = [("fwd", hp - k + 1, wp - k + 1, o, i, 2,
                              lambda: tlrt.double_conv_fwd(xp, w_mu, w_var))]
                else:
                    xp, w, g = cs.conv_operands(s, dtype, gen)
                    calls = [("fwd", hp - k + 1, wp - k + 1, o, i, 1,
                              lambda xp=xp, w=w: tcf.conv_valid_fwd(xp, w))]
                    if s["needs_dx"]:
                        calls.append(("dx", hp, wp, i, o, 1,
                                      lambda g=g, w=w: tcf.conv_dx(g, w)))
                for tag, h, wd, n, ci, nw, fn in calls:
                    pick = chosen(h, wd, n, ci, dtype, k, nw)
                    times = []
                    for p in candidates(tcf, h, wd, n, ci, dtype):
                        forced["plan"] = p
                        times.append(dict(tile=p.tile, split=p.split,
                                          ctas=p.ctas,
                                          ms=cs.device_ms(fn, reps=5)))
                    forced.clear()
                    best = min((t for t in times if t["ms"] > 0),
                               key=lambda t: t["ms"])
                    mine = next(t for t in times if t["tile"] == pick.tile
                                and t["split"] == pick.split)
                    rows.append(dict(kind=kind, dtype=dname, site=s["name"],
                                     call=tag, h=h, w=wd, n=n, i=ci, k=k,
                                     n_weights=nw, picked=mine, best=best,
                                     times=times))
                    cs.log(f"{kind} {dname} {s['name']:16s} {tag}: picked "
                           f"{tcf.TILES[pick.tile]} s{pick.split} "
                           f"{mine['ms'] * 1e3:7.1f} us, best "
                           f"{tcf.TILES[best['tile']]} s{best['split']} "
                           f"{best['ms'] * 1e3:7.1f} us")
    finally:
        tcf.tile_plan = chosen
    if args.inp_k5:
        return report(cs, smi, rows, (("conv", "f32"), ("lrt", "f32")),
                      args.out, t0)
    rows += sweep_fused_dx(cs, f_sites, gen)
    return report(cs, smi, rows, (("conv", "bf16"), ("conv", "f32"),
                                  ("lrt", "f32"), ("fused_dx", "f32"),
                                  ("fused_dx", "bf16")), args.out, t0)


@contextlib.contextmanager
def forced(module, attr, plan):
    """``module.attr`` (a plan function) returns ``plan`` inside."""
    chosen = getattr(module, attr)
    setattr(module, attr, lambda *a, **kw: plan)
    try:
        yield
    finally:
        setattr(module, attr, chosen)


def sweep_fused_dx(cs, fused_sites, gen) -> list:
    """fused_block_bwd_dx in f32 and bf16 at every fused site that needs a
    dx under each (tile, split of K) of the FULL conv of its shape."""
    import torch
    from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf
    from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb

    rows = []
    for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for s in fused_sites:
            if not s["needs_dx"]:
                continue
            _, wk, _, _, dc = (t.to(dtype)
                               for t in cs.fused_operands(s, gen))
            h, wd, co, ci, k = (s[n] for n in ("h", "w", "co", "ci", "k"))
            row = timed_row(
                cs, "fused_dx", dname, s["name"], h + k - 1, wd + k - 1, ci,
                co, k, candidates(tcf, h + k - 1, wd + k - 1, ci, co, dtype),
                tfb.dx_plan(h, wd, co, ci, k, dtype),
                lambda p: forced(tfb, "dx_plan", p),
                lambda dc=dc, wk=wk: tfb.bwd_dx(dc, wk))
            rows.append(dict(row, n_weights=1))
    return rows


def report(cs, smi, rows, groups, out, t0) -> int:
    summary = {}
    for kind, dname in groups:
        rs = [r for r in rows if (r["kind"], r["dtype"]) == (kind, dname)]
        summary[f"{kind}_{dname}"] = dict(
            picked_ms=sum(r["picked"]["ms"] for r in rs),
            best_ms=sum(r["best"]["ms"] for r in rs), launches=len(rs))
    if out:
        with open(out, "w") as f:
            json.dump(dict(card=smi, rows=rows, summary=summary,
                           seconds=time.perf_counter() - t0), f, indent=1)
    print(json.dumps(dict(card=smi, summary=summary)))
    return 0


def timed_row(cs, kind, dname, name, h, w, n, i, k, plans, pick, force,
              fn) -> dict:
    """The device time of ``fn`` under each plan (``force(plan)`` makes the
    wrapper take it), beside ``pick``'s."""
    times = []
    for p in plans:
        with force(p):
            times.append(dict(tile=p.tile, split=p.split, ctas=p.ctas,
                              ms=cs.device_ms(fn, reps=5)))
    best = min((t for t in times if t["ms"] > 0), key=lambda t: t["ms"])
    mine = next(t for t in times
                if (t["tile"], t["split"]) == (pick.tile, pick.split))
    cs.log(f"{kind} {dname} {name:16s}: picked tile {pick.tile} "
           f"s{pick.split} {mine['ms'] * 1e3:7.1f} us, best tile "
           f"{best['tile']} s{best['split']} {best['ms'] * 1e3:7.1f} us")
    return dict(kind=kind, dtype=dname, site=name, h=h, w=w, n=n, i=i, k=k,
                picked=mine, best=best, times=times)


def sweep_dw(cs, conv_sites, fused_sites, check: bool) -> list:
    """cf_conv_dw at every distinct conv-site shape in bf16 and f32, and
    fused_block_bwd_dw at every fused site, under each of dw_candidates'
    plans; fused_block_fwd at every fused site with each conv tile (no
    split of K)."""
    import torch
    from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf
    from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb

    if check:
        results = {}
        cs.check_conv_kernels(conv_sites, results)
        cs.check_fused_kernels(fused_sites, results)
        cs.check_fused_kernels(fused_sites, results, torch.bfloat16)

    gen = torch.Generator(device=cs.DEVICE).manual_seed(13)
    shapes = {}
    for s in conv_sites:
        shapes.setdefault((s["xp"], s["w"]), s)
    rows = []
    for dtype, dname in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for s in shapes.values():
            xp, w, g = cs.conv_operands(s, dtype, gen)
            o, i, k, _ = w.shape
            h, wd = g.shape[1], g.shape[2]
            rows.append(timed_row(
                cs, "dw", dname, s["name"], h, wd, o, i, k,
                tcf.dw_candidates(h, wd, o, i, k),
                tcf.dw_plan(h, wd, o, i, dtype, k),
                lambda p: forced(tcf, "dw_plan", p),
                lambda xp=xp, g=g, k=k: tcf.conv_dw(xp, g, k, k)))
    for (dname, dtype), s in itertools.product(
            (("f32", torch.float32), ("bf16", torch.bfloat16)), fused_sites):
        xp, wk, gamma, beta, dc = (t.to(dtype)
                                   for t in cs.fused_operands(s, gen))
        h, wd, co, ci, k = (s[n] for n in ("h", "w", "co", "ci", "k"))
        rows.append(timed_row(
            cs, "fused_dw", dname, s["name"], h, wd, co, ci, k,
            tcf.dw_candidates(h, wd, co, ci, k),
            tfb.dw_plan(h, wd, co, ci, k, dtype),
            lambda p: forced(tfb, "dw_plan", p),
            lambda xp=xp, dc=dc, k=k: tfb.bwd_dw(dc, xp, k)))
        chunks = -(-ci // tcf.chunk_channels(dtype))
        plans = [tcf._plan(t, 1, h, wd, co, chunks)
                 for t, (_, bn) in enumerate(tcf.TILES) if bn <= max(16, co)]
        rows.append(timed_row(
            cs, "fused", dname, s["name"], h, wd, co, ci, k, plans,
            tfb.fwd_plan(h, wd, co, ci, k, dtype),
            lambda p: forced(tfb, "fwd_plan", p),
            lambda xp=xp, wk=wk, gamma=gamma, beta=beta: tfb.fwd(
                xp, wk, gamma, beta)))
    return rows


if __name__ == "__main__":
    sys.exit(main())
