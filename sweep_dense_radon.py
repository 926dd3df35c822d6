#!/usr/bin/env python3
"""Time the dense-matrix Radon pair alone and inside path B's fit.

    python3 sweep_dense_radon.py [--grids] [--fit-steps N] [--out FILE]
    python3 sweep_dense_radon.py --parent DIR [--fit-steps N] [--out FILE]

On one NVIDIA GPU, for the port beside this script (or, with
``--port-root DIR``, the one under DIR: another version's checkout, e.g. a
``git archive`` of a parent commit), the profiler's device time of
``radon_dense_fwd`` and ``radon_dense_adj`` on the 256^2 / 45-angle bf16
matrix with one image column, each beside cuBLAS's ``torch.mv`` on the
same matrix, the two taken in turns (median of 3), in three states:

* ``warm``: calls back to back, as chip_smoke.py's phase 4 takes them;
* ``flushed``: a 256 MB write (five L2s) before each call;
* ``read``: a 256 MB read before each call (L2 emptied of the call's
  lines, none left dirty);
* ``pages``: one float read in each 2 MB of a 2 GB buffer before each call
  (1,024 pages' address translations, 32 KB of L2);
* ``idle``: the host waits 20 ms before each call, as the host-bound fit
  leaves the card idle between its kernels.

With ``--fit-steps N`` also the device time per step of every dense kernel
and of the whole step in N profiled steps of path B's fit (the CT/MFVI
bf16 fit with ``radon_mode="dense-bf16"``). ``--grids`` times this
checkout's kernels at one and two persistent blocks per SM
(``ops/kernels/radon_dense.py::BLOCKS_PER_SM`` is the port's choice), each
checked against its plain version first. ``--parent DIR`` runs DIR's port
and this one in child processes in the order parent, this, this, parent,
so that two versions are compared on one card in one call. Prints one JSON
line; the port never reads it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
STATES = ("warm", "flushed", "read", "pages", "idle")


def smoke():
    """chip_smoke.py beside this script (its logging, tolerances, bound)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_ms(fn, before=None, reps: int = 10, tries: int = 4) -> float:
    """The profiler's device time per call of the kernels ``fn()``
    launches, with ``before()`` (not counted: its kernels are told apart by
    name from a profile of it alone) run ahead of each call. Taken again
    while a profile caught fewer than ``reps`` calls' kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kernels(body):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            body()
            torch.cuda.synchronize()
        return [ev for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA]

    skip = {ev.key for ev in kernels(before)} if before else set()
    fn()
    torch.cuda.synchronize()
    per_call = sum(ev.count for ev in kernels(fn))

    def body():
        for _ in range(reps):
            if before:
                before()
            fn()

    for _ in range(tries):
        evs = [ev for ev in kernels(body) if ev.key not in skip]
        if sum(ev.count for ev in evs) >= per_call * reps:
            break
    return sum(ev.self_device_time_total for ev in evs) / 1e3 / reps


def in_turns(fns: dict, before=None) -> dict:
    """Each of ``fns`` three times, in turns (a b, b a, a b), and the
    median of each."""
    runs = {k: [] for k in fns}
    order = list(fns)
    for turn in range(3):
        for k in (order if turn % 2 == 0 else order[::-1]):
            runs[k].append(device_ms(fns[k], before))
    return {k: dict(ms=statistics.median(r), runs=r) for k, r in runs.items()}


def time_pair(cs, grids: bool) -> dict:
    import torch
    from mfvi_dip_mia_tpu_torch.ops import radon as tradon
    from mfvi_dip_mia_tpu_torch.ops.kernels import radon_dense as rd
    from mfvi_dip_mia_tpu_torch.tasks.problems import _CT_THETA

    a = tradon.dense_matrix_bf16(_CT_THETA, cs.SIZE, cs.SIZE, "cuda")
    p, q = a.shape
    gen = torch.Generator(device="cuda").manual_seed(11)
    v = torch.rand((1, q), generator=gen, device="cuda")
    y = torch.randn((1, p), generator=gen, device="cuda")
    v16, y16 = v[0].to(torch.bfloat16), y[0].to(torch.bfloat16)
    junk = torch.ones(64 * 1024 ** 2, dtype=torch.float32, device="cuda")
    pages = torch.ones((1024, 512 * 1024), dtype=torch.float32,
                       device="cuda")
    pause = {"warm": None, "flushed": lambda: junk.fill_(1.0),
             "read": lambda: junk.sum(), "pages": lambda: pages[:, 0].sum(),
             "idle": lambda: (torch.cuda.synchronize(), time.sleep(0.02))}
    bound_ms = (a.numel() * 2 + (p + q) * 4) / cs.PEAK_BYTES_PER_S * 1e3
    out = dict(bound_ms=bound_ms, a_gb=a.numel() * 2 / 1e9)
    pairs = {"radon_dense_fwd": dict(kernel=lambda: rd.radon_dense_fwd(a, v),
                                     cuBLAS=lambda: torch.mv(a, v16)),
             "radon_dense_adj": dict(kernel=lambda: rd.radon_dense_adj(a, y),
                                     cuBLAS=lambda: torch.mv(a.T, y16))}
    for name, fns in pairs.items():
        out[name] = {s: in_turns(fns, pause[s]) for s in STATES}
        cs.log(f"{name}: " + "; ".join(
            f"{s} kernel {r['kernel']['ms']:.4f} ms, cuBLAS "
            f"{r['cuBLAS']['ms']:.4f} ms" for s, r in out[name].items()))
    if grids:
        out["grids"] = time_grids(cs, rd, a, v, y)
    return out


def time_grids(cs, rd, a, v, y) -> dict:
    """This checkout's kernels at one and two blocks per SM (warm), each
    first held to its plain version."""
    p, q = a.shape
    tol = cs.TOL[("radon_dense", "bf16")]
    n_sm = rd._sm_count(v.device)
    fns = {}
    for bps in (1, 2):
        plan = rd._device_plan(p, q, v.device, bps * n_sm)
        fns[f"fwd {bps}/SM"] = (lambda pl=plan: rd._launch_fwd(a, v, *pl),
                                rd.radon_dense_fwd_plain(a, v))
        fns[f"adj {bps}/SM"] = (lambda pl=plan: rd._launch_adj(a, y, *pl),
                                rd.radon_dense_adj_plain(a, y))
    for key, (fn, ref) in fns.items():
        err, r = cs.rel_err(fn(), ref)
        if r > tol:
            raise AssertionError(f"{key}: rel err {r:.3e}")
    out = {}
    for kind in ("fwd", "adj"):
        out.update(in_turns({k: f for k, (f, _) in fns.items()
                             if k.startswith(kind)}))
    cs.log("grids (warm): " + ", ".join(
        f"{k} {r['ms']:.4f} ms" for k, r in out.items()))
    return out


def fit_profile(cs, steps: int) -> dict:
    """Device time per step of each dense kernel and of the whole step in
    ``steps`` profiled steps of path B's fit."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import mfvi_dip_mia_tpu_torch.tasks.problems as P
    from mfvi_dip_mia_tpu_torch.tasks.trainer import Method, fit

    problem = P.build_problem("ct", "mfvi", 0, input_depth=16, device="cuda",
                              radon_mode="dense-bf16")
    method = Method("mfvi", temp=2.2e-10, sigma=1.7e-7)
    kw = dict(lr=1e-3, seed=1, metrics_every=10, compute_dtype="bf16",
              collect_snapshots=False)
    fit(problem, method, num_iter=9, show_every=10, **kw)        # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fit(problem, method, num_iter=steps - 1, show_every=steps, **kw)
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA]
    dense = {ev.key: ev.self_device_time_total / 1e3 / steps
             for ev in evs if "radon_dense" in ev.key}
    out = dict(steps=steps,
               device_ms_per_step=sum(ev.self_device_time_total
                                      for ev in evs) / 1e3 / steps,
               kernels_per_step=sum(ev.count for ev in evs) / steps,
               dense_ms_per_step=dense)
    cs.log(f"path B fit, {steps} profiled steps: {out['kernels_per_step']:.0f}"
           f" kernels, {out['device_ms_per_step']:.4f} device ms per step; "
           + ", ".join(f"{k[:60]} {ms:.4f}" for k, ms in dense.items()))
    return out


def one(args) -> dict:
    if args.port_root:
        sys.path.insert(0, os.path.abspath(args.port_root))
    else:
        sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    cs = smoke()
    import mfvi_dip_mia_tpu_torch
    port = os.path.dirname(os.path.dirname(mfvi_dip_mia_tpu_torch.__file__))
    card = cs.nvidia_smi_line()
    cs.log(f"port {port}; {card}")
    out = dict(port=port, card=card, torch=torch.__version__)
    out["pair"] = time_pair(cs, args.grids)
    if args.fit_steps:
        out["fit"] = fit_profile(cs, args.fit_steps)
    return out


def compare(args) -> dict:
    """Parent, this, this, parent, each in its own process."""
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, root) in enumerate((("parent", args.parent),
                                           ("this", None), ("this", None),
                                           ("parent", args.parent))):
            path = os.path.join(tmp, f"{i}.json")
            cmd = [sys.executable, os.path.abspath(__file__), "--out", path,
                   "--fit-steps", str(args.fit_steps)]
            if root:
                cmd += ["--port-root", root]
            elif i == 1:
                cmd += ["--grids"]
            print(f"== {label} ({' '.join(cmd[2:])})", flush=True)
            subprocess.run(cmd, check=True, cwd=HERE)
            with open(path) as f:
                runs.append(dict(label=label, **json.load(f)))
    return dict(runs=runs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the result here")
    ap.add_argument("--fit-steps", type=int, default=0,
                    help="profile this many steps of path B's fit")
    ap.add_argument("--grids", action="store_true",
                    help="also time one and two blocks per SM")
    ap.add_argument("--port-root", default=None,
                    help="import the port from this directory")
    ap.add_argument("--parent", default=None,
                    help="compare the port under this directory with this "
                    "checkout's (parent, this, this, parent)")
    args = ap.parse_args(argv)
    out = compare(args) if args.parent else one(args)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
