"""The benchmark of mfvi_dip_mia_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. With ``--trace 0`` the result reports the cell's end-to-end metrics,
with ``--trace 1`` its per-layer ones (``BENCHMARK.json``). The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (with ``--trace 1`` also ``busy_s`` / ``window_s``
and a ``breakdown``), then ``compared``, each number of the correctness
check beside its limit, which also end standard error. Earlier lines give
the set-up's parts, the traced stretch's cross-checks and the reference's
other readings. Without the cards the cell asks for, or with the port
missing, it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "mfvi_dip_mia_tpu")
# the program's and PyTorch's build and kernel caches, inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}
# the device functions of the port's hand-written kernels (csrc/*.cu)
PORT_KERNELS = re.compile(
    r"conv_fwd_mma_kernel|conv_dw_mma_kernel|radon_fwd|radon_adj"
    r"|fused_fwd_mma_kernel|fused_bwd_dc_cluster_kernel"
    r"|fused_bwd_dw_mma_kernel|fused_bwd_dx_mma_kernel"
    r"|lrt_conv_fwd_mma_kernel|radon_dense")


# set-up parts timed before the harness runs the cell (the setup line)
PARTS = {}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's own name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # a crash prints each thread's Python stack on standard error
    faulthandler.enable()

    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(ROOT, "build", "portbench", sub)
    sys.path.insert(0, ROOT)
    from portbench import spec
    cell = spec.load_cell(ROOT, args.workload)

    t = time.perf_counter()
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " available")
        return 2
    PARTS["torch_s"] = time.perf_counter() - t
    out = measure(cell, args, "cuda")
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: the benchmark runs the port alone")
        return 3
    rc = emit(out)
    if args.trace:
        # the result is out: skip the interpreter's teardown, in which a
        # traced run has crashed after its result (the profiler's CUDA
        # tracing library is the suspect; no untraced run has)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
    return rc


def measure(cell, args, device: str) -> dict:
    """The run, its metrics and its correctness check (``device`` 'cpu' runs
    the port's plain path: the tests)."""
    import torch
    from portbench import check, harness, spec

    run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           T_START, device)
    rates = run.rates()
    metrics = {}
    for m in cell.metrics(bool(args.trace)):
        value = spec.reader(m["name"], cell.bench_dir)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                 if device != "cpu" else 0)}
    lines = {"setup": setup_line(run), "card": harness.power_limit()
             if device != "cpu" else "cpu"}
    breakdown = None
    if run.trace is not None:
        dev["busy_s"], dev["window_s"] = run.trace.busy_s, \
            run.trace.window_s
        breakdown = {"device_ops": run.trace.device_ops(),
                     "idle_gaps": run.trace.idle_gaps()}
        lines["stretch"] = stretch_line(run)
    lines["rates_it_s"] = rates
    lines["chunk_s"] = chunk_line(run)

    sound = [c for c in run.candidates
             if c.error is None and c.flat3 is not None]
    side = [check.program_side(c) for c in sound]
    cands = [(c.temp, c.sigma) for c in sound]
    failed = sum(c.nonfinite_chunks + (c.error is not None)
                 for c in run.candidates)
    attempted = sum(len(c.chunks) for c in run.candidates)
    for c in run.candidates:
        if c.error:
            log(f"candidate {c.index} failed:\n{c.error}")
        c.prep = None
    del run
    gc.collect()
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    per_cand = [check.readings(p, check.reference_side(
        cell, t, s, args.seed, device)) for p, (t, s) in zip(side, cands)]
    lines["reference_s"] = time.perf_counter() - t_ref
    numbers = check.worst(per_cand) if per_cand else {}
    correct, compared = check.judge(numbers, cell.config["limits"])
    correct = correct and len(sound) == len(cands) and failed == 0 \
        and len(side) > 0 and bool(metrics)
    lines["readings"] = numbers
    return {"lines": lines, "correct": correct, "attempted": attempted,
            "failed": failed, "metrics": metrics, "device": dev,
            "breakdown": breakdown, "compared": compared}


def setup_line(run) -> dict:
    """The set-up's parts, in seconds, and the peak memory at the window's
    opening."""
    import torch
    s = dict(PARTS, **run.setup)
    cs = run.candidates
    if all(c.t_call for c in cs):
        s["before_trainer_s"] = min(c.t_call for c in cs) - run.t_start
    s["prepare_s"] = [c.t_prepared - c.t_call for c in cs if c.t_prepared]
    s["warmup_capture_s"] = [c.t_capture[1] - c.t_capture[0] for c in cs
                             if c.t_capture]
    s["first_chunk_after_capture_s"] = [
        c.first_chunk_end - c.t_capture[1] for c in cs
        if c.t_capture and c.first_chunk_end]
    if run.window.w0 is not None:
        s["setup_s"] = run.window.w0 - run.t_start
    if torch.cuda.is_available():
        s["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    return s


def chunk_line(run) -> list:
    """Each candidate's whole chunks in the window, in order: [chunk ms,
    ms the host spent inside the chunk's graph replays], to tell a steady
    run from one whose pace changed, and a device-bound chunk from one
    held up by the host's launches."""
    w = run.window
    if w.w0 is None:
        return []
    return [[[round(1e3 * d, 3), round(1e3 * r, 3)]
             for d, r in c.chunks_in(w.w0, w.w1)] for c in run.candidates]


def stretch_line(run) -> dict:
    """The traced stretch beside the launch counters: the port's kernels a
    replay by the profiler and by the counters, and the stretch's pace
    (set it beside an untraced run's ``cand_it_s`` for the profiler's
    cost)."""
    import statistics
    tr, st = run.trace, run.stretch
    c0 = run.candidates[0]
    launches = sum(c0.launches) if c0.launches else None
    groups = {}
    for o in tr.kernels():
        if o.corr and PORT_KERNELS.search(o.name):
            groups[o.corr] = groups.get(o.corr, 0) + 1
    port_per_replay = (statistics.mode(groups.values()) if groups
                       else None)
    counted = [b - a for a, b in zip(st["counts0"], st["counts1"])]
    replays = tr.replays()
    return {"window_s": tr.window_s, "busy_s": tr.busy_s,
            "replays": replays, "graph_launches": tr.graph_launches,
            "kernels_per_replay": tr.kernels_per_replay(),
            "stretch_idle_pct": (100.0 * (1.0 - tr.busy_s / tr.window_s)
                                 if tr.window_s > 0 else None),
            "port_kernels_per_replay_profiler": port_per_replay,
            "port_kernels_per_replay_counters": launches,
            "port_launches_counted_in_stretch": sum(counted),
            "iterations_in_stretch_cand0": st["iters1"] - st["iters0"],
            "profiler_start_s": st["start_s"],
            "profiler_stop_s": st["stop_s"],
            "stretch_it_s": (replays / tr.window_s if replays else None)}


def emit(out: dict) -> int:
    for name, value in out["lines"].items():
        print(json.dumps({name: value}), flush=True)
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": out["device"]}
    if out["breakdown"] is not None:
        result["breakdown"] = out["breakdown"]
    result["compared"] = out["compared"]
    for name, c in out["compared"].items():
        log(f"compared {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
