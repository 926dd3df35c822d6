"""The readings the correctness limits are set from, on the card, in one
process per cell (PERF.md gives the readings and the limits set from them):

  * the program: the cell's timed path from each seed, its first three
    steps against the reference (as a run compares them);
  * the control: the reference itself in the program's place, its convs at
    the configuration's ``control`` precision (one step below the stated
    one), against the reference;
  * the faults planted in the program: its data loss over half the image
    ('half'), its state left unchanged by the step ('frozen'), its
    parameters alone left unchanged ('params'), its update doubled ('lr2')
    or of the wrong sign ('sign'), its metric rows altered where the step
    writes them ('rows').

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \\
        --control-seeds 3 --fault-seeds 3 --out calib.json
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIRST_SEED = 2 ** 31 + 1000


@contextlib.contextmanager
def fault(name: str, port: dict):
    """The program with fault ``name`` planted, for the block."""
    trainer, problems = port["tasks.trainer"], port["tasks.problems"]
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "half":
        loss = problems.Problem.data_loss

        def half_loss(self, out):
            # the loss over the top half of the image (ct: of the angles)
            if self.task == "ct":
                full = self.operator(out)
                t = full.shape[2] // 2
                return ((full[:, :, :t] - self.target[:, :, :t]) ** 2).mean()
            h = out.shape[2] // 2
            return loss(_Rows(self, h), out[:, :, :h])

        patch(problems.Problem, "data_loss", half_loss)
    elif name == "frozen":
        patch(trainer, "flat_adamw_update",
              lambda p, g, m, v, count, **kw: (p, m, v, count))
    elif name in UPDATE_FAULTS:
        patch(trainer, "flat_adamw_update",
              _update_fault(trainer.flat_adamw_update, UPDATE_FAULTS[name]))
    elif name == "rows":
        metrics = problems.Problem.metrics

        def rows(self, out_t, out_avg):
            # a 20 % wrong answer: ct's bf16 rows lie up to 1.2 % from the
            # float32 reference's, so a smaller one hides in them
            return metrics(self, out_t, out_avg) * 1.2

        patch(problems.Problem, "metrics", rows)
    elif name != "none":
        raise ValueError(name)
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


# the update's faults: the parameters' new value from the old one and the
# update the optimizer made, its moments and count kept as it made them
UPDATE_FAULTS = {
    "params": lambda p, d: p,          # the parameters left unchanged
    "lr2": lambda p, d: p + 2 * d,     # twice the learning rate
    "sign": lambda p, d: p - d,        # the update's sign flipped
}


def _update_fault(update, wrong):
    def faulty(p, g, m, v, count, **kw):
        new, m, v, count = update(p, g, m, v, count, **kw)
        return wrong(p, new - p), m, v, count
    return faulty


class _Rows:
    """A den problem whose target is cut to its top ``h`` rows."""

    def __init__(self, problem, h):
        self._p, self.target = problem, problem.target[:, :, :h]

    def __getattr__(self, name):
        return getattr(self._p, name)


def program_readings(cell, seed, port, setup, device) -> list:
    from portbench import check, harness
    run = harness.run_cell(cell, seed, 0.0, False, T_START, device,
                           port=port, setup=setup)
    out = []
    for c in run.candidates:
        if c.error or c.flat3 is None:
            out.append({"error": c.error or "no probe"})
            continue
        side = check.program_side(c)
        c.prep = None
        t = time.perf_counter()
        ref = check.reference_side(cell, c.temp, c.sigma, seed, device)
        r = check.readings(side, ref)
        r["reference_s"] = time.perf_counter() - t
        r["detail"] = check.worst_leaves(side, ref)
        out.append(r)
    return out


def control_readings(cell, seed, device) -> list:
    from portbench import check
    rounding = cell.config["control"]
    out = []
    for temp, sigma in cell.traffic().candidates(cell):
        low = check.reference_side(cell, temp, sigma, seed, device, rounding)
        ref = check.reference_side(cell, temp, sigma, seed, device)
        r = check.readings(low, ref)
        r["detail"] = check.worst_leaves(low, ref)
        out.append(r)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--faults", default="half,frozen,params,lr2,sign,rows")
    ap.add_argument("--first-seed", type=int, default=FIRST_SEED)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from portbench import harness, spec
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(ROOT, args.workload)
    port, setup = harness.import_port("cuda")
    res = {"cell": cell.name, "card": harness.power_limit(),
           "program": {}, "control": {}, "faults": {}}
    seeds = [args.first_seed + i for i in range(args.seeds)]
    for s in seeds:
        t = time.perf_counter()
        res["program"][s] = program_readings(cell, s, port, setup, "cuda")
        print(f"program seed {s} {time.perf_counter() - t:.1f}s "
              f"{res['program'][s]}", flush=True)
    for s in seeds[:args.control_seeds]:
        res["control"][s] = control_readings(cell, s, "cuda")
        print(f"control seed {s} {res['control'][s]}", flush=True)
    for name in [f for f in args.faults.split(",") if f]:
        res["faults"][name] = {}
        for s in seeds[:args.fault_seeds]:
            with fault(name, port):
                res["faults"][name][s] = program_readings(cell, s, port,
                                                          setup, "cuda")
            print(f"fault {name} seed {s} {res['faults'][name][s]}",
                  flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
