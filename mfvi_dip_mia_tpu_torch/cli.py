"""BO sweep CLI (counterpart of mfvi_dip_mia_tpu/cli.py, the reference's
``python bayesian_optimization.py``), on the card:

    python -m mfvi_dip_mia_tpu_torch.cli --task ct --bayes mfvi \
        --config configs/bo_mfvi_ct.json --num-iter 200 --rounds 2 --no-plot

``--no-plot`` turns off the sweep's figures; the runners plot as the
config's ``run_params.plot`` says. To split each round's candidates over N
processes (on one card or several), start the same command N times with
``--dist-coordinator host:port --dist-nproc N --dist-pid i`` (i = 0 .. N-1):
each joins one ``torch.distributed`` gloo group (parallel/multihost.py),
and rank 0 writes the sweep's files.
"""

from __future__ import annotations

import argparse

from .bo.loop import bo
from .utils.config import load_config


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--task", type=str, default="denoising")
    parser.add_argument("--bayes", type=str, default="mfvi")
    parser.add_argument("--config", type=str,
                        default="./configs/bo_den.json")
    parser.add_argument("--rounds", type=int, default=20)
    parser.add_argument("--resume", action="store_true",
                        help="resume from the last *_fig_data.npz round")
    parser.add_argument("--no-plot", action="store_true")
    parser.add_argument("--num-iter", type=int, default=None,
                        help="override run_params.num_iter (smoke runs)")
    parser.add_argument("--metrics-every", type=int, default=None)
    parser.add_argument("--screen-iters", type=int, default=None,
                        help="run BO rounds at this reduced fit budget and "
                             "confirm the winner with one full-budget fit")
    parser.add_argument("--dist-coordinator", type=str, default=None,
                        help="host:port of rank 0: start the same command in "
                             "every process to split each round's "
                             "candidates over them (parallel/multihost.py)")
    parser.add_argument("--dist-nproc", type=int, default=None)
    parser.add_argument("--dist-pid", type=int, default=None)
    args = parser.parse_args(argv)

    config = load_config(args.config)
    bo_params = {k: {"logbounds": v.logbounds, "candidates": v.candidates}
                 for k, v in config.bo_params.items()}
    run_params = dict(config.run_params)
    if args.num_iter is not None:
        run_params["num_iter"] = args.num_iter
    if args.metrics_every is not None:
        run_params["metrics_every"] = args.metrics_every
    sweep = dict(task=args.task, bayes=args.bayes, bo_params=bo_params,
                 run_params=run_params, n_rounds=args.rounds,
                 plot=not args.no_plot, resume=args.resume,
                 screen_iters=args.screen_iters)
    if args.dist_coordinator is None:
        return bo(**sweep)
    import torch.distributed as dist
    dist.init_process_group("gloo",
                            init_method=f"tcp://{args.dist_coordinator}",
                            world_size=args.dist_nproc, rank=args.dist_pid)
    try:
        return bo(**sweep)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
