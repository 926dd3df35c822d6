"""Fixed-candidate evaluation CLI (counterpart of
mfvi_dip_mia_tpu/eval_cli.py, the reference's ``python eval_result.py``):
runs the configured candidates once on the card (no GP) and prints the
(candidate, psnr) table; the paper-reproduction path of configs/test_*.json.

    python -m mfvi_dip_mia_tpu_torch.eval_cli --task ct --bayes mfvi \
        --config configs/test_mfvi_ct.json
"""

from __future__ import annotations

import argparse

from .bo.loop import evaluate_candidates
from .utils.config import load_config


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--task", type=str, default="denoising")
    parser.add_argument("--bayes", type=str, default="mfvi")
    parser.add_argument("--config", type=str,
                        default="./configs/test_mfvi_den.json")
    parser.add_argument("--num-iter", type=int, default=None,
                        help="override run_params.num_iter (smoke runs)")
    parser.add_argument("--metrics-every", type=int, default=None)
    parser.add_argument("--no-save", action="store_true")
    args = parser.parse_args(argv)

    config = load_config(args.config)
    bo_params = {k: {"logbounds": v.logbounds, "candidates": v.candidates}
                 for k, v in config.bo_params.items()}
    run_params = dict(config.run_params)
    if args.num_iter is not None:
        run_params["num_iter"] = args.num_iter
    if args.metrics_every is not None:
        run_params["metrics_every"] = args.metrics_every
    if args.no_save:
        run_params["save"] = False
        run_params["plot"] = False
    return evaluate_candidates(args.task, args.bayes, bo_params, run_params)


if __name__ == "__main__":
    main()
