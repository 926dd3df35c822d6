"""Config loading (counterpart of mfvi_dip_mia_tpu/utils/config.py): the
reference's JSON schema, read with plain ``json`` so the existing
``configs/*.json`` load unchanged.

  {
    "bo_params": {<param>: {"logbounds": [lo, hi], "candidates": [...]}, ...},
    "run_params": {"img", "num_iter", "lr", "seed", "p_sigma", "input_depth",
                   "show_every", "plot", "save", "devices", "save_path",
                   "bo_results_path", ...}
  }
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List


@dataclasses.dataclass
class BOParam:
    logbounds: List[float]
    candidates: List[float]


@dataclasses.dataclass
class Config:
    bo_params: Dict[str, BOParam]
    run_params: Dict[str, Any]


def load_config(path: str) -> Config:
    with open(path) as f:
        raw = json.load(f)
    bo_params = {
        name: BOParam(logbounds=list(spec["logbounds"]),
                      candidates=list(spec["candidates"]))
        for name, spec in raw.get("bo_params", {}).items()
    }
    return Config(bo_params=bo_params,
                  run_params=dict(raw.get("run_params", {})))


def dump_locals(path: str, values: Dict[str, Any]) -> None:
    """locals.txt: one ``key = value`` line per entry."""
    with open(path, "w") as f:
        for key, val in values.items():
            print(key, "=", val, file=f)
