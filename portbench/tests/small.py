"""Small cells for the CPU tests: the configurations' nets cut to 2 scales
at 32 x 32, with the program patched to the same size."""

from __future__ import annotations

import copy
import json
import os

from portbench import spec
from portbench.reference import data

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SIZE = 32


def cut(cfg: dict) -> dict:
    """A copy of configuration ``cfg`` cut to ``SIZE``."""
    cfg = copy.deepcopy(cfg)
    cfg["imsize"] = SIZE
    cfg["net"].update(skip_n33d=[16, 32], skip_n33u=[16, 32], num_scales=2)
    return cfg


def small_config(name: str) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return cut(json.load(f))


def small_cell(name: str) -> spec.Cell:
    """Cell ``name`` with its configuration cut to ``SIZE``."""
    cell = spec.load_cell(ROOT, name)
    cell.config = small_config(cell.entry["config"])
    return cell


def patch_port(monkeypatch, cfg: dict) -> None:
    """The program's problems at the small configuration's size."""
    import mfvi_dip_mia_tpu_torch.tasks.data as D
    import mfvi_dip_mia_tpu_torch.tasks.problems as P

    n = cfg["net"]

    def net(n_channels, method, dropout_p, input_depth=16):
        return P.build_skip_net(
            input_depth, n_channels=n_channels, pad="reflection",
            skip_n33d=n["skip_n33d"], skip_n33u=n["skip_n33u"],
            skip_n11=n["skip_n11"], num_scales=n["num_scales"],
            upsample_mode="bilinear")

    monkeypatch.setattr(P, "_standard_net", net)
    monkeypatch.setattr(D, "get_img_ct",
                        lambda img: (data.ct_image(SIZE), (SIZE, SIZE)))
    monkeypatch.setattr(D, "get_image_denoising",
                        lambda img: (data.xray_image(SIZE, img),
                                     (SIZE, SIZE)))
