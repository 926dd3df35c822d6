"""The inp cell for the CPU tests, cut to 3 scales [16, 32, 64] at 64 x 64
(the smallest size whose deepest k5 reflection pads fit), with the
program patched to the same size; and inp's own ``half`` fault, which
cuts the mask with the target (calibrate.py's ``half`` cuts the target
alone, which inp's masked loss refuses by its shapes, not by a number);
and ``LR11``, an update a tenth too large, the smallest fault of the
update's scale the limits are set to catch."""

from __future__ import annotations

import contextlib
import copy

from portbench import spec
from portbench.tests import small

NAME = "inp_mfvi_f32_256.fit"
WIDTHS = [16, 32, 64]
SIZE = 64
# calibrate.py's update faults take the parameters and the update made
LR11 = ("lr11", lambda p, d: p + 1.1 * d)


def cut(cfg: dict) -> dict:
    """A copy of the inp configuration ``cfg`` cut to ``SIZE``, with chunks
    of 5 iterations (the probe reads the first three steps)."""
    cfg = copy.deepcopy(cfg)
    cfg.update(imsize=SIZE, num_iter=20, chunk_iters=5)
    cfg["net"].update(skip_n33d=WIDTHS, skip_n33u=WIDTHS,
                      skip_n11=[0] * len(WIDTHS), num_scales=len(WIDTHS))
    return cfg


def small_cell() -> spec.Cell:
    cell = spec.load_cell(small.ROOT, NAME)
    cell.config = cut(cell.config)
    return cell


def patch_port(monkeypatch) -> None:
    """The program's inp problem at ``SIZE`` on the cut net: its
    ``SkipNet`` with the cut widths, its image and mask at ``SIZE``."""
    import mfvi_dip_mia_tpu_torch.tasks.data as D
    import mfvi_dip_mia_tpu_torch.tasks.problems as P

    skip_net = P.SkipNet

    def net(**kw):
        kw.update(num_channels_down=WIDTHS, num_channels_up=WIDTHS,
                  num_channels_skip=[0] * len(WIDTHS))
        return skip_net(**kw)

    monkeypatch.setattr(P, "SkipNet", net)
    monkeypatch.setattr(D, "get_img_inpainting", lambda img: (
        *D.synthetic_hair(img, SIZE), (SIZE, SIZE)))


class _Top:
    """An inp problem whose target and mask are cut to their top ``h``
    rows."""

    def __init__(self, problem, h):
        self._p = problem
        self.target = problem.target[:, :, :h]
        self.mask = problem.mask[:, :, :h]

    def __getattr__(self, name):
        return getattr(self._p, name)


@contextlib.contextmanager
def half(port: dict):
    """The program with inp's ``half`` fault planted for the block: the
    data loss over the top half of the image, its target and its mask
    cut alike."""
    problem = port["tasks.problems"].Problem
    loss = problem.data_loss

    def half_loss(self, out):
        h = out.shape[2] // 2
        return loss(_Top(self, h), out[:, :, :h])

    problem.data_loss = half_loss
    try:
        yield
    finally:
        problem.data_loss = loss
