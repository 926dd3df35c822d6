"""Operations and bytes of the CT operator per pass, read from the plain
reference's own discretised operator (portbench/reference/radon.py): two
operations (a multiply and an add) per nonzero weight of A, and the image in
and the sinogram out once each, in float32 (the loss takes both in float32).
The stored band or matrix a kernel streams is not counted, so the share is
the same whatever implements the operator."""

from __future__ import annotations

import functools

from ..reference import radon as R
from . import peaks


@functools.lru_cache(maxsize=None)
def nnz(theta: tuple, size: int) -> int:
    import numpy as np
    return R.projection_matrix(np.asarray(theta), size)._nnz()


def pass_work(cfg: dict) -> tuple:
    """(operations, bytes) of one pass, forward or adjoint."""
    theta = tuple(float(t) for t in R.theta_deg(cfg))
    size = int(cfg["imsize"])
    return 2.0 * nnz(theta, size), 4.0 * (size * size + len(theta) * size)


def least_seconds_per_iteration(cfg: dict) -> float:
    """The forward and the adjoint, one each per iteration."""
    flops, nbytes = pass_work(cfg)
    return 2 * peaks.least_seconds(flops, nbytes, cfg["compute_dtype"])


def flops_per_iteration(cfg: dict) -> float:
    return 2 * pass_work(cfg)[0]
