"""The spatial ('sp') split of one fit: every image-sized activation of the
skip net cut into contiguous row blocks, one per entry of a mesh's ``sp``
axis (the counterpart of what GSPMD inserts for the JAX package's
parallel/sharding.py::sp_shardings; no JAX module mirrors this one).

A split activation is a list of (N, C, h_i, W) tensors, shard i on
``RowSplit.devices[i]``, holding the rows [b_i, b_{i+1}) of the whole. The
level-0 bounds split the image height H evenly in mesh order, and level l
(l halvings deep in the U-Net) uses the level-0 bounds divided by 2^l, so
a net of n scales needs every bound to be a multiple of 2^n
(``RowSplit.of`` raises otherwise).

* ``halo_slab``: each shard's rows plus ``r_top`` / ``r_bottom`` halo rows
  gathered from whichever shards hold them (one or several neighbours);
  rows past the image's edges reflected or zero, as the conv site's pad
  mode says; then the columns padded as the unsplit site pads them. The
  VALID kernels run on the slab unchanged.
* ``batch_norm_train_sp``: train-mode BatchNorm with the moments of the
  whole activation: the shift from the global first 8 rows, the per-shard
  sums of x - c and (x - c)^2 added on the first device, the mean and
  variance sent back to every shard.
* ``upsample2x_sp`` and ``rows_by_matrix``: a row-matrix resize (bilinear
  x2, the Lanczos pool) as the shard's band of the unsplit matrix on its
  rows plus halo; nearest x2 needs no halo.
* ``slice_rows`` / ``gather_rows``: a full-size tensor cut into the
  shards' rows, and the shards joined back in row order on one device.
  Every random draw of a split forward is made once at full size, as the
  unsplit forward makes it, and then sliced, so the fit's generator gives
  the same stream draw for draw.

Every gather is ``narrow`` / ``flip`` / ``cat`` (and ``.to``), whose
adjoints are slices, flips and zero-padded copies summed by autograd in a
fixed order: no ``index_select``, ``index_add_`` or scatter, so a split
step is as reproducible as the unsplit one. Each function has a plain
single-device meaning (the unsplit op on the gathered whole), which
tests/test_torch_sp.py holds it to.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import layers


def _concrete(device) -> torch.device:
    """``device`` with its card's ordinal ("cuda" is the current card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """The shards' devices, in mesh order, and the level-0 row bounds
    (n + 1 of them, from 0 to H)."""
    devices: tuple
    bounds0: tuple

    @staticmethod
    def check(height: int, n_sp: int, n_scales: int) -> int:
        """The rows a shard of a height-row image holds at level 0; raises
        ValueError unless they are a whole multiple of 2^n_scales."""
        if n_sp < 1 or height % n_sp:
            raise ValueError(f"a split over {n_sp} shards does not divide "
                             f"the image height {height}")
        rows = height // n_sp
        if rows % (1 << n_scales):
            raise ValueError(
                f"a split of {height} rows over {n_sp} shards gives {rows} "
                f"rows a shard; a net of {n_scales} scales halves them "
                f"{n_scales} times and needs a multiple of {1 << n_scales} "
                f"(at most {height // (1 << n_scales)} shards)")
        return rows

    @classmethod
    def of(cls, devices, height: int, n_scales: int) -> "RowSplit":
        """An even split of ``height`` rows over ``devices`` (one shard
        each, in order; a device may appear several times)."""
        devices = tuple(_concrete(d) for d in devices)
        rows = cls.check(height, len(devices), n_scales)
        return cls(devices, tuple(i * rows for i in range(len(devices) + 1)))

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    @property
    def spans_devices(self) -> bool:
        """Whether the shards lie on more than one device."""
        return len(set(self.devices)) > 1

    def at(self, level: int) -> tuple:
        """The row bounds at ``level`` (the level-0 bounds / 2^level)."""
        return tuple(b >> level for b in self.bounds0)


def slice_rows(x: torch.Tensor, bounds, devices) -> list:
    """The shards of a full-size (N, C, H, W) ``x``: rows [b_i, b_{i+1}) on
    ``devices[i]``."""
    return [x.narrow(2, lo, hi - lo).to(dev)
            for lo, hi, dev in zip(bounds[:-1], bounds[1:], devices)]


def split_rows(x: torch.Tensor, split: RowSplit, level: int = 0) -> list:
    """``x`` at ``level``'s resolution cut into ``split``'s shards."""
    return slice_rows(x, split.at(level), split.devices)


def gather_rows(shards, device) -> torch.Tensor:
    """The shards joined in row order on ``device``: the unsplit tensor."""
    return torch.cat([s.to(device) for s in shards], dim=2)


def _source_rows(lo: int, hi: int, height: int, pad_mode: str) -> list:
    """For the rows [lo, hi) of the image padded at its top and bottom
    edges, the image row each one reads (None: a zero row)."""
    rows = []
    for j in range(lo, hi):
        if 0 <= j < height:
            rows.append(j)
        elif pad_mode == "reflection":
            src = -j if j < 0 else 2 * (height - 1) - j
            if not 0 <= src < height:
                raise ValueError(f"a reflection pad of {max(-lo, hi - height)}"
                                 f" rows needs an image of more rows than "
                                 f"{height}")
            rows.append(src)
        else:
            rows.append(None)
    return rows


def _runs(rows, bounds) -> list:
    """``rows`` as maximal runs (shard, first local row, count, reversed):
    rows of one shard in steps of +1 (or -1, reversed: the first local row
    is then the run's lowest); shard None for a run of zero rows."""
    runs = []                         # [shard, local row, count, step]
    for r in rows:
        if r is None:
            if runs and runs[-1][0] is None:
                runs[-1][2] += 1
            else:
                runs.append([None, 0, 1, 0])
            continue
        i = next(k for k in range(len(bounds) - 1)
                 if bounds[k] <= r < bounds[k + 1])
        local = r - bounds[i]
        if runs and runs[-1][0] == i:
            last = runs[-1]
            step = local - (last[1] + (last[2] - 1) * last[3])
            if step in (1, -1) and last[3] in (0, step):
                last[2] += 1
                last[3] = step
                continue
        runs.append([i, local, 1, 0])
    return [(i, local - count + 1 if step == -1 else local, count,
             step == -1) for i, local, count, step in runs]


def take_rows(shards, bounds, rows, device) -> torch.Tensor:
    """The image rows ``rows`` (indices into the whole, None for a zero
    row), stacked in that order on ``device`` from the shards that hold
    them: one ``narrow`` per run of rows, flipped where the run descends,
    one ``cat`` (none for a single run, whose view on ``device`` is
    returned)."""
    pieces = []
    ref = shards[0]
    for i, start, count, reverse in _runs(rows, bounds):
        if i is None:
            pieces.append(ref.new_zeros(
                (ref.shape[0], ref.shape[1], count, ref.shape[3]),
                device=device))
            continue
        piece = shards[i].narrow(2, start, count)
        pieces.append((piece.flip(2) if reverse else piece).to(device))
    if len(pieces) == 1:
        return pieces[0]
    return torch.cat(pieces, dim=2)


def pad_cols(x: torch.Tensor, p: int, pad_mode: str) -> torch.Tensor:
    """``x`` padded by p columns on both sides: reflected
    (ReflectionPad2d's columns, as narrow / flip / cat) or zeros."""
    if p == 0:
        return x
    if pad_mode != "reflection":
        return F.pad(x, (p, p))
    w = x.shape[3]
    if p >= w:
        raise ValueError(f"a reflection pad of {p} columns needs more than "
                         f"{w} columns")
    return torch.cat([x.narrow(3, 1, p).flip(3), x,
                      x.narrow(3, w - 1 - p, p).flip(3)], dim=3)


def halo_slab(shards, bounds, r_top: int, r_bottom: int, pad_mode: str,
              cols: int = 0) -> list:
    """Per shard i, the rows [b_i - r_top, b_{i+1} + r_bottom) of the image
    (row-padded at its edges by ``pad_mode``, 'reflection' or zeros),
    gathered onto shard i's device from whichever shards hold them, then
    ``cols`` columns padded on both sides: the slab a VALID conv of the
    padded image reads for shard i's output rows. ``r_bottom`` may be
    negative (a stride-2 site reads fewer rows)."""
    height = bounds[-1]
    slabs = []
    for i, s in enumerate(shards):
        rows = _source_rows(bounds[i] - r_top, bounds[i + 1] + r_bottom,
                            height, pad_mode)
        slabs.append(pad_cols(take_rows(shards, bounds, rows, s.device),
                              cols, pad_mode))
    return slabs


def batch_norm_train_sp(shards, bounds, scale: torch.Tensor,
                        offset: torch.Tensor, eps: float = 1e-5) -> list:
    """``layers.batch_norm_train`` of the whole activation, shard by shard:
    the shift c from the global first 8 rows (gathered onto the first
    shard's device), each shard's sums of x - c and (x - c)^2 (f32), added
    on the first device by one reduction over the shard axis, then the
    mean and variance (hence the multiply-add) sent back to each shard."""
    first = shards[0].device
    n, _, _, w = shards[0].shape
    top = take_rows(shards, bounds, range(min(8, bounds[-1])), first)
    c = top.float().mean(dim=(0, 2, 3), keepdim=True).detach()
    sums, squares = [], []
    for s in shards:
        xc = s.float() - c.to(s.device)
        sums.append(xc.sum(dim=(0, 2, 3), keepdim=True).to(first))
        squares.append((xc * xc).sum(dim=(0, 2, 3), keepdim=True).to(first))
    count = n * bounds[-1] * w
    mean_c = torch.cat(sums).sum(dim=0, keepdim=True) / count
    ex2 = torch.cat(squares).sum(dim=0, keepdim=True) / count
    var = torch.clamp(ex2 - mean_c * mean_c, min=0.0)
    mean = c + mean_c
    inv = torch.rsqrt(var + eps)
    sc = scale[None, :, None, None].float()
    dtype = shards[0].dtype
    a = (inv * sc).to(dtype)
    b = (offset[None, :, None, None].float() - mean * inv * sc).to(dtype)
    return [s * a.to(s.device) + b.to(s.device) for s in shards]


def rows_by_matrix(shards, bounds_in, bounds_out, band, mw) -> list:
    """A separable resize of a split activation: per output shard, its
    band of the (OH, H) row matrix, ``band(r0, r1, device) -> (rows
    (r1 - r0, c1 - c0), c0, c1)``, on the input rows [c0, c1) gathered onto
    its device, then the (OW, W) column matrix ``mw``
    (``layers.apply_matrices``)."""
    out = []
    for i, s in enumerate(shards):
        mh, c0, c1 = band(bounds_out[i], bounds_out[i + 1], s.device)
        slab = take_rows(shards, bounds_in, range(c0, c1), s.device)
        out.append(layers.apply_matrices(slab, mh, mw.to(s.device)))
    return out


def upsample2x_sp(shards, bounds_in, mode: str) -> list:
    """``layers.upsample2x`` of a split activation whose shards hold the
    rows ``bounds_in``: the output shards hold twice those rows. Nearest
    copies each shard's rows; bilinear reads one halo row on each side
    through the shard's band of the row matrix."""
    if mode == "nearest":
        return [layers.resize_nearest(s, 2.0) for s in shards]
    if mode != "bilinear":
        raise ValueError(f"unknown upsample mode {mode!r}")
    h, w = bounds_in[-1], shards[0].shape[3]
    dtype = shards[0].dtype
    mw = layers._matrix_on("bilinear", w, 2 * w, 2.0, str(shards[0].device),
                          dtype)
    return rows_by_matrix(
        shards, bounds_in, tuple(2 * b for b in bounds_in),
        lambda r0, r1, dev: layers.band_on("bilinear", h, 2 * h, 2.0, r0, r1,
                                           str(dev), dtype), mw)


def dropout_sp(shards, bounds, p: float, generator: torch.Generator,
               channels: bool) -> list:
    """``layers.dropout`` (``channels``: ``dropout2d``) of a split
    activation: one keep mask drawn at the whole's shape, as the unsplit
    forward draws it, then sliced to each shard's rows (a channel mask is
    every shard's)."""
    n, c, _, w = shards[0].shape
    shape = (n, c, 1, 1) if channels else (n, c, bounds[-1], w)
    keep = layers.dropout_keep(shape, 1.0 - p, generator)
    keeps = ([keep.to(s.device) for s in shards] if channels
             else slice_rows(keep, bounds, [s.device for s in shards]))
    return [torch.where(k, s / (1.0 - p), 0.0) for k, s in zip(keeps, shards)]
