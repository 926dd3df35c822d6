"""The tensor-core weight gradient (csrc/conv_mma.cuh's dw tile, ``cf_conv_dw``)
and the fused block's tensor-core forward (``fused_block_fwd``), held on the
CPU before any card runs them.

(a) The dw plan (ops/kernels/cf_conv.py::dw_plan) at every conv site of
    chip_smoke.py's 5-scale 256^2 nets, bf16 and f32: every output channel,
    input channel and tap row lies in exactly one output tile, every pixel in
    one pixel tile and every pixel tile in one split; clusters hold at most 8
    blocks; a launch has at least min(132, the smallest tile's most) blocks.
(b) A numpy emulation of the kernel: the slab and the cotangent staged as the
    kernel stages them (zero outside both tensors), the B operand of tap
    (ky, kx) read at slab row (r + ky) * (16 + k - 1) + kx + j for pixel
    (r, j) of a tile, and the sums in the kernel's order (each warp's rows,
    the WK warps, the cluster's ranks, the groups of clusters), against the
    port's ``conv_dw_plain`` and JAX's ``dw_valid_cf`` (interpret mode) at
    k in {1, 2, 3, 5}, and at a stride-2 site on parity planes against the
    JAX conv's VJP.
(c) 3xTF32 over a 65,536-pixel reduction (the 256^2 sites) within 1e-5 of
    f64, where one TF32 pass is not.
(d) The fused forward's tile plan (no split of K) covers every output once
    at the 20 fused sites, and an emulation of its statistics order (per-tile
    channel sums, their fixed-order totals, per-chunk centred squares) in f32
    matches ``fwd_plain`` and the JAX fused block.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import chip_smoke
from mfvi_dip_mia_tpu.ops.pallas import cf_conv as jcf
from mfvi_dip_mia_tpu.ops.pallas import fused_block as jfb
from mfvi_dip_mia_tpu_torch.nn import build_skip_net
from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf
from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb
from torch_port_helpers import (assert_dw_covers, emulate_dw, matmul_3xtf32,
                                rel, tf32)

torch.set_num_threads(1)

TW = tcf.TILE_W


def _nets():
    return {n: build_skip_net(16, n_channels=n, pad="reflection",
                              skip_n33d=[16, 32, 64, 128, 128],
                              skip_n33u=[16, 32, 64, 128, 128], skip_n11=4,
                              num_scales=5, upsample_mode="bilinear")
            for n in (1, 2)}


# -- (a) the dw plan -----------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dw_plan_covers_every_site_once_and_fills_the_card(dtype):
    sites = [s for n_out in (1, 2) for s in chip_smoke.conv_sites(
        _nets()[n_out], 256)]
    extra = [dict(xp=x, w=w) for x, w in chip_smoke.EXTRA_CONV_SHAPES]
    for s in sites + extra:
        i, hp, wp = s["xp"]
        o, _, k, _ = s["w"]
        h, w = hp - k + 1, wp - k + 1
        p = tcf.dw_plan(h, w, o, i, dtype, k)
        assert_dw_covers(p, o, i, k, h, w)
        assert p.bo <= max(16, -(-o // 16) * 16)
        assert p.bc <= max(16, -(-i // 16) * 16)
        most = max(c.ctas for c in tcf.dw_candidates(h, w, o, i, k)
                   if c.tile == 0)
        assert p.ctas >= min(tcf.SMS, most), (s, p)


def test_dw_plan_splits_the_large_sites():
    """The 256^2 sites' few output tiles face 512 pixel tiles: the plan
    splits them across clusters and groups of clusters."""
    for dtype in (torch.float32, torch.bfloat16):
        p = tcf.dw_plan(256, 256, 16, 36, dtype, 3)       # levels.0.up
        assert p.split >= 8 and p.ctas >= tcf.SMS
        p = tcf.dw_plan(256, 256, 4, 16, dtype, 1)        # levels.0.skip
        assert p.groups > 1


# -- (b) the kernel's indexing and summation order -------------------------------

def _plans(h, w, o, i, k):
    """The plan dw_plan picks, and forced ones that run every tile, a
    cluster and groups of clusters."""
    picked = tcf.dw_plan(h, w, o, i, torch.float32, k)
    n_pt = picked.pixel_tiles
    forced = [(0, 1, 1), (0, 2, 1), (0, 8, 2)] if k == 5 else [
        (0, 1, 1), (1, 2, 1), (0, 4, 1), (1, 8, 2), (0, 8, 2)]
    return [picked] + [tcf._dw_plan(t, c, gr, h, w, o, i, k)
                       for t, c, gr in forced if c * gr <= n_pt]


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_emulated_dw_matches_the_plain_dw_and_jax(k):
    rng = np.random.default_rng(20 + k)
    i_ch, o_ch, h, w = 37, 21, 19, 90     # ragged in every tile dimension
    xp = rng.standard_normal((i_ch, h + k - 1, w + k - 1)).astype(np.float32)
    g = rng.standard_normal((o_ch, h, w)).astype(np.float32)
    plain = tcf.conv_dw_plain(torch.from_numpy(xp), torch.from_numpy(g), k,
                              k).numpy()
    ref = np.asarray(jcf.dw_valid_cf(jnp.asarray(xp), jnp.asarray(g),
                                     (k, k))).transpose(3, 2, 0, 1)
    assert rel(plain, ref) < 1e-5
    plans = _plans(h, w, o_ch, i_ch, k)
    assert len(plans) >= 3
    for p in plans:
        assert_dw_covers(p, o_ch, i_ch, k, h, w)
        got = emulate_dw(xp, g, k, p)
        # f32 sums of 19 * 90 products in other orders
        assert rel(got, plain) < 1e-5, p
        assert rel(got, ref) < 1e-5, p
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(tcf.conv_dw(torch.from_numpy(xp), torch.from_numpy(g),
                                   k, k), torch.from_numpy(plain))


def test_emulated_dw_at_a_parity_plane_stride_2_site():
    """A 3x3 stride-2 site runs as a 2x2 VALID conv of the 4C parity planes:
    the kernel's dw of the plane weight, mapped back through
    s2_plane_weight's adjoint, against the JAX stride-2 conv's VJP."""
    rng = np.random.default_rng(7)
    c, o_ch, hs, ws = 6, 9, 22, 34
    xs = rng.standard_normal((c, hs, ws)).astype(np.float32)
    w_hwio = (rng.standard_normal((3, 3, c, o_ch)) * 0.2).astype(np.float32)
    out_j, vjp = jax.vjp(lambda w_: jcf._conv_s2_planes(jnp.asarray(xs), w_),
                         jnp.asarray(w_hwio))
    gy = rng.standard_normal(out_j.shape).astype(np.float32)
    (ref,) = vjp(jnp.asarray(gy))
    ref = np.asarray(ref).transpose(3, 2, 0, 1)            # OIHW
    planes = tcf.s2_planes(torch.from_numpy(xs), 3, 3).numpy()
    h, w = gy.shape[1:]
    assert planes.shape == (4 * c, h + 1, w + 1)
    wt = torch.from_numpy(np.ascontiguousarray(
        w_hwio.transpose(3, 2, 0, 1))).requires_grad_(True)
    plane_w = tcf.s2_plane_weight(wt)
    for p in _plans(h, w, o_ch, 4 * c, 2):
        dw_planes = emulate_dw(planes, gy, 2, p)
        (got,) = torch.autograd.grad(
            plane_w, wt, torch.from_numpy(dw_planes), retain_graph=True)
        assert rel(got.numpy(), ref) < 1e-5, p


# -- (c) 3xTF32 over the longest pixel reduction ---------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_meets_f32_accuracy_over_65536_pixels(seed):
    """dw at a 256^2 site: g (16 output channels x 65,536 pixels) against
    the patches (65,536 pixels x 64 of I * k^2), unit-normal as chip_smoke.py
    draws them; and the LRT's dw_var, the squares of the input."""
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal((16, 65536)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((65536, 64)).astype(np.float32))
    for rhs in (x, x * x):
        ref = g.double() @ rhs.double()
        scale = float(ref.abs().max())
        err3 = float((matmul_3xtf32(g, rhs).double() - ref).abs().max())
        err1 = float((tf32(g) @ tf32(rhs)).double().sub(ref).abs().max())
        assert err3 / scale < 1e-5
        assert err1 / scale > 1e-5       # one TF32 pass would not do


# -- (d) the fused forward -------------------------------------------------------

def test_fused_fwd_plan_covers_every_fused_site_once():
    for s in chip_smoke.fused_sites(_nets()[2], 256):
        h, w, co, ci, k = (s[n] for n in ("h", "w", "co", "ci", "k"))
        p = tfb.fwd_plan(h, w, co, ci, k)
        assert p.split == 1                  # the grid walks the tiles
        bm, bn = tcf.TILES[p.tile]
        tiles_x = -(-w // TW)
        assert p.m_tiles == -(-h // p.rows) * tiles_x
        cover = np.zeros((co, h, w), np.int64)
        for my in range(p.m_tiles):
            y0, x0 = (my // tiles_x) * p.rows, (my % tiles_x) * TW
            for nz in range(p.n_tiles):
                cover[nz * bn:(nz + 1) * bn, y0:y0 + p.rows,
                      x0:x0 + TW] += 1
        assert (cover == 1).all(), s["name"]


def _seq(v: np.ndarray, axis: int) -> np.ndarray:
    """Sequential f32 sums along ``axis`` (a thread's loop, from 0)."""
    return np.add.accumulate(v.astype(np.float32), axis=axis,
                             dtype=np.float32).take(-1, axis=axis)


def _warp_sum(v: np.ndarray) -> np.ndarray:
    """conv_tile.cuh warp_sum over the last axis (32 lanes): the xor
    butterfly from 16 down, lane 0's result."""
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., np.arange(32) ^ off]
    return v[..., 0]


def _warp_sum_strided(v: np.ndarray) -> np.ndarray:
    """conv_tile.cuh warp_sum_strided over the last axis: lane l sums
    elements l, l + 32, ... in order, then warp_sum."""
    n = v.shape[-1]
    vz = np.zeros(v.shape[:-1] + (-(-n // 32) * 32,), np.float32)
    vz[..., :n] = v
    lanes = _seq(vz.reshape(v.shape[:-1] + (-1, 32)), axis=-2)
    return _warp_sum(lanes)


def emulate_fused_fwd(xp, w, gamma, beta, p, slope=0.2, eps=1e-5):
    """fused_block_fwd's arithmetic in f32 on the conv output c: pass 1's
    per-tile channel sums (each lane's pixels in (mf, column half) order,
    the 8 lanes of a channel pair by the xor tree, the tile's warp rows in
    order), the mean from their fixed-order totals; pass 2's centred squares
    per 2048-pixel chunk (each thread's strided pixels, the warp trees, the
    warps in order) and their totals; then normalize + LeakyReLU."""
    k = w.shape[2]
    co, h, wd = w.shape[0], xp.shape[1] - k + 1, xp.shape[2] - k + 1
    c = tcf.conv_valid_plain(torch.from_numpy(xp),
                             torch.from_numpy(w)).numpy()
    bm, bn = tcf.TILES[p.tile]
    wm = p.rows // 2                          # warp rows of the tile
    threads = 32 * wm * (bn // 32 if bn >= 32 else 1)
    ty, tx = -(-h // p.rows), -(-wd // TW)
    # masked pixels add nothing: zero-extend (x + 0 = x in f32)
    cz = np.zeros((co, ty * p.rows, tx * TW), np.float32)
    cz[:, :h, :wd] = c
    # (co, ty, warp row, mf, tx, column half, lane g)
    t = cz.reshape(co, ty, wm, 2, tx, 2, 8)
    lane = _seq(t.transpose(0, 1, 2, 4, 6, 3, 5).reshape(
        co, ty, wm, tx, 8, 4), axis=-1)       # (mf, eh) order
    tree = (((lane[..., 0] + lane[..., 1]) + (lane[..., 2] + lane[..., 3]))
            + ((lane[..., 4] + lane[..., 5]) + (lane[..., 6] + lane[..., 7])))
    tile_sum = _seq(tree, axis=2)             # (co, ty, tx): warp rows
    part_sum = tile_sum.reshape(co, ty * tx)  # my = row tile * tx + col tile
    inv_hw = np.float32(1.0 / (h * wd))
    mu = _warp_sum_strided(part_sum) * inv_hw
    hw, chunk = h * wd, 2048
    n_chunks = -(-hw // chunk)
    d2 = (c.reshape(co, hw) - mu[:, None]) ** 2
    d2z = np.zeros((co, n_chunks * chunk), np.float32)
    d2z[:, :hw] = d2
    per_thread = _seq(d2z.reshape(co, n_chunks, chunk // threads, threads),
                      axis=2)                 # (co, chunk, thread)
    warps = _warp_sum(per_thread.reshape(co, n_chunks, threads // 32, 32))
    part_sq = _seq(warps, axis=-1)            # (co, chunk)
    var = _warp_sum_strided(part_sq) * inv_hw
    inv = np.float32(1.0) / np.sqrt(var + np.float32(eps))
    y = ((c - mu[:, None, None]) * inv[:, None, None] * gamma[:, None, None]
         + beta[:, None, None])
    return (np.where(y > 0, y, np.float32(slope) * y),
            np.stack([mu, inv], axis=1))


@pytest.mark.parametrize("ci,h,w,k", [(16, 128, 128, 3), (16, 128, 128, 1),
                                      (36, 64, 48, 3), (20, 8, 8, 3)])
def test_emulated_fused_fwd_matches_fwd_plain_and_jax(ci, h, w, k):
    rng = np.random.default_rng(ci + h + k)
    co = 16
    x = rng.standard_normal((1, ci, h, w)).astype(np.float32)
    w_hwio = (rng.standard_normal((k, k, ci, co)) * 0.1).astype(np.float32)
    gamma = (rng.random(co) + 0.5).astype(np.float32)
    beta = rng.standard_normal(co).astype(np.float32)
    xt = torch.from_numpy(x)
    p_ = (k - 1) // 2
    xp = (torch.nn.functional.pad(xt, (p_,) * 4, mode="reflect")
          if p_ else xt)[0].contiguous().numpy()
    wt = np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))
    plan = tfb.fwd_plan(h, w, co, ci, k)
    got, stats = emulate_fused_fwd(xp, wt, gamma, beta, plan)
    out_p, stats_p = (a.numpy() for a in tfb.fwd_plain(
        torch.from_numpy(xp), torch.from_numpy(wt), torch.from_numpy(gamma),
        torch.from_numpy(beta)))
    # chip_smoke.py's tolerances of the kernel against fwd_plain
    assert rel(got, out_p) < 1e-4
    assert rel(stats[:, 0], stats_p[:, 0]) < 1e-5
    assert rel(stats[:, 1], stats_p[:, 1]) < 1e-5
    if jfb.supported(ci, co, h, w, k):
        ref = np.asarray(jfb.apply_fused(
            jnp.asarray(x), jnp.asarray(w_hwio), jnp.asarray(gamma),
            jnp.asarray(beta), pad_mode="reflection"))[0]
        assert rel(got, ref) < 1e-4
