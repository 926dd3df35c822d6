"""The fused block's backward on the tensor cores (``fused_block_bwd_dx`` on
conv_mma.cuh's FULL tile, ``fused_block_bwd_dw`` on its dw tile), held on
the CPU before any card runs it.

(a) At each of the 20 fused sites of the 256^2 den U-Net (FUSED_SITES, as
    chip_smoke.py::fused_sites lists them): dx's tile plan in the FULL form
    (``fused_block.py::dx_plan``) covers every output pixel, output channel
    and K chunk once with at least tile_plan's floor of blocks, and the dw
    plan (``dw_plan``) covers every channel, tap and pixel tile once.
(b) A CPU emulation of each kernel's arithmetic at its plan (the FULL dx's
    3xTF32 products chunk by chunk, its cluster ranks summed in rank order;
    the dw tile's staging, 3xTF32 products and warp / rank / group sums) at
    reduced shapes -- narrow widths, ragged channels 36 / 68, Co = 4, k = 1
    -- equals ``bwd_dx_plain`` / ``bwd_dw_plain``, and at the shapes JAX
    fuses the JAX block's input and weight gradients (ops/pallas/
    fused_block.py in interpret mode), to 1e-5 of the largest value.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import chip_smoke
from mfvi_dip_mia_tpu.ops.pallas import fused_block as jfb
from mfvi_dip_mia_tpu_torch.nn import build_skip_net
from mfvi_dip_mia_tpu_torch.ops import pad
from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf
from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb
from torch_port_helpers import (TW, assert_dw_covers, emulate_dw,
                                emulate_full_dx, matmul_3xtf32_np, rel)

torch.set_num_threads(1)

# (name, Ci, Co, H, W, k, needs dx) of the 256^2 den net's fused sites
FUSED_SITES = (
    ("levels.0.skip", 16, 4, 256, 256, 1, False),
    ("levels.0.down2", 16, 16, 128, 128, 3, True),
    ("levels.0.up", 36, 16, 256, 256, 3, True),
    ("levels.0.up1x1", 16, 16, 256, 256, 1, True),
    ("levels.1.skip", 16, 4, 128, 128, 1, True),
    ("levels.1.down2", 32, 32, 64, 64, 3, True),
    ("levels.1.up", 68, 32, 128, 128, 3, True),
    ("levels.1.up1x1", 32, 32, 128, 128, 1, True),
    ("levels.2.skip", 32, 4, 64, 64, 1, True),
    ("levels.2.down2", 64, 64, 32, 32, 3, True),
    ("levels.2.up", 132, 64, 64, 64, 3, True),
    ("levels.2.up1x1", 64, 64, 64, 64, 1, True),
    ("levels.3.skip", 64, 4, 32, 32, 1, True),
    ("levels.3.down2", 128, 128, 16, 16, 3, True),
    ("levels.3.up", 132, 128, 32, 32, 3, True),
    ("levels.3.up1x1", 128, 128, 32, 32, 1, True),
    ("levels.4.skip", 128, 4, 16, 16, 1, True),
    ("levels.4.down2", 128, 128, 8, 8, 3, True),
    ("levels.4.up", 132, 128, 16, 16, 3, True),
    ("levels.4.up1x1", 128, 128, 16, 16, 1, True),
)


def test_the_site_list_is_the_den_nets():
    net = build_skip_net(16, n_channels=2, pad="reflection",
                         skip_n33d=[16, 32, 64, 128, 128],
                         skip_n33u=[16, 32, 64, 128, 128], skip_n11=4,
                         num_scales=5, upsample_mode="bilinear")
    got = tuple((s["name"], s["ci"], s["co"], s["h"], s["w"], s["k"],
                 s["needs_dx"]) for s in chip_smoke.fused_sites(net, 256))
    assert got == FUSED_SITES
    assert sum(s[-1] for s in FUSED_SITES) == 19


# -- (a) the plans at the fused sites ---------------------------------------------

@pytest.mark.parametrize("site", [s for s in FUSED_SITES if s[-1]],
                         ids=lambda s: s[0])
def test_dx_plan_covers_every_output_once_and_fills_the_card(site):
    _, ci, co, h, w, k, _ = site
    ho, wo = h + k - 1, w + k - 1
    p = tfb.dx_plan(h, w, co, ci, k)
    assert p == tcf.tile_plan(ho, wo, ci, co, torch.float32, k)
    bm, bn = tcf.TILES[p.tile]
    assert bn <= max(16, ci)
    tiles_x = -(-wo // TW)
    assert p.m_tiles == -(-ho // p.rows) * tiles_x
    cover = np.zeros((ci, ho, wo), np.int64)
    for my in range(p.m_tiles):
        y0, x0 = (my // tiles_x) * p.rows, (my % tiles_x) * TW
        for nz in range(p.n_tiles):
            cover[nz * bn:(nz + 1) * bn, y0:y0 + p.rows, x0:x0 + TW] += 1
    assert (cover == 1).all()
    # K: the 8-channel chunks of dconv, each in one rank of the cluster
    assert p.chunks == -(-co // 8)
    seen = sorted(c for r in range(p.split) for c in p.chunks_of(r))
    assert seen == list(range(p.chunks))
    assert 1 <= p.split <= tcf.MAX_SPLIT
    # tile_plan's floor: min(132, the smallest tile's blocks unsplit)
    smallest = min(range(len(tcf.TILES)),
                   key=lambda t: tcf.TILES[t][0] * tcf.TILES[t][1])
    least = tcf._plan(smallest, 1, ho, wo, ci, p.chunks).ctas
    assert p.ctas >= min(tcf.SMS, least)


@pytest.mark.parametrize("site", FUSED_SITES, ids=lambda s: s[0])
def test_dw_plan_covers_every_pixel_tile_once(site):
    _, ci, co, h, w, k, _ = site
    p = tfb.dw_plan(h, w, co, ci, k)
    assert p == tcf.dw_plan(h, w, co, ci, torch.float32, k)
    assert_dw_covers(p, co, ci, k, h, w)
    most = max(c.ctas for c in tcf.dw_candidates(h, w, co, ci, k)
               if c.tile == 0)
    assert p.ctas >= min(tcf.SMS, most)


# -- (b) the kernels' arithmetic at reduced shapes -----------------------------------

def _dx_plans(h, w, co, ci, k):
    """The picked FULL plan and one that splits K over a cluster."""
    picked = tfb.dx_plan(h, w, co, ci, k)
    chunks = -(-co // 8)
    plans = [picked]
    if chunks > 1:
        plans.append(tcf._plan(3, min(4, chunks), h + k - 1, w + k - 1, ci,
                               chunks))
    return plans


def _dw_plans(h, w, co, ci, k):
    """The picked dw plan, one cluster of 4 and two groups of 8-clusters."""
    picked = tfb.dw_plan(h, w, co, ci, k)
    n_pt = picked.pixel_tiles
    return [picked] + [tcf._dw_plan(t, c, g, h, w, co, ci, k)
                       for t, c, g in ((1, 4, 1), (0, 8, 2))
                       if c * g <= n_pt]


def _block_operands(ci, co, h, w, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, ci, h, w)).astype(np.float32)
    w_hwio = (rng.standard_normal((k, k, ci, co)) * 0.1).astype(np.float32)
    gamma = (rng.random(co) + 0.5).astype(np.float32)
    beta = rng.standard_normal(co).astype(np.float32)
    g = rng.standard_normal((1, co, h, w)).astype(np.float32)
    return x, w_hwio, gamma, beta, g


@pytest.mark.parametrize("ci,co,h,w,k", [
    (36, 68, 10, 20, 3),        # narrow, ragged channel tiles
    (68, 4, 9, 23, 3),          # Co = 4, ragged width
    (36, 4, 8, 128, 3),         # a shape JAX fuses
    (68, 36, 8, 128, 1),        # k = 1, a shape JAX fuses
])
def test_emulated_bwd_matches_the_plain_versions_and_jax(ci, co, h, w, k):
    x, w_hwio, gamma, beta, g = _block_operands(ci, co, h, w, k,
                                                seed=ci + co + k)
    p_ = (k - 1) // 2
    xt = torch.from_numpy(x)
    xp = (pad.reflection_pad(xt[0], p_) if p_ else xt[0]).contiguous()
    wt = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    gm, bt = torch.from_numpy(gamma), torch.from_numpy(beta)
    out, stats = tfb.fwd_plain(xp, wt, gm, bt)
    dc = tfb.bwd_dc_plain(torch.from_numpy(g[0]), out, stats, gm, bt)[0]
    dx_plain = tfb.bwd_dx_plain(dc, wt).numpy()
    dw_plain = tfb.bwd_dw_plain(dc, xp, k).numpy()
    # the wrappers on CPU tensors are the plain versions
    assert np.array_equal(tfb.bwd_dx(dc, wt).numpy(), dx_plain)
    assert np.array_equal(tfb.bwd_dw(dc, xp, k).numpy(), dw_plain)
    dxs = [emulate_full_dx(dc.numpy(), wt.numpy(), p)
           for p in _dx_plans(h, w, co, ci, k)]
    dws = [emulate_dw(xp.numpy(), dc.numpy(), k, p, matmul=matmul_3xtf32_np)
           for p in _dw_plans(h, w, co, ci, k)]
    assert len(dxs) + len(dws) >= 3
    # f32 sums of <= 68 * 9 (dx) and 23 * 10 (dw) 3xTF32 products in other
    # orders
    for got in dxs:
        assert rel(got, dx_plain) < 1e-5
    for got in dws:
        assert rel(got, dw_plain) < 1e-5
    if not jfb.supported(ci, co, h, w, k):
        return
    args = [jnp.asarray(a) for a in (x, w_hwio, gamma, beta)]
    _, vjp = jax.vjp(lambda *a: jfb.apply_fused(*a, pad_mode="reflection"),
                     *args)
    gx, gw, _, _ = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    for got in dxs:
        dx_in = (pad.reflection_pad_adjoint(torch.from_numpy(got), p_)
                 if p_ else torch.from_numpy(got)).numpy()
        assert rel(dx_in, gx[0]) < 1e-5
    for got in dws:
        assert rel(got, gw.transpose(3, 2, 0, 1)) < 1e-5
