"""The fused conv + BN + LeakyReLU block in bf16 (ops/kernels/fused_block.py,
its plain versions on the CPU; the CUDA kernels are csrc/fused_block.cu's
bf16 instantiations, which chip_smoke.py holds to these plain versions).

(a) Each bf16 plain version against the f32 one: on bf16 operands the f32
    arithmetic is the same, so each bf16 output is the f32 output rounded
    to bf16 once, bit for bit; on f32 operands rounded to bf16, within bf16
    tolerances.
(b) The bf16 block (apply_fused) against the unfused bf16 chain it replaces
    (cf_conv + batch_norm_train + leaky_relu), values and gradients, both
    against a float64 reference on the same bf16 operands.
(c) The wrappers raise on operands of two dtypes and on k = 5.
(d) The plans: dc_plan at bf16's 2 bytes a value, fwd_plan's bf16 tile,
    dw_plan / dx_plan at bf16, and the f32 dc_plan / fwd_plan unchanged at
    the 256^2 den net's 20 fused sites; a numpy emulation of the bf16 dc's
    order of summation (groups of 8 pixels) against bwd_dc_plain.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from mfvi_dip_mia_tpu_torch.nn import build_skip_net, layers
from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf
from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb

torch.set_num_threads(1)

BF16 = torch.bfloat16
SMS = 132
SMEM_PER_BLOCK = 232_448
# one bf16 rounding of the largest output: 2^-7 of a value at most, as a
# share of the largest magnitude (chip_smoke.py's TOL[("conv", "bf16")])
TOL_BF16 = 8e-3

SITES = chip_smoke.fused_sites(
    build_skip_net(16, n_channels=2, pad="reflection",
                   skip_n33d=[16, 32, 64, 128, 128],
                   skip_n33u=[16, 32, 64, 128, 128], skip_n11=4,
                   num_scales=5, upsample_mode="bilinear"), 256)

# The f32 plans at the den net's 20 fused sites, as the f32-only block
# planned them: (name, dc_plan, (tile, m_tiles, n_tiles, chunks) of
# fwd_plan). The bf16 plans must leave them as they were.
F32_PLANS = (
    ("levels.0.skip", (8, 1, 8192, 8192, 4, 32, 65536), (5, 512, 1, 2)),
    ("levels.0.down2", (8, 1, 2048, 2048, 1, 128, 16384), (5, 128, 1, 2)),
    ("levels.0.up", (8, 1, 8192, 8192, 4, 128, 65536), (5, 512, 1, 5)),
    ("levels.0.up1x1", (8, 1, 8192, 8192, 4, 128, 65536), (5, 512, 1, 2)),
    ("levels.1.skip", (8, 1, 2048, 2048, 1, 32, 16384), (5, 128, 1, 2)),
    ("levels.1.down2", (4, 1, 1024, 1024, 1, 128, 8192), (5, 32, 2, 4)),
    ("levels.1.up", (4, 1, 4096, 4096, 2, 128, 32768), (5, 128, 2, 9)),
    ("levels.1.up1x1", (4, 1, 4096, 4096, 2, 128, 32768), (5, 128, 2, 4)),
    ("levels.2.skip", (4, 1, 1024, 1024, 1, 16, 8192), (5, 32, 1, 4)),
    ("levels.2.down2", (1, 1, 1024, 1024, 1, 64, 8192), (5, 8, 4, 8)),
    ("levels.2.up", (2, 1, 2048, 2048, 1, 128, 16384), (5, 32, 4, 17)),
    ("levels.2.up1x1", (2, 1, 2048, 2048, 1, 128, 16384), (5, 32, 4, 8)),
    ("levels.3.skip", (1, 1, 1024, 1024, 1, 4, 8192), (5, 8, 1, 8)),
    ("levels.3.down2", (1, 4, 256, 256, 1, 32, 8192), (5, 2, 8, 16)),
    ("levels.3.up", (1, 1, 1024, 1024, 1, 128, 8192), (5, 8, 8, 17)),
    ("levels.3.up1x1", (1, 1, 1024, 1024, 1, 128, 8192), (5, 8, 8, 16)),
    ("levels.4.skip", (1, 4, 256, 256, 1, 1, 8192), (5, 2, 1, 16)),
    ("levels.4.down2", (1, 8, 64, 64, 1, 16, 4096), (5, 1, 8, 16)),
    ("levels.4.up", (1, 4, 256, 256, 1, 32, 8192), (5, 2, 8, 17)),
    ("levels.4.up1x1", (1, 4, 256, 256, 1, 32, 8192), (5, 2, 8, 16)))


def _site_of(name):
    return next(s for s in SITES if s["name"] == name)


def _operands(ci, co, h, w, k, seed):
    """f32 (xp, w, gamma, beta, g) of one site: the reflection-padded input,
    the OIHW kernel, the BN affine and a cotangent of the output."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((1, ci, h, w), generator=gen) * 2 + 0.5
    p = (k - 1) // 2
    xp = (torch.nn.functional.pad(x, (p,) * 4, mode="reflect")
          if p else x)[0].contiguous()
    wk = torch.randn((co, ci, k, k), generator=gen) / (ci * k * k) ** 0.5
    gamma = (torch.rand((co,), generator=gen) + 0.5) * torch.where(
        torch.rand((co,), generator=gen) < 0.3, -1.0, 1.0)
    beta = torch.randn((co,), generator=gen)
    g = torch.randn((co, h, w), generator=gen)
    return xp, wk, gamma, beta, g


def _rel(got, ref):
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max())


# -- (a) the bf16 plain versions against the f32 ones -------------------------

SHAPES = ((6, 8, 16, 20, 3), (16, 4, 32, 32, 1), (20, 12, 9, 13, 3))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_plain_is_the_f32_plain_rounded_once(shape):
    """On bf16 operands each bf16 plain version does the f32 version's
    arithmetic (exact f32 products of bf16 values, f32 sums, statistics and
    epilogue) and rounds its output to bf16 once: the f32 result, rounded,
    bit for bit; the statistics are the f32 ones."""
    ci, co, h, w, k = shape
    xp, wk, gamma, beta, g = (t.to(BF16) for t in _operands(*shape, 1))
    xp32, wk32, ga32, be32, g32 = (t.float() for t in (xp, wk, gamma, beta, g))
    out, stats = tfb.fwd_plain(xp, wk, gamma, beta)
    out32, stats32 = tfb.fwd_plain(xp32, wk32, ga32, be32)
    assert out.dtype == BF16 and stats.dtype == torch.float32
    assert torch.equal(out, out32.to(BF16)) and torch.equal(stats, stats32)
    got = tfb.bwd_dc_plain(g, out, stats, gamma, beta)
    ref = tfb.bwd_dc_plain(g32, out.float(), stats, ga32, be32)
    for a, r in zip(got, ref):
        assert a.dtype == BF16 and torch.equal(a, r.to(BF16))
    dc = got[0]
    dw = tfb.bwd_dw_plain(dc, xp, k)
    dx = tfb.bwd_dx_plain(dc, wk)
    assert dw.dtype == dx.dtype == BF16
    assert torch.equal(dw, tfb.bwd_dw_plain(dc.float(), xp32, k).to(BF16))
    assert torch.equal(dx, tfb.bwd_dx_plain(dc.float(), wk32).to(BF16))
    # the wrappers take the plain versions on the CPU
    assert all(torch.equal(a, b) for a, b in zip(
        tfb.fwd(xp, wk, gamma, beta), (out, stats)))
    assert all(torch.equal(a, b) for a, b in zip(
        tfb.bwd_dc(g, out, stats, gamma, beta), got))
    assert torch.equal(tfb.bwd_dw(dc, xp, k), dw)
    assert torch.equal(tfb.bwd_dx(dc, wk), dx)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_plain_against_f32_plain_on_f32_operands(shape):
    """Each bf16 plain version on f32 operands rounded to bf16 against the
    f32 version on the operands themselves: the forward within two bf16
    roundings (operands, output), the statistics within the operands'
    rounding; each backward kernel, given the f32 forward's out and stats
    rounded as the bf16 block keeps them, within a few bf16 roundings of
    sums over its products."""
    ci, co, h, w, k = shape
    xp, wk, gamma, beta, g = _operands(*shape, 2)
    xb, wb, gab, beb, gb = (t.to(BF16) for t in (xp, wk, gamma, beta, g))
    out, stats = tfb.fwd_plain(xb, wb, gab, beb)
    out32, stats32 = tfb.fwd_plain(xp, wk, gamma, beta)
    assert _rel(out, out32) < 2e-2
    assert _rel(stats[:, 0], stats32[:, 0]) < 1e-2
    assert _rel(stats[:, 1], stats32[:, 1]) < 1e-2
    ref = tfb.bwd_dc_plain(g, out32, stats32, gamma, beta)
    got = tfb.bwd_dc_plain(gb, out32.to(BF16), stats32, gab, beb)
    for a, r in zip(got, ref):
        assert _rel(a, r) < 3e-2
    dc32 = ref[0]
    assert _rel(tfb.bwd_dw_plain(dc32.to(BF16), xb, k),
                tfb.bwd_dw_plain(dc32, xp, k)) < 2e-2
    assert _rel(tfb.bwd_dx_plain(dc32.to(BF16), wb),
                tfb.bwd_dx_plain(dc32, wk)) < 2e-2


# -- (b) the bf16 block against the unfused bf16 chain ------------------------

def _block(dtype, ci, co, h, w, k, seed, fused):
    """Output and (dx, dw, dgamma, dbeta), in float64, of one 'same' site on
    bf16-rounded operands computed in ``dtype``, under the loss
    sum((out - tgt)^2) + sum(sin(out)) taken in float64: the fused block or
    the unfused chain (conv kernel, shifted one-pass BN, LeakyReLU)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((1, ci, h, w), generator=gen) * 2 + 0.5
    wk = torch.randn((co, ci, k, k), generator=gen) * 0.3
    gamma = torch.rand((co,), generator=gen) + 0.5
    beta = torch.randn((co,), generator=gen)
    tgt = torch.randn((1, co, h, w), generator=gen).double()
    ts = [t.to(BF16).to(dtype).requires_grad_(True)
          for t in (x, wk, gamma, beta)]
    if fused:
        out = tfb.apply_fused(*ts)
    else:
        c = tcf.conv2d_cf(ts[0], ts[1], None, 1, (k - 1) // 2, "reflection")
        out = layers.leaky_relu(layers.batch_norm_train(c, ts[2], ts[3]))
    o = out.double()
    (((o - tgt) ** 2).sum() + torch.sin(o).sum()).backward()
    return [out.detach().double()] + [t.grad.double() for t in ts]


@pytest.mark.parametrize("k,seed", [(1, 0), (3, 0), (1, 3), (3, 5)])
def test_bf16_block_against_the_unfused_bf16_chain(k, seed):
    """The fused bf16 block and the unfused bf16 chain on the same bf16
    operands, against the float64 chain: the block, which rounds only its
    output, lies within two bf16 roundings of the exact value in its output
    and all four gradients, and no farther from it than the chain, which
    rounds the conv output, the BN's multiply-add and every gradient on the
    way back (its dx and dw drift by several per cent)."""
    shape = (6, 8, 16, 20, k)
    exact = _block(torch.float64, *shape, seed, fused=False)
    fused = _block(BF16, *shape, seed, fused=True)
    chain = _block(BF16, *shape, seed, fused=False)
    names = ("out", "dx", "dw", "dgamma", "dbeta")
    err_f = {n: _rel(a, r) for n, a, r in zip(names, fused, exact)}
    err_c = {n: _rel(a, r) for n, a, r in zip(names, chain, exact)}
    assert max(err_f.values()) < 1e-2, err_f
    for n in names:
        assert err_f[n] <= err_c[n] * 1.01 + 1e-4, (n, err_f, err_c)
    # the block's output is the chain's within a few bf16 roundings
    assert _rel(fused[0], chain[0]) < 2e-2


# -- (c) what the wrappers refuse ----------------------------------------------

def test_wrappers_raise_on_mixed_dtypes_and_k5():
    xp, wk, gamma, beta, g = _operands(4, 8, 8, 8, 3, 4)
    xb, wb, gab, beb, gb = (t.to(BF16) for t in (xp, wk, gamma, beta, g))
    x4 = xp[None, :, 1:-1, 1:-1]
    with pytest.raises(ValueError, match="of one dtype"):
        tfb.fwd(xb, wk, gab, beb)
    with pytest.raises(ValueError, match="of one dtype"):
        tfb.fwd(xb, wb, gamma, beb)
    out, stats = tfb.fwd(xb, wb, gab, beb)
    with pytest.raises(ValueError, match="of one dtype"):
        tfb.bwd_dc(g, out, stats, gab, beb)
    with pytest.raises(ValueError, match="of one dtype"):
        tfb.bwd_dw(g, xb, 3)
    with pytest.raises(ValueError, match="of one dtype"):
        tfb.bwd_dx(gb, wk)
    with pytest.raises(ValueError, match="of one dtype"):
        tfb.fwd(xp.half(), wk.half(), gamma.half(), beta.half())
    for args in ((x4.to(BF16), wk, gab, beb), (x4.to(BF16), wb, gamma, beb),
                 (x4, wk, gamma, beta.to(BF16))):
        with pytest.raises(ValueError, match="batch-1 f32 or bf16"):
            tfb.apply_fused(*args)
    w5 = torch.zeros((8, 4, 5, 5), dtype=BF16)
    with pytest.raises(ValueError, match="batch-1 f32 or bf16"):
        tfb.apply_fused(x4.to(BF16), w5, gab, beb)
    with pytest.raises(ValueError, match="square kernel"):
        tfb.fwd(torch.zeros((4, 12, 12), dtype=BF16), w5, gab, beb)
    with pytest.raises(ValueError, match="does not match"):
        tfb.bwd_dw(gb, xb, 5)
    with pytest.raises(ValueError):
        tfb.bwd_dx(gb, w5)


# -- (d) the plans -------------------------------------------------------------

def test_f32_plans_at_the_den_sites_are_unchanged():
    assert [s["name"] for s in SITES] == [n for n, _, _ in F32_PLANS]
    for name, dc, fwd in F32_PLANS:
        s = _site_of(name)
        h, w, co, ci, k = (s[n] for n in ("h", "w", "co", "ci", "k"))
        assert tuple(tfb.dc_plan(co, h * w)) == dc, name
        assert tfb.dc_plan(co, h * w, 4) == tfb.dc_plan(co, h * w)
        p = tfb.fwd_plan(h, w, co, ci, k)
        assert (p.tile, p.m_tiles, p.n_tiles, p.chunks) == fwd, name
        assert p.split == 1 and p == tfb.fwd_plan(h, w, co, ci, k,
                                                  torch.float32)


def _slices(plan, co, hw):
    """(channel, rank, first pixel, pixels) of every slice of the plan."""
    for b in range(plan.blocks):
        rank = b % plan.cluster
        for j in range(plan.cpb):
            c = (b // plan.cluster) * plan.cpb + j
            if c < co:
                p0 = rank * plan.length
                yield c, rank, p0, max(0, min(plan.length, hw - p0))


ODD = tuple((co, h, w) for _, co, h, w, _ in chip_smoke.EXTRA_FUSED_SHAPES)
DEN = tuple((s["co"], s["h"], s["w"]) for s in SITES)


@pytest.mark.parametrize("shape", sorted(set(DEN + ODD + ((16, 512, 512),))),
                         ids=lambda s: "x".join(map(str, s)))
def test_bf16_dc_plan_covers_every_pixel_once(shape):
    """At 2 bytes a value: slices and resident prefixes on 16-byte (8-pixel)
    boundaries, g and out of a slice in cpb * 2 * res * 2 bytes, every 256^2
    site resident and within one wave."""
    co, h, w = shape
    hw = h * w
    plan = tfb.dc_plan(co, hw, 2)
    assert 1 <= plan.cluster <= 8 and plan.cpb in (1, 2, 4, 8)
    assert plan.cpb == 1 or plan.cluster == 1
    assert plan.length % 8 == 0 and plan.res % 8 == 0 and plan.res >= 8
    assert 1 <= plan.chunks <= 4 and plan.chunks <= max(1, plan.res // 2048)
    assert plan.smem == plan.cpb * 2 * plan.res * 2
    assert plan.smem <= tfb.DC_SMEM <= SMEM_PER_BLOCK
    seen = np.zeros((co, hw), np.int32)
    for c, _, p0, n in _slices(plan, co, hw):
        seen[c, p0:p0 + n] += 1
    assert (seen == 1).all()
    if shape in DEN:
        assert plan.res >= plan.length and plan.blocks <= SMS, plan
        # half the bytes, the same split of the pixels as f32 (each 256^2
        # f32 slice is a multiple of 8 pixels)
        assert plan.cluster == tfb.dc_plan(co, hw).cluster
        assert plan.smem * 2 == tfb.dc_plan(co, hw).smem
    assert tfb.dc_plan(co, hw, 2) is plan


def test_bf16_dc_plan_holds_512_squared_channels_in_fewer_blocks():
    """16 x 512^2 (the level-0 sites on a 512^2 input): 2 MB of f32 g and
    out a channel outgrows a cluster's shared memory; 1 MB of bf16 fits."""
    f32, bf16 = tfb.dc_plan(16, 512 * 512), tfb.dc_plan(16, 512 * 512, 2)
    assert f32.res < f32.length
    assert bf16.res == bf16.length and bf16.cluster == 8


def test_bf16_fwd_dw_dx_plans_at_the_fused_sites():
    """fwd_plan's bf16 tile covers each site's output once in 16-channel
    chunks; dw_plan and dx_plan at bf16 are cf_conv's bf16 plans, which the
    unfused bf16 sites ran."""
    for s in SITES:
        h, w, co, ci, k = (s[n] for n in ("h", "w", "co", "ci", "k"))
        p = tfb.fwd_plan(h, w, co, ci, k, BF16)
        assert p.tile == tfb.FWD_TILE_BF16 and p.split == 1
        assert p.chunks == -(-ci // 16)
        bm, bn = tcf.TILES[p.tile]
        assert p.rows == bm // 16 and p.bn == bn
        assert p.m_tiles == -(-h // p.rows) * -(-w // 16)
        assert p.n_tiles == -(-co // bn)
        assert tfb.dw_plan(h, w, co, ci, k, BF16) == tcf.dw_plan(
            h, w, co, ci, BF16, k)
        assert tfb.dx_plan(h, w, co, ci, k, BF16) == tcf.tile_plan(
            h + k - 1, w + k - 1, ci, co, BF16, k)


def _butterfly(v):
    """conv_tile.cuh::warp_sum: the xor shuffle tree, lane 0's result."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[lanes ^ off]
    return v[0]


def _thread_sums(x, threads, group):
    """Each thread's sum of its groups of ``group`` pixels u = t,
    t + threads, ..., each group's pixels in order (f32)."""
    pad = -len(x) % (group * threads)
    groups = np.concatenate([x, np.zeros(pad, np.float32)]).reshape(
        -1, threads, group)
    acc = np.zeros(threads, np.float32)
    for row in groups:
        for e in range(group):
            acc = acc + row[:, e]
    return acc


def emulate_dc_bf16(g, out, stats, gamma, beta, slope=0.2):
    """The bf16 fused_bwd_dc_cluster_kernel's arithmetic at dc_plan's bf16
    plan: the values widened to f32, groups of 8 pixels, the warp's tree,
    the channel's warps and the cluster's ranks in order; dconv, dgamma and
    dbeta rounded to bf16."""
    f32 = np.float32
    co, h, w = out.shape
    hw = h * w
    plan = tfb.dc_plan(co, hw, 2)
    gt = tfb.DC_THREADS // plan.cpb
    g2 = g.float().numpy().reshape(co, hw)
    o2 = out.float().numpy().reshape(co, hw)
    ga_all, be_all = gamma.float().numpy(), beta.float().numpy()

    def leaf(c, o, gv):
        ga, be = ga_all[c], be_all[c]
        rg = f32(1) / (f32(1e-20) if abs(ga) < 1e-20 else ga)
        m = o > 0
        xh = (np.where(m, o, o * f32(1 / slope)) - be) * rg
        return xh, np.where(m, gv, f32(slope) * gv)

    parts = {}
    for c, rank, p0, n in _slices(plan, co, hw):
        xh, gp = leaf(c, o2[c, p0:p0 + n], g2[c, p0:p0 + n])
        sums = []
        for x in (gp, gp * xh):
            a = _thread_sums(x.astype(f32), gt, 8)
            s = f32(0)
            for wi in range(gt // 32):
                s = s + _butterfly(a[32 * wi:32 * wi + 32])
            sums.append(s)
        parts[c, rank] = sums
    dconv = np.empty_like(g2)
    dgb = np.empty((2, co), f32)
    for c in range(co):
        s1 = s2 = f32(0)
        for r in range(plan.cluster):
            s1, s2 = s1 + parts[c, r][0], s2 + parts[c, r][1]
        dgb[:, c] = s2, s1
        xh, gp = leaf(c, o2[c], g2[c])
        m1, m2 = s1 * f32(1 / hw), s2 * f32(1 / hw)
        dconv[c] = (stats[c, 1].item() * ga_all[c]) * ((gp - m1) - xh * m2)
    return (torch.from_numpy(dconv.reshape(co, h, w)).to(BF16),
            torch.from_numpy(dgb[0]).to(BF16),
            torch.from_numpy(dgb[1]).to(BF16))


# clusters of 8 and 4, 8 channels a block, a ragged last block
@pytest.mark.parametrize("shape", [(4, 128, 128), (32, 64, 64), (128, 8, 8),
                                   (36, 8, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_emulated_bf16_dc_order_matches_plain(shape):
    co, h, w = shape
    plan = tfb.dc_plan(co, h * w, 2)
    assert (plan.cluster > 1) != (plan.cpb > 1)
    xp, wk, gamma, beta, g = (t.to(BF16) for t in _operands(
        co, co, h, w, 1, co + h))
    out, stats = tfb.fwd_plain(xp, wk, gamma, beta)
    got = emulate_dc_bf16(g, out, stats, gamma, beta)
    ref = tfb.bwd_dc_plain(g, out, stats, gamma, beta)
    for name, a, r in zip(("dconv", "dgamma", "dbeta"), got, ref):
        assert a.dtype == r.dtype == BF16
        assert _rel(a, r) <= TOL_BF16, name
