"""The fused block's dc kernel (``fused_block_bwd_dc``: one cluster launch
per site, csrc/fused_block.cu) held on the CPU before any card runs it.

(a) ``ops/kernels/fused_block.py::dc_plan`` at the 20 fused sites of the
    256^2 den U-Net, chip_smoke.py's four odd fused shapes and 512^2
    versions of the level-0 sites: every (channel, pixel) once, clusters of
    1-8, dynamic shared memory within a block's 227 KB, every slice
    resident at the 256^2 den sites, and one wave or less at the widest.
(b) A numpy emulation of the kernel's order of summation at its plan (each
    thread's groups of four pixels in order, the warp's shuffle tree, the
    warps of a channel in index order, the cluster's ranks in rank order),
    then dconv, against
    ``bwd_dc_plain`` and the JAX block's ``_bwd_dc_call`` (ops/pallas/
    fused_block.py in interpret mode).
(c) The source: no grid barrier, cooperative launch or atomics on the dc's
    path, and no scratch in its wrapper.
"""

import inspect
import os
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import chip_smoke
from mfvi_dip_mia_tpu.ops.pallas import fused_block as jfb
from mfvi_dip_mia_tpu_torch.nn import build_skip_net
from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "mfvi_dip_mia_tpu_torch", "csrc", "fused_block.cu")

# (Co, H, W) of the 256^2 den net's 20 fused sites, as chip_smoke.py lists
# them
DEN_SITES = tuple((s["co"], s["h"], s["w"]) for s in chip_smoke.fused_sites(
    build_skip_net(16, n_channels=2, pad="reflection",
                   skip_n33d=[16, 32, 64, 128, 128],
                   skip_n33u=[16, 32, 64, 128, 128], skip_n11=4,
                   num_scales=5, upsample_mode="bilinear"), 256))
ODD = tuple((co, h, w) for _, co, h, w, _ in chip_smoke.EXTRA_FUSED_SHAPES)
# level 0 of the net on a 512^2 input: skip, down2, up, up1x1
WIDE = ((4, 512, 512), (16, 256, 256), (16, 512, 512), (16, 512, 512))
SMEM_PER_BLOCK = 232_448          # an H100 block's shared memory, opted in
SMS = 132

# dconv, dgamma and dbeta as a share of the reference's largest magnitude:
# the same f32 arithmetic, sums of up to 16,384 terms in another order
# (tests/test_torch_fused_block.py's TOL)
TOL = 1e-4


def _slices(plan, co, hw):
    """(block, channel, first pixel, pixels) of every slice of the plan."""
    for b in range(plan.blocks):
        rank = b % plan.cluster
        for j in range(plan.cpb):
            c = (b // plan.cluster) * plan.cpb + j
            if c < co:
                p0 = rank * plan.length
                yield b, c, p0, max(0, min(plan.length, hw - p0))


@pytest.mark.parametrize("shape", sorted(set(DEN_SITES + ODD + WIDE)),
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_every_pixel_once(shape):
    co, h, w = shape
    hw = h * w
    plan = tfb.dc_plan(co, hw)
    assert 1 <= plan.cluster <= 8 and plan.cpb in (1, 2, 4, 8)
    assert plan.cpb == 1 or plan.cluster == 1
    assert plan.length % 4 == 0 and plan.res % 4 == 0 and plan.res >= 4
    assert 1 <= plan.chunks <= 4 and plan.chunks <= max(1, plan.res // 2048)
    assert plan.blocks % plan.cluster == 0
    assert plan.smem == plan.cpb * 2 * plan.res * 4
    assert plan.smem <= SMEM_PER_BLOCK and plan.smem <= tfb.DC_SMEM
    seen = np.zeros((co, hw), np.int32)
    for _, c, p0, n in _slices(plan, co, hw):
        seen[c, p0:p0 + n] += 1
    assert (seen == 1).all()
    if shape in DEN_SITES:
        assert plan.res >= plan.length, plan      # every slice resident
    if shape in WIDE and h == 512 and co == 16:
        # 2 MB of g and out per channel: more than a cluster holds
        assert plan.res < plan.length
    assert tfb.dc_plan(co, hw) is plan          # cached per shape


def test_plan_fills_the_card_at_the_widest_site():
    """levels.0.up (16 x 256^2): clusters of 8, 64 KB resident a block, one
    wave; every 256^2 den site in at most one wave."""
    assert len(DEN_SITES) == 20
    plan = tfb.dc_plan(16, 256 * 256)
    assert plan.cluster == 8 and plan.smem == 64 * 1024
    assert plan.blocks <= SMS
    for co, h, w in DEN_SITES:
        assert tfb.dc_plan(co, h * w).blocks <= SMS


def _butterfly(v):
    """conv_tile.cuh::warp_sum: the xor shuffle tree, lane 0's result."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[lanes ^ off]
    return v[0]


def _thread_sums(x, threads):
    """Each thread's sum of its groups of four pixels u = t, t + threads,
    ..., each group's pixels in order (f32)."""
    pad = -len(x) % (4 * threads)
    groups = np.concatenate([x, np.zeros(pad, np.float32)]).reshape(
        -1, threads, 4)
    acc = np.zeros(threads, np.float32)
    for row in groups:
        for e in range(4):
            acc = acc + row[:, e]
    return acc


def emulate_dc(g, out, stats, gamma, beta, slope=0.2):
    """fused_bwd_dc_cluster_kernel's arithmetic at dc_plan's plan, in f32."""
    f32 = np.float32
    co, h, w = out.shape
    hw = h * w
    plan = tfb.dc_plan(co, hw)
    gt = tfb.DC_THREADS // plan.cpb
    g2, o2 = g.reshape(co, hw), out.reshape(co, hw)
    dconv = np.empty_like(g2)
    dgamma, dbeta = np.empty(co, f32), np.empty(co, f32)
    parts = {}                              # (channel, rank) -> (s1, s2)
    for b, c, p0, n in _slices(plan, co, hw):
        ga, be = gamma[c], beta[c]
        rg = f32(1) / (f32(1e-20) if abs(ga) < 1e-20 else ga)
        o, gv = o2[c, p0:p0 + n], g2[c, p0:p0 + n]
        m = o > 0
        xh = (np.where(m, o, o * f32(1 / slope)) - be) * rg
        gp = np.where(m, gv, f32(slope) * gv)
        sums = []
        for x in (gp, gp * xh):
            a = _thread_sums(x.astype(f32), gt)
            s = f32(0)
            for wi in range(gt // 32):       # the channel's warps in order
                s = s + _butterfly(a[32 * wi:32 * wi + 32])
            sums.append(s)
        parts[c, b % plan.cluster] = sums
    for c in range(co):
        s1 = s2 = f32(0)
        for r in range(plan.cluster):       # rank order
            s1, s2 = s1 + parts[c, r][0], s2 + parts[c, r][1]
        dgamma[c], dbeta[c] = s2, s1
        ga, be = gamma[c], beta[c]
        rg = f32(1) / (f32(1e-20) if abs(ga) < 1e-20 else ga)
        m = o2[c] > 0
        xh = (np.where(m, o2[c], o2[c] * f32(1 / slope)) - be) * rg
        gp = np.where(m, g2[c], f32(slope) * g2[c])
        m1, m2 = s1 * f32(1 / hw), s2 * f32(1 / hw)
        dconv[c] = (stats[c, 1] * ga) * ((gp - m1) - xh * m2)
    return dconv.reshape(co, h, w), dgamma, dbeta


def _dc_inputs(co, h, w, seed):
    """(g, out, stats, gamma, beta): out as a block output, lrelu(BN(x)),
    gamma of both signs (tests/test_torch_fused_block.py holds the safe
    reciprocal at gamma ~ 0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((co, h, w)).astype(np.float32)
    gamma = (rng.random(co) + 0.5).astype(np.float32) * rng.choice(
        [-1, 1], co).astype(np.float32)
    beta = rng.standard_normal(co).astype(np.float32)
    mu = x.mean(axis=(1, 2), dtype=np.float32)
    inv = (1 / np.sqrt(x.var(axis=(1, 2), dtype=np.float32) + 1e-5)).astype(
        np.float32)
    y = (x - mu[:, None, None]) * inv[:, None, None] * gamma[:, None, None] \
        + beta[:, None, None]
    out = np.where(y > 0, y, np.float32(0.2) * y).astype(np.float32)
    g = rng.standard_normal((co, h, w)).astype(np.float32)
    return g, out, np.stack([mu, inv], axis=1), gamma, beta


def _close(got, ref, name):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all(), name
    err = float(np.abs(got - ref).max())
    assert err <= TOL * float(np.abs(ref).max()), (name, err)


# clusters of 8 and 4 (levels.1.skip, levels.1.down2), 8 channels a block
# (levels.4.down2), and 8 a block with a ragged last block (36 channels);
# H a multiple of the JAX kernel's row tile TH
@pytest.mark.parametrize("shape", [(4, 128, 128), (32, 64, 64), (128, 8, 8),
                                   (36, 8, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_emulated_order_matches_plain_and_jax(shape):
    co, h, w = shape
    assert h % jfb.TH == 0
    plan = tfb.dc_plan(co, h * w)
    assert (plan.cluster > 1) != (plan.cpb > 1)
    g, out, stats, gamma, beta = _dc_inputs(co, h, w, seed=co + h)
    got = emulate_dc(g, out, stats, gamma, beta)
    plain = tfb.bwd_dc_plain(*map(torch.from_numpy,
                                  (g, out, stats, gamma, beta)))
    ref = jfb._bwd_dc_call(*map(jnp.asarray, (g, out, stats, gamma, beta)),
                           k=3, h=h, w=w, slope=0.2, eps=1e-5)
    for name, a, p, r in zip(("dconv", "dgamma", "dbeta"), got, plain, ref):
        _close(a, p.numpy(), name + " vs plain")
        _close(a, r, name + " vs jax")


def _body(src, signature):
    """The brace-balanced body that follows ``signature`` in ``src``."""
    i = src.index("{", src.index(signature))
    depth = 0
    for k in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[k], 0)
        if depth == 0:
            return src[i:k + 1]
    raise AssertionError(signature)


def test_source_is_one_cluster_launch_without_scratch():
    src = open(SRC).read()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    kern = _body(code, "fused_bwd_dc_cluster_kernel(")
    entry = _body(code, "int fused_block_bwd_dc(")
    for part in (kern, entry):
        assert "grid.sync" not in part and "this_grid" not in part
        assert "Cooperative" not in part and "launch_coop" not in part
        assert not re.search(r"atomic\w*\(", part)
    assert "bulk_load(" in kern and "map_shared_rank" in kern
    # the cluster barrier twice: every rank started, every push landed
    assert kern.count("cluster_wait()") == 2
    assert "grid_group" not in kern and "__threadfence" not in kern
    assert "launch_cluster(" in entry
    assert "fused_bwd_dc_kernel" not in code and "kDcPix" not in code
    wrapper = inspect.getsource(tfb.bwd_dc)
    assert len(re.findall(r"torch\.empty", wrapper)) == 2   # dc and dgb
