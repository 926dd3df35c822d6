"""The tensor-core conv kernels' design, held on the CPU before any card runs
it (csrc/conv_mma.cuh: ``cf_conv_fwd`` forward and FULL dx, ``lrt_conv_fwd``).

(a) The tile plan (ops/kernels/cf_conv.py::tile_plan) of every conv site of
    chip_smoke.py's 5-scale 256^2 nets, forward and dx: each output pixel,
    output channel and K chunk is covered exactly once, a cluster holds at
    most 8 blocks, and a launch has at least min(132, tiles at the smallest
    tile) blocks.
(b) The 3xTF32 product the f32 kernels run, emulated in torch (TF32 = f32
    rounded to a 10-bit mantissa, nearest, ties away from zero): at the
    widest site's K = 132 * 9 it meets f32 accuracy against an f64
    reference, and one TF32 pass does not.
(c) The FULL dx indexing (a virtual zero halo around the unpadded cotangent,
    the forward weight read flipped and I/O-transposed) written as plain
    torch, against the port's ``conv_dx_plain`` and the JAX Pallas conv's
    VJP (interpret mode), at k in {1, 2, 3, 5}.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import chip_smoke
from mfvi_dip_mia_tpu.ops.pallas import cf_conv as jcf
from mfvi_dip_mia_tpu_torch.nn import build_skip_net
from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf
from torch_port_helpers import full_dx_indexed, matmul_3xtf32, tf32

torch.set_num_threads(1)


def _sites(n_out):
    net = build_skip_net(16, n_channels=n_out, pad="reflection",
                         skip_n33d=[16, 32, 64, 128, 128],
                         skip_n33u=[16, 32, 64, 128, 128], skip_n11=4,
                         num_scales=5, upsample_mode="bilinear")
    return chip_smoke.conv_sites(net, 256)


def _launches(n_out):
    """(name, h_out, w_out, n, i, k) of every launch of the net's step:
    each site's forward and, where its input needs one, its FULL dx."""
    out = []
    for s in _sites(n_out):
        i, hp, wp = s["xp"]
        o, _, k, _ = s["w"]
        out.append((s["name"], hp - k + 1, wp - k + 1, o, i, k))
        if s["needs_dx"]:
            out.append((s["name"] + " dx", hp, wp, i, o, k))
    return out


# -- (a) the tile plan ---------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_out,n_weights", [(1, 1), (2, 1), (2, 2)])
def test_tile_plan_covers_every_site_once_and_fills_the_card(dtype, n_out,
                                                              n_weights):
    """n_weights 2: the LRT double conv's forward at the den net's sites."""
    c = tcf.chunk_channels(dtype)
    smallest = min(range(len(tcf.TILES)), key=lambda t: tcf.TILES[t][0]
                   * tcf.TILES[t][1])
    for name, h, w, n, i, k in _launches(n_out):
        if n_weights == 2 and name.endswith(" dx"):
            continue
        p = tcf.tile_plan(h, w, n, i, dtype, k, n_weights)
        bm, bn = tcf.TILES[p.tile]
        assert (p.rows, p.bn) == (bm // tcf.TILE_W, bn)
        assert bn <= max(16, n), name
        # M: the kernel's (row tile, column tile) of blockIdx.y
        tiles_x = -(-w // tcf.TILE_W)
        assert p.m_tiles == -(-h // p.rows) * tiles_x
        cover = np.zeros((h, w), np.int64)
        for my in range(p.m_tiles):
            y0, x0 = (my // tiles_x) * p.rows, (my % tiles_x) * tcf.TILE_W
            cover[y0:y0 + p.rows, x0:x0 + tcf.TILE_W] += 1
        assert (cover == 1).all(), name
        # N
        n_cover = np.zeros(n, np.int64)
        for nz in range(p.n_tiles):
            n_cover[nz * bn:(nz + 1) * bn] += 1
        assert (n_cover == 1).all(), name
        # K: the chunks of the cluster's ranks
        assert p.chunks == -(-i // c) and (p.chunks - 1) * c < i <= p.chunks * c
        seen = [ch for r in range(p.split) for ch in p.chunks_of(r)]
        assert sorted(seen) == list(range(p.chunks)), name
        assert all(len(p.chunks_of(r)) > 0 for r in range(p.split))
        assert 1 <= p.split <= tcf.MAX_SPLIT
        # grid fill
        least = tcf._plan(smallest, 1, h, w, n, p.chunks).ctas
        assert p.ctas >= min(tcf.SMS, least), (name, p)


def test_deep_sites_split_k_across_a_cluster():
    """Where the smallest tile leaves the card mostly idle, the plan splits
    K, and the widest sites' f32 forwards launch about one block per SM or
    more (128 blocks count: the cost model weighs 128 and 132 alike)."""
    plans = {name: tcf.tile_plan(h, w, n, i, torch.float32, k)
             for name, h, w, n, i, k in _launches(1)}
    assert plans["levels.4.up"].split > 1
    assert plans["levels.4.down2"].split > 1
    assert plans["levels.3.up"].ctas >= 128
    assert plans["levels.2.up"].ctas >= 128
    assert max(p.split for p in plans.values()) <= tcf.MAX_SPLIT


# -- (b) 3xTF32 ----------------------------------------------------------------

def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12], dtype=torch.float32)
    got = tf32(x).tolist()
    assert got == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                   -(1.0 + 2.0 ** -10), 1.0]


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_meets_f32_accuracy_at_the_widest_site(seed):
    """K = 132 * 9 (levels.2-4 up): im2col rows of a unit-normal input
    against a 1/sqrt(K)-scaled weight, as chip_smoke.py draws them; and the
    squares of the input against a positive weight (the LRT variance)."""
    k = 132 * 9
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((256, k)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((k, 64)) / k ** 0.5
                          ).astype(np.float32))
    b_var = torch.from_numpy((rng.random((k, 64)) * 0.01).astype(np.float32))
    for lhs, rhs in ((a, b), (a * a, b_var)):
        ref = lhs.double() @ rhs.double()
        scale = float(ref.abs().max())
        err3 = float((matmul_3xtf32(lhs, rhs).double() - ref).abs().max())
        err1 = float((tf32(lhs) @ tf32(rhs)).double().sub(ref).abs().max())
        assert err3 / scale < 1e-5
        assert err1 / scale > 1e-5       # one TF32 pass would not do
        assert err1 > 30 * err3


# -- (c) the FULL dx indexing ----------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_full_dx_indexing_matches_the_plain_dx_and_jax(k):
    rng = np.random.default_rng(10 + k)
    i_ch, o_ch, hp, wp = 6, 5, 14, 19
    xp = rng.standard_normal((i_ch, hp, wp)).astype(np.float32)
    w = (rng.standard_normal((o_ch, i_ch, k, k)) * 0.2).astype(np.float32)
    g = rng.standard_normal((o_ch, hp - k + 1, wp - k + 1)).astype(np.float32)
    got = full_dx_indexed(torch.from_numpy(g), torch.from_numpy(w)).numpy()
    plain = tcf.conv_dx_plain(torch.from_numpy(g), torch.from_numpy(w)).numpy()
    w_hwio = jnp.asarray(w.transpose(2, 3, 1, 0))
    _, vjp = jax.vjp(lambda x: jcf.conv_valid_cf(x, w_hwio, (k, k)),
                     jnp.asarray(xp))
    (ref,) = vjp(jnp.asarray(g))
    ref = np.asarray(ref)
    assert got.shape == plain.shape == ref.shape == xp.shape
    # f32 sums of <= 5 * 25 products in other orders
    scale = np.abs(ref).max()
    assert np.abs(got - plain).max() / scale < 1e-5
    assert np.abs(got - ref).max() / scale < 1e-5
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(tcf.conv_dx(torch.from_numpy(g), torch.from_numpy(w)),
                       torch.from_numpy(plain))
