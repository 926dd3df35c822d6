"""The parts of the row split (mfvi_dip_mia_tpu_torch/nn/sp.py) against
their unsplit ops, on a mesh that names the CPU n times: the halo slab
against the padded image's rows (every shard count, kernel size, pad mode
and stride, halos that span one and two neighbours), gather / split, the
BatchNorm with the whole's moments, the x2 upsample, the Lanczos pool's
band, the dropout draws; then the whole skip net, split against unsplit,
with the same weights and draws (forward <= 1e-5, flat gradient <= 1e-4,
both relative to the largest magnitude): JAX's 2-scale 64^2 test net
(tests/test_sharding.py::_tiny_den_problem's), its pooled (avg, lanczos2),
mcd and LRT variants, and a k5 no-skip net (the inp net's structure) whose
deepest halos span two shards. Copies must be exact; sums agree to 1e-6
relative (the same f32 terms in another order)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mfvi_dip_mia_tpu_torch.bayes import vi as tvi
from mfvi_dip_mia_tpu_torch.nn import build_skip_net, layers, sp
from mfvi_dip_mia_tpu_torch.nn.skip import SkipNet
from mfvi_dip_mia_tpu_torch.ops.downsampler import Downsampler
from mfvi_dip_mia_tpu_torch.ops.kernels.cf_conv import conv2d_cf

torch.set_num_threads(1)

TINY_NET = dict(pad="reflection", skip_n33d=[8, 16], skip_n33u=[8, 16],
                skip_n11=4, num_scales=2, upsample_mode="bilinear")


def _split(n, height, scales=0):
    return sp.RowSplit.of(["cpu"] * n, height, scales)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _grad_of(fn, x, seed=0):
    """d/dx of sum(fn(x) * g) for a fixed random g of fn(x)'s shape."""
    x = x.clone().requires_grad_(True)
    out = fn(x)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed))
    (out * g).sum().backward()
    return out.detach(), x.grad


# (n_sp, rows a shard, k, stride): 1-row shards give a k5 halo across two
# neighbours; a stride-2 slab needs an even shard
HALO_CASES = [(n, rows, k, stride)
              for n in (2, 4, 8) for rows in (1, 2, 8) for k in (1, 3, 5)
              for stride in (1, 2)
              if not (stride == 2 and rows % 2) and n * rows > (k - 1) // 2]


@pytest.mark.parametrize("pad_mode", ["reflection", "zero"])
@pytest.mark.parametrize("n,rows,k,stride", HALO_CASES)
def test_halo_slab_is_the_padded_rows(n, rows, k, stride, pad_mode):
    """Each shard's slab equals the padded image's rows its output reads,
    bit for bit; the VALID conv of the slabs gathered equals the padded
    conv; the slabs' gradient equals the padded rows' gradient."""
    height, width, p = n * rows, 7, (k - 1) // 2
    split = _split(n, height)
    x = torch.randn(1, 3, height, width,
                    generator=torch.Generator().manual_seed(n * 100 + k))
    b = split.at(0)
    r_bottom = k - p - stride

    def whole(t):
        if not p:
            return t
        mode = "reflect" if pad_mode == "reflection" else "constant"
        return F.pad(t, (p,) * 4, mode=mode)

    def ref_rows(t):
        padded = whole(t)
        return torch.cat([padded[:, :, b[i]:b[i + 1] + p + r_bottom]
                          for i in range(n)], dim=2)

    def slabs(t):
        return torch.cat(sp.halo_slab(sp.slice_rows(t, b, split.devices), b,
                                      p, r_bottom, pad_mode, p), dim=2)

    want, want_dx = _grad_of(ref_rows, x)
    got, got_dx = _grad_of(slabs, x)
    assert torch.equal(got, want)
    assert _rel(got_dx, want_dx) <= 1e-6

    w = torch.randn(4, 3, k, k, generator=torch.Generator().manual_seed(k))
    conv_whole = conv2d_cf(x, w, None, stride, p, pad_mode)
    shards = sp.halo_slab(sp.slice_rows(x, b, split.devices), b, p,
                          r_bottom, pad_mode, p)
    conv_split = torch.cat([conv2d_cf(s, w, None, stride, 0) for s in shards],
                           dim=2)
    assert conv_split.shape == conv_whole.shape
    assert _rel(conv_split, conv_whole) <= 1e-6


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_split_and_gather_rows(n):
    split = _split(n, 32, 2)
    x = torch.randn(1, 5, 32, 9, generator=torch.Generator().manual_seed(n))
    out, dx = _grad_of(lambda t: sp.gather_rows(sp.split_rows(t, split),
                                                "cpu") * 2.0, x)
    assert torch.equal(out, x * 2.0)
    _, want = _grad_of(lambda t: t * 2.0, x)
    assert torch.equal(dx, want)
    assert [s.shape[2] for s in sp.split_rows(x, split, 1)] == [16 // n] * n


@pytest.mark.parametrize("n,height", [(2, 64), (4, 64), (8, 64), (8, 16),
                                      (4, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_with_the_whole_moments(n, height, dtype):
    """Shards of 1-32 rows: the shift spans shards below 8 rows a shard."""
    split = _split(n, height)
    gen = torch.Generator().manual_seed(height + n)
    x = (torch.randn(1, 6, height, 11, generator=gen) * 3 + 5).to(dtype)
    scale = torch.rand(6, generator=gen) + 0.5
    offset = torch.randn(6, generator=gen)
    b = split.at(0)
    want, want_dx = _grad_of(
        lambda t: layers.batch_norm_train(t, scale, offset).float(), x)
    got, got_dx = _grad_of(lambda t: sp.gather_rows(sp.batch_norm_train_sp(
        sp.slice_rows(t, b, split.devices), b, scale, offset), "cpu").float(),
        x)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    assert _rel(got, want) <= tol
    assert _rel(got_dx, want_dx) <= (1e-5 if dtype == torch.float32
                                     else 2e-2)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("n,rows", [(2, 4), (4, 2), (8, 1), (8, 4)])
def test_upsample2x_on_shards(mode, n, rows):
    height = n * rows
    split = _split(n, height)
    x = torch.randn(1, 4, height, 10,
                    generator=torch.Generator().manual_seed(rows))
    b = split.at(0)
    want, want_dx = _grad_of(lambda t: layers.upsample2x(t, mode), x)
    got, got_dx = _grad_of(lambda t: sp.gather_rows(sp.upsample2x_sp(
        sp.slice_rows(t, b, split.devices), b, mode), "cpu"), x)
    assert _rel(got, want) <= 1e-6
    assert _rel(got_dx, want_dx) <= 1e-6


@pytest.mark.parametrize("kind", ["lanczos2", "lanczos3"])
@pytest.mark.parametrize("n,rows", [(2, 8), (4, 4), (8, 2)])
def test_lanczos_pool_on_shards(kind, n, rows):
    """The pool's halo (3-5 rows at factor 2) spans up to three shards."""
    height = n * rows
    split = _split(n, height, 1)
    ds = Downsampler(4, 2, kind, phase=0.5, preserve_size=True)
    x = torch.randn(1, 4, height, 12,
                    generator=torch.Generator().manual_seed(n))
    b_in, b_out = split.at(0), split.at(1)

    def split_pool(t):
        shards = sp.slice_rows(t, b_in, split.devices)
        return sp.gather_rows(sp.rows_by_matrix(
            shards, b_in, b_out,
            lambda r0, r1, dev: ds.band(height, r0, r1, dev),
            ds.matrices(height, 12, "cpu")[1]), "cpu")

    want, want_dx = _grad_of(ds, x)
    got, got_dx = _grad_of(split_pool, x)
    assert _rel(got, want) <= 1e-6
    assert _rel(got_dx, want_dx) <= 1e-6


@pytest.mark.parametrize("channels", [False, True])
def test_dropout_draws_the_whole_mask(channels):
    split = _split(4, 16)
    x = torch.randn(1, 5, 16, 6, generator=torch.Generator().manual_seed(3))
    b = split.at(0)
    drop = layers.dropout2d if channels else layers.dropout
    want = drop(x, 0.3, torch.Generator().manual_seed(7))
    got = sp.gather_rows(sp.dropout_sp(sp.slice_rows(x, b, split.devices), b,
                                       0.3, torch.Generator().manual_seed(7),
                                       channels), "cpu")
    assert torch.equal(got, want)


def _net_case(variant):
    """(net, params, input) of the split-net cases."""
    gen = torch.Generator().manual_seed(1)
    if variant == "k5 no-skip":
        net = SkipNet(num_input_channels=4, num_output_channels=4,
                      num_channels_down=[4] * 5, num_channels_up=[4] * 5,
                      num_channels_skip=[0] * 5, filter_size_down=5,
                      filter_size_up=3, need1x1_up=False,
                      upsample_mode="nearest", pad="reflection",
                      need_sigmoid=False)
        x = torch.randn(1, 4, 128, 128, generator=gen)
        return net, net.init_params(gen), x
    kw = dict(TINY_NET)
    if variant in ("avg", "lanczos2"):
        kw["downsample_mode"] = variant
    if variant == "mcd":
        kw.update(dropout_mode_down="2d", dropout_p_down=0.3,
                  dropout_mode_up="2d", dropout_p_up=0.3)
    net = build_skip_net(8, n_channels=2, **kw)
    params = net.init_params(gen)
    if variant == "lrt":
        params = tvi.to_mfvi(params, gen)
    return net, params, torch.randn(1, 8, 64, 64, generator=gen)


NET_CASES = [(v, n) for v in ("stride", "avg", "lanczos2", "mcd", "lrt")
             for n in (2, 8)] + [("k5 no-skip", 2), ("k5 no-skip", 4)]


@pytest.mark.parametrize("variant,n", NET_CASES)
def test_split_net_matches_unsplit(variant, n):
    """The same weights, input and generator seed (so the same draws: RT,
    dropout masks, LRT noise) through the net whole and split n ways."""
    net, params, x = _net_case(variant)
    reparam = "lrt" if variant == "lrt" else "rt"

    def run(split):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        out = net(leaves, x, torch.Generator().manual_seed(5),
                  reparam=reparam, split=split)
        g = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
        (out * g).sum().backward()
        return out.detach(), torch.cat([
            (t.grad if t.grad is not None else torch.zeros_like(t))
            .reshape(-1) for t in leaves.values()])

    out, grad = run(None)
    out_sp, grad_sp = run(_split(n, x.shape[2], net.n_scales))
    assert out_sp.shape == out.shape
    assert _rel(out_sp, out) <= 1e-5
    assert _rel(grad_sp, grad) <= 1e-4
    assert grad.abs().max() > 0


def test_bad_splits_raise():
    net, params, x = _net_case("stride")
    with pytest.raises(ValueError, match="does not divide"):
        sp.RowSplit.of(["cpu"] * 3, 64, 2)
    with pytest.raises(ValueError, match="multiple of 4"):
        sp.RowSplit.of(["cpu"] * 32, 64, 2)
    with pytest.raises(ValueError, match="multiple of 4"):
        net(params, x, split=sp.RowSplit(("cpu",) * 32,
                                         tuple(range(0, 66, 2))))
    with pytest.raises(ValueError, match="of 32 rows for an input of 64"):
        net(params, x, split=_split(2, 32, 2))
    with pytest.raises(ValueError, match="one height"):
        layers.concat_center_crop([x[:, :, :4], x[:, :, :6]],
                                  rows_split=True)
    assert np.array_equal(_split(4, 64, 2).at(2), (0, 4, 8, 12, 16))
