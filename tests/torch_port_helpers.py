"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: one numpy eps vector feeding both sides' whole-tree RT draw, fixed
tables for the other draws of a step (dropout masks, SGLD noise, mixture
draws), the small nets the port's tests run, and CPU emulations of the tensor-core
conv kernels' arithmetic (csrc/conv_mma.cuh): 3xTF32 products, the FULL
dx's indexing and split of K, the dw tile's staging and summation order."""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from mfvi_dip_mia_tpu.bayes import vi as jvi
from mfvi_dip_mia_tpu_torch.bayes import vi as tvi
from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf
from mfvi_dip_mia_tpu_torch.utils import bridge

TW = tcf.TILE_W

SMALL_NET = dict(pad="reflection", skip_n33d=[16, 32], skip_n33u=[16, 32],
                 skip_n11=4, num_scales=2, upsample_mode="bilinear")


def jax_eps_order(tree):
    """(sampled-leaf name, JAX shape) in the order jvi._collect_variational
    walks ``tree`` (its own dict order: a tree that came out of jit has
    sorted keys)."""
    order = []

    def rec(node, prefix):
        if jvi.is_variational_leaf(node):
            order.append((prefix + "w", tuple(node["w_mu"].shape)))
            if node.get("b_mu") is not None:
                order.append((prefix + "b", tuple(node["b_mu"].shape)))
            return
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{prefix}{k}.")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{prefix}{i}.")

    rec(tree, "")
    return order


def jax_sample_with_eps(params, eps, out_dtype=None):
    """vi.sample_mfvi_tree with a supplied eps vector in place of the
    normal draw (bayes/vi.py:109-134)."""
    pairs = jvi._collect_variational(params)
    mu = jnp.concatenate([m.reshape(-1) for m, _ in pairs])
    rho = jnp.concatenate([r.reshape(-1) for _, r in pairs])
    flat = mu + jax.nn.softplus(rho) * jnp.asarray(eps, mu.dtype)
    if out_dtype is not None:
        flat = flat.astype(out_dtype)
    offs = np.cumsum([0] + [m.size for m, _ in pairs])
    chunks = iter(flat[offs[i]:offs[i + 1]] for i in range(len(pairs)))

    def transform(leaf, _k):
        if not jvi.is_variational_leaf(leaf):
            return leaf
        out = {"w": next(chunks).reshape(leaf["w_mu"].shape)}
        out["b"] = (next(chunks).reshape(leaf["b_mu"].shape)
                    if leaf.get("b_mu") is not None else None)
        return out

    return jvi._map_conv_leaves(params, transform, jax.random.PRNGKey(0))


def eps_pair(jax_tree, port_params: tvi.FlatParams, seed=0):
    """One standard-normal eps, as the JAX vector (in ``jax_tree``'s walk
    order, HWIO kernels) and the port's (in its eps_order, OIHW)."""
    rng = np.random.default_rng(seed)
    eps = np.concatenate([rng.standard_normal(shape).astype(np.float32)
                          .reshape(-1)
                          for _, shape in jax_eps_order(jax_tree)])
    return eps, port_eps(jax_tree, port_params, eps)


def port_eps(jax_tree, port_params: tvi.FlatParams, eps) -> torch.Tensor:
    """The JAX eps vector ``eps`` (in ``jax_tree``'s walk order, HWIO
    kernels) as the port's (in its eps_order, OIHW)."""
    eps = np.asarray(eps, np.float32)
    by_name, off = {}, 0
    for name, shape in jax_eps_order(jax_tree):
        size = int(np.prod(shape))
        by_name[name] = eps[off:off + size].reshape(shape)
        off += size
    return torch.cat([bridge.leaf_from_jax(name, by_name[name]).reshape(-1)
                      for name, _ in tvi.eps_order(port_params)])


class MixtureTable:
    """One fixed scale-mixture draw per variational element, keyed by leaf
    name (as the JAX tree holds it): a component index drawn with weights
    ``pi`` and a standard normal, reused every step. JAX's
    vi._mixture_sample is replaced by ``jax_sample`` (the leaves of one KL
    come in jax_eps_order), the port's vi.mixture_draw by ``port_draw``
    (the same elements in the port's eps_order and layout)."""

    def __init__(self, jax_tree, port_params: tvi.FlatParams, seed, pi):
        rng = np.random.default_rng(seed)
        p = np.asarray(pi, np.float64) / np.sum(pi)
        self.order = jax_eps_order(jax_tree)
        self.by_name = {
            name: (rng.choice(len(p), size=shape, p=p),
                   rng.standard_normal(shape).astype(np.float32))
            for name, shape in self.order}
        port = [(bridge.leaf_from_jax(n, self.by_name[n][0]).long(),
                 bridge.leaf_from_jax(n, self.by_name[n][1]))
                for n, _ in tvi.eps_order(port_params)]
        self.comp = torch.cat([c.reshape(-1) for c, _ in port])
        self.z = torch.cat([z.reshape(-1) for _, z in port])
        self.jax_calls = 0

    def jax_sample(self, key, shape, loc, scale, pi):
        name, want = self.order[self.jax_calls % len(self.order)]
        self.jax_calls += 1
        assert tuple(shape) == want, (name, shape, want)
        comp, z = self.by_name[name]
        return (jnp.asarray(loc)[comp] + jnp.asarray(scale)[comp]
                * jnp.asarray(z))

    def port_draw(self, n, cum, generator):
        assert n == self.z.numel()
        return self.comp.to(cum.device), self.z.to(cum.device)


def dropout_kwargs(method, p):
    """The skip net's dropout keywords of ``method`` (problems.py:166-174):
    dropout2d on the down and up sites for mcd, none otherwise."""
    if method != "mcd":
        return {}
    return dict(dropout_mode_down="2d", dropout_p_down=p,
                dropout_mode_up="2d", dropout_p_up=p)


class MaskTable:
    """Fixed dropout2d keep masks, one per dropout call of a forward
    (``n_sites`` calls), drawn from numpy at the port's first forward (NCHW,
    (1, C, 1, 1)) in its call order, which the JAX net shares. With
    ``n_tables`` > 1 forward k takes table k % n_tables (the port's MC
    samples); a JAX trace reads the table ``jax_dropout2d`` names. The
    port's ``nn/layers.py::dropout_keep`` is replaced by ``port_keep``, the
    JAX op sets' ``dropout2d`` by ``jax_dropout2d``."""

    def __init__(self, seed, n_sites, n_tables=1, keep=0.6):
        self.rng = np.random.default_rng(seed)
        self.n_sites, self.n_tables, self.keep = n_sites, n_tables, keep
        self.masks = [[] for _ in range(n_tables)]
        self.port_calls = 0

    def port_keep(self, shape, keep_prob, generator):
        forward, site = divmod(self.port_calls, self.n_sites)
        table = self.masks[forward % self.n_tables]
        self.port_calls += 1
        if len(table) == site:
            table.append(self.rng.uniform(size=tuple(shape)) < self.keep)
        assert table[site].shape == tuple(shape), (site, shape)
        return torch.from_numpy(table[site])

    def jax_dropout2d(self, table=0, channels_last=True):
        calls = [0]

        def dropout2d(x, p, key):
            keep = self.masks[table][calls[0] % self.n_sites]
            calls[0] += 1
            if channels_last:
                keep = keep.transpose(0, 2, 3, 1)
            return jnp.where(jnp.asarray(keep), x / (1.0 - p), 0.0)

        return dropout2d


def jax_leaf_name(path) -> str:
    """A jax tree path as the port's leaf name ('levels.0.down1.conv.w')."""
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


class NoiseTable:
    """One fixed standard-normal SGLD parameter noise per conv kernel, keyed
    by leaf name (HWIO, as the JAX tree holds it), reused every step: the
    JAX trainer's add_param_noise is replaced by ``jax_add_param_noise``,
    the port's ``optim/sgld.py::param_noise_eps`` by ``port_eps`` of the
    port's buffer layout."""

    def __init__(self, jax_tree, seed):
        rng = np.random.default_rng(seed)
        self.by_name = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(jax_tree)[0]:
            if np.ndim(leaf) == 4:
                self.by_name[jax_leaf_name(path)] = rng.standard_normal(
                    np.shape(leaf)).astype(np.float32)

    def jax_add_param_noise(self, params, key, sigma, lr):
        def add(path, p):
            if p.ndim != 4:
                return p
            eps = jnp.asarray(self.by_name[jax_leaf_name(path)])
            return p + eps * sigma * lr
        return jax.tree_util.tree_map_with_path(add, params)

    def port_eps(self, port_params: tvi.FlatParams):
        eps = torch.cat([bridge.leaf_from_jax(n, self.by_name[n]).reshape(-1)
                         for n, s in zip(port_params.names,
                                         port_params.shapes) if len(s) == 4])

        def param_noise_eps(n, generator):
            assert n == eps.numel()
            return eps
        return param_noise_eps


def rel(got, ref):
    """max |got - ref| over max |ref|."""
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


# -- 3xTF32 ----------------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round to nearest, ties away
    from zero (on the magnitude bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    # the kernel's order: a_lo b_hi, a_hi b_lo, then a_hi b_hi, in f32
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def matmul_3xtf32_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return matmul_3xtf32(torch.from_numpy(np.ascontiguousarray(a)),
                         torch.from_numpy(np.ascontiguousarray(b))).numpy()


# -- the FULL dx -------------------------------------------------------------------

def full_dx_indexed(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's FULL form in plain torch: out[i, y, x] = sum_{o, ky, kx}
    w[o, i, k-1-ky, k-1-kx] * g[o, y + ky - (k-1), x + kx - (k-1)], g read
    only inside its bounds (no padded copy), w as stored."""
    o_ch, i_ch, k, _ = w.shape
    _, h, wd = g.shape
    out = torch.zeros((i_ch, h + k - 1, wd + k - 1), dtype=torch.float64)
    gd, wdd = g.double(), w.double()
    for ky in range(k):
        for kx in range(k):
            wt = wdd[:, :, k - 1 - ky, k - 1 - kx].T          # (I, O)
            # output rows y whose source row y + ky - (k-1) lies in g
            y_lo, x_lo = k - 1 - ky, k - 1 - kx
            out[:, y_lo:y_lo + h, x_lo:x_lo + wd] += torch.einsum(
                "io,ohw->ihw", wt, gd)
    return out.float()


def emulate_full_dx(g: np.ndarray, w: np.ndarray, plan) -> np.ndarray:
    """The FULL dx as conv_mma.cuh computes it under ``plan`` (a
    tcf.TilePlan of the (I, H+k-1, W+k-1) output from the O channels of g),
    in f32: each cluster rank walks its K chunks (8 channels of g) in order,
    per chunk the taps (ky, kx) in order, each an f32 accumulation of a
    3xTF32 product of the flipped, transposed weight with g shifted by the
    tap (zero outside g: the virtual halo); the leader then adds the ranks'
    partial tiles in rank order. The M / N tiling does not change any
    element's arithmetic, so all tiles run at once."""
    o_ch, i_ch, k, _ = w.shape
    _, h, wd = g.shape
    ho, wo = h + k - 1, wd + k - 1
    c = tcf.chunk_channels(torch.float32)
    gz = np.zeros((plan.chunks * c, h + 2 * (k - 1), wd + 2 * (k - 1)),
                  np.float32)
    gz[:o_ch, k - 1:k - 1 + h, k - 1:k - 1 + wd] = g
    wz = np.zeros((plan.chunks * c, i_ch, k, k), np.float32)
    wz[:o_ch] = w
    total = None
    for rank in range(plan.split):
        acc = np.zeros((i_ch, ho * wo), np.float32)
        for ch in plan.chunks_of(rank):
            sl = slice(ch * c, (ch + 1) * c)
            for ky in range(k):
                for kx in range(k):
                    wt = wz[sl, :, k - 1 - ky, k - 1 - kx].T    # (I, 8)
                    src = gz[sl, ky:ky + ho, kx:kx + wo].reshape(c, -1)
                    acc = acc + matmul_3xtf32_np(wt, src)
        total = acc if total is None else total + acc
    return total.reshape(i_ch, ho, wo)


# -- the dw tile -------------------------------------------------------------------

def assert_dw_covers(p, o, i, k, h, w):
    """Assert that dw plan p covers (o, i, k, h, w) once."""
    assert p.o_tiles * p.bo >= o > (p.o_tiles - 1) * p.bo
    assert p.c_tiles * p.bc >= i > (p.c_tiles - 1) * p.bc
    assert p.tap_groups * p.tap_rows == k
    assert p.tap_rows == (k if k <= 3 else 1)
    tiles_x = -(-w // TW)
    assert p.pixel_tiles == -(-h // tcf.DW_ROWS) * tiles_x
    cover = np.zeros((h, w), np.int64)
    seen = []
    for s in range(p.split):
        mine = list(p.pixel_tiles_of(s))
        assert mine, (s, p)                     # every split has work
        seen += mine
        for pt in mine:
            y0, x0 = (pt // tiles_x) * tcf.DW_ROWS, (pt % tiles_x) * TW
            cover[y0:y0 + tcf.DW_ROWS, x0:x0 + TW] += 1
    assert sorted(seen) == list(range(p.pixel_tiles))
    assert (cover == 1).all()
    assert 1 <= p.cluster <= tcf.MAX_SPLIT and p.split % p.cluster == 0
    assert p.groups == 1 or p.cluster == tcf.MAX_SPLIT
    wm, wn, _ = tcf.DW_TILES[p.tile]
    assert (p.bo, p.bc) == (16 * wm, 16 * wn)
    assert p.partial_floats(k) == (0 if p.groups == 1 else
                                   p.tiles * p.groups * p.bo * p.bc
                                   * p.tap_rows * k)


def slab_row(r: int, j: int, ky: int, kx: int, k: int) -> int:
    """The slab row that the B operand of tap (ky, kx) reads for pixel (row
    r, column j) of a pixel tile (conv_mma.cuh, dw_tile_mma)."""
    return (r + ky) * (TW + k - 1) + kx + j


def emulate_dw(xp: np.ndarray, g: np.ndarray, k: int, p,
               matmul=np.matmul) -> np.ndarray:
    """cf_conv_dw as the kernel computes it, in f32: per output tile and
    split, each staged pixel tile's products (``matmul``: f32, or
    ``matmul_3xtf32_np`` for the f32 kernel's 3xTF32) by pixel row into the
    row's warp (row r to warp r % WK), then the WK warps, the cluster's
    ranks and the groups of clusters summed in order."""
    i_ch, hp, wp = xp.shape
    o_ch, h, w = g.shape
    _, _, wk = tcf.DW_TILES[p.tile]
    rows, kyb = tcf.DW_ROWS, p.tap_rows
    sh, sw = rows + kyb - 1, TW + k - 1
    tiles_x = -(-w // TW)
    # the tensors zero-extended: the staging's zero fill outside them
    xz = np.zeros((p.c_tiles * p.bc, hp + rows + k, wp + TW + k), np.float32)
    xz[:i_ch, :hp, :wp] = xp
    gz = np.zeros((p.o_tiles * p.bo, h + rows, w + TW), np.float32)
    gz[:o_ch, :h, :w] = g
    out = np.zeros((p.o_tiles * p.bo, p.c_tiles * p.bc, k, k), np.float32)
    for ot in range(p.o_tiles):
        for ct in range(p.c_tiles):
            for tg in range(p.tap_groups):
                o0, c0, ky0 = ot * p.bo, ct * p.bc, tg * kyb
                sums = []
                for s in range(p.split):
                    part = np.zeros((wk, p.bo, p.bc, kyb, k), np.float32)
                    for pt in p.pixel_tiles_of(s):
                        y0, x0 = (pt // tiles_x) * rows, (pt % tiles_x) * TW
                        # slab[sy * sw + sx][c], channels-last
                        slab = xz[c0:c0 + p.bc, y0 + ky0:y0 + ky0 + sh,
                                  x0:x0 + sw].reshape(p.bc, sh * sw).T
                        gt = gz[o0:o0 + p.bo, y0:y0 + rows, x0:x0 + TW]
                        for r in range(rows):
                            for ky in range(kyb):
                                for kx in range(k):
                                    q = [slab_row(r, j, ky, kx, k)
                                         for j in range(TW)]
                                    part[r % wk, :, :, ky, kx] += matmul(
                                        gt[:, r, :], slab[q])
                    block = part[0]
                    for wi in range(1, wk):
                        block = block + part[wi]
                    sums.append(block)
                # a cluster's ranks into its leader, then the groups
                leaders = []
                for grp in range(p.groups):
                    lead = sums[grp * p.cluster]
                    for rank in range(1, p.cluster):
                        lead = lead + sums[grp * p.cluster + rank]
                    leaders.append(lead)
                tot = leaders[0]
                for lead in leaders[1:]:
                    tot = tot + lead
                out[o0:o0 + p.bo, c0:c0 + p.bc, ky0:ky0 + kyb] = tot
    return out[:o_ch, :i_ch]
