"""The dense Radon kernels' persistent-grid plan
(mfvi_dip_mia_tpu_torch/ops/kernels/radon_dense.py::dense_plan,
csrc/radon_dense.cu), on the CPU: the plan cuts A into equal shares that
cover every element once, and a numpy emulation of the adjoint kernel's
walk of the plan (its tiles' rows in order, its scratch slots, each
strip's splits summed in split order, each image column in turn) agrees
with the plain version and with the VJP of the JAX package's
``radon_apply_pallas``: a check of the plan's coverage and of the order
the kernel sums in, not of the kernel."""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import mfvi_dip_mia_tpu.ops.radon as jradon
from mfvi_dip_mia_tpu.ops.pallas import radon_kernel as jrk
import mfvi_dip_mia_tpu_torch.ops.radon as tradon
from mfvi_dip_mia_tpu_torch.ops.kernels import radon_dense as trd

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "mfvi_dip_mia_tpu_torch", "csrc", "radon_dense.cu")

# 64^2 at 8 angles: A (512, 4096), as tests/test_torch_radon_dense.py runs
# the JAX VJP (H*W a multiple of 2048, T*W of 256)
S = 64
THETA = np.arange(0.0, 180.0, 22.5).astype(np.float32)
# f32 sums of the same products in another order, as a share of the
# reference's largest magnitude
REL = 1e-5


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.max(np.abs(got - ref)))
    assert err <= rel * float(np.max(np.abs(ref))), err


# -- the partition --------------------------------------------------------------

@pytest.mark.parametrize("n_sm", [132, 114, 1])
@pytest.mark.parametrize("angles", [45, 180])
@pytest.mark.parametrize("size", [32, 64, 256, 512])
def test_plan_covers_a_once_in_equal_shares(size, angles, n_sm):
    """The plan does not depend on the image columns: the kernels walk it
    once per column."""
    p, q = angles * size, size * size
    plan = trd.dense_plan(p, q, trd.BLOCKS_PER_SM * n_sm)

    # forward: whole rows, contiguous, each block within one row of P / nb
    nf = plan.fwd_blocks
    assert 1 <= nf <= min(p, trd.BLOCKS_PER_SM * n_sm)
    rows = np.array(plan.rows)
    assert rows[0] == 0 and rows[-1] == p and len(rows) == nf + 1
    assert set(np.diff(rows)) <= {p // nf, -(-p // nf)}

    # adjoint: strips of <= 1024 columns (multiples of 8) cover Q once
    assert plan.strip % 8 == 0 and 8 <= plan.strip <= 1024
    assert (plan.n_strips - 1) * plan.strip < q <= plan.n_strips * plan.strip
    na = plan.adj_blocks
    assert 1 <= na <= trd.BLOCKS_PER_SM * n_sm
    ptr = np.array(plan.tile_ptr)
    assert ptr[0] == 0 and ptr[-1] == len(plan.tiles) and len(ptr) == na + 1
    assert (np.diff(ptr) >= 1).all()
    # each strip's tiles, in split order, cover rows 0..P once
    by_strip = {}
    for t, (s, p0, p1, split, n_split) in enumerate(plan.tiles):
        by_strip.setdefault(s, []).append((p0, p1, split, n_split, t))
    assert sorted(by_strip) == list(range(plan.n_strips))
    for s, ts in by_strip.items():
        assert [t[2] for t in ts] == list(range(len(ts)))
        assert {t[3] for t in ts} == {len(ts)}
        assert ts[0][0] == 0 and ts[-1][1] == p
        assert all(a[1] == b[0] for a, b in zip(ts, ts[1:]))
        assert all(p0 < p1 for p0, p1, *_ in ts)
        # split k of a strip is tile (first + k): the kernel's partial slots
        assert [t[4] for t in ts] == list(range(ts[0][4], ts[0][4] + len(ts)))
    # each block's (strip, row) units within one of its equal share
    units = p * plan.n_strips
    per_block = [sum(p1 - p0 for _, p0, p1, _, _ in plan.tiles[a:b])
                 for a, b in zip(ptr, ptr[1:])]
    assert sum(per_block) == units
    assert set(per_block) <= {units // na, -(-units // na)}


def test_plan_at_the_path_shape():
    """256^2 / 45 angles on 132 SMs: 264 blocks for both kernels, every
    strip of 1024 columns cut into 5 splits; 228 blocks on 114 SMs."""
    plan = trd.dense_plan(11520, 65536, 264)
    assert (plan.fwd_blocks, plan.adj_blocks) == (264, 264)
    assert (plan.strip, plan.n_strips, len(plan.tiles)) == (1024, 64, 320)
    assert {t[4] for t in plan.tiles} == {5}
    assert trd.dense_plan(11520, 65536, 228).adj_blocks == 228
    assert trd.dense_plan(8, 64, 264).fwd_blocks == 8    # one row a block
    with pytest.raises(ValueError):
        trd.dense_plan(64, 100, 264)                # Q % 8 != 0


# -- the adjoint's walk of the plan ------------------------------------------

def emulate_adj(a: np.ndarray, g: np.ndarray, plan) -> np.ndarray:
    """radon_dense_adj_kernel's walk: for each image column, each tile sums
    its rows in row order (f32) and, where its strip has several splits,
    stores its partial at slot (column, tile); the strip's last split sums
    the slots from its split 0 (tile t - split) in split order."""
    p, q = a.shape
    cols, n_tiles = g.shape[0], len(plan.tiles)
    scratch = np.full((cols * n_tiles, plan.strip), np.nan, np.float32)
    out = np.full((cols, q), np.nan, np.float32)
    for c in range(cols):
        for t, (s, p0, p1, split, n_split) in enumerate(plan.tiles):
            q0, q1 = s * plan.strip, min(q, (s + 1) * plan.strip)
            acc = np.zeros(q1 - q0, np.float32)
            for r in range(p0, p1):
                acc = acc + g[c, r] * a[r, q0:q1]
            if n_split > 1:
                scratch[c * n_tiles + t, :q1 - q0] = acc
                if split < n_split - 1:
                    continue   # the same sum, whichever split ends last
                first = c * n_tiles + t - split
                acc = scratch[first, :q1 - q0]
                for k in range(1, n_split):
                    acc = acc + scratch[first + k, :q1 - q0]
            out[c, q0:q1] = acc
    return out


@pytest.fixture(scope="module")
def matrix():
    a_t = tradon.dense_matrix_bf16(THETA, S, S, "cpu")
    return a_t, a_t.float().numpy()


@pytest.mark.parametrize("n_sm,cols", [(132, 1), (114, 3), (1, 1)])
def test_adjoint_split_order_matches_plain(matrix, n_sm, cols):
    a_t, a = matrix
    plan = trd.dense_plan(a.shape[0], a.shape[1], trd.BLOCKS_PER_SM * n_sm)
    assert max(t[4] for t in plan.tiles) > 1 or n_sm == 1
    g = np.random.default_rng(5).standard_normal(
        (cols, a.shape[0])).astype(np.float32)
    ref = trd.radon_dense_adj_plain(a_t, torch.from_numpy(g)).numpy()
    _close(emulate_adj(a, g, plan), ref)


def test_adjoint_order_matches_pallas_vjp(matrix):
    """The emulated split-order adjoint on the H100's plan (132 SMs) against
    the VJP of radon_apply_pallas in interpret mode, run as
    tests/test_torch_radon_dense.py runs it."""
    _, a = matrix
    a_j = jrk.prepare_matrix_bf16(jradon._build_projection_matrix(THETA, S, S))
    img = np.random.default_rng(0).uniform(size=(1, S, S, 1)).astype(
        np.float32)
    ct = np.random.default_rng(1).standard_normal(
        (1, len(THETA), S, 1)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jrk.radon_apply_pallas(x, a_j, len(THETA)),
                     jnp.asarray(img))
    plan = trd.dense_plan(a.shape[0], a.shape[1], trd.BLOCKS_PER_SM * 132)
    _close(emulate_adj(a, ct.reshape(1, -1), plan),
           np.asarray(vjp(jnp.asarray(ct))[0]).reshape(1, -1))


# -- the source ------------------------------------------------------------------

def test_source_streams_a_by_bulk_copies_in_one_adjoint_launch():
    """Both kernels take A through cp.async.bulk with an L2 evict_first
    policy into an mbarrier ring, each refill fenced after the consumers'
    reads of the stage; the adjoint is one kernel, with no reduce
    launch and no float atomics (the one atomicAdd is the int ticket); no
    SM count is written into the wrapper."""
    src = open(SRC).read()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    # the copy and barrier helpers live in csrc/bulk_copy.cuh, which the
    # source includes and calls
    assert '#include "bulk_copy.cuh"' in code
    helpers = open(os.path.join(os.path.dirname(SRC), "bulk_copy.cuh")).read()
    assert "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes" \
        ".L2::cache_hint" in helpers
    assert "createpolicy.fractional.L2::evict_first" in helpers
    assert "mbarrier.try_wait.parity" in helpers
    assert "bulk_load(" in code and "l2_evict_first()" in code
    assert "bar_wait(" in code
    # the producer orders the consumers' reads of a stage before the bulk
    # copies that refill it (async proxy)
    assert "fence.proxy.async.shared::cta" in helpers
    acquire = code[code.index("void producer_acquire("):]
    acquire = acquire[:acquire.index("}")]
    assert acquire.index("bar_wait(") < acquire.index("fence_proxy_async()") \
        < acquire.index("bar_expect_tx(")
    assert code.count("__global__") == 2
    assert "radon_dense_adj_reduce_kernel" not in code
    atomics = [line.strip() for line in code.splitlines()
               if "atomic" in line]
    assert len(atomics) == 1 and "atomicAdd(tk, 1)" in atomics[0]
    wrapper = open(trd.__file__).read()
    assert "528" not in wrapper and "multi_processor_count" in wrapper
