"""The row-split fit (mfvi_dip_mia_tpu_torch/parallel/sharding.py::fit_sp)
and the fanout's ``sp_split`` route (parallel/fanout.py::
_run_candidates_sp), against the JAX package.

* Lockstep: the port's ``fit_sp`` on a mesh of 8 CPU entries against JAX's
  ``fit_sp`` on its 8-device CPU mesh (tests/conftest.py), den/mfvi on
  JAX's ``_tiny_den_problem`` (64^2, the 2-scale [8, 16] net, input
  depth 8; 8 rows a shard): the same parameters (carried across by utils/bridge.py), the same
  fixed DIP input, the input jitter off, and one fixed RT eps per step fed
  to both sides. Per-iteration PSNR within JAX's own sp tolerance (rtol
  1e-3, atol 6e-2 dB: tests/test_sharding.py::
  test_sp_fit_matches_unsharded), the final smoothed PSNR within 2e-2 dB.
* The port's ``fit_sp`` against the port's ``fit`` (2 and 4 shards, at
  32^2), its placement (``sp_shardings``), and a ct/mfvi ``fit_sp`` that
  learns.
* The fanout as JAX's tests/test_trainer.py::
  test_fanout_sp_split_matches_plain: two candidates on 8 CPU entries with
  ``sp_split=True`` (4 shards a candidate), scores within 0.1 dB of the
  plain route's, and ``failures`` records a crashing candidate."""

import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfvi_dip_mia_tpu.bayes.vi as jvi
import mfvi_dip_mia_tpu.tasks.trainer as JT
from mfvi_dip_mia_tpu.parallel import sharding as JS
import mfvi_dip_mia_tpu_torch.bayes.vi as tvi
import mfvi_dip_mia_tpu_torch.tasks.problems as TP
import mfvi_dip_mia_tpu_torch.tasks.trainer as TT
from mfvi_dip_mia_tpu_torch.nn import build_skip_net as tbuild
from mfvi_dip_mia_tpu_torch.nn.sp import RowSplit
from mfvi_dip_mia_tpu_torch.parallel import fanout as TF
from mfvi_dip_mia_tpu_torch.parallel import sharding as TS
from mfvi_dip_mia_tpu_torch.utils import bridge

from test_sharding import _tiny_den_problem
from test_torch_trainer import _patch_problems
from torch_port_helpers import eps_pair, jax_sample_with_eps

torch.set_num_threads(1)

SIZE = 32
# the lockstep's size, JAX's own (test_sp_fit_matches_unsharded): at 32^2
# (1 row a shard at the deepest level) JAX's fit_sp drifts up to 0.15 dB
# from its own unsplit fit within 40 iterations
LOCK_SIZE = 64
DEPTH = 8
ITERS = 40                     # rows 0..ITERS-1, one chunk
LR = 2e-3
METHOD = dict(temp=1e-6, sigma=1e-2)   # JAX's test_sp_fit_matches_unsharded


def _port_tiny_den(prob_j):
    """JAX's _tiny_den_problem as the port's Problem on the CPU."""
    net = tbuild(DEPTH, n_channels=2, pad="reflection", skip_n33d=[8, 16],
                 skip_n33u=[8, 16], skip_n11=4, num_scales=2,
                 upsample_mode="bilinear")
    return TP.Problem("den", "mfvi", net, DEPTH, prob_j.imsize, 1,
                      torch.from_numpy(prob_j.gt_np)[None],
                      torch.from_numpy(prob_j.target_np)[None], None,
                      torch.device("cpu"), prob_j.gt_np, prob_j.target_np,
                      has_ale=True)


def _mesh(n):
    return TS.make_mesh(n, names=("sp",), devices=["cpu"] * n)


def test_fit_sp_lockstep_against_jax(monkeypatch):
    prob_j = _tiny_den_problem(LOCK_SIZE)
    prob_t = _port_tiny_den(prob_j)
    for T in (JT, TT):
        monkeypatch.setattr(T, "REG_NOISE_STD", 0.0)
    monkeypatch.setattr(JT, "_RUN_CHUNK_CACHE", {})
    monkeypatch.setattr(JT, "_RUN_CHUNK_CACHE_WEAK",
                        weakref.WeakKeyDictionary())
    k1, k2 = jax.random.split(jax.random.PRNGKey(21))
    # one compiled program: JAX's init runs op by op otherwise (~25 s)
    params_j = jax.jit(lambda: jvi.to_mfvi(prob_j.net.init(k1), k2))()
    params_np = jax.tree.map(np.asarray, params_j)
    flat = tvi.flatten(bridge.params_from_jax(params_np))
    eps_j, eps_t = eps_pair(params_j, flat, seed=22)
    monkeypatch.setattr(
        JT, "_get_init_fn", lambda problem, name, optimizer, std:
        (lambda *keys: (params_j, optimizer.init(params_j))))
    monkeypatch.setattr(
        jvi, "sample_mfvi_tree", lambda p, key, out_dtype=None:
        jax_sample_with_eps(p, eps_j, out_dtype))
    monkeypatch.setattr(TT, "init_params", lambda problem, method, seed:
                        bridge.params_from_jax(params_np))
    sample = tvi.sample_mfvi_tree
    monkeypatch.setattr(
        tvi, "sample_mfvi_tree",
        lambda p, generator=None, out_dtype=None, eps=None:
        sample(p, out_dtype=out_dtype, eps=eps_t))

    kw = dict(num_iter=ITERS - 1, lr=LR, seed=42, show_every=ITERS,
              collect_snapshots=False)
    res_t = TS.fit_sp(prob_t, TT.Method("mfvi", **METHOD), mesh=_mesh(8),
                      **kw)
    res_j = JS.fit_sp(prob_j, JT.Method("mfvi", **METHOD),
                      mesh=JS.make_mesh(8, names=("sp",)), **kw)
    np.testing.assert_array_equal(res_t.net_input, res_j.net_input)
    assert res_t.psnrs.shape == res_j.psnrs.shape == (ITERS, 3)
    np.testing.assert_allclose(res_t.psnrs, res_j.psnrs, rtol=1e-3,
                               atol=6e-2)
    assert res_t.final_psnr == pytest.approx(res_j.final_psnr, abs=2e-2)
    # the fit moved: the lockstep compares dynamics, not a fixed point
    assert res_t.psnrs[-1, 1] - res_t.psnrs[0, 1] > 1.0


@pytest.mark.parametrize("n", [2, 4])
def test_fit_sp_matches_the_port_fit(n):
    prob = _port_tiny_den(_tiny_den_problem(SIZE))
    m = TT.Method("mfvi", **METHOD)
    kw = dict(num_iter=ITERS - 1, lr=LR, seed=42, show_every=20,
              metrics_every=2)
    ref = TT.fit(prob, m, device="cpu", **kw)
    res = TS.fit_sp(prob, m, mesh=_mesh(n), **kw)
    np.testing.assert_allclose(res.psnrs, ref.psnrs, rtol=1e-3, atol=6e-2,
                               equal_nan=True)
    assert res.final_psnr == pytest.approx(ref.final_psnr, abs=2e-2)
    for maps in ("recons", "uncerts_epi", "uncerts_ale"):
        np.testing.assert_allclose(getattr(res, maps), getattr(ref, maps),
                                   atol=2e-2)


def test_sp_shardings_places_the_split_and_the_state():
    prob = _port_tiny_den(_tiny_den_problem(SIZE))
    prep = TT.prepare_fit(prob, TT.Method("mfvi"), iterations=3, lr=LR,
                          device="cpu")
    placed = TS.sp_shardings(_mesh(4), prob, prep.state)
    assert placed["split"] == RowSplit((torch.device("cpu"),) * 4,
                                       (0, 8, 16, 24, 32))
    assert set(placed["state"].values()) == {torch.device("cpu")}
    assert set(placed["state"]) == {"flat", "m", "v", "count", "out_avg",
                                    "ring_epi", "ring_ale", "rows", "it"}
    with pytest.raises(ValueError, match="multiple of 4"):
        TS.sp_shardings(TS.make_mesh(16, names=("sp",),
                                     devices=["cpu"] * 16), prob, prep.state)
    with pytest.raises(ValueError, match="multiple of 4"):
        TS.fit_sp(prob, TT.Method("mfvi"), num_iter=1, lr=LR,
                  mesh=TS.make_mesh(16, names=("sp",), devices=["cpu"] * 16))


def test_ct_fit_sp_learns(monkeypatch):
    _patch_problems(monkeypatch, 32)
    prob = TP.build_problem("ct", "mfvi", 0, device="cpu",
                            radon_mode="banded")
    res = TS.fit_sp(prob, TT.Method("mfvi", temp=2.2e-10, sigma=1.7e-7),
                    mesh=_mesh(2), num_iter=59, lr=3e-3, seed=1,
                    show_every=30, compute_dtype="bf16",
                    collect_snapshots=False)
    assert np.isfinite(res.psnrs).all()
    assert res.final_psnr > res.psnrs[0, 2] + 1.0


def test_fanout_sp_split_matches_plain(monkeypatch):
    _patch_problems(monkeypatch, SIZE)
    run_params = dict(img=0, num_iter=40, lr=2e-3, seed=2, show_every=20,
                      input_depth=8, plot=False, save=False)
    cands = [(1e-6, 1e-3), (1e-4, 1e-2)]
    fits = []
    fit_sp = TS.fit_sp

    def watched(problem, method, *, mesh, **kw):
        fits.append(mesh.shape)
        return fit_sp(problem, method, mesh=mesh, **kw)

    monkeypatch.setattr(TS, "fit_sp", watched)
    kept_sp, y_sp = TF.run_candidates("den", "mfvi", cands, run_params,
                                      ["cpu"] * 8, sp_split=True)   # k = 4
    kept_p, y_p = TF.run_candidates("den", "mfvi", cands, run_params,
                                    ["cpu"], interleave=False)
    assert fits == [{"sp": 4}, {"sp": 4}]
    assert kept_sp == kept_p == [tuple(c) for c in cands]
    np.testing.assert_allclose(y_sp, y_p, atol=0.1)

    def crash(problem, method, **kw):
        if method.temp > 1e-5:
            raise RuntimeError("boom")
        return fit_sp(problem, method, **kw)

    monkeypatch.setattr(TS, "fit_sp", crash)
    failures = []
    kept, y = TF.run_candidates("den", "mfvi", cands,
                                dict(run_params, num_iter=4), ["cpu"] * 4,
                                sp_split=2, failures=failures)
    assert kept == [cands[0]] and np.isfinite(y).all()
    assert len(failures) == 1 and failures[0]["index"] == 1
    assert failures[0]["crashed"] and "boom" in failures[0]["error"]


def test_fit_sp_resumes_and_stops_early(tmp_path):
    """The state is not split, so a split fit's checkpoint resumes it with
    the uninterrupted fit's bits, and its early stop reads its rows."""
    prob = _port_tiny_den(_tiny_den_problem(SIZE))
    m = TT.Method("mfvi", **METHOD)
    kw = dict(num_iter=29, lr=LR, seed=42, show_every=10, mesh=_mesh(2),
              collect_snapshots=False)
    path = str(tmp_path / "ckpt.npz")
    full = TS.fit_sp(prob, m, checkpoint_path=path, checkpoint_every_chunks=1,
                     **kw)
    resumed = TS.fit_sp(prob, m, checkpoint_path=path, resume=True, **kw)
    np.testing.assert_array_equal(resumed.psnrs, full.psnrs)
    for name, v in full.params.items():
        np.testing.assert_array_equal(resumed.params[name], v, err_msg=name)
    stopped = TS.fit_sp(prob, m, early_stop={"patience": 5,
                                             "min_delta": 100.0}, **kw)
    # the first chunk sets the best row, the second cannot beat it by 100 dB
    assert stopped.executed == 20
    assert np.isnan(stopped.psnrs[20:]).all()
    np.testing.assert_array_equal(stopped.psnrs[:20], full.psnrs[:20])


def test_bo_and_multihost_pass_sp_split_to_the_spatial_route(monkeypatch,
                                                              tmp_path):
    """``bo(..., sp_split=True)`` and the one-process multi-host fanout
    route their candidates through fit_sp, each on its own sub-mesh (a
    stand-in fit scores them here)."""
    from mfvi_dip_mia_tpu_torch.bo import loop as TL
    from mfvi_dip_mia_tpu_torch.parallel import multihost as TM

    _patch_problems(monkeypatch, SIZE)
    meshes = []

    def split_fit(problem, method, *, mesh, **kw):
        meshes.append(mesh.shape["sp"])
        return TT.FitResult(*([None] * 11),
                            final_psnr=-float(np.log10(method.temp)))

    monkeypatch.setattr(TS, "fit_sp", split_fit)
    grid = {"temp": {"logbounds": [-10.0, 0.0], "candidates": [1e-2, 1e-8]},
            "sigma": {"logbounds": [-10.0, 0.0], "candidates": [1e-2, 1e-8]}}
    rp = dict(img=0, num_iter=3, input_depth=DEPTH, plot=False,
              bo_results_path=str(tmp_path), devices=["cpu"] * 8)
    X, Y = TL.bo("den", "mfvi", grid, rp, n_rounds=1, plot=False,
                 gp_iters=10, sp_split=True)
    assert meshes == [2] * 4
    assert sorted(Y) == [2.0, 2.0, 8.0, 8.0]
    meshes.clear()
    kept = TM.run_candidates_multihost("den", "mfvi", X[:2], rp,
                                       devices=["cpu"] * 8, sp_split=True)
    assert meshes == [4, 4] and kept[1] == Y[:2]
