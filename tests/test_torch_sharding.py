"""The port's candidate-parallel sweeps (mfvi_dip_mia_tpu_torch/parallel/
sharding.py) and the fanout's ``use_spmd`` / ``sp_split`` routing
(parallel/fanout.py), against the JAX package's parallel/sharding.py on its
8-device CPU mesh (tests/conftest.py).

* ``make_mesh``: the same axis sizes as JAX's for 1-8 devices, one and two
  axes (a port mesh may name one CPU device several times).
* ``run_sweep_spmd``: each candidate's rows and final PSNR are the bits of
  its own port ``fit`` at the same seed, on a one-entry and on a two-entry
  CPU mesh (two candidates per block; JAX's
  test_spmd_sweep_two_candidates_per_slice case).
* the fanout's ``sp_split`` route: the spatial branch (fit_sp per
  candidate on its sub-mesh) where JAX takes it, the plain dispatch
  where it falls through; the split fits themselves are
  tests/test_torch_sp_fit.py's.
* ``build_sharded_sweep_step``: 2 candidates x 2 MC samples on a (2, 2)
  mesh, in lockstep with JAX's step: the same parameters, jitter off, and
  each sample's RT draw fed to both sides from one table (JAX's net draws
  the whole tree from its sample key; the port's ``sample_mfvi_tree`` takes
  the same vector in its order). Losses, parameters and the EMA after 3
  steps at rtol 1e-4: the same f32 arithmetic, summed in another order.
Nets: the 2-scale SMALL_NET (input depth 8) at 32^2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfvi_dip_mia_tpu.tasks.data as JD
import mfvi_dip_mia_tpu.tasks.problems as JP
import mfvi_dip_mia_tpu.tasks.trainer as JT
import mfvi_dip_mia_tpu.utils.images as JI
from mfvi_dip_mia_tpu.nn import build_skip_net as jbuild
from mfvi_dip_mia_tpu.parallel import sharding as JS
import mfvi_dip_mia_tpu_torch.bayes.vi as tvi
import mfvi_dip_mia_tpu_torch.tasks.problems as TP
import mfvi_dip_mia_tpu_torch.tasks.runners as TR
import mfvi_dip_mia_tpu_torch.tasks.trainer as TT
from mfvi_dip_mia_tpu_torch.nn import build_skip_net as tbuild
from mfvi_dip_mia_tpu_torch.parallel import fanout as TF
from mfvi_dip_mia_tpu_torch.parallel import multihost as TM
from mfvi_dip_mia_tpu_torch.parallel import sharding as TS
from mfvi_dip_mia_tpu_torch.utils import bridge

from test_torch_trainer import _patch_problems
from torch_port_helpers import SMALL_NET, jax_eps_order, jax_sample_with_eps, \
    port_eps

torch.set_num_threads(1)

SIZE = 32
DEPTH = 8
LR = 1e-3
CANDS = [(1e-6, 1e-2), (1e-5, 1e-3), (1e-4, 1e-4), (1e-3, 1e-5)]


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shapes_match_jax(n):
    for names in (("cand",), ("cand", "mc")):
        got = TS.make_mesh(n, names=names, devices=["cpu"] * 8)
        assert got.shape == dict(JS.make_mesh(n, names=names).shape)
        assert got.devices.size == n
    assert TS.make_mesh(4, shape=(2, 2), devices=["cpu"] * 4).shape == {
        "cand": 2, "mc": 2}


def _den_problems():
    """The same den problem in both packages (jax, port)."""
    img = JD.synthetic_xray(0, SIZE)
    noisy = JI.add_gaussian_noise(img, 0.1, np.random.default_rng(0))
    nhwc = lambda a: jnp.asarray(JI.chw_to_nhwc(a))
    prob_j = JP.Problem(
        task="den", method="mfvi", net=jbuild(DEPTH, n_channels=2,
                                              **SMALL_NET),
        input_depth=DEPTH, imsize=(SIZE, SIZE), mean_ch=1, gt=nhwc(img),
        target=nhwc(noisy), mask=None, operator=None, gt_np=img,
        target_np=noisy, has_ale=True)
    prob_t = TP.Problem(
        "den", "mfvi", tbuild(DEPTH, n_channels=2, **SMALL_NET), DEPTH,
        (SIZE, SIZE), 1, torch.from_numpy(img)[None],
        torch.from_numpy(noisy)[None], None, torch.device("cpu"), img, noisy,
        has_ale=True)
    return prob_j, prob_t


@pytest.mark.parametrize("entries", [1, 2])
def test_run_sweep_spmd_equals_sequential_fits(entries):
    _, problem = _den_problems()
    methods = [TT.Method("mfvi", temp=t, sigma=s) for t, s in CANDS]
    mesh = TS.make_mesh(entries, names=("cand",), devices=["cpu"] * entries)
    kw = dict(num_iter=19, lr=LR, seed=1, show_every=10, metrics_every=3)
    finals, psnrs = TS.run_sweep_spmd(problem, methods, mesh=mesh, **kw)
    assert psnrs.shape == (4, 20, 3) and len(finals) == 4
    assert len(set(finals)) == 4
    for c, m in enumerate(methods):
        ref = TT.fit(problem, m, device="cpu", collect_snapshots=False, **kw)
        np.testing.assert_array_equal(psnrs[c], ref.psnrs)
        assert finals[c] == ref.final_psnr


def test_run_sweep_spmd_blocks_split_evenly():
    _, problem = _den_problems()
    methods = [TT.Method("mfvi", temp=t, sigma=s) for t, s in CANDS[:3]]
    with pytest.raises(ValueError, match="split evenly"):
        TS.run_sweep_spmd(problem, methods, num_iter=3, lr=LR, mesh=(
            TS.make_mesh(2, names=("cand",), devices=["cpu", "cpu"])))
    with pytest.raises(ValueError, match="share a method"):
        TS.run_sweep_spmd(problem, methods[:1] + [TT.Method("dip")],
                          num_iter=3, lr=LR, mesh=TS.make_mesh(
                              1, names=("cand",), devices=["cpu"]))


class _EpsNet:
    """JAX's net with the whole-tree RT draw of a sample taken from the
    sample's key (one standard normal over the variational leaves, in
    ``order``), so the port can be fed the same vector."""

    def __init__(self, net, order):
        self.net = net
        self.n = sum(int(np.prod(s)) for _, s in order)

    def apply(self, params, x, key=None, training=True, reparam="rt",
              dropout_p=None, layout="nhwc"):
        eps = jax.random.normal(key, (self.n,), jnp.float32)
        return self.net.apply(jax_sample_with_eps(params, eps), x, None,
                              training, reparam, dropout_p, layout)


def test_sharded_sweep_step_lockstep_against_jax(monkeypatch):
    import dataclasses

    prob_j, prob_t = _den_problems()
    n_cand, n_mc, n_steps = 2, 2, 3
    for T in (JT, TT):
        monkeypatch.setattr(T, "REG_NOISE_STD", 0.0)
    # one compiled program: JAX's init runs op by op otherwise (~25 s)
    state_j = jax.jit(lambda: JS.init_sweep_state(prob_j, "mfvi", n_cand,
                                                  seed=0))()
    one = jax.tree.map(lambda a: np.asarray(a[0]), state_j.params)
    order = jax_eps_order(one)
    prob_j = dataclasses.replace(prob_j, net=_EpsNet(prob_j.net, order))
    mesh_j = JS.make_mesh(4, shape=(n_cand, n_mc))
    step_j, sh = JS.build_sharded_sweep_step(prob_j, "mfvi", n_mc, mesh_j)
    methods = [JT.Method("mfvi", temp=1e-6, sigma=1e-2),
               JT.Method("mfvi", temp=1e-4, sigma=1e-3)]
    state_j = jax.device_put(state_j, sh["cand"])
    hp_j = jax.device_put(JS.stack_hyperparams(methods, LR), sh["cand"])
    base = jax.random.PRNGKey(3)
    keys = jnp.stack([jnp.stack([jax.random.fold_in(
        jax.random.fold_in(base, c), s) for s in range(n_mc)])
        for c in range(n_cand)])
    z_np = JI.get_noise(DEPTH, (SIZE, SIZE), rng=np.random.default_rng(1))

    port_order = list(TT.init_params(prob_t, TT.Method("mfvi"), 0))

    def flat_of(params_j, c):
        """Candidate c's JAX parameters as the port's flat buffer."""
        tree = jax.tree.map(lambda a: np.asarray(a[c]), params_j)
        leaves = bridge.params_from_jax(tree)
        return tvi.flatten({k: leaves[k] for k in port_order})

    state_t = TS.init_sweep_state(prob_t, "mfvi", n_cand, seed=0)
    layout = flat_of(state_j.params, 0)
    assert layout.names == state_t.params.names
    state_t.params.flat.copy_(torch.stack(
        [flat_of(state_j.params, c).flat for c in range(n_cand)]))
    draws = [port_eps(one, layout, jax.random.normal(
        jax.random.fold_in(keys[c, s], it), (_EpsNet(None, order).n,)))
        for it in range(n_steps) for c in range(n_cand) for s in range(n_mc)]
    calls = []

    def table(params, generator=None, out_dtype=None, eps=None):
        calls.append(len(calls))
        return sample(params, out_dtype=out_dtype, eps=draws[len(calls) - 1])

    sample = tvi.sample_mfvi_tree
    monkeypatch.setattr(tvi, "sample_mfvi_tree", table)
    mesh_t = TS.make_mesh(4, shape=(n_cand, n_mc), devices=["cpu"] * 4)
    step_t, placed = TS.build_sharded_sweep_step(prob_t, "mfvi", n_mc,
                                                 mesh_t)
    assert placed == {"device": torch.device("cpu"), "cand": 2, "mc": 2}
    hp_t = TS.stack_hyperparams(
        [TT.Method("mfvi", temp=m.temp, sigma=m.sigma) for m in methods], LR)
    gens = [[torch.Generator() for _ in range(n_mc)] for _ in range(n_cand)]
    z_t = torch.from_numpy(z_np).permute(0, 3, 1, 2).contiguous()
    z_j = jax.device_put(jnp.asarray(z_np), sh["z"])
    keys = jax.device_put(keys, sh["keys"])
    for it in range(n_steps):
        state_j, loss_j = step_j(state_j, hp_j, keys, z_j, it)
        state_t, loss_t = step_t(state_t, hp_t, gens, z_t, it)
        np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j),
                                   rtol=1e-4)
    assert len(calls) == len(draws)
    for c in range(n_cand):
        got = state_t.params.with_flat(state_t.params.flat[c]).leaves()
        want = flat_of(state_j.params, c).leaves()
        for name, w in want.items():
            g, w = got[name].numpy(), w.numpy()
            if name.endswith("bn_cat.offset"):
                # a per-channel constant into a conv whose BatchNorm removes
                # it: its gradient is 0 up to rounding, which AdamW's first
                # steps scale up to +-lr whatever its sign
                assert np.abs(g - w).max() <= 2 * n_steps * LR, name
            else:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                           err_msg=name)
        moved = state_t.params.flat[c] - layout.flat
        assert moved.abs().max() > 1e-4
    np.testing.assert_allclose(
        state_t.out_avg.numpy(),
        np.asarray(state_j.out_avg).transpose(0, 1, 4, 2, 3), rtol=1e-4,
        atol=1e-6)
    assert int(state_t.opt_state[0][0]) == n_steps


def test_run_candidates_spmd_route(monkeypatch):
    """use_spmd=True (no runner) runs the mesh program: the scores of
    run_sweep_spmd on build_problem's problem; a given runner ignores it."""
    _patch_problems(monkeypatch, SIZE)
    mesh = TS.make_mesh(1, names=("cand",), devices=["cpu"])
    rp = dict(img=0, num_iter=9, lr=LR, seed=1, show_every=5, mesh=mesh)
    kept_c, kept_y = TF.run_candidates("den", "mfvi", CANDS[:2], rp,
                                       devices=["cpu"], use_spmd=True)
    finals, _ = TS.run_sweep_spmd(
        TP.build_problem("den", "mfvi", 0, device="cpu"),
        [TR.method_for("den", "mfvi", TF.candidate_kwargs("mfvi", c))
         for c in CANDS[:2]],
        num_iter=9, lr=LR, seed=1, show_every=5, mesh=mesh)
    assert kept_y == finals and kept_c == [tuple(c) for c in CANDS[:2]]


def test_sp_split_routing(monkeypatch):
    """JAX's routing (fanout.py:209-219): too few devices for a >= 2-way
    split per candidate fall through to the plain dispatch; enough of them
    take the spatial branch, candidate i's fit split over devices[i*k:
    (i+1)*k] (fit_sp, its scores here from a stand-in); a split the net
    cannot halve to its deepest scale raises up front."""
    def group(task, bayes, cands, device=None, **kw):
        return [float(c[0]) for c in cands]

    def task_run(task, bayes, index=0, device=None, temp=0.0, **kw):
        return 100.0 + temp

    meshes = []

    def split_fit(problem, method, *, mesh, num_iter, lr, **kw):
        meshes.append((mesh.shape, problem.imsize, num_iter))
        return TT.FitResult(*([None] * 11), final_psnr=200.0 + method.temp
                            + mesh.shape["sp"])

    _patch_problems(monkeypatch, SIZE)
    monkeypatch.setattr(TR, "run_group_interleaved", group)
    monkeypatch.setattr(TR, "run_task", task_run)
    monkeypatch.setattr(TS, "fit_sp", split_fit)
    cands = [(1.0, 1.0), (2.0, 2.0)]
    plain = TF.run_candidates("den", "mfvi", cands, {}, devices=["cpu"])
    assert plain[1] == [1.0, 2.0]
    for sp in (True, 2, 3):
        assert TF.run_candidates("den", "mfvi", cands, {}, devices=["cpu"],
                                 sp_split=sp) == plain
    two = ["cpu", "cpu"]
    assert TF.run_candidates("den", "mfvi", cands, {}, devices=two,
                             sp_split=2)[1] == [101.0, 102.0]
    rp = dict(img=0, num_iter=7, lr=LR, input_depth=DEPTH)
    # (sp_split, candidates, devices, k, scores)
    for sp, n, n_dev, k, want in ((2, 1, 2, 2, [203.0]),
                                  (True, 1, 2, 2, [203.0]),
                                  (2, 2, 4, 2, [203.0, 204.0]),
                                  (True, 2, 8, 4, [205.0, 206.0])):
        meshes.clear()
        kept = TF.run_candidates("den", "mfvi", cands[:n], rp,
                                 devices=["cpu"] * n_dev, sp_split=sp)
        assert kept == ([tuple(c) for c in cands[:n]], want)
        assert meshes == [({"sp": k}, (SIZE, SIZE), 7)] * n
    with pytest.raises(ValueError, match="multiple of 4"):
        TF.run_candidates("den", "mfvi", cands[:1], rp, devices=["cpu"] * 16,
                          sp_split=True)


def test_entry_points_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, problem = _den_problems()
    m = [TT.Method("mfvi")]
    for call in (lambda: TS.make_mesh(),
                 lambda: TS.run_sweep_spmd(problem, m, num_iter=1, lr=LR),
                 lambda: TT.fit_interleaved(problem, m, num_iter=1, lr=LR),
                 lambda: TR.run_group_interleaved("den", "mfvi", [(1, 1)]),
                 lambda: TF.run_candidates("den", "mfvi", [(1, 1)], {}),
                 lambda: TM.run_candidates_multihost("den", "mfvi", [(1, 1)],
                                                     {})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
