"""The port's cand x mc sharded step over a mesh of several entries
(mfvi_dip_mia_tpu_torch/parallel/sharding.py::build_sharded_sweep_step,
``sweep_placement``) against the JAX package's shard_map step on its
8-device CPU mesh (tests/conftest.py).

* ``sweep_placement`` over a mesh of ``torch.device("cuda", i)`` objects
  (planned without a card) is JAX's device layout for ``P("cand")`` and
  ``P("cand", "mc")`` at 4 and 8 entries.
* The step on ``["cpu"] * 4`` meshes of shape (2, 2) and (1, 4) in
  lockstep with JAX's: the same parameters (``bridge.params_from_jax``),
  jitter off, each sample's RT draw fed to both sides from one table.
  Losses, parameters and the EMA after 3 steps at rtol 1e-4, the
  tolerance of tests/test_torch_sharding.py's one-device lockstep; every
  replica bit-equal to its lead after each step; 2 C (n_mc - 1) copies a
  step, each through ``_to_entry`` into another buffer.
* A generator on another device than its entry, or another state in a
  later call, raises ValueError.
JAX compiles its init once and its step once per mesh shape (a
module-scoped fixture); most of the file's time is those compiles. The
entry points that drive this step are tests/test_torch_entry.py's."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfvi_dip_mia_tpu.bayes import to_mfvi
import mfvi_dip_mia_tpu.tasks.trainer as JT
import mfvi_dip_mia_tpu.utils.images as JI
from mfvi_dip_mia_tpu.parallel import sharding as JS
import mfvi_dip_mia_tpu_torch.bayes.vi as tvi
import mfvi_dip_mia_tpu_torch.tasks.trainer as TT
from mfvi_dip_mia_tpu_torch.parallel import sharding as TS
from mfvi_dip_mia_tpu_torch.utils import bridge

from test_torch_sharding import DEPTH, LR, SIZE, _den_problems, _EpsNet
from torch_port_helpers import jax_eps_order, port_eps

torch.set_num_threads(1)

N_STEPS = 3
TEMPS = [(1e-6, 1e-2), (1e-4, 1e-3)]


@pytest.mark.parametrize("n", [4, 8])
def test_sweep_placement_is_jax_layout(n):
    jmesh = JS.make_mesh(n, names=("cand", "mc"))
    cards = np.empty(jmesh.devices.shape, dtype=object)
    for idx, d in np.ndenumerate(jmesh.devices):
        cards[idx] = torch.device("cuda", d.id)
    placement = TS.sweep_placement(TS.Mesh(cards, ("cand", "mc")))
    n_cand, n_mc = jmesh.devices.shape
    assert len(placement) == n_cand
    assert all(lead == devs[0] and len(devs) == n_mc
               for lead, devs in placement)
    for s_local in (1, 2):
        keys = jax.sharding.NamedSharding(jmesh, JS.P("cand", "mc"))
        for d, (cs, ss) in keys.devices_indices_map(
                (n_cand, n_mc * s_local)).items():
            for s in range(ss.start, ss.stop):
                assert placement[cs.start][1][s // s_local] == torch.device(
                    "cuda", d.id)
    holders = {}
    cand = jax.sharding.NamedSharding(jmesh, JS.P("cand"))
    for d, (cs,) in cand.devices_indices_map((n_cand,)).items():
        holders.setdefault(cs.start, set()).add(torch.device("cuda", d.id))
    assert holders == {c: set(devs) for c, (_, devs) in enumerate(placement)}
    one_axis = TS.Mesh(cards.reshape(-1), ("cand",))
    assert TS.sweep_placement(one_axis) == [(d, [d]) for d in cards.flat]


def _flat_of(params_j, c, port_order):
    """Candidate c's JAX parameters as the port's flat buffer."""
    tree = jax.tree.map(lambda a: np.asarray(a[c]), params_j)
    leaves = bridge.params_from_jax(tree)
    return tvi.flatten({k: leaves[k] for k in port_order})


def _jax_sweep_state(prob_j, n_cand):
    """JAX's ``init_sweep_state(prob_j, "mfvi", n_cand, seed=0)``
    (sharding.py:379-400) with one candidate's init compiled once, for
    every candidate's key."""
    one = jax.jit(lambda key: to_mfvi(prob_j.net.init(key),
                                      jax.random.fold_in(key, 1)))
    params = jax.tree.map(lambda *xs: jnp.stack(xs),
                          *[one(jax.random.PRNGKey(i)) for i in range(n_cand)])
    opt = jax.vmap(JT._build_optimizer(JT.Method("mfvi"), 1e-3).init)(params)
    h, w = prob_j.imsize
    return JS.SweepState(params, opt, jnp.zeros((n_cand, 1, h, w, 2)))


@pytest.fixture(scope="module")
def jax_runs():
    """shape -> JAX's sharded step run N_STEPS times on that (C, n_mc)
    mesh, one sample an mc slice, jitter off: the inputs the port needs
    (initial rows, the draw table, z) and JAX's losses and final state,
    each step compiled once."""
    import dataclasses

    cache = {}
    prob_j, prob_t = _den_problems()
    state_2 = _jax_sweep_state(prob_j, 2)
    one = jax.tree.map(lambda a: np.asarray(a[0]), state_2.params)
    order = jax_eps_order(one)
    n_eps = _EpsNet(None, order).n
    port_order = list(TT.init_params(prob_t, TT.Method("mfvi"), 0))

    def run(shape):
        if shape in cache:
            return cache[shape]
        n_cand, n_mc = shape
        state_j = jax.tree.map(lambda a: a[:n_cand], state_2)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JT, "REG_NOISE_STD", 0.0)
            step, sh = JS.build_sharded_sweep_step(
                dataclasses.replace(prob_j, net=_EpsNet(prob_j.net, order)),
                "mfvi", n_mc, JS.make_mesh(n_cand * n_mc, shape=shape))
        methods = [JT.Method("mfvi", temp=t, sigma=s)
                   for t, s in TEMPS[:n_cand]]
        rows = [_flat_of(state_j.params, c, port_order)
                for c in range(n_cand)]
        state_j = jax.device_put(state_j, sh["cand"])
        hp = jax.device_put(JS.stack_hyperparams(methods, LR), sh["cand"])
        base = jax.random.PRNGKey(3)
        keys = jnp.stack([jnp.stack([jax.random.fold_in(
            jax.random.fold_in(base, c), s) for s in range(n_mc)])
            for c in range(n_cand)])
        draws = [port_eps(one, rows[0], jax.random.normal(
            jax.random.fold_in(keys[c, s], it), (n_eps,)))
            for it in range(N_STEPS) for c in range(n_cand)
            for s in range(n_mc)]
        z_np = JI.get_noise(DEPTH, (SIZE, SIZE),
                            rng=np.random.default_rng(1))
        z_j = jax.device_put(jnp.asarray(z_np), sh["z"])
        keys = jax.device_put(keys, sh["keys"])
        losses = []
        for it in range(N_STEPS):
            state_j, loss = step(state_j, hp, keys, z_j, it)
            losses.append(np.asarray(loss))
        cache[shape] = types.SimpleNamespace(
            methods=methods, rows=rows, draws=draws, z=z_np, losses=losses,
            final=[_flat_of(state_j.params, c, port_order)
                   for c in range(n_cand)],
            out_avg=np.asarray(state_j.out_avg).transpose(0, 1, 4, 2, 3))
        return cache[shape]

    return run


def _port_step(monkeypatch, shape, draws):
    """The port's step on a ``["cpu"] * C n_mc`` mesh of ``shape``, jitter
    off, every RT draw taken from ``draws`` in call order."""
    _, prob_t = _den_problems()
    monkeypatch.setattr(TT, "REG_NOISE_STD", 0.0)
    sample, calls = tvi.sample_mfvi_tree, []

    def table(params, generator=None, out_dtype=None, eps=None):
        calls.append(len(calls))
        return sample(params, out_dtype=out_dtype, eps=draws[len(calls) - 1])

    monkeypatch.setattr(tvi, "sample_mfvi_tree", table)
    n_cand, n_mc = shape
    mesh = TS.make_mesh(n_cand * n_mc, shape=shape,
                        devices=["cpu"] * (n_cand * n_mc))
    step, placed = TS.build_sharded_sweep_step(prob_t, "mfvi", n_mc, mesh)
    assert placed == {"device": torch.device("cpu"), "cand": n_cand,
                      "mc": n_mc}
    return prob_t, step, calls


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_sharded_step_on_a_mesh_against_jax(monkeypatch, jax_runs, shape):
    ref = jax_runs(shape)
    n_cand, n_mc = shape
    prob_t, step, calls = _port_step(monkeypatch, shape, ref.draws)
    state = TS.init_sweep_state(prob_t, "mfvi", n_cand, seed=0)
    state.params.flat.copy_(torch.stack([r.flat for r in ref.rows]))
    hp = TS.stack_hyperparams([TT.Method("mfvi", temp=m.temp, sigma=m.sigma)
                               for m in ref.methods], LR)
    gens = [[torch.Generator() for _ in range(n_mc)] for _ in range(n_cand)]
    z = torch.from_numpy(ref.z).permute(0, 3, 1, 2).contiguous()
    for it in range(N_STEPS):
        state, loss = step(state, hp, gens, z, it)
        np.testing.assert_allclose(loss.numpy(), ref.losses[it], rtol=1e-4)
        for row in step.replicas:
            for rep in row[1:]:
                for a, b in zip(rep, row[0]):
                    assert torch.equal(a, b)
    assert len(calls) == len(ref.draws)
    assert step.copies == N_STEPS * 2 * n_cand * (n_mc - 1)
    assert step.steps_run == N_STEPS and not step.replays
    for c in range(n_cand):
        got = state.params.with_flat(state.params.flat[c]).leaves()
        for name, w in ref.final[c].leaves().items():
            g, w = got[name].numpy(), w.numpy()
            if name.endswith("bn_cat.offset"):
                # its gradient is 0 up to rounding, which AdamW's first
                # steps scale up to +-lr (tests/test_torch_sharding.py)
                assert np.abs(g - w).max() <= 2 * N_STEPS * LR, name
            else:
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                           err_msg=name)
        assert (state.params.flat[c] - ref.rows[c].flat).abs().max() > 1e-4
    np.testing.assert_allclose(state.out_avg.numpy(), ref.out_avg,
                               rtol=1e-4, atol=1e-6)
    assert state.opt_state[0].tolist() == [N_STEPS] * n_cand


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (2, 1)])
def test_copies_go_through_one_function(monkeypatch, shape):
    """Each copy between entries goes through ``_to_entry``, from one
    buffer into another (a real copy, though every entry names the CPU):
    the packs into the lead's rows, then the mean to the other entries."""
    n_cand, n_mc = shape
    prob_t, step, _ = _port_step(monkeypatch, shape, _draws(n_cand * n_mc))
    seen = []
    to_entry = TS.ShardedSweepStep._to_entry

    def watched(self, src, dst):
        seen.append((src.data_ptr(), dst.data_ptr()))
        to_entry(self, src, dst)

    monkeypatch.setattr(TS.ShardedSweepStep, "_to_entry", watched)
    state = TS.init_sweep_state(prob_t, "mfvi", n_cand, seed=0)
    hp = TS.stack_hyperparams([TT.Method("mfvi", temp=t, sigma=s)
                               for t, s in TEMPS[:n_cand]], LR)
    gens = [[torch.Generator().manual_seed(c * n_mc + s)
             for s in range(n_mc)] for c in range(n_cand)]
    z = torch.zeros((1, DEPTH, SIZE, SIZE))
    step(state, hp, gens, z, 0)
    per_step = 2 * n_cand * (n_mc - 1)
    assert len(seen) == step.copies == per_step
    assert all(src != dst for src, dst in seen)
    want_dst, want_src = [], []
    for c in range(n_cand):
        for b in range(1, n_mc):
            want_dst.append(step.gather[c][b].data_ptr())
            want_src.append(step.send[c][b - 1].data_ptr())
        for b in range(1, n_mc):
            want_dst.append(step.recv[c][b - 1].data_ptr())
            want_src.append(None)      # the lead's mean, made in the step
    assert [dst for _, dst in seen] == want_dst
    assert all(w is None or src == w for (src, _), w in zip(seen, want_src))


def _draws(n_calls):
    """Standard-normal RT draws enough for ``n_calls`` samples at SIZE."""
    _, prob_t = _den_problems()
    n = tvi.flatten(TT.init_params(prob_t, TT.Method("mfvi"), 0)).n_var
    gen = torch.Generator().manual_seed(7)
    return [torch.randn(n, generator=gen) for _ in range(n_calls)]


def test_sharded_step_refuses_misplaced_inputs(monkeypatch):
    prob_t, step, _ = _port_step(monkeypatch, (2, 2), _draws(4))
    state = TS.init_sweep_state(prob_t, "mfvi", 2, seed=0)
    hp = TS.stack_hyperparams([TT.Method("mfvi", temp=t, sigma=s)
                               for t, s in TEMPS], LR)
    z = torch.zeros((1, DEPTH, SIZE, SIZE))
    gens = [[torch.Generator() for _ in range(2)] for _ in range(2)]
    elsewhere = types.SimpleNamespace(device=torch.device("cuda", 1))
    with pytest.raises(ValueError, match="cuda:1.*cpu"):
        step(state, hp, [gens[0], [gens[1][0], elsewhere]], z, 0)
    with pytest.raises(ValueError, match="generators for a 2 x 2"):
        step(state, hp, [g[:1] for g in gens], z, 0)
    step(state, hp, gens, z, 0)
    other = TS.init_sweep_state(prob_t, "mfvi", 2, seed=0)
    with pytest.raises(ValueError, match="another state"):
        step(other, hp, gens, z, 1)
