"""The RT draw's backward as one autograd node (bayes/vi.py::_Draw): the
flat buffer's gradient through it equals, bit for bit, the one autograd
makes when every leaf is a slice view of the drawn sample or of the buffer
(the draw's construction before the node), for the den and inp nets cut
small, in f32 and bf16, with a supplied eps, with leaves the net never
uses, and summed over two draws from one buffer (the sharded step's). The
leaves' backward graph holds one node of the draw and no slice backward,
each backward counts its leaves (``vi.flat_grad_leaves``), and a captured
step's ``graph`` span carries that count. Imports no JAX."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import mfvi_dip_mia_tpu_torch.tasks.problems as TP
import mfvi_dip_mia_tpu_torch.tasks.trainer as TT
from mfvi_dip_mia_tpu_torch.bayes import vi
from mfvi_dip_mia_tpu_torch.utils.profiling import TRACER
from portbench.tests import small, small_inp

SEED = 2 ** 31 + 25


def sliced_draw(params: vi.FlatParams, eps: torch.Tensor, out_dtype=None
                ) -> dict:
    """The draw with every leaf a slice view: the sampled leaves of the
    sample, the det leaves of the buffer, each slice's backward a fill and
    an add of its whole base."""
    n = params.n_var
    sample = params.mu + F.softplus(params.rho) * eps
    if out_dtype is not None:
        sample = sample.to(out_dtype)
    out = {}
    for name, s, o in zip(params.names, params.shapes, params.offsets):
        size = math.prod(s)
        if name.endswith("_mu"):
            out[name[:-3]] = sample[o:o + size].view(s)
        elif o >= 2 * n:
            out[name] = params.flat[o:o + size].view(s)
    return out


def node_draw(params: vi.FlatParams, eps: torch.Tensor, out_dtype=None
              ) -> dict:
    return vi.sample_mfvi_tree(params, eps=eps, out_dtype=out_dtype)


def _problem(monkeypatch, task: str):
    if task == "den":
        small.patch_port(monkeypatch, small.small_config("den_mfvi_f32_256"))
    else:
        small_inp.patch_port(monkeypatch)
    return TP.build_problem(task, "mfvi", 0, device="cpu",
                            rng=np.random.default_rng(SEED))


def _layout(problem, unused: bool) -> vi.FlatParams:
    """The problem's MFVI parameters as a flat buffer; ``unused`` adds a
    sampled and a det leaf the net never reads."""
    params = TT.init_params(problem, TT.Method("mfvi"), SEED)
    if unused:
        gen = torch.Generator().manual_seed(SEED)
        params["unused.w_mu"] = torch.randn((3, 2), generator=gen)
        params["unused.w_rho"] = torch.randn((3, 2), generator=gen) - 3.0
        params["unused.scale"] = torch.ones(5)
    return vi.flatten(params, device="cpu")


def _grad(problem, flat: vi.FlatParams, draw, eps_list, low) -> torch.Tensor:
    """The buffer's gradient of the summed data loss over one net forward
    per eps of ``eps_list``, each on its own draw from one buffer, the
    leaves cast to ``low`` as the trainer's step casts them."""
    p = flat.flat.clone().requires_grad_(True)
    h, w = problem.imsize
    x = torch.rand((1, problem.input_depth, h, w),
                   generator=torch.Generator().manual_seed(SEED))
    loss = 0.0
    for eps in eps_list:
        leaves = draw(flat.with_flat(p), eps, low)
        xin = x
        if low is not None:
            leaves = {k: t.to(low) for k, t in leaves.items()}
            xin = x.to(low)
        out = problem.net(leaves, xin, torch.Generator().manual_seed(1),
                          reparam="rt", dropout_p=None).float()
        loss = loss + problem.data_loss(out)
    loss.backward()
    return p.grad


@pytest.mark.parametrize("task", ["den", "inp"])
@pytest.mark.parametrize("low", [None, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("unused", [False, True], ids=["all_used", "unused"])
@pytest.mark.parametrize("draws", [1, 2])
def test_flat_gradient_equals_the_sliced_draws(monkeypatch, task, low, unused,
                                               draws):
    problem = _problem(monkeypatch, task)
    flat = _layout(problem, unused)
    gen = torch.Generator().manual_seed(SEED + draws)
    eps_list = [torch.randn((flat.n_var,), generator=gen)
                for _ in range(draws)]
    ours = _grad(problem, flat, node_draw, eps_list, low)
    theirs = _grad(problem, flat, sliced_draw, eps_list, low)
    assert ours.dtype == theirs.dtype == torch.float32
    assert ours.shape == flat.flat.shape
    assert torch.equal(ours, theirs)
    assert bool(ours[:flat.n_var].ne(0).any())
    if unused:
        # the unused sampled leaf's mu and rho, and the unused det leaf
        for name in ("unused.w_mu", "unused.w_rho", "unused.scale"):
            i = flat.names.index(name)
            o, size = flat.offsets[i], math.prod(flat.shapes[i])
            assert not bool(ours[o:o + size].any()), name


def test_the_leaves_values_are_the_sliced_draws():
    params = {"a.w_mu": torch.randn(4, 3), "a.w_rho": torch.randn(4, 3) - 3,
              "a.b_mu": torch.randn(4), "a.b_rho": torch.randn(4) - 3,
              "bn.scale": torch.ones(4), "bn.offset": torch.zeros(4)}
    flat = vi.flatten(params)
    eps = torch.randn(flat.n_var)
    for low in (None, torch.bfloat16):
        ours, theirs = node_draw(flat, eps, low), sliced_draw(flat, eps, low)
        assert list(ours) == list(theirs)
        for k, t in theirs.items():
            assert ours[k].dtype == t.dtype and torch.equal(ours[k], t), k


def _nodes(root) -> list:
    """Every node of the backward graph from ``root``, once each."""
    seen, todo, out = set(), [root], []
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        out.append(node)
        todo.extend(f for f, _ in node.next_functions)
    return out


@pytest.mark.parametrize("low", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_one_draw_node_and_no_slice_backward_to_the_buffer(monkeypatch, low):
    problem = _problem(monkeypatch, "den")
    flat = _layout(problem, unused=True)
    p = flat.flat.clone().requires_grad_(True)
    leaves = vi.sample_mfvi_tree(flat.with_flat(p), eps=torch.randn(
        (flat.n_var,), generator=torch.Generator().manual_seed(3)),
        out_dtype=low)
    used = [t for k, t in leaves.items() if not k.startswith("unused.")]
    loss = sum((t.float() ** 2).sum() for t in used)
    nodes = _nodes(loss.grad_fn)
    names = [type(n).__name__ for n in nodes]
    assert names.count("_DrawBackward") == 1
    assert not any("Slice" in n for n in names)
    (draw,) = [n for n in nodes if type(n).__name__ == "_DrawBackward"]
    # the buffer's one edge is the draw's first
    into_p = [n for n in nodes
              if any(f is not None and getattr(f, "variable", None) is p
                     for f, _ in n.next_functions)]
    assert into_p == [draw]
    # each backward gathers every leaf, the unused ones too
    for _ in range(2):
        before = vi.flat_grad_leaves()
        loss.backward(retain_graph=True)
        assert vi.flat_grad_leaves() - before == len(leaves)


def test_no_grad_draw_makes_no_node():
    params = {"a.w_mu": torch.randn(4, 3), "a.w_rho": torch.randn(4, 3) - 3,
              "bn.scale": torch.ones(4)}
    flat = vi.flatten(params)
    p = flat.flat.clone().requires_grad_(True)
    with torch.no_grad():
        leaves = vi.sample_mfvi_tree(flat.with_flat(p),
                                     torch.Generator().manual_seed(0))
    assert all(t.grad_fn is None for t in leaves.values())
    assert not leaves["a.w"].requires_grad


@pytest.mark.parametrize("method,gathered", [("mfvi", True), ("dip", False)])
def test_graph_span_counts_the_leaves_gathered(monkeypatch, method,
                                               gathered):
    """``capture_variant``'s ``graph`` span carries the leaves the captured
    step gathers in one pass: every MFVI leaf, and none where the leaves
    are slices of the buffer. The capture is run eagerly here."""
    problem = _problem(monkeypatch, "den")
    monkeypatch.setattr(TT, "capture",
                        lambda fn, gens, stream: (None, (), fn()))
    m = TT.Method(method, temp=1e-6, sigma=1e-2)
    prep = TT.prepare_fit(problem, m, iterations=4, lr=1e-3, seed=SEED,
                          device="cpu")
    TRACER.reset()
    TT.capture_variant([(prep.step, prep.state, prep.generator)], None,
                       True)
    (span,) = TRACER.spans("graph")
    leaves = len(vi.sample_mfvi_tree(prep.params,
                                     torch.Generator().manual_seed(0)))
    assert span.attrs["flat_grad_leaves"] == (leaves if gathered else 0)
    TRACER.reset()
