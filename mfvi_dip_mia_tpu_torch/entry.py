"""The port's entry points for a quick check (counterpart of the repo's
``__graft_entry__.py``).

* ``entry()`` — one stochastic MFVI forward of the flagship net (the skip
  U-Net at 256^2) and its tempered-ELBO loss, with example arguments.
* ``dryrun_multichip(n)`` — the cand x mc sharded step on an n-entry mesh,
  two steps, then a one-program sweep of three chunks.

    python -c "from mfvi_dip_mia_tpu_torch.entry import dryrun_multichip; \\
        dryrun_multichip(8, devices=['cpu'] * 8)"

JAX provisions a virtual CPU mesh when it has too few devices; here the
mesh names the cards round-robin (``cuda:i`` folds i modulo the card count,
utils/device.py), so on one card every entry names it and the step runs
every copy that n cards would.
"""

from __future__ import annotations

import numpy as np
import torch

from .bayes import vi
from .nn import build_skip_net
from .ops.losses import gaussian_nll
from .parallel import sharding as sh
from .tasks import data as D
from .tasks.problems import Problem
from .tasks.trainer import Method
from .utils import images as I
from .utils.device import resolve_device

FLAGSHIP_WIDTHS = [16, 32, 64, 128, 128]


def entry(device=None, size: int = 256, input_depth: int = 16, scales=None):
    """(fn, (params, x, generator)): ``fn(params, x, generator) -> (nll +
    1e-6 KL, out)``, one RT draw of the MFVI skip net (``scales`` its
    widths, default [16, 32, 64, 128, 128], skip 4, reflection pad,
    bilinear up, 2 output channels) on ``x``, its Gaussian NLL against a
    zero target and the KL to N(0, 1e-6) (__graft_entry__.py:15-48).
    ``params`` is the net's MFVI parameters at seed 0 as a ``FlatParams``,
    ``x`` a (1, input_depth, size, size) uniform input x 0.1, both on
    ``device`` (default the card)."""
    dev = resolve_device(device)
    ch = list(scales or FLAGSHIP_WIDTHS)
    net = build_skip_net(input_depth, n_channels=2, pad="reflection",
                         skip_n33d=ch, skip_n33u=ch, skip_n11=4,
                         num_scales=len(ch), upsample_mode="bilinear")
    gen = torch.Generator().manual_seed(0)
    params = vi.flatten(vi.to_mfvi(net.init_params(gen), gen), device=dev)
    x = (torch.rand((1, input_depth, size, size), generator=gen) * 0.1
         ).to(dev)
    target = torch.zeros((1, 1, size, size), device=dev)

    def forward_step(params: vi.FlatParams, x: torch.Tensor,
                     generator: torch.Generator):
        out = net(vi.sample_mfvi_tree(params, generator), x, generator)
        nll = gaussian_nll(out[:, :1], out[:, 1:], target)
        kl = vi.kl_mfvi(params, 0.0, 1e-6)
        return nll + 1e-6 * kl, out

    return forward_step, (params, x, torch.Generator(device=dev).manual_seed(0))


DRYRUN_SIZE = 64


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """The cand x mc sharded step on ``make_mesh(n_devices, names=("cand",
    "mc"))`` over ``devices`` (default ``cuda:0`` .. ``cuda:n-1``, folded
    onto the cards there are), on JAX's dry-run problem
    (__graft_entry__.py:95-176): the 64^2 synthetic x-ray, noise 0.1, the
    3-scale [8, 16, 32] den/MFVI net with input depth 8. C = the mesh's
    ``cand`` size and S = max(its ``mc`` size, 2) candidates x samples
    (temp 10^-(5+i), sigma 1e-4, lr 2e-3): two steps, whose losses must be
    finite and of shape (C,). Then ``run_sweep_spmd`` of min(n, 4)
    candidates over the first min(n, 4) devices (59 iterations, chunks of
    20), whose final PSNRs must be finite. Prints JAX's two lines; raises
    on a failed check, and for a mesh with fewer than 2 candidates."""
    devs = [resolve_device(d) for d in
            (devices or [f"cuda:{i}" for i in range(n_devices)])]
    img = D.synthetic_xray(0, DRYRUN_SIZE)
    noisy = I.add_gaussian_noise(img, 0.1, np.random.default_rng(0))
    widths = [8, 16, 32]
    net = build_skip_net(8, n_channels=2, pad="reflection", skip_n33d=widths,
                         skip_n33u=widths, skip_n11=4, num_scales=3,
                         upsample_mode="bilinear")
    dev = devs[0]
    problem = Problem("den", "mfvi", net, 8, (DRYRUN_SIZE, DRYRUN_SIZE), 1,
                      torch.from_numpy(img)[None].to(dev),
                      torch.from_numpy(noisy)[None].to(dev), None, dev, img,
                      noisy, has_ale=True)

    mesh = sh.make_mesh(n_devices, names=("cand", "mc"), devices=devs)
    n_cand, n_mc = mesh.shape["cand"], max(mesh.shape["mc"], 2)
    if n_cand < 2:
        raise ValueError(f"a mesh of {n_devices} has {n_cand} candidate; the "
                         "dry run needs 2")
    step, _ = sh.build_sharded_sweep_step(problem, "mfvi", n_samples=n_mc,
                                          mesh=mesh)
    state = sh.init_sweep_state(problem, "mfvi", n_cand, seed=0)
    methods = [Method("mfvi", temp=10.0 ** (-5 - i), sigma=1e-4)
               for i in range(n_cand)]
    hp_stack = sh.stack_hyperparams(methods, lr=2e-3)
    s_local = n_mc // mesh.shape["mc"]
    generators = [[torch.Generator(device=entries[s // s_local]).manual_seed(
        1000 * c + s) for s in range(n_mc)]
        for c, (_, entries) in enumerate(sh.sweep_placement(mesh))]
    z = torch.from_numpy(I.get_noise(8, (DRYRUN_SIZE, DRYRUN_SIZE),
                                     rng=np.random.default_rng(1))
                         ).permute(0, 3, 1, 2).contiguous().to(dev)

    for it in range(2):
        state, losses = step(state, hp_stack, generators, z, it)
        losses = losses.cpu().numpy()
        if losses.shape != (n_cand,) or not np.isfinite(losses).all():
            raise AssertionError(f"step {it}: losses {losses}, expected "
                                 f"{n_cand} finite values")
    print(f"[dryrun_multichip] mesh={mesh.shape} candidates={n_cand} "
          f"mc={n_mc} losses={losses}")

    n_sweep = min(n_devices, 4)
    sweep_methods = [Method("mfvi", temp=10.0 ** (-5 - i), sigma=1e-4)
                     for i in range(n_sweep)]
    finals, _ = sh.run_sweep_spmd(
        problem, sweep_methods, lr=2e-3, num_iter=59, seed=0, show_every=20,
        chunk_iters=20, mesh=sh.make_mesh(n_sweep, names=("cand",),
                                          devices=devs))
    if not np.isfinite(finals).all():
        raise AssertionError(f"non-finite sweep PSNRs {finals}")
    print(f"[dryrun_multichip] spmd sweep: {n_sweep} candidates x 3 chunks "
          f"-> final smoothed PSNRs {np.round(finals, 2)}")
