"""The port's entry points (mfvi_dip_mia_tpu_torch/entry.py) against the
repo's __graft_entry__.py.

* ``dryrun_multichip(4, devices=["cpu"] * 4)``: the cand x mc sharded
  step on a (2, 2) CPU mesh, two steps with finite losses, then a
  one-program sweep of 4 candidates in 3 chunks with finite PSNRs, and
  JAX's two lines printed; a mesh of one candidate raises.
* ``entry``'s fn at 64^2 on the 3-scale [8, 16, 32] net against JAX's net,
  ``gaussian_nll`` and ``kl_mfvi`` (the formula of __graft_entry__.py:
  42-46) on the same parameters (``bridge.params_from_jax``) and RT draw
  at rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfvi_dip_mia_tpu.bayes.vi as jvi
from mfvi_dip_mia_tpu.bayes import to_mfvi
from mfvi_dip_mia_tpu.nn import build_skip_net as jbuild
from mfvi_dip_mia_tpu.ops import gaussian_nll as jnll
import mfvi_dip_mia_tpu_torch.bayes.vi as tvi
from mfvi_dip_mia_tpu_torch import entry as TE
from mfvi_dip_mia_tpu_torch.utils import bridge

from torch_port_helpers import jax_eps_order, jax_sample_with_eps, \
    port_eps, rel

torch.set_num_threads(1)


def test_dryrun_multichip_on_cpu(capsys):
    TE.dryrun_multichip(4, devices=["cpu"] * 4)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[dryrun_multichip] mesh={'cand': 2, 'mc': 2}"
                               " candidates=2 mc=2 losses=")
    assert lines[1].startswith("[dryrun_multichip] spmd sweep: 4 candidates")
    assert "nan" not in "".join(lines)
    with pytest.raises(ValueError, match="needs 2"):
        TE.dryrun_multichip(1, devices=["cpu"])


def test_entry_against_jax(monkeypatch):
    size, depth, scales = 64, 8, [8, 16, 32]
    # __graft_entry__.py:15-29 (_flagship), its init compiled once: a tree
    # that comes out of jit has sorted keys, as the jitted forward sees it
    net_j = jbuild(depth, n_channels=2, pad="reflection", skip_n33d=scales,
                   skip_n33u=scales, skip_n11=4, num_scales=len(scales),
                   upsample_mode="bilinear")
    key = jax.random.PRNGKey(0)
    params_j = jax.jit(lambda k: to_mfvi(net_j.init(k),
                                         jax.random.fold_in(k, 1)))(key)
    x_j = jax.random.uniform(jax.random.fold_in(key, 2),
                             (1, size, size, depth)) * 0.1
    order = jax_eps_order(params_j)
    eps = np.random.default_rng(0).standard_normal(
        sum(int(np.prod(s)) for _, s in order)).astype(np.float32)

    @jax.jit
    def forward_step(params, eps, x):
        # __graft_entry__.py:42-46 with the draw from ``eps``
        out = net_j.apply(jax_sample_with_eps(params, eps), x, None, True,
                          "rt", None, "nhwc")
        nll = jnll(out[..., :1], out[..., 1:], jnp.zeros((1, size, size, 1)))
        return nll + 1e-6 * jvi.kl_mfvi(params, 0.0, 1e-6), out

    loss_j, out_j = forward_step(params_j, eps, x_j)

    fn, (params_t, x_t, gen) = TE.entry(device="cpu", size=size,
                                        input_depth=depth, scales=scales)
    assert x_t.shape == (1, depth, size, size) and gen.device.type == "cpu"
    leaves = bridge.params_from_jax(jax.tree.map(np.asarray, params_j))
    assert set(leaves) == set(params_t.names)
    params = tvi.flatten({k: leaves[k] for k in params_t.names})
    eps_t = port_eps(params_j, params, eps)
    sample = tvi.sample_mfvi_tree
    monkeypatch.setattr(tvi, "sample_mfvi_tree",
                        lambda p, generator=None, out_dtype=None, eps=None:
                        sample(p, out_dtype=out_dtype, eps=eps_t))
    x = torch.from_numpy(np.array(x_j)).permute(0, 3, 1, 2).contiguous()
    loss_t, out_t = fn(params, x, gen)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    assert rel(out_t.detach().numpy(),
               np.asarray(out_j).transpose(0, 3, 1, 2)) <= 1e-4
