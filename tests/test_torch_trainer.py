"""The slice as a whole: the port's ``fit`` (mfvi_dip_mia_tpu_torch/tasks/
trainer.py) against the JAX package's ``fit`` in lockstep, for ct/mfvi and
den/mfvi at 64^2 on a 2-scale net.

Both sides start from the same parameters (carried across by utils/bridge.py),
see the same fixed DIP input (the same numpy generator), run with the input
jitter off and draw their RT weights from one fixed numpy eps. The JAX side
runs layout='auto' with the banded Radon operator and, at 64^2, the fused
block off, i.e. every conv and Radon pass on the Pallas kernels the port
replaces (in interpret mode here); a den lockstep at 128^2 keeps the JAX
fused block on, its default. The port runs the kernels' plain versions on
the CPU."""

import weakref

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import mfvi_dip_mia_tpu.bayes.vi as jvi
import mfvi_dip_mia_tpu.tasks.data as JD
import mfvi_dip_mia_tpu.tasks.problems as JP
import mfvi_dip_mia_tpu.tasks.trainer as JT
import mfvi_dip_mia_tpu.utils.images as JI
from mfvi_dip_mia_tpu.ops.pallas import fused_block as jfb
from mfvi_dip_mia_tpu.nn import build_skip_net as jbuild
import mfvi_dip_mia_tpu_torch.bayes.vi as tvi
import mfvi_dip_mia_tpu_torch.tasks.data as TD
import mfvi_dip_mia_tpu_torch.tasks.problems as TP
import mfvi_dip_mia_tpu_torch.tasks.trainer as TT
import mfvi_dip_mia_tpu_torch.utils.images as TI
from mfvi_dip_mia_tpu_torch.nn import build_skip_net as tbuild
from mfvi_dip_mia_tpu_torch.utils import bridge

from torch_port_helpers import SMALL_NET, dropout_kwargs, eps_pair, \
    jax_sample_with_eps

torch.set_num_threads(1)

SIZE = 64
N_STEPS = 4
# the bench's priors: ct (bench.py --metric ct) and den (test_mfvi_den)
PRIORS = {"ct": (2.2e-10, 1.7e-7), "den": (5.66e-7, 1.46e-5)}
LR = 1e-3


def _psnr_tol(i):
    # the lockstep gate of test_reference_parity.py::test_inp_dip_lockstep_
    # exact: f32 drift compounds ~1e-3 dB per Adam step
    return 2e-3 * (1 + i)


def _patch_problems(monkeypatch, size):
    """Both packages' build_problem at size^2 on the 2-scale net."""
    for D in (JD, TD):
        monkeypatch.setattr(D, "get_img_ct", lambda i, D=D: (
            D.synthetic_ct(i, size), (size, size)))
        monkeypatch.setattr(D, "get_image_denoising", lambda i, D=D: (
            D.synthetic_xray(i, size), (size, size)))
    monkeypatch.setattr(JP, "_standard_net", lambda n, m, dp, input_depth=16:
                        jbuild(input_depth, n_channels=n, **SMALL_NET,
                               **dropout_kwargs(m, dp)))
    monkeypatch.setattr(TP, "_standard_net", lambda n, m, dp, input_depth=16:
                        tbuild(input_depth, n_channels=n, **SMALL_NET,
                               **dropout_kwargs(m, dp)))


@pytest.fixture
def small_problems(monkeypatch):
    _patch_problems(monkeypatch, SIZE)


@pytest.fixture
def lockstep(monkeypatch):
    return _lockstep(monkeypatch, SIZE, jax_fused=False)


def _lockstep(monkeypatch, size, jax_fused):
    _patch_problems(monkeypatch, size)
    monkeypatch.setenv("MFVI_DIP_RADON", "banded")
    if not jax_fused:
        monkeypatch.setenv("MFVI_DIP_FUSED_BLOCK", "0")
    for T in (JT, TT):
        monkeypatch.setattr(T, "REG_NOISE_STD", 0.0)
    # the compiled chunk runner is cached per net structure for the whole
    # process and its key does not cover a patched sampler
    monkeypatch.setattr(JT, "_RUN_CHUNK_CACHE", {})
    monkeypatch.setattr(JT, "_RUN_CHUNK_CACHE_WEAK",
                        weakref.WeakKeyDictionary())

    def setup(task):
        prob_j = JP.build_problem(task, "mfvi", 0, input_depth=16)
        prob_t = TP.build_problem(task, "mfvi", 0, input_depth=16,
                                  device="cpu", radon_mode="banded")
        k1, k2 = jax.random.split(jax.random.PRNGKey(21))
        # a pytree round trip sorts dict keys, as the jitted step sees them
        params_j = jax.tree.map(jnp.asarray,
                                jvi.to_mfvi(prob_j.net.init(k1), k2))
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
        return prob_j, prob_t

    return setup


@pytest.mark.parametrize("task", ["ct", "den"])
def test_fit_lockstep_against_jax(lockstep, task):
    _check_lockstep(*lockstep(task), task)


def test_den_fit_lockstep_against_jax_fused_block_on(monkeypatch):
    """den f32 at 128^2: the JAX fit runs its fused block at the 128-wide
    level (skip, up, up1x1), the port fuses every stride-1 site."""
    fused_j = []
    apply_j = jfb.apply_fused

    def spy_j(*args, **kw):
        out = apply_j(*args, **kw)
        fused_j.append(out is not None)
        return out

    monkeypatch.setattr(jfb, "apply_fused", spy_j)
    prob_j, prob_t = _lockstep(monkeypatch, 128, jax_fused=True)("den")
    _check_lockstep(prob_j, prob_t, "den")
    assert sum(fused_j) >= 3


def _check_lockstep(prob_j, prob_t, task, reparam="rt"):
    """The port runs first (an LRT noise table fills in its site order);
    ``reparam='lrt'`` runs the JAX side at layout='nhwc', where its LRT noise
    is drawn in that same order."""
    temp, sigma = PRIORS[task]
    kw = dict(num_iter=N_STEPS - 1, lr=LR, seed=1, show_every=N_STEPS,
              metrics_every=1, reparam=reparam)
    res_t = TT.fit(prob_t, TT.Method("mfvi", temp=temp, sigma=sigma),
                   device="cpu", **kw)
    res_j = JT.fit(prob_j, JT.Method("mfvi", temp=temp, sigma=sigma),
                   layout="auto" if reparam == "rt" else "nhwc", **kw)
    assert res_t.psnrs.shape == res_j.psnrs.shape == (N_STEPS, 3)
    np.testing.assert_array_equal(res_t.net_input, res_j.net_input)
    for i in range(N_STEPS):
        for col in range(3):
            assert abs(res_t.psnrs[i, col] - res_j.psnrs[i, col]) < \
                _psnr_tol(i), (i, col, res_t.psnrs[i], res_j.psnrs[i])
    # the fit moved: the lockstep compares dynamics, not a fixed point
    assert abs(res_t.psnrs[-1, 1] - res_t.psnrs[0, 1]) > 10 * _psnr_tol(
        N_STEPS)
    assert abs(res_t.final_psnr - res_j.final_psnr) < _psnr_tol(N_STEPS)
    np.testing.assert_allclose(res_t.ssims, res_j.ssims, atol=1e-4)


def test_fit_result_fields_and_shapes(small_problems):
    prob = TP.build_problem("den", "mfvi", 0, device="cpu")
    n_iter, show = 5, 2
    seen = []
    res = TT.fit(prob, TT.Method("mfvi", *PRIORS["den"]), num_iter=n_iter - 1,
                 lr=LR, seed=3, show_every=show, device="cpu",
                 snapshot_fn=lambda i, *maps: seen.append(i))
    n_snaps = n_iter // show + 1
    assert res.executed == n_iter and seen == [0, 2, 4]
    assert res.psnrs.shape == res.ssims.shape == (n_iter, 3)
    assert res.mse_corrupted.shape == res.mse_gt.shape == (n_iter,)
    for maps in (res.recons, res.uncerts_epi, res.uncerts_ale):
        assert maps.shape == (n_snaps, 1, SIZE, SIZE)
        assert np.isfinite(maps).all()
    assert res.net_input.shape == (1, SIZE, SIZE, 16)
    assert np.isfinite(res.psnrs).all() and np.isfinite(res.ssims).all()
    assert res.final_psnr == res.psnrs[-1, 2]
    assert res.wall_seconds > 0 and res.iters_per_sec > 0
    names = TT.init_params(prob, TT.Method("mfvi"), 3)
    assert set(res.params) == set(names)
    assert all(res.params[k].shape == tuple(v.shape)
               for k, v in names.items())


def test_metrics_every_leaves_the_other_rows_unset(small_problems):
    prob = TP.build_problem("ct", "mfvi", 0, device="cpu",
                            radon_mode="banded")
    res = TT.fit(prob, TT.Method("mfvi", *PRIORS["ct"]), num_iter=5, lr=LR,
                 seed=1, show_every=3, metrics_every=3, device="cpu",
                 compute_dtype="bf16", collect_snapshots=False)
    rows = np.isfinite(res.psnrs[:, 2])
    np.testing.assert_array_equal(rows, [True, False, False, True, False,
                                         False])
    assert res.final_psnr == res.psnrs[3, 2]


def test_non_finite_loss_leaves_the_parameters_unchanged(small_problems,
                                                         monkeypatch):
    prob = TP.build_problem("den", "mfvi", 0, device="cpu")
    init = {k: v.numpy().copy() for k, v in
            TT.init_params(prob, TT.Method("mfvi"), 4).items()}
    real_loss = prob.data_loss
    monkeypatch.setattr(prob, "data_loss",
                        lambda out: real_loss(out) * float("nan"))
    res = TT.fit(prob, TT.Method("mfvi", *PRIORS["den"]), num_iter=2, lr=LR,
                 seed=4, show_every=3, device="cpu")
    for name, v in init.items():
        np.testing.assert_array_equal(res.params[name], v, err_msg=name)


def test_host_data_is_bit_equal_to_the_jax_package():
    for size in (32, 64):
        for img in (0, 2):
            np.testing.assert_array_equal(TD.synthetic_ct(img, size),
                                          JD.synthetic_ct(img, size))
            np.testing.assert_array_equal(TD.synthetic_xray(img, size),
                                          JD.synthetic_xray(img, size))
        np.testing.assert_array_equal(TD.shepp_logan(size),
                                      JD.shepp_logan(size))
    np.testing.assert_array_equal(TD.real_mri_slice(), JD.real_mri_slice())
    img = TD.synthetic_xray(1, 32)
    np.testing.assert_array_equal(
        TI.add_gaussian_noise(img, 0.1, np.random.default_rng(5)),
        JI.add_gaussian_noise(img, 0.1, np.random.default_rng(5)))
    np.testing.assert_array_equal(
        TI.get_noise(16, (32, 48), rng=np.random.default_rng(6)),
        JI.get_noise(16, (32, 48), rng=np.random.default_rng(6)))
    np.testing.assert_array_equal(TI.chw_to_nhwc(img), JI.chw_to_nhwc(img))


def test_unported_combinations_raise():
    """Every task is ported: sr and inp build (at their full sizes and
    widths), and only an unknown task or method raises."""
    sr = TP.build_problem("sr", "mfvi", 0, device="cpu")
    inp = TP.build_problem("inp", "sgld", 0, device="cpu")
    assert (sr.task, sr.imsize, sr.mean_ch) == ("sr", (384, 384), 1)
    assert (inp.task, inp.imsize, inp.mean_ch) == ("inp", (256, 256), 3)
    with pytest.raises(ValueError, match="unknown task"):
        TP.build_problem("deblur", "mfvi", 0, device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        TP.build_problem("sr", "vi", 0, device="cpu")
