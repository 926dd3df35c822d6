"""The port's evaluation report (mfvi_dip_mia_tpu_torch/tasks/evaluation.py),
its UCE (ops/metrics.py) and classical baselines (ops/classical.py) against
the JAX package's tasks/evaluation.py, ops/metrics.py and ops/classical.py:
the same inputs, and the same save.npz files (written by either package's
runner at 64^2 on the 2-scale net) through both reports."""

import glob
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from PIL import Image

import mfvi_dip_mia_tpu.tasks.data as JD
import mfvi_dip_mia_tpu.tasks.evaluation as JE
import mfvi_dip_mia_tpu.tasks.problems as JP
import mfvi_dip_mia_tpu.tasks.runners as JR
from mfvi_dip_mia_tpu.nn import build_skip_net as jbuild
from mfvi_dip_mia_tpu.ops import classical as JC
from mfvi_dip_mia_tpu.ops.metrics import uce as juce
from mfvi_dip_mia_tpu.utils.images import add_gaussian_noise
import mfvi_dip_mia_tpu_torch.tasks.data as TD
import mfvi_dip_mia_tpu_torch.tasks.evaluation as TE
import mfvi_dip_mia_tpu_torch.tasks.problems as TP
import mfvi_dip_mia_tpu_torch.tasks.runners as TR
from mfvi_dip_mia_tpu_torch.nn import build_skip_net as tbuild
from mfvi_dip_mia_tpu_torch.ops import classical as TC
from mfvi_dip_mia_tpu_torch.ops.metrics import uce as tuce

from torch_port_helpers import SMALL_NET

torch.set_num_threads(1)

SIZE = 64
# the same float64 numpy / torch operations, f32 in and out
CLASSICAL = 1e-6
# UCE: the same f32 bin sums in another order
UCE_REL = 1e-6
# the report's scores: PSNR in dB, SSIM; FBP's image agrees to 1e-4 of its
# largest value (tests/test_torch_radon_dense.py REL_FBP), bicubic's to
# PIL's uint16 quantization (BICUBIC)
PSNR_DB, SSIM_ABS = 1e-4, 1e-6
TOL_ROW = {"fbp_shepp_logan": (2e-3, 1e-4), "bicubic": (1e-4, 1e-5)}
# bicubic without the uint16 round trip against PIL, where PIL does not
# saturate: PIL's path truncates the input to uint16 (< 1 unit of 1/65535,
# through taps whose magnitudes sum to ~1.15) and rounds after each of its
# two passes (0.5 unit each), so < 2.5 units; measured worst 1.97 units on
# the sr task's 96^2 image, 2.01 on a random one
BICUBIC = 2.5 / 65535


def _noisy(size, channels=1, seed=0):
    gt = JD.synthetic_xray(0, size)
    if channels > 1:
        gt = np.concatenate([gt * (0.6 + 0.2 * c) for c in range(channels)])
    return gt, add_gaussian_noise(gt, 0.1, np.random.default_rng(seed))


# -- UCE -----------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"value_range": (0.0, 0.2)},
                                {"outlier": 0.07}, {"n_bins": 7}],
                         ids=["minmax", "value_range", "outlier", "7 bins"])
def test_uce_against_jax(kw):
    rng = np.random.default_rng(1)
    err = (rng.uniform(size=(1, 48, 64)) ** 2).astype(np.float32)
    unc = (rng.uniform(size=(1, 48, 64)) * 0.1).astype(np.float32)
    ref = juce(jnp.asarray(err), jnp.asarray(unc), **kw)
    got = tuce(torch.from_numpy(err), torch.from_numpy(unc), **kw)
    assert abs(float(got[0]) - float(ref[0])) <= UCE_REL * float(ref[0])
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=UCE_REL,
                                   atol=1e-9)
    skipped = np.isnan(got[1].numpy())
    # value_range leaves the bins above 0.1 empty; outlier skips the thin
    # bins; neither skips any otherwise
    assert skipped.any() == ("value_range" in kw or "outlier" in kw)
    np.testing.assert_array_equal(skipped, np.isnan(np.asarray(ref[1])))


# -- the classical baselines ---------------------------------------------------

@pytest.mark.parametrize("name", ["tv_denoise_chambolle", "bilateral_denoise",
                                  "wavelet_denoise"])
@pytest.mark.parametrize("channels", [1, 3])
def test_denoisers_against_jax(name, channels):
    """TV, bilateral and wavelet denoising on a noisy 64^2 x-ray (the
    wavelet's finest diagonal subband has 1024 elements: an even count,
    whose median is the mean of the two middle values)."""
    _, noisy = _noisy(SIZE, channels)
    ref = getattr(JC, name)(noisy)
    got = getattr(TC, name)(noisy, device="cpu")
    assert got.dtype == torch.float32 and got.shape == noisy.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=CLASSICAL)


def test_wavelet_median_of_an_even_count():
    x = torch.tensor([4.0, 1.0, 3.0, 2.0], dtype=torch.float64)
    assert float(TC._median(x)) == np.median(x.numpy()) == 2.5
    assert float(TC._median(x[:3])) == np.median(x[:3].numpy()) == 3.0


def test_bicubic_against_pil_on_the_sr_image():
    """The sr task's 96^2 low-resolution image (img 1, the synthetic MRI)
    up x4 against JAX's PIL path, everywhere within the quantization."""
    prob = TP.build_problem("sr", "mfvi", 1, device="cpu")
    lr = prob.target_np.reshape(1, 96, 96)
    ref = JC.bicubic_upscale(lr, 4)
    got = TC.bicubic_upscale(lr, 4, device="cpu").numpy()
    assert got.shape == ref.shape == (1, 384, 384)
    assert np.abs(got - ref).max() <= BICUBIC


def test_bicubic_against_pil_on_random_images():
    """Two channels, and a non-square image, in [0, 0.8]: bicubic's
    overshoot stays below 1, where PIL's 16-bit passes saturate (above
    65535 they keep the low byte under a 0xFF high byte; the port clips to
    1 instead)."""
    rng = np.random.default_rng(2)
    for shape in ((2, 24, 24), (1, 17, 22)):
        img = rng.uniform(0.0, 0.8, shape).astype(np.float32)
        ref = JC.bicubic_upscale(img, 4)
        got = TC.bicubic_upscale(img, 4, device="cpu").numpy()
        assert got.shape == ref.shape == (shape[0], shape[1] * 4,
                                          shape[2] * 4)
        assert np.abs(got - ref).max() <= BICUBIC


def test_bicubic_matrix_rows_are_pil_s_weights():
    m = TC.bicubic_matrix(8, 32)
    np.testing.assert_allclose(m.sum(axis=1), 1.0, rtol=1e-15)
    # an impulse through PIL (float mode, no quantization) is a column
    a = np.zeros((1, 8), np.float32)
    a[0, 3] = 1.0
    up = np.asarray(Image.fromarray(a, mode="F").resize((32, 1),
                                                         Image.BICUBIC))
    np.testing.assert_allclose(m[:, 3], up[0], atol=1e-6)


# -- the report ----------------------------------------------------------------

@pytest.fixture
def small(monkeypatch):
    for D in (JD, TD):
        monkeypatch.setattr(D, "get_image_denoising", lambda i, D=D: (
            D.synthetic_xray(i, SIZE), (SIZE, SIZE)))
        monkeypatch.setattr(D, "get_img_ct", lambda i, D=D: (
            D.synthetic_ct(i, SIZE), (SIZE, SIZE)))
    monkeypatch.setattr(JP, "_standard_net", lambda n, m, dp, input_depth=16:
                        jbuild(input_depth, n_channels=n, **SMALL_NET))
    monkeypatch.setattr(TP, "_standard_net", lambda n, m, dp, input_depth=16:
                        tbuild(input_depth, n_channels=n, **SMALL_NET))


RUN = dict(num_iter=6, lr=1e-3, temp=5.66e-7, sigma=1.46e-5, seed=3,
           show_every=3, plot=False, save=True)


def _run(package, task, tmp_path):
    save = str(tmp_path / f"{package}_{task}")
    if package == "jax":
        JR.ALL_RUNNERS[f"run_{task}_mfvi"](save_path=save, **RUN)
    else:
        TR.ALL_RUNNERS[f"run_{task}_mfvi"](device="cpu", save_path=save,
                                           radon_mode="banded", **RUN)
    (path,) = glob.glob(os.path.join(save, "*", "save.npz"))
    return path


def _hold_report(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    for path in ref:
        g, r = got[path], ref[path]
        assert g.keys() == r.keys()
        assert g["summary"] == r["summary"]
        assert g.get("mc_mean") == r.get("mc_mean")
        assert g["calibration"].keys() == r["calibration"].keys()
        for name, cal in r["calibration"].items():
            mine = g["calibration"][name]
            assert abs(mine["uce"] - cal["uce"]) <= UCE_REL * cal["uce"]
            for key in ("err_in_bin", "uncert_in_bin", "prop_in_bin"):
                np.testing.assert_allclose(mine[key], cal[key],
                                           rtol=UCE_REL, atol=1e-9)
        assert g["classical"].keys() == r["classical"].keys()
        for name, row in r["classical"].items():
            db, ss = TOL_ROW.get(name, (PSNR_DB, SSIM_ABS))
            assert abs(g["classical"][name]["psnr"] - row["psnr"]) <= db
            assert abs(g["classical"][name]["ssim"] - row["ssim"]) <= ss


@pytest.mark.parametrize("package,task", [("jax", "den"), ("port", "den"),
                                          ("port", "ct")])
def test_report_against_jax(small, tmp_path, package, task, monkeypatch):
    """write_report with maps on one save.npz, by the port on the CPU and by
    JAX: the same tables, calibration, classical rows and files."""
    if task == "ct":
        monkeypatch.setenv("MFVI_DIP_RADON", "banded")
    path = _run(package, task, tmp_path)
    ref = JE.write_report([path], str(tmp_path / "jax_report"))
    got = TE.write_report([path], str(tmp_path / "port_report"),
                          device="cpu")
    _hold_report(got["runs"], ref["runs"])
    assert sorted(os.listdir(tmp_path / "port_report")) == sorted(
        os.listdir(tmp_path / "jax_report"))
    with open(tmp_path / "port_report" / "report.json") as f:
        assert json.load(f)["runs"].keys() == got["runs"].keys()
    entry = got["runs"][path]
    assert set(entry["classical"]) == (
        {"wavelet", "tv_chambolle", "bilateral"} if task == "den"
        else {"fbp_shepp_logan"})
    assert set(entry["calibration"]) == {"mfvi"}
    assert entry["mc_mean"]["psnr"] > 0


def test_report_rows_of_sr_inp_and_dip(tmp_path):
    """A hand-made save.npz per schema: sr (the bicubic row), inp (no
    classical row) and a dip run (all-zero maps: no calibration row)."""
    rng = np.random.default_rng(4)
    # in [0, 0.8], below PIL's saturation
    hr = 0.8 * JD.synthetic_xray(0, 32)
    rows = np.cumsum(rng.normal(0.1, 0.2, (30, 3)), axis=0) + 10
    maps = rng.uniform(size=(2, 1, 32, 32)).astype(np.float32)
    common = dict(psnrs={"m": rows}, ssims={"m": rows / 40},
                  recons={"m": maps}, uncerts={"m": maps * 0.1},
                  uncerts_ale={"m": maps * 0.2}, mse_gt={"m": rows[:, 0]})
    files = {
        "sr": dict(img_hr=hr, img_lr=hr[0, ::4, ::4], mse_noisy={}, **common),
        "inp": dict(img_inpainting=hr, img_mask=hr > 0.5, mse_corrupted={},
                    **common),
        "dip": dict(img_gt=hr, img_noisy=hr, mse_noisy={},
                    **dict(common, uncerts={"m": 0 * maps},
                           uncerts_ale={"m": 0 * maps})),
    }
    paths = []
    for name, payload in files.items():
        os.makedirs(tmp_path / name)
        paths.append(str(tmp_path / name / "save.npz"))
        np.savez(paths[-1], **payload)
    ref = JE.write_report(paths, str(tmp_path / "jax"), with_maps=False)
    got = TE.write_report(paths, str(tmp_path / "port"), with_maps=False,
                          device="cpu")
    assert os.listdir(tmp_path / "port") == ["report.json"]
    _hold_report(got["runs"], ref["runs"])
    sr, inp, dip = (got["runs"][p] for p in paths)
    assert set(sr["classical"]) == {"bicubic"} and inp["classical"] == {}
    assert dip["calibration"] == {} and set(dip["classical"]) == {
        "wavelet", "tv_chambolle", "bilateral"}


def test_main_on_the_cpu(small, tmp_path, capsys):
    path = _run("port", "den", tmp_path)
    out = str(tmp_path / "report")
    report = TE.main([path, "--out", out, "--device", "cpu"])
    printed = capsys.readouterr().out
    assert f"== {path}" in printed and "[classical] wavelet" in printed
    assert "mfvi: UCE" in printed and "mc-mean(25)" in printed
    assert os.path.isfile(os.path.join(out, "report.json"))
    assert any(f.endswith("_calibration.png") for f in os.listdir(out))
    assert report["runs"][path]["summary"]["mfvi"]["psnr_converged"] > 0


def test_the_report_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.write_report([], str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.wavelet_denoise(np.zeros((1, 8, 8), np.float32))
