#!/usr/bin/env python3
"""Drive the PyTorch port (mfvi_dip_mia_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--profile-steps N]

Phases, each of which raises on failure (the script then exits non-zero):

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, the build of the hand-written CUDA kernels from csrc/, each
   kernel's registers, shared memory and spills (``nvcc -Xptxas -v`` of the
   build), and the HMMA (mma.sync) instructions of every instantiation of
   the six tensor-core kernels (``cuobjdump -sass`` of the library; each
   must have some); the dense Radon kernels and the fused dc must not
   spill.
2. Every kernel against its plain PyTorch version on the card: the VALID
   conv (forward and FULL dx) and its weight gradient, each twice for the
   same bits, in f32 and bf16 at every conv-site shape of the 256^2 CT and
   den U-Nets and four odd shapes, the banded Radon forward and
   adjoint at 256^2 / 45 angles with the f32 and the bf16 band, the four
   fused conv + BN + LeakyReLU kernels in f32 at every fused-site shape of
   the 256^2 den U-Net and four odd shapes (each twice for the same bits;
   the dc also at 16 x 512^2, past a cluster's shared memory), the LRT
   double conv in f32 and bf16 at every conv-site shape of the 256^2 den
   U-Net (act_mu, act_var; its backward in f32 at a quarter of them), and
   the dense bf16-matrix Radon forward and adjoint at 256^2 / 45 angles and
   on two odd random matrices, at 1 and 3 image columns, each launched
   for the same bits (40 times at 256^2, twice on the odd matrices).
   Besides, at every site shape of phase 8's nets (sr: the 5-scale net on
   384^2 with input depth 32; inp: the 6-scale k5 / k3 net and the mcd
   skip-0 net on 256^2): the conv, its dx and dw in f32 and bf16 (k5 as
   it is at stride 1, as k3 parity planes at stride 2), the four fused
   kernels at the sr net's 20 fused sites and the inp net's 6, and the
   LRT double conv, with the same tolerances.
3. One f32 CT, one f32 den and one f32 LRT den loss and gradient through
   the 256^2 nets on the card against the CPU's plain path. Then the paths,
   each a fit on the card, where every iteration is a replay of the step's
   CUDA graph (checked), and the same fit once more eagerly
   (``fit(..., eager=True)``) for its it/s beside the graph's:
   bench.py's CT configuration (256^2, input depth 16, temp 2.2e-10, sigma
   1.7e-7, lr 1e-3, seed 1, bf16, metrics every 10) through ``fit``, 100
   warm-up and 200 timed iterations; the den/MFVI f32 fit of 500 iterations
   (bench.py --metric train's configuration) through the user's entry point
   ``run_den_mfvi`` (save.npz into a temporary directory, no plots), with
   its 25-sample MC posterior summary, and the MC posterior samples per
   second of ``mc_predict``; path A, the same den fit through
   ``fit(..., reparam="lrt")`` (100 warm-up and 200 timed iterations) and
   its 25-sample LRT posterior summary; path B, the CT configuration with
   ``radon_mode="dense-bf16"`` (100 + 200 iterations). Launch counters are
   zeroed just before each path and read just after its graph fit; they
   count what the card ran: each replay adds its capture's launches, the
   two eager warm-up steps before a capture count as steps run. Last, the
   reproducibility of a fit: the den f32, CT bf16, path-A and path-B graph
   fits, each run twice at seed 1 for 60 iterations, must give equal bits
   in every metric row and in the final parameters.
4. The graph against the eager step: each path's fit at seed 1 (60
   iterations, snapshots every 20, metric rows every 10) once eagerly and
   three times in a row as graph replays. Every graph fit must give the
   eager fit's bits in every metric row, snapshot and final parameter,
   replay every iteration, and count the eager fit's launches per step
   run; the three must leave at most 64 MB more device memory allocated
   than before them; and every global cache of the port must hold the same
   tensors just before and just after each capture.
5. The sweep: ``mc_predict`` at 256^2 as graph replays against its eager
   loop (``eager=True``), RT on the den net and LRT (path A), 100 samples,
   each from random parameters (seed 1): equal bits, samples/s of each,
   launches counted per replay, no memory or cache entry left behind. Then
   ``bo("ct", "mfvi", ...)`` with configs/bo_mfvi_ct.json's parameters
   (256^2, f32, img 0, lr 1e-3, seed 1, the 2 x 2 temp / sigma candidates,
   "tpu:0" -> cuda:0) cut to 200 iterations a fit and 2 rounds, plots off,
   paths in a temporary directory: no crashed candidate, a kept one in
   every round, every fit all graph replays, the JAX loop's fig_data keys,
   at most 64 MB more allocated after round 2 than after round 1, and the
   launches of the whole sweep (``launches_by_path["bo_ct"]``); round 1
   again, resumed from a copy of round 0's ``0_fig_data.npz``, must give
   the straight sweep's (X, Y) and fig_data bit for bit. Seconds per
   candidate (set-up, fit, MC summary) and per round (GP, candidate
   search). Last, ``cli.main`` on a copy of that config (one round, which
   must observe the sweep's round 0) and ``eval_cli.main`` on a copy of
   configs/test_mfvi_ct.json (200 iterations): a finite PSNR and a
   save.npz with the CT and MC keys.
7. (run after 5, before 6's timing) The other methods: plain DIP, MC
   dropout and SGLD on den and ct at 256^2, f32, seed 1, each with
   configs/test_{method}_{task}.json's candidate and lr, through ``fit``: a
   300-iteration graph fit (it/s over the last 200, every iteration a
   replay, the final smoothed PSNR above iteration 0's, launches exactly
   the conv and fused kernels on den and those and the banded Radon pair
   on ct; mcd's skip sites on the fused block and more conv launches per
   step than dip), then two 60-iteration graph fits and an eager one with
   equal bits (masks and parameter noise drawn inside the graph). mcd's
   25-sample MC forward as a graph against its eager loop (equal bits,
   fresh masks every sample). ``run_den_mcd`` and ``run_ct_sgld`` (the
   save.npz keys with the MC summary's) and ``run_den_dip`` (none of
   them), 101 iterations each. ``cli.main`` on configs/bo_sgld_den.json
   (one round, 200 iterations, every candidate kept) and ``eval_cli.main``
   on configs/test_mcd_ct.json and configs/test_dip_den.json (200
   iterations). ``--profile-steps`` also profiles mcd den and sgld den.
8. (run after 7, before 6's timing) The sr and inp tasks under the four
   methods, full width: sr (configs/test_{method}_sr.json: img 1, the
   384^2 synthetic MRI, its 96^2 low-resolution image by a x1/4 resize,
   the 5-scale skip net with input depth 32; mcd re-draws its convs from
   N(0, 0.1)) and inp (img 1, the 256^2 synthetic skin with its hair mask,
   the 6-scale no-skip k5 / k3 net, or for mcd the 5-scale skip-0 net),
   f32, seed 1, each with its test config's candidate and lr, through
   ``fit``: a 300-iteration graph fit (it/s over the last 200, every
   iteration a replay, the final smoothed PSNR above iteration 0's, the
   launches per step exactly ``STEP_LAUNCHES``, as PERF.md predicts), then
   two 60-iteration graph fits and an eager one with equal bits; inp/mfvi
   under ``reparam="lrt"`` (its k5 sites on ``lrt_conv_fwd``), a graph fit
   and an eager one of 60 iterations with equal bits. The MC summaries of
   the sr and inp mfvi fits (twice, equal bits). ``run_sr_mcd`` and
   ``run_inp_mfvi`` (101 iterations; save.npz with the task's keys and
   the MC summary's), ``cli.main`` on configs/bo_mfvi_sr.json and
   configs/bo_mfvi_inp.json (one round of 4 candidates, 200 iterations a
   fit, plots off). Last, the profiler's device time of the kernels at
   the nets' new shapes (the inp k5 sites, the sr net's 384^2 sites, the
   LRT k5 sites) beside cuDNN's. ``--profile-steps`` also profiles sr/mfvi
   and inp/mfvi as graph replays.
6. Each kernel's time at the paths' shapes beside its bound, its plain
   version's time and one PyTorch library call's time (cuDNN / cuBLAS, TF32
   off; timed here only, never called by the port), printed as one JSON
   line ``{"kernels": [...]}``; for every kernel also the profiler's device
   time of one step's calls beside the library's for the same calls
   (``device_ms``, ``library_device_ms``; for the fused forward the cuDNN
   conv + batch_norm + leaky_relu chain, for the fused dc the
   leaky_relu_backward + native_batch_norm_backward chain on the conv
   output; the dc also per site, its smallest site the per-launch floor).
   The dense Radon pair also gives the GB/s of A and the share of the bytes
   bound of the kernel and of cuBLAS. With ``--profile-steps``, each path's
   fit is profiled as graph replays (from the first replay on) and eagerly.
   ``launches_by_path`` adds "sr" and "inp": the launches of phase 8's
   four sr fits and of its four inp fits and the LRT inp fit.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the package beside it, the script exits
with a non-zero code and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet): dense bf16 tensor-core rate,
# f32 rate outside the tensor cores, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

SIZE = 256
DEVICE = "cuda"
CT_ITERS_WARM = 100            # first show_every chunk: warm-up
CT_ITERS_TIMED = 200
DEN_ITERS = 500
MC_SAMPLES_TIMED = 100
DEN_AB_ITERS = 110             # unprofiled den steps of the fused A/B
PATH_ITERS_WARM = 100          # paths A and B: first chunk, then timed
PATH_ITERS_TIMED = 200
MC_SAMPLES = 25                # the runner's posterior summary

# Tolerances of a kernel against its plain version, as a share of the
# plain result's largest magnitude:
#   f32 conv / dx: the same <= 1188-term f32 sums in another order
#   bf16 conv / dx: both round an f32 sum to bf16; a sum that differs in its
#     last f32 bits can round one bf16 ulp (2^-8) apart
#   dw (f32 out, f32 accumulation of up to 65,536 products from f32 or bf16
#     inputs): split partial sums in another order than cuBLAS's
#   Radon: f32 accumulation of the same band products (bf16 band promoted
#     to f32 in both), in another order
#   LRT act_mu / act_var: as the conv, two sums of <= 1188 products (of x
#     and of x^2, squared in f32 by both) in another order; bf16 as the conv
#   LRT backward (f32): dx is two full correlations and an elementwise
#     product, dw / dw_var the split sums of up to 65,536 products, each in
#     another order than the plain version's matmuls
#   dense Radon: f32 accumulation of the same bf16-matrix products (up to
#     65,536 per bin or pixel) in another order than cuBLAS's f32 matmul
TOL = {("conv", "f32"): 1e-4, ("conv", "bf16"): 8e-3,
       ("dw", "f32"): 1e-3, ("dw", "bf16"): 1e-3,
       ("radon", "f32"): 1e-4, ("radon", "bf16"): 1e-4,
       ("lrt", "f32"): 1e-4, ("lrt", "bf16"): 8e-3,
       ("lrt_bwd", "f32"): 1e-3, ("radon_dense", "bf16"): 1e-4}
# The fused block's kernels against their plain versions (f32), as a share
# of the plain result's largest magnitude (per column of stats):
#   out / dconv / dx: f32 sums of <= 1188 products in another order, then
#     elementwise BN / LeakyReLU / dconv arithmetic
#   mu, inv: sums of up to 65,536 terms in another (fixed) order
#   dw, dgamma, dbeta: sums of up to 65,536 products in another order
TOL_FUSED = {"out": 1e-4, "dconv": 1e-4, "dx": 1e-4, "mu": 1e-5, "inv": 1e-5,
             "dw": 1e-3, "dgamma": 1e-3, "dbeta": 1e-3}
# One f32 step, card against CPU: the same f32 arithmetic in another
# summation order at every one of 26 convs, 30 BatchNorms (and the Radon);
# gradients as a share of the largest one
TOL_STEP = {"out": 1e-4, "loss": 1e-4, "grad": 1e-3}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_report() -> dict:
    """Each kernel's registers, static shared memory and spill bytes as
    ``nvcc -Xptxas -v`` reported them when the library was built."""
    from mfvi_dip_mia_tpu_torch.ops.kernels import build
    report = {}
    for src, out in build.ptxas_logs().items():
        name = None
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
                report[name] = dict(source=src, spill=0)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and name:
                report[name]["spill"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$",
                          line)
            if m and name:
                report[name].update(registers=int(m.group(1)),
                                    smem=int(m.group(2) or 0))
    for src in sorted({r["source"] for r in report.values()}):
        rows = [r for r in report.values() if r["source"] == src]
        log(f"[1] ptxas {src}: {len(rows)} entry functions, registers "
            f"{min(r['registers'] for r in rows)}-"
            f"{max(r['registers'] for r in rows)}, static shared memory up "
            f"to {max(r['smem'] for r in rows)} B, spill bytes "
            f"{sum(r['spill'] for r in rows)}")
    for name, tag in NO_SPILL_FUNCS:
        rows = {f: r for f, r in report.items() if tag in f}
        if not rows:
            raise AssertionError(f"ptxas reported no {name} kernel")
        for f, r in rows.items():
            log(f"[1] ptxas {name} ({f}): {r['registers']} registers, "
                f"static shared memory {r['smem']} B, spill bytes "
                f"{r['spill']}")
            if r["spill"]:
                raise AssertionError(f"{f} spills {r['spill']} bytes")
    for name, tag in MMA_KERNELS:
        rows = [r for f, r in report.items() if tag_of(f) == tag]
        if not rows:
            raise AssertionError(f"ptxas reported no {tag}")
        log(f"[1] ptxas {name} ({tag}, {len(rows)} instantiations): "
            f"registers {min(r['registers'] for r in rows)}-"
            f"{max(r['registers'] for r in rows)}, static shared memory "
            f"{max(r['smem'] for r in rows)} B, spill bytes "
            f"{sum(r['spill'] for r in rows)}")
        for f, r in report.items():
            if tag_of(f) == tag and r["spill"]:
                log(f"    spills {r['spill']} B, {r['registers']} registers:"
                    f" {f}")
    return report


# the tensor-core kernels (mma.sync): the port's kernel, its CUDA template
# (lrt_conv_fwd's first: conv_fwd_mma_kernel is a part of its name)
MMA_KERNELS = (("lrt_conv_fwd", "lrt_conv_fwd_mma_kernel"),
               ("cf_conv_fwd", "conv_fwd_mma_kernel"),
               ("cf_conv_dw", "conv_dw_mma_kernel"),
               ("fused_block_fwd", "fused_fwd_mma_kernel"),
               ("fused_block_bwd_dw", "fused_bwd_dw_mma_kernel"),
               ("fused_block_bwd_dx", "fused_bwd_dx_mma_kernel"))


# the dense Radon pair's __global__s (csrc/radon_dense.cu), held to no spills
DENSE_FUNCS = (("radon_dense_fwd", "radon_dense_fwd_kernel"),
               ("radon_dense_adj", "radon_dense_adj_kernel"))
# the __global__s held to no spills: the dense Radon pair and the fused dc
NO_SPILL_FUNCS = DENSE_FUNCS + (("fused_block_bwd_dc",
                                 "fused_bwd_dc_cluster_kernel"),)


def tag_of(mangled: str) -> str:
    """The kernel template's name inside a mangled entry-function name."""
    for _, tag in MMA_KERNELS:
        if tag in mangled:
            return tag
    return ""


def sass_mma_report() -> dict:
    """HMMA instructions per instantiation of the tensor-core kernels in the
    built library (``cuobjdump -sass``); raises where one has none."""
    from mfvi_dip_mia_tpu_torch.ops.kernels import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    lib = build.library()._name
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=300)
    if out.returncode:
        raise RuntimeError(f"cuobjdump -sass failed: {out.stderr[-2000:]}")
    counts, cur = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if tag_of(m.group(1)) else None
            if cur:
                counts[cur] = 0
        elif cur and re.search(r"\bHMMA\b", line):
            counts[cur] += 1
    report = {}
    for _, tag in MMA_KERNELS:
        n = [v for f, v in counts.items() if tag_of(f) == tag]
        if not n or min(n) == 0:
            raise AssertionError(f"{tag}: an instantiation without HMMA "
                                 f"({n})")
        report[tag] = dict(instantiations=len(n), hmma_min=min(n),
                           hmma_max=max(n))
        log(f"[1] sass {tag}: {len(n)} instantiations, HMMA (mma.sync) "
            f"instructions {min(n)}-{max(n)} each")
    return report


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 5, tries: int = 6) -> float:
    """torch.profiler's device time of the kernels ``fn()`` launches, per
    call (the host's launch rate does not enter it). On the card a profile
    now and then catches none or only a part of the kernels (seen after
    many profiles in one process), so it is taken until two profiles catch
    the same number of kernels, at most ``tries`` times; the one with the
    most kernels is kept."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = {}                       # kernels caught -> device us
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
        n = sum(ev.count for ev in evs)
        us = sum(ev.self_device_time_total for ev in evs)
        if n and n in seen:
            return us / 1e3 / reps
        seen[n] = us
    n = max(seen)
    if not n:
        raise RuntimeError("the profiler caught no device kernel")
    return seen[n] / 1e3 / reps


def site_device_ms(calls, tag: str, reps: int = 5, tries: int = 6) -> list:
    """The profiler's device time of each call's one kernel (its function
    name starting with ``tag``), in call order: the median over ``reps``
    passes of the calls. Profiled again until a profile catches every
    launch, at most ``tries`` times (see ``device_ms``)."""
    import statistics
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for f in calls:
        f()
    torch.cuda.synchronize()
    n = len(calls)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                for f in calls:
                    f()
            torch.cuda.synchronize()
        evs = sorted((ev for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA
                      and re.search(r"(?<!\w)" + tag, ev.name)),
                     key=lambda ev: ev.time_range.start)
        if len(evs) == reps * n:
            us = [ev.time_range.elapsed_us() for ev in evs]
            return [statistics.median(us[r * n + i] for r in range(reps)) / 1e3
                    for i in range(n)]
    raise RuntimeError(f"no profile caught all {reps * n} launches of {tag}")


def rel_err(got, ref) -> tuple[float, float]:
    """(max |got - ref|, that over max |ref|)."""
    d = float((got.float() - ref.float()).abs().max())
    return d, d / max(float(ref.float().abs().max()), 1e-30)


def bound(flops: float, nbytes: float, peak_flops: float):
    """(least time in ms, which of bytes / operations bounds it)."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


# -- the 256^2 CT U-Net's conv sites ------------------------------------------

def conv_sites(net, size: int) -> list[dict]:
    """Every conv site of ``net`` on a size^2 input, as the VALID stride-1
    conv the kernel sees: xp (I, Hp, Wp) and w (O, I, k, k) after padding and
    the stride-2 parity planes (ops/kernels/cf_conv.py::conv2d_cf). The
    operations a bound counts are the site's own conv's (``flops``, one
    contraction, and ``x_elems``, its padded input): a stride-2 site's plane
    form holds 16 taps per output where the k=3 conv needs 9."""
    sites = []

    def add(name, site, s_in, needs_dx=True):
        k = site.kernel
        hp = s_in + 2 * ((k - 1) // 2)
        ho = (hp - k) // site.stride + 1
        own = dict(flops=2.0 * site.c_out * site.c_in * k * k * ho * ho,
                   x_elems=site.c_in * hp * hp)
        if site.stride == 1:
            xp, w = (site.c_in, hp, hp), (site.c_out, site.c_in, k, k)
        elif site.stride == 2 and k > 1:
            k2 = (k + 1) // 2
            m = (hp - k) // 2 + 1 + k2 - 1
            xp, w = (4 * site.c_in, m, m), (site.c_out, 4 * site.c_in, k2, k2)
        else:
            raise ValueError(f"site {name}: stride {site.stride}, k {k}")
        sites.append(dict(name=name, xp=xp, w=w, needs_dx=needs_dx, **own))

    for i, cfg in enumerate(net.levels):
        s = size >> i
        first = i == 0            # level 0's skip and down1 read the input z
        if cfg.skip_conv is not None:
            add(f"levels.{i}.skip", cfg.skip_conv, s, not first)
        add(f"levels.{i}.down1", cfg.down1, s, not first)
        add(f"levels.{i}.down2", cfg.down2, s // 2)
        add(f"levels.{i}.up", cfg.up, s)
        if cfg.up1x1 is not None:
            add(f"levels.{i}.up1x1", cfg.up1x1, s)
    add("out", net.out_conv, size)
    return sites


def conv_operands(site: dict, dtype, gen):
    import torch
    i_ch, hp, wp = site["xp"]
    o_ch, _, kh, kw = site["w"]
    dev = DEVICE
    xp = torch.randn(site["xp"], generator=gen, device=dev).to(dtype)
    w = (torch.randn(site["w"], generator=gen, device=dev)
         / (i_ch * kh * kw) ** 0.5).to(dtype)
    g = torch.randn((o_ch, hp - kh + 1, wp - kw + 1), generator=gen,
                    device=dev).to(dtype)
    return xp, w, g


# -- phase 2: kernels against their plain versions ----------------------------

# Shapes beyond the nets' sites, so that every branch of the conv kernels
# runs on the card: widths that are no multiple of 8 (the dw's element-wise
# copy of g), k = 5 (the dw's one row of taps per block), ragged channel
# tiles: (xp, w)
EXTRA_CONV_SHAPES = (((20, 37, 29), (12, 20, 3, 3)),
                     ((9, 23, 21), (5, 9, 5, 5)),
                     ((40, 19, 50), (70, 40, 2, 2)),
                     ((3, 64, 64), (33, 3, 1, 1)))


def check_conv_kernels(sites, results: dict) -> None:
    import torch
    from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    shapes = {}
    for s in sites:
        shapes.setdefault((s["xp"], s["w"]), s)
    for xps, ws in EXTRA_CONV_SHAPES:
        shapes[(xps, ws)] = dict(name="extra", xp=xps, w=ws, needs_dx=True)
    log(f"[2] conv kernels at {len(shapes)} distinct shapes of "
        f"{len(sites)} conv sites")
    for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        worst = {"cf_conv_fwd": (0.0, 0.0), "cf_conv_dw": (0.0, 0.0)}
        for (xps, ws), s in shapes.items():
            xp, w, g = conv_operands(s, dtype, gen)
            k = ws[2]
            checks = [
                ("cf_conv_fwd", "conv", tcf.conv_valid_fwd(xp, w),
                 tcf.conv_valid_plain(xp, w)),
                ("cf_conv_fwd", "conv", tcf.conv_dx(g, w),
                 tcf.conv_dx_plain(g, w)),
                ("cf_conv_dw", "dw", tcf.conv_dw(xp, g, k, k),
                 tcf.conv_dw_plain(xp, g, k, k)),
            ]
            # a cluster's partial tiles are summed in rank order, the dw's
            # groups of clusters in index order: the same bits on every call
            again = (tcf.conv_valid_fwd(xp, w), tcf.conv_dx(g, w),
                     tcf.conv_dw(xp, g, k, k))
            torch.cuda.synchronize()
            for (kname, _, first, _), second in zip(checks, again):
                if not torch.equal(first, second):
                    raise AssertionError(f"{kname} {dname} at xp {xps} w "
                                         f"{ws}: two calls gave different "
                                         "bits")
            for kname, kind, got, ref in checks:
                if got.shape != ref.shape or got.dtype != ref.dtype:
                    raise AssertionError(
                        f"{kname} {dname} at xp {xps} w {ws}: got "
                        f"{tuple(got.shape)} {got.dtype}, plain "
                        f"{tuple(ref.shape)} {ref.dtype}")
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{kname} {dname} at xp {xps} w "
                                         f"{ws}: non-finite output")
                a, r = rel_err(got, ref)
                if r > TOL[(kind, dname)]:
                    raise AssertionError(
                        f"{kname} {dname} at xp {xps} w {ws}: max abs err "
                        f"{a:.3e} (rel {r:.3e}) > tolerance "
                        f"{TOL[(kind, dname)]:.0e}")
                worst[kname] = max(worst[kname], (a, r), key=lambda t: t[1])
        for kname, (a, r) in worst.items():
            log(f"    {kname:12s} {dname:4s} worst max abs err {a:.3e} "
                f"rel {r:.3e} (tolerance {TOL[('conv' if 'fwd' in kname else 'dw', dname)]:.0e}) ok")
            results.setdefault(kname, {})[f"max_abs_err_{dname}"] = a


def check_radon_kernels(results: dict) -> dict:
    import torch
    from mfvi_dip_mia_tpu_torch.ops.kernels import radon_banded as rb
    from mfvi_dip_mia_tpu_torch.tasks.problems import _CT_THETA

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    states = {}
    t0 = time.perf_counter()
    for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        states[dname] = rb.prepare_banded_direct(
            _CT_THETA, SIZE, SIZE, dtype=dtype, device=DEVICE)
    log(f"[2] Radon bands built in {time.perf_counter() - t0:.2f} s: "
        f"blocks {tuple(states['bf16'].blocks.shape)}, tchunk "
        f"{states['bf16'].tchunk}")
    for dname, st in states.items():
        g_count, _, _, pp = st.blocks.shape
        v = torch.rand((1, g_count * pp), generator=gen, device=DEVICE)
        y = torch.randn((st.t_pad * st.w, 1), generator=gen, device=DEVICE)
        for kname, got, ref in (
                ("radon_banded_fwd", rb.radon_fwd(st, v),
                 rb.radon_fwd_plain(st, v)),
                ("radon_banded_adj", rb.radon_adj(st, y),
                 rb.radon_adj_plain(st, y))):
            torch.cuda.synchronize()
            a, r = rel_err(got, ref)
            if got.shape != ref.shape or r > TOL[("radon", dname)]:
                raise AssertionError(
                    f"{kname} {dname} band: shape {tuple(got.shape)} vs "
                    f"{tuple(ref.shape)}, max abs err {a:.3e} (rel {r:.3e})")
            log(f"    {kname:16s} {dname:4s} band max abs err {a:.3e} "
                f"rel {r:.3e} (tolerance {TOL[('radon', dname)]:.0e}) ok")
            results.setdefault(kname, {})[f"max_abs_err_{dname}"] = a
        # the adjoint identity <A v, y> = <v, A^T y> on the kernels
        lhs = float((rb.radon_fwd(st, v) * y).double().sum())
        rhs = float((v * rb.radon_adj(st, y)).double().sum())
        if abs(lhs - rhs) > 1e-4 * max(abs(lhs), 1.0):
            raise AssertionError(f"adjoint identity {dname}: {lhs} vs {rhs}")
    return states


def fused_sites(net, size: int) -> list[dict]:
    """Every site of ``net`` on a size^2 f32 input that runs as the fused
    block (nn/skip.py: stride 1, k in {1, 3}, no dropout): (Ci, Co, H, W, k), and
    whether the backward needs its dx (level 0's skip reads the input z)."""
    sites = []
    for i, cfg in enumerate(net.levels):
        s = size >> i
        for name, site, s_in in (("skip", cfg.skip_conv, s),
                                 ("down2", cfg.down2, s // 2),
                                 ("up", cfg.up, s), ("up1x1", cfg.up1x1, s)):
            if (site is None or site.stride != 1 or site.kernel not in (1, 3)
                    or site.dropout_mode != "None"):
                continue
            sites.append(dict(name=f"levels.{i}.{name}", ci=site.c_in,
                              co=site.c_out, h=s_in, w=s_in, k=site.kernel,
                              needs_dx=not (i == 0 and name == "skip")))
    return sites


def fused_operands(site: dict, gen):
    """(xp, w, gamma, beta, g) on the card: the reflection-padded input, the
    OIHW kernel, the BN affine and a cotangent of the output."""
    import torch
    import torch.nn.functional as F
    ci, co, h, w, k = (site[n] for n in ("ci", "co", "h", "w", "k"))
    p = (k - 1) // 2
    x = torch.randn((1, ci, h, w), generator=gen, device=DEVICE)
    xp = (F.pad(x, (p,) * 4, mode="reflect") if p else x)[0].contiguous()
    wk = torch.randn((co, ci, k, k), generator=gen, device=DEVICE) / (
        ci * k * k) ** 0.5
    gamma = torch.rand((co,), generator=gen, device=DEVICE) + 0.5
    beta = torch.randn((co,), generator=gen, device=DEVICE)
    g = torch.randn((co, h, w), generator=gen, device=DEVICE)
    return xp, wk, gamma, beta, g


# Fused-block shapes beyond the den net's sites, (Ci, Co, H, W, k): ragged
# channel tiles (36 / 68 / 132), Co = 4, an 8^2 site, widths that are no
# multiple of 4 (the dw's element-wise copy of dconv)
EXTRA_FUSED_SHAPES = ((36, 68, 20, 27, 3), (68, 4, 33, 17, 3),
                      (16, 36, 8, 8, 3), (132, 36, 12, 40, 1))


# The dc kernel beyond the den net's sites, (Ci, Co, H, W, k): 16 channels
# of 512^2 (bench.py --size 512's level 0), whose slices do not fit in a
# cluster's shared memory
DC_WIDE_SHAPES = ((16, 16, 512, 512, 1),)


def hold_fused(checks, shape, worst: dict) -> None:
    """Each (kernel, what, got, ref) within TOL_FUSED[what] of the largest
    |ref|; the worst error per (kernel, what) into ``worst``."""
    for kname, what, got, ref in checks:
        if got.shape != ref.shape or not bool(got.isfinite().all()):
            raise AssertionError(
                f"{kname} {what} at {shape}: shape {tuple(got.shape)} vs "
                f"{tuple(ref.shape)} or non-finite values")
        a, r = rel_err(got, ref)
        if r > TOL_FUSED[what]:
            raise AssertionError(
                f"{kname} {what} at (Ci, Co, H, W, k) {shape}: max abs "
                f"err {a:.3e} (rel {r:.3e}) > tolerance "
                f"{TOL_FUSED[what]:.0e}")
        if r >= worst.get((kname, what), (0.0, -1.0))[1]:
            worst[(kname, what)] = (a, r)


def check_dc(g, out, stats, gamma, beta, shape, worst: dict) -> None:
    """fused_block_bwd_dc against bwd_dc_plain, launched twice: its sums
    have one order, fixed by the shape, so the bits must repeat."""
    import torch
    from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb

    got = tfb.bwd_dc(g, out, stats, gamma, beta)
    again = tfb.bwd_dc(g, out, stats, gamma, beta)
    ref = tfb.bwd_dc_plain(g, out, stats, gamma, beta)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"fused_block_bwd_dc at {shape}: two calls gave "
                             "different bits")
    hold_fused([("fused_block_bwd_dc", what, a, r) for what, a, r in zip(
        ("dconv", "dgamma", "dbeta"), got, ref)], shape, worst)


def check_fused_kernels(sites, results: dict) -> None:
    """Each fused kernel against its plain version at every distinct
    fused-site shape and at EXTRA_FUSED_SHAPES, the dc also at
    DC_WIDE_SHAPES; the backward kernels take the plain forward's out and
    stats and the plain dconv, so each is held alone. Every kernel is called
    twice for the same bits."""
    import torch
    from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb

    gen = torch.Generator(device=DEVICE).manual_seed(4)
    shapes = {}
    for s in sites:
        shapes.setdefault(tuple(s[n] for n in ("ci", "co", "h", "w", "k")), s)
    for shape in EXTRA_FUSED_SHAPES:
        shapes[shape] = dict(zip(("ci", "co", "h", "w", "k"), shape))
    log(f"[2] fused-block kernels at {len(shapes)} distinct shapes of "
        f"{len(sites)} fused sites and {len(EXTRA_FUSED_SHAPES)} odd shapes, "
        f"the dc also at {len(DC_WIDE_SHAPES)} shape(s) of 512^2")
    worst = {}
    mu_f64 = {"kernel": 0.0, "plain": 0.0}
    for shape, s in shapes.items():
        xp, wk, gamma, beta, g = fused_operands(s, gen)
        k = s["k"]
        out, stats = tfb.fwd(xp, wk, gamma, beta)
        out_p, stats_p = tfb.fwd_plain(xp, wk, gamma, beta)
        # fixed-order channel sums: the same bits on every call
        out2, stats2 = tfb.fwd(xp, wk, gamma, beta)
        torch.cuda.synchronize()
        if not (torch.equal(out, out2) and torch.equal(stats, stats2)):
            raise AssertionError(f"fused_block_fwd at {shape}: two calls "
                                 "gave different bits")
        dc_p, dgam_p, dbet_p = tfb.bwd_dc_plain(g, out_p, stats_p, gamma,
                                                beta)
        dw, dx = tfb.bwd_dw(dc_p, xp, k), tfb.bwd_dx(dc_p, wk)
        # a cluster's partial tiles are summed in rank order, the dw's
        # groups of clusters in index order: the same bits on every call
        for kname, first, second in (
                ("fused_block_bwd_dw", dw, tfb.bwd_dw(dc_p, xp, k)),
                ("fused_block_bwd_dx", dx, tfb.bwd_dx(dc_p, wk))):
            torch.cuda.synchronize()
            if not torch.equal(first, second):
                raise AssertionError(f"{kname} at {shape}: two calls gave "
                                     "different bits")
        # both batch means against the float64 conv's: the kernel's error
        # beside the plain version's own
        mu64 = torch.nn.functional.conv2d(xp[None].double(), wk.double())[
            0].mean(dim=(1, 2))
        for who, mu in (("kernel", stats[:, 0]), ("plain", stats_p[:, 0])):
            r64 = float((mu.double() - mu64).abs().max()
                        / mu64.abs().max())
            mu_f64[who] = max(mu_f64[who], r64)
        checks = [
            ("fused_block_fwd", "out", out, out_p),
            ("fused_block_fwd", "mu", stats[:, 0], stats_p[:, 0]),
            ("fused_block_fwd", "inv", stats[:, 1], stats_p[:, 1]),
            ("fused_block_bwd_dw", "dw", dw, tfb.bwd_dw_plain(dc_p, xp, k)),
            ("fused_block_bwd_dx", "dx", dx, tfb.bwd_dx_plain(dc_p, wk)),
        ]
        torch.cuda.synchronize()
        hold_fused(checks, shape, worst)
        check_dc(g, out_p, stats_p, gamma, beta, shape, worst)
    # a channel wider than a cluster's shared memory (dc_plan keeps what
    # fits and re-reads the rest)
    for shape in DC_WIDE_SHAPES:
        xp, wk, gamma, beta, g = fused_operands(
            dict(zip(("ci", "co", "h", "w", "k"), shape)), gen)
        out_p, stats_p = tfb.fwd_plain(xp, wk, gamma, beta)
        check_dc(g, out_p, stats_p, gamma, beta, shape, worst)
    for (kname, what), (a, r) in worst.items():
        log(f"    {kname:18s} {what:6s} worst max abs err {a:.3e} rel "
            f"{r:.3e} (tolerance {TOL_FUSED[what]:.0e}) ok")
        res = results.setdefault(kname, {})
        res["max_abs_err_f32"] = max(res.get("max_abs_err_f32", 0.0), a)
        res.setdefault("errors", {})[what] = dict(max_abs_err=a, rel=r)
    log(f"    fused_block_fwd mu against the float64 conv's mean, worst rel: "
        f"kernel {mu_f64['kernel']:.3e}, plain {mu_f64['plain']:.3e}")
    results["fused_block_fwd"]["mu_rel_err_vs_f64"] = mu_f64


def lrt_operands(site: dict, dtype, gen):
    """(xp, w_mu, w_var, g) of one LRT site as the kernel sees it: the
    padded input (or its stride-2 planes), both weights (w_var positive,
    softplus(rho)^2-sized) and a cotangent of the outputs."""
    import torch
    xp, w_mu, g = conv_operands(site, dtype, gen)
    w_var = (torch.rand(site["w"], generator=gen, device=DEVICE)
             * 0.01).to(dtype)
    return xp, w_mu, w_var, g


def lrt_backward_plain(xp, w_mu, w_var, g_mu, g_var):
    """(dxp, dw_mu, dw_var) of the double conv from the conv's plain
    versions (lrt_conv_pallas.py::_vjp_bwd on the padded input)."""
    from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf
    k = w_mu.shape[2]
    dx = (tcf.conv_dx_plain(g_mu, w_mu)
          + 2.0 * xp * tcf.conv_dx_plain(g_var, w_var))
    return (dx, tcf.conv_dw_plain(xp, g_mu, k, k),
            tcf.conv_dw_plain(xp * xp, g_var, k, k))


def check_lrt_kernel(sites, results: dict) -> None:
    """``lrt_conv_fwd`` against its plain version at every distinct LRT site
    shape of the 256^2 den net (21 stride-1 sites and 5 stride-2 sites on
    parity planes), in f32 and bf16; its autograd backward (the conv's dx
    and dw kernels) against the plain formulas at every fourth shape."""
    import torch
    from mfvi_dip_mia_tpu_torch.ops.kernels import lrt_conv as tlrt

    gen = torch.Generator(device=DEVICE).manual_seed(8)
    shapes = {}
    for s in sites:
        shapes.setdefault((s["xp"], s["w"]), s)
    log(f"[2] LRT double conv at {len(shapes)} distinct shapes of "
        f"{len(sites)} LRT sites")
    worst = {}

    def hold(kind, dname, what, shape, got, ref):
        if got.shape != ref.shape or got.dtype != ref.dtype or not bool(
                torch.isfinite(got).all()):
            raise AssertionError(
                f"lrt_conv_fwd {what} {dname} at {shape}: {tuple(got.shape)} "
                f"{got.dtype} vs {tuple(ref.shape)} {ref.dtype}, or not "
                "finite")
        a, r = rel_err(got, ref)
        if r > TOL[(kind, dname)]:
            raise AssertionError(
                f"lrt_conv_fwd {what} {dname} at xp/w {shape}: max abs err "
                f"{a:.3e} (rel {r:.3e}) > tolerance {TOL[(kind, dname)]:.0e}")
        if r >= worst.get((kind, dname, what), (0.0, -1.0))[1]:
            worst[(kind, dname, what)] = (a, r)

    for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for n, ((xps, ws), s) in enumerate(shapes.items()):
            xp, w_mu, w_var, g = lrt_operands(s, dtype, gen)
            got = tlrt.double_conv_fwd(xp, w_mu, w_var)
            ref = tlrt.fused_double_conv(xp, w_mu, w_var)
            torch.cuda.synchronize()
            for what, a, b in zip(("act_mu", "act_var"), got, ref):
                hold("lrt", dname, what, (xps, ws), a, b)
            if dtype != torch.float32 or n % 4:
                continue
            g_var = torch.randn(g.shape, generator=gen, device=DEVICE)
            args = [t.clone().requires_grad_(True) for t in (xp, w_mu, w_var)]
            mu, var = tlrt.lrt_double_conv(*args)
            grads = torch.autograd.grad(
                (mu * g).sum() + (var * g_var).sum(), args)
            plain = lrt_backward_plain(xp, w_mu, w_var, g, g_var)
            torch.cuda.synchronize()
            for what, a, b in zip(("dxp", "dw_mu", "dw_var"), grads, plain):
                hold("lrt_bwd", dname, what, (xps, ws), a, b)
    for (kind, dname, what), (a, r) in sorted(worst.items()):
        log(f"    lrt_conv_fwd {what:7s} {dname:4s} worst max abs err "
            f"{a:.3e} rel {r:.3e} (tolerance {TOL[(kind, dname)]:.0e}) ok")
    res = results.setdefault("lrt_conv_fwd", {})
    res["errors"] = {f"{what}_{dname}": dict(max_abs_err=a, rel=r)
                     for (_, dname, what), (a, r) in worst.items()}
    # the path runs f32: its forward error is the kernel's error
    res["max_abs_err"] = max(worst[("lrt", "f32", w)][0]
                             for w in ("act_mu", "act_var"))


def check_dense_radon(results: dict):
    """The bf16 projection matrix at 256^2 / 45 angles, built once (it is
    cached for path B), and the dense forward and adjoint kernels against
    their plain versions on it at 1 and 3 image columns, each launched
    DENSE_REPEATS times for the same bits, with the adjoint identity."""
    import torch
    from mfvi_dip_mia_tpu_torch.ops import radon as tradon
    from mfvi_dip_mia_tpu_torch.ops.kernels import radon_dense as rd
    from mfvi_dip_mia_tpu_torch.tasks.problems import _CT_THETA

    t0 = time.perf_counter()
    a = tradon.dense_matrix_bf16(_CT_THETA, SIZE, SIZE, DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"[2] dense bf16 projection matrix {tuple(a.shape)} "
        f"({a.numel() * 2 / 1e9:.3f} GB) built and cast in {build_s:.1f} s")
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    tol = TOL[("radon_dense", "bf16")]
    for cols in (1, 3):
        v = torch.rand((cols, a.shape[1]), generator=gen, device=DEVICE)
        y = torch.randn((cols, a.shape[0]), generator=gen, device=DEVICE)
        for kname, fn, ref in (
                ("radon_dense_fwd", lambda: rd.radon_dense_fwd(a, v),
                 rd.radon_dense_fwd_plain(a, v)),
                ("radon_dense_adj", lambda: rd.radon_dense_adj(a, y),
                 rd.radon_dense_adj_plain(a, y))):
            got = fn()
            again = [fn() for _ in range(DENSE_REPEATS - 1)]
            torch.cuda.synchronize()
            err, r = rel_err(got, ref)
            if got.shape != ref.shape or r > tol:
                raise AssertionError(
                    f"{kname} ({cols} columns): shape {tuple(got.shape)} vs "
                    f"{tuple(ref.shape)}, max abs err {err:.3e} (rel "
                    f"{r:.3e})")
            differ = sum(not torch.equal(got, o) for o in again)
            if differ:
                raise AssertionError(
                    f"{kname} ({cols} columns): {differ} of "
                    f"{DENSE_REPEATS - 1} launches gave other bits than the "
                    "first")
            log(f"    {kname:16s} {cols} column(s): max abs err {err:.3e} "
                f"rel {r:.3e} (tolerance {tol:.0e}), {DENSE_REPEATS} "
                "launches equal bits ok")
            res = results.setdefault(kname, {})
            res["max_abs_err"] = max(res.get("max_abs_err", 0.0), err)
        if cols == 1:
            lhs = float((rd.radon_dense_fwd(a, v) * y).double().sum())
            rhs = float((v * rd.radon_dense_adj(a, y)).double().sum())
            if abs(lhs - rhs) > 1e-4 * max(abs(lhs), 1.0):
                raise AssertionError(f"dense adjoint identity: {lhs} vs "
                                     f"{rhs}")
            log(f"    adjoint identity <Av, y> {lhs:.6e} vs <v, A^T y> "
                f"{rhs:.6e} ok")
    # odd shapes, random bf16 matrices: strips narrower than a stage and
    # ragged (Q = 96, 4104), more splits per strip than one batch of the
    # adjoint's sum, tiles of one row, g padded to 4 floats (cols * P % 4)
    for p, q in ODD_DENSE_SHAPES:
        m = torch.randn((p, q), generator=gen, device=DEVICE).to(torch.bfloat16)
        for cols in (1, 3):
            v = torch.randn((cols, q), generator=gen, device=DEVICE)
            y = torch.randn((cols, p), generator=gen, device=DEVICE)
            for kname, fn, ref in (
                    ("radon_dense_fwd", lambda: rd.radon_dense_fwd(m, v),
                     rd.radon_dense_fwd_plain(m, v)),
                    ("radon_dense_adj", lambda: rd.radon_dense_adj(m, y),
                     rd.radon_dense_adj_plain(m, y))):
                got, again = fn(), fn()
                torch.cuda.synchronize()
                err, r = rel_err(got, ref)
                if got.shape != ref.shape or r > tol or not torch.equal(
                        got, again):
                    raise AssertionError(
                        f"{kname} at A ({p}, {q}), {cols} columns: rel err "
                        f"{r:.3e}, equal bits {torch.equal(got, again)}")
        log(f"    dense pair at A ({p}, {q}), 1 and 3 columns: ok")
    results["radon_dense_fwd"]["matrix_build_seconds"] = build_s
    return a


ODD_DENSE_SHAPES = ((270, 96), (1000, 4104))
# launches of each dense kernel at 256^2 that must give equal bits: a race
# between a stage's readers and its refill (csrc/bulk_copy.cuh::
# fence_proxy_async) changed the bits of only some adjoint launches
DENSE_REPEATS = 40


# -- phase 3: the main path ---------------------------------------------------

def check_step_against_cpu(net, task: str, reparam: str = "rt") -> dict:
    """One f32 loss and its parameter gradient through the 256^2 net, on the
    card (the kernels) and on the CPU (their plain versions), from the same
    weights, noise and input: the slice's model against its reference on
    one input. ct: MSE of the banded Radon sinograms; den: the Gaussian NLL
    of the noisy x-ray. RT: one sampled tree, gradients by sampled leaf;
    LRT: the mu / rho tree with one fixed eps per site (nn/var_conv.py::
    lrt_eps held to a table), gradients by mu / rho leaf."""
    import numpy as np
    import torch
    import mfvi_dip_mia_tpu_torch.nn.var_conv as tvc
    from mfvi_dip_mia_tpu_torch.bayes import vi
    from mfvi_dip_mia_tpu_torch.ops.losses import gaussian_nll, mse_loss
    from mfvi_dip_mia_tpu_torch.ops.radon import FastRadonTransform
    from mfvi_dip_mia_tpu_torch.tasks.data import synthetic_ct, synthetic_xray
    from mfvi_dip_mia_tpu_torch.tasks.problems import _CT_THETA
    from mfvi_dip_mia_tpu_torch.utils.images import add_gaussian_noise, get_noise

    gen = torch.Generator().manual_seed(5)
    flat = vi.flatten(vi.to_mfvi(net.init_params(gen), gen))
    leaves = ({k: v.detach().clone() for k, v in flat.leaves().items()}
              if reparam == "lrt" else
              {k: v.detach().clone() for k, v in
               vi.sample_mfvi_tree(flat, gen).items()})
    z = torch.from_numpy(get_noise(16, SIZE, rng=np.random.default_rng(5))
                         ).permute(0, 3, 1, 2).contiguous()
    if task == "ct":
        gt = torch.from_numpy(synthetic_ct(0, SIZE))[None]
    else:
        noisy = torch.from_numpy(add_gaussian_noise(
            synthetic_xray(0, SIZE), 0.1, np.random.default_rng(5)))[None]
    table = {}

    def fixed_eps(shape, generator, site_id):
        if site_id not in table:
            table[site_id] = torch.randn(
                tuple(shape), generator=torch.Generator().manual_seed(
                    100 + site_id))
        return table[site_id].to(generator.device)

    got = {}
    saved_eps, tvc.lrt_eps = tvc.lrt_eps, fixed_eps
    try:
        for dev in ("cpu", DEVICE):
            p = {k: v.detach().clone().to(dev).requires_grad_(True)
                 for k, v in leaves.items()}
            out = net(p, z.to(dev), torch.Generator(device=dev),
                      reparam=reparam)
            if task == "ct":
                radon = FastRadonTransform(gt.shape, _CT_THETA,
                                           mode="banded", device=dev)
                loss = mse_loss(radon(out), radon(gt.to(dev)))
            else:
                loss = gaussian_nll(out[:, :1], out[:, 1:], noisy.to(dev))
            loss.backward()
            got[dev] = (out.detach().cpu(), loss.detach().cpu(),
                        {k: v.grad.cpu() for k, v in p.items()
                         if v.grad is not None})
    finally:
        tvc.lrt_eps = saved_eps
    (o_c, l_c, g_c), (o_d, l_d, g_d) = got["cpu"], got[DEVICE]
    _, r_out = rel_err(o_d, o_c)
    r_loss = abs(float(l_d - l_c)) / abs(float(l_c))
    scale = max(float(g.abs().max()) for g in g_c.values())
    r_grad = max(float((g_d[k] - g).abs().max()) for k, g in g_c.items()
                 ) / scale
    label = task if reparam == "rt" else f"{task} {reparam}"
    log(f"[3] one f32 {label} step at {SIZE}^2, card vs CPU plain path: "
        f"output rel {r_out:.2e}, loss rel {r_loss:.2e}, gradients rel "
        f"{r_grad:.2e} (tolerances {TOL_STEP['out']:.0e} / "
        f"{TOL_STEP['loss']:.0e} / {TOL_STEP['grad']:.0e})")
    if reparam == "lrt" and len(table) != net.num_conv_sites:
        raise AssertionError(f"{len(table)} LRT sites drew noise")
    if set(g_d) != set(g_c) or not (
            r_out <= TOL_STEP["out"] and r_loss <= TOL_STEP["loss"]
            and r_grad <= TOL_STEP["grad"]):
        raise AssertionError(f"the card's {label} step disagrees with the "
                             "CPU's")
    return dict(out_rel=r_out, loss_rel=r_loss, grad_rel=r_grad)


# the kernels each path launches; every other kernel must stay at 0 there
CONV = {"cf_conv_fwd", "cf_conv_dw"}
BANDED = {"radon_banded_fwd", "radon_banded_adj"}
FUSED = {"fused_block_fwd", "fused_block_bwd_dc", "fused_block_bwd_dw",
         "fused_block_bwd_dx"}
DENSE = {"radon_dense_fwd", "radon_dense_adj"}
# the path whose launches each kernel's line reports
PATH_OF = {**{k: "ct" for k in CONV | BANDED}, **{k: "den" for k in FUSED},
           "lrt_conv_fwd": "lrt_den", **{k: "dense_ct" for k in DENSE}}


def hold_launches(path: str, launches: dict, expected: set) -> None:
    for name, n in launches.items():
        if (n > 0) != (name in expected):
            raise AssertionError(
                f"kernel {name} was launched {n} times on {path} (expected "
                f"launches of {sorted(expected)} only)")


def steps_run(res) -> int:
    """The steps a fit ran on the card: its iterations, and before a graph
    fit's capture its two eager warm-up steps (one of each variant), which
    launch every kernel too."""
    return res.executed + res.warmup_steps


def hold_replays(path: str, res) -> None:
    if res.replays != res.executed:
        raise AssertionError(f"{path}: {res.replays} of {res.executed} "
                             "iterations were graph replays")


def eager_rate(problem, method, **kw) -> float:
    """it/s of the same fit run eagerly (``fit(..., eager=True)``), for the
    line beside the graph fit's."""
    from mfvi_dip_mia_tpu_torch.tasks.trainer import fit
    res = fit(problem, method, eager=True, **kw)
    if res.replays:
        raise AssertionError("an eager fit replayed a graph")
    return res.iters_per_sec


def use_bench_images() -> None:
    """bench.py's images: the synthetic CT slice and x-ray at SIZE^2."""
    import mfvi_dip_mia_tpu_torch.tasks.data as D
    import mfvi_dip_mia_tpu_torch.tasks.problems as P
    P.D.get_img_ct = lambda img: (D.synthetic_ct(img, SIZE), (SIZE, SIZE))
    P.D.get_image_denoising = lambda img: (D.synthetic_xray(img, SIZE),
                                           (SIZE, SIZE))


REPRO_ITERS = 60
METRIC_ROWS = ("mse_corrupted", "mse_gt", "psnrs", "ssims")


def fit_paths() -> tuple:
    """The four paths' fits: (label, task, method, compute dtype, fit
    keywords, build_problem keywords)."""
    from mfvi_dip_mia_tpu_torch.tasks.trainer import Method
    den = Method("mfvi", temp=5.66e-7, sigma=1.46e-5)
    ct = Method("mfvi", temp=2.2e-10, sigma=1.7e-7)
    return (("den f32", "den", den, "f32", {}, {}),
            ("ct bf16", "ct", ct, "bf16", {}, {}),
            ("path A, LRT den f32", "den", den, "f32", dict(reparam="lrt"),
             {}),
            ("path B, dense CT bf16", "ct", ct, "bf16", {},
             dict(radon_mode="dense-bf16")))


def reproducibility() -> dict:
    """The den f32 fit, the CT bf16 fit, path A's LRT den f32 fit and path
    B's dense CT bf16 fit, each run twice in this process through ``fit``
    (graph replays) at seed 1 for REPRO_ITERS iterations (metric rows every
    iteration):
    whether the two runs' metric rows and final parameters are equal bit
    for bit, and the first iteration whose row differs. The caller decides
    what a difference means (chip_smoke.py raises)."""
    import numpy as np
    import mfvi_dip_mia_tpu_torch.tasks.problems as P
    from mfvi_dip_mia_tpu_torch.tasks.trainer import fit

    use_bench_images()
    out = {}
    for label, task, method, dtype, kw, op in fit_paths():
        problem = P.build_problem(task, "mfvi", 0, input_depth=16,
                                  device=DEVICE, **op)
        a, b = (fit(problem, method, num_iter=REPRO_ITERS - 1, lr=1e-3,
                    seed=1, show_every=REPRO_ITERS, metrics_every=1,
                    compute_dtype=dtype, collect_snapshots=False,
                    device=DEVICE, **kw) for _ in range(2))
        for r in (a, b):
            hold_replays(f"the reproducibility fit, {label}", r)
        differ = np.zeros(a.executed, bool)
        for f in METRIC_ROWS:
            ra, rb = getattr(a, f), getattr(b, f)
            differ |= ~((ra == rb) | (np.isnan(ra) & np.isnan(rb))).reshape(
                a.executed, -1).all(axis=1)
        leaves = [k for k in a.params
                  if not np.array_equal(a.params[k], b.params[k],
                                        equal_nan=True)]
        first = int(np.argmax(differ)) if differ.any() else None
        out[label] = dict(iterations=a.executed, rows_equal=not differ.any(),
                          first_row_differing=first,
                          params_equal=not leaves,
                          leaves_differing=len(leaves),
                          leaves=len(a.params),
                          final_psnr=[a.final_psnr, b.final_psnr])
        log(f"[3] reproducibility, {label}: two {a.executed}-iteration fits "
            f"at seed 1: metric rows "
            + ("equal" if first is None else
               f"differ from iteration {first}")
            + ", final parameters "
            + ("equal" if not leaves else
               f"differ in {len(leaves)} of {len(a.params)} leaves")
            + f" (final PSNR {a.final_psnr!r} / {b.final_psnr!r} dB)")
    return out


def run_fits(results: dict) -> dict:
    import numpy as np
    from mfvi_dip_mia_tpu_torch.ops import kernels
    import mfvi_dip_mia_tpu_torch.tasks.problems as P
    from mfvi_dip_mia_tpu_torch.tasks.trainer import Method, fit

    use_bench_images()
    out = {}

    problem = P.build_problem("ct", "mfvi", 0, input_depth=16,
                              device=DEVICE)
    if problem.operator.mode != "banded-bf16":
        raise AssertionError(f"CT operator mode {problem.operator.mode}")
    method = Method("mfvi", temp=2.2e-10, sigma=1.7e-7)
    n_iter = CT_ITERS_WARM + CT_ITERS_TIMED
    kw = dict(num_iter=n_iter - 1, lr=1e-3, seed=1,
              show_every=CT_ITERS_WARM, metrics_every=10,
              compute_dtype="bf16", collect_snapshots=False, device=DEVICE)
    kernels.reset_launches()
    res = fit(problem, method, **kw)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    eager = eager_rate(problem, method, **kw)
    traj = res.psnrs[::10, 2]
    log(f"[3] ct/mfvi bf16 {SIZE}^2: {res.executed} iterations, graph "
        f"{res.iters_per_sec:.2f} it/s, eager {eager:.2f} it/s over the last "
        f"{CT_ITERS_TIMED} (graph's first chunk incl. set-up "
        f"{res.compile_seconds:.1f} s)")
    log("    smoothed PSNR every 10 it: "
        + " ".join(f"{p:.2f}" for p in traj))
    log(f"    final smoothed PSNR {res.final_psnr:.3f} dB (iteration 0: "
        f"{res.psnrs[0, 2]:.3f}); launches {launches}")
    if not (np.isfinite(res.final_psnr)
            and res.final_psnr > res.psnrs[0, 2]):
        raise AssertionError("CT fit did not improve on iteration 0")
    hold_launches("the bf16 CT main path", launches, CONV | BANDED)
    hold_replays("the bf16 CT main path", res)
    out["ct"] = dict(iters_per_sec=res.iters_per_sec,
                     eager_iters_per_sec=eager,
                     final_psnr=res.final_psnr,
                     psnr_it0=float(res.psnrs[0, 2]),
                     psnr_every10=[float(p) for p in traj],
                     executed=res.executed, steps_run=steps_run(res),
                     launches=launches,
                     launches_per_step={k: n / steps_run(res)
                                        for k, n in launches.items()})
    out["den"] = run_den(kernels)
    out["lrt_den"] = run_lrt_den(kernels)
    out["dense_ct"] = run_dense_ct(kernels)
    return out


def run_lrt_den(kernels) -> dict:
    """Path A: the den/MFVI f32 fit through ``fit(..., reparam="lrt")``,
    every conv site on the LRT kernel, then the runner's 25-sample LRT
    posterior summary (runners.py::mc_summary)."""
    import numpy as np
    import torch
    import mfvi_dip_mia_tpu_torch.tasks.problems as P
    import mfvi_dip_mia_tpu_torch.tasks.runners as R
    from mfvi_dip_mia_tpu_torch.tasks.trainer import Method, fit

    problem = P.build_problem("den", "mfvi", 0, input_depth=16,
                              device=DEVICE)
    n_sites = problem.net.num_conv_sites
    method = Method("mfvi", temp=5.66e-7, sigma=1.46e-5)
    kw = dict(num_iter=PATH_ITERS_WARM + PATH_ITERS_TIMED - 1, lr=1e-3,
              seed=1, show_every=PATH_ITERS_WARM, metrics_every=1,
              compute_dtype="f32", collect_snapshots=False, device=DEVICE,
              reparam="lrt")
    kernels.reset_launches()
    res = fit(problem, method, **kw)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    per_step = {k: n / steps_run(res) for k, n in launches.items()}
    eager = eager_rate(problem, method, **kw)
    log(f"[3] path A, den/mfvi f32 LRT {SIZE}^2 through fit(reparam='lrt'): "
        f"{res.executed} iterations, graph {res.iters_per_sec:.2f} it/s, "
        f"eager {eager:.2f} it/s over the last {PATH_ITERS_TIMED} (graph's "
        f"first chunk incl. set-up {res.compile_seconds:.1f} s), final "
        f"smoothed PSNR {res.final_psnr:.3f} dB (iteration 0: "
        f"{res.psnrs[0, 2]:.3f})")
    log(f"    launches per step {per_step}")
    if not (np.isfinite(res.final_psnr)
            and res.final_psnr > res.psnrs[0, 2]):
        raise AssertionError("LRT den fit did not improve on iteration 0")
    hold_launches("path A's fit", launches, CONV | {"lrt_conv_fwd"})
    hold_replays("path A's fit", res)
    if launches["lrt_conv_fwd"] != n_sites * steps_run(res):
        raise AssertionError(f"lrt_conv_fwd launched "
                             f"{launches['lrt_conv_fwd']} times in "
                             f"{steps_run(res)} steps of {n_sites} sites")

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mc = R.mc_summary(problem, res.params, res.net_input, seed=1 + 77,
                      n_samples=MC_SAMPLES, reparam="lrt")
    torch.cuda.synchronize()
    mc_rate = MC_SAMPLES / (time.perf_counter() - t0)
    mc_launches = {k.name: k.launches for k in kernels.KERNELS}
    log(f"[3] path A's posterior summary: {MC_SAMPLES} LRT samples, MC mean "
        f"PSNR {mc['mc_mean_psnr']:.3f} dB, {mc_rate:.1f} samples/s; "
        f"launches {mc_launches}")
    hold_launches("path A's posterior summary", mc_launches,
                  {"lrt_conv_fwd"})
    # the summary replays one sample's graph, after one eager warm sample
    if (mc_launches["lrt_conv_fwd"] != n_sites * (MC_SAMPLES + 1)
            or not np.isfinite(mc["mc_mean_psnr"])
            or not np.isfinite(mc["mc_epi"]).all()):
        raise AssertionError("path A's posterior summary failed")
    return dict(iters_per_sec=res.iters_per_sec, eager_iters_per_sec=eager,
                final_psnr=res.final_psnr, psnr_it0=float(res.psnrs[0, 2]),
                mc_mean_psnr=mc["mc_mean_psnr"], mc_samples_per_sec=mc_rate,
                executed=res.executed, steps_run=steps_run(res),
                launches=launches, launches_per_step=per_step,
                mc_launches=mc_launches)


def run_dense_ct(kernels) -> dict:
    """Path B: the CT configuration through ``fit`` with the dense
    bf16-matrix Radon operator (radon_mode='dense-bf16'); its target
    sinogram is made by the same operator."""
    import numpy as np
    import mfvi_dip_mia_tpu_torch.tasks.problems as P
    from mfvi_dip_mia_tpu_torch.tasks.trainer import Method, fit

    t0 = time.perf_counter()
    problem = P.build_problem("ct", "mfvi", 0, input_depth=16, device=DEVICE,
                              radon_mode="dense-bf16")
    build_s = time.perf_counter() - t0
    if problem.operator.mode != "dense-bf16":
        raise AssertionError(f"CT operator mode {problem.operator.mode}")
    method = Method("mfvi", temp=2.2e-10, sigma=1.7e-7)
    kw = dict(num_iter=PATH_ITERS_WARM + PATH_ITERS_TIMED - 1, lr=1e-3,
              seed=1, show_every=PATH_ITERS_WARM, metrics_every=10,
              compute_dtype="bf16", collect_snapshots=False, device=DEVICE)
    kernels.reset_launches()
    res = fit(problem, method, **kw)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    per_step = {k: n / steps_run(res) for k, n in launches.items()}
    eager = eager_rate(problem, method, **kw)
    log(f"[3] path B, ct/mfvi bf16 {SIZE}^2 with the dense bf16 matrix: "
        f"problem built in {build_s:.1f} s (matrix cached), "
        f"{res.executed} iterations, graph {res.iters_per_sec:.2f} it/s, "
        f"eager {eager:.2f} it/s over the last {PATH_ITERS_TIMED}, final "
        f"smoothed PSNR {res.final_psnr:.3f} dB (iteration 0: "
        f"{res.psnrs[0, 2]:.3f})")
    log(f"    launches per step {per_step}")
    if not (np.isfinite(res.final_psnr)
            and res.final_psnr > res.psnrs[0, 2]):
        raise AssertionError("dense CT fit did not improve on iteration 0")
    hold_launches("path B", launches, CONV | DENSE)
    hold_replays("path B", res)
    if any(launches[k] != steps_run(res) for k in DENSE):
        raise AssertionError("the dense Radon kernels did not run once each "
                             "per step")
    return dict(iters_per_sec=res.iters_per_sec, eager_iters_per_sec=eager,
                final_psnr=res.final_psnr, psnr_it0=float(res.psnrs[0, 2]),
                executed=res.executed, steps_run=steps_run(res),
                problem_seconds=build_s, launches=launches,
                launches_per_step=per_step)


DEN_KEYS = {"mse_gt", "recons", "uncerts", "uncerts_ale", "psnrs", "ssims",
            "img_gt", "img_noisy", "mse_noisy", "mc_mean_recon",
            "mc_mean_psnr", "mc_mean_ssim", "mc_ale", "mc_epi"}


def run_den(kernels) -> dict:
    """The den/MFVI f32 fit through the user's entry point, run_den_mfvi,
    with its MC summary and save.npz; then the MC posterior sampling rate."""
    import glob
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch
    from mfvi_dip_mia_tpu_torch.bayes import vi
    from mfvi_dip_mia_tpu_torch.bayes.uncertainty import mc_predict
    import mfvi_dip_mia_tpu_torch.tasks.runners as R

    seen = {}
    fit = R.fit

    def fit_and_count(problem, method, **kw):
        seen["res"] = fit(problem, method, **kw)
        seen.update(problem=problem, method=method, kw=kw)
        seen["fit_launches"] = {k.name: k.launches for k in kernels.KERNELS}
        return seen["res"]

    tmp = tempfile.mkdtemp(prefix="chip_smoke_den_")
    R.fit = fit_and_count
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        final = R.run_den_mfvi(
            device=DEVICE, num_iter=DEN_ITERS - 1, lr=1e-3, temp=5.66e-7,
            sigma=1.46e-5, seed=1, input_depth=16, show_every=100,
            metrics_every=1, plot=False, save=True, save_path=tmp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels.KERNELS}
        (path,) = glob.glob(os.path.join(tmp, "*", "save.npz"))
        z = np.load(path, allow_pickle=True)
        arrays = {k: z[k].item() if z[k].dtype == object else z[k]
                  for k in z.files}
    finally:
        R.fit = fit
        shutil.rmtree(tmp, ignore_errors=True)
    res, problem = seen["res"], seen["problem"]
    per_step = {k: n / steps_run(res)
                for k, n in seen["fit_launches"].items()}
    mc_psnr = float(arrays["mc_mean_psnr"])
    # the runner's fit again, eagerly: its own net input (the runner's
    # stream has moved on), no callbacks
    eager = eager_rate(problem, seen["method"], **{
        k: v for k, v in seen["kw"].items()
        if k not in ("rng", "log_fn", "snapshot_fn")})
    log(f"[3] den/mfvi f32 {SIZE}^2 through run_den_mfvi: {res.executed} "
        f"iterations, graph {res.iters_per_sec:.2f} it/s (run wall "
        f"{wall:.1f} s), eager {eager:.2f} it/s, final smoothed PSNR "
        f"{final:.3f} dB (iteration 0: {res.psnrs[0, 2]:.3f}), 25-sample MC "
        f"mean PSNR {mc_psnr:.3f} dB")
    log(f"    launches per fit step {per_step}; whole run {launches}")
    if set(arrays) != DEN_KEYS:
        raise AssertionError(f"save.npz keys {sorted(arrays)}")
    for k, v in arrays.items():
        for a in (v.values() if isinstance(v, dict) else [v]):
            if not np.isfinite(np.asarray(a, np.float64)).all():
                raise AssertionError(f"save.npz {k} is not finite")
    if not (np.isfinite(final) and np.isfinite(mc_psnr)
            and final > res.psnrs[0, 2]):
        raise AssertionError("den fit did not improve on iteration 0")
    hold_launches("the den main path", launches, CONV | FUSED)
    hold_replays("the den main path", res)

    # MC posterior samples per second of mc_predict at SIZE^2 (bench.py
    # --metric mc's counterpart): the final parameters, 100 whole-tree draws
    flat = vi.flatten({k: torch.from_numpy(v) for k, v in res.params.items()},
                      device=DEVICE)
    x = torch.from_numpy(res.net_input).permute(0, 3, 1, 2).contiguous().to(
        DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    mc_predict(problem.net, flat, x, gen, 5)                 # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = mc_predict(problem.net, flat, x, gen, MC_SAMPLES_TIMED)
    torch.cuda.synchronize()
    mc_rate = MC_SAMPLES_TIMED / (time.perf_counter() - t0)
    if not torch.isfinite(outs).all():
        raise AssertionError("mc_predict gave non-finite samples")
    log(f"[3] mc_predict at {SIZE}^2: {mc_rate:.1f} posterior samples/s over "
        f"{MC_SAMPLES_TIMED} samples (graph replays; the call's warm sample "
        "and capture included)")
    return dict(iters_per_sec=res.iters_per_sec, eager_iters_per_sec=eager,
                final_psnr=final, psnr_it0=float(res.psnrs[0, 2]),
                mc_mean_psnr=mc_psnr, mc_samples_per_sec=mc_rate,
                executed=res.executed, steps_run=steps_run(res),
                run_wall_seconds=wall, launches=launches,
                fit_launches=seen["fit_launches"],
                launches_per_step=per_step)


# the port's kernels by their CUDA function names (csrc/*.cu), each matched
# at the start of an identifier (conv_fwd_kernel is not lrt_conv_fwd_kernel)
KERNEL_FUNCS = {"cf_conv_fwd": "conv_fwd_mma_kernel",
                "cf_conv_dw": "conv_dw_mma_kernel",
                "radon_banded_fwd": "radon_fwd_",
                "radon_banded_adj": "radon_adj_",
                "fused_block_fwd": "fused_fwd_mma_kernel",
                "fused_block_bwd_dc": "fused_bwd_dc_cluster_kernel",
                "fused_block_bwd_dw": "fused_bwd_dw_mma_kernel",
                "fused_block_bwd_dx": "fused_bwd_dx_mma_kernel",
                "lrt_conv_fwd": "lrt_conv_fwd_mma_kernel",
                **dict(DENSE_FUNCS)}


def profile_fit(label: str, problem, method, kw: dict, steps: int,
                step_ms: dict, site_tag: str | None = None) -> dict:
    """torch.profiler over a short fit in each mode of ``step_ms``
    ({"graph" / "eager": the unprofiled fit's ms per step in that mode}):
    device time by kernel, and the card's busy share of a step (the
    profiler slows the host, so the share is taken of the unprofiled step).
    A graph fit is profiled from its first replay: its warm-up and capture
    stay outside the window, so every step counted is a replay. With both
    modes, the kernels whose calls per step differ are listed by name.
    ``site_tag`` names a kernel whose device time is also given per launch
    of a step (in launch order, the median over the steps)."""
    out = {mode: _profile_mode(label, problem, method, kw, steps, ms,
                               mode == "eager", site_tag)
           for mode, ms in step_ms.items()}
    if len(out) == 2:
        calls = {m: out[m]["calls_per_step"] for m in ("eager", "graph")}
        differ = {k: [calls["eager"].get(k, 0.0), calls["graph"].get(k, 0.0)]
                  for k in sorted(set(calls["eager"]) | set(calls["graph"]))
                  if abs(calls["eager"].get(k, 0.0)
                         - calls["graph"].get(k, 0.0)) > 0.05}
        out["calls_differing"] = differ
        log(f"    {label}: kernels whose calls per step differ, eager / "
            "graph: " + ("; ".join(f"{k[:70]} {e:.2f} / {g:.2f}"
                                    for k, (e, g) in differ.items())
                         or "none"))
    return out


def _profile_mode(label: str, problem, method, kw: dict, steps: int,
                  step_ms: float, eager: bool, site_tag) -> dict:
    import statistics
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import mfvi_dip_mia_tpu_torch.tasks.trainer as T

    mode = "eager" if eager else "graph"
    T.fit(problem, method, num_iter=9, show_every=10, eager=eager, **kw)
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    started = []
    capture_step = T.capture_step

    def start():
        torch.cuda.synchronize()
        prof.start()
        started.append(time.perf_counter())

    def then_profile(*args, **kwargs):
        graphs = capture_step(*args, **kwargs)
        start()
        return graphs

    T.capture_step = then_profile
    try:
        if eager:
            start()
        T.fit(problem, method, num_iter=steps - 1, show_every=steps,
              eager=eager, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - started[0]
    finally:
        T.capture_step = capture_step
        if started:
            prof.stop()
    # device kernels only: an operator's row repeats its kernels' time
    rows = [(ev.key, ev.self_device_time_total, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3 / steps
    launches = sum(r[2] for r in rows) / steps
    log(f"[3] profile of {steps} {label} steps, {mode}: {launches:.1f} "
        f"device kernels and {busy_ms:.3f} ms of device time per step; the "
        f"unprofiled {mode} step takes {step_ms:.3f} ms, so the card is "
        f"busy {100 * busy_ms / step_ms:.1f}% of it (profiled wall "
        f"{wall * 1e3 / steps:.1f} ms/step)")
    for key, us, n in rows[:12]:
        log(f"    {us / 1e3 / steps:9.4f} ms/step  x{n / steps:6.1f}  "
            f"{key[:90]}")
    ours = {name: sum(us for key, us, _ in rows
                      if re.search(r"(?<!\w)" + tag, key)) / 1e3 / steps
            for name, tag in KERNEL_FUNCS.items()}
    log("    the port's kernels, device ms/step: " + ", ".join(
        f"{k} {v:.4f}" for k, v in ours.items() if v > 0))
    sites = None
    if site_tag:
        evs = sorted((ev for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA
                      and re.search(r"(?<!\w)" + site_tag, ev.name)),
                     key=lambda ev: ev.time_range.start)
        if evs and len(evs) % steps == 0:
            n = len(evs) // steps
            us = [ev.time_range.elapsed_us() for ev in evs]
            sites = [statistics.median(us[r * n + i] for r in range(steps))
                     for i in range(n)]
            log(f"    {site_tag} device us per launch, in a step's launch "
                "order: " + " ".join(f"{u:.2f}" for u in sites)
                + f" (smallest {min(sites):.2f})")
    return dict(steps=steps, device_ms_per_step=busy_ms, step_ms=step_ms,
                kernels_device_ms_per_step=ours,
                busy_share=busy_ms / step_ms, kernels_per_step=launches,
                profiled_wall_ms_per_step=wall * 1e3 / steps,
                calls_per_step={k: n / steps for k, _, n in rows},
                site_us=sites,
                top=[dict(kernel=k, ms_per_step=us / 1e3 / steps,
                          calls_per_step=n / steps) for k, us, n in rows[:40]])


def profile_ct(steps: int, fit: dict) -> dict:
    import mfvi_dip_mia_tpu_torch.tasks.problems as P
    from mfvi_dip_mia_tpu_torch.tasks.trainer import Method

    problem = P.build_problem("ct", "mfvi", 0, input_depth=16)
    return profile_fit(
        "CT", problem, Method("mfvi", temp=2.2e-10, sigma=1.7e-7),
        dict(lr=1e-3, seed=1, metrics_every=10, compute_dtype="bf16",
             collect_snapshots=False), steps, step_ms_of(fit))


def step_ms_of(fit: dict) -> dict:
    """{mode: unprofiled ms per step} of a phase-3 path's fits."""
    return {"graph": 1e3 / fit["iters_per_sec"],
            "eager": 1e3 / fit["eager_iters_per_sec"]}


def profile_den(steps: int) -> dict:
    """The den f32 fit profiled with the fused block, as graph replays and
    eagerly, and once more with its sites sent down the unfused chain (an
    A/B of this script only: the port has no switch; graph replays), each
    beside its own unprofiled it/s over 100 steps."""
    from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block
    import mfvi_dip_mia_tpu_torch.tasks.problems as P
    from mfvi_dip_mia_tpu_torch.tasks.trainer import Method, fit

    problem = P.build_problem("den", "mfvi", 0, input_depth=16)
    method = Method("mfvi", temp=5.66e-7, sigma=1.46e-5)
    kw = dict(lr=1e-3, seed=1, metrics_every=1, compute_dtype="f32",
              collect_snapshots=False)
    out = {}
    supported = fused_block.supported
    try:
        for variant, modes in (("fused", ("graph", "eager")),
                               ("unfused", ("graph",))):
            if variant == "unfused":
                fused_block.supported = lambda x, k: False
            rate = {mode: fit(problem, method, num_iter=DEN_AB_ITERS - 1,
                              show_every=10, eager=mode == "eager",
                              **kw).iters_per_sec for mode in modes}
            out[variant] = profile_fit(
                f"den ({variant})", problem, method, kw, steps,
                {mode: 1e3 / r for mode, r in rate.items()},
                KERNEL_FUNCS["fused_block_bwd_dc"]
                if variant == "fused" else None)
            out[variant]["iters_per_sec"] = rate
            log(f"    den {variant}: " + ", ".join(
                f"{mode} {r:.2f} it/s" for mode, r in rate.items())
                + f" over {DEN_AB_ITERS - 10} unprofiled steps")
    finally:
        fused_block.supported = supported
    return out


def profile_paths(steps: int, fits: dict) -> dict:
    """Path A (LRT den) and path B (dense CT) profiled, each beside its own
    unprofiled it/s from phase 3, as graph replays and eagerly."""
    import mfvi_dip_mia_tpu_torch.tasks.problems as P
    from mfvi_dip_mia_tpu_torch.tasks.trainer import Method

    den = P.build_problem("den", "mfvi", 0, input_depth=16)
    ct = P.build_problem("ct", "mfvi", 0, input_depth=16,
                         radon_mode="dense-bf16")
    return {
        "lrt_den": profile_fit(
            "LRT den (path A)", den, Method("mfvi", temp=5.66e-7,
                                            sigma=1.46e-5),
            dict(lr=1e-3, seed=1, metrics_every=1, compute_dtype="f32",
                 collect_snapshots=False, reparam="lrt"), steps,
            step_ms_of(fits["lrt_den"])),
        "dense_ct": profile_fit(
            "dense CT (path B)", ct, Method("mfvi", temp=2.2e-10,
                                            sigma=1.7e-7),
            dict(lr=1e-3, seed=1, metrics_every=10, compute_dtype="bf16",
                 collect_snapshots=False), steps,
            step_ms_of(fits["dense_ct"]))}

# -- phase 4: the graph against the eager step ----------------------------------

GRAPH_ITERS = 60              # each fit's iterations
GRAPH_SHOW = 20               # snapshots and host reads every 20
GRAPH_METRICS = 10            # metric rows every 10: both captured variants
GRAPH_FITS = 3                # graph fits in a row, held to MEMORY_SLACK
MEMORY_SLACK = 64 * 2 ** 20   # device bytes the three may leave allocated
SNAPSHOTS = ("recons", "uncerts_epi", "uncerts_ale")


def _tensor_ptrs(v) -> list:
    import torch
    if isinstance(v, torch.Tensor):
        return [v.data_ptr()]
    if isinstance(v, (tuple, list)):
        return [p for x in v for p in _tensor_ptrs(x)]
    return []


def cache_state() -> dict:
    """The port's global caches: the data_ptr of every tensor each holds,
    by key (the dw / dense adjoint tickets, the pad tables, the dense Radon
    matrices and plan tables, the bilinear and blur matrices), and the size
    of the host-side plan caches (dc_plan, the dense and conv plans)."""
    import mfvi_dip_mia_tpu_torch.nn.layers as L
    import mfvi_dip_mia_tpu_torch.ops.metrics as M
    import mfvi_dip_mia_tpu_torch.ops.pad as PD
    import mfvi_dip_mia_tpu_torch.ops.radon as R
    from mfvi_dip_mia_tpu_torch.ops.kernels import (cf_conv, fused_block,
                                                    radon_dense)
    out = {name: {repr(k): _tensor_ptrs(v) for k, v in d.items()}
           for name, d in (("cf_conv._TICKETS", cf_conv._TICKETS),
                           ("radon._MATRIX_CACHE", R._MATRIX_CACHE),
                           ("pad._tables", PD._tables.entries),
                           ("layers._matrix_on", L._matrix_on.entries),
                           ("metrics._blur_on", M._blur_on.entries),
                           ("radon_dense._device_plan",
                            radon_dense._device_plan.entries))}
    for name, fn in (("fused_block.dc_plan", fused_block.dc_plan),
                     ("radon_dense.dense_plan", radon_dense.dense_plan),
                     ("cf_conv.tile_plan", cf_conv.tile_plan),
                     ("cf_conv.dw_plan", cf_conv.dw_plan)):
        out[name] = fn.cache_info().currsize
    return out


def graph_against_eager() -> dict:
    """Each path's fit at seed 1 (GRAPH_ITERS iterations, snapshots and
    host reads every GRAPH_SHOW, metric rows every GRAPH_METRICS, so both
    captured variants run) once eagerly and GRAPH_FITS times as graph
    replays, in a row. Raises unless every graph fit gives the eager fit's
    bits in every metric row, snapshot and final parameter; every one of
    its iterations was a replay; its launch counts are the eager fit's per
    step run (the two warm-up steps included); the graph fits leave at most
    MEMORY_SLACK bytes more allocated than before them; and every cache of
    ``cache_state`` is the same just before and just after each capture."""
    import numpy as np
    import torch
    import mfvi_dip_mia_tpu_torch.tasks.problems as P
    import mfvi_dip_mia_tpu_torch.tasks.trainer as T
    from mfvi_dip_mia_tpu_torch.ops import kernels

    use_bench_images()
    captures = []
    capture_variant = T.capture_variant

    def watched(*args, **kw):
        before = cache_state()
        out = capture_variant(*args, **kw)
        captures.append(before == cache_state())
        return out

    out = {}
    T.capture_variant = watched
    try:
        for label, task, method, dtype, kw, op in fit_paths():
            problem = P.build_problem(task, "mfvi", 0, input_depth=16,
                                      device=DEVICE, **op)
            fit_kw = dict(num_iter=GRAPH_ITERS - 1, lr=1e-3, seed=1,
                          show_every=GRAPH_SHOW, metrics_every=GRAPH_METRICS,
                          compute_dtype=dtype, device=DEVICE, **kw)
            kernels.reset_launches()
            ref = T.fit(problem, method, eager=True, **fit_kw)
            ref_launches = kernels.counts()
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()
            n_captures = len(captures)
            fits = []
            for _ in range(GRAPH_FITS):
                kernels.reset_launches()
                fits.append((T.fit(problem, method, **fit_kw),
                             kernels.counts()))
            torch.cuda.synchronize()
            mem_left = torch.cuda.memory_allocated() - mem0
            caches_kept = captures[n_captures:]
            unequal = sorted({
                f for res, _ in fits for f in METRIC_ROWS + SNAPSHOTS
                if not np.array_equal(getattr(res, f), getattr(ref, f),
                                      equal_nan=True)} | {
                "params" for res, _ in fits
                if any(not np.array_equal(res.params[k], v, equal_nan=True)
                       for k, v in ref.params.items())})
            counted = all(
                n * ref.executed == m * steps_run(res)
                for res, got in fits for n, m in zip(got, ref_launches))
            replays = [res.replays for res, _ in fits]
            log(f"[4] {label}: {GRAPH_FITS} graph fits against an eager fit "
                f"at seed 1, {ref.executed} iterations each: "
                + ("equal bits in every metric row, snapshot and final "
                   "parameter" if not unequal else f"{unequal} differ")
                + f"; replays {replays}; launches "
                + ("the eager fit's per step run" if counted else
                   f"{fits[0][1]} against eager {ref_launches}")
                + f"; {mem_left / 2 ** 20:+.1f} MB allocated after the "
                f"graph fits (reserved {torch.cuda.memory_reserved() / 2 ** 20:.0f}"
                f" MB); caches unchanged by {sum(caches_kept)} of "
                f"{len(caches_kept)} captures; graph {fits[0][0].iters_per_sec:.2f}"
                f" it/s, eager {ref.iters_per_sec:.2f} it/s over "
                f"{ref.executed - GRAPH_SHOW} iterations")
            out[label] = dict(
                iterations=ref.executed, unequal=unequal, replays=replays,
                launches_counted=counted, memory_left_bytes=mem_left,
                captures=len(caches_kept), captures_keeping_caches=sum(
                    caches_kept),
                graph_iters_per_sec=[r.iters_per_sec for r, _ in fits],
                eager_iters_per_sec=ref.iters_per_sec,
                final_psnr=ref.final_psnr)
            if (unequal or replays != [ref.executed] * GRAPH_FITS
                    or ref.replays or not counted
                    or mem_left > MEMORY_SLACK
                    or len(caches_kept) != 2 * GRAPH_FITS
                    or not all(caches_kept)):
                raise AssertionError(f"{label}: the graph fit failed its "
                                     "checks against the eager fit")
    finally:
        T.capture_variant = capture_variant
    return out


# -- phase 5: the BO sweep, its CLIs, and mc_predict as a graph --------------

MC_GRAPH_SAMPLES = 100        # samples of each mc_predict call held here
SWEEP_ITERS = 200             # configs/bo_mfvi_ct.json's num_iter, cut
SWEEP_ROUNDS = 2              # and its 20 rounds, cut
FIG_KEYS = {"XX_lr", "XX_wd", "pred", "observed_X", "observed_Y",
            "expected_improvement", "confidence", "acq", "candidates"}
CT_KEYS = {"mse_gt", "recons", "uncerts", "uncerts_ale", "psnrs", "ssims",
           "img_gt", "img_radon", "mse_noisy", "mc_mean_recon",
           "mc_mean_psnr", "mc_mean_ssim", "mc_ale", "mc_epi"}
REPO = os.path.dirname(os.path.abspath(__file__))


def mc_graph_against_eager() -> dict:
    """mc_predict at SIZE^2 on the den net's random parameters (seed 1), RT
    and LRT, MC_GRAPH_SAMPLES samples a call: an eager call (``eager=True``)
    against two graph calls from the same generator seed. Raises unless
    both graph calls give the eager samples' bits, count the eager call's
    launches per sample for each replay and the warm sample, leave at most
    MEMORY_SLACK bytes more allocated, and leave every cache of
    ``cache_state`` as the eager call left it. Samples/s of each, in this
    call, whole calls (the graph's warm sample and capture included)."""
    import numpy as np
    import torch
    import mfvi_dip_mia_tpu_torch.tasks.problems as P
    import mfvi_dip_mia_tpu_torch.utils.images as I
    from mfvi_dip_mia_tpu_torch.bayes import vi
    from mfvi_dip_mia_tpu_torch.bayes.uncertainty import mc_predict
    from mfvi_dip_mia_tpu_torch.ops import kernels
    from mfvi_dip_mia_tpu_torch.tasks.trainer import Method, init_params

    problem = P.build_problem("den", "mfvi", 0, input_depth=16,
                              device=DEVICE)
    params = vi.flatten(init_params(problem, Method("mfvi"), 1),
                        device=DEVICE)
    z = I.get_noise(16, (SIZE, SIZE), rng=np.random.default_rng(1))
    x = torch.from_numpy(z).permute(0, 3, 1, 2).contiguous().to(DEVICE)

    def timed(**kw):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = mc_predict(problem.net, params, x,
                          torch.Generator(device=DEVICE).manual_seed(5),
                          MC_GRAPH_SAMPLES, **kw)
        torch.cuda.synchronize()
        return (outs, MC_GRAPH_SAMPLES / (time.perf_counter() - t0),
                kernels.counts())

    out = {}
    for reparam in ("rt", "lrt"):
        timed(reparam=reparam, eager=True)              # warm
        ref, eager_rate, ref_launches = timed(reparam=reparam, eager=True)
        caches = cache_state()
        mem0 = torch.cuda.memory_allocated()
        rates, equal, counted = [], [], []
        for _ in range(2):
            outs, rate, launches = timed(reparam=reparam)
            rates.append(rate)
            equal.append(torch.equal(outs, ref))
            counted.append(all(
                m * MC_GRAPH_SAMPLES == n * (MC_GRAPH_SAMPLES + 1)
                for n, m in zip(ref_launches, launches)))
            del outs
        torch.cuda.synchronize()
        mem_left = torch.cuda.memory_allocated() - mem0
        kept = cache_state() == caches
        names = {k.name: n // MC_GRAPH_SAMPLES
                 for k, n in zip(kernels.KERNELS, ref_launches) if n}
        log(f"[5] mc_predict {reparam} at {SIZE}^2, {MC_GRAPH_SAMPLES} "
            f"samples: two graph calls against an eager call: "
            + ("equal bits" if all(equal) else f"equal bits {equal}")
            + f"; graph {rates[0]:.1f} / {rates[1]:.1f} samples/s, eager "
            f"{eager_rate:.1f} samples/s (whole calls); launches per sample "
            f"{names}" + ("" if all(counted) else " NOT counted per replay")
            + f"; {mem_left / 2 ** 20:+.1f} MB allocated after; caches "
            + ("unchanged" if kept else "CHANGED"))
        out[reparam] = dict(equal=equal, graph_samples_per_sec=rates,
                            eager_samples_per_sec=eager_rate,
                            launches_per_sample=names,
                            launches_counted=counted,
                            memory_left_bytes=mem_left, caches_kept=kept)
        if not (all(equal) and all(counted) and kept
                and mem_left <= MEMORY_SLACK and names):
            raise AssertionError(f"mc_predict {reparam}: the graph calls "
                                 "failed their checks against the eager one")
    return out


class SweepProbe:
    """Times and counts a sweep from outside: wraps the runner's fit and MC
    summary, ``run_task``, the fanout and the loop's GP and candidate
    search (module attributes, restored on exit)."""

    def __init__(self):
        import mfvi_dip_mia_tpu_torch.bo.loop as L
        import mfvi_dip_mia_tpu_torch.parallel.fanout as F
        import mfvi_dip_mia_tpu_torch.tasks.runners as R
        self.targets = [(R, "fit"), (R, "mc_summary"), (R, "run_task"),
                        (F, "run_candidates"), (L, "train_gp"),
                        (L, "find_candidates")]
        self.reset()

    def reset(self):
        self.candidates, self.rounds, self.failures = [], [], []
        self._cand = {}

    def __enter__(self):
        import torch
        self.saved = [getattr(m, n) for m, n in self.targets]
        fit, mc, run_task, fanout, train_gp, find = self.saved

        def timed(fn, key):
            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                r = fn(*a, **kw)
                self._cand[key] = time.perf_counter() - t0
                if key == "fit":
                    self._cand["res"] = r
                return r
            return wrapper

        def run_task_w(*a, **kw):
            self._cand = {}
            t0 = time.perf_counter()
            try:
                return run_task(*a, **kw)
            finally:
                torch.cuda.synchronize()
                c, res = self._cand, self._cand.get("res")
                total = time.perf_counter() - t0
                self.candidates.append(dict(
                    seconds=total, fit_seconds=c.get("fit"),
                    mc_seconds=c.get("mc_summary"),
                    setup_seconds=total - c.get("fit", 0.0)
                    - c.get("mc_summary", 0.0),
                    first_chunk_seconds=getattr(res, "compile_seconds",
                                                None),
                    iters_per_sec=getattr(res, "iters_per_sec", None),
                    replays=getattr(res, "replays", None),
                    executed=getattr(res, "executed", None),
                    final_psnr=getattr(res, "final_psnr", None)))

        def fanout_w(*a, **kw):
            t0 = time.perf_counter()
            kw.setdefault("failures", self.failures)
            r = fanout(*a, **kw)
            torch.cuda.synchronize()
            self.rounds.append(dict(
                fanout_seconds=time.perf_counter() - t0,
                candidates=len(a[2]), kept=len(r[0]),
                memory_allocated=torch.cuda.memory_allocated()))
            return r

        def round_timed(fn, key):
            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                r = fn(*a, **kw)
                self.rounds[-1][key] = time.perf_counter() - t0
                return r
            return wrapper

        for (m, n), w in zip(self.targets, (
                timed(fit, "fit"), timed(mc, "mc_summary"), run_task_w,
                fanout_w, round_timed(train_gp, "train_gp_seconds"),
                round_timed(find, "find_candidates_seconds"))):
            setattr(m, n, w)
        return self

    def __exit__(self, *exc):
        for (m, n), f in zip(self.targets, self.saved):
            setattr(m, n, f)
        return False


def _fig_arrays(path: str) -> dict:
    import numpy as np
    z = np.load(path)
    return {k: z[k] for k in z.files}


def sweep(probe: SweepProbe, tmp: str) -> dict:
    """configs/bo_mfvi_ct.json through ``bo`` on the card, cut to
    SWEEP_ITERS iterations a fit and SWEEP_ROUNDS rounds, no plots, paths
    in ``tmp``; then round 1 again, resumed from a copy of round 0's
    ``0_fig_data.npz``. Raises on a crashed candidate, a round without a
    kept one, fig_data keys other than the JAX loop's, a resumed (X, Y) or
    round-1 fig_data that is not the straight sweep's bit for bit, or more
    than MEMORY_SLACK bytes more allocated after round 2 than after
    round 1."""
    import shutil
    import numpy as np
    import torch
    from mfvi_dip_mia_tpu_torch.bo.loop import bo
    from mfvi_dip_mia_tpu_torch.ops import kernels
    from mfvi_dip_mia_tpu_torch.utils.config import load_config

    config = load_config(os.path.join(REPO, "configs", "bo_mfvi_ct.json"))
    bo_params = {k: {"logbounds": v.logbounds, "candidates": v.candidates}
                 for k, v in config.bo_params.items()}
    rp = dict(config.run_params, num_iter=SWEEP_ITERS, plot=False,
              save_path=os.path.join(tmp, "logs"))
    straight, resumed = (os.path.join(tmp, d) for d in ("bo", "resumed"))

    kernels.reset_launches()
    t0 = time.perf_counter()
    X, Y = bo("ct", "mfvi", bo_params, dict(rp, bo_results_path=straight),
              n_rounds=SWEEP_ROUNDS, plot=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    cands, rounds = list(probe.candidates), list(probe.rounds)
    failures = probe.failures
    for i, r in enumerate(rounds):
        log(f"[5] bo_mfvi_ct round {i}: {r['kept']} of {r['candidates']} "
            f"candidates kept, fanout {r['fanout_seconds']:.2f} s, GP "
            f"{r['train_gp_seconds']:.2f} s, find_candidates "
            f"{r['find_candidates_seconds']:.2f} s, "
            f"{r['memory_allocated'] / 2 ** 20:.1f} MB allocated after")
    for c in cands:
        log(f"    candidate: {c['seconds']:.2f} s = set-up "
            f"{c['setup_seconds']:.2f} + fit {c['fit_seconds']:.2f} (first "
            f"chunk incl. warm-up and capture {c['first_chunk_seconds']:.2f}"
            f", then {c['iters_per_sec']:.1f} it/s) + MC summary "
            f"{c['mc_seconds']:.2f}; final PSNR {c['final_psnr']:.3f} dB")
    log(f"    sweep {wall:.1f} s, X {[tuple(map(float, x)) for x in X]}, "
        f"Y {[float(y) for y in Y]}; launches {launches}")
    crashed = [f for f in failures if f["crashed"]]
    if crashed:
        raise AssertionError(f"the sweep crashed on {len(crashed)} "
                             f"candidates:\n{crashed[0]['error']}")
    if len(rounds) != SWEEP_ROUNDS or any(r["kept"] < 1 for r in rounds):
        raise AssertionError("a sweep round kept no candidate")
    if any(c["replays"] != c["executed"] for c in cands):
        raise AssertionError("a candidate's fit was not all graph replays")
    if rounds[1]["memory_allocated"] > (rounds[0]["memory_allocated"]
                                        + MEMORY_SLACK):
        raise AssertionError("round 2 left more memory allocated than "
                             "round 1")
    hold_launches("the BO sweep", launches, CONV | BANDED | FUSED)
    figs = [_fig_arrays(os.path.join(straight, f"{k}_fig_data.npz"))
            for k in range(SWEEP_ROUNDS)]
    if any(set(f) != FIG_KEYS for f in figs):
        raise AssertionError(f"fig_data keys {sorted(figs[0])}")

    os.makedirs(resumed)
    shutil.copy(os.path.join(straight, "0_fig_data.npz"), resumed)
    n_before = len(probe.candidates)
    Xr, Yr = bo("ct", "mfvi", bo_params, dict(rp, bo_results_path=resumed),
                n_rounds=SWEEP_ROUNDS, plot=False, resume=True)
    last = _fig_arrays(os.path.join(resumed,
                                    f"{SWEEP_ROUNDS - 1}_fig_data.npz"))
    equal = (np.array_equal(np.asarray(Xr), np.asarray(X))
             and np.array_equal(np.asarray(Yr), np.asarray(Y))
             and all(np.array_equal(last[k], figs[-1][k]) for k in FIG_KEYS))
    log(f"[5] bo_mfvi_ct resumed from round 0's fig_data: round "
        f"{SWEEP_ROUNDS - 1} ran {len(probe.candidates) - n_before} fits; "
        + ("(X, Y) and its fig_data equal the straight sweep's bit for bit"
           if equal else "it DIFFERS from the straight sweep"))
    if not equal:
        raise AssertionError("the resumed sweep differs from the straight "
                             "one")
    return dict(X=[list(map(float, x)) for x in X], Y=[float(y) for y in Y],
                seconds=wall, rounds=rounds, candidates=cands,
                launches=launches, resumed_equal=equal)


def run_clis(probe: SweepProbe, tmp: str, sweep_y: list) -> dict:
    """``cli.main`` on a copy of configs/bo_mfvi_ct.json (plots off, paths
    in ``tmp``; one round, --num-iter SWEEP_ITERS), whose round must
    observe the sweep's round 0, and ``eval_cli.main`` on a copy of
    configs/test_mfvi_ct.json (plots off, save_path in ``tmp``): a finite
    PSNR and a save.npz with the CT and MC keys."""
    import glob
    import numpy as np
    from mfvi_dip_mia_tpu_torch import cli, eval_cli

    def copy(name, **over):
        with open(os.path.join(REPO, "configs", name)) as f:
            raw = json.load(f)
        raw["run_params"].update(over)
        path = os.path.join(tmp, name)
        with open(path, "w") as f:
            json.dump(raw, f)
        return path

    args = ["--task", "ct", "--bayes", "mfvi", "--num-iter",
            str(SWEEP_ITERS)]
    t0 = time.perf_counter()
    X, Y = cli.main(args + ["--config", copy(
        "bo_mfvi_ct.json", plot=False,
        save_path=os.path.join(tmp, "cli_logs"),
        bo_results_path=os.path.join(tmp, "cli_bo")),
        "--rounds", "1", "--no-plot"])
    cli_s = time.perf_counter() - t0
    if Y != sweep_y[:len(Y)]:
        raise AssertionError(f"the CLI's round 0 observed {Y}, the sweep's "
                             f"{sweep_y[:len(Y)]}")
    t0 = time.perf_counter()
    save = os.path.join(tmp, "eval_logs")
    kept_c, kept_y = eval_cli.main(args + ["--config", copy(
        "test_mfvi_ct.json", plot=False, save_path=save)])
    eval_s = time.perf_counter() - t0
    (path,) = glob.glob(os.path.join(save, "*", "save.npz"))
    z = np.load(path, allow_pickle=True)
    log(f"[5] cli.main (1 round of bo_mfvi_ct, {SWEEP_ITERS} it): "
        f"{cli_s:.1f} s, Y {[float(y) for y in Y]} (the sweep's round 0); "
        f"eval_cli.main (test_mfvi_ct, {SWEEP_ITERS} it): {eval_s:.1f} s, "
        f"candidate {kept_c} PSNR {kept_y}, save.npz keys {len(z.files)}")
    if (len(kept_y) != 1 or not np.isfinite(kept_y[0])
            or set(z.files) != CT_KEYS
            or not np.isfinite(float(z["mc_mean_psnr"]))):
        raise AssertionError("eval_cli.main failed its checks")
    return dict(cli_seconds=cli_s, cli_Y=[float(y) for y in Y],
                eval_seconds=eval_s, eval_psnr=float(kept_y[0]),
                eval_mc_mean_psnr=float(z["mc_mean_psnr"]))


def sweep_phase() -> dict:
    """Phase 5: mc_predict's graph against its eager loop, the BO sweep and
    its resume, and the two CLIs; everything written goes to a temporary
    directory, removed after."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    out = {"mc_graph_vs_eager": mc_graph_against_eager()}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bo_")
    try:
        with SweepProbe() as probe:
            out["bo_ct"] = sweep(probe, tmp)
            probe.reset()
            out["clis"] = run_clis(probe, tmp, out["bo_ct"]["Y"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"[5] phase 5 took {out['seconds']:.1f} s")
    return out


# -- phase 7: dip, MC dropout and SGLD on the den and ct tasks -------------------

METHOD_PAIRS = tuple((task, name) for name in ("dip", "mcd", "sgld")
                     for task in ("den", "ct"))
METHOD_ITERS = 300            # each pair's timed graph fit: 100 warm + 200
METHOD_SHOW = 100
METHOD_BITS_ITERS = 60        # the two graph fits and the eager one held
METHOD_BITS_SHOW = 20         # equal bit for bit; the eager it/s over 40
METHOD_RUNNER_ITERS = 100     # run_den_mcd / run_ct_sgld / run_den_dip
METHOD_CLI_ITERS = 200        # the CLIs' fits
METHOD_KERNELS = {"den": CONV | FUSED, "ct": CONV | BANDED | FUSED}
MC_KEYS = {"mc_mean_recon", "mc_mean_psnr", "mc_mean_ssim", "mc_ale",
           "mc_epi"}


def method_of(task: str, name: str) -> tuple:
    """(Method, lr, candidate keywords) of configs/test_{name}_{task}.json's
    candidate, with the runners' weight-decay quirks (runners.py::
    method_for: ct and dip zero it)."""
    from mfvi_dip_mia_tpu_torch.parallel.fanout import candidate_kwargs
    from mfvi_dip_mia_tpu_torch.tasks.runners import method_for
    from mfvi_dip_mia_tpu_torch.utils.config import load_config
    cfg = load_config(os.path.join(REPO, "configs",
                                   f"test_{name}_{task}.json"))
    cand = candidate_kwargs(name, [v.candidates[0]
                                   for v in cfg.bo_params.values()])
    return method_for(task, name, cand), cfg.run_params["lr"], cand


def same_bits(a, b) -> bool:
    """Whether two fits' metric rows and final parameters are equal bit for
    bit."""
    import numpy as np
    return (all(np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True)
                for f in METRIC_ROWS)
            and a.params.keys() == b.params.keys()
            and all(np.array_equal(a.params[k], b.params[k], equal_nan=True)
                    for k in a.params))


def method_fits() -> dict:
    """Each (task, method) pair of METHOD_PAIRS at 256^2, f32, seed 1, with
    its test config's candidate and lr, through ``fit`` on the card: a graph
    fit of METHOD_ITERS iterations (it/s over the last 200; every iteration
    a replay; its final smoothed PSNR finite and above iteration 0's; the
    launches exactly METHOD_KERNELS[task]); then two graph fits and one
    eager fit of METHOD_BITS_ITERS iterations, all three with equal bits in
    every metric row and final parameter: the dropout masks and the
    parameter noise are drawn in the graph from the registered generator,
    not frozen at capture. mcd must launch the fused block (its skip sites)
    and more conv kernels per step than dip."""
    import numpy as np
    import mfvi_dip_mia_tpu_torch.tasks.problems as P
    from mfvi_dip_mia_tpu_torch.ops import kernels
    from mfvi_dip_mia_tpu_torch.tasks.trainer import fit

    use_bench_images()
    out = {}
    for task, name in METHOD_PAIRS:
        label = f"{task}/{name}"
        method, lr, _ = method_of(task, name)
        problem = P.build_problem(task, name, 0, input_depth=16,
                                  dropout_p=method.dropout_p, device=DEVICE)
        kw = dict(lr=lr, seed=1, metrics_every=1, compute_dtype="f32",
                  collect_snapshots=False, device=DEVICE)
        kernels.reset_launches()
        res = fit(problem, method, num_iter=METHOD_ITERS - 1,
                  show_every=METHOD_SHOW, **kw)
        launches = {k.name: k.launches for k in kernels.KERNELS}
        per_step = {k: n / steps_run(res) for k, n in launches.items()}
        bits = dict(num_iter=METHOD_BITS_ITERS - 1,
                    show_every=METHOD_BITS_SHOW, **kw)
        a, b = (fit(problem, method, **bits) for _ in range(2))
        eager = fit(problem, method, eager=True, **bits)
        equal, vs_eager = same_bits(a, b), same_bits(a, eager)
        log(f"[7] {label} f32 {SIZE}^2 (lr {lr}, dropout_p "
            f"{method.dropout_p}, weight_decay {method.weight_decay}, gamma "
            f"{method.gamma}): graph {res.iters_per_sec:.2f} it/s over the "
            f"last {METHOD_ITERS - METHOD_SHOW}, eager "
            f"{eager.iters_per_sec:.2f} it/s over "
            f"{METHOD_BITS_ITERS - METHOD_BITS_SHOW}; final smoothed PSNR "
            f"{res.final_psnr:.3f} dB (iteration 0: {res.psnrs[0, 2]:.3f}); "
            f"two {METHOD_BITS_ITERS}-iteration graph fits "
            + ("equal" if equal else "DIFFER") + ", graph against eager "
            + ("equal" if vs_eager else "DIFFER"))
        log(f"    launches per step {per_step}")
        hold_replays(f"{label}'s fit", res)
        for r in (a, b):
            hold_replays(f"{label}'s bit-equality fit", r)
        if eager.replays:
            raise AssertionError("an eager fit replayed a graph")
        hold_launches(f"{label}'s fit", launches, METHOD_KERNELS[task])
        if not (np.isfinite(res.final_psnr)
                and res.final_psnr > res.psnrs[0, 2]):
            raise AssertionError(f"{label}'s fit did not improve on "
                                 "iteration 0")
        if not (equal and vs_eager):
            raise AssertionError(f"{label}: fits at one seed gave different "
                                 "bits")
        out[label] = dict(iters_per_sec=res.iters_per_sec,
                          eager_iters_per_sec=eager.iters_per_sec,
                          final_psnr=res.final_psnr,
                          psnr_it0=float(res.psnrs[0, 2]),
                          executed=res.executed, steps_run=steps_run(res),
                          launches=launches, launches_per_step=per_step,
                          graph_fits_equal=equal, graph_equals_eager=vs_eager)
    for task in ("den", "ct"):
        mcd, dip = (out[f"{task}/{m}"]["launches_per_step"]
                    for m in ("mcd", "dip"))
        if not (mcd["fused_block_fwd"] > 0
                and mcd["cf_conv_fwd"] > dip["cf_conv_fwd"]):
            raise AssertionError(f"{task}/mcd: expected its skip sites on the "
                                 "fused block and more conv launches per "
                                 "step than dip")
    return out


def mcd_mc_graph() -> dict:
    """mcd's MC summary forward (den, 256^2, the test config's dropout_p)
    through ``mc_predict`` on random deterministic parameters (seed 1):
    one eager call against one graph call from the same generator seed.
    Raises unless the two give equal bits, the samples differ from one
    another (fresh masks on every replay), and the graph call launches the
    conv and fused forward kernels only."""
    import numpy as np
    import torch
    import mfvi_dip_mia_tpu_torch.tasks.problems as P
    import mfvi_dip_mia_tpu_torch.utils.images as I
    from mfvi_dip_mia_tpu_torch.bayes import vi
    from mfvi_dip_mia_tpu_torch.bayes.uncertainty import mc_predict
    from mfvi_dip_mia_tpu_torch.ops import kernels
    from mfvi_dip_mia_tpu_torch.tasks.trainer import init_params

    method, _, _ = method_of("den", "mcd")
    problem = P.build_problem("den", "mcd", 0, input_depth=16,
                              dropout_p=method.dropout_p, device=DEVICE)
    params = vi.flatten(init_params(problem, method, 1), device=DEVICE)
    z = I.get_noise(16, (SIZE, SIZE), rng=np.random.default_rng(1))
    x = torch.from_numpy(z).permute(0, 3, 1, 2).contiguous().to(DEVICE)

    def apply_fn(leaves, x, generator, **kw):
        return problem.net(leaves, x, generator, dropout_p=method.dropout_p,
                           **kw)

    def timed(**kw):
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = mc_predict(apply_fn, params, x,
                          torch.Generator(device=DEVICE).manual_seed(5),
                          MC_SAMPLES, **kw)
        torch.cuda.synchronize()
        return (outs, MC_SAMPLES / (time.perf_counter() - t0),
                {k.name: k.launches for k in kernels.KERNELS})

    ref, eager_rate, _ = timed(eager=True)
    got, rate, launches = timed()
    equal = torch.equal(got, ref)
    fresh = not torch.equal(got[0], got[1])
    log(f"[7] mcd den MC summary forward, {MC_SAMPLES} samples at {SIZE}^2: "
        f"graph against eager " + ("equal bits" if equal else "DIFFER")
        + (", samples differ from one another" if fresh else
           ", samples EQUAL") + f"; graph {rate:.1f} samples/s, eager "
        f"{eager_rate:.1f} (whole calls); launches {launches}")
    hold_launches("mcd's MC graph", launches,
                  {"cf_conv_fwd", "fused_block_fwd"})
    if not (equal and fresh):
        raise AssertionError("mcd's MC graph failed its checks against the "
                             "eager samples")
    return dict(equal=equal, fresh_masks=fresh, graph_samples_per_sec=rate,
                eager_samples_per_sec=eager_rate, launches=launches)


def method_runners(tmp: str) -> dict:
    """run_den_mcd and run_ct_sgld (save.npz with the task's keys and the MC
    summary's), run_den_dip (no MC summary, so no mc_* keys), each
    METHOD_RUNNER_ITERS iterations with its test config's candidate, plots
    off: a finite final PSNR and finite arrays."""
    import glob
    import numpy as np
    import mfvi_dip_mia_tpu_torch.tasks.runners as R

    out = {}
    for task, name, keys in (("den", "mcd", DEN_KEYS), ("ct", "sgld", CT_KEYS),
                             ("den", "dip", DEN_KEYS - MC_KEYS)):
        _, lr, cand = method_of(task, name)
        save = os.path.join(tmp, f"run_{task}_{name}")
        t0 = time.perf_counter()
        psnr = R.ALL_RUNNERS[f"run_{task}_{name}"](
            device=DEVICE, num_iter=METHOD_RUNNER_ITERS, lr=lr, seed=1,
            input_depth=16, show_every=METHOD_RUNNER_ITERS // 2, plot=False,
            save=True, save_path=save, **cand)
        wall = time.perf_counter() - t0
        (path,) = glob.glob(os.path.join(save, "*", "save.npz"))
        z = np.load(path, allow_pickle=True)
        arrays = {k: z[k].item() if z[k].dtype == object else z[k]
                  for k in z.files}
        finite = all(np.isfinite(np.asarray(a, np.float64)).all()
                     for v in arrays.values()
                     for a in (v.values() if isinstance(v, dict) else [v]))
        log(f"[7] run_{task}_{name} ({METHOD_RUNNER_ITERS + 1} it, {cand}): "
            f"{wall:.1f} s, final PSNR {psnr:.3f} dB, save.npz keys "
            f"{sorted(arrays)}")
        if set(arrays) != keys or not finite or not np.isfinite(psnr):
            raise AssertionError(f"run_{task}_{name} failed its checks")
        out[f"run_{task}_{name}"] = dict(seconds=wall, final_psnr=psnr,
                                         keys=sorted(arrays))
    return out


def method_clis(tmp: str) -> dict:
    """``cli.main`` on a copy of configs/bo_sgld_den.json (one round of its
    2 x 2 gamma / weight-decay candidates, METHOD_CLI_ITERS iterations a
    fit, plots off, paths in ``tmp``): every candidate kept with a finite
    PSNR; ``eval_cli.main`` on copies of configs/test_mcd_ct.json and
    configs/test_dip_den.json: a finite PSNR and a save.npz with the task's
    keys (and the MC summary's for mcd only)."""
    import glob
    import numpy as np
    from mfvi_dip_mia_tpu_torch import cli, eval_cli

    def copy(name, **over):
        with open(os.path.join(REPO, "configs", name)) as f:
            raw = json.load(f)
        raw["run_params"].update(over)
        path = os.path.join(tmp, name)
        with open(path, "w") as f:
            json.dump(raw, f)
        return path

    t0 = time.perf_counter()
    X, Y = cli.main(["--task", "denoising", "--bayes", "sgld", "--num-iter",
                     str(METHOD_CLI_ITERS), "--rounds", "1", "--no-plot",
                     "--config", copy(
                         "bo_sgld_den.json", plot=False,
                         save_path=os.path.join(tmp, "cli_logs"),
                         bo_results_path=os.path.join(tmp, "cli_bo"))])
    cli_s = time.perf_counter() - t0
    log(f"[7] cli.main (1 round of bo_sgld_den, {METHOD_CLI_ITERS} it): "
        f"{cli_s:.1f} s, X {[tuple(map(float, x)) for x in X]}, Y "
        f"{[float(y) for y in Y]}")
    if len(Y) != 4 or not np.isfinite(Y).all():
        raise AssertionError("the bo_sgld_den round did not keep all four "
                             "candidates")
    out = dict(cli_seconds=cli_s, cli_Y=[float(y) for y in Y])
    for cfg, task, name, keys in (
            ("test_mcd_ct.json", "ct", "mcd", CT_KEYS),
            ("test_dip_den.json", "denoising", "dip", DEN_KEYS - MC_KEYS)):
        save = os.path.join(tmp, f"eval_{name}")
        t0 = time.perf_counter()
        kept_c, kept_y = eval_cli.main([
            "--task", task, "--bayes", name, "--num-iter",
            str(METHOD_CLI_ITERS), "--config",
            copy(cfg, plot=False, save_path=save)])
        wall = time.perf_counter() - t0
        (path,) = glob.glob(os.path.join(save, "*", "save.npz"))
        z = np.load(path, allow_pickle=True)
        log(f"[7] eval_cli.main ({cfg}, {METHOD_CLI_ITERS} it): {wall:.1f} "
            f"s, candidate {kept_c} PSNR {kept_y}, save.npz keys "
            f"{len(z.files)}")
        if (len(kept_y) != 1 or not np.isfinite(kept_y[0])
                or set(z.files) != keys):
            raise AssertionError(f"eval_cli.main on {cfg} failed its checks")
        out[f"eval_{name}"] = dict(seconds=wall, psnr=float(kept_y[0]))
    return out


def methods_phase() -> dict:
    """Phase 7: the six pairs' fits, mcd's MC graph, three runners and the
    two CLIs; everything written goes to a temporary directory, removed
    after."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    out = {"fits": method_fits(), "mcd_mc_graph": mcd_mc_graph()}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_methods_")
    try:
        out["runners"] = method_runners(tmp)
        out["clis"] = method_clis(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"[7] phase 7 took {out['seconds']:.1f} s")
    return out


def profile_methods(steps: int, fits: dict) -> dict:
    """mcd den and sgld den (phase 7's configurations) profiled, each beside
    its own unprofiled it/s from phase 7, as graph replays and eagerly."""
    import mfvi_dip_mia_tpu_torch.tasks.problems as P

    out = {}
    for name in ("mcd", "sgld"):
        method, lr, _ = method_of("den", name)
        problem = P.build_problem("den", name, 0, input_depth=16,
                                  dropout_p=method.dropout_p)
        out[f"den/{name}"] = profile_fit(
            f"{name} den", problem, method,
            dict(lr=lr, seed=1, metrics_every=1, compute_dtype="f32",
                 collect_snapshots=False), steps,
            step_ms_of(fits[f"den/{name}"]))
    return out


# -- phase 8: the sr and inp tasks under the four methods ----------------------

def sr_inp_nets() -> dict:
    """The full-width nets of phase 8: "sr" the 5-scale skip-4 net with
    input depth 32 and 2 outputs (configs/test_*_sr.json), "inp" the
    6-scale no-skip k5 / k3 net with 4 outputs, "inp mcd" the 5-scale
    skip-0 net with dropout (tasks/problems.py)."""
    from mfvi_dip_mia_tpu_torch.nn import build_skip_net
    from mfvi_dip_mia_tpu_torch.nn.skip import SkipNet
    widths = [16, 32, 64, 128, 128]
    return {
        "sr": build_skip_net(32, n_channels=2, pad="reflection",
                             skip_n33d=widths, skip_n33u=widths, skip_n11=4,
                             num_scales=5, upsample_mode="bilinear"),
        "inp": SkipNet(
            num_input_channels=16, num_output_channels=4,
            num_channels_down=widths + [128], num_channels_up=widths + [128],
            num_channels_skip=[0] * 6, filter_size_down=5, filter_size_up=3,
            filter_skip_size=1, need1x1_up=False, upsample_mode="nearest",
            pad="reflection", need_sigmoid=False),
        "inp mcd": build_skip_net(
            16, n_channels=4, pad="reflection", skip_n33d=widths,
            skip_n33u=widths, skip_n11=0, num_scales=5,
            upsample_mode="bilinear", dropout_mode_down="2d",
            dropout_mode_up="2d"),
    }


SR_INP_PAIRS = tuple((task, name) for task in ("sr", "inp")
                     for name in ("dip", "mfvi", "mcd", "sgld"))
SR_INP_ITERS = 300            # each pair's timed graph fit: 100 warm + 200
SR_INP_SHOW = 100
SR_INP_BITS_ITERS = 60        # the two graph fits and the eager one held
SR_INP_BITS_SHOW = 20         # equal bit for bit; the eager it/s over 40
SR_INP_RUNNER_ITERS = 100     # run_sr_mcd / run_inp_mfvi
SR_INP_CLI_ITERS = 200        # the bo_mfvi_sr / bo_mfvi_inp rounds' fits
SR_KEYS = {"mse_gt", "recons", "uncerts", "uncerts_ale", "psnrs", "ssims",
           "img_hr", "img_lr", "mse_noisy"} | MC_KEYS
INP_KEYS = {"mse_gt", "recons", "uncerts", "uncerts_ale", "psnrs", "ssims",
            "img_inpainting", "img_mask", "mse_corrupted"} | MC_KEYS
# Launches per step of each phase-8 fit, predicted from the nets (PERF.md
# §6): the 5-scale skip net (sr; den's counts) fuses its 20 stride-1 sites
# and runs the 5 stride-2 down1 sites and the output conv on the conv kernel
# (6 forwards, 5 dx, 6 dw); under mcd only its 5 skip sites fuse. The
# 6-scale inp net fuses its 6 k3 up sites and runs 6 k5 down1 sites (as k3
# parity planes), 6 k5 down2 sites and the output conv on the conv kernel
# (13 forwards, 12 dx, 13 dw); inp mcd's net has dropout at every site and
# fuses none (21 sites, 20 dx). Under LRT every one of the 6-scale net's 19
# sites is one lrt_conv_fwd launch, its backward two dx (18 sites) and two
# dw per site on the conv kernels.
_FUSED = ("fused_block_fwd", "fused_block_bwd_dc", "fused_block_bwd_dw",
          "fused_block_bwd_dx")
STEP_LAUNCHES = {
    "5-scale": dict(cf_conv_fwd=11, cf_conv_dw=6,
                    **dict(zip(_FUSED, (20, 20, 20, 19)))),
    "5-scale mcd": dict(cf_conv_fwd=41, cf_conv_dw=21,
                        **dict(zip(_FUSED, (5, 5, 5, 4)))),
    "6-scale": dict(cf_conv_fwd=25, cf_conv_dw=13,
                    **dict(zip(_FUSED, (6, 6, 6, 6)))),
    "5-scale skip-0 mcd": dict(cf_conv_fwd=41, cf_conv_dw=21),
    "6-scale LRT": dict(lrt_conv_fwd=19, cf_conv_fwd=36, cf_conv_dw=38),
}


def net_of(task: str, name: str) -> str:
    if task == "sr":
        return "5-scale mcd" if name == "mcd" else "5-scale"
    return "5-scale skip-0 mcd" if name == "mcd" else "6-scale"


def run_params_of(task: str, name: str) -> dict:
    from mfvi_dip_mia_tpu_torch.utils.config import load_config
    return load_config(os.path.join(REPO, "configs",
                                    f"test_{name}_{task}.json")).run_params


def hold_step_launches(label: str, launches: dict, steps: int,
                       expected: dict) -> dict:
    """Each kernel's launches per step equal to ``expected`` (0 where it is
    not named); returns the launches per step."""
    per_step = {k: n / steps for k, n in launches.items()}
    wrong = {k: v for k, v in per_step.items() if v != expected.get(k, 0)}
    if wrong:
        raise AssertionError(f"{label}: launches per step {wrong}, predicted "
                             f"{ {k: expected.get(k, 0) for k in wrong} }")
    return per_step


def sr_inp_problem(task: str, name: str, method):
    import mfvi_dip_mia_tpu_torch.tasks.problems as P
    rp = run_params_of(task, name)
    return P.build_problem(task, name, rp["img"],
                           input_depth=rp["input_depth"],
                           dropout_p=method.dropout_p, device=DEVICE)


def sr_inp_fits() -> dict:
    """Each (task, method) pair of SR_INP_PAIRS at full size (sr: 384^2 ->
    96^2, input depth 32; inp: 256^2 RGB with its mask), f32, seed 1, with
    configs/test_{method}_{task}.json's candidate, lr, img and input depth,
    through ``fit`` on the card: a graph fit of SR_INP_ITERS iterations
    (it/s over the last 200; every iteration a replay; its final smoothed
    PSNR finite and above iteration 0's; the launches per step exactly
    STEP_LAUNCHES of its net); then two graph fits and one eager fit of
    SR_INP_BITS_ITERS iterations with equal bits in every metric row and
    final parameter. Last, inp/mfvi under ``reparam="lrt"`` (the k5 sites
    on lrt_conv_fwd): one graph fit and one eager fit of SR_INP_BITS_ITERS
    iterations, equal bits, the LRT launches per step."""
    import numpy as np
    from mfvi_dip_mia_tpu_torch.ops import kernels
    from mfvi_dip_mia_tpu_torch.tasks.trainer import fit

    out = {}
    for task, name in SR_INP_PAIRS:
        label = f"{task}/{name}"
        method, lr, _ = method_of(task, name)
        problem = sr_inp_problem(task, name, method)
        kw = dict(lr=lr, seed=1, metrics_every=1, compute_dtype="f32",
                  collect_snapshots=False, device=DEVICE)
        kernels.reset_launches()
        res = fit(problem, method, num_iter=SR_INP_ITERS - 1,
                  show_every=SR_INP_SHOW, **kw)
        launches = {k.name: k.launches for k in kernels.KERNELS}
        bits = dict(num_iter=SR_INP_BITS_ITERS - 1,
                    show_every=SR_INP_BITS_SHOW, **kw)
        a, b = (fit(problem, method, **bits) for _ in range(2))
        eager = fit(problem, method, eager=True, **bits)
        equal, vs_eager = same_bits(a, b), same_bits(a, eager)
        h, w = problem.imsize
        log(f"[8] {label} f32 {h}x{w}, {net_of(task, name)} net, input "
            f"depth {problem.input_depth} (lr {lr}, {method}): graph "
            f"{res.iters_per_sec:.2f} it/s over the last "
            f"{SR_INP_ITERS - SR_INP_SHOW}, eager {eager.iters_per_sec:.2f} "
            f"it/s over {SR_INP_BITS_ITERS - SR_INP_BITS_SHOW}; final "
            f"smoothed PSNR {res.final_psnr:.3f} dB (iteration 0: "
            f"{res.psnrs[0, 2]:.3f}); two {SR_INP_BITS_ITERS}-iteration "
            "graph fits " + ("equal" if equal else "DIFFER")
            + ", graph against eager " + ("equal" if vs_eager else "DIFFER"))
        per_step = hold_step_launches(f"{label}'s fit", launches,
                                      steps_run(res),
                                      STEP_LAUNCHES[net_of(task, name)])
        log(f"    launches per step {per_step} (as predicted)")
        hold_replays(f"{label}'s fit", res)
        for r in (a, b):
            hold_replays(f"{label}'s bit-equality fit", r)
        if eager.replays:
            raise AssertionError("an eager fit replayed a graph")
        if not (np.isfinite(res.final_psnr)
                and res.final_psnr > res.psnrs[0, 2]):
            raise AssertionError(f"{label}'s fit did not improve on "
                                 "iteration 0")
        if not (equal and vs_eager):
            raise AssertionError(f"{label}: fits at one seed gave different "
                                 "bits")
        out[label] = dict(iters_per_sec=res.iters_per_sec,
                          eager_iters_per_sec=eager.iters_per_sec,
                          final_psnr=res.final_psnr,
                          psnr_it0=float(res.psnrs[0, 2]),
                          executed=res.executed, steps_run=steps_run(res),
                          launches=launches, launches_per_step=per_step,
                          graph_fits_equal=equal, graph_equals_eager=vs_eager,
                          result=res, problem=problem)

    # inp under LRT: the k5 down2 sites on lrt_conv_fwd
    method, lr, _ = method_of("inp", "mfvi")
    problem = sr_inp_problem("inp", "mfvi", method)
    kw = dict(num_iter=SR_INP_BITS_ITERS - 1, show_every=SR_INP_BITS_SHOW,
              lr=lr, seed=1, metrics_every=1, compute_dtype="f32",
              collect_snapshots=False, device=DEVICE, reparam="lrt")
    kernels.reset_launches()
    res = fit(problem, method, **kw)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    eager = fit(problem, method, eager=True, **kw)
    vs_eager = same_bits(res, eager)
    per_step = hold_step_launches("inp/mfvi LRT fit", launches,
                                  steps_run(res), STEP_LAUNCHES["6-scale LRT"])
    hold_replays("inp/mfvi LRT fit", res)
    log(f"[8] inp/mfvi LRT f32 256x256: graph {res.iters_per_sec:.2f} it/s, "
        f"eager {eager.iters_per_sec:.2f} it/s over the last "
        f"{SR_INP_BITS_ITERS - SR_INP_BITS_SHOW}; final smoothed PSNR "
        f"{res.final_psnr:.3f} dB (iteration 0: {res.psnrs[0, 2]:.3f}); "
        "graph against eager " + ("equal" if vs_eager else "DIFFER")
        + f"; launches per step {per_step} (as predicted)")
    if not (vs_eager and np.isfinite(res.final_psnr)):
        raise AssertionError("inp/mfvi LRT: the graph fit is not the eager "
                             "fit's bits, or its PSNR is not finite")
    out["inp/mfvi lrt"] = dict(iters_per_sec=res.iters_per_sec,
                               eager_iters_per_sec=eager.iters_per_sec,
                               final_psnr=res.final_psnr,
                               psnr_it0=float(res.psnrs[0, 2]),
                               executed=res.executed,
                               steps_run=steps_run(res), launches=launches,
                               launches_per_step=per_step,
                               graph_equals_eager=vs_eager)
    return out


def sr_inp_mc(fits: dict) -> dict:
    """The runner's 25-sample MC summary (runners.py::mc_summary) of the sr
    and inp mfvi fits' final parameters on the card, twice from one seed:
    equal bits, the maps' shapes (inp: 3 mean channels, one aleatoric), a
    finite mean PSNR, and the forward kernels only."""
    import numpy as np
    from mfvi_dip_mia_tpu_torch.ops import kernels
    from mfvi_dip_mia_tpu_torch.tasks.runners import mc_summary

    out = {}
    for task in ("sr", "inp"):
        f = fits[f"{task}/mfvi"]
        res, problem = f["result"], f["problem"]
        kernels.reset_launches()
        t0 = time.perf_counter()
        a = mc_summary(problem, res.params, res.net_input, 78)
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels.KERNELS}
        b = mc_summary(problem, res.params, res.net_input, 78)
        equal = all(np.array_equal(a[k], b[k]) for k in a)
        h, w = problem.imsize
        mc = problem.mean_ch
        shapes = {k: np.shape(a[k]) for k in ("mc_mean_recon", "mc_epi",
                                              "mc_ale")}
        log(f"[8] {task}/mfvi MC summary ({MC_SAMPLES} samples): "
            f"{wall:.2f} s, mean PSNR {a['mc_mean_psnr']:.3f} dB, SSIM "
            f"{a['mc_mean_ssim']:.4f}, shapes {shapes}; two calls "
            + ("equal" if equal else "DIFFER") + f"; launches {launches}")
        hold_launches(f"{task}'s MC summary", launches,
                      {"cf_conv_fwd", "fused_block_fwd"})
        if not (equal and np.isfinite(a["mc_mean_psnr"])
                and shapes == {"mc_mean_recon": (mc, h, w),
                               "mc_epi": (mc, h, w), "mc_ale": (1, h, w)}):
            raise AssertionError(f"{task}'s MC summary failed its checks")
        out[task] = dict(seconds=wall, mc_mean_psnr=a["mc_mean_psnr"],
                         mc_mean_ssim=a["mc_mean_ssim"], equal=equal,
                         launches=launches)
    return out


def sr_inp_runners(tmp: str) -> dict:
    """run_sr_mcd and run_inp_mfvi, SR_INP_RUNNER_ITERS iterations each with
    its test config's candidate, lr, img and input depth, plots off: a
    finite final PSNR and a save.npz of the task's keys (and the MC
    summary's), all finite."""
    import glob
    import numpy as np
    import mfvi_dip_mia_tpu_torch.tasks.runners as R

    out = {}
    for task, name, keys in (("sr", "mcd", SR_KEYS), ("inp", "mfvi",
                                                      INP_KEYS)):
        _, lr, cand = method_of(task, name)
        rp = run_params_of(task, name)
        save = os.path.join(tmp, f"run_{task}_{name}")
        t0 = time.perf_counter()
        psnr = R.ALL_RUNNERS[f"run_{task}_{name}"](
            device=DEVICE, img=rp["img"], num_iter=SR_INP_RUNNER_ITERS,
            lr=lr, seed=1, input_depth=rp["input_depth"],
            show_every=SR_INP_RUNNER_ITERS // 2, plot=False, save=True,
            save_path=save, **cand)
        wall = time.perf_counter() - t0
        (path,) = glob.glob(os.path.join(save, "*", "save.npz"))
        z = np.load(path, allow_pickle=True)
        arrays = {k: z[k].item() if z[k].dtype == object else z[k]
                  for k in z.files}
        finite = all(np.isfinite(np.asarray(a, np.float64)).all()
                     for v in arrays.values()
                     for a in (v.values() if isinstance(v, dict) else [v]))
        log(f"[8] run_{task}_{name} ({SR_INP_RUNNER_ITERS + 1} it, {cand}): "
            f"{wall:.1f} s, final PSNR {psnr:.3f} dB, save.npz keys "
            f"{sorted(arrays)}")
        if set(arrays) != keys or not finite or not np.isfinite(psnr):
            raise AssertionError(f"run_{task}_{name} failed its checks")
        out[f"run_{task}_{name}"] = dict(seconds=wall, final_psnr=psnr,
                                         keys=sorted(arrays))
    return out


def sr_inp_clis(tmp: str) -> dict:
    """``cli.main`` on copies of configs/bo_mfvi_sr.json and
    configs/bo_mfvi_inp.json: one round of each one's 2 x 2 temp / sigma
    candidates, SR_INP_CLI_ITERS iterations a fit, plots off, paths in
    ``tmp``: every candidate kept with a finite PSNR, and the round's
    launches."""
    import numpy as np
    from mfvi_dip_mia_tpu_torch import cli
    from mfvi_dip_mia_tpu_torch.ops import kernels

    out = {}
    for task, long in (("sr", "super-resolution"), ("inp", "inpainting")):
        cfg = f"bo_mfvi_{task}.json"
        with open(os.path.join(REPO, "configs", cfg)) as f:
            raw = json.load(f)
        raw["run_params"].update(
            plot=False, save_path=os.path.join(tmp, f"cli_logs_{task}"),
            bo_results_path=os.path.join(tmp, f"cli_bo_{task}"))
        path = os.path.join(tmp, cfg)
        with open(path, "w") as f:
            json.dump(raw, f)
        kernels.reset_launches()
        t0 = time.perf_counter()
        X, Y = cli.main(["--task", long, "--bayes", "mfvi", "--num-iter",
                         str(SR_INP_CLI_ITERS), "--rounds", "1", "--no-plot",
                         "--config", path])
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels.KERNELS}
        log(f"[8] cli.main (1 round of {cfg}, {SR_INP_CLI_ITERS} it): "
            f"{wall:.1f} s, X {[tuple(map(float, x)) for x in X]}, Y "
            f"{[float(y) for y in Y]}; launches {launches}")
        if len(Y) != 4 or not np.isfinite(Y).all():
            raise AssertionError(f"the {cfg} round did not keep all four "
                                 "candidates")
        out[f"bo_mfvi_{task}"] = dict(seconds=wall, Y=[float(y) for y in Y],
                                      launches=launches)
    return out


def sr_inp_site_times(nets: dict) -> dict:
    """The profiler's device time of one step's calls of each kernel at the
    sr and inp nets' own shapes, beside the same calls through cuDNN (TF32
    off): cf_conv_fwd (forward and dx) and cf_conv_dw at the 6-scale inp
    net's k5 sites (down1 as k3 parity planes, down2 as k5) and at the
    5-scale sr net's unfused sites (384^2, input depth 32), the four fused
    kernels at the sr net's 20 fused sites (the forward against the cuDNN
    conv + batch_norm + leaky_relu chain, the dc against leaky_relu_backward
    + native_batch_norm_backward), and lrt_conv_fwd at the inp net's 19
    sites (against two cuDNN convs). f32, as the fits run."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight
    from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf
    from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb
    from mfvi_dip_mia_tpu_torch.ops.kernels import lrt_conv as tlrt

    gen = torch.Generator(device=DEVICE).manual_seed(13)
    f32 = torch.float32
    out = {}

    def pair(label, kern, lib):
        k_ms = device_ms(lambda: [f() for f in kern])
        l_ms = device_ms(lambda: [f() for f in lib])
        out[label] = dict(calls=len(kern), device_ms=k_ms,
                          library_device_ms=l_ms)
        log(f"[8] {label}: {len(kern)} calls, device {k_ms:.4f} ms, "
            f"library {l_ms:.4f} ms")

    inp_k5 = [s for s in conv_sites(nets["inp"], 256)
              if s["name"].endswith(("down1", "down2"))]
    sr_unfused = [s for s in conv_sites(nets["sr"], 384)
                  if s["name"].endswith("down1") or s["name"] == "out"]
    for label, group in (("inp k5 sites", inp_k5),
                         ("sr unfused sites", sr_unfused)):
        fwd, fwd_l, dw, dw_l, plans = [], [], [], [], []
        for s in group:
            xp, w, g = conv_operands(s, f32, gen)
            k = w.shape[2]
            fwd.append(lambda xp=xp, w=w: tcf.conv_valid_fwd(xp, w))
            fwd_l.append(lambda xp=xp, w=w: F.conv2d(xp[None], w))
            if s["needs_dx"]:
                fwd.append(lambda g=g, w=w: tcf.conv_dx(g, w))
                fwd_l.append(lambda xp=xp, g=g, w=w: conv2d_input(
                    (1,) + tuple(xp.shape), w, g[None]))
            dw.append(lambda xp=xp, g=g, k=k: tcf.conv_dw(xp, g, k, k))
            dw_l.append(lambda xp=xp, g=g, w=w: conv2d_weight(
                xp[None], w.shape, g[None]))
            p = tcf.tile_plan(g.shape[1], g.shape[2], w.shape[0], w.shape[1],
                              f32, k)
            plans.append((s["name"], list(s["xp"]), list(s["w"]),
                          tcf.TILES[p.tile], p.split))
        pair(f"cf_conv_fwd (fwd + dx), {label}", fwd, fwd_l)
        pair(f"cf_conv_dw, {label}", dw, dw_l)
        out[f"plans, {label}"] = plans

    kern = {n: [] for n in _FUSED}
    lib = {n: [] for n in _FUSED}
    for s in fused_sites(nets["sr"], 384):
        xp, wk, gamma, beta, g = fused_operands(s, gen)
        k = s["k"]
        o, stats = tfb.fwd_plain(xp, wk, gamma, beta)
        dc = tfb.bwd_dc_plain(g, o, stats, gamma, beta)[0]
        conv = F.conv2d(xp[None], wk)
        mu, inv = stats[:, 0].contiguous(), stats[:, 1].contiguous()
        kern["fused_block_fwd"].append(
            lambda xp=xp, wk=wk, ga=gamma, be=beta: tfb.fwd(xp, wk, ga, be))
        lib["fused_block_fwd"].append(
            lambda xp=xp, wk=wk, ga=gamma, be=beta: F.leaky_relu(
                F.batch_norm(F.conv2d(xp[None], wk), None, None, ga, be,
                             training=True), 0.2))
        kern["fused_block_bwd_dc"].append(
            lambda g=g, o=o, st=stats, ga=gamma, be=beta: tfb.bwd_dc(
                g, o, st, ga, be))
        lib["fused_block_bwd_dc"].append(
            lambda g=g, o=o, conv=conv, ga=gamma, mu=mu, inv=inv:
            torch.ops.aten.native_batch_norm_backward(
                torch.ops.aten.leaky_relu_backward(g[None], o[None],
                                                   tfb.SLOPE, True),
                conv, ga, None, None, mu, inv, True, tfb.EPS,
                [True, True, True]))
        kern["fused_block_bwd_dw"].append(
            lambda dc=dc, xp=xp, k=k: tfb.bwd_dw(dc, xp, k))
        lib["fused_block_bwd_dw"].append(
            lambda dc=dc, xp=xp, wk=wk: conv2d_weight(xp[None], wk.shape,
                                                      dc[None]))
        if s["needs_dx"]:
            kern["fused_block_bwd_dx"].append(
                lambda dc=dc, wk=wk: tfb.bwd_dx(dc, wk))
            lib["fused_block_bwd_dx"].append(
                lambda dc=dc, wk=wk, xp=xp: conv2d_input(
                    (1,) + tuple(xp.shape), wk, dc[None]))
    for n in _FUSED:
        pair(f"{n}, sr fused sites", kern[n], lib[n])

    kern, lib = [], []
    for s in conv_sites(nets["inp"], 256):
        xp, w_mu, w_var, _ = lrt_operands(s, f32, gen)
        xp2 = xp * xp
        kern.append(lambda xp=xp, a=w_mu, b=w_var: tlrt.double_conv_fwd(
            xp, a, b))
        lib.append(lambda xp=xp, xp2=xp2, a=w_mu, b=w_var: (
            F.conv2d(xp[None], a), F.conv2d(xp2[None], b)))
    pair("lrt_conv_fwd, inp sites", kern, lib)
    return out


def sr_inp_phase(nets: dict) -> dict:
    """Phase 8: the eight pairs' fits and inp's LRT fit, the MC summaries,
    two runners, the two CLI rounds and the kernels' device times at the
    nets' shapes; everything written goes to a temporary directory, removed
    after. Returns the phase's results, with "sr" and "inp" the launches of
    their paths (the four pairs' SR_INP_ITERS-iteration fits; inp also its
    LRT fit)."""
    import shutil
    import tempfile
    from mfvi_dip_mia_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    fits = sr_inp_fits()
    out = {"fits": fits, "mc": sr_inp_mc(fits)}
    for task in ("sr", "inp"):
        labels = [k for k in fits if k.startswith(f"{task}/")]
        out[task] = dict(launches={k.name: sum(fits[lb]["launches"][k.name]
                                               for lb in labels)
                                   for k in kernels.KERNELS},
                         launches_per_step={
                             lb: fits[lb]["launches_per_step"]
                             for lb in labels})
    for f in fits.values():
        f.pop("result", None)
        f.pop("problem", None)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sr_inp_")
    try:
        out["runners"] = sr_inp_runners(tmp)
        out["clis"] = sr_inp_clis(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["times"] = sr_inp_site_times(nets)
    out["seconds"] = time.perf_counter() - t0
    log(f"[8] phase 8 took {out['seconds']:.1f} s")
    return out


def profile_sr_inp(steps: int, fits: dict) -> dict:
    """sr/mfvi and inp/mfvi (phase 8's configurations) profiled as graph
    replays, each beside its own unprofiled it/s from phase 8."""
    out = {}
    for task in ("sr", "inp"):
        method, lr, _ = method_of(task, "mfvi")
        problem = sr_inp_problem(task, "mfvi", method)
        out[f"{task}/mfvi"] = profile_fit(
            f"{task}/mfvi", problem, method,
            dict(lr=lr, seed=1, metrics_every=1, compute_dtype="f32",
                 collect_snapshots=False),
            steps, {"graph": 1e3 / fits[f"{task}/mfvi"]["iters_per_sec"]})
    return out


# -- phase 6: times beside bounds -----------------------------------------

def time_conv_kernels(sites, results: dict) -> None:
    """Per training step of the CT main path (bf16): every forward site and
    every dx (one cf_conv_fwd launch each; the dx in its FULL form on the
    unpadded cotangent), every dw (one cf_conv_dw). Beside the CUDA-event
    times, torch.profiler's device time of one step's calls of cf_conv_fwd
    and of the same calls through cuDNN (``F.conv2d`` and its input
    gradient ``conv2d_input``), so a launch-rate-bound sum does not decide
    which is faster."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight
    from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    dt = torch.bfloat16
    item = 2
    fwd = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               t_ops=0.0, t_bytes=0.0, calls=0, flops=0.0)
    dw = dict(fwd)
    per_site = []
    step_kernel, step_library = [], []
    step_dw, step_dw_library = [], []
    plans, dw_plans = [], []
    for s in sites:
        xp, w, g = conv_operands(s, dt, gen)
        o_ch, i_ch, kh, kw = w.shape
        shapes = {"fwd": (g.shape[1], g.shape[2], o_ch, i_ch),
                  "dx": (xp.shape[1], xp.shape[2], i_ch, o_ch)}
        calls = [("fwd", xp.numel() + w.numel() + g.numel(),
                  lambda xp=xp, w=w: tcf.conv_valid_fwd(xp, w),
                  lambda xp=xp, w=w: tcf.conv_valid_plain(xp, w),
                  lambda xp=xp, w=w: F.conv2d(xp[None], w))]
        if s["needs_dx"]:
            calls.append((
                "dx", g.numel() + w.numel() + xp.numel(),
                lambda g=g, w=w: tcf.conv_dx(g, w),
                lambda g=g, w=w: tcf.conv_dx_plain(g, w),
                lambda xp=xp, g=g, w=w: conv2d_input(
                    (1,) + tuple(xp.shape), w, g[None])))
        row = dict(site=s["name"], xp=list(s["xp"]), w=list(s["w"]))
        for tag, elems, fk, fp, fl in calls:
            flops = s["flops"]        # dx of a conv: the same products
            nbytes = elems * item
            b_ms, _ = bound(flops, nbytes, PEAK_BF16_FLOPS)
            t_k, t_p, t_l = time_ms(fk), time_ms(fp), time_ms(fl)
            step_kernel.append(fk)
            step_library.append(fl)
            for key, val in (("ms", t_k), ("plain_ms", t_p),
                             ("library_ms", t_l), ("bound_ms", b_ms)):
                fwd[key] += val
            fwd["t_ops"] += flops / PEAK_BF16_FLOPS * 1e3
            fwd["t_bytes"] += nbytes / PEAK_BYTES_PER_S * 1e3
            fwd["calls"] += 1
            fwd["flops"] += flops
            p = tcf.tile_plan(*shapes[tag], dt, kh)
            plans.append(p)
            row[tag] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                            bound_ms=b_ms, gflop=flops / 1e9,
                            tile=list(tcf.TILES[p.tile]), split=p.split,
                            ctas=p.ctas)
        flops = s["flops"]
        nbytes = (xp.numel() + g.numel()) * item + o_ch * i_ch * kh * kw * 4
        b_ms, _ = bound(flops, nbytes, PEAK_BF16_FLOPS)
        fk = lambda xp=xp, g=g, kh=kh: tcf.conv_dw(xp, g, kh, kh)
        fl = lambda xp=xp, g=g, w=w: conv2d_weight(xp[None], w.shape, g[None])
        t_k = time_ms(fk)
        t_p = time_ms(lambda: tcf.conv_dw_plain(xp, g, kh, kw))
        t_l = time_ms(fl)
        step_dw.append(fk)
        step_dw_library.append(fl)
        dwp = tcf.dw_plan(g.shape[1], g.shape[2], o_ch, i_ch, dt, kh)
        dw_plans.append(dwp)
        for key, val in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                         ("bound_ms", b_ms)):
            dw[key] += val
        dw["t_ops"] += flops / PEAK_BF16_FLOPS * 1e3
        dw["t_bytes"] += nbytes / PEAK_BYTES_PER_S * 1e3
        dw["calls"] += 1
        dw["flops"] += flops
        row["dw"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                         gflop=flops / 1e9, tile=list(tcf.DW_TILES[dwp.tile]),
                         cluster=dwp.cluster, groups=dwp.groups,
                         ctas=dwp.ctas)
        per_site.append(row)
    log(f"[6] cf_conv_fwd tile plans of the {len(plans)} bf16 launches: "
        + ", ".join(f"{bm}x{bn} {sum(tcf.TILES[p.tile] == (bm, bn) for p in plans)}"
                    for bm, bn in tcf.TILES)
        + "; splits " + ", ".join(f"{k} {sum(p.split == k for p in plans)}"
                                  for k in (1, 2, 4, 8))
        + f"; blocks per launch {min(p.ctas for p in plans)}-"
        f"{max(p.ctas for p in plans)}")
    log(f"[6] cf_conv_dw plans of the {len(dw_plans)} bf16 launches: tiles "
        + ", ".join(f"{'x'.join(map(str, t))} "
                    f"{sum(tcf.DW_TILES[p.tile] == t for p in dw_plans)}"
                    for t in tcf.DW_TILES)
        + "; splits " + ", ".join(
            f"{n} {sum(p.split == n for p in dw_plans)}"
            for n in sorted({p.split for p in dw_plans}))
        + f"; blocks per launch {min(p.ctas for p in dw_plans)}-"
        f"{max(p.ctas for p in dw_plans)}")
    fwd["device_ms"] = device_ms(lambda: [f() for f in step_kernel])
    fwd["library_device_ms"] = device_ms(lambda: [f() for f in step_library])
    dw["device_ms"] = device_ms(lambda: [f() for f in step_dw])
    dw["library_device_ms"] = device_ms(
        lambda: [f() for f in step_dw_library])
    for name, agg in (("cf_conv_fwd", fwd), ("cf_conv_dw", dw)):
        r = results.setdefault(name, {})
        r.update(ms=agg["ms"], plain_ms=agg["plain_ms"],
                 library_ms=agg["library_ms"], bound_ms=agg["bound_ms"],
                 bound_by=("operations" if agg["t_ops"] > agg["t_bytes"]
                           else "bytes"),
                 calls_timed_per_step=agg["calls"],
                 gflop_per_step=agg["flops"] / 1e9)
        extra = ""
        if "device_ms" in agg:
            r.update(device_ms=agg["device_ms"],
                     library_device_ms=agg["library_device_ms"])
            extra = (f"; profiler device time {agg['device_ms']:.4f} ms, "
                     f"cuDNN's {agg['library_device_ms']:.4f} ms")
        log(f"[6] {name}: {agg['calls']} launches per step, "
            f"{agg['flops'] / 1e9:.3f} GFLOP: kernel {agg['ms']:.3f} ms, "
            f"plain {agg['plain_ms']:.3f} ms, library {agg['library_ms']:.3f}"
            f" ms, bound {agg['bound_ms']:.4f} ms{extra}")
    results["_conv_sites"] = per_site


def time_fused_kernels(sites, results: dict) -> None:
    """Per training step of the den main path (f32): each fused site's
    forward, dc, dw and (where the input needs it) dx, one launch each."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight
    from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb

    gen = torch.Generator(device=DEVICE).manual_seed(6)
    names = ("fused_block_fwd", "fused_block_bwd_dc", "fused_block_bwd_dw",
             "fused_block_bwd_dx")
    agg = {n: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, chain_ms=0.0,
                   bound_ms=0.0, t_ops=0.0, t_bytes=0.0, calls=0, flops=0.0,
                   nbytes=0.0) for n in names}
    per_site = []
    steps = {n: ([], []) for n in names}   # one step's kernel / library calls

    def site_calls(s):
        """(name, flops, bytes, kernel, plain, library, chain) of each fused
        kernel at one site, on operands bound to the closures."""
        xp, wk, gamma, beta, g = fused_operands(s, gen)
        ci, co, h, w, k = (s[n] for n in ("ci", "co", "h", "w", "k"))
        out, stats = tfb.fwd_plain(xp, wk, gamma, beta)
        dc = tfb.bwd_dc_plain(g, out, stats, gamma, beta)[0]
        # the unfused backward's inputs: the conv output it keeps, and the
        # statistics as batch_norm saves them
        conv = F.conv2d(xp[None], wk)
        mu, inv = stats[:, 0].contiguous(), stats[:, 1].contiguous()
        conv_flops = 2.0 * co * ci * k * k * h * w
        n_out, n_io = co * h * w, xp.numel() + wk.numel()
        calls = [
            ("fused_block_fwd", conv_flops + 8.0 * n_out,
             (n_io + n_out + 4 * co) * 4,
             lambda: tfb.fwd(xp, wk, gamma, beta),
             lambda: tfb.fwd_plain(xp, wk, gamma, beta), None,
             lambda: F.leaky_relu(F.batch_norm(
                 F.conv2d(xp[None], wk), None, None, gamma, beta,
                 training=True), 0.2)),
            ("fused_block_bwd_dc", 14.0 * n_out, (3 * n_out + 6 * co) * 4,
             lambda: tfb.bwd_dc(g, out, stats, gamma, beta),
             lambda: tfb.bwd_dc_plain(g, out, stats, gamma, beta), None,
             lambda: torch.ops.aten.native_batch_norm_backward(
                 torch.ops.aten.leaky_relu_backward(g[None], out[None],
                                                    tfb.SLOPE, True),
                 conv, gamma, None, None, mu, inv, True, tfb.EPS,
                 [True, True, True])),
            ("fused_block_bwd_dw", conv_flops, (n_out + n_io) * 4,
             lambda: tfb.bwd_dw(dc, xp, k),
             lambda: tfb.bwd_dw_plain(dc, xp, k),
             lambda: conv2d_weight(xp[None], wk.shape, dc[None]), None)]
        if s["needs_dx"]:
            calls.append((
                "fused_block_bwd_dx", conv_flops, (n_out + n_io) * 4,
                lambda: tfb.bwd_dx(dc, wk), lambda: tfb.bwd_dx_plain(dc, wk),
                lambda: conv2d_input((1,) + tuple(xp.shape), wk, dc[None]),
                None))
        return calls

    for s in sites:
        ci, co, h, w, k = (s[n] for n in ("ci", "co", "h", "w", "k"))
        calls = site_calls(s)
        row = dict(site=s["name"], shape=[ci, co, h, w, k])
        for name, flops, nbytes, fk, fp, fl, fc in calls:
            b_ms, _ = bound(flops, nbytes, PEAK_F32_FLOPS)
            a = agg[name]
            t = dict(ms=time_ms(fk), plain_ms=time_ms(fp),
                     library_ms=time_ms(fl) if fl else 0.0,
                     chain_ms=time_ms(fc) if fc else 0.0, bound_ms=b_ms)
            for key, val in t.items():
                a[key] += val
            steps[name][0].append(fk)
            if fl or fc:
                steps[name][1].append(fl or fc)
            a["t_ops"] += flops / PEAK_F32_FLOPS * 1e3
            a["t_bytes"] += nbytes / PEAK_BYTES_PER_S * 1e3
            a["calls"] += 1
            a["flops"] += flops
            a["nbytes"] += nbytes
            row[name] = t
        per_site.append(row)
    for name, a in agg.items():
        r = results.setdefault(name, {})
        lib = a["library_ms"] if name in ("fused_block_bwd_dw",
                                          "fused_block_bwd_dx") else None
        r.update(ms=a["ms"], plain_ms=a["plain_ms"], library_ms=lib,
                 bound_ms=a["bound_ms"],
                 bound_by=("operations" if a["t_ops"] > a["t_bytes"]
                           else "bytes"),
                 calls_timed_per_step=a["calls"],
                 gflop_per_step=a["flops"] / 1e9, mb_per_step=a["nbytes"] / 1e6)
        # the profiler's device time of one step's calls, and of the same
        # calls through the library (for the forward, the cuDNN conv +
        # batch_norm + leaky_relu chain; the dc kernel has none)
        kern, libs = steps[name]
        r["device_ms"] = device_ms(lambda: [f() for f in kern])
        r["library_device_ms"] = (device_ms(lambda: [f() for f in libs])
                                  if libs else None)
        extra = f"; profiler device time {r['device_ms']:.4f} ms"
        if libs:
            extra += f", the library's {r['library_device_ms']:.4f} ms"
        if name == "fused_block_fwd":
            r["cudnn_conv_bn_lrelu_chain_ms"] = a["chain_ms"]
            r["library_device_ms_is_a_chain"] = True
            extra = (f", cuDNN conv + batch_norm + leaky_relu chain "
                     f"{a['chain_ms']:.3f} ms" + extra + " (a chain of "
                     "three calls)")
        if name == "fused_block_bwd_dc":
            r["lrelu_bn_backward_chain_ms"] = a["chain_ms"]
            r["library_device_ms_is_a_chain"] = True
            extra = (f", leaky_relu_backward + native_batch_norm_backward "
                     f"chain {a['chain_ms']:.3f} ms" + extra + " (a chain "
                     "of two calls, on the conv output)")
            # each site's kernel alone: the smallest is what one launch
            # costs the card at least
            per = site_device_ms(kern, KERNEL_FUNCS[name])
            r["site_device_ms"] = {s["name"]: v for s, v in zip(sites, per)}
            r["launch_floor_device_ms"] = min(per)
            log(f"[6] {name} device ms per site, in launch order: "
                + ", ".join(f"{s['name']} {v:.4f}"
                            for s, v in zip(sites, per))
                + f"; the smallest (the per-launch floor) {min(per):.4f}")
        log(f"[6] {name}: {a['calls']} launches per den step, "
            f"{a['flops'] / 1e9:.3f} GFLOP, {a['nbytes'] / 1e6:.1f} MB: kernel "
            f"{a['ms']:.3f} ms, plain {a['plain_ms']:.3f} ms, library "
            f"{'none' if lib is None else f'{lib:.3f} ms'}{extra}, bound "
            f"{a['bound_ms']:.4f} ms ({r['bound_by']})")
    results["_fused_sites"] = per_site


def time_radon_kernels(states, dense_bf16, results: dict) -> None:
    """The band kernels beside the dense f32 ``torch.mv``: the dense bf16
    matrix promoted to f32 (3.02 GB), the bf16 band's own operator."""
    import torch
    from mfvi_dip_mia_tpu_torch.ops.kernels import radon_banded as rb
    from mfvi_dip_mia_tpu_torch.tasks.problems import _CT_THETA

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    dense = dense_bf16.float()                        # (T*W, H*W) f32
    img = torch.rand((1, 1, SIZE, SIZE), generator=gen, device=DEVICE)
    for dname, st in states.items():
        v = rb.patchify(img, st.patch).contiguous()
        y = torch.randn((st.t_pad * st.w, 1), generator=gen, device=DEVICE)
        flat_img = img.reshape(-1)
        y_dense = y[:len(_CT_THETA) * SIZE, 0].contiguous()
        band_bytes = st.blocks.numel() * st.blocks.element_size()
        flops = 2.0 * st.blocks.numel()
        for kname, fk, fp, fl, io_bytes in (
                ("radon_banded_fwd", lambda: rb.radon_fwd(st, v),
                 lambda: rb.radon_fwd_plain(st, v),
                 lambda: torch.mv(dense, flat_img),
                 (v.numel() + y.numel()) * 4),
                ("radon_banded_adj", lambda: rb.radon_adj(st, y),
                 lambda: rb.radon_adj_plain(st, y),
                 lambda: torch.mv(dense.T, y_dense),
                 (v.numel() + y.numel()) * 4)):
            nbytes = band_bytes + st.jlo.numel() * 4 + io_bytes
            b_ms, b_by = bound(flops, nbytes, PEAK_F32_FLOPS)
            t_k, t_p, t_l = time_ms(fk), time_ms(fp, reps=5), time_ms(fl)
            log(f"[6] {kname} {dname} band ({band_bytes / 1e6:.1f} MB): "
                f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, dense mv "
                f"{t_l:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"{band_bytes / (t_k * 1e-3) / 1e9:.0f} GB/s of band")
            r = results.setdefault(kname, {})
            r[f"ms_{dname}"] = t_k
            r[f"plain_ms_{dname}"] = t_p
            r[f"bound_ms_{dname}"] = b_ms
            r["library_ms"] = t_l
            if dname == "bf16":       # the main path's band
                r.update(ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                         device_ms=device_ms(fk),
                         library_device_ms=device_ms(fl))
                log(f"    profiler device time {r['device_ms']:.4f} ms, the "
                    f"dense f32 mv's {r['library_device_ms']:.4f} ms")
    del dense
    torch.cuda.empty_cache()


def time_lrt_kernel(sites, results: dict) -> None:
    """Per LRT den step (path A, f32): each of the 26 sites' forward, one
    ``lrt_conv_fwd`` launch each, beside its bound (both contractions and
    the squares of the site's own conv; the bytes of the kernel's operands,
    parity planes included), its plain version and two
    cuDNN ``F.conv2d`` calls (on xp and on a precomputed xp^2)."""
    import torch
    import torch.nn.functional as F
    from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf
    from mfvi_dip_mia_tpu_torch.ops.kernels import lrt_conv as tlrt

    gen = torch.Generator(device=DEVICE).manual_seed(10)
    agg = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, t_ops=0.0,
               t_bytes=0.0, calls=0, flops=0.0, nbytes=0.0)
    per_site = []
    step_kernel, step_library = [], []
    for s in sites:
        xp, w_mu, w_var, g = lrt_operands(s, torch.float32, gen)
        xp2 = xp * xp
        flops = 2 * s["flops"] + s["x_elems"]
        nbytes = (xp.numel() + 2 * w_mu.numel() + 2 * g.numel()) * 4
        b_ms, _ = bound(flops, nbytes, PEAK_F32_FLOPS)
        t = dict(ms=time_ms(lambda: tlrt.double_conv_fwd(xp, w_mu, w_var)),
                 plain_ms=time_ms(
                     lambda: tlrt.fused_double_conv(xp, w_mu, w_var)),
                 library_ms=time_ms(lambda: (F.conv2d(xp[None], w_mu),
                                             F.conv2d(xp2[None], w_var))),
                 bound_ms=b_ms)
        step_kernel.append(
            lambda xp=xp, w_mu=w_mu, w_var=w_var: tlrt.double_conv_fwd(
                xp, w_mu, w_var))
        step_library.append(
            lambda xp=xp, xp2=xp2, w_mu=w_mu, w_var=w_var: (
                F.conv2d(xp[None], w_mu), F.conv2d(xp2[None], w_var)))
        for key, val in t.items():
            agg[key] += val
        agg["t_ops"] += flops / PEAK_F32_FLOPS * 1e3
        agg["t_bytes"] += nbytes / PEAK_BYTES_PER_S * 1e3
        agg["calls"] += 1
        agg["flops"] += flops
        agg["nbytes"] += nbytes
        i_ch, hp, wp = s["xp"]
        o_ch, _, k, _ = s["w"]
        p = tcf.tile_plan(hp - k + 1, wp - k + 1, o_ch, i_ch, torch.float32,
                          k, 2)
        per_site.append(dict(site=s["name"], xp=list(s["xp"]),
                             w=list(s["w"]), tile=list(tcf.TILES[p.tile]),
                             split=p.split, ctas=p.ctas, **t))
    dev = device_ms(lambda: [f() for f in step_kernel])
    dev_l = device_ms(lambda: [f() for f in step_library])
    r = results.setdefault("lrt_conv_fwd", {})
    r.update(device_ms=dev, library_device_ms=dev_l)
    r.update(ms=agg["ms"], plain_ms=agg["plain_ms"],
             library_ms=agg["library_ms"], bound_ms=agg["bound_ms"],
             bound_by=("operations" if agg["t_ops"] > agg["t_bytes"]
                       else "bytes"),
             calls_timed_per_step=agg["calls"],
             gflop_per_step=agg["flops"] / 1e9,
             mb_per_step=agg["nbytes"] / 1e6, sites=per_site)
    log(f"[6] lrt_conv_fwd: {agg['calls']} launches per LRT den step, "
        f"{agg['flops'] / 1e9:.3f} GFLOP, {agg['nbytes'] / 1e6:.1f} MB: "
        f"kernel {agg['ms']:.3f} ms, plain {agg['plain_ms']:.3f} ms, two "
        f"cuDNN convs {agg['library_ms']:.3f} ms, bound "
        f"{agg['bound_ms']:.4f} ms ({r['bound_by']}); profiler device time "
        f"{dev:.4f} ms, the two cuDNN convs' {dev_l:.4f} ms")


def time_dense_radon(a, results: dict) -> None:
    """One call of each dense kernel at 256^2 / 45 angles beside its bound
    (A's bytes read once), its plain version and cuBLAS ``torch.mv`` on the
    same bf16 matrix (which rounds the vector and the result to bf16): the
    CUDA-event and profiler device times (the kernel's and cuBLAS's taken
    in turns, three each), the GB/s of A and the share of the bound of
    each."""
    import torch
    from mfvi_dip_mia_tpu_torch.ops.kernels import radon_dense as rd

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    p, q = a.shape
    v = torch.rand((1, q), generator=gen, device=DEVICE)
    y = torch.randn((1, p), generator=gen, device=DEVICE)
    v16, y16 = v[0].to(torch.bfloat16), y[0].to(torch.bfloat16)
    flops = 2.0 * p * q
    nbytes = a.numel() * 2 + (p + q) * 4
    b_ms, b_by = bound(flops, nbytes, PEAK_F32_FLOPS)

    def rate(ms):
        return (f"{a.numel() * 2 / (ms * 1e-3) / 1e9:.0f} GB/s of A, "
                f"{100 * b_ms / ms:.1f} % of the bound")

    for kname, fk, fp, fl in (
            ("radon_dense_fwd", lambda: rd.radon_dense_fwd(a, v),
             lambda: rd.radon_dense_fwd_plain(a, v),
             lambda: torch.mv(a, v16)),
            ("radon_dense_adj", lambda: rd.radon_dense_adj(a, y),
             lambda: rd.radon_dense_adj_plain(a, y),
             lambda: torch.mv(a.T, y16))):
        t_k, t_p, t_l = time_ms(fk), time_ms(fp, reps=5), time_ms(fl)
        # the kernel and cuBLAS in turns (k, l, l, k, k, l): medians of 3
        runs = {fk: [], fl: []}
        for turn in range(3):
            for f in ((fk, fl) if turn % 2 == 0 else (fl, fk)):
                runs[f].append(device_ms(f, reps=10))
        d_k, d_l = (sorted(runs[f])[1] for f in (fk, fl))
        log(f"[6] {kname} ({nbytes / 1e9:.3f} GB): kernel {t_k:.4f} ms "
            f"({rate(t_k)}), plain {t_p:.4f} ms, cuBLAS bf16 mv {t_l:.4f} "
            f"ms ({rate(t_l)}), bound {b_ms:.4f} ms ({b_by})")
        log(f"    profiler device time, median of 3 in turns: kernel "
            f"{d_k:.4f} ms ({rate(d_k)}; runs "
            + " ".join(f"{x:.4f}" for x in runs[fk]) + f"), cuBLAS "
            f"{d_l:.4f} ms ({rate(d_l)}; runs "
            + " ".join(f"{x:.4f}" for x in runs[fl]) + ")")
        results.setdefault(kname, {}).update(
            ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
            bound_by=b_by, gb=nbytes / 1e9, device_ms=d_k,
            library_device_ms=d_l, device_ms_runs=runs[fk],
            library_device_ms_runs=runs[fl],
            device_gb_per_s=a.numel() * 2 / (d_k * 1e-3) / 1e9,
            library_device_gb_per_s=a.numel() * 2 / (d_l * 1e-3) / 1e9,
            device_share_of_bound=b_ms / d_k,
            library_device_share_of_bound=b_ms / d_l)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="profile this many steps of each path with "
                    "torch.profiler (den also without the fused block)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run on the "
              "card", file=sys.stderr)
        return 2
    try:
        from mfvi_dip_mia_tpu_torch.nn import build_skip_net
        from mfvi_dip_mia_tpu_torch.ops import kernels
        from mfvi_dip_mia_tpu_torch.ops.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 2
    if "jax" in sys.modules or "mfvi_dip_mia_tpu" in sys.modules:
        raise AssertionError("the port imported JAX or the JAX package")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] {smi}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, {torch.cuda.device_count()} device(s): "
        f"{kind}")
    build.library()
    log(f"[1] kernels built and loaded in {build.BUILD_SECONDS:.1f} s")
    ptxas = ptxas_report()
    sass = sass_mma_report()

    results: dict = {}
    # the 256^2 nets of the two main paths: ct (1 output channel) and den
    # (2: mean and neg-logvar)
    nets = {n_out: build_skip_net(16, n_channels=n_out, pad="reflection",
                                  skip_n33d=[16, 32, 64, 128, 128],
                                  skip_n33u=[16, 32, 64, 128, 128],
                                  skip_n11=4, num_scales=5,
                                  upsample_mode="bilinear")
            for n_out in (1, 2)}
    sites = conv_sites(nets[1], SIZE)
    f_sites = fused_sites(nets[2], SIZE)
    # every LRT site of the den net, as the kernel sees it (stride-2 sites
    # on parity planes): the conv sites' geometry
    l_sites = conv_sites(nets[2], SIZE)
    # phase 8's nets: sr's 5-scale net on 384^2 with input depth 32, inp's
    # 6-scale k5 / k3 net and its mcd net (skip 0, dropout) on 256^2
    p8_nets = sr_inp_nets()
    p8_conv = (conv_sites(p8_nets["sr"], 384) + conv_sites(p8_nets["inp"], 256)
               + conv_sites(p8_nets["inp mcd"], 256))
    p8_fused = (fused_sites(p8_nets["sr"], 384)
                + fused_sites(p8_nets["inp"], 256))
    # the dw runs at every conv site of the CT net (bf16), of the den net
    # (f32, the non-fused sites) and of path A (f32, 2 per site): every
    # distinct shape of both nets, in both dtypes; and at every site of the
    # sr and inp nets
    check_conv_kernels(sites + l_sites + p8_conv, results)
    states = check_radon_kernels(results)
    check_fused_kernels(f_sites + p8_fused, results)
    check_lrt_kernel(l_sites + p8_conv, results)
    dense = check_dense_radon(results)

    steps = {label: check_step_against_cpu(nets[n_out], task, reparam)
             for label, task, n_out, reparam in (
                 ("ct", "ct", 1, "rt"), ("den", "den", 2, "rt"),
                 ("lrt_den", "den", 2, "lrt"))}
    fits = run_fits(results)
    fits["step_vs_cpu"] = steps
    fits["reproducibility"] = reproducibility()
    unequal = [k for k, r in fits["reproducibility"].items()
               if not (r["rows_equal"] and r["params_equal"])]
    if unequal:
        raise AssertionError(f"two fits at one seed gave different bits: "
                             f"{unequal}")
    fits["graph_vs_eager"] = graph_against_eager()
    fits["sweep"] = sweep_phase()
    fits["bo_ct"] = fits["sweep"]["bo_ct"]
    fits["methods"] = methods_phase()
    fits["sr_inp"] = sr_inp_phase(p8_nets)
    fits["sr"], fits["inp"] = fits["sr_inp"]["sr"], fits["sr_inp"]["inp"]

    time_conv_kernels(sites, results)
    time_radon_kernels(states, dense, results)
    del states
    time_fused_kernels(f_sites, results)
    time_lrt_kernel(l_sites, results)
    time_dense_radon(dense, results)
    del dense
    if args.profile_steps:
        fits["profile"] = profile_ct(args.profile_steps, fits["ct"])
        fits["profile_den"] = profile_den(args.profile_steps)
        fits["profile_paths"] = profile_paths(args.profile_steps, fits)
        fits["profile_methods"] = profile_methods(
            args.profile_steps, fits["methods"]["fits"])
        fits["profile_sr_inp"] = profile_sr_inp(args.profile_steps,
                                                fits["sr_inp"]["fits"])

    line = []
    for k in kernels.KERNELS:
        r = results[k.name]
        # each kernel's launches on the path it belongs to: the bf16 CT fit
        # for the conv and banded Radon kernels, the den run (fit + MC
        # summary) for the fused block's, path A's fit for the LRT kernel,
        # path B's fit for the dense Radon kernels
        path = PATH_OF[k.name]
        err = r.get("max_abs_err",
                    r.get("max_abs_err_bf16", r.get("max_abs_err_f32")))
        line.append(dict(
            name=k.name, route="cuda", source=k.source, replaces=k.replaces,
            launches=fits[path]["launches"][k.name], path=path,
            launches_per_step=fits[path]["launches_per_step"][k.name],
            launches_by_path={p: fits[p]["launches"][k.name]
                              for p in ("ct", "den", "lrt_den", "dense_ct",
                                        "bo_ct", "sr", "inp")},
            max_abs_err=err, ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            **{k: r[k] for k in ("device_ms", "library_device_ms")
               if k in r}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, torch=torch.__version__,
                           cuda=torch.version.cuda,
                           build_seconds=build.BUILD_SECONDS, ptxas=ptxas,
                           sass=sass,
                           kernels=line,
                           details=results, fits=fits,
                           seconds=time.perf_counter() - t_start), f,
                      indent=1, default=float)
    log(f"[6] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
