#!/usr/bin/env python3
"""Drive the PyTorch port (mfvi_dip_mia_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--profile-steps N]
                          [--parent DIR]

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
   the dc also at 16 x 512^2, past a cluster's shared memory) and in bf16
   at every fused-site shape of the 256^2 CT U-Net, the same odd shapes
   and 16 x 512^2 (TOL_FUSED_BF16), the LRT
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
   (``fit(..., eager=True)``, its first chunk and 50 more iterations) for
   its it/s beside the graph's:
   bench.py's CT configuration (256^2, input depth 16, temp 2.2e-10, sigma
   1.7e-7, lr 1e-3, seed 1, bf16, metrics every 10) through ``fit``, 100
   warm-up and 200 timed iterations; the den/MFVI f32 fit of 300 iterations
   (bench.py --metric train's configuration) through the user's entry point
   ``run_den_mfvi`` (save.npz into a temporary directory, no plots), with
   its 25-sample MC posterior summary, and the MC posterior samples per
   second of ``mc_predict``; path A, the same den fit through
   ``fit(..., reparam="lrt")`` (100 warm-up and 200 timed iterations) and
   its 25-sample LRT posterior summary; path B, the CT configuration with
   ``radon_mode="dense-bf16"`` (100 + 200 iterations). Launch counters are
   zeroed just before each path and read just after its graph fit; they
   count what the card ran: each replay adds its capture's launches, the
   two eager warm-up steps before a capture count as steps run. The bf16
   CT fit runs its 20 fused sites on the bf16 fused block: exactly
   ``CT_STEP_LAUNCHES`` a step run (20 / 20 / 20 / 19 fused, 11 conv and 6
   dw launches, the Radon pair once each). Last, the
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
   paths in a temporary directory: round 0's 4 candidates on the one card
   take JAX's interleaved route (``run_group_interleaved``: one
   ``fit_interleaved``, no MC summary), a round of one candidate
   ``run_task``; no crashed candidate, a kept one in every round, every fit
   all graph replays, the JAX loop's fig_data keys, at most 64 MB more
   allocated after round 2 than after round 1, and the launches of the
   whole sweep (``launches_by_path["bo_ct"]``); round 1 again, resumed
   from a copy of round 0's ``0_fig_data.npz``, must give the straight
   sweep's (X, Y) and fig_data bit for bit; round 0's candidates once more
   through ``run_candidates(..., interleave=False)`` (``run_task`` each,
   with its MC summary) must give the interleaved scores bit for bit.
   Seconds per candidate (set-up, fit, MC summary; a group's shared
   evenly) and per round (GP, candidate search). Last, ``cli.main`` on a copy of that config (one round, which
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
   output; the dc also per site, its smallest site the per-launch floor;
   the four fused kernels also in bf16 at the CT net's 20 fused sites,
   beside their plain versions and bound, under each kernel's "bf16" key).
   The dense Radon pair also gives the GB/s of A and the share of the bytes
   bound of the kernel and of cuBLAS. With ``--profile-steps``, each path's
   fit is profiled as graph replays (from the first replay on) and eagerly.
   ``launches_by_path`` adds "sr" and "inp": the launches of phase 8's
   four sr fits and of its four inp fits and the LRT inp fit, and "tail"
   those of phase 9's three fits.
9. (run last) The trainer's tail and the evaluation report, at bench.py's
   den widths (256^2, input depth 16, f32, lr 1e-3, seed 1): den/MFVI
   under the reference's scale-mixture prior (two graph fits of 300
   iterations and an eager one, equal bits, the final smoothed PSNR above
   iteration 0's, den's launches per step exactly), and with ELU and Swish
   nets (a graph fit and an eager one, equal bits, cf_conv_fwd 50 and
   cf_conv_dw 26 launches per step and no fused one); a den/MFVI graph fit
   of 301 iterations in 7 chunks with checkpoints after chunks 2, 4 and 6,
   fits resumed from the chunk-2 and chunk-6 files with the uninterrupted
   fit's bits (rows, snapshots, parameters), and an eager fit's chunk-2
   file equal to the graph fit's (generator state included);
   ``run_den_dip`` stopped early (``executed`` as ``_EarlyStop`` decides
   on the fit's rows, NaN rows after it, replays and launches per step
   for exactly the iterations executed); ``write_report`` (no maps) on one
   101-iteration run of each ``run_{den,ct,sr,inp}_mfvi`` on the card
   against the same report on the CPU (PSNR 1e-4 dB, SSIM 1e-6, UCE 1e-6
   relative), each classical baseline and FBP timed on the card, and
   ``evaluation.main`` once.
10. (run after 9) The library tail, at bench.py's den widths (256^2, input
   depth 16, f32, lr 1e-3, seed 1), each part's seconds by
   ``utils/profiling.py::PhaseTimer``: den/MFVI on the 5-scale net built
   with ``downsample_mode="lanczos2"`` (two graph fits of 300 iterations
   and an eager one, equal bits, the launches per step exactly den's in
   graph and eager fits, the final smoothed PSNR above iteration 0's),
   and with "avg" and "max" (a graph and an eager fit of 100 iterations
   each, equal bits, the same launches); the conv kernels' device time at
   the five pooled down1 sites (stride 1, full resolution; phase 2 holds
   the kernels at their shapes) beside cuDNN's; ``gaussian_dropout_conv``
   at three den site shapes (one ``lrt_conv_fwd`` launch a call, its
   moments against the plain double conv, its output and gradients
   against the CPU's with the same noise); the ClassificationTrainer /
   Predictor problem of JAX tests/test_aux.py on the card (accuracy above
   0.9) and one ``make_elbo_step`` against the CPU's with the same draws;
   ``sgld``, ``psgld`` and ``param_noise_transform`` on the den net's
   parameters (finite; noise-free against the CPU); ``prune_mask_by_snr``
   (30 %) on the lanczos2 fit's parameters; ``profiling.trace`` around a
   5-iteration graph fit. ``launches_by_path["lib"]``: the launches of the
   three pooled graph fits and of the Gaussian-dropout calls.

11. (run after 10) ``parallel/`` at bench.py's den widths (256^2, input
   depth 16, f32, lr 1e-3, seed 1), each part's seconds by ``PhaseTimer``:
   configs/bo_mfvi_den.json's first three candidates as three sequential
   graph fits of 300 iterations, then as one ``fit_interleaved`` (K = 3)
   and K = 1: each interleaved fit equal to its sequential fit bit for bit
   (rows and parameters), every iteration a replay, den/MFVI's launches per
   step in every fit's captured step and over all; the summed it/s (last
   200) beside one sequential fit's, and the peak allocated memory of K = 1
   and K = 3. The same three through ``run_sweep_spmd`` on ``make_mesh(1,
   names=("cand",))``: each candidate's rows equal to its sequential
   fit's, one replay launching three times den's kernels, its summed it/s
   and capture seconds. Last, two child processes that share the card run
   one round of configs/bo_mfvi_ct.json (100 iterations a fit, plots off,
   paths in a temporary directory) through ``cli.main`` with
   ``--dist-coordinator 127.0.0.1:PORT --dist-nproc 2 --dist-pid i`` (a
   gloo group): both exit 0 with the same (X, Y), equal to one process's
   ``run_candidates`` of the same candidates with its scores rounded to
   float32, and only rank 0 reports the round and writes its fig_data.
   ``launches_by_path["parallel"]``: the launches of the interleaved and
   one-program fits.

12. (run after 11) One fit split by image rows (``parallel/sharding.py::
   fit_sp``, nn/sp.py) over meshes that name cuda:0 2 and 4 times, at
   bench.py's den widths (256^2, input depth 16, lr 1e-3, seed 1), each
   part's seconds by ``PhaseTimer``: the unsplit den/MFVI f32 graph fit of
   300 iterations and the same with every site on the unfused chain (the
   route a split takes), then per split a 300-iteration graph fit (every
   iteration a replay; launches per step exactly ``sp_step_launches``,
   predicted from the net; its first 80 rows' smoothed PSNR within JAX's
   sp tolerance of the unsplit fit's, its current iterate's PSNRs and its
   final smoothed PSNR within that tolerance, or 0.1 dB, plus the two
   unsplit routes' spread; its it/s and peak allocated memory beside the
   unsplit fit's), two graph fits and an eager one of 40 iterations with
   equal bits, and every cache unchanged by each capture; CT/MFVI bf16
   over 2 shards (100 iterations: finite, the final smoothed PSNR above
   iteration 0's, its gap to the unsplit fit's logged); and
   ``run_candidates("den", "mfvi", 2 candidates, devices=["cuda:0"] * 4,
   sp_split=True)`` (100 iterations a fit, a 2-entry sub-mesh each), its
   scores within 0.1 dB of the plain route's (``run_task`` each) and of
   each candidate's unsplit fit. Phase 2 holds the conv kernels at every
   shard slab of these fits (f32 and bf16). ``launches_by_path["sp"]``:
   the launches of the split den and CT fits.

13. (run after 12) The fanout's threads (parallel/fanout.py) on cuda:0,
   at bench.py's den widths (256^2, input depth 16, f32, lr 1e-3, seed 1,
   300 iterations a fit), each route's round once through
   ``run_candidates`` and once one candidate after another in this
   thread: (a) 3 dip candidates, a thread each; (b) configs/
   bo_mfvi_den.json's 4 candidates on ``["cuda:0", "cuda:0"]`` (a thread
   per interleaved group of 2) and with ``interleave=False`` (a thread per
   candidate, ``run_task`` with its MC summary); (c) 2 of them with
   ``sp_split=2`` over ``["cuda:0"] * 4`` (a thread per ``fit_sp``). Every
   candidate's score, metric rows and parameters equal its sequential
   run's bit for bit, every iteration is a replay, the round's launches
   equal the sequential round's, and the threads ran on streams of their
   own with overlapping fits. Logged per route, threaded beside
   sequential: wall seconds, graph it/s (summed over the threaded fits),
   capture seconds, peak allocated memory, launches per fit.
   ``launches_by_path["threads"]``: the threaded rounds' launches. Phase 2
   launches ``cf_conv_dw``, ``fused_block_fwd``, ``fused_block_bwd_dw``
   and ``radon_dense_adj`` from two threads on two streams at once, at the
   widest den sites and path B's matrix: every result equal to its
   single-stream bits.

14. (run last) The cand x mc sharded step (``parallel/sharding.py::
   build_sharded_sweep_step``) and the port's entry points
   (``mfvi_dip_mia_tpu_torch/entry.py``), each part's seconds by
   ``PhaseTimer``: (a) ``dryrun_multichip(8)``, its mesh cuda:0 named 8
   times (a 4 cand x 2 mc step on 64^2, two steps, then a 4-candidate
   one-program sweep of 3 chunks); (b) the step at bench.py's den widths
   (256^2, input depth 16, f32, lr 1e-3, jitter on), configs/
   bo_mfvi_den.json's first 2 candidates, S = 2, on a 2 cand x 2 mc mesh
   of cuda:0 x 4: 20 steps as one CUDA graph and 20 eagerly from the same
   state and generator seeds, with equal bits in the losses, parameters,
   moments, counts and EMA, every mc replica equal to its lead after
   every step, launches exactly C x S x the den step's per step run and
   2 C (n_mc - 1) copies between entries a step, steps/s, first-call
   seconds and peak memory logged beside phase 3's den fit it/s; one step
   against the CPU's plain path with the same draws (jitter off) at
   TOL_STEP; (c) ``entry()``'s loss, output and gradient at 256^2 against
   the CPU at TOL_STEP. ``launches_by_path["sharded"]``: (b)'s graph
   steps' launches.
15. (with ``--parent DIR``, after 14) The den/MFVI f32 fit (60 graph
   replays at seed 1) in a child process on DIR, another checkout (a
   ``git archive`` of the parent commit), and on this one, each building
   its own kernels: equal bits in every metric row and final parameter.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the package beside it, the script exits
with a non-zero code and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import re
import subprocess
import sys
import threading
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
DEN_ITERS = 300
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
# The fused block's bf16 kernels against their bf16 plain versions: the same
# f32 arithmetic on the same bf16 operands (the conv's products exact in
# f32), each output rounded to bf16 once, as a share of the plain result's
# largest magnitude:
#   out / dconv / dx / dw / dgamma / dbeta: f32 sums in another order, then
#     one rounding to bf16: a sum that differs in its last f32 bits can
#     round one bf16 ulp (2^-7 of a value at most) apart, as TOL's bf16 conv
#     entry
#   mu, inv: f32 sums of up to 65,536 terms in another order, as in f32
TOL_FUSED_BF16 = {"out": 8e-3, "dconv": 8e-3, "dx": 8e-3, "mu": 1e-5,
                  "inv": 1e-5, "dw": 8e-3, "dgamma": 8e-3, "dbeta": 8e-3}
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
    form holds 16 taps per output where the k=3 conv needs 9. A pooled
    down1 site (``downsample_mode`` other than 'stride') convolves at
    stride 1, its output at its input's resolution."""
    sites = []

    def add(name, site, s_in, needs_dx=True):
        k = site.kernel
        stride = 1 if site.downsample_mode != "stride" else site.stride
        hp = s_in + 2 * ((k - 1) // 2)
        ho = (hp - k) // stride + 1
        own = dict(flops=2.0 * site.c_out * site.c_in * k * k * ho * ho,
                   x_elems=site.c_in * hp * hp)
        if stride == 1:
            xp, w = (site.c_in, hp, hp), (site.c_out, site.c_in, k, k)
        elif stride == 2 and k > 1:
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


def split_conv_sites(net, size: int, n_sp: int) -> list[dict]:
    """Every conv site of ``net`` on a size^2 input split by rows into
    ``n_sp`` even shards (nn/sp.py), as the VALID conv the kernel sees on
    one shard's halo slab (every shard's slab has one shape): the shard's
    rows of the site's level plus the pad or halo rows its output reads,
    the columns padded as the unsplit site's; a stride-2 site's slab as k3
    parity planes. Bounds and needs_dx as ``conv_sites``."""
    sites = []

    def add(name, site, s_in, needs_dx=True):
        k, p = site.kernel, (site.kernel - 1) // 2
        stride = 1 if site.downsample_mode != "stride" else site.stride
        hp, wp = s_in // n_sp + k - stride, s_in + 2 * p
        ho, wo = (hp - k) // stride + 1, (wp - k) // stride + 1
        own = dict(flops=2.0 * site.c_out * site.c_in * k * k * ho * wo,
                   x_elems=site.c_in * hp * wp)
        if stride == 1:
            xp, w = (site.c_in, hp, wp), (site.c_out, site.c_in, k, k)
        else:
            k2 = (k + 1) // 2
            xp = (4 * site.c_in, ho + k2 - 1, wo + k2 - 1)
            w = (site.c_out, 4 * site.c_in, k2, k2)
        sites.append(dict(name=f"{name} sp{n_sp}", xp=xp, w=w,
                          needs_dx=needs_dx, **own))

    for i, cfg in enumerate(net.levels):
        s = size >> i
        first = i == 0
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


def hold_fused(checks, shape, worst: dict, tol: dict = TOL_FUSED) -> None:
    """Each (kernel, what, got, ref) of one dtype within tol[what] of the
    largest |ref|; the worst error per (kernel, what) into ``worst``."""
    for kname, what, got, ref in checks:
        if (got.shape != ref.shape or got.dtype != ref.dtype
                or not bool(got.isfinite().all())):
            raise AssertionError(
                f"{kname} {what} at {shape}: {tuple(got.shape)} {got.dtype} "
                f"vs {tuple(ref.shape)} {ref.dtype}, or non-finite values")
        a, r = rel_err(got, ref)
        if r > tol[what]:
            raise AssertionError(
                f"{kname} {what} {got.dtype} at (Ci, Co, H, W, k) {shape}: "
                f"max abs err {a:.3e} (rel {r:.3e}) > tolerance "
                f"{tol[what]:.0e}")
        if r >= worst.get((kname, what), (0.0, -1.0))[1]:
            worst[(kname, what)] = (a, r)


def check_dc(g, out, stats, gamma, beta, shape, worst: dict,
             tol: dict = TOL_FUSED) -> None:
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
        ("dconv", "dgamma", "dbeta"), got, ref)], shape, worst, tol)


def check_fused_kernels(sites, results: dict, dtype=None) -> None:
    """Each fused kernel in ``dtype`` (f32 by default, or bf16) against its
    plain version at every distinct fused-site shape and at
    EXTRA_FUSED_SHAPES, the dc also at DC_WIDE_SHAPES; the backward kernels
    take the plain forward's out and stats and the plain dconv, so each is
    held alone (to TOL_FUSED, or TOL_FUSED_BF16). Every kernel is called
    twice for the same bits."""
    import torch
    from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb

    dtype = dtype or torch.float32
    dname = "bf16" if dtype == torch.bfloat16 else "f32"
    tol = TOL_FUSED_BF16 if dname == "bf16" else TOL_FUSED
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    shapes = {}
    for s in sites:
        shapes.setdefault(tuple(s[n] for n in ("ci", "co", "h", "w", "k")), s)
    for shape in EXTRA_FUSED_SHAPES:
        shapes[shape] = dict(zip(("ci", "co", "h", "w", "k"), shape))
    log(f"[2] fused-block kernels in {dname} at {len(shapes)} distinct shapes "
        f"of {len(sites)} fused sites and {len(EXTRA_FUSED_SHAPES)} odd "
        f"shapes, the dc also at {len(DC_WIDE_SHAPES)} shape(s) of 512^2")
    worst = {}
    mu_f64 = {"kernel": 0.0, "plain": 0.0}
    for shape, s in shapes.items():
        xp, wk, gamma, beta, g = (t.to(dtype)
                                  for t in fused_operands(s, gen))
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
        hold_fused(checks, shape, worst, tol)
        check_dc(g, out_p, stats_p, gamma, beta, shape, worst, tol)
    # a channel wider than a cluster's shared memory (dc_plan keeps what
    # fits and re-reads the rest; in bf16 it fits)
    for shape in DC_WIDE_SHAPES:
        xp, wk, gamma, beta, g = (t.to(dtype) for t in fused_operands(
            dict(zip(("ci", "co", "h", "w", "k"), shape)), gen))
        out_p, stats_p = tfb.fwd_plain(xp, wk, gamma, beta)
        check_dc(g, out_p, stats_p, gamma, beta, shape, worst, tol)
    suffix = "" if dname == "f32" else "_bf16"
    for (kname, what), (a, r) in worst.items():
        log(f"    {kname:18s} {what:6s} {dname:4s} worst max abs err {a:.3e} "
            f"rel {r:.3e} (tolerance {tol[what]:.0e}) ok")
        res = results.setdefault(kname, {})
        res[f"max_abs_err_{dname}"] = max(res.get(f"max_abs_err_{dname}", 0.0),
                                          a)
        res.setdefault("errors" + suffix, {})[what] = dict(max_abs_err=a,
                                                           rel=r)
    log(f"    fused_block_fwd {dname} mu against the float64 conv's mean, "
        f"worst rel: kernel {mu_f64['kernel']:.3e}, plain "
        f"{mu_f64['plain']:.3e}")
    results["fused_block_fwd"]["mu_rel_err_vs_f64" + suffix] = mu_f64


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


# Phase 2's concurrent launches: threads, each on a stream of its own, and
# the launches of each kernel a thread makes; a thread not done within the
# timeout fails the phase (a deadlock of two cooperative launches)
CONCURRENT_THREADS = 2
CONCURRENT_REPEATS = 20
CONCURRENT_TIMEOUT = 120


def concurrent_sites(conv_sites_den, fused_sites_den) -> tuple:
    """(the widest den conv site the dw runs at, i.e. not fused; the widest
    fused den site), by their convs' operations."""
    fused = {f["name"] for f in fused_sites_den}
    conv = max((s for s in conv_sites_den if s["name"] not in fused),
               key=lambda s: s["flops"])
    wide = max(fused_sites_den, key=lambda s: s["ci"] * s["co"] * s["h"]
               * s["w"] * s["k"] ** 2)
    return conv, wide


def check_concurrent_streams(conv_site, fused_site, a, results) -> None:
    """The kernels whose launches share state across calls, from several
    threads at once, as the fanout's threads launch them
    (parallel/fanout.py): ``cf_conv_dw`` at ``conv_site`` (f32),
    ``fused_block_fwd`` and ``fused_block_bwd_dw`` at ``fused_site`` and
    ``radon_dense_adj`` on path B's matrix ``a`` at one column. The two dw
    kernels and the dense adjoint count blocks in a ticket buffer (one per
    stream, ops/kernels/cf_conv.py::_tickets); the fused forward is a
    cooperative launch on every co-resident block. Each first runs alone
    on the current stream, held against its plain version; then
    CONCURRENT_THREADS threads, each on a stream of its own and started
    together, launch all four CONCURRENT_REPEATS times without a sync.
    Every result must equal the one alone bit for bit, and every thread
    end within CONCURRENT_TIMEOUT seconds."""
    import traceback
    import torch
    from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf
    from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb
    from mfvi_dip_mia_tpu_torch.ops.kernels import radon_dense as rd

    gen = torch.Generator(device=DEVICE).manual_seed(17)
    xp, _, g = conv_operands(conv_site, torch.float32, gen)
    k = conv_site["w"][2]
    fxp, fwk, gamma, beta, fg = fused_operands(fused_site, gen)
    fk = fused_site["k"]
    out_p, stats_p = tfb.fwd_plain(fxp, fwk, gamma, beta)
    dc_p = tfb.bwd_dc_plain(fg, out_p, stats_p, gamma, beta)[0]
    y = torch.randn((1, a.shape[0]), generator=gen, device=DEVICE)
    # name: (the kernel's call, its plain version's, a tolerance per output)
    calls = {
        "cf_conv_dw": (lambda: (tcf.conv_dw(xp, g, k, k),),
                       lambda: (tcf.conv_dw_plain(xp, g, k, k),),
                       (TOL[("dw", "f32")],)),
        "fused_block_fwd": (lambda: tfb.fwd(fxp, fwk, gamma, beta),
                            lambda: (out_p, stats_p),
                            (TOL_FUSED["out"], TOL_FUSED["mu"])),
        "fused_block_bwd_dw": (lambda: (tfb.bwd_dw(dc_p, fxp, fk),),
                               lambda: (tfb.bwd_dw_plain(dc_p, fxp, fk),),
                               (TOL_FUSED["dw"],)),
        "radon_dense_adj": (lambda: (rd.radon_dense_adj(a, y),),
                            lambda: (rd.radon_dense_adj_plain(a, y),),
                            (TOL[("radon_dense", "bf16")],)),
    }
    alone = {name: fn() for name, (fn, _, _) in calls.items()}
    torch.cuda.synchronize()
    for name, (_, plain, tols) in calls.items():
        for got, ref, tol in zip(alone[name], plain(), tols):
            err, r = rel_err(got, ref)
            if got.shape != ref.shape or r > tol:
                raise AssertionError(f"{name} alone for the concurrent "
                                     f"check: rel err {r:.3e} > {tol:.0e}")
    barrier = threading.Barrier(CONCURRENT_THREADS)
    got = [[] for _ in range(CONCURRENT_THREADS)]
    streams, errors = [None] * CONCURRENT_THREADS, []

    def work(t):
        try:
            stream = streams[t] = torch.cuda.Stream(DEVICE)
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                barrier.wait()
                for _ in range(CONCURRENT_REPEATS):
                    got[t].append({name: fn()
                                   for name, (fn, _, _) in calls.items()})
            stream.synchronize()
        except Exception:
            errors.append(traceback.format_exc())
            barrier.abort()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=work, args=(t,), daemon=True)
               for t in range(CONCURRENT_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(CONCURRENT_TIMEOUT)
    seconds = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"a concurrent-launch thread did not end within "
                             f"{CONCURRENT_TIMEOUT} s")
    if errors:
        raise AssertionError("a concurrent-launch thread failed:\n"
                             + "\n".join(errors))
    if len({s.cuda_stream for s in streams}) != CONCURRENT_THREADS:
        raise AssertionError("the concurrent-launch threads shared a stream")
    differ = {name: sum(not all(torch.equal(o, r) for o, r in
                                zip(launch[name], alone[name]))
                        for outs in got for launch in outs)
              for name in calls}
    log(f"[2] concurrent launches: {CONCURRENT_THREADS} threads on streams "
        f"of their own, {CONCURRENT_REPEATS} x (cf_conv_dw at "
        f"{conv_site['name']} xp {conv_site['xp']}, fused_block_fwd and "
        f"fused_block_bwd_dw at {fused_site['name']} (Ci, Co, H, W, k) "
        f"{tuple(fused_site[n] for n in ('ci', 'co', 'h', 'w', 'k'))}, "
        f"radon_dense_adj on A {tuple(a.shape)}, 1 column) each, "
        f"{seconds:.2f} s: launches with other bits than alone {differ}")
    if any(differ.values()):
        raise AssertionError(f"concurrent launches gave other bits: {differ}")
    for name in calls:
        results.setdefault(name, {})["concurrent_equal_bits"] = dict(
            threads=CONCURRENT_THREADS, launches_each=CONCURRENT_REPEATS,
            differing=differ[name])


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
# A bf16 CT step's launches: the 20 stride-1 conv -> BN -> LeakyReLU sites
# on the fused block (level 0's skip reads the input z: no dx), the five
# stride-2 down1 sites and the output conv on the conv kernels (forward 6,
# dx 5: level 0's down1 reads z), the banded Radon pair once each
CT_STEP_LAUNCHES = dict(cf_conv_fwd=11, cf_conv_dw=6, radon_banded_fwd=1,
                        radon_banded_adj=1, fused_block_fwd=20,
                        fused_block_bwd_dc=20, fused_block_bwd_dw=20,
                        fused_block_bwd_dx=19)


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


# the eager fit of each phase-3 path: its first chunk, then this many
# iterations timed (a diagnostic beside the graph fit's it/s, kept short so
# that the whole script stays near half its time limit)
EAGER_ITERS_TIMED = 50


def eager_rate(problem, method, **kw) -> float:
    """it/s of the same fit run eagerly (``fit(..., eager=True)``) over
    EAGER_ITERS_TIMED iterations after its first chunk, for the line beside
    the graph fit's."""
    from mfvi_dip_mia_tpu_torch.tasks.trainer import fit
    kw = dict(kw, num_iter=kw["show_every"] + EAGER_ITERS_TIMED - 1)
    res = fit(problem, method, eager=True, **kw)
    if res.replays:
        raise AssertionError("an eager fit replayed a graph")
    return res.iters_per_sec


_SHIPPED_LOADERS: dict = {}   # the data loaders before use_bench_images


def use_bench_images() -> None:
    """bench.py's images: the synthetic CT slice and x-ray at SIZE^2."""
    import mfvi_dip_mia_tpu_torch.tasks.data as D
    _SHIPPED_LOADERS.setdefault("get_img_ct", D.get_img_ct)
    _SHIPPED_LOADERS.setdefault("get_image_denoising", D.get_image_denoising)
    D.get_img_ct = lambda img: (D.synthetic_ct(img, SIZE), (SIZE, SIZE))
    D.get_image_denoising = lambda img: (D.synthetic_xray(img, SIZE),
                                         (SIZE, SIZE))


@contextlib.contextmanager
def shipped_images():
    """The package's own data loaders (what a child process loads) for the
    duration, bench.py's images again after."""
    import mfvi_dip_mia_tpu_torch.tasks.data as D
    saved = {k: getattr(D, k) for k in _SHIPPED_LOADERS}
    for k, f in _SHIPPED_LOADERS.items():
        setattr(D, k, f)
    try:
        yield
    finally:
        for k, f in saved.items():
            setattr(D, k, f)


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
        f"{res.iters_per_sec:.2f} it/s over the last {CT_ITERS_TIMED}, eager "
        f"{eager:.2f} it/s over {EAGER_ITERS_TIMED} (graph's first chunk "
        "incl. set-up "
        f"{res.compile_seconds:.1f} s)")
    log("    smoothed PSNR every 10 it: "
        + " ".join(f"{p:.2f}" for p in traj))
    log(f"    final smoothed PSNR {res.final_psnr:.3f} dB (iteration 0: "
        f"{res.psnrs[0, 2]:.3f}); launches {launches}")
    if not (np.isfinite(res.final_psnr)
            and res.final_psnr > res.psnrs[0, 2]):
        raise AssertionError("CT fit did not improve on iteration 0")
    hold_launches("the bf16 CT main path", launches, CONV | BANDED | FUSED)
    hold_step_launches("the bf16 CT main path", launches, steps_run(res),
                       CT_STEP_LAUNCHES)
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
        f"eager {eager:.2f} it/s over {EAGER_ITERS_TIMED} (graph's "
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
        f"eager {eager:.2f} it/s over {EAGER_ITERS_TIMED}, final "
        f"smoothed PSNR {res.final_psnr:.3f} dB (iteration 0: "
        f"{res.psnrs[0, 2]:.3f})")
    log(f"    launches per step {per_step}")
    if not (np.isfinite(res.final_psnr)
            and res.final_psnr > res.psnrs[0, 2]):
        raise AssertionError("dense CT fit did not improve on iteration 0")
    hold_launches("path B", launches, CONV | DENSE | FUSED)
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
        f"{wall:.1f} s), eager {eager:.2f} it/s over {EAGER_ITERS_TIMED}, "
        "final smoothed PSNR "
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
    import mfvi_dip_mia_tpu_torch.ops.downsampler as DS
    import mfvi_dip_mia_tpu_torch.ops.metrics as M
    import mfvi_dip_mia_tpu_torch.ops.pad as PD
    import mfvi_dip_mia_tpu_torch.ops.radon as R
    from mfvi_dip_mia_tpu_torch.ops.kernels import (cf_conv, fused_block,
                                                    radon_dense)
    out = {name: {repr(k): _tensor_ptrs(v) for k, v in d.items()}
           for name, d in (("cf_conv._TICKETS", cf_conv._TICKETS),
                           ("radon._dense_matrix", R._dense_matrix.entries),
                           ("pad._tables", PD._tables.entries),
                           ("layers._matrix_on", L._matrix_on.entries),
                           ("layers.band_on", L.band_on.entries),
                           ("downsampler._band_on", DS._band_on.entries),
                           ("downsampler._matrices_on",
                            DS._matrices_on.entries),
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
    ``cache_state`` is the same just before and just after each capture (a
    fit captures its two variants, and with tracing on the third,
    ``trainer.MARKED``)."""
    import numpy as np
    import torch
    import mfvi_dip_mia_tpu_torch.tasks.problems as P
    import mfvi_dip_mia_tpu_torch.tasks.trainer as T
    from mfvi_dip_mia_tpu_torch.ops import kernels
    from mfvi_dip_mia_tpu_torch.utils.profiling import TRACER

    variants = 3 if TRACER.enabled else 2

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
                    or len(caches_kept) != variants * GRAPH_FITS
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
    summary, ``run_task``, the interleaved group (``run_group_interleaved``
    and its ``fit_interleaved``), the fanout and the loop's GP and candidate
    search (module attributes, restored on exit). Each candidate gets one
    record; a group's candidates share its seconds evenly."""

    def __init__(self):
        import mfvi_dip_mia_tpu_torch.bo.loop as L
        import mfvi_dip_mia_tpu_torch.parallel.fanout as F
        import mfvi_dip_mia_tpu_torch.tasks.runners as R
        self.targets = [(R, "fit"), (R, "mc_summary"), (R, "run_task"),
                        (R, "fit_interleaved"), (R, "run_group_interleaved"),
                        (F, "run_candidates"), (L, "train_gp"),
                        (L, "find_candidates")]
        self.reset()

    def reset(self):
        self.candidates, self.rounds, self.failures = [], [], []
        # each fanout thread's candidate: its fit's and MC summary's seconds
        self._local = threading.local()

    def __enter__(self):
        import torch
        self.saved = [getattr(m, n) for m, n in self.targets]
        (fit, mc, run_task, fit_interleaved, group, fanout, train_gp,
         find) = self.saved

        def timed(fn, key):
            def wrapper(*a, **kw):
                t0 = time.perf_counter()
                r = fn(*a, **kw)
                cand = self._local.__dict__.setdefault("cand", {})
                cand[key] = time.perf_counter() - t0
                cand[key + "_result"] = r
                return r
            return wrapper

        def record(res, seconds, fit_s, mc_s, route):
            self.candidates.append(dict(
                seconds=seconds, fit_seconds=fit_s, mc_seconds=mc_s,
                setup_seconds=seconds - fit_s - mc_s, route=route,
                first_chunk_seconds=getattr(res, "compile_seconds", None),
                iters_per_sec=getattr(res, "iters_per_sec", None),
                replays=getattr(res, "replays", None),
                executed=getattr(res, "executed", None),
                final_psnr=getattr(res, "final_psnr", None)))

        # a candidate's thread waits for its own stream only: a device-wide
        # sync would break another fanout thread's capture
        def run_task_w(*a, **kw):
            self._local.cand = {}
            t0 = time.perf_counter()
            try:
                return run_task(*a, **kw)
            finally:
                torch.cuda.current_stream().synchronize()
                c = self._local.cand
                record(c.get("fit_result"), time.perf_counter() - t0,
                       c.get("fit", 0.0), c.get("mc_summary", 0.0), "run_task")

        def group_w(*a, **kw):
            self._local.cand = {}
            t0 = time.perf_counter()
            try:
                return group(*a, **kw)
            finally:
                torch.cuda.current_stream().synchronize()
                c, k = self._local.cand, len(a[2])
                total = time.perf_counter() - t0
                for res in c.get("fit_interleaved_result") or [None] * k:
                    record(res, total / k, c.get("fit_interleaved", 0.0) / k,
                           0.0, "interleaved")

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
                timed(fit_interleaved, "fit_interleaved"), group_w,
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
    ``0_fig_data.npz``; then round 0's candidates again through the
    per-candidate route (``interleave=False``: ``run_task`` on a thread
    each, with its MC summary). Round 0's 4 candidates on one card take
    JAX's interleaved route (``run_group_interleaved`` on one thread, no
    MC summary). Raises on a crashed
    candidate, a round without a kept one, a round-0 candidate off the
    interleaved route, fig_data keys other than the JAX loop's, a resumed
    (X, Y) or round-1 fig_data that is not the straight sweep's bit for
    bit, a per-candidate score of round 0 that is not the interleaved one
    bit for bit, or more than MEMORY_SLACK bytes more allocated after round
    2 than after round 1."""
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
        log(f"    candidate ({c['route']}): {c['seconds']:.2f} s = set-up "
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
    n0 = rounds[0]["candidates"]
    if [c["route"] for c in cands[:n0]] != ["interleaved"] * n0:
        raise AssertionError("round 0's candidates did not take the "
                             "interleaved route")
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

    # round 0 once more, a thread per candidate through run_task
    from mfvi_dip_mia_tpu_torch.parallel import fanout
    grid = [tuple(c) for c in itertools.product(
        *[v["candidates"] for v in bo_params.values()])]
    n_before = len(probe.candidates)
    t0 = time.perf_counter()
    plain_rp = dict(rp, save_path=os.path.join(tmp, "plain"))
    devices = plain_rp.pop("devices")
    plain_c, plain_y = fanout.run_candidates("ct", "mfvi", grid, plain_rp,
                                             devices, interleave=False)
    plain_s = time.perf_counter() - t0
    routes = {c["route"] for c in probe.candidates[n_before:]}
    k0 = rounds[0]["kept"]
    same = plain_c == list(X[:k0]) and plain_y == list(Y[:k0])
    log(f"[5] round 0's {len(grid)} candidates through run_task, a thread "
        f"each (interleave=False, with MC summaries): {plain_s:.2f} s, "
        f"Y {plain_y}: "
        + ("the interleaved scores bit for bit" if same else
           f"DIFFERENT from the interleaved {list(Y[:k0])}"))
    if not same or routes != {"run_task"}:
        raise AssertionError("round 0 per candidate differs from its "
                             "interleaved route")
    return dict(X=[list(map(float, x)) for x in X], Y=[float(y) for y in Y],
                seconds=wall, rounds=rounds, candidates=cands,
                launches=launches, resumed_equal=equal,
                per_candidate_round0=dict(Y=plain_y, seconds=plain_s,
                                          equal=same))


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


def time_fused_kernels(sites, results: dict, dtype=None) -> None:
    """Per training step of the den main path (f32), or with ``dtype`` bf16
    of the CT main path (its results under each kernel's "bf16" key, no
    library call beside them): each fused site's forward, dc, dw and (where
    the input needs it) dx, one launch each."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight
    from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb

    bf16 = dtype == torch.bfloat16
    item = 2 if bf16 else 4
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
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
        xp, wk, gamma, beta, g = (t.to(dtype or torch.float32)
                                  for t in fused_operands(s, gen))
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
             (n_io + n_out + 4 * co) * item,
             lambda: tfb.fwd(xp, wk, gamma, beta),
             lambda: tfb.fwd_plain(xp, wk, gamma, beta), None,
             lambda: F.leaky_relu(F.batch_norm(
                 F.conv2d(xp[None], wk), None, None, gamma, beta,
                 training=True), 0.2)),
            ("fused_block_bwd_dc", 14.0 * n_out, (3 * n_out + 6 * co) * item,
             lambda: tfb.bwd_dc(g, out, stats, gamma, beta),
             lambda: tfb.bwd_dc_plain(g, out, stats, gamma, beta), None,
             lambda: torch.ops.aten.native_batch_norm_backward(
                 torch.ops.aten.leaky_relu_backward(g[None], out[None],
                                                    tfb.SLOPE, True),
                 conv, gamma, None, None, mu, inv, True, tfb.EPS,
                 [True, True, True])),
            ("fused_block_bwd_dw", conv_flops, (n_out + n_io) * item,
             lambda: tfb.bwd_dw(dc, xp, k),
             lambda: tfb.bwd_dw_plain(dc, xp, k),
             lambda: conv2d_weight(xp[None], wk.shape, dc[None]), None)]
        if s["needs_dx"]:
            calls.append((
                "fused_block_bwd_dx", conv_flops, (n_out + n_io) * item,
                lambda: tfb.bwd_dx(dc, wk), lambda: tfb.bwd_dx_plain(dc, wk),
                lambda: conv2d_input((1,) + tuple(xp.shape), wk, dc[None]),
                None))
        if bf16:    # the kernels and their plain versions alone
            calls = [c[:5] + (None, None) for c in calls]
        return calls

    for s in sites:
        ci, co, h, w, k = (s[n] for n in ("ci", "co", "h", "w", "k"))
        calls = site_calls(s)
        row = dict(site=s["name"], shape=[ci, co, h, w, k])
        for name, flops, nbytes, fk, fp, fl, fc in calls:
            b_ms, _ = bound(flops, nbytes, peak)
            a = agg[name]
            t = dict(ms=time_ms(fk), plain_ms=time_ms(fp),
                     library_ms=time_ms(fl) if fl else 0.0,
                     chain_ms=time_ms(fc) if fc else 0.0, bound_ms=b_ms)
            for key, val in t.items():
                a[key] += val
            steps[name][0].append(fk)
            if fl or fc:
                steps[name][1].append(fl or fc)
            a["t_ops"] += flops / peak * 1e3
            a["t_bytes"] += nbytes / PEAK_BYTES_PER_S * 1e3
            a["calls"] += 1
            a["flops"] += flops
            a["nbytes"] += nbytes
            row[name] = t
        per_site.append(row)
    if bf16:
        for name, a in agg.items():
            r = results.setdefault(name, {})["bf16"] = dict(
                ms=a["ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
                bound_by=("operations" if a["t_ops"] > a["t_bytes"]
                          else "bytes"), calls_timed_per_step=a["calls"],
                device_ms=device_ms(lambda: [f() for f in steps[name][0]]))
            log(f"[6] {name} bf16: {a['calls']} launches per CT step: kernel "
                f"{a['ms']:.3f} ms, plain {a['plain_ms']:.3f} ms; profiler "
                f"device time {r['device_ms']:.4f} ms, bound "
                f"{a['bound_ms']:.4f} ms ({r['bound_by']})")
        results["_fused_sites_bf16"] = per_site
        return
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


# -- phase 9: the trainer's tail and the evaluation report ---------------------

TAIL_ITERS = 300              # each tail fit: 100 warm + 200 timed
TAIL_SHOW = 100
# the reference's scale-mixture prior schema (JAX tests/test_vi.py:209)
MIXTURE = {"mu": [0.0, 0.0], "sigma": [0.1, 0.0005], "pi": [0.75, 0.25]}
# launches per step of phase 9's fits (PERF.md §6): the mixture prior's den
# step is den/MFVI's; an ELU or Swish net fuses no site, so each of its 26
# sites runs cf_conv_fwd (24 with a dx) and cf_conv_dw, as the CT net's do
ACT_LAUNCHES = dict(cf_conv_fwd=50, cf_conv_dw=26)
CKPT_ITERS = 300              # 301 iterations in 7 chunks of 50 (the last 1)
CKPT_SHOW = 50
CKPT_EVERY = 2                # checkpoints after chunks 2, 4 and 6
EARLY_ITERS = 2000            # run_den_dip's budget; the stop must fire
EARLY_STOP = {"patience": 200, "min_delta": 2.0}
EARLY_SHOW = 100
REPORT_ITERS = 100            # each report run: 101 iterations
# the report on the card against the same report on the CPU
REPORT_PSNR_DB, REPORT_SSIM, REPORT_UCE_REL = 1e-4, 1e-6, 1e-6


def den_tail_problem(act_fun: str = "LeakyReLU",
                     downsample_mode: str = "stride"):
    """bench.py's den problem (256^2 synthetic x-ray, input depth 16) on the
    card; with another ``act_fun`` or ``downsample_mode`` its net is the
    same 5-scale net built with that activation or pooling."""
    import dataclasses
    import mfvi_dip_mia_tpu_torch.tasks.problems as P
    use_bench_images()
    problem = P.build_problem("den", "mfvi", 0, input_depth=16,
                              device=DEVICE)
    if act_fun != "LeakyReLU" or downsample_mode != "stride":
        problem = dataclasses.replace(problem, net=den_net(
            act_fun=act_fun, downsample_mode=downsample_mode))
    return problem


def den_net(**kw):
    """bench.py's 5-scale den net (widths [16, 32, 64, 128, 128], skip 4,
    input depth 16, reflection pad, bilinear up), with ``kw`` on top."""
    from mfvi_dip_mia_tpu_torch.nn import build_skip_net
    widths = [16, 32, 64, 128, 128]
    return build_skip_net(16, n_channels=2, pad="reflection",
                          skip_n33d=widths, skip_n33u=widths, skip_n11=4,
                          num_scales=5, upsample_mode="bilinear", **kw)


def tail_fits() -> dict:
    """den/MFVI f32 at SIZE^2 (temp 5.66e-7, sigma 1.46e-5, lr 1e-3, seed
    1) with the mixture prior MIXTURE, and with ELU and Swish nets under
    the scalar prior: for each a graph fit of TAIL_ITERS iterations (every
    iteration a replay, the launches per step exactly predicted, a finite
    final smoothed PSNR, the mixture fit's above iteration 0's) and the
    same fit eagerly, equal bit for bit; the mixture fit also a second
    graph fit, equal too."""
    import numpy as np
    from mfvi_dip_mia_tpu_torch.ops import kernels
    from mfvi_dip_mia_tpu_torch.tasks.trainer import Method, fit

    out = {}
    for label, act, prior, expected, graphs in (
            ("mixture prior", "LeakyReLU", MIXTURE,
             STEP_LAUNCHES["5-scale"], 2),
            ("ELU", "ELU", None, ACT_LAUNCHES, 1),
            ("Swish", "Swish", None, ACT_LAUNCHES, 1)):
        problem = den_tail_problem(act)
        method = Method("mfvi", temp=5.66e-7, sigma=1.46e-5, prior=prior)
        kw = dict(num_iter=TAIL_ITERS - 1, show_every=TAIL_SHOW, lr=1e-3,
                  seed=1, metrics_every=1, collect_snapshots=False,
                  device=DEVICE)
        kernels.reset_launches()
        res = fit(problem, method, **kw)
        launches = {k.name: k.launches for k in kernels.KERNELS}
        again = [fit(problem, method, **kw) for _ in range(graphs - 1)]
        eager = fit(problem, method, eager=True, **kw)
        equal = all(same_bits(res, r) for r in again + [eager])
        log(f"[9] den/mfvi f32 {SIZE}^2, {label}: graph "
            f"{res.iters_per_sec:.2f} it/s, eager {eager.iters_per_sec:.2f} "
            f"it/s over the last {TAIL_ITERS - TAIL_SHOW}; final smoothed "
            f"PSNR {res.final_psnr:.3f} dB (iteration 0: "
            f"{res.psnrs[0, 2]:.3f}); {graphs} graph fit(s) and the eager "
            "fit " + ("equal" if equal else "DIFFER"))
        per_step = hold_step_launches(f"the {label} fit", launches,
                                      steps_run(res), expected)
        log(f"    launches per step {per_step} (as predicted)")
        for r in [res] + again:
            hold_replays(f"the {label} fit", r)
        if eager.replays:
            raise AssertionError("an eager fit replayed a graph")
        if not np.isfinite(res.final_psnr) or (
                prior is not None and res.final_psnr <= res.psnrs[0, 2]):
            raise AssertionError(f"the {label} fit's PSNR is not finite, or "
                                 "the mixture fit's not above iteration 0's")
        if not equal:
            raise AssertionError(f"the {label} fits gave different bits")
        out[label] = dict(iters_per_sec=res.iters_per_sec,
                          eager_iters_per_sec=eager.iters_per_sec,
                          final_psnr=res.final_psnr,
                          psnr_it0=float(res.psnrs[0, 2]),
                          steps_run=steps_run(res), launches=launches,
                          launches_per_step=per_step, equal_bits=equal)
    return out


def _same_snapshots(a, b) -> bool:
    import numpy as np
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in SNAPSHOTS)


def checkpoint_resume(tmp: str) -> dict:
    """A den/MFVI graph fit of CKPT_ITERS iterations with snapshots every
    CKPT_SHOW (7 chunks), uninterrupted, then again with a checkpoint every
    CKPT_EVERY chunks (after chunks 2, 4 and 6; the chunk-2 file copied
    before the fit overwrites it). Fits resumed from the chunk-2 copy and
    from the chunk-6 file must give the uninterrupted fit's bits in every
    row, snapshot and final parameter, replaying only the iterations after
    their chunk. The chunk-2 file of an eager fit must hold the graph
    fit's generator state and state tensors bit for bit: the replays
    advance the generator's offset as the eager steps do."""
    import shutil
    import numpy as np
    import mfvi_dip_mia_tpu_torch.tasks.trainer as T

    problem = den_tail_problem()
    method = T.Method("mfvi", temp=5.66e-7, sigma=1.46e-5)
    kw = dict(num_iter=CKPT_ITERS, show_every=CKPT_SHOW, lr=1e-3, seed=1,
              metrics_every=1, device=DEVICE)
    full = T.fit(problem, method, **kw)
    path = os.path.join(tmp, "fit.npz")
    copy2 = os.path.join(tmp, "fit_chunk2.npz")
    saves = []
    save = T.save_fit_checkpoint

    def timed_save(*args):
        t0 = time.perf_counter()
        save(*args)
        saves.append((args[3], time.perf_counter() - t0))

    def copy_chunk2(i, row):
        # the log of chunk 3 (iterations 100-149) comes before any later save
        if i == 3 * CKPT_SHOW - 1:
            shutil.copy(path, copy2)

    T.save_fit_checkpoint = timed_save
    try:
        written = T.fit(problem, method, checkpoint_path=path,
                        checkpoint_every_chunks=CKPT_EVERY,
                        log_fn=copy_chunk2, **kw)
    finally:
        T.save_fit_checkpoint = save
    if [c for c, _ in saves] != [2, 4, 6]:
        raise AssertionError(f"checkpoints after chunks {saves}, expected "
                             "2, 4, 6")
    size = os.path.getsize(path)
    out = dict(file_bytes=size, save_seconds=[s for _, s in saves])
    checks = {"with checkpoints": (written, full.executed)}
    for label, src in (("resumed at chunk 2", copy2),
                       ("resumed at chunk 6", path)):
        with np.load(src) as z:
            chunk = int(z["chunk"])
        res = T.fit(problem, method, checkpoint_path=src, resume=True, **kw)
        checks[label] = (res, full.executed - chunk * CKPT_SHOW)
    for label, (res, replays) in checks.items():
        equal = same_bits(res, full) and _same_snapshots(res, full)
        log(f"[9] checkpoint / resume, {label}: "
            + ("equal" if equal else "DIFFER") + " to the uninterrupted "
            f"graph fit; {res.replays} replays ({res.iters_per_sec:.2f} "
            "it/s)")
        if not equal or res.replays != replays:
            raise AssertionError(f"{label}: not the uninterrupted fit's bits, "
                                 f"or {res.replays} replays for {replays}")
        out[label] = dict(equal=equal, replays=res.replays)

    # the eager fit's chunk-2 file against the graph fit's
    eager_path = os.path.join(tmp, "eager.npz")
    T.fit(problem, method, eager=True, checkpoint_path=eager_path,
          checkpoint_every_chunks=CKPT_EVERY,
          **dict(kw, num_iter=3 * CKPT_SHOW))
    with np.load(copy2) as g, np.load(eager_path) as e:
        same = {k: np.array_equal(g[k], e[k], equal_nan=True)
                for k in ("chunk", "generator", "state_flat", "state_m",
                          "state_v", "state_count", "state_it",
                          "state_out_avg", "state_ring_epi")}
    log(f"[9] checkpoint file {size / 2 ** 20:.2f} MiB, each save "
        + ", ".join(f"{s:.3f}" for s in out["save_seconds"]) + " s; the "
        "eager fit's chunk-2 file against the graph fit's: "
        + ("equal" if all(same.values()) else f"DIFFER {same}"))
    if not all(same.values()):
        raise AssertionError(f"the eager and graph checkpoints differ: {same}")
    out["eager_file_equal"] = same
    return out


def early_stop_run(tmp: str) -> dict:
    """run_den_dip on the card with EARLY_STOP over EARLY_ITERS iterations
    (save.npz, no plots): the stop must fire; ``executed`` must equal what
    _EarlyStop decides on the fit's own rows, chunk by chunk; the rows
    after it NaN; the replays and the launches per step (den dip's) must
    count exactly the iterations executed."""
    import numpy as np
    import mfvi_dip_mia_tpu_torch.tasks.runners as R
    from mfvi_dip_mia_tpu_torch.ops import kernels
    from mfvi_dip_mia_tpu_torch.tasks.trainer import _EarlyStop

    use_bench_images()
    seen = {}
    fit = R.fit

    def keep(problem, method, **kw):
        seen["res"] = fit(problem, method, **kw)
        return seen["res"]

    R.fit = keep
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        psnr = R.run_den_dip(device=0, num_iter=EARLY_ITERS,
                             early_stop=EARLY_STOP, save=True, plot=False,
                             save_path=tmp, lr=1e-3, seed=1, input_depth=16,
                             show_every=EARLY_SHOW)
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels.KERNELS}
    finally:
        R.fit = fit
    res = seen["res"]
    col = res.psnrs[:, 2]
    stop, expected = _EarlyStop(EARLY_STOP), EARLY_ITERS + 1
    for start in range(0, EARLY_ITERS + 1, EARLY_SHOW):
        end = min(start + EARLY_SHOW, EARLY_ITERS + 1)
        if stop.should_stop(col[start:end], start):
            expected = end
            break
    log(f"[9] run_den_dip with early_stop {EARLY_STOP}: executed "
        f"{res.executed} of {EARLY_ITERS + 1} (the rows give {expected}), "
        f"best smoothed PSNR {stop.best:.3f} dB at iteration "
        f"{stop.best_iter}, final {psnr:.3f} dB, {res.replays} replays, "
        f"{wall:.1f} s")
    if not (res.executed == expected < EARLY_ITERS + 1):
        raise AssertionError("the early stop did not fire where the rows say")
    if not (np.isfinite(res.psnrs[:res.executed]).all()
            and np.isnan(res.psnrs[res.executed:]).all()
            and psnr == col[res.executed - 1]):
        raise AssertionError("the early-stopped rows are not NaN after it")
    hold_replays("the early-stopped run", res)
    per_step = hold_step_launches("the early-stopped run", launches,
                                  steps_run(res), STEP_LAUNCHES["5-scale"])
    return dict(executed=res.executed, expected=expected,
                replays=res.replays, best_iter=stop.best_iter,
                final_psnr=psnr, seconds=wall, launches_per_step=per_step)


def _hold_reports(card: dict, cpu: dict) -> dict:
    """The largest differences between the card's report and the CPU's:
    PSNR in dB, SSIM, UCE relative; raises beyond the tolerances."""
    worst = dict(psnr_db=0.0, ssim=0.0, uce_rel=0.0)
    for path, c in cpu["runs"].items():
        g = card["runs"][path]
        if g["summary"] != c["summary"] or g.get("mc_mean") != c.get(
                "mc_mean"):
            raise AssertionError(f"{path}: the summary tables differ")
        if g["calibration"].keys() != c["calibration"].keys() or \
                g["classical"].keys() != c["classical"].keys():
            raise AssertionError(f"{path}: the report's rows differ")
        for name, cal in c["calibration"].items():
            worst["uce_rel"] = max(worst["uce_rel"], abs(
                g["calibration"][name]["uce"] - cal["uce"]) / cal["uce"])
        for name, row in c["classical"].items():
            worst["psnr_db"] = max(worst["psnr_db"], abs(
                g["classical"][name]["psnr"] - row["psnr"]))
            worst["ssim"] = max(worst["ssim"], abs(
                g["classical"][name]["ssim"] - row["ssim"]))
    if (worst["psnr_db"] > REPORT_PSNR_DB or worst["ssim"] > REPORT_SSIM
            or worst["uce_rel"] > REPORT_UCE_REL):
        raise AssertionError(f"the card's report is off the CPU's: {worst}")
    return worst


def report_phase(tmp: str) -> dict:
    """One REPORT_ITERS-iteration run each of run_den_mfvi, run_ct_mfvi (the
    FBP row), run_sr_mfvi (384^2, the bicubic row) and run_inp_mfvi (no
    classical row) on the card, with the test configs' candidates, img,
    input depth and lr (den, ct: bench.py's 256^2 images); write_report on
    their save.npz files with with_maps=False on the card and on the CPU,
    held within REPORT_*; each classical baseline and FBP timed on the card;
    and evaluation.main once on the card."""
    import glob
    import numpy as np
    import torch
    import mfvi_dip_mia_tpu_torch.tasks.runners as R
    from mfvi_dip_mia_tpu_torch.ops import classical as C
    from mfvi_dip_mia_tpu_torch.ops.radon import fbp
    from mfvi_dip_mia_tpu_torch.tasks import evaluation as E

    use_bench_images()
    paths = {}
    for task in ("den", "ct", "sr", "inp"):
        _, lr, cand = method_of(task, "mfvi")
        rp = run_params_of(task, "mfvi")
        save = os.path.join(tmp, f"run_{task}")
        img = rp["img"] if task in ("sr", "inp") else 0
        R.ALL_RUNNERS[f"run_{task}_mfvi"](
            device=DEVICE, img=img, num_iter=REPORT_ITERS, lr=lr, seed=1,
            input_depth=rp["input_depth"], show_every=REPORT_ITERS // 2,
            plot=False, save=True, save_path=save, **cand)
        (paths[task],) = glob.glob(os.path.join(save, "*", "save.npz"))
    files = list(paths.values())
    t0 = time.perf_counter()
    card = E.write_report(files, os.path.join(tmp, "card"), with_maps=False,
                          device=DEVICE)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = E.write_report(files, os.path.join(tmp, "cpu"), with_maps=False,
                         device="cpu")
    cpu_s = time.perf_counter() - t0
    worst = _hold_reports(card, cpu)
    rows = {t: card["runs"][p]["classical"] for t, p in paths.items()}
    if {t: set(r) for t, r in rows.items()} != {
            "den": {"wavelet", "tv_chambolle", "bilateral"},
            "ct": {"fbp_shepp_logan"}, "sr": {"bicubic"}, "inp": set()}:
        raise AssertionError(f"the report's classical rows: {rows}")
    for t, p in paths.items():
        run = card["runs"][p]
        if not (set(run["calibration"]) == {"mfvi"}
                and np.isfinite(run["calibration"]["mfvi"]["uce"])
                and np.isfinite(run["summary"]["mfvi"]["psnr_converged"])):
            raise AssertionError(f"{t}: the report's rows are not finite")
    log(f"[9] write_report on 4 runs: card {card_s:.2f} s, CPU {cpu_s:.2f} "
        f"s; largest differences PSNR {worst['psnr_db']:.2e} dB, SSIM "
        f"{worst['ssim']:.2e}, UCE {worst['uce_rel']:.2e} relative (held "
        f"to {REPORT_PSNR_DB}, {REPORT_SSIM}, {REPORT_UCE_REL})")
    log("    " + "; ".join(
        f"{t} " + ", ".join(f"{n} {r['psnr']:.3f} dB" for n, r in
                            rows[t].items())
        + f", UCE {card['runs'][p]['calibration']['mfvi']['uce']:.5f}"
        for t, p in paths.items()))

    # each baseline on the card, timed alone (after one warm call)
    with np.load(paths["den"]) as z:
        noisy = np.asarray(z["img_noisy"], np.float32)
    with np.load(paths["sr"]) as z:
        lr_img = np.asarray(z["img_lr"], np.float32)[None]
    with np.load(paths["ct"]) as z:
        sino = torch.from_numpy(np.asarray(z["img_radon"], np.float32)).to(
            DEVICE)
    t_ang = sino.shape[2]
    theta = np.arange(t_ang, dtype=np.float32) * (180.0 / t_ang)
    calls = {
        "wavelet": lambda: C.wavelet_denoise(noisy, device=DEVICE),
        "tv_chambolle": lambda: C.tv_denoise_chambolle(noisy, device=DEVICE),
        "bilateral": lambda: C.bilateral_denoise(noisy, device=DEVICE),
        "bicubic": lambda: C.bicubic_upscale(lr_img, 4, device=DEVICE),
        "fbp": lambda: fbp(sino, theta, SIZE),
    }
    seconds = {}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    log("[9] on the card: " + ", ".join(f"{n} {s * 1e3:.1f} ms"
                                        for n, s in seconds.items()))
    t0 = time.perf_counter()
    main_report = E.main([paths["den"], paths["ct"], "--out",
                          os.path.join(tmp, "main"), "--no-maps"])
    main_s = time.perf_counter() - t0
    if main_report["runs"].keys() != {paths["den"], paths["ct"]}:
        raise AssertionError("evaluation.main reported other runs")
    return dict(card_seconds=card_s, cpu_seconds=cpu_s, worst=worst,
                classical=rows, baseline_seconds=seconds,
                main_seconds=main_s)


def tail_phase() -> dict:
    """Phase 9: the mixture-prior, ELU and Swish fits, checkpoint / resume,
    early stop and the evaluation report, everything written to a temporary
    directory, removed after. Returns the phase's results, with "launches"
    the launches of its three tail fits' graph fits."""
    import shutil
    import tempfile
    from mfvi_dip_mia_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    out = {"fits": tail_fits()}
    out["launches"] = {k.name: sum(f["launches"][k.name]
                                   for f in out["fits"].values())
                       for k in kernels.KERNELS}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tail_")
    try:
        out["checkpoint"] = checkpoint_resume(tmp)
        out["early_stop"] = early_stop_run(tmp)
        out["report"] = report_phase(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"[9] phase 9 took {out['seconds']:.1f} s")
    return out



# -- phase 10: the library tail ------------------------------------------------

LIB_ITERS = 300               # the lanczos2 fits: 100 warm + 200 timed
LIB_SHOW = 100
POOL_ITERS = 100              # the avg and max fits: 50 warm + 50 timed
POOL_SHOW = 50
# launches per step of phase 10's pooled den fits (PERF.md §6): a pooled
# down1 site runs its stride-1 conv on cf_conv_fwd (level 0's without a
# dx) and cf_conv_dw, where the stride-2 site ran its parity planes, so
# den/MFVI's counts hold; the pools are plain PyTorch
POOLED_LAUNCHES = STEP_LAUNCHES["5-scale"]
GAUSS_P = 0.3
# Gaussian dropout at three of the den net's stride-1 site shapes: (C, O,
# size, k), level 0's up, level 2's down2, level 4's up
GAUSS_SITES = ((36, 16, 256, 3), (64, 64, 64, 3), (256, 128, 16, 3))
CLS_POINTS, CLS_EPOCHS = 256, 30
SGLD_STEPS = 20
# one ELBO step, card against CPU, as a share of the largest value
ELBO_REL = 1e-5
# a noise-free SGLD-family run, card against CPU, per element
SGLD_RTOL = 1e-6
TRACE_ITERS = 5


def pooled_fits() -> dict:
    """den/MFVI f32 at SIZE^2 (temp 5.66e-7, sigma 1.46e-5, lr 1e-3, seed
    1) on the 5-scale net with ``downsample_mode`` lanczos2 (two graph fits
    of LIB_ITERS iterations and an eager one), avg and max (a graph fit and
    an eager one of POOL_ITERS): every iteration of a graph fit a replay,
    the launches per step exactly POOLED_LAUNCHES in graph and eager fits,
    equal bits, the lanczos fit's final smoothed PSNR finite and above
    iteration 0's. Launch counters are zeroed just before each graph fit and
    read just after it."""
    import numpy as np
    from mfvi_dip_mia_tpu_torch.ops import kernels
    from mfvi_dip_mia_tpu_torch.tasks.trainer import Method, fit

    out = {}
    for mode, iters, show, graphs in (("lanczos2", LIB_ITERS, LIB_SHOW, 2),
                                      ("avg", POOL_ITERS, POOL_SHOW, 1),
                                      ("max", POOL_ITERS, POOL_SHOW, 1)):
        problem = den_tail_problem(downsample_mode=mode)
        if [c.down1.downsample_mode for c in problem.net.levels] != [mode] * 5:
            raise AssertionError(f"the {mode} net's down1 sites are not "
                                 "pooled")
        method = Method("mfvi", temp=5.66e-7, sigma=1.46e-5)
        kw = dict(num_iter=iters - 1, show_every=show, lr=1e-3, seed=1,
                  metrics_every=1, collect_snapshots=False, device=DEVICE)
        kernels.reset_launches()
        res = fit(problem, method, **kw)
        launches = {k.name: k.launches for k in kernels.KERNELS}
        again = [fit(problem, method, **kw) for _ in range(graphs - 1)]
        kernels.reset_launches()
        eager = fit(problem, method, eager=True, **kw)
        eager_launches = {k.name: k.launches for k in kernels.KERNELS}
        equal = all(same_bits(res, r) for r in again + [eager])
        log(f"[10] den/mfvi f32 {SIZE}^2, {mode} pools: graph "
            f"{res.iters_per_sec:.2f} it/s, eager {eager.iters_per_sec:.2f} "
            f"it/s over the last {iters - show}; final smoothed PSNR "
            f"{res.final_psnr:.3f} dB (iteration 0: {res.psnrs[0, 2]:.3f}); "
            f"{graphs} graph fit(s) and the eager fit "
            + ("equal" if equal else "DIFFER"))
        per_step = hold_step_launches(f"the {mode} graph fit", launches,
                                      steps_run(res), POOLED_LAUNCHES)
        hold_step_launches(f"the {mode} eager fit", eager_launches,
                           eager.executed, POOLED_LAUNCHES)
        log(f"     launches per step {per_step} (as predicted, graph and "
            "eager)")
        for r in [res] + again:
            hold_replays(f"the {mode} fit", r)
        if eager.replays:
            raise AssertionError("an eager fit replayed a graph")
        if not np.isfinite(res.final_psnr) or (
                mode == "lanczos2" and res.final_psnr <= res.psnrs[0, 2]):
            raise AssertionError(f"the {mode} fit's PSNR is not finite, or "
                                 "the lanczos2 fit's not above iteration "
                                 "0's")
        if not equal:
            raise AssertionError(f"the {mode} fits gave different bits")
        out[mode] = dict(iters_per_sec=res.iters_per_sec,
                         eager_iters_per_sec=eager.iters_per_sec,
                         final_psnr=res.final_psnr,
                         psnr_it0=float(res.psnrs[0, 2]),
                         steps_run=steps_run(res), launches=launches,
                         launches_per_step=per_step, equal_bits=equal,
                         result=res, problem=problem, method=method, kw=kw)
    return out


def pooled_site_times(net) -> dict:
    """The profiler's device time of cf_conv_fwd (forward and dx) and
    cf_conv_dw over the pooled net's five down1 sites (stride 1 at full
    resolution) and at each site, beside cuDNN's for the same calls (TF32
    off), f32; and the same calls' time by CUDA events."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight
    from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf

    gen = torch.Generator(device=DEVICE).manual_seed(14)
    sites = [s for s in conv_sites(net, SIZE) if s["name"].endswith("down1")]
    fwd, fwd_l, dw, dw_l, names = [], [], [], [], []
    for s in sites:
        xp, w, g = conv_operands(s, torch.float32, gen)
        k = w.shape[2]
        fwd.append(lambda xp=xp, w=w: tcf.conv_valid_fwd(xp, w))
        fwd_l.append(lambda xp=xp, w=w: F.conv2d(xp[None], w))
        names.append(f"{s['name']} fwd")
        if s["needs_dx"]:
            fwd.append(lambda g=g, w=w: tcf.conv_dx(g, w))
            fwd_l.append(lambda xp=xp, g=g, w=w: conv2d_input(
                (1,) + tuple(xp.shape), w, g[None]))
            names.append(f"{s['name']} dx")
        dw.append(lambda xp=xp, g=g, k=k: tcf.conv_dw(xp, g, k, k))
        dw_l.append(lambda xp=xp, g=g, w=w: conv2d_weight(
            xp[None], w.shape, g[None]))
    out = {}
    for label, kern, lib, tag, labels in (
            ("cf_conv_fwd (fwd + dx)", fwd, fwd_l, "conv_fwd_mma_kernel",
             names),
            ("cf_conv_dw", dw, dw_l, "conv_dw_mma_kernel",
             [s["name"] for s in sites])):
        k_ms = device_ms(lambda: [f() for f in kern])
        l_ms = device_ms(lambda: [f() for f in lib])
        try:
            per = dict(zip(labels, site_device_ms(kern, tag)))
        except RuntimeError as e:
            # a profile now and then loses launches (device_ms): the
            # per-site split is then not measured, the totals stand
            log(f"[10] {label}: per-site device time not measured ({e})")
            per = None
        out[label] = dict(calls=len(kern), device_ms=k_ms,
                          library_device_ms=l_ms, site_device_ms=per,
                          ms=time_ms(lambda: [f() for f in kern]),
                          library_ms=time_ms(lambda: [f() for f in lib]))
        log(f"[10] {label} at the 5 pooled down1 sites: {len(kern)} calls, "
            f"device {k_ms:.4f} ms"
            + ("" if per is None else " (" + ", ".join(
                f"{n} {v:.4f}" for n, v in per.items()) + ")")
            + f", cuDNN {l_ms:.4f} ms; CUDA events {out[label]['ms']:.4f} "
            f"ms, cuDNN {out[label]['library_ms']:.4f} ms")
    return out


def gaussian_dropout_on_card() -> dict:
    """``gaussian_dropout_conv`` at GAUSS_SITES, batch 1: each call one
    ``lrt_conv_fwd`` launch; its two moments (the kernel's double conv on
    (x, w, w^2)) against ``fused_double_conv``; its output and its gradients
    in x and w against the CPU's plain path with the same noise tensor
    substituted for the draw. Returns the launches of the calls (path) and
    the worst errors."""
    import torch
    import torch.nn.functional as F
    import mfvi_dip_mia_tpu_torch.bayes.dropout as D
    from mfvi_dip_mia_tpu_torch.ops import kernels
    from mfvi_dip_mia_tpu_torch.ops.kernels import lrt_conv as tlrt

    gen = torch.Generator(device=DEVICE).manual_seed(15)
    draw = D.gaussian_eps
    launches = {k.name: 0 for k in kernels.KERNELS}
    worst = {}

    def hold(what, got, ref, tol):
        a, r = rel_err(got, ref)
        if not bool(torch.isfinite(got).all()) or r > tol:
            raise AssertionError(f"gaussian_dropout_conv {what}: max abs err "
                                 f"{a:.3e} (rel {r:.3e}) > {tol:.0e}, or "
                                 "not finite")
        worst[what] = max(worst.get(what, 0.0), r)

    try:
        for c, o, size, k in GAUSS_SITES:
            x = torch.rand((1, c, size, size), generator=gen, device=DEVICE)
            w = torch.randn((o, c, k, k), generator=gen, device=DEVICE) / (
                c * k * k) ** 0.5
            pad = (k - 1) // 2
            eps = torch.randn((1, o, size, size), generator=gen,
                              device=DEVICE)
            g = torch.randn_like(eps)
            D.gaussian_eps = lambda shape, gn, e=eps: e.to(gn.device)
            outs = {}
            for dev in (DEVICE, "cpu"):
                xd = x.to(dev).clone().requires_grad_(True)
                wd = w.to(dev).clone().requires_grad_(True)
                before = kernels.counts()
                out = D.gaussian_dropout_conv(
                    xd, wd, GAUSS_P, torch.Generator(device=dev), 1, pad)
                if dev == DEVICE:
                    fwd_calls = (tlrt.FWD.launches
                                 - before[kernels.KERNELS.index(tlrt.FWD)])
                    if fwd_calls != 1:
                        raise AssertionError(
                            f"gaussian_dropout_conv at {(c, o, size, k)} "
                            f"launched lrt_conv_fwd {fwd_calls} times")
                (out * g.to(dev)).sum().backward()
                if dev == DEVICE:
                    for kern, b, a in zip(kernels.KERNELS, before,
                                          kernels.counts()):
                        launches[kern.name] += a - b
                outs[dev] = (out.detach(), xd.grad, wd.grad)
            torch.cuda.synchronize()
            # the kernel's two moments against the plain double conv
            xs = F.pad(x[0], (pad,) * 4)
            got = tlrt.double_conv_fwd(xs, w, w * w)
            ref = tlrt.fused_double_conv(xs, w, w * w)
            for what, a, b in zip(("mu", "second"), got, ref):
                hold(what, a, b, TOL[("lrt", "f32")])
            card, cpu = outs[DEVICE], outs["cpu"]
            hold("out (card vs CPU)", card[0].cpu(), cpu[0],
                 TOL[("lrt", "f32")])
            hold("dx (card vs CPU)", card[1].cpu(), cpu[1],
                 TOL[("lrt_bwd", "f32")])
            hold("dw (card vs CPU)", card[2].cpu(), cpu[2],
                 TOL[("lrt_bwd", "f32")])
    finally:
        D.gaussian_eps = draw
    log(f"[10] gaussian_dropout_conv at {len(GAUSS_SITES)} den site shapes: "
        "one lrt_conv_fwd launch a call; worst relative errors "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return dict(launches=launches, worst_rel=worst)


def cls_apply(params, x, generator=None, training=True):
    """The 2-16-2 variational MLP of JAX tests/test_aux.py:166-204, its two
    layers 1x1 conv leaves (a batch of points as (N, 2, 1, 1))."""
    import torch
    from mfvi_dip_mia_tpu_torch.nn.var_conv import apply_conv_leaf

    def leaf(name):
        return {k[len(name) + 1:]: v for k, v in params.items()
                if k.startswith(name + ".")}

    h = torch.relu(apply_conv_leaf(leaf("l1"), x[:, :, None, None], stride=1,
                                   padding=0, generator=generator,
                                   training=training))
    return apply_conv_leaf(leaf("l2"), h, stride=1, padding=0,
                           generator=generator, training=training)[:, :, 0, 0]


def cls_params(seed: int = 0) -> dict:
    """The MLP's variational parameters (CPU), from a seeded generator."""
    import torch
    from mfvi_dip_mia_tpu_torch.bayes.vi import to_mfvi
    from mfvi_dip_mia_tpu_torch.nn import init as init_lib
    gen = torch.Generator().manual_seed(seed)
    params = {"l1.w": init_lib.conv_kernel_torch_default(gen, 1, 1, 2, 16),
              "l1.b": torch.zeros(16),
              "l2.w": init_lib.conv_kernel_torch_default(gen, 1, 1, 16, 2),
              "l2.b": torch.zeros(2)}
    return to_mfvi(params, gen)


def classification_on_card() -> dict:
    """The ClassificationTrainer / Predictor problem of JAX
    tests/test_aux.py:166-204 on the card (CLS_POINTS points, CLS_EPOCHS
    epochs, beta 1e-5, lr 5e-2, prior sigma 1): accuracy above 0.9. Then
    one Blundell ``make_elbo_step`` on the card against the CPU, the RT
    weight draws substituted by one fixed table on both: loss, accuracy,
    parameters and moments within ELBO_REL of the largest."""
    import numpy as np
    import torch
    import mfvi_dip_mia_tpu_torch.nn.var_conv as VC
    from mfvi_dip_mia_tpu_torch.bayes import classification as C

    rng = np.random.default_rng(0)
    x = rng.standard_normal((CLS_POINTS, 2)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.int64)
    t0 = time.perf_counter()
    trainer = C.ClassificationTrainer(cls_apply, cls_params(), lr=5e-2,
                                      prior_sigma=1.0, n_batches=1,
                                      beta_type=1e-5, device=DEVICE)
    if trainer.device.type != torch.device(DEVICE).type:
        raise AssertionError("the trainer is not on the card")
    gen = torch.Generator(device=DEVICE)
    for epoch in range(CLS_EPOCHS):
        gen.manual_seed(10 + epoch)
        trainer.train_epoch([(x, y)], gen)
    pred = C.Predictor(cls_apply, trainer.params, n_samples=16)(x)
    acc = float((pred.argmax(-1).cpu().numpy() == y).mean())
    train_s = time.perf_counter() - t0
    log(f"[10] ClassificationTrainer on the card: {CLS_EPOCHS} epochs, "
        f"loss {trainer.log.losses[0]:.4f} -> {trainer.log.losses[-1]:.4f}, "
        f"Predictor accuracy {acc:.4f} ({train_s:.2f} s)")
    if not acc > 0.9:
        raise AssertionError(f"classification accuracy {acc} <= 0.9")

    params = cls_params(1)
    # the four sampled leaves' shapes differ: one fixed draw per shape
    table = {tuple(t.shape): torch.randn(t.shape, generator=torch.Generator()
                                         .manual_seed(i))
             for i, (n, t) in enumerate(params.items()) if n.endswith("_mu")}
    draw = VC._normal_like
    steps = {}
    VC._normal_like = lambda t, generator: table[tuple(t.shape)].to(t.device)
    try:
        for dev in (DEVICE, "cpu"):
            opt = C.adamw(5e-2)
            p = {n: t.to(dev) for n, t in params.items()}
            step = C.make_elbo_step(cls_apply, opt, 1.0, 4, "Blundell")
            steps[dev] = step(p, opt.init(p), torch.from_numpy(x).to(dev),
                              torch.from_numpy(y).to(dev),
                              torch.Generator(device=dev), torch.tensor(2))
    finally:
        VC._normal_like = draw
    card, cpu = steps[DEVICE], steps["cpu"]
    worst = 0.0
    pairs = [(card[2], cpu[2]), (card[3], cpu[3])]
    pairs += [(card[0][n], cpu[0][n]) for n in params]
    pairs += [(card[1][m][n], cpu[1][m][n]) for m in ("mu", "nu")
              for n in params]
    for a, b in pairs:
        worst = max(worst, rel_err(a.cpu(), b)[1])
    log(f"[10] one make_elbo_step, card against CPU with the same draws: "
        f"worst relative error {worst:.3e} (tolerance {ELBO_REL:.0e})")
    if worst > ELBO_REL:
        raise AssertionError(f"make_elbo_step card vs CPU {worst:.3e}")
    return dict(accuracy=acc, seconds=train_s, first_loss=trainer.log.losses[0],
                last_loss=trainer.log.losses[-1], elbo_step_worst_rel=worst)


def sgld_family_on_card(params: dict) -> dict:
    """``sgld``, ``psgld`` (burn-in 10 of SGLD_STEPS, so across it) and
    ``param_noise_transform`` on the den net's parameter dict on the card,
    SGLD_STEPS steps each, the gradient that of 0.5 |p|^2 (for
    ``param_noise_transform``, which adds to an update, SGD's update -lr p):
    everything finite. The same three noise-free (no Langevin noise; burn-in past the
    run; sigma 0) on the card and on the CPU: equal within SGLD_RTOL."""
    import torch
    from mfvi_dip_mia_tpu_torch.optim import sgld as S
    from mfvi_dip_mia_tpu_torch.optim.transform import apply_updates

    def run(transform, dev, scale):
        p = {n: t.to(dev) for n, t in params.items()}
        state = transform.init(p)
        for _ in range(SGLD_STEPS):
            upd, state = transform.update({n: scale * t for n, t in
                                           p.items()}, state, p)
            p = apply_updates(p, upd)
        return p

    sched = S.exponential_decay_floored(1e-3, 0.99)
    noisy = {"sgld": S.sgld(1e-3, weight_decay=1e-4, seed=1),
             "psgld": S.psgld(1e-3, num_burn_in_steps=10, seed=2),
             "param_noise": S.param_noise_transform(2.0, sched, seed=3)}
    quiet = {"sgld": lambda: S.sgld(1e-3, weight_decay=1e-4, addnoise=False),
             "psgld": lambda: S.psgld(1e-3, num_burn_in_steps=100),
             "param_noise": lambda: S.param_noise_transform(0.0, sched)}
    out = {}
    for name, tr in noisy.items():
        scale = -1e-3 if name == "param_noise" else 1.0
        p = run(tr, DEVICE, scale)
        moved = max(float((p[n] - params[n].to(DEVICE)).abs().max())
                    for n in params)
        if not all(bool(torch.isfinite(t).all()) for t in p.values()):
            raise AssertionError(f"{name} on the card: not finite")
        card = run(quiet[name](), DEVICE, scale)
        cpu = run(quiet[name](), "cpu", scale)
        worst = max(float(((card[n].cpu() - cpu[n]).abs()
                           / (cpu[n].abs() + 1e-30)).max()) for n in params)
        log(f"[10] {name}: {SGLD_STEPS} steps on the den net's "
            f"{sum(t.numel() for t in params.values()):,} parameters, finite "
            f"(largest move {moved:.3e}); noise-free card vs CPU worst "
            f"relative {worst:.3e}")
        if worst > SGLD_RTOL:
            raise AssertionError(f"{name} noise-free card vs CPU {worst:.3e}")
        out[name] = dict(largest_move=moved, noise_free_worst_rel=worst)
    return out


def prune_on_card(params: dict) -> dict:
    """``prune_mask_by_snr(amount=0.3)`` on the lanczos2 fit's final
    parameters on the card: the mask's zero share within one weight of
    30 %."""
    import torch
    from mfvi_dip_mia_tpu_torch.bayes.uncertainty import prune_mask_by_snr
    p = {n: torch.as_tensor(v, device=DEVICE) for n, v in params.items()}
    masks = prune_mask_by_snr(p, 0.3)
    n = sum(m.numel() for m in masks.values())
    zeros = sum(int((m == 0).sum()) for m in masks.values())
    log(f"[10] prune_mask_by_snr(0.3): {len(masks)} kernels, {zeros:,} of "
        f"{n:,} weights zeroed ({zeros / n:.6f})")
    if abs(zeros - 0.3 * n) > 1:
        raise AssertionError(f"{zeros} of {n} zeroed, not 30 %")
    return dict(kernels=len(masks), weights=n, zeroed=zeros)


def trace_on_card(fitted: dict, tmp: str) -> dict:
    """``profiling.trace`` around a TRACE_ITERS-iteration lanczos2 graph fit
    (every iteration a replay): a non-empty Chrome trace with device
    kernels."""
    import json as _json
    from mfvi_dip_mia_tpu_torch.tasks.trainer import fit
    from mfvi_dip_mia_tpu_torch.utils import profiling
    kw = dict(fitted["kw"], num_iter=TRACE_ITERS - 1, show_every=TRACE_ITERS)
    logdir = os.path.join(tmp, "trace")
    with profiling.trace(logdir):
        res = fit(fitted["problem"], fitted["method"], **kw)
    hold_replays("the traced fit", res)
    path = os.path.join(logdir, profiling.TRACE_FILE)
    size = os.path.getsize(path)
    with open(path) as f:
        events = _json.load(f)["traceEvents"]
    kernels_seen = sum(1 for e in events if e.get("cat") == "kernel")
    log(f"[10] profiling.trace around {res.replays} replays: {size:,} bytes, "
        f"{len(events):,} events, {kernels_seen:,} device kernels")
    if not size or not events:
        raise AssertionError("profiling.trace wrote an empty trace")
    return dict(bytes=size, events=len(events), kernel_events=kernels_seen,
                replays=res.replays)


def lib_phase() -> dict:
    """Phase 10: the pooled den fits, the conv kernels' device time at the
    pooled sites, Gaussian dropout, the classification trainer, the SGLD
    family, SNR pruning and ``profiling.trace``, each part timed by
    ``profiling.PhaseTimer``; the trace goes to a temporary directory,
    removed after. Returns the phase's results, with "launches" those of
    the three pooled graph fits and of the Gaussian-dropout calls."""
    import shutil
    import tempfile
    from mfvi_dip_mia_tpu_torch.ops import kernels
    from mfvi_dip_mia_tpu_torch.tasks.trainer import Method, init_params
    from mfvi_dip_mia_tpu_torch.utils.profiling import PhaseTimer

    t0 = time.perf_counter()
    timer = PhaseTimer()
    out = {}
    with timer.phase("pooled fits", sync=True):
        fits = pooled_fits()
    with timer.phase("pooled site times", sync=True):
        out["site_times"] = pooled_site_times(fits["lanczos2"]["problem"].net)
    with timer.phase("gaussian dropout", sync=True):
        out["gaussian_dropout"] = gaussian_dropout_on_card()
    with timer.phase("classification", sync=True):
        out["classification"] = classification_on_card()
    with timer.phase("sgld family", sync=True):
        den_params = init_params(fits["lanczos2"]["problem"], Method("mfvi"),
                                 1)
        out["sgld"] = sgld_family_on_card(den_params)
    with timer.phase("prune", sync=True):
        out["prune"] = prune_on_card(fits["lanczos2"]["result"].params)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lib_")
    try:
        with timer.phase("trace", sync=True):
            out["trace"] = trace_on_card(fits["lanczos2"], tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = {
        k.name: sum(f["launches"][k.name] for f in fits.values())
        + out["gaussian_dropout"]["launches"][k.name]
        for k in kernels.KERNELS}
    for f in fits.values():
        for key in ("result", "problem", "method", "kw"):
            f.pop(key)
    out["fits"] = fits
    out["timer"] = timer.summary()
    out["seconds"] = time.perf_counter() - t0
    log("[10] parts: " + ", ".join(f"{k} {v['total_s']:.1f} s"
                                   for k, v in out["timer"].items()))
    log(f"[10] phase 10 took {out['seconds']:.1f} s")
    return out


# -- phase 11: parallel/ on the card -------------------------------------------

PAR_ITERS = 300               # interleaved and one-program fits: 100 + 200
PAR_SHOW = 100
PAR_K = 3                     # bo_mfvi_den.json's first three candidates
DIST_ITERS = 100              # the two-process round's fits
DIST_TIMEOUT = 300            # seconds for each child process
# a child of the two-process round: cli.main with the arguments after the
# output path, then its (X, Y) as JSON into that path
DIST_CHILD = ("import json, sys\n"
              "from mfvi_dip_mia_tpu_torch import cli\n"
              "X, Y = cli.main(sys.argv[2:])\n"
              "with open(sys.argv[1], 'w') as f:\n"
              "    json.dump(dict(X=[[float(v) for v in x] for x in X],\n"
              "                   Y=[float(y) for y in Y]), f)\n")


def den_candidates(k: int = PAR_K) -> tuple:
    """(grid, Methods) of configs/bo_mfvi_den.json's first ``k``
    candidates (the runners' Method for each)."""
    from mfvi_dip_mia_tpu_torch.parallel.fanout import candidate_kwargs
    from mfvi_dip_mia_tpu_torch.tasks.runners import method_for
    from mfvi_dip_mia_tpu_torch.utils.config import load_config
    cfg = load_config(os.path.join(REPO, "configs", "bo_mfvi_den.json"))
    grid = list(itertools.product(
        *[v.candidates for v in cfg.bo_params.values()]))[:k]
    return grid, [method_for("den", "mfvi", candidate_kwargs("mfvi", c))
                  for c in grid]


def _named(taken: tuple) -> dict:
    from mfvi_dip_mia_tpu_torch.ops import kernels
    return {k.name: n for k, n in zip(kernels.KERNELS, taken)}


def interleaved_on_card(problem, methods) -> dict:
    """The PAR_K den/MFVI fits (PAR_ITERS iterations, graph) one after
    another through ``fit``, then together through ``fit_interleaved``
    (K = PAR_K), then ``fit_interleaved`` of the first alone (K = 1, two
    chunks): each interleaved fit must give its sequential fit's bits
    (rows and parameters), replay every iteration, and launch den/MFVI's
    kernels per step (each fit's captured variants, and the counters over
    all). Logs the summed it/s (last PAR_ITERS - PAR_SHOW) beside one
    sequential fit's, and the peak allocated MiB of K = 1 and K = PAR_K."""
    import numpy as np
    import torch
    import mfvi_dip_mia_tpu_torch.tasks.trainer as T
    from mfvi_dip_mia_tpu_torch.ops import kernels

    kw = dict(num_iter=PAR_ITERS - 1, lr=1e-3, seed=1, show_every=PAR_SHOW,
              device=DEVICE)
    seq = [T.fit(problem, m, collect_snapshots=False, **kw) for m in methods]
    captured = []
    capture_step = T.capture_step

    def watched(*a, **k):
        graphs = capture_step(*a, **k)
        captured.append({wm: _named(l) for wm, (_, l) in graphs.items()})
        return graphs

    def peak_run(ms, **over):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        res = T.fit_interleaved(problem, ms, **dict(kw, **over))
        launches = {k.name: k.launches for k in kernels.KERNELS}
        return res, launches, torch.cuda.max_memory_allocated() - base

    T.capture_step = watched
    try:
        res, launches, peak = peak_run(methods)
        one, _, peak1 = peak_run(methods[:1], num_iter=2 * PAR_SHOW - 1)
    finally:
        T.capture_step = capture_step
    equal = [same_bits(r, s) for r, s in zip(res, seq)]
    expected = STEP_LAUNCHES["5-scale"]
    per_fit = [hold_step_launches(f"interleaved fit {j}'s captured step",
                                  c[with_metrics], 1, expected)
               for j, c in enumerate(captured[:len(methods)])
               for with_metrics in (False, True)]
    per_step = hold_step_launches(
        "the interleaved fits", launches, sum(steps_run(r) for r in res),
        expected)
    summed = sum(r.iters_per_sec for r in res)
    log(f"[11] fit_interleaved of {len(methods)} den/MFVI f32 {SIZE}^2 "
        f"candidates, {PAR_ITERS} it, graph: "
        + ("each fit equals its sequential fit bit for bit (rows and "
           "parameters)" if all(equal) else f"equal bits {equal}")
        + f"; summed {summed:.2f} it/s over the last {PAR_ITERS - PAR_SHOW}"
        f" (each {[round(r.iters_per_sec, 2) for r in res]}), one "
        f"sequential fit {seq[0].iters_per_sec:.2f} it/s; launches per step "
        f"of each fit { {k: v for k, v in per_fit[0].items() if v} } (as "
        "den/MFVI's, every fit and variant); "
        f"peak allocated K=1 {peak1 / 2 ** 20:.1f} MiB, K={len(methods)} "
        f"{peak / 2 ** 20:.1f} MiB")
    for r in res + one:
        hold_replays("an interleaved fit", r)
    if not all(equal) or not all(np.isfinite(r.final_psnr) for r in res):
        raise AssertionError("an interleaved fit differs from its "
                             "sequential fit")
    return dict(equal_bits=equal, iters_per_sec=[r.iters_per_sec for r in res],
                summed_iters_per_sec=summed,
                sequential_iters_per_sec=[s.iters_per_sec for s in seq],
                final_psnr=[r.final_psnr for r in res],
                launches=launches, launches_per_step=per_step,
                peak_allocated_bytes={1: peak1, len(methods): peak},
                compile_seconds=res[0].compile_seconds, sequential=seq)


def spmd_on_card(problem, methods, seq) -> dict:
    """``run_sweep_spmd`` of the same candidates on ``make_mesh(1,
    names=("cand",))``: each candidate's rows must equal its sequential
    fit's bit for bit, one replay launches PAR_K x den/MFVI's kernels, and
    the counters count them per replay. Logs the summed it/s of the chunks
    after the first, the capture seconds and the launches per replay."""
    import numpy as np
    import torch
    import mfvi_dip_mia_tpu_torch.parallel.sharding as S
    from mfvi_dip_mia_tpu_torch.ops import kernels

    captures, chunk_starts = [], []
    capture_steps, build_chunk = S.capture_steps, S.build_spmd_chunk

    def watched(fits):
        t0 = time.perf_counter()
        graphs = capture_steps(fits)
        torch.cuda.synchronize()
        captures.append((time.perf_counter() - t0,
                         {wm: _named(l) for wm, (_, l) in graphs.items()}))
        return graphs

    def timed_chunk(*a, **k):
        run = build_chunk(*a, **k)

        def wrapper(start, end):
            chunk_starts.append(time.perf_counter())
            return run(start, end)
        return wrapper

    S.capture_steps, S.build_spmd_chunk = watched, timed_chunk
    try:
        mesh = S.make_mesh(1, names=("cand",))
        kernels.reset_launches()
        finals, psnrs = S.run_sweep_spmd(problem, methods, lr=1e-3,
                                         num_iter=PAR_ITERS - 1, seed=1,
                                         show_every=PAR_SHOW, mesh=mesh)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        launches = {k.name: k.launches for k in kernels.KERNELS}
    finally:
        S.capture_steps, S.build_spmd_chunk = capture_steps, build_chunk
    equal = [bool(np.array_equal(psnrs[c], s.psnrs, equal_nan=True))
             and finals[c] == s.final_psnr for c, s in enumerate(seq)]
    expected = {k: len(methods) * n
                for k, n in STEP_LAUNCHES["5-scale"].items()}
    (capture_s, variants), = captures
    for with_metrics in (False, True):
        hold_step_launches("one replay of the one-program block",
                           variants[with_metrics], 1, expected)
    per_replay = hold_step_launches("the one-program sweep", launches,
                                    PAR_ITERS + 2, expected)
    summed = len(methods) * (PAR_ITERS - PAR_SHOW) / (t_end - chunk_starts[1])
    log(f"[11] run_sweep_spmd of the {len(methods)} candidates on a 1-card "
        f"'cand' mesh: "
        + ("each candidate's rows equal its sequential fit's bit for bit"
           if all(equal) else f"equal rows {equal}")
        + f"; summed {summed:.2f} it/s over the last "
        f"{PAR_ITERS - PAR_SHOW}; capture (warm-up included) "
        f"{capture_s:.2f} s; launches per replay "
        f"{ {k: v for k, v in per_replay.items() if v} }")
    if not all(equal):
        raise AssertionError("a one-program candidate differs from its "
                             "sequential fit")
    return dict(equal_rows=equal, summed_iters_per_sec=summed,
                capture_seconds=capture_s, launches=launches,
                launches_per_replay=per_replay, finals=finals)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def two_processes(tmp: str) -> dict:
    """One round of configs/bo_mfvi_ct.json (DIST_ITERS iterations a fit,
    plots off, its paths in ``tmp``) split over two processes that share the
    card: each child runs ``cli.main`` with ``--dist-coordinator
    127.0.0.1:PORT --dist-nproc 2 --dist-pid i`` (a gloo group) and writes
    its (X, Y). Raises unless both children exit 0, both (X, Y) are equal,
    they equal a one-process ``run_candidates`` of the round's candidates
    with its scores rounded to float32, rank 0 alone reports the round and
    ``bo_results_path`` holds its one fig_data file with that (X, Y). The
    children load the kernels phase 1 built."""
    import numpy as np
    from mfvi_dip_mia_tpu_torch.parallel import fanout

    with open(os.path.join(REPO, "configs", "bo_mfvi_ct.json")) as f:
        raw = json.load(f)
    bo_dir = os.path.join(tmp, "dist_bo")
    raw["run_params"].update(plot=False, save_path=os.path.join(tmp, "dl"),
                             bo_results_path=bo_dir)
    config = os.path.join(tmp, "bo_mfvi_ct.json")
    with open(config, "w") as f:
        json.dump(raw, f)
    port = _free_port()
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", DIST_CHILD, outs[r], "--task", "ct",
         "--bayes", "mfvi", "--config", config, "--rounds", "1",
         "--num-iter", str(DIST_ITERS), "--no-plot", "--dist-coordinator",
         f"127.0.0.1:{port}", "--dist-nproc", "2", "--dist-pid", str(r)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    logs, fails = [], []
    for r, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=DIST_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            fails.append(f"rank {r} timed out")
        logs.append(out.decode(errors="replace"))
        if p.returncode != 0:
            fails.append(f"rank {r} exited {p.returncode}:\n{logs[r][-3000:]}")
    wall = time.perf_counter() - t0
    if fails:
        raise AssertionError("the two-process round failed: "
                             + "\n".join(fails))
    got = []
    for o in outs:
        with open(o) as f:
            got.append(json.load(f))

    rp = dict(raw["run_params"], num_iter=DIST_ITERS,
              save_path=os.path.join(tmp, "one"))
    devices = rp.pop("devices")
    rp.pop("bo_results_path")
    grid = list(itertools.product(
        *[v["candidates"] for v in raw["bo_params"].values()]))
    t1 = time.perf_counter()
    with shipped_images():
        one_c, one_y = fanout.run_candidates("ct", "mfvi", grid, rp, devices)
    one_s = time.perf_counter() - t1
    one = dict(X=[[float(v) for v in c] for c in one_c],
               Y=[float(np.float32(y)) for y in one_y])
    fig = np.load(os.path.join(bo_dir, "0_fig_data.npz"))
    rank0_only = ("[bo] round 0 done" in logs[0]
                  and "[bo] round 0 done" not in logs[1]
                  and sorted(os.listdir(bo_dir)) == ["0_fig_data.npz"]
                  and fig["observed_Y"].tolist() == got[0]["Y"])
    log(f"[11] two processes on one card (gloo), one round of bo_mfvi_ct, "
        f"{DIST_ITERS} it a fit: {wall:.1f} s wall (process start "
        f"included); rank 0 (X, Y) {got[0]}; "
        + ("rank 1's equal" if got[0] == got[1] else f"rank 1's {got[1]}")
        + "; " + ("equal to" if got[0] == one else f"DIFFERENT from {one},")
        + f" one process's run_candidates ({one_s:.2f} s) rounded to "
        "float32; " + ("only rank 0 wrote" if rank0_only else
                       "rank 0 is NOT the only writer"))
    if not (got[0] == got[1] == one and rank0_only):
        raise AssertionError("the two-process round failed its checks")
    return dict(seconds=wall, X=got[0]["X"], Y=got[0]["Y"],
                one_process_seconds=one_s, ranks_equal=True)


def parallel_phase() -> dict:
    """Phase 11: fit_interleaved and run_sweep_spmd of bo_mfvi_den.json's
    first PAR_K candidates at bench.py's den widths, each candidate against
    its sequential fit, and a two-process bo_mfvi_ct round through the CLI;
    each part timed by ``profiling.PhaseTimer``, everything written in a
    temporary directory, removed after. Returns the phase's results, with
    "launches" those of the interleaved and one-program fits."""
    import shutil
    import tempfile
    from mfvi_dip_mia_tpu_torch.ops import kernels
    from mfvi_dip_mia_tpu_torch.utils.profiling import PhaseTimer

    t0 = time.perf_counter()
    timer = PhaseTimer()
    problem = den_tail_problem()
    grid, methods = den_candidates()
    out = {"candidates": [list(map(float, c)) for c in grid]}
    with timer.phase("interleaved", sync=True):
        out["interleaved"] = interleaved_on_card(problem, methods)
    seq = out["interleaved"].pop("sequential")
    with timer.phase("one program", sync=True):
        out["spmd"] = spmd_on_card(problem, methods, seq)
    del problem, seq
    tmp = tempfile.mkdtemp(prefix="chip_smoke_par_")
    try:
        with timer.phase("two processes", sync=True):
            out["two_processes"] = two_processes(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = {k.name: out["interleaved"]["launches"][k.name]
                       + out["spmd"]["launches"][k.name]
                       for k in kernels.KERNELS}
    out["timer"] = timer.summary()
    out["seconds"] = time.perf_counter() - t0
    log("[11] parts: " + ", ".join(f"{k} {v['total_s']:.1f} s"
                                   for k, v in out["timer"].items()))
    log(f"[11] phase 11 took {out['seconds']:.1f} s")
    return out


# -- phase 12: one fit split by rows over a one-card mesh (fit_sp) ------------

SP_SPLITS = (2, 4)            # shards of the den fits: 128 and 64 rows each
SP_ITERS = 300                # each den fit, split or not: 100 warm + 200
SP_SHOW = 100
SP_BITS_ITERS = 40            # two graph fits and an eager one, equal bits
SP_BITS_SHOW = 20
# A split fit against the unsplit fits of the same seed, over its first
# SP_PSNR_ITERS rows: the smoothed PSNR (the BO objective) within JAX's sp
# tolerance (tests/test_sharding.py:122-127) of the unsplit fit's (fused
# sites) and of the unsplit fit on the split's own route (every site on
# the unfused chain); the current iterate's two PSNRs within that
# tolerance plus the spread between the two unsplit routes, of the
# same-route fit's; the final smoothed PSNR within SP_FINAL_DB plus that
# final spread, of the same-route fit's. At 300 iterations the current
# iterate's PSNR swings by dB from one iteration to the next and the
# smoothed PSNR climbs ~0.05 dB an iteration, so another summation order
# alone moves them by 0.2-0.3 dB (PERF.md §6), while the smoothed
# rows of the first 80 iterations agree to about 1e-3 dB.
SP_PSNR_ITERS = 80
SP_RTOL, SP_ATOL_DB = 1e-3, 6e-2
SP_FINAL_DB = 0.1
SP_CT_SPLIT = 2               # CT/MFVI bf16: 2 shards, 100 iterations
SP_CT_ITERS = 100
SP_FANOUT_ITERS = 100         # each fanout fit
SP_FANOUT_DEVICES = 4         # 2 candidates, sp_split=True: 2 shards each
SP_FANOUT_DB = 0.1


def sp_step_launches(n_sp: int, task: str = "den") -> dict:
    """Launches per step of a fit split over ``n_sp`` shards (PERF.md §6):
    no site fuses, so each of the 5-scale net's 26 sites runs one
    cf_conv_fwd and one cf_conv_dw per shard, and one dx (cf_conv_fwd) per
    shard at the 24 sites whose input has a gradient (all but level 0's
    skip and down1, which read the net input); CT's banded Radon pair runs
    once, on the gathered output."""
    launches = dict(cf_conv_fwd=50 * n_sp, cf_conv_dw=26 * n_sp)
    if task == "ct":
        launches.update(radon_banded_fwd=1, radon_banded_adj=1)
    return launches


def sp_mesh(n_sp: int):
    from mfvi_dip_mia_tpu_torch.parallel.sharding import make_mesh
    return make_mesh(n_sp, names=("sp",), devices=["cuda:0"] * n_sp)


def _peak_fit(fn):
    """(fn(), the launches it counted, its peak allocated bytes above what
    was allocated before it)."""
    import torch
    from mfvi_dip_mia_tpu_torch.ops import kernels
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    res = fn()
    torch.cuda.synchronize()
    return (res, {k.name: k.launches for k in kernels.KERNELS},
            torch.cuda.max_memory_allocated() - base)


def sp_den_fits() -> dict:
    """den/MFVI f32 at bench.py's widths: the unsplit graph fit of SP_ITERS
    iterations, and the same with every site on the unfused chain (the
    route a split takes: ``fused_block.supported`` False for the fit), then
    for each of SP_SPLITS ``fit_sp`` on a mesh that names cuda:0 that many
    times: a graph fit of SP_ITERS (held to the unsplit fit as the
    constants above say, every iteration a replay, the launches per step
    exactly ``sp_step_launches`` in its captured step and over the fit; its
    it/s and peak allocated memory beside the unsplit fit's), then two
    graph fits and an eager one of SP_BITS_ITERS iterations with equal bits
    (rows and parameters), whose rows are also the long fit's first ones
    bit for bit; every cache of ``cache_state`` the same before and after
    each capture."""
    import numpy as np
    import mfvi_dip_mia_tpu_torch.tasks.trainer as T
    from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block
    from mfvi_dip_mia_tpu_torch.parallel.sharding import fit_sp

    problem = den_tail_problem()
    method = T.Method("mfvi", temp=5.66e-7, sigma=1.46e-5)
    kw = dict(num_iter=SP_ITERS - 1, lr=1e-3, seed=1, show_every=SP_SHOW,
              collect_snapshots=False)
    out, fits = {}, {}
    supported = fused_block.supported
    for label in ("unsplit", "unsplit unfused"):
        if label == "unsplit unfused":
            fused_block.supported = lambda x, k: False
        try:
            res, counted, peak = _peak_fit(
                lambda: T.fit(problem, method, device=DEVICE, **kw))
        finally:
            fused_block.supported = supported
        hold_replays(f"the {label} den fit", res)
        log(f"[12] den/MFVI f32 {SIZE}^2 {label}, {SP_ITERS} it, graph: "
            f"{res.iters_per_sec:.2f} it/s, peak allocated "
            f"{peak / 2 ** 20:.1f} MiB, final smoothed PSNR "
            f"{res.final_psnr:.4f} dB")
        fits[label] = res
        out[label] = dict(iters_per_sec=res.iters_per_sec,
                          peak_allocated_bytes=peak,
                          final_psnr=res.final_psnr, psnrs=res.psnrs.tolist(),
                          launches_per_step={k: n / steps_run(res)
                                             for k, n in counted.items()})
    ref, same_route = fits["unsplit"], fits["unsplit unfused"]
    head = slice(0, SP_PSNR_ITERS)

    def gaps(res, to) -> tuple:
        """(the smoothed column's, the current iterate's columns') largest
        gap to the fit ``to`` over ``head``, and the final's."""
        d = np.abs(res.psnrs[head] - to.psnrs[head])
        return (float(d[:, 2].max()), float(d[:, :2].max()),
                res.final_psnr - to.final_psnr)

    spread_smoothed, spread, spread_final = gaps(same_route, ref)
    spread_final = abs(spread_final)
    tol = SP_ATOL_DB + SP_RTOL * float(np.abs(ref.psnrs[head]).max())
    log(f"[12] the two unsplit routes' spread over the first "
        f"{SP_PSNR_ITERS} rows: current iterate {spread:.4f} dB, smoothed "
        f"{spread_smoothed:.4f} dB; final {spread_final:.4f} dB")
    out["spread"] = dict(current=spread, smoothed=spread_smoothed,
                         final=spread_final)
    ref_peak = out["unsplit"]["peak_allocated_bytes"]
    captured, kept = [], []
    capture_step, capture_variant = T.capture_step, T.capture_variant

    def watched_step(*a, **k):
        graphs = capture_step(*a, **k)
        captured.append({wm: _named(l) for wm, (_, l) in graphs.items()})
        return graphs

    def watched_variant(*a, **k):
        before = cache_state()
        graph = capture_variant(*a, **k)
        kept.append(before == cache_state())
        return graph

    T.capture_step, T.capture_variant = watched_step, watched_variant
    launches, failed = {}, []
    try:
        for n_sp in SP_SPLITS:
            mesh = sp_mesh(n_sp)
            expected = sp_step_launches(n_sp)
            captured.clear()
            res, counted, peak = _peak_fit(
                lambda: fit_sp(problem, method, mesh=mesh, **kw))
            for name, n in counted.items():
                launches[name] = launches.get(name, 0) + n
            hold_replays(f"the {n_sp}-shard den fit", res)
            for with_metrics in (False, True):
                hold_step_launches(f"the {n_sp}-shard den fit's captured "
                                   "step", captured[0][with_metrics], 1,
                                   expected)
            per_step = hold_step_launches(f"the {n_sp}-shard den fit",
                                          counted, steps_run(res), expected)
            smoothed, current_fused, final_gap = gaps(res, ref)
            smoothed_route, current, final_route = gaps(res, same_route)
            close = [max(smoothed, smoothed_route) <= tol,
                     current <= tol + spread,
                     abs(final_route) <= SP_FINAL_DB + spread_final]
            bits_kw = dict(kw, num_iter=SP_BITS_ITERS - 1,
                           show_every=SP_BITS_SHOW)
            graphs = [fit_sp(problem, method, mesh=mesh, **bits_kw)
                      for _ in range(2)]
            eager = fit_sp(problem, method, mesh=mesh, eager=True, **bits_kw)
            equal = [same_bits(graphs[0], graphs[1]),
                     same_bits(graphs[0], eager),
                     bool(np.array_equal(res.psnrs[:SP_BITS_ITERS],
                                         graphs[0].psnrs))]
            for g in graphs:
                hold_replays(f"a {n_sp}-shard den fit", g)
            if eager.replays:
                raise AssertionError("an eager split fit replayed a graph")
            log(f"[12] fit_sp den/MFVI f32 over {n_sp} shards of "
                f"{SIZE // n_sp} rows on cuda:0, {SP_ITERS} it, graph: "
                f"{res.iters_per_sec:.2f} it/s (unsplit "
                f"{ref.iters_per_sec:.2f}), peak allocated "
                f"{peak / 2 ** 20:.1f} MiB (unsplit "
                f"{ref_peak / 2 ** 20:.1f}); launches per step "
                f"{ {k: v for k, v in per_step.items() if v} } (as "
                f"predicted); over the first {SP_PSNR_ITERS} rows the "
                f"smoothed PSNR within {smoothed:.4f} dB of the unsplit "
                f"fit's and {smoothed_route:.4f} of the same-route fit's "
                f"(limit {tol:.4f}), the current iterate's within "
                f"{current:.4f} dB of the same-route fit's (limit "
                f"{tol + spread:.4f}; of the unsplit fit's "
                f"{current_fused:.4f}); final smoothed PSNR "
                f"{res.final_psnr:.4f} dB, {final_route:+.4f} dB from the "
                f"same-route fit's (limit {SP_FINAL_DB + spread_final:.4f}),"
                f" {final_gap:+.4f} from the unsplit fit's; "
                f"{SP_BITS_ITERS}-it fits: two "
                "graph fits " + ("equal" if equal[0] else "DIFFERENT")
                + ", the eager fit " + ("equal" if equal[1] else "DIFFERENT")
                + ", the long fit's first rows "
                + ("equal" if equal[2] else "DIFFERENT")
                + f" (eager {eager.iters_per_sec:.2f} it/s over the last "
                f"{SP_BITS_ITERS - SP_BITS_SHOW}); caches unchanged by "
                f"{sum(kept)} of {len(kept)} captures so far")
            out[n_sp] = dict(
                iters_per_sec=res.iters_per_sec, peak_allocated_bytes=peak,
                launches_per_step=per_step, smoothed_gap=smoothed,
                smoothed_gap_route=smoothed_route, current_gap=current,
                current_gap_fused=current_fused, final_psnr=res.final_psnr,
                final_gap=final_gap, final_gap_route=final_route,
                within=close, equal_bits=equal,
                eager_iters_per_sec=eager.iters_per_sec,
                compile_seconds=res.compile_seconds,
                psnrs=res.psnrs.tolist())
            if not (all(close) and all(equal) and all(kept)
                    and np.isfinite(res.final_psnr)):
                failed.append(n_sp)
    finally:
        T.capture_step, T.capture_variant = capture_step, capture_variant
    out["launches"] = launches
    if failed:
        raise AssertionError(f"the den fits split {failed} ways failed their "
                             "checks")
    return out


def sp_ct_fit() -> dict:
    """CT/MFVI bf16 (bench.py's CT configuration, metric rows every
    iteration) over SP_CT_SPLIT shards for SP_CT_ITERS iterations, graph:
    finite, the final smoothed PSNR above iteration 0's, the launches per
    step exactly ``sp_step_launches(SP_CT_SPLIT, "ct")``; its gap to the
    unsplit fit's final PSNR logged."""
    import numpy as np
    import mfvi_dip_mia_tpu_torch.tasks.problems as P
    import mfvi_dip_mia_tpu_torch.tasks.trainer as T
    from mfvi_dip_mia_tpu_torch.parallel.sharding import fit_sp

    use_bench_images()
    problem = P.build_problem("ct", "mfvi", 0, input_depth=16, device=DEVICE)
    method = T.Method("mfvi", temp=2.2e-10, sigma=1.7e-7)
    kw = dict(num_iter=SP_CT_ITERS - 1, lr=1e-3, seed=1, show_every=50,
              compute_dtype="bf16", collect_snapshots=False)
    ref = T.fit(problem, method, device=DEVICE, **kw)
    res, launches, peak = _peak_fit(
        lambda: fit_sp(problem, method, mesh=sp_mesh(SP_CT_SPLIT), **kw))
    hold_replays("the split CT fit", res)
    per_step = hold_step_launches("the split CT fit", launches,
                                  steps_run(res),
                                  sp_step_launches(SP_CT_SPLIT, "ct"))
    learned = bool(np.isfinite(res.psnrs).all()
                   and res.final_psnr > res.psnrs[0, 2])
    log(f"[12] fit_sp CT/MFVI bf16 over {SP_CT_SPLIT} shards, "
        f"{SP_CT_ITERS} it, graph: {res.iters_per_sec:.2f} it/s (unsplit "
        f"{ref.iters_per_sec:.2f}); final smoothed PSNR "
        f"{res.final_psnr:.4f} dB (iteration 0 {res.psnrs[0, 2]:.4f}), "
        f"{res.final_psnr - ref.final_psnr:+.4f} dB from the unsplit fit's; "
        f"launches per step {({k: v for k, v in per_step.items() if v})}; "
        f"peak allocated {peak / 2 ** 20:.1f} MiB")
    if not learned:
        raise AssertionError("the split CT fit did not learn")
    return dict(iters_per_sec=res.iters_per_sec,
                unsplit_iters_per_sec=ref.iters_per_sec,
                final_psnr=res.final_psnr, psnr0=float(res.psnrs[0, 2]),
                final_gap=res.final_psnr - ref.final_psnr,
                launches_per_step=per_step, launches=launches,
                peak_allocated_bytes=peak)


def sp_fanout() -> dict:
    """bo_mfvi_den.json's first two candidates through ``run_candidates(
    ..., devices=["cuda:0"] * SP_FANOUT_DEVICES, sp_split=True)`` (each fit
    split over its own sub-mesh of 2 entries, SP_FANOUT_ITERS iterations),
    against the plain route (``devices=["cuda:0"], interleave=False``:
    ``run_task`` each) and against each candidate's unsplit ``fit`` of the
    route's own problem and seed: both within SP_FANOUT_DB."""
    import numpy as np
    import mfvi_dip_mia_tpu_torch.parallel.sharding as S
    import mfvi_dip_mia_tpu_torch.tasks.problems as P
    import mfvi_dip_mia_tpu_torch.tasks.trainer as T
    from mfvi_dip_mia_tpu_torch.parallel import fanout

    use_bench_images()
    grid, methods = den_candidates()
    grid, methods = grid[:2], methods[:2]
    rp = dict(img=0, num_iter=SP_FANOUT_ITERS, lr=1e-3, seed=1,
              show_every=50, input_depth=16, plot=False, save=False)
    meshes = []
    fit_sp = S.fit_sp

    def watched(problem, method, *, mesh, **kw):
        meshes.append(mesh.shape)
        return fit_sp(problem, method, mesh=mesh, **kw)

    S.fit_sp = watched
    try:
        t0 = time.perf_counter()
        failures = []
        kept, y_sp = fanout.run_candidates(
            "den", "mfvi", grid, rp, ["cuda:0"] * SP_FANOUT_DEVICES,
            sp_split=True, failures=failures)
        sp_s = time.perf_counter() - t0
    finally:
        S.fit_sp = fit_sp
    t0 = time.perf_counter()
    _, y_plain = fanout.run_candidates("den", "mfvi", grid, rp, ["cuda:0"],
                                       interleave=False)
    plain_s = time.perf_counter() - t0
    problem = P.build_problem("den", "mfvi", 0, input_depth=16,
                              device=DEVICE)
    y_fit = [T.fit(problem, m, num_iter=SP_FANOUT_ITERS, lr=1e-3, seed=1,
                   show_every=50, device=DEVICE,
                   collect_snapshots=False).final_psnr for m in methods]
    gap_plain = np.abs(np.subtract(y_sp, y_plain)) if len(y_sp) == 2 else None
    gap_fit = np.abs(np.subtract(y_sp, y_fit)) if len(y_sp) == 2 else None
    log(f"[12] run_candidates(sp_split=True) of 2 den/MFVI candidates on "
        f"{SP_FANOUT_DEVICES} entries of cuda:0, {SP_FANOUT_ITERS} it a "
        f"fit: sub-meshes {meshes}, scores {y_sp} ({sp_s:.1f} s); the plain "
        f"route's {y_plain} ({plain_s:.1f} s), gap {gap_plain}; the "
        f"unsplit fits' {y_fit}, gap {gap_fit}; failures {failures}")
    if (failures or meshes != [{"sp": 2}] * 2 or gap_plain is None
            or gap_plain.max() > SP_FANOUT_DB or gap_fit.max() > SP_FANOUT_DB):
        raise AssertionError("the sp_split fanout failed its checks")
    return dict(scores=y_sp, plain_scores=y_plain, fit_scores=y_fit,
                seconds=sp_s, plain_seconds=plain_s)


def sp_phase() -> dict:
    """Phase 12: the row split of one fit (``fit_sp``) on meshes that name
    cuda:0 2 and 4 times at bench.py's widths, den/MFVI f32 and CT/MFVI
    bf16, and the fanout's ``sp_split`` route; each part timed by
    ``PhaseTimer``. Returns the phase's results, with "launches" those of
    the split den and CT fits (their warm-up steps included)."""
    from mfvi_dip_mia_tpu_torch.ops import kernels
    from mfvi_dip_mia_tpu_torch.utils.profiling import PhaseTimer

    t0 = time.perf_counter()
    timer = PhaseTimer()
    out = {}
    with timer.phase("den split fits", sync=True):
        out["den"] = sp_den_fits()
    with timer.phase("ct split fit", sync=True):
        out["ct"] = sp_ct_fit()
    with timer.phase("fanout", sync=True):
        out["fanout"] = sp_fanout()
    out["launches"] = {k.name: out["den"]["launches"].get(k.name, 0)
                       + out["ct"]["launches"][k.name]
                       for k in kernels.KERNELS}
    out["timer"] = timer.summary()
    out["seconds"] = time.perf_counter() - t0
    log("[12] parts: " + ", ".join(f"{k} {v['total_s']:.1f} s"
                                   for k, v in out["timer"].items()))
    log(f"[12] phase 12 took {out['seconds']:.1f} s")
    return out


# -- phase 13: the fanout's threads on one card -------------------------------

THREAD_ITERS = 300            # each fit: 100 warm + 200
THREAD_SHOW = 100
THREAD_DIP = 3                # route (a): dip den candidates, a thread each
THREAD_K = 4                  # route (b): bo_mfvi_den.json's four candidates
THREAD_SP = 2                 # route (c): 2 candidates, sp_split=2 each


class FitRecorder:
    """Records, while installed, every fit the runners and ``fit_sp``
    return (the candidate's Method, its FitResult, the thread and stream it
    ran on, its start and end on the host clock) and every warm-up and
    capture (``trainer.capture_steps``: start, end)."""

    def __init__(self):
        self.fits, self.captures = [], []
        self._lock = threading.Lock()

    def clear(self):
        self.fits, self.captures = [], []

    @contextlib.contextmanager
    def installed(self):
        import torch
        import mfvi_dip_mia_tpu_torch.tasks.runners as R
        import mfvi_dip_mia_tpu_torch.tasks.trainer as T
        saved = dict(fit=(R.fit, T.fit), fit_interleaved=R.fit_interleaved,
                     capture_steps=T.capture_steps)
        fit, fit_interleaved = saved["fit"][1], saved["fit_interleaved"]
        capture_steps = saved["capture_steps"]

        def note(methods, results, t0):
            t1 = time.perf_counter()
            stream = torch.cuda.current_stream().cuda_stream
            with self._lock:
                for m, r in zip(methods, results):
                    self.fits.append(dict(
                        method=m, result=r, thread=threading.get_ident(),
                        stream=stream, start=t0, end=t1))

        def one(problem, method, **kw):
            t0 = time.perf_counter()
            res = fit(problem, method, **kw)
            note([method], [res], t0)
            return res

        def several(problem, methods, **kw):
            t0 = time.perf_counter()
            results = fit_interleaved(problem, methods, **kw)
            note(methods, results, t0)
            return results

        def captured(fits, **kw):
            t0 = time.perf_counter()
            graphs = capture_steps(fits, **kw)
            with self._lock:
                self.captures.append((t0, time.perf_counter()))
            return graphs

        R.fit, T.fit, R.fit_interleaved = one, one, several
        T.capture_steps = captured
        try:
            yield self
        finally:
            R.fit, T.fit = saved["fit"]
            R.fit_interleaved = saved["fit_interleaved"]
            T.capture_steps = saved["capture_steps"]


def _key(method) -> tuple:
    return (method.name, method.temp, method.sigma)


def _round(rec: FitRecorder, run) -> dict:
    """``run()`` (a round of candidates) with the launch counters zeroed
    just before it and read just after, the peak allocated bytes above
    those allocated before it, its wall seconds (the card synchronized)
    and the fits it recorded."""
    import torch
    from mfvi_dip_mia_tpu_torch.ops import kernels
    rec.clear()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    scores = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels.KERNELS}
    fits = list(rec.fits)
    iters = sum(f["result"].executed for f in fits)
    return dict(scores=[float(y) for y in scores], wall_seconds=wall,
                launches=launches,
                launches_per_fit={k: n / len(fits)
                                  for k, n in launches.items()},
                peak_allocated_bytes=torch.cuda.max_memory_allocated() - base,
                iters_per_sec=[f["result"].iters_per_sec for f in fits],
                summed_iters_per_sec=sum(f["result"].iters_per_sec
                                         for f in fits),
                round_iters_per_sec=iters / wall,
                capture_seconds=sum(b - a for a, b in rec.captures),
                captures=len(rec.captures),
                captured_by=max((b for _, b in rec.captures), default=t0) - t0,
                threads=len({f["thread"] for f in fits}),
                streams=len({f["stream"] for f in fits}),
                overlap=(max(f["start"] for f in fits)
                         < min(f["end"] for f in fits)),
                fits=fits)


def _hold_route(label: str, seq: dict, thr: dict, workers: int,
                fits: int) -> dict:
    """The threaded round ``thr`` against the sequential round ``seq`` of
    the same candidates: equal scores, every candidate's fits bit-equal
    (rows and parameters), every iteration a replay, the same launches,
    ``workers`` threads, none the main thread, on as many streams, whose
    fits overlapped in time. Logs both rounds; returns their numbers."""
    ok = {"scores": seq["scores"] == thr["scores"]
          and all(y == y for y in thr["scores"]),
          "fits": len(seq["fits"]) == len(thr["fits"]) == fits}
    by_key = {}
    for f in seq["fits"]:
        by_key.setdefault(_key(f["method"]), []).append(f["result"])
    ok["bits"] = all(any(same_bits(f["result"], r)
                         for r in by_key.get(_key(f["method"]), []))
                     for f in thr["fits"])
    for f in seq["fits"] + thr["fits"]:
        hold_replays(f"{label}'s fit", f["result"])
    ok["launches"] = seq["launches"] == thr["launches"]
    ok["threads"] = (thr["threads"] == thr["streams"] == workers
                     and threading.get_ident() not in
                     {f["thread"] for f in thr["fits"]})
    ok["overlap"] = thr["overlap"]
    per_fit = {k: v for k, v in thr["launches_per_fit"].items() if v}
    log(f"[13] {label}: sequential {seq['wall_seconds']:.2f} s, threaded "
        f"{thr['wall_seconds']:.2f} s ({thr['threads']} threads on "
        f"{thr['streams']} streams, fits overlapping: {thr['overlap']}); "
        f"graph it/s one fit at a time "
        f"{[round(v, 2) for v in seq['iters_per_sec']]}, threaded summed "
        f"{thr['summed_iters_per_sec']:.2f} "
        f"({[round(v, 2) for v in thr['iters_per_sec']]}); round it/s "
        f"{seq['round_iters_per_sec']:.2f} / "
        f"{thr['round_iters_per_sec']:.2f}; capture seconds "
        f"{seq['capture_seconds']:.2f} / {thr['capture_seconds']:.2f} "
        f"({thr['captures']} captures, the last done "
        f"{seq['captured_by']:.2f} / {thr['captured_by']:.2f} s into the "
        f"round); peak allocated {seq['peak_allocated_bytes'] / 2 ** 20:.1f}"
        f" / {thr['peak_allocated_bytes'] / 2 ** 20:.1f} MiB; launches per "
        f"fit {per_fit}; checks {ok}")
    if not all(ok.values()):
        raise AssertionError(f"{label}: the threaded round failed {ok}")
    out = {}
    for name, r in (("sequential", seq), ("threaded", thr)):
        out[name] = {k: v for k, v in r.items() if k != "fits"}
    out["checks"] = ok
    return out


def threads_phase() -> dict:
    """Phase 13: ``run_candidates``' threads on cuda:0 at bench.py's den
    widths (256^2, input depth 16, f32, lr 1e-3, seed 1, THREAD_ITERS
    iterations a fit, plots and saves off), each route's round once
    threaded and once one candidate after another in this thread: (a)
    THREAD_DIP dip candidates on ``["cuda:0"]`` (a thread per candidate,
    ``run_task``); (b) configs/bo_mfvi_den.json's THREAD_K candidates on
    ``["cuda:0", "cuda:0"]`` (a thread per interleaved group of 2) and with
    ``interleave=False`` (a thread per candidate, ``run_task`` with its MC
    summary); (c) THREAD_SP of them with ``sp_split=2`` over ``["cuda:0"]
    * 4`` (a thread per candidate, ``fit_sp`` over 2 shards). Every
    candidate's score and fit equal its sequential run's bit for bit and
    the launches equal the sequential round's (``_hold_route``). Returns
    each route's numbers, and "launches" the threaded rounds'."""
    import mfvi_dip_mia_tpu_torch.tasks.problems as P
    import mfvi_dip_mia_tpu_torch.tasks.runners as R
    from mfvi_dip_mia_tpu_torch.ops import kernels
    from mfvi_dip_mia_tpu_torch.parallel import fanout
    from mfvi_dip_mia_tpu_torch.parallel.sharding import fit_sp, make_mesh
    from mfvi_dip_mia_tpu_torch.utils.profiling import PhaseTimer

    t0 = time.perf_counter()
    timer = PhaseTimer()
    use_bench_images()
    rp = dict(img=0, num_iter=THREAD_ITERS - 1, lr=1e-3, seed=1,
              show_every=THREAD_SHOW, input_depth=16, plot=False,
              save=False)
    grid, methods = den_candidates(THREAD_K)
    rec = FitRecorder()
    out = {"candidates": [list(map(float, c)) for c in grid]}

    def scores(kept):
        return kept[1]

    def interleaved_sequential():
        ys = [None] * THREAD_K
        for g in range(2):
            idx = range(g, THREAD_K, 2)
            for i, y in zip(idx, R.run_group_interleaved(
                    "den", "mfvi", [grid[i] for i in idx], device=DEVICE,
                    **rp)):
                ys[i] = y
        return ys

    def sp_sequential():
        # _run_candidates_sp's problem and fits, one after another
        problem = P.build_problem("den", "mfvi", 0, input_depth=16,
                                  device="cuda:0")
        mesh = make_mesh(2, names=("sp",), devices=["cuda:0"] * 2)
        return [fit_sp(problem, m, mesh=mesh, num_iter=rp["num_iter"],
                       lr=rp["lr"], seed=rp["seed"], collect_snapshots=False,
                       show_every=THREAD_SHOW).final_psnr
                for m in methods[:THREAD_SP]]

    routes = (
        ("(a) dip, a thread per candidate", THREAD_DIP, THREAD_DIP,
         lambda: [R.run_task("den", "dip", index=i, device=DEVICE, **rp)
                  for i in range(THREAD_DIP)],
         lambda: scores(fanout.run_candidates(
             "den", "dip", [()] * THREAD_DIP, rp, ["cuda:0"],
             keep_nan=True))),
        ("(b) mfvi, a thread per interleaved group", 2, THREAD_K,
         interleaved_sequential,
         lambda: scores(fanout.run_candidates(
             "den", "mfvi", grid, rp, ["cuda:0", "cuda:0"],
             keep_nan=True))),
        ("(b) mfvi, a thread per candidate", THREAD_K, THREAD_K,
         lambda: [R.run_task("den", "mfvi", index=i, device=DEVICE,
                             **fanout.candidate_kwargs("mfvi", c), **rp)
                  for i, c in enumerate(grid)],
         lambda: scores(fanout.run_candidates(
             "den", "mfvi", grid, rp, ["cuda:0"], interleave=False,
             keep_nan=True))),
        ("(c) mfvi sp_split=2, a thread per candidate", THREAD_SP,
         THREAD_SP, sp_sequential,
         lambda: scores(fanout.run_candidates(
             "den", "mfvi", grid[:THREAD_SP], rp, ["cuda:0"] * 4,
             sp_split=2, keep_nan=True))),
    )
    launches = {k.name: 0 for k in kernels.KERNELS}
    with rec.installed():
        for label, workers, n_fits, sequential, threaded in routes:
            with timer.phase(label, sync=True):
                seq = _round(rec, sequential)
                thr = _round(rec, threaded)
                out[label] = _hold_route(label, seq, thr, workers, n_fits)
            for k, n in thr["launches"].items():
                launches[k] += n
    out["launches"] = launches
    out["timer"] = timer.summary()
    out["seconds"] = time.perf_counter() - t0
    log(f"[13] phase 13 took {out['seconds']:.1f} s")
    return out


# -- phase 14: the cand x mc sharded step and the dry run on one card --------

SHARD_SHAPE = (2, 2)          # (cand, mc): bo_mfvi_den.json's first two
SHARD_SAMPLES = 2             # candidates, S = 2 samples, one an mc entry
SHARD_STEPS = 20              # graph steps, and as many eager ones
DRYRUN_ENTRIES = 8            # dryrun_multichip(8): cuda:0 named 8 times


def shard_step_launches() -> dict:
    """Launches per sharded step: each of C x S samples runs the den fit
    step's forward and backward (STEP_LAUNCHES["5-scale"], PERF.md §6)."""
    n = SHARD_SHAPE[0] * SHARD_SAMPLES
    return {k: n * v for k, v in STEP_LAUNCHES["5-scale"].items()}


def shard_copies_per_step() -> int:
    """Copies between mesh entries a step: each candidate's n_mc - 1 packs
    into its lead's rows, then the mean back to those n_mc - 1 entries."""
    n_cand, n_mc = SHARD_SHAPE
    return 2 * n_cand * (n_mc - 1)


def _sweep_clone(state):
    from mfvi_dip_mia_tpu_torch.parallel.sharding import SweepState
    return SweepState(state.params.with_flat(state.params.flat.clone()),
                      tuple(t.clone() for t in state.opt_state),
                      state.out_avg.clone())


def _replicas_equal(step):
    """A device bool: every mc replica equal to its lead's bit for bit."""
    import torch
    same = [(a.view(torch.int32) == b.view(torch.int32)).all()
            for row in step.replicas for rep in row[1:]
            for a, b in zip(rep, row[0])]
    return torch.stack(same).all()


def _sharded_run(step, state, hp, gens, z) -> dict:
    """SHARD_STEPS calls of ``step`` from ``state``: each step's losses and
    replica check kept on the card, read after the last; the launch
    counters zeroed just before and read just after; the first call's
    seconds (a graph's warm-up and capture) and steps/s over the rest (the
    card synchronized); the peak allocated bytes above those allocated
    before."""
    import torch
    from mfvi_dip_mia_tpu_torch.ops import kernels
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, same = [], []
    t0 = time.perf_counter()
    for it in range(SHARD_STEPS):
        state, loss = step(state, hp, gens, z, it)
        losses.append(loss)
        same.append(_replicas_equal(step))
        if it == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return dict(state=state, losses=torch.stack(losses).cpu(),
                replicas_equal=bool(torch.stack(same).all()),
                launches={k.name: k.launches for k in kernels.KERNELS},
                first_call_seconds=t1 - t0,
                steps_per_sec=(SHARD_STEPS - 1) / (t2 - t1),
                peak_allocated_bytes=torch.cuda.max_memory_allocated() - base)


def sharded_step_against_cpu(problem, methods) -> dict:
    """One sharded step on the card (eager: the substituted draws are moved
    to the card as they are used) against the same step on the CPU's plain
    path, on a ``["cpu"] * 4`` mesh of the same shape: the same initial
    state, jitter off, each sample's RT draw from one table (drawn on the
    CPU, in call order). The losses, the first moments (0.1 x the mean
    gradient) and the EMA (the transformed mean output at iteration 0) at
    TOL_STEP."""
    import numpy as np
    import torch
    import mfvi_dip_mia_tpu_torch.bayes.vi as vi
    import mfvi_dip_mia_tpu_torch.parallel.sharding as S
    import mfvi_dip_mia_tpu_torch.tasks.trainer as T
    from mfvi_dip_mia_tpu_torch.tasks.problems import problem_on
    from mfvi_dip_mia_tpu_torch.utils.images import get_noise

    n_cand, n_mc = SHARD_SHAPE
    state0 = S.init_sweep_state(problem, "mfvi", n_cand, seed=1)
    gen = torch.Generator().manual_seed(11)
    draws = [torch.randn(state0.params.n_var, generator=gen)
             for _ in range(n_cand * SHARD_SAMPLES)]
    z = torch.from_numpy(get_noise(16, SIZE, rng=np.random.default_rng(1))
                         ).permute(0, 3, 1, 2).contiguous()
    hp = S.stack_hyperparams(methods, 1e-3)
    sample, calls = vi.sample_mfvi_tree, []

    def table(params, generator=None, out_dtype=None, eps=None):
        calls.append(len(calls))
        return sample(params, out_dtype=out_dtype,
                      eps=draws[(len(calls) - 1) % len(draws)].to(
                          params.flat.device))

    got = {}
    saved_noise = T.REG_NOISE_STD
    vi.sample_mfvi_tree, T.REG_NOISE_STD = table, 0.0
    try:
        for dev in ("cpu", DEVICE + ":0"):
            placed = problem_on(problem, dev)
            mesh = S.make_mesh(4, shape=SHARD_SHAPE, names=("cand", "mc"),
                               devices=[dev] * 4)
            step, _ = S.build_sharded_sweep_step(placed, "mfvi",
                                                 SHARD_SAMPLES, mesh,
                                                 eager=True)
            state = S.SweepState(
                state0.params.with_flat(state0.params.flat.to(dev,
                                                              copy=True)),
                tuple(t.to(dev, copy=True) for t in state0.opt_state),
                state0.out_avg.to(dev, copy=True))
            gens = [[torch.Generator(device=dev) for _ in range(SHARD_SAMPLES)]
                    for _ in range(n_cand)]
            state, loss = step(state, hp, gens, z.to(dev), 0)
            got[dev] = (loss.cpu(), state.opt_state[1].cpu(),
                        state.out_avg.cpu())
    finally:
        vi.sample_mfvi_tree, T.REG_NOISE_STD = sample, saved_noise
    if len(calls) != 2 * len(draws):
        raise AssertionError(f"{len(calls)} RT draws, expected "
                             f"{2 * len(draws)}")
    (l_c, m_c, o_c), (l_d, m_d, o_d) = got["cpu"], got[DEVICE + ":0"]
    r_loss = float(((l_d - l_c).abs() / l_c.abs()).max())
    r_grad = float((m_d - m_c).abs().max() / m_c.abs().max())
    _, r_out = rel_err(o_d, o_c)
    log(f"[14] one sharded step ({n_cand} x {n_mc} mesh, S = "
        f"{SHARD_SAMPLES}) at {SIZE}^2, card vs CPU plain path: loss rel "
        f"{r_loss:.2e}, mean gradient rel {r_grad:.2e}, EMA rel {r_out:.2e} "
        f"(tolerances {TOL_STEP['loss']:.0e} / {TOL_STEP['grad']:.0e} / "
        f"{TOL_STEP['out']:.0e})")
    if not (r_loss <= TOL_STEP["loss"] and r_grad <= TOL_STEP["grad"]
            and r_out <= TOL_STEP["out"]):
        raise AssertionError("the card's sharded step disagrees with the "
                             "CPU's")
    return dict(loss_rel=r_loss, grad_rel=r_grad, out_rel=r_out)


def sharded_step_on_card(den_iters_per_sec: float) -> dict:
    """(b): the cand x mc step (parallel/sharding.py::
    build_sharded_sweep_step) at bench.py's den widths (256^2, input depth
    16, f32, lr 1e-3, jitter on), configs/bo_mfvi_den.json's first two
    candidates, S = 2, on a (2 cand x 2 mc) mesh that names cuda:0 four
    times: SHARD_STEPS steps as one CUDA graph and SHARD_STEPS eagerly
    (``eager=True``) from the same state and generator seeds. Every loss,
    parameter, moment, count and EMA equal bit for bit, every mc replica
    equal to its lead after every step, every graph call a replay, the
    launches exactly ``shard_step_launches`` per step run (the graph's
    warm-up is one) in the captured step and over both runs, the entry
    copies exactly ``shard_copies_per_step`` per step run; one step
    against the CPU (``sharded_step_against_cpu``). Logs steps/s (graph,
    eager), the first call's seconds and the peak allocated memory beside
    one den fit's it/s (phase 3)."""
    import numpy as np
    import torch
    import mfvi_dip_mia_tpu_torch.parallel.sharding as S
    from mfvi_dip_mia_tpu_torch.utils.images import get_noise

    problem = den_tail_problem()
    _, methods = den_candidates(SHARD_SHAPE[0])
    mesh = S.make_mesh(4, shape=SHARD_SHAPE, names=("cand", "mc"),
                       devices=[DEVICE + ":0"] * 4)
    hp = S.stack_hyperparams(methods, 1e-3)
    z = torch.from_numpy(get_noise(16, SIZE, rng=np.random.default_rng(1))
                         ).permute(0, 3, 1, 2).contiguous().to(DEVICE)
    state0 = S.init_sweep_state(problem, "mfvi", SHARD_SHAPE[0], seed=1)
    placement = S.sweep_placement(mesh)
    s_local = SHARD_SAMPLES // SHARD_SHAPE[1]
    runs = {}
    for mode in ("graph", "eager"):
        step, placed = S.build_sharded_sweep_step(
            problem, "mfvi", SHARD_SAMPLES, mesh, eager=mode == "eager")
        gens = [[torch.Generator(device=devs[s // s_local]).manual_seed(
            100 * c + s) for s in range(SHARD_SAMPLES)]
            for c, (_, devs) in enumerate(placement)]
        runs[mode] = _sharded_run(step, _sweep_clone(state0), hp, gens, z)
        runs[mode]["step"] = step
    g, e = runs["graph"], runs["eager"]
    gs, es = g["step"], e["step"]
    per_step = shard_step_launches()
    graph_launches = _named(gs.graph[1])
    hold_step_launches("one replay of the sharded step", graph_launches, 1,
                       per_step)
    for mode, r in runs.items():
        hold_step_launches(f"the {mode} sharded steps", r["launches"],
                           r["step"].steps_run, per_step)
    fields = ((g["state"].params.flat, e["state"].params.flat),
              *zip(g["state"].opt_state, e["state"].opt_state),
              (g["state"].out_avg, e["state"].out_avg),
              (g["losses"], e["losses"]))
    checks = dict(
        graph_equals_eager=all(torch.equal(a, b) for a, b in fields),
        replicas_equal=g["replicas_equal"] and e["replicas_equal"],
        every_graph_call_a_replay=(gs.replays == SHARD_STEPS
                                   and gs.steps_run == SHARD_STEPS + 1),
        eager_no_graph=es.graph is None and es.steps_run == SHARD_STEPS,
        copies=(gs.copies == gs.steps_run * shard_copies_per_step()
                and es.copies == es.steps_run * shard_copies_per_step()
                and gs.graph[2] == shard_copies_per_step()),
        finite=bool(torch.isfinite(g["losses"]).all()),
        placed=placed == {"device": problem.device, "cand": SHARD_SHAPE[0],
                          "mc": SHARD_SHAPE[1]})
    log(f"[14] sharded step, {SHARD_SHAPE[0]} cand x {SHARD_SHAPE[1]} mc on "
        f"cuda:0 x 4, S = {SHARD_SAMPLES}, {SIZE}^2 den f32: graph "
        f"{g['steps_per_sec']:.2f} steps/s ({g['steps_per_sec'] * SHARD_SHAPE[0]:.2f}"
        f" candidate it/s), eager {e['steps_per_sec']:.2f} steps/s; first "
        f"call (warm-up, capture, replay) {g['first_call_seconds']:.2f} s, "
        f"eager {e['first_call_seconds']:.2f} s; peak allocated "
        f"{g['peak_allocated_bytes'] / 2 ** 20:.1f} / "
        f"{e['peak_allocated_bytes'] / 2 ** 20:.1f} MiB; one den fit "
        f"{den_iters_per_sec:.2f} it/s (phase 3); launches per step "
        f"{ {k: v for k, v in graph_launches.items() if v} }; copies per "
        f"step {gs.graph[2]}; losses at step {SHARD_STEPS} "
        f"{g['losses'][-1].tolist()}; checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"the sharded step failed {checks}")
    out = {mode: {k: v for k, v in r.items() if k not in ("state", "step")}
           for mode, r in runs.items()}
    for r in out.values():
        r["losses"] = r["losses"].tolist()
    out["launches_per_step"] = graph_launches
    out["copies_per_step"] = gs.graph[2]
    out["checks"] = checks
    out["den_iters_per_sec"] = den_iters_per_sec
    out["launches"] = g["launches"]
    out["step_vs_cpu"] = sharded_step_against_cpu(problem, methods)
    return out


def entry_against_cpu() -> dict:
    """(c): ``entry()``'s fn (the flagship MFVI net at 256^2: its loss nll +
    1e-6 KL and output) on the card against the port's CPU path, with the
    same parameters, input and RT draw (one table, drawn on the CPU): the
    loss, the output and the gradient by the flat parameters at
    TOL_STEP."""
    import torch
    import mfvi_dip_mia_tpu_torch.bayes.vi as vi
    from mfvi_dip_mia_tpu_torch.entry import entry

    fn_d, (params, x, gen_d) = entry(device=DEVICE)
    fn_c, _ = entry(device="cpu")
    table = torch.randn(params.n_var,
                        generator=torch.Generator().manual_seed(12))
    sample = vi.sample_mfvi_tree
    got = {}

    def fixed(p, generator=None, out_dtype=None, eps=None):
        return sample(p, out_dtype=out_dtype, eps=table.to(p.flat.device))

    vi.sample_mfvi_tree = fixed
    try:
        for fn, dev, gen in ((fn_c, "cpu", torch.Generator()),
                             (fn_d, DEVICE, gen_d)):
            p = params.flat.detach().to(dev).requires_grad_(True)
            loss, out = fn(params.with_flat(p), x.to(dev), gen)
            loss.backward()
            got[dev] = (loss.detach().cpu(), out.detach().cpu(),
                        p.grad.cpu())
    finally:
        vi.sample_mfvi_tree = sample
    (l_c, o_c, g_c), (l_d, o_d, g_d) = got["cpu"], got[DEVICE]
    r_loss = abs(float(l_d - l_c)) / abs(float(l_c))
    _, r_out = rel_err(o_d, o_c)
    r_grad = float((g_d - g_c).abs().max() / g_c.abs().max())
    log(f"[14] entry() at {SIZE}^2, card vs CPU plain path: loss "
        f"{float(l_d):.6f} / {float(l_c):.6f} (rel {r_loss:.2e}), output "
        f"rel {r_out:.2e}, gradient rel {r_grad:.2e}")
    if not (r_loss <= TOL_STEP["loss"] and r_out <= TOL_STEP["out"]
            and r_grad <= TOL_STEP["grad"]):
        raise AssertionError("entry()'s fn on the card disagrees with the "
                             "CPU's")
    return dict(loss_rel=r_loss, out_rel=r_out, grad_rel=r_grad)


def dryrun_on_card() -> dict:
    """(a): ``dryrun_multichip(DRYRUN_ENTRIES)`` with its default devices,
    cuda:0 .. cuda:7 folded onto the one card: the (4 cand x 2 mc) step
    as a CUDA graph on 64^2, two steps, then ``run_sweep_spmd`` of 4
    candidates over cuda:0 x 4. Its two lines are logged; it raises on a
    failed check."""
    import io
    from mfvi_dip_mia_tpu_torch.entry import dryrun_multichip
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        dryrun_multichip(DRYRUN_ENTRIES)
    lines = printed.getvalue().splitlines()
    for line in lines:
        log(f"[14] {line}")
    if len(lines) != 2:
        raise AssertionError(f"the dry run printed {lines}")
    return dict(lines=lines, seconds=time.perf_counter() - t0)


def sharded_phase(den_iters_per_sec: float) -> dict:
    """Phase 14: (a) the dry run, (b) the sharded step graph against eager
    and against the CPU, (c) ``entry()`` against the CPU, each timed by
    ``PhaseTimer``. Returns the phase's results, with "launches" those of
    (b)'s graph steps."""
    from mfvi_dip_mia_tpu_torch.utils.profiling import PhaseTimer

    t0 = time.perf_counter()
    timer = PhaseTimer()
    out = {}
    with timer.phase("dry run", sync=True):
        out["dryrun"] = dryrun_on_card()
    with timer.phase("sharded step", sync=True):
        out["step"] = sharded_step_on_card(den_iters_per_sec)
    with timer.phase("entry", sync=True):
        out["entry"] = entry_against_cpu()
    out["launches"] = out["step"]["launches"]
    out["timer"] = timer.summary()
    out["seconds"] = time.perf_counter() - t0
    log("[14] parts: " + ", ".join(f"{k} {v['total_s']:.1f} s"
                                   for k, v in out["timer"].items()))
    log(f"[14] phase 14 took {out['seconds']:.1f} s")
    return out


# -- phase 15: the den f32 fit against another checkout's ---------------------

PARENT_BITS_ITERS = 60
# One den/MFVI f32 graph fit at seed 1 in a child process on the checkout
# at argv[1] (the port's public API only, so that any checkout runs it), its
# metric rows and final parameters saved to argv[2].
_DEN_FIT_CHILD = f"""
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import mfvi_dip_mia_tpu_torch.tasks.data as D
import mfvi_dip_mia_tpu_torch.tasks.problems as P
from mfvi_dip_mia_tpu_torch.tasks.trainer import Method, fit
D.get_image_denoising = lambda img: (D.synthetic_xray(img, {SIZE}),
                                     ({SIZE}, {SIZE}))
problem = P.build_problem("den", "mfvi", 0, input_depth=16, device="cuda")
res = fit(problem, Method("mfvi", temp=5.66e-7, sigma=1.46e-5),
          num_iter={PARENT_BITS_ITERS - 1}, lr=1e-3, seed=1,
          show_every={PARENT_BITS_ITERS}, metrics_every=1,
          compute_dtype="f32", collect_snapshots=False, device="cuda")
np.savez(sys.argv[2], **{{f: getattr(res, f) for f in {METRIC_ROWS!r}}},
         **{{"param." + k: v for k, v in res.params.items()}})
print(res.replays, res.executed, flush=True)
"""


def den_bits_against_parent(parent: str) -> dict:
    """The den f32 fit (PARENT_BITS_ITERS graph replays at seed 1), run in a
    child process on ``parent`` and on this checkout, each building its own
    kernels: every metric row and final parameter must be equal bit for
    bit (the f32 fused block's instantiation is the f32 kernel as it was)."""
    import tempfile
    import numpy as np

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, root in (("parent", os.path.abspath(parent)),
                            ("this", REPO)):
            path = os.path.join(tmp, f"{label}.npz")
            t0 = time.perf_counter()
            run = subprocess.run([sys.executable, "-c", _DEN_FIT_CHILD, root,
                                  path], cwd=root, capture_output=True,
                                 text=True, timeout=600)
            if run.returncode != 0:
                raise AssertionError(f"the den fit on {label} ({root}) failed:"
                                     f"\n{run.stdout[-2000:]}"
                                     f"\n{run.stderr[-4000:]}")
            out[label] = dict(np.load(path))
            log(f"[15] den f32 fit on {label}: {run.stdout.strip()} "
                f"(replays, iterations), {time.perf_counter() - t0:.1f} s "
                "with its build")
    a, b = out["parent"], out["this"]
    differ = sorted(k for k in a if not np.array_equal(a[k], b.get(k),
                                                       equal_nan=True))
    log(f"[15] the den f32 fit, this checkout against {parent}: "
        + ("equal bits in every metric row and final parameter"
           if not differ else f"{len(differ)} arrays differ: {differ[:8]}"))
    if differ or set(a) != set(b):
        raise AssertionError(f"the den f32 fit differs from {parent}'s")
    return dict(arrays=len(a), equal=True, iterations=PARENT_BITS_ITERS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="profile this many steps of each path with "
                    "torch.profiler (den also without the fused block)")
    ap.add_argument("--parent", default=None,
                    help="a checkout of another commit (git archive): its "
                    "den f32 fit must give this checkout's bits (phase 15)")
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
        from mfvi_dip_mia_tpu_torch.utils.profiling import PhaseTimer
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
    timer = PhaseTimer()          # each phase's seconds, in the --out file
    with timer.phase("1 build and reports", sync=True):
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
    # the CT net's fused sites, which its bf16 fits run on the bf16 block
    f_sites_ct = fused_sites(nets[1], SIZE)
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
    # phase 10's pooled den net: its down1 sites convolve at stride 1, at
    # their level's full resolution (the other sites are den's)
    p10_conv = conv_sites(den_net(downsample_mode="lanczos2"), SIZE)
    # phase 12's split fits: every site's shard slab of the den net over 2
    # and 4 shards (down to 2 rows a shard at the deepest level)
    p12_conv = [site for n_sp in SP_SPLITS
                for site in split_conv_sites(nets[2], SIZE, n_sp)]
    # the dw runs at every conv site of the CT net (bf16), of the den net
    # (f32, the non-fused sites) and of path A (f32, 2 per site): every
    # distinct shape of both nets, in both dtypes; and at every site of the
    # sr and inp nets
    with timer.phase("2 kernels against plain", sync=True):
        check_conv_kernels(sites + l_sites + p8_conv + p10_conv + p12_conv,
                           results)
        states = check_radon_kernels(results)
        check_fused_kernels(f_sites + p8_fused, results)
        check_fused_kernels(f_sites_ct, results, torch.bfloat16)
        check_lrt_kernel(l_sites + p8_conv, results)
        dense = check_dense_radon(results)
        check_concurrent_streams(*concurrent_sites(l_sites, f_sites), dense,
                                 results)

    with timer.phase("3 main paths", sync=True):
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
    with timer.phase("4 graph against eager", sync=True):
        fits["graph_vs_eager"] = graph_against_eager()
    with timer.phase("5 sweep", sync=True):
        fits["sweep"] = sweep_phase()
    fits["bo_ct"] = fits["sweep"]["bo_ct"]
    with timer.phase("7 methods", sync=True):
        fits["methods"] = methods_phase()
    with timer.phase("8 sr and inp", sync=True):
        fits["sr_inp"] = sr_inp_phase(p8_nets)
    fits["sr"], fits["inp"] = fits["sr_inp"]["sr"], fits["sr_inp"]["inp"]

    with timer.phase("6 kernel times", sync=True):
        time_conv_kernels(sites, results)
        time_radon_kernels(states, dense, results)
        del states
        time_fused_kernels(f_sites, results)
        time_fused_kernels(f_sites_ct, results, torch.bfloat16)
        time_lrt_kernel(l_sites, results)
        time_dense_radon(dense, results)
        del dense
    if args.profile_steps:
        with timer.phase("6 profiles", sync=True):
            fits["profile"] = profile_ct(args.profile_steps, fits["ct"])
            fits["profile_den"] = profile_den(args.profile_steps)
            fits["profile_paths"] = profile_paths(args.profile_steps, fits)
            fits["profile_methods"] = profile_methods(
                args.profile_steps, fits["methods"]["fits"])
            fits["profile_sr_inp"] = profile_sr_inp(args.profile_steps,
                                                    fits["sr_inp"]["fits"])
    # phases 9 and 10 last: phase 6's timings and profiles run in the
    # process they ran in before them (a profile now and then loses
    # kernels: device_ms)
    with timer.phase("9 tail", sync=True):
        fits["tail"] = tail_phase()
    with timer.phase("10 library tail", sync=True):
        fits["lib"] = lib_phase()
    with timer.phase("11 parallel", sync=True):
        fits["parallel"] = parallel_phase()
    with timer.phase("12 spatial split", sync=True):
        fits["sp"] = sp_phase()
    with timer.phase("13 threads", sync=True):
        fits["threads"] = threads_phase()
    with timer.phase("14 sharded step", sync=True):
        fits["sharded"] = sharded_phase(fits["den"]["iters_per_sec"])
    if args.parent:
        with timer.phase("15 den bits against the parent", sync=True):
            fits["parent_bits"] = den_bits_against_parent(args.parent)

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
                                        "bo_ct", "sr", "inp", "tail",
                                        "lib", "parallel", "sp",
                                        "threads", "sharded")},
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
                           phase_seconds=timer.summary(),
                           seconds=time.perf_counter() - t_start), f,
                      indent=1, default=float)
    log("[6] seconds by phase: " + ", ".join(
        f"{k} {v['total_s']:.1f}" for k, v in timer.summary().items()))
    log(f"[6] total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
