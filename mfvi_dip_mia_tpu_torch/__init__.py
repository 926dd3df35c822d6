"""mfvi_dip_mia_tpu_torch: the PyTorch / CUDA port of mfvi_dip_mia_tpu for an
NVIDIA H100 (sm_90a).

It runs the DIP skip U-Net's fits for all four tasks (CT with the banded or
dense Radon operator, denoising, super-resolution and inpainting) under
plain DIP, mean-field VI (with a scalar or scale-mixture prior), MC dropout
and SGLD, on hand-written CUDA kernels (csrc/) that replace the JAX
package's Pallas TPU kernels; the Bayesian-optimisation sweep of those fits
(``cli``, ``eval_cli``); and the evaluation report that scores a run's
save.npz against the classical baselines (``tasks.evaluation``); and the
library around them (pooled nets, Gaussian dropout, a Bayesian
classification trainer, the SGLD family, SNR pruning, profiling):

  * ``nn``     — the NCHW skip U-Net and its layers (LeakyReLU, ELU and
                 Swish nets; MC dropout; stride, avg, max or Lanczos
                 downsampling)
  * ``bayes``  — mean-field VI on a flat [mu | rho | det] buffer (the
                 closed-form and the scale-mixture MC KL), the priors
                 (``bayes.priors``), MC and Gaussian dropout, the MC
                 posterior summary, the uncertainty decompositions and
                 SNR pruning, the classification trainer
  * ``ops``    — the Radon operator, losses, metrics (PSNR, SSIM, UCE), the
                 classical baselines (``ops.classical``), the anti-aliased
                 downsampler, and
                 ``ops.kernels`` (the CUDA kernels' wrappers and their plain
                 versions)
  * ``optim``  — flat AdamW with the analytic KL gradient, SGLD's parameter
                 noise and floored lr decay, gradient transformations over
                 a parameter dict (optax's AdamW, SGLD, pSGLD)
  * ``tasks``  — data, problems, the trainer (checkpoint / resume, early
                 stop), the runners and the evaluation report
  * ``bo``     — the exact GP, acquisition and the BO loop (f64, host CPU)
  * ``parallel`` — the candidate fanout (interleaved groups on a card, one
                 program over a device mesh, candidates split over
                 processes with ``torch.distributed``)
  * ``utils``  — host images, plots, profiling, device resolution, CUDA
                 graph capture, the JAX weight bridge

Entry points run on the card unless the caller passes ``device="cpu"``; the
JAX package and JAX itself are never imported.
"""

__version__ = "0.1.0"
