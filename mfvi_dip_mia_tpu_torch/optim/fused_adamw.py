"""Flat AdamW with the MFVI KL gradient fused in analytically (counterpart of
mfvi_dip_mia_tpu/optim/fused_adamw.py), over the ``[mu | rho | det]`` buffer
of bayes/vi.py::FlatParams.

For the reverse KL with prior N(0, sigma_p), sigma_p = prior_sigma + 1e-6,
and posterior N(mu, sigma_q), sigma_q = softplus(rho):

    dKL/dmu   = mu / sigma_q^2
    dKL/drho  = (1/sigma_q - (sigma_p^2 + mu^2) / sigma_q^3) * sigmoid(rho)

added to the data-loss gradient scaled by ``kl_temp``, then the optax.adamw
update formulas (count incremented first, bias correction 1 - b**count). The
trainer keeps the KL value for the logged loss under no_grad. Plain torch, as
in JAX, where this runs outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..bayes.vi import PRIOR_SIGMA_STABILIZER


def flat_adamw_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                      v: torch.Tensor, count: torch.Tensor, *, lr: float,
                      n_var: int, weight_decay: float = 0.0,
                      kl_temp: float = 0.0, kl_prior_sigma: float = 0.1,
                      use_kl: bool = False, b1: float = 0.9,
                      b2: float = 0.999, eps: float = 1e-8):
    """One update of the flat buffer ``p`` with gradient ``g``. Returns new
    (p, m, v, count) tensors; nothing is modified in place, so the caller's
    NaN guard can keep the old state with torch.where."""
    if use_kl and n_var:
        mu, rho = p[:n_var], p[n_var:2 * n_var]
        sig = F.softplus(rho)
        sp = kl_prior_sigma + PRIOR_SIGMA_STABILIZER
        g_mu = g[:n_var] + kl_temp * (mu / (sig * sig))
        dkl_dsig = 1.0 / sig - (sp * sp + mu * mu) / (sig * sig * sig)
        g_rho = g[n_var:2 * n_var] + kl_temp * dkl_dsig * torch.sigmoid(rho)
        g = torch.cat([g_mu, g_rho, g[2 * n_var:]])
    c = count + 1
    upd, m, v = adamw_update(p, g, m, v, c, lr=lr, weight_decay=weight_decay,
                             b1=b1, b2=b2, eps=eps)
    return p + upd, m, v, c


def adamw_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 v: torch.Tensor, c: torch.Tensor, *, lr: float,
                 weight_decay: float, b1: float, b2: float, eps: float):
    """optax.adamw's update of one tensor at the (already incremented)
    count ``c``: (update, m, v), the update -lr * (m_hat / (sqrt(v_hat) +
    eps) + weight_decay * p), decoupled from the moments."""
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * (g * g)
    cf = c.to(m.dtype)
    m_hat = m / (1.0 - torch.full_like(cf, b1) ** cf)
    v_hat = v / (1.0 - torch.full_like(cf, b2) ** cf)
    return -lr * (m_hat / (torch.sqrt(v_hat) + eps) + weight_decay * p), m, v
