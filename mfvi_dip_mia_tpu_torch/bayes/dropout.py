"""MC dropout as a network transform (counterpart of
mfvi_dip_mia_tpu/bayes/dropout.py:19 ``mc_dropout_apply``): always-on
dropout at the output of any apply function. In the skip U-Net MC dropout is
set when the net is built instead (nn/skip.py, the ``dropout_mode_*``
keywords). The Gaussian-dropout variants (dropout.py:35, :48) are not
ported yet (ROADMAP Queue 1 item 8)."""

from __future__ import annotations

from ..nn import layers


def mc_dropout_apply(apply_fn, p: float = 0.5, mode: str = "2d"):
    """Wrap ``apply_fn(params, x, generator, **kw)`` with dropout of rate
    ``p`` on its NCHW output, drawn from the same generator after the
    forward ('2d': whole channels, else elements). Without a generator the
    output passes unchanged, as JAX's does without a key."""

    def wrapped(params, x, generator=None, **kwargs):
        out = apply_fn(params, x, generator, **kwargs)
        if generator is None:
            return out
        if mode == "2d":
            return layers.dropout2d(out, p, generator)
        return layers.dropout(out, p, generator)

    return wrapped
