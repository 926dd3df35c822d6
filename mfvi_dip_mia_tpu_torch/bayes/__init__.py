from .vi import kl_mfvi, kl_mfvi_mc, posterior_mean_params, to_mfvi
from . import priors
from . import uncertainty
