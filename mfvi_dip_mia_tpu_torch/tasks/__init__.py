from .problems import Problem, build_problem
from .trainer import FitResult, HyperParams, Method, fit
from .runners import ALL_RUNNERS, method_for, run_task
from .runners import (run_ct_dip, run_ct_mcd, run_ct_mfvi,  # noqa: F401
                      run_ct_sgld, run_den_dip, run_den_mcd, run_den_mfvi,
                      run_den_sgld)  # (built by name)
