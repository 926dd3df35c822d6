from .problems import Problem, build_problem, problem_on
from .trainer import (FitResult, HyperParams, Method, fit, fit_interleaved,
                      load_fit_checkpoint, save_fit_checkpoint)
from .runners import (ALL_RUNNERS, method_for, run_group_interleaved,
                      run_task)
from .runners import (run_ct_dip, run_ct_mcd, run_ct_mfvi,  # noqa: F401
                      run_ct_sgld, run_den_dip, run_den_mcd, run_den_mfvi,
                      run_den_sgld, run_inp_dip, run_inp_mcd, run_inp_mfvi,
                      run_inp_sgld, run_sr_dip, run_sr_mcd, run_sr_mfvi,
                      run_sr_sgld)  # (built by name)
from . import evaluation
