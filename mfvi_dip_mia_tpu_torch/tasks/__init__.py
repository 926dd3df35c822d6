from .problems import Problem, build_problem
from .trainer import FitResult, HyperParams, Method, fit
from .runners import ALL_RUNNERS, method_for, run_task
from .runners import run_ct_mfvi, run_den_mfvi  # noqa: F401  (built by name)
