from .problems import Problem, build_problem
from .trainer import FitResult, HyperParams, Method, fit
