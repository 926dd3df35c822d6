from .gp import ExactGP, train_gp
from .acquisition import expected_improvement, upper_confidence_bound, find_candidates
from .normalize import normalize_X, unnormalize_X
from .loop import bo, evaluate_candidates
