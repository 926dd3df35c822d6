from .fanout import run_candidates, candidate_kwargs, TASK_ALIASES
