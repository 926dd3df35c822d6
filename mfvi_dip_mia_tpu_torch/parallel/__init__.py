from .fanout import (run_candidates, run_candidates_spmd, candidate_kwargs,
                     TASK_ALIASES)
from .multihost import check_resume_consistency, run_candidates_multihost
from .sharding import (Mesh, SweepState, build_sharded_sweep_step,
                       build_spmd_chunk, fit_sp, init_sweep_state, make_mesh,
                       run_sweep_spmd, sp_shardings, stack_hyperparams,
                       sweep_placement)
