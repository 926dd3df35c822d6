"""capture_s (s, program span; layer: Trainer): the slowest candidate's
``capture`` span (tasks/trainer.py::fit): the wait for the compile lock,
the warm-up of both step variants until its work is done, and both
variants' CUDA graph captures."""

from portbench import program


def read(run):
    spans = program.captures(run)
    return max(s.seconds for s in spans) if spans else None
