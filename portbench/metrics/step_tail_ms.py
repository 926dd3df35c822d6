"""step_tail_ms (ms, program span; layer: Trainer): the median, over the
window's whole chunks outside the profiler's run, of the device time of
each chunk's last replay between the step's tail boundaries
(tasks/trainer.py::make_step's marks, event-record nodes in the graph): the
transform, the EMA, the MC rings, the metric row and the iteration index.
portbench/program.py selects the chunks."""

from portbench import program


def read(run):
    return program.region_ms(run, "tail")
