"""step_update_ms (ms, program span; layer: Net): the median, over the
window's whole chunks outside the profiler's run, of the device time of
each chunk's last replay between the step's update boundaries
(tasks/trainer.py::make_step's marks, event-record nodes in the graph): the
KL, the NaN guard's test, the flat AdamW with the KL gradient
(optim/fused_adamw.py) and the guard's copies. portbench/program.py selects
the chunks."""

from portbench import program


def read(run):
    return program.region_ms(run, "update")
