"""step_draw_ms (ms, program span; layer: Net): the median, over the window's
whole chunks outside the profiler's run, of the device time of each chunk's
last replay between the step's draw boundaries
(tasks/trainer.py::make_step's marks, event-record nodes in the graph): the
input jitter, sgld's noise, the RT draw over the flat buffer
(bayes/vi.py::sample_mfvi_tree) and the casts to the compute dtype.
portbench/program.py selects the chunks."""

from portbench import program


def read(run):
    return program.region_ms(run, "draw")
