"""step_backward_down_ms (ms, program span; layer: Net): the median, over
the window's whole chunks outside the profiler's run, of the device time of
each chunk's last replay from the moment the gradient of the net's deepest
output is complete to the moment the first of the net's leaves has its
gradient (tasks/trainer.py::STEP_SUBREGIONS' ``backward_down``: the
encoder's backward, without what autograd runs after the net, the leaves'
gradients' sum into the flat buffer and the MFVI draw's backward; points
that tensor hooks record, event-record nodes in the graph). A program
without those points leaves it out. portbench/program.py selects the
chunks."""

from portbench import program


def read(run):
    return program.region_ms(run, "backward_down")
