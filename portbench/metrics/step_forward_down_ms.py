"""step_forward_down_ms (ms, program span; layer: Net): the median, over the
window's whole chunks outside the profiler's run, of the device time of
each chunk's last replay from the forward's first boundary to the net's
deepest output (tasks/trainer.py::STEP_SUBREGIONS' ``forward_down``: the
encoder's sites, the down1 and down2 of every level; a point recorded by
the net's forward, an event-record node in the graph). A program without
that point leaves it out. portbench/program.py selects the chunks."""

from portbench import program


def read(run):
    return program.region_ms(run, "forward_down")
