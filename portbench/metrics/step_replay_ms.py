"""step_replay_ms (ms, program span; layer: Device): the median, over the
window's whole chunks outside the profiler's run, of each chunk's device
time over its replays: two timing events the fit records on its stream,
before the chunk's first replay and after its last (tasks/trainer.py,
``device_ms``), with no profiler. portbench/program.py selects the
chunks."""

from portbench import program


def read(run):
    return program.chunk_median(
        run, lambda s: s.attrs["device_ms"] / s.attrs["replays"])
