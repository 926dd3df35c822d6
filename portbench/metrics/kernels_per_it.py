"""kernels_per_it (kernels/it, device trace; layer: Net): the device
kernels of the traced stretch over the candidate iterations in it, a
replay of a fit's step counted by the kernels that carry its launch's
correlation."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    replays = tr.replays()
    if not replays:
        return None
    return len(tr.kernels()) / replays
