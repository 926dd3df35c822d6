"""setup_s (s, host clock): the process's start to the window's opening,
when every candidate has finished its first chunk (the library load, the
problem, the state, the warm-up and capture, and the first chunk)."""


def read(run):
    if run.window.w0 is None:
        return None
    return run.window.w0 - run.t_start
