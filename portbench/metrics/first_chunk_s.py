"""first_chunk_s (s, host clock; layer: Trainer): the call into ``fit`` to
its first ``log_fn`` (prepare_fit, warm-up, capture and the first chunk),
the slowest candidate's."""


def read(run):
    ends = [c.first_chunk_end - c.t_call for c in run.candidates
            if c.first_chunk_end is not None]
    if len(ends) != len(run.candidates):
        return None
    return max(ends)
