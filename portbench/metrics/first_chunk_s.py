"""first_chunk_s (s, host clock; layer: Trainer): the call into the
trainer (``fit``, or ``fit_interleaved`` for a round's group; the problems
are built before it) to each candidate's first ``log_fn`` (prepare_fit,
warm-up, capture and the first chunk; in a group, of every fit before it
too), the slowest candidate's."""


def read(run):
    ends = [c.first_chunk_end - c.t_call for c in run.candidates
            if c.first_chunk_end is not None]
    if len(ends) != len(run.candidates):
        return None
    return max(ends)
