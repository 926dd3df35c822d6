"""cand_it_s (it/s, host clock): the candidate iterations the cell's fits
completed in the window, per second: each candidate's whole chunks that
ended in the window over the seconds they span, summed over candidates."""


def read(run):
    rates = run.rates()
    if not rates or any(r is None for r in rates):
        return None
    return sum(rates)
