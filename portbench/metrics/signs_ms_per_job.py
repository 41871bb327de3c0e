"""Host wall per job of the program's sign path: its "load.skq" spans
(the .skq read) and its "signs" spans (the .ski -> .skd reorder and the
upload of the packed signs), portbench/spans.py, ms. None for a program
without these spans."""

from portbench.spans import stage_intervals, union


def read(trace, spans=None):
    iv = union(stage_intervals(trace, "load.skq", spans)
               + stage_intervals(trace, "signs", spans))
    if not iv:
        return None
    return sum(e - s for s, e in iv) / 1e6 / trace.n_jobs
