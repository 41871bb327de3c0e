"""Host wall per job of the program's "values" spans (the f64 chain on
the selected pairs, pair_samebits included: portbench/spans.py), ms."""

from portbench.spans import wall_ms_per_job


def read(trace, spans=None):
    return wall_ms_per_job(trace, "values", spans)
