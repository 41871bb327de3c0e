"""Host wall per job of the program's "load" spans (the .skm, .skd and
.ski reads and their parse: portbench/spans.py), ms."""

from portbench.spans import wall_ms_per_job


def read(trace, spans=None):
    return wall_ms_per_job(trace, "load", spans)
