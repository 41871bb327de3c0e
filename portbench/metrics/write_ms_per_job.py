"""Host wall per job of the program's "write" spans (the output's text,
formatted and written: portbench/spans.py), ms."""

from portbench.spans import wall_ms_per_job


def read(trace, spans=None):
    return wall_ms_per_job(trace, "write", spans)
