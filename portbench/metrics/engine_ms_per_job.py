"""Host wall per job of the program's "engine" spans (the engine
selectors of runtime.py, each engine's set-up and upload included:
portbench/spans.py), ms."""

from portbench.spans import wall_ms_per_job


def read(trace, spans=None):
    return wall_ms_per_job(trace, "engine", spans)
