"""Device-idle time per job inside the program's "scan" spans (the tile
loop up to the selection's copy to the host, or the pair count): launch
gaps, waits and the host's side of the loop (portbench/spans.py), ms."""

from portbench.spans import idle_ms_per_job


def read(trace, spans=None):
    return idle_ms_per_job(trace, "scan", spans)
