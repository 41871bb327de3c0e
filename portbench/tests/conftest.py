"""Tiny sizes, for the whole runs of test_portbench_cells.py's `root`
fixture, of the configurations that BENCHMARK.json gained after that
file's TINY table: every configuration there must have one."""

import test_portbench_cells

test_portbench_cells.TINY.setdefault(
    "mix64-n50k", {"samples": 700, "species": 8})
