"""Progress reporting to stderr (the reference uses indicatif bars,
utils.rs:36-48; here a lightweight carriage-return ticker, shown only when
stderr is a terminal and --quiet is not set)."""

from __future__ import annotations

import sys
import time


def progress_printer(total: int, quiet: bool = False, label: str = ""):
    """Returns (callback, finish): callback() advances the ticker by one."""
    show = not quiet and sys.stderr.isatty() and total > 0
    state = {"done": 0, "last": 0.0}

    def tick():
        state["done"] += 1
        now = time.time()
        if show and (now - state["last"] > 0.1 or state["done"] == total):
            state["last"] = now
            pct = 100.0 * state["done"] / total
            print(
                f"\r{label}{state['done']}/{total} ({pct:3.0f}%)",
                end="",
                file=sys.stderr,
            )

    def finish():
        if show and state["done"]:
            print(file=sys.stderr)

    return tick, finish
