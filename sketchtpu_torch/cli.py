"""Command line of the port: sketchtpu's CLI with this package's engines.

`sketchtpu.cli` imports every engine selector from `sketchtpu.runtime` at
call time, so binding the port's selectors onto that module for the
length of a call routes the whole command through the port, and the
originals come back afterwards. Commands and flags whose engines are not
ported yet are refused before anything runs.
"""

from __future__ import annotations

import contextlib
import os
import sys

ROUTED = (
    "select_backend",
    "select_engine",
    "select_coreacc_engine",
    "select_dense_stream_engine",
    "select_knn_engine",
    "select_inverted_engine",
)


@contextlib.contextmanager
def port_engines():
    """Bind the port's selectors onto sketchtpu.runtime, then restore."""
    import sketchtpu.runtime as jax_runtime

    from . import runtime

    saved = {name: getattr(jax_runtime, name) for name in ROUTED}
    try:
        for name in ROUTED:
            setattr(jax_runtime, name, getattr(runtime, name))
        yield
    finally:
        for name, fn in saved.items():
            setattr(jax_runtime, name, fn)


def refuse_unported(args) -> None:
    """Raise NotImplementedError for the parts of the CLI with no port."""
    if args.command == "inverted":
        raise NotImplementedError(
            "inverted index commands are not ported yet (ROADMAP queue 1 "
            "item 6)"
        )
    if args.command == "warmup":
        raise NotImplementedError(
            "warmup is not ported yet (ROADMAP queue 1 item 10)"
        )
    if getattr(args, "jax_profile", None):
        raise NotImplementedError(
            "--jax-profile is not ported yet (ROADMAP queue 1 item 10)"
        )
    n_proc = getattr(args, "n_processes", None)
    if (n_proc is not None and n_proc > 1) or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    ):
        raise NotImplementedError(
            "multi-process runs are not ported yet (ROADMAP queue 1 item 8)"
        )


def main(argv=None) -> int:
    from sketchtpu import cli

    argv = sys.argv[1:] if argv is None else list(argv)
    refuse_unported(cli.build_parser().parse_args(argv))
    with port_engines():
        return cli.main(argv)
