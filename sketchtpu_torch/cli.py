"""Command line of the port: the subcommands and flags of the reference
(sketchlib.rust src/cli.rs) that sketchtpu_torch serves, on its own engines.

Subcommands: sketch (assemblies, reads, amino acids and 3Di), dist (dense
and --knn), merge, append, delete, info (.skm and .ski), inverted build /
query / precluster / serve, and warmup (builds the kernels). sketch, dist
and inverted build / query / precluster run as several ranks, under
torchrun or by --process-id/--n-processes (shard/distributed.py);
--jax-profile writes a torch.profiler trace, the host stages' spans
(spans.py) among its events. A k past the card's hash
kernel (MAX_K_CUDA for DNA, MAX_K_AA_CUDA for --seq-type aa|pdb) is
refused at argument parsing in cuda mode, as is a jax.distributed
coordinator (JAX_COORDINATOR_ADDRESS) without torchrun's variables.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np

from . import spans

log = logging.getLogger("sketchtpu")

DEFAULT_KNN = 50
DEFAULT_KMER = 21
DEFAULT_MINCOUNT = 5
DEFAULT_MINQUAL = 20
DEFAULT_SKETCHSIZE = 1000


def _add_common(p):
    p.add_argument("-v", "--verbose", action="store_true", help="Show progress messages")
    p.add_argument("--quiet", action="store_true", help="Don't show any messages")
    p.add_argument(
        "--jax-profile",
        metavar="DIR",
        help="Write a PyTorch profiler trace of the run (torch.profiler, "
        "CPU and CUDA activities) into DIR as a Chrome trace, one file per "
        "rank, with the host stages (load, engine, upload, scan, values, "
        "write) as record_function ranges; the flag keeps the JAX "
        "package's name",
    )


def _add_kmers(p):
    p.add_argument(
        "-k",
        "--k-vals",
        type=lambda s: [int(x) for x in s.split(",")],
        help="K-mer list (comma separated k-mer values to sketch at)",
    )
    p.add_argument(
        "--k-seq",
        type=lambda s: [int(x) for x in s.split(",")],
        help="K-mer linear sequence (start,end,step)",
    )


def _add_ranks(p, what: str):
    p.add_argument("--process-id", type=int, default=None,
                   help="Multi-process sharding: this process's rank (read "
                   "from torchrun's RANK when the flags are absent)")
    p.add_argument("--n-processes", type=int, default=None,
                   help="Multi-process sharding: total process count; " + what)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="sketchtpu_torch",
        description="Genome sketching and distances on PyTorch and CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    # --- sketch ---
    p = sub.add_parser("sketch", help="Create sketches from input data")
    p.add_argument("seq_files", nargs="*", help="List of input FASTA files")
    p.add_argument("-f", dest="file_list", help="File listing input files")
    p.add_argument("--concat-fasta", action="store_true")
    p.add_argument("-o", dest="output", required=True, help="Output prefix")
    _add_kmers(p)
    p.add_argument("-s", "--sketch-size", type=int, default=DEFAULT_SKETCHSIZE)
    p.add_argument("--seq-type", choices=["dna", "aa", "pdb"], default="dna")
    p.add_argument(
        "--convert-pdb",
        action="store_true",
        help="Input files are .pdb; convert them to 3Di first (requires the "
        "optional mini3di + biopython packages)",
    )
    p.add_argument("--level", choices=["level1", "level2", "level3"], default="level1")
    p.add_argument("--single-strand", action="store_true")
    p.add_argument("--min-count", type=int, default=DEFAULT_MINCOUNT)
    p.add_argument("--min-qual", type=int, default=DEFAULT_MINQUAL)
    p.add_argument("--threads", type=int, default=1)
    _add_ranks(p, "each process sketches its slice of the input list, "
               "rank 0 merges")
    _add_common(p)

    # --- dist ---
    p = sub.add_parser("dist", help="Calculate pairwise distances using sketches")
    p.add_argument("ref_db")
    p.add_argument("query_db", nargs="?")
    p.add_argument("-o", dest="output")
    p.add_argument("--knn", type=int)
    p.add_argument("--subset")
    p.add_argument("-k", dest="kmer", type=int)
    p.add_argument("--ani", action="store_true")
    p.add_argument(
        "--exact",
        action="store_true",
        help="Dense multi-k core/accessory output (self AND ref-vs-"
        "query): stream exact per-k samebits from the device and replay "
        "the f64 chain on the host — byte-identical to the host "
        "pipeline (the default large-run engine is f32, within ~1e-5). "
        "Single-k and kNN outputs are already exact; no effect there",
    )
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--ref-completeness-file")
    p.add_argument("--query-completeness-file")
    p.add_argument("--completeness-cutoff", type=float, default=0.64)
    _add_ranks(p, "each process computes a balanced block of output rows "
               "and writes OUTPUT.partN; concatenate parts in rank order")
    _add_common(p)

    _add_inverted(sub)
    _add_warmup(sub)

    # --- merge ---
    p = sub.add_parser("merge", help="Merge two sketch databases")
    p.add_argument("db1")
    p.add_argument("db2")
    p.add_argument("-o", dest="output", required=True)
    _add_common(p)

    # --- append ---
    p = sub.add_parser("append", help="Sketch new genomes and append to a database")
    p.add_argument("db")
    p.add_argument("seq_files", nargs="*")
    p.add_argument("-f", dest="file_list")
    p.add_argument("-o", dest="output", required=True)
    p.add_argument("--single-strand", action="store_true")
    p.add_argument("--min-count", type=int, default=DEFAULT_MINCOUNT)
    p.add_argument("--min-qual", type=int, default=DEFAULT_MINQUAL)
    p.add_argument("--concat-fasta", action="store_true")
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--level", choices=["level1", "level2", "level3"], default="level1")
    _add_common(p)

    # --- delete ---
    p = sub.add_parser("delete", help="Delete genome(s) from a database")
    p.add_argument("db")
    p.add_argument("samples", help="Input file with IDs to delete (one per line)")
    p.add_argument("output_file")
    _add_common(p)

    # --- info ---
    p = sub.add_parser("info", help="Print information about a .skm file")
    p.add_argument("skm_file")
    p.add_argument("--sample-info", action="store_true")
    _add_common(p)

    return parser


def _add_inverted(sub) -> None:
    p_inv = sub.add_parser("inverted", help="Inverted index commands")
    inv_sub = p_inv.add_subparsers(dest="inverted_command", required=True)

    p = inv_sub.add_parser("build")
    p.add_argument("seq_files", nargs="*")
    p.add_argument("-f", dest="file_list")
    p.add_argument("-o", dest="output", required=True)
    p.add_argument("--write-skq", action="store_true")
    p.add_argument("--species-names")
    p.add_argument("--metadata")
    p.add_argument("-s", "--sketch-size", type=int, default=DEFAULT_SKETCHSIZE)
    p.add_argument("-k", "--kmer-length", type=int, default=DEFAULT_KMER)
    p.add_argument("--single-strand", action="store_true")
    p.add_argument("--min-count", type=int, default=DEFAULT_MINCOUNT)
    p.add_argument("--min-qual", type=int, default=DEFAULT_MINQUAL)
    p.add_argument("--threads", type=int, default=1)
    _add_ranks(p, "each process builds its slice of the sample rows, rank "
               "0 merges the .ski (byte-identical to a single-process "
               "build)")
    _add_common(p)

    p = inv_sub.add_parser("query")
    p.add_argument("ski")
    p.add_argument("seq_files", nargs="*")
    p.add_argument("-f", dest="file_list")
    p.add_argument("-o", dest="output")
    p.add_argument(
        "--query-type",
        choices=["match-count", "all-bins", "any-bins"],
        default="match-count",
    )
    p.add_argument("--min-count", type=int, default=DEFAULT_MINCOUNT)
    p.add_argument("--min-qual", type=int, default=DEFAULT_MINQUAL)
    p.add_argument("--threads", type=int, default=1)
    _add_ranks(p, _ROW_PARTS)
    _add_common(p)

    p = inv_sub.add_parser(
        "serve",
        help="Serve the index over HTTP (GET /info, POST /query = "
        "SketchlibData::get_probs JSON, POST /match-count)",
    )
    p.add_argument("ski")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    _add_common(p)

    p = inv_sub.add_parser("precluster")
    p.add_argument("ski")
    p.add_argument("--skd")
    p.add_argument("-o", dest="output")
    p.add_argument("--count", action="store_true")
    p.add_argument("--knn", type=int, default=DEFAULT_KNN)
    p.add_argument("--ani", action="store_true")
    p.add_argument(
        "--core-acc",
        action="store_true",
        help="Rank neighbours by multi-k core/accessory distances over "
        "every k in the .skd (extension; the reference CLI only supports "
        "single-k distances here)",
    )
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--ref-completeness-file")
    p.add_argument("--completeness-cutoff", type=float, default=0.64)
    p.add_argument(
        "--retain-unmatched", choices=["singleton", "bruteforce"], default=None
    )
    _add_ranks(p, _ROW_PARTS)
    _add_common(p)


_ROW_PARTS = ("each process handles a block of rows and writes OUTPUT.partN "
              "(concatenate parts in rank order; only rank 0 prints the "
              "header)")


def _add_warmup(sub) -> None:
    """`warmup` takes the JAX package's flags, so scripts written for it run
    unchanged; the port's one-time cost is the kernels' build, which no
    flag but --modes (checked) changes (warmup.py)."""
    from .warmup import MODES

    p = sub.add_parser(
        "warmup",
        help="Build the CUDA kernels (nvcc) and the host helper (g++) into "
        "sketchtpu_torch/_build, so that later runs start at once "
        "(see sketchtpu_torch/warmup.py)",
    )
    _add_kmers(p)
    p.add_argument("-s", "--sketch-size", type=int, default=DEFAULT_SKETCHSIZE)
    p.add_argument("--knn", type=int, default=DEFAULT_KNN)
    p.add_argument("--db-size", type=int, default=10240)
    p.add_argument("--genome-sizes", default="2000000")
    p.add_argument("--modes", default="sketch,dense,knn",
                   help="Comma-separated subset of " + ",".join(MODES)
                   + " (each needs the same one build; an unknown name is "
                   "an error)")
    p.add_argument("--query-db-size", type=int, default=2048)
    p.add_argument("--reads-bases", type=int, default=20_000_000)
    p.add_argument("--inverted-sketch-size", type=int, default=100)
    p.add_argument("--seq-type", choices=["dna", "aa"], default="dna")
    p.add_argument("--level", choices=["level1", "level2", "level3"],
                   default="level1")
    p.add_argument("--threads", type=int, default=1)
    _add_common(p)


def refuse_unported(args, parser) -> None:
    """Refuse, before any work, the rank settings that the port cannot
    honour: a jax.distributed coordinator (JAX_COORDINATOR_ADDRESS) with
    neither the rank flags nor torchrun's variables, where each rank would
    silently write the whole output; --process-id without --n-processes;
    and a rank outside [0, n). An unknown warmup mode is refused too."""
    from .shard.distributed import TORCHRUN_ENV, torchrun_env

    if args.command == "warmup":
        from .warmup import parse_modes

        try:
            parse_modes(args.modes)
        except ValueError as e:
            parser.error(str(e))
        return
    if not hasattr(args, "n_processes"):
        return
    n_proc, proc_id = args.n_processes, args.process_id
    if (n_proc is None and os.environ.get("JAX_COORDINATOR_ADDRESS")
            and not torchrun_env()):
        parser.error(
            "JAX_COORDINATOR_ADDRESS is set, but the port does not join a "
            "jax.distributed coordinator: start the ranks with torchrun "
            f"(or set {', '.join(TORCHRUN_ENV)} for each rank), or pass "
            "--process-id and --n-processes"
        )
    if n_proc is None and proc_id is not None:
        parser.error("--process-id needs --n-processes")
    if n_proc is not None and not 0 <= (proc_id or 0) < n_proc:
        parser.error(f"--process-id {proc_id or 0} is outside [0, {n_proc}) "
                     f"for --n-processes {n_proc}")


def refuse_past_card_limits(args, parser) -> None:
    """A k past the card's hash kernel (MAX_K_CUDA, csrc/nthash_bin.cu, or
    for amino acids and 3Di MAX_K_AA_CUDA, csrc/aahash_bin.cu) is refused
    before any work in cuda mode, for `sketch`, `inverted build` and
    `append` (the database's k); nothing else takes it there."""
    from .runtime import mode

    if mode() != "cuda":
        return
    seq_type = getattr(args, "seq_type", "dna")
    if args.command == "sketch" and (args.k_vals or args.k_seq):
        from .ingest.inputs import parse_kmers

        kmers = parse_kmers(args.k_vals, args.k_seq)
    elif args.command == "inverted" and args.inverted_command == "build":
        kmers = [args.kmer_length]
    elif args.command == "append":
        from .formats.skm import MultiSketch

        db = MultiSketch.load_metadata(strip_sketch_extension(args.db))
        kmers, seq_type = db.kmer_lengths, db.hash_type.kind
    else:
        return
    if seq_type == "dna":
        from .hash.nthash_torch import MAX_K_CUDA as limit
    else:
        from .hash.aahash_torch import MAX_K_AA_CUDA as limit

    past = [k for k in kmers if k > limit]
    if past:
        parser.error(
            f"k={past}: the card's hash kernel takes k <= {limit} "
            "(SKETCHTPU_TORCH_BACKEND=cpu or host sketch past it)"
        )


def strip_sketch_extension(name: str) -> str:
    if name.endswith((".skm", ".skd", ".ski")):
        return name[:-4]
    return name


def _setup_logging(args):
    level = logging.WARNING
    if getattr(args, "quiet", False):
        level = logging.ERROR
    elif getattr(args, "verbose", False):
        level = logging.INFO
    logging.basicConfig(
        stream=sys.stderr, level=level, format="%(asctime)s %(levelname)s %(message)s"
    )


def _level_num(level_str: str) -> int:
    return int(level_str[-1])


def _resolve_ranks(args):
    """(proc_id, n_proc, multiproc): from the flags, else from torchrun's
    environment (which joins its gloo process group)."""
    n_proc, proc_id = args.n_processes, args.process_id
    if n_proc is None:
        from .shard.distributed import init_distributed

        proc_id, n_proc = init_distributed()
    return proc_id or 0, n_proc, n_proc > 1


def _start_profile(args) -> None:
    """torch.profiler over the whole run (CPU activity, and CUDA where torch
    sees a card), written at exit, so that every early return closes it,
    as a Chrome trace into the --jax-profile directory: one file per rank."""
    import atexit

    import torch
    from torch.profiler import ProfilerActivity, profile

    from .shard.distributed import torchrun_env

    rank = None
    if getattr(args, "n_processes", None) is not None:
        rank = args.process_id or 0
    elif hasattr(args, "n_processes") and torchrun_env():
        rank = int(os.environ["RANK"])
    name = args.command + (f".rank{rank}" if rank is not None else "")
    path = os.path.join(args.jax_profile, f"{name}.pt.trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    spans.annotate(True)  # this profiler is the program's own

    def stop():
        spans.annotate(False)
        prof.stop()
        os.makedirs(args.jax_profile, exist_ok=True)
        prof.export_chrome_trace(path)

    atexit.register(stop)
    log.info("PyTorch profiler tracing to %s", path)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    refuse_unported(args, parser)
    refuse_past_card_limits(args, parser)
    _setup_logging(args)
    start = time.time()
    if args.jax_profile:
        _start_profile(args)
    try:
        with spans.span(f"cli.{args.command}"):
            return _run(args, start)
    finally:
        window = os.environ.get("SKETCHTPU_COMPUTE_WINDOW_FILE")
        if window:
            # the post-import compute window, for rank-scaling measurements:
            # interpreter start and imports are a fixed per-process cost
            import json

            with open(window, "w") as f:
                json.dump({"compute_s": time.time() - start}, f)


def _run(args, start: float) -> int:
    if args.command == "sketch":
        _sketch_main(args, start)
    elif args.command == "dist":
        _dist_main(args, start)
    elif args.command == "merge":
        _merge_main(args)
    elif args.command == "append":
        _append_main(args)
    elif args.command == "delete":
        from .formats.skm import MultiSketch

        ref_db = strip_sketch_extension(args.db)
        with open(args.samples) as f:
            ids = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        _delete_samples(MultiSketch.load_metadata(ref_db), ref_db,
                        args.output_file, ids)
    elif args.command == "inverted":
        _inverted_main(args)
    elif args.command == "info":
        _info_main(args)
        return 0
    elif args.command == "warmup":
        from .warmup import run_warmup

        run_warmup(args)

    if not args.quiet:
        print(f"\U0001f9ec\U0001f58b️ sketchtpu done in {int(time.time() - start)}s", file=sys.stderr)
    return 0


def _sketch_main(args, start: float) -> None:
    from .constants import num_bins
    from .formats.skm import MultiSketch
    from .ingest import inputs as io_inputs
    from .progress import progress_printer
    from .runtime import select_backend
    from .sketchcore.pipeline import sketch_files
    from .sketchcore.sketch import HashType

    input_files = io_inputs.get_input_list(args.file_list, args.seq_files or None)
    log.info("Parsed %d samples in input list", len(input_files))
    kmers = io_inputs.parse_kmers(args.k_vals, args.k_seq)
    seq_type = HashType(args.seq_type, _level_num(args.level))
    _, sketch_bins, _ = num_bins(args.sketch_size)
    log.info(
        "Running sketching: k:%s; sketch_size:%s; seq:%s; threads:%s",
        kmers, sketch_bins, seq_type.debug_str(), args.threads,
    )
    proc_id, n_proc, multiproc = _resolve_ranks(args)
    if multiproc:
        _sketch_ranks(args, input_files, kmers, sketch_bins, seq_type,
                      proc_id, n_proc)
        return
    backend = select_backend(seq_type, len(input_files))
    tick, finish = progress_printer(len(input_files), args.quiet, "Sketching ")
    sketches = sketch_files(
        args.output,
        input_files,
        args.concat_fasta,
        kmers,
        sketch_bins,
        seq_type,
        not args.single_strand,
        args.min_count,
        args.min_qual,
        threads=args.threads,
        backend=backend,
        progress=tick,
        convert_pdb=args.convert_pdb,
    )
    finish()
    elapsed = max(time.time() - start, 1e-9)
    total_mb = sum(s.seq_length for s in sketches) / 1e6
    log.info(
        "Sketched %d samples (%.1f Mbases) in %.2fs "
        "(%.1f samples/s, %.1f Mbase/s, %.1f Mbase-k/s)",
        len(sketches), total_mb, elapsed, len(sketches) / elapsed,
        total_mb / elapsed, total_mb * len(kmers) / elapsed,
    )
    MultiSketch(sketches, sketch_bins, kmers, seq_type).save_metadata(args.output)


def _sketch_ranks(args, input_files, kmers, sketch_bins, seq_type, proc_id,
                  n_proc) -> None:
    """This rank's slice of the input list into a shard; rank 0 merges
    once every shard exists (byte-identical to a single-process sketch)."""
    from .shard import distributed

    distributed.sketch_shard(
        args.output, input_files, proc_id, n_proc,
        concat_fasta=args.concat_fasta, kmers=kmers, sketch_bins=sketch_bins,
        seq_type=seq_type, rc=not args.single_strand,
        min_count=args.min_count, min_qual=args.min_qual,
        threads=args.threads, convert_pdb=args.convert_pdb,
    )
    _merge_on_rank0(args.output, proc_id, n_proc, ".skm",
                    lambda: distributed.merge_shards(args.output, n_proc),
                    "merge_shards")


def _merge_on_rank0(output: str, proc_id: int, n_proc: int, ext: str, merge,
                    what: str):
    """After a barrier when a process group spans the ranks, rank 0 runs
    merge() if every rank's shard exists; under the flags' own
    orchestration a rank 0 that finishes first leaves the merge to the
    caller. Returns merge()'s result, or None."""
    from pathlib import Path

    from .shard import distributed

    if distributed.spans(n_proc):
        distributed.barrier()
    if proc_id != 0:
        return None
    if all(Path(f"{distributed.shard_prefix(output, i)}{ext}").exists()
           for i in range(n_proc)):
        return merge()
    log.warning(
        "shards incomplete; run sketchtpu_torch.shard.distributed.%s(%r, "
        "%d) once all ranks finish", what, output, n_proc,
    )
    return None


def _dist_main(args, start: float) -> None:
    from .dist import api
    from .dist import output as dist_output
    from .formats.skm import MultiSketch
    from .ingest import inputs as io_inputs
    from .runtime import (
        select_coreacc_engine,
        select_dense_stream_engine,
        select_engine,
        select_knn_engine,
    )

    if args.ani and args.kmer is None:
        # clap: `ani` requires `kmer` (cli.rs:212)
        raise SystemExit("--ani requires -k (a single k-mer length)")
    proc_id, n_proc, multiproc = _resolve_ranks(args)
    if multiproc and args.output:
        from .shard.distributed import shard_prefix

        args.output = shard_prefix(args.output, proc_id)
        log.info("Multi-process dist: rank %d/%d writing %s (concatenate "
                 "parts in rank order for the full output)", proc_id, n_proc,
                 args.output)
    out = open(args.output, "w") if args.output else sys.stdout
    ref_name = strip_sketch_extension(args.ref_db)
    with spans.span("load"):
        references = MultiSketch.load_metadata(ref_name)
        log.info("Loading sketch data from %s.skd", ref_name)
        if args.subset:
            references.read_sketch_data_block(
                ref_name, io_inputs.read_subset_names(args.subset)
            )
        else:
            references.read_sketch_data(ref_name)
    n = references.number_samples_loaded()
    ref_comp = (
        io_inputs.read_completeness_file(args.ref_completeness_file, references)
        if args.ref_completeness_file
        else None
    )
    dist_type = api.set_k(references, args.kmer, args.ani)
    log.info("%s", dist_type.describe())
    engine = select_engine(references)
    names = [references.sketch_name(i) for i in range(n)]
    cutoff = args.completeness_cutoff
    # a rank's rows: self dense by pair count (the upper triangle), kNN and
    # ref-vs-query dense evenly; every rank loads all columns
    tri_rows = uni_rows = None
    if multiproc:
        from .shard.distributed import process_slice, triangle_row_slice

        tri_rows = triangle_row_slice(n, proc_id, n_proc)
        uni_rows = process_slice(n, proc_id, n_proc)
    row_names = names[uni_rows] if uni_rows is not None else names

    def log_pair_rate(n_pairs):
        el = max(time.time() - start, 1e-9)
        log.info("Computed %d pairwise distances in %.2fs (%.3g pairs/s)",
                 n_pairs, el, n_pairs / el)

    if args.query_db is None and args.knn is None:
        ca_engine = stream_engine = None
        if dist_type.coreacc:
            ca_engine = select_coreacc_engine(references, ref_comp, cutoff,
                                              exact=args.exact)
        else:
            stream_engine = select_dense_stream_engine(references, dist_type)
        if ca_engine is not None:
            log.info("Using on-device core/accessory %s engine",
                     "exact-stream" if args.exact else "tile")
            ca_engine.stream_self_dense(out, names, row_range=tri_rows)
        elif stream_engine is not None:
            log.info("Using on-device dense streaming engine")
            stream_engine.stream_self_dense(out, names, dist_type, ref_comp,
                                            cutoff, row_range=tri_rows)
        else:
            d = api.self_dists_all(references, dist_type, ref_comp, cutoff,
                                   engine=engine, row_range=tri_rows)
            dist_output.write_dense_self(out, names, d, dist_type.coreacc,
                                         row_range=tri_rows)
        lo, hi = (tri_rows.start, tri_rows.stop) if tri_rows else (0, n)
        log_pair_rate((hi - lo) * (n - 1) - (hi - lo) * (lo + hi - 1) // 2)
    elif args.query_db is None:
        nn = args.knn
        if nn >= n:
            log.warning("knn=%d is higher than number of samples=%d", nn, n)
            nn = n - 1
        knn_engine = select_knn_engine(references, dist_type)
        if knn_engine is not None:
            log.info("Using on-device kNN engine")
            if dist_type.coreacc:
                rows = knn_engine.self_knn_coreacc(
                    nn, row_range=uni_rows, completeness_vec=ref_comp,
                    completeness_cutoff=cutoff)
            else:
                rows = knn_engine.self_knn(
                    nn, dist_type, row_range=uni_rows,
                    completeness_vec=ref_comp, completeness_cutoff=cutoff)
        else:
            rows = api.self_dists_knn(references, nn, dist_type, ref_comp,
                                      cutoff, engine=engine,
                                      row_range=uni_rows)
        dist_output.write_sparse(out, row_names, names, rows,
                                 dist_type.coreacc)
        log_pair_rate(len(row_names) * n)
    else:
        query_name = strip_sketch_extension(args.query_db)
        with spans.span("load"):
            queries = MultiSketch.load_metadata(query_name)
            if multiproc and args.knn is not None:
                # kNN rows are queries: this rank loads only its block
                from .shard.distributed import process_slice

                all_q = [queries.sketch_name(i) for i in
                         range(queries.number_samples_loaded())]
                queries.read_sketch_data_block(
                    query_name,
                    all_q[process_slice(len(all_q), proc_id, n_proc)])
            else:
                queries.read_sketch_data(query_name)
        q_comp = (
            io_inputs.read_completeness_file(args.query_completeness_file, queries)
            if args.query_completeness_file
            else None
        )
        qnames = [queries.sketch_name(i)
                  for i in range(queries.number_samples_loaded())]
        if args.knn is not None:
            nn = args.knn
            if nn > n:
                log.warning(
                    "knn=%d is higher than number of reference samples=%d", nn, n
                )
                nn = n
            knn_engine = select_knn_engine(references, dist_type)
            if knn_engine is not None:
                log.info("Using on-device kNN engine")
                if dist_type.coreacc:
                    rows = knn_engine.cross_knn_coreacc(
                        queries, nn, ref_completeness_vec=ref_comp,
                        query_completeness_vec=q_comp,
                        completeness_cutoff=cutoff)
                else:
                    rows = knn_engine.cross_knn(
                        queries, nn, dist_type, ref_completeness_vec=ref_comp,
                        query_completeness_vec=q_comp,
                        completeness_cutoff=cutoff)
            else:
                rows = api.cross_dists_knn(references, queries, nn, dist_type,
                                           ref_comp, q_comp, cutoff,
                                           engine=engine)
            dist_output.write_sparse(out, qnames, names, rows,
                                     dist_type.coreacc)
        else:
            ca_engine = stream_engine = None
            if dist_type.coreacc:
                # correction applies only when BOTH sides have values
                # (jaccard.rs:36-42)
                both = ref_comp is not None and q_comp is not None
                ca_engine = select_coreacc_engine(
                    references, ref_comp if both else None, cutoff,
                    exact=args.exact)
            else:
                stream_engine = select_dense_stream_engine(references,
                                                           dist_type)
            # ref-vs-query dense rows are references: uni_rows
            if stream_engine is not None:
                log.info("Using on-device dense streaming engine")
                stream_engine.stream_cross_dense(
                    out, names, qnames, queries, dist_type, ref_comp, q_comp,
                    cutoff, row_range=uni_rows)
            elif ca_engine is not None:
                log.info("Using on-device core/accessory %s engine (cross)",
                         "exact-stream" if args.exact else "tile")
                ca_engine.stream_cross_dense(
                    out, names, qnames, queries, rcomp=ref_comp,
                    qcomp=q_comp, cutoff=cutoff, row_range=uni_rows)
            else:
                d = api.cross_dists_all(references, queries, dist_type,
                                        ref_comp, q_comp, cutoff,
                                        engine=engine, row_range=uni_rows)
                dist_output.write_dense_cross(out, row_names, qnames, d,
                                              dist_type.coreacc)
        log_pair_rate((n if args.knn is not None else len(row_names))
                      * len(qnames))
    if out is not sys.stdout:
        out.close()


def _merge_main(args) -> None:
    from .formats import skd as skd_io
    from .formats.skm import MultiSketch

    db1 = strip_sketch_extension(args.db1)
    db2 = strip_sketch_extension(args.db2)
    sketches1 = MultiSketch.load_metadata(db1)
    sketches2 = MultiSketch.load_metadata(db2)
    diffs = sketches1.incompatibilities(sketches2)
    if diffs:
        raise SystemExit(
            "Databases are not compatible for merging: " + "; ".join(diffs)
        )
    merged = sketches1.merge_sketches(sketches2)
    merged.save_metadata(args.output)
    with open(f"{args.output}.skd", "wb") as out_f:
        skd_io.append_skd(f"{db1}.skd", out_f)
        skd_io.append_skd(f"{db2}.skd", out_f)


def _append_main(args) -> None:
    from .formats import skd as skd_io
    from .formats.skm import MultiSketch
    from .ingest import inputs as io_inputs
    from .runtime import select_backend
    from .sketchcore.pipeline import sketch_files
    from .sketchcore.sketch import HashType

    input_files = io_inputs.get_input_list(args.file_list, args.seq_files or None)
    db_metadata = MultiSketch.load_metadata(strip_sketch_extension(args.db))
    if not db_metadata.append_compatibility(input_files):
        raise SystemExit("Databases are not compatible for merging.")
    kmers = db_metadata.kmer_lengths
    sketch_size = db_metadata.sketch_size
    seq_type = db_metadata.hash_type
    if seq_type.kind == "aa":
        seq_type = HashType("aa", _level_num(args.level))
    db2_sketches = sketch_files(
        args.output,
        input_files,
        args.concat_fasta,
        kmers,
        sketch_size,
        seq_type,
        not args.single_strand,
        args.min_count,
        args.min_qual,
        threads=args.threads,
        backend=select_backend(seq_type, len(input_files)),
    )
    db2_metadata = MultiSketch(db2_sketches, sketch_size, kmers, seq_type)
    with open(f"{args.output}.skd", "ab") as out_f:
        skd_io.append_skd(f"{strip_sketch_extension(args.db)}.skd", out_f)
    db2_metadata.merge_sketches(db_metadata).save_metadata(args.output)


def _delete_samples(ms, ref_db: str, output_file: str, ids: list[str]) -> None:
    """Delete flow (lib.rs:879-908 + multisketch.rs:269-348): filter the
    metadata, then rewrite the .skd keeping non-deleted positions. The
    surviving sketches are re-indexed to their compacted .skd rows, so the
    output equals a direct sketch of the remainder (the reference keeps the
    old name_map and indices, leaving its output inconsistent)."""
    from .formats import skd as skd_io

    removed = set()
    new_meta = []
    for sketch in ms.sketch_metadata:
        if sketch.name in ids:
            removed.add(sketch.name)
        else:
            new_meta.append(sketch)
    missing = [i for i in ids if i not in removed]
    if missing:
        raise SystemExit(
            f"The following samples have not been found in the database: {missing!r}"
        )
    positions = {ms.name_map[i] for i in ids}
    keep = [idx for idx in range(len(ms.sketch_metadata)) if idx not in positions]
    for new_idx, sketch in enumerate(new_meta):
        sketch.index = new_idx
    ms.sketch_metadata = new_meta
    ms.name_map = {s.name: s.index for s in new_meta}
    ms.save_metadata(output_file)
    data = skd_io.read_skd_batch(f"{ref_db}.skd", keep, ms.sample_stride)
    with skd_io.SketchDataWriter(f"{output_file}.skd") as w:
        for i in range(len(keep)):
            w.write_sketch(data[i * ms.sample_stride : (i + 1) * ms.sample_stride])


def _ostream(path):
    return open(path, "w") if path else sys.stdout


def _inverted_main(args) -> None:
    from .ingest import inputs as io_inputs
    from .inverted.index import Inverted
    from .runtime import select_backend, select_inverted_engine
    from .sketchcore.sketch import HashType

    if args.inverted_command == "build":
        from .progress import progress_printer

        input_files = io_inputs.get_input_list(args.file_list,
                                               args.seq_files or None)
        log.info("Parsed %d samples in input list", len(input_files))
        distinct = {name for name, _ in input_files}
        if args.species_names:
            file_order, map_names_labels = io_inputs.reorder_input_files(
                input_files, args.species_names
            )
        else:
            names = [name for name, _ in input_files]
            if len(distinct) == len(input_files):
                file_order, map_names_labels = list(range(len(input_files))), None
            else:
                idx_map: dict[str, int] = {}
                for name in names:
                    if name not in idx_map:
                        idx_map[name] = len(idx_map)
                file_order, map_names_labels = [idx_map[n] for n in names], None
        labels_vec = None
        if map_names_labels is not None:
            labels_vec = [""] * len(distinct)
            for idx, (name, _f) in zip(file_order, input_files):
                labels_vec[idx] = map_names_labels.get(name, "")
        metadata_vec = None
        if args.metadata:
            md = io_inputs.parse_metadata_info(args.metadata)
            metadata_vec = [""] * len(distinct)
            for idx, (name, _f) in zip(file_order, input_files):
                metadata_vec[idx] = md[name]
        proc_id, n_proc, multiproc = _resolve_ranks(args)
        if multiproc:
            _inverted_build_ranks(args, input_files, file_order, metadata_vec,
                                  labels_vec, proc_id, n_proc)
            return
        tick, finish = progress_printer(len(input_files), args.quiet,
                                        "Sketching ")
        inv = Inverted.build(
            input_files,
            file_order,
            args.kmer_length,
            args.sketch_size,
            not args.single_strand,
            args.min_count,
            args.min_qual,
            write_skq=f"{args.output}.skq" if args.write_skq else None,
            metadata=metadata_vec,
            labels=labels_vec,
            hash_type=HashType("dna"),
            backend=select_backend(HashType("dna"), len(input_files)),
            threads=args.threads,
            progress=tick,
        )
        finish()
        inv.save(args.output)
        log.info("Index info:\n%s", inv.debug_str())

    elif args.inverted_command == "query":
        proc_id, n_proc, multiproc = _resolve_ranks(args)
        if multiproc and args.output:
            from .shard.distributed import shard_prefix

            args.output = shard_prefix(args.output, proc_id)
            log.info("Multi-process query: rank %d/%d writing %s", proc_id,
                     n_proc, args.output)
        out = _ostream(args.output)
        inv = Inverted.load(strip_sketch_extension(args.ski))
        input_files = io_inputs.get_input_list(args.file_list,
                                               args.seq_files or None)
        if multiproc:
            from .shard.distributed import process_slice

            input_files = input_files[process_slice(len(input_files), proc_id,
                                                    n_proc)]
        queries, query_names = inv.sketch_queries(
            input_files,
            args.min_count,
            args.min_qual,
            backend=select_backend(HashType("dna"), len(input_files)),
            threads=args.threads,
        )
        engine = select_inverted_engine(inv)
        batch_counts = batch_any = None
        if engine is not None:
            if args.query_type == "match-count":
                batch_counts = engine.match_counts(queries)
            elif args.query_type == "any-bins":
                batch_any = engine.any_shared_rows(queries)
            else:
                batch_any = engine.all_shared_rows(queries)
        if proc_id == 0:  # the header once, in the first part
            out.write("Query")
            if args.query_type == "match-count":
                for name in inv.sample_names:
                    out.write(f"\t{name}")
                out.write("\n")
            else:
                out.write("\tMatches\n")
        for qi, q_name in enumerate(query_names):
            q = queries[qi]
            out.write(q_name)
            if args.query_type == "match-count":
                counts = (batch_counts[qi] if batch_counts is not None
                          else inv.query_match_count(q))
                out.write("\t" + "\t".join(str(int(c)) for c in counts))
            else:
                if batch_any is not None:
                    hits = np.flatnonzero(batch_any[qi])
                elif args.query_type == "all-bins":
                    hits = inv.all_shared_bins(q)
                else:
                    hits = inv.any_shared_bins(q)
                if hits.size:
                    out.write("\t" + ",".join(inv.sample_names[int(h)]
                                              for h in hits))
            out.write("\n")
        if out is not sys.stdout:
            out.close()

    elif args.inverted_command == "serve":
        from .inverted.serve import serve_forever

        inv = Inverted.load(strip_sketch_extension(args.ski))
        serve_forever(inv, args.host, args.port,
                      backend=select_backend(HashType("dna"), 1),
                      engine=select_inverted_engine(inv))

    elif args.inverted_command == "precluster":
        _precluster_main(args)


def _inverted_build_ranks(args, input_files, file_order, metadata_vec,
                          labels_vec, proc_id, n_proc) -> None:
    """This rank's slice of the sample rows into a shard; rank 0 merges
    with the global metadata and labels (byte-identical to a
    single-process build)."""
    from .shard import distributed
    from .sketchcore.sketch import HashType

    distributed.inverted_build_shard(
        args.output, input_files, file_order, proc_id, n_proc,
        k=args.kmer_length, sketch_size=args.sketch_size,
        rc=not args.single_strand, min_count=args.min_count,
        min_qual=args.min_qual, write_skq=args.write_skq,
        hash_type=HashType("dna"), threads=args.threads,
    )
    inv = _merge_on_rank0(
        args.output, proc_id, n_proc, ".ski",
        lambda: distributed.merge_inverted_shards(
            args.output, n_proc, metadata=metadata_vec, labels=labels_vec,
            write_skq=args.write_skq),
        "merge_inverted_shards")
    if inv is not None:
        log.info("Index info:\n%s", inv.debug_str())


def _precluster_main(args) -> None:
    from .dist import api
    from .dist import output as dist_output
    from .formats import skd as skd_io
    from .formats.skm import MultiSketch
    from .ingest import inputs as io_inputs
    from .inverted.index import Inverted
    from .runtime import select_engine, select_knn_engine

    if args.count and args.skd:
        # clap: the "mode" ArgGroup is exclusive (cli.rs:416-420)
        raise SystemExit("--count and --skd are mutually exclusive")
    if args.count and args.core_acc:
        raise SystemExit("--core-acc needs --skd, not --count")
    input_prefix = strip_sketch_extension(args.ski)
    with spans.span("load"):
        inv = Inverted.load(input_prefix)
    if not args.count and not args.skd:
        raise SystemExit("one of --skd or --count is required")
    proc_id, n_proc, multiproc = _resolve_ranks(args)
    if args.count:
        _count_main(inv, proc_id, n_proc, multiproc)
        return
    if multiproc and args.output:
        from .shard.distributed import shard_prefix

        args.output = shard_prefix(args.output, proc_id)
        log.info("Multi-process precluster: rank %d/%d writing %s", proc_id,
                 n_proc, args.output)
    out = _ostream(args.output)
    ref_name = strip_sketch_extension(args.skd)
    with spans.span("load"):
        with spans.span("load.skq"):
            skq_bins = skd_io.read_all_skq(f"{input_prefix}.skq")
            spans.count("bytes", skq_bins.nbytes)
        references = MultiSketch.load_metadata(ref_name)
        references.read_sketch_data(ref_name)
    n = references.number_samples_loaded()
    knn = args.knn
    if knn >= n:
        log.warning("knn=%d is higher than number of samples=%d", knn, n)
        knn = n - 1
    if args.core_acc:
        # extension: the reference leaves core/accessory precluster
        # unimplemented (distances/mod.rs:548-550)
        if args.ani:
            raise SystemExit("--core-acc and --ani are mutually exclusive")
        if len(references.kmer_lengths) < 2:
            raise SystemExit(
                "--core-acc needs at least two k-mer lengths in the .skd")
        # the k-mer of the prefilter must still exist in the .skd
        api.set_k(references, inv.kmer_size, False)
        dist_type = api.DistType()
        log.info("Preclustering with k=%d, ranking by core/accessory over "
                 "k=%s", inv.kmer_size, references.kmer_lengths)
    else:
        dist_type = api.set_k(references, inv.kmer_size, args.ani)
    ref_comp = (
        io_inputs.read_completeness_file(args.ref_completeness_file,
                                         references)
        if args.ref_completeness_file
        else None
    )
    pc_rows = None
    if multiproc:
        from .shard.distributed import process_slice

        pc_rows = process_slice(n, proc_id, n_proc)
    knn_engine = select_knn_engine(references, dist_type)
    if knn_engine is not None:
        log.info("Using on-device preclustered kNN engine")
        rows = knn_engine.precluster_knn(
            inv, skq_bins, knn, dist_type, args.retain_unmatched,
            row_range=pc_rows, completeness_vec=ref_comp,
            completeness_cutoff=args.completeness_cutoff,
        )
    else:
        rows = api.self_dists_knn_precluster(
            references, inv, skq_bins, inv.sketch_size, knn, dist_type,
            ref_comp, args.completeness_cutoff, args.retain_unmatched,
            engine=select_engine(references), row_range=pc_rows,
        )
    names = [references.sketch_name(i) for i in range(n)]
    dist_output.write_sparse(out,
                             names[pc_rows] if pc_rows is not None else names,
                             names, rows, coreacc=dist_type.coreacc)
    if out is not sys.stdout:
        out.close()


def _count_main(inv, proc_id: int, n_proc: int, multiproc: bool) -> None:
    """`precluster --count`: a rank counts the pairs whose first sample is
    in its block of the upper triangle's rows; when a process group spans
    the ranks their partials are summed and rank 0 prints the total, else
    each rank prints its partial."""
    from .runtime import select_inverted_engine
    from .shard import distributed

    n = len(inv.sample_names)
    row_range = (distributed.triangle_row_slice(n, proc_id, n_proc)
                 if multiproc else None)
    count = inv.any_shared_bin_count(engine=select_inverted_engine(inv),
                                     row_range=row_range)
    line = None
    if not multiproc:
        line = (f"Identified {count} prefilter pairs from a max of "
                f"{n * (n - 1) // 2}")
    elif distributed.spans(n_proc):
        count = distributed.allgather_sum(count)
        if proc_id == 0:
            line = (f"Identified {count} prefilter pairs from a max of "
                    f"{n * (n - 1) // 2}")
    else:
        line = (f"Identified {count} prefilter pairs in rows "
                f"[{row_range.start}, {row_range.stop}) of {n} (rank "
                f"{proc_id}/{n_proc} partial; sum ranks for the total)")
    if line is not None:
        with spans.span("write"):
            print(line)
            spans.count("bytes", len(line) + 1)


def _info_main(args) -> None:
    from .formats.skm import MultiSketch
    from .inverted.index import Inverted

    name = args.skm_file
    if name.endswith(".ski"):
        inv = Inverted.load(name[:-4])
        print(inv.display_str() if args.sample_info else inv.debug_str())
    else:
        ms = MultiSketch.load_metadata(strip_sketch_extension(name))
        print(ms.display_str() if args.sample_info else ms.debug_str())
