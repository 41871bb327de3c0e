"""Multi-process runs: one rank per GPU (or per host), over torch.distributed.

As in the JAX package's shard/distributed.py, the work is split, never
reduced: each rank sketches a contiguous slice of the input list into a
`.partN` shard (rank 0 concatenates them byte-identically to a
single-process sketch), or computes a block of output rows against every
column and writes `OUTPUT.partN`; the parts concatenate in rank order into
the single-process file. The only collectives are a barrier before a
rank-0 merge and the sum of the ranks' `precluster --count` partials: both
carry host values, so the process group is gloo's, which also takes several
ranks on one GPU (NCCL refuses that).

Ranks come from torchrun's environment (WORLD_SIZE, RANK, MASTER_ADDR,
MASTER_PORT, and LOCAL_RANK for the GPU), or from the CLI's
--process-id/--n-processes flags, where no process group exists and the
caller orchestrates the ranks and the merge.
"""

from __future__ import annotations

import atexit
import datetime
import os

TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")
# a rank that dies leaves the others waiting in a collective this long at
# most (ranks wait in the barrier for the slowest rank's shard)
TIMEOUT = datetime.timedelta(hours=2)


def torchrun_env() -> bool:
    """Whether torchrun's rendezvous variables are all set."""
    return all(os.environ.get(v) for v in TORCHRUN_ENV)


def init_distributed() -> tuple[int, int]:
    """Join the gloo process group that torchrun's environment describes
    (once per process; later calls reuse it) and return (rank, world size).
    In cuda mode the rank's GPU, LOCAL_RANK modulo the GPUs, becomes the
    current device. Without that environment: (0, 1), no group."""
    import torch.distributed as dist

    from ..runtime import device

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if not torchrun_env():
        return 0, 1
    dist.init_process_group("gloo", init_method="env://", timeout=TIMEOUT)
    atexit.register(_destroy)
    device()  # selects the rank's GPU in cuda mode
    return dist.get_rank(), dist.get_world_size()


def _destroy() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def spans(n_proc: int) -> bool:
    """Whether a process group of exactly n_proc ranks exists (torchrun),
    as opposed to ranks that the caller orchestrates by the CLI's flags."""
    import torch.distributed as dist

    return dist.is_initialized() and dist.get_world_size() == n_proc


def barrier() -> None:
    """Wait for every rank of the process group."""
    import torch.distributed as dist

    dist.barrier()


def allgather_sum(value: int) -> int:
    """The sum over the ranks of each rank's integer, on every rank."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return int(t.item())


def process_slice(n_items: int, process_index: int, process_count: int) -> slice:
    """Contiguous near-equal split of n_items over processes (first
    n_items % process_count processes take one extra)."""
    base = n_items // process_count
    extra = n_items % process_count
    start = process_index * base + min(process_index, extra)
    length = base + (1 if process_index < extra else 0)
    return slice(start, start + length)


def shard_prefix(output_prefix: str, process_index: int) -> str:
    return f"{output_prefix}.part{process_index}"


def triangle_row_slice(
    n: int, process_index: int, process_count: int
) -> slice:
    """Row range for one process of an upper-triangle self-distance run,
    balanced by pair count (row i carries n-1-i pairs, so equal row counts
    would leave the first rank with ~2x the work). Concatenating the ranks'
    long-form outputs in rank order reproduces the single-process file.
    The float64 cumulative count and its searchsorted are the JAX
    package's, so both split the rows alike."""
    import numpy as np

    if n == 0:
        return slice(0, 0)
    cum = np.arange(n + 1, dtype=np.float64)
    cum = cum * n - cum * (cum + 1) / 2  # pairs in rows [0, i)
    total = cum[-1]
    lo = int(np.searchsorted(cum, total * process_index / process_count))
    hi = int(np.searchsorted(cum, total * (process_index + 1) / process_count))
    if process_index == process_count - 1:
        hi = n
    return slice(min(lo, n), min(hi, n))


def sketch_shard(
    output_prefix: str,
    input_files: list,
    process_index: int,
    process_count: int,
    *,
    concat_fasta: bool,
    kmers: list[int],
    sketch_bins: int,
    seq_type,
    rc: bool,
    min_count: int,
    min_qual: int,
    threads: int = 1,
    convert_pdb: bool = False,
) -> str:
    """Sketch this process's slice of the input list into
    {output_prefix}.part{i}.skd/.skm. Returns the shard prefix."""
    from ..formats.skm import MultiSketch
    from ..runtime import select_backend
    from ..sketchcore.pipeline import sketch_files

    sl = process_slice(len(input_files), process_index, process_count)
    part = input_files[sl]
    prefix = shard_prefix(output_prefix, process_index)
    sketches = sketch_files(
        prefix,
        part,
        concat_fasta,
        kmers,
        sketch_bins,
        seq_type,
        rc,
        min_count,
        min_qual,
        threads=threads,
        backend=select_backend(seq_type, len(part)),
        convert_pdb=convert_pdb,
    )
    MultiSketch(sketches, sketch_bins, kmers, seq_type).save_metadata(prefix)
    return prefix


def _concat(out_path: str, part_paths) -> None:
    with open(out_path, "wb") as out:
        for path in part_paths:
            with open(path, "rb") as f:
                while chunk := f.read(1 << 24):
                    out.write(chunk)


def merge_shards(output_prefix: str, process_count: int):
    """Concatenate per-process shards into {output_prefix}.skd/.skm
    (rank-0 step after a barrier). Byte-identical to a single-process
    sketch of the full input list."""
    from ..formats.skm import MultiSketch

    parts = [shard_prefix(output_prefix, i) for i in range(process_count)]
    merged = MultiSketch.load_metadata(parts[0])
    for p in parts[1:]:
        merged = merged.merge_sketches(MultiSketch.load_metadata(p))
    _concat(f"{output_prefix}.skd", [f"{p}.skd" for p in parts])
    merged.save_metadata(output_prefix)
    for p in parts:
        os.remove(f"{p}.skd")
        os.remove(f"{p}.skm")
    return merged


def inverted_build_shard(
    output_prefix: str,
    input_files: list,
    file_order: list[int],
    process_index: int,
    process_count: int,
    *,
    k: int,
    sketch_size: int,
    rc: bool,
    min_count: int,
    min_qual: int,
    write_skq: bool,
    hash_type,
    threads: int = 1,
) -> str:
    """Build this process's slice of the inverted index into
    {output_prefix}.part{i}.ski (+ .skq). The slice is over DISTINCT
    sample indices (rows of the sign matrix), so multi-file samples —
    which min-combine into one row — stay whole on one rank. Returns the
    shard prefix."""
    import numpy as np

    from ..inverted.index import Inverted
    from ..runtime import select_backend

    n_distinct = (max(file_order) + 1) if file_order else 0
    sl = process_slice(n_distinct, process_index, process_count)
    pairs = [
        (idx - sl.start, f)
        for idx, f in zip(file_order, input_files)
        if sl.start <= idx < sl.stop
    ]
    part_order = [i for i, _ in pairs]
    part_files = [f for _, f in pairs]
    prefix = shard_prefix(output_prefix, process_index)
    if not part_files:  # more ranks than samples: write an empty shard
        inv = Inverted(
            sign_matrix=np.zeros((0, sketch_size), dtype=np.uint16),
            sample_names=[],
            kmer_size=k,
            rc=rc,
            hash_type=hash_type,
        )
        if write_skq:
            open(f"{prefix}.skq", "wb").close()
        inv.save(prefix)
        return prefix
    inv = Inverted.build(
        part_files,
        part_order,
        k,
        sketch_size,
        rc,
        min_count,
        min_qual,
        write_skq=f"{prefix}.skq" if write_skq else None,
        hash_type=hash_type,
        backend=select_backend(hash_type, len(part_files)),
        threads=threads,
    )
    inv.save(prefix)
    return prefix


def merge_inverted_shards(
    output_prefix: str,
    process_count: int,
    *,
    metadata=None,
    labels=None,
    write_skq: bool = False,
):
    """Concatenate per-process inverted shards into {output_prefix}.ski
    (+ .skq), byte-identical to a single-process build of the full list.
    metadata/labels are global (rank 0 computes them from the full input
    list)."""
    import numpy as np

    from ..inverted.index import Inverted

    prefixes = [shard_prefix(output_prefix, i) for i in range(process_count)]
    parts = [Inverted.load(p) for p in prefixes]
    first = parts[0]
    inv = Inverted(
        sign_matrix=np.concatenate([p.sign_matrix for p in parts]),
        sample_names=[n for p in parts for n in p.sample_names],
        kmer_size=first.kmer_size,
        rc=first.rc,
        hash_type=first.hash_type,
        metadata=metadata,
        labels=labels,
    )
    inv.save(output_prefix)
    if write_skq:
        # .skq is the row-major u16 sign stream in .ski order: parts
        # concatenate bytewise
        _concat(f"{output_prefix}.skq", [f"{p}.skq" for p in prefixes])
    for p in prefixes:
        os.remove(f"{p}.ski")
        if write_skq:
            os.remove(f"{p}.skq")
    return inv
