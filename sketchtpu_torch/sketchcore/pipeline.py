"""sketch_files: the batch sketching pipeline driving ingest -> hashing ->
sign extraction -> .skd writing.

Unlike the reference's rayon + mpsc + serial-writer arrangement
(src/sketch/mod.rs:283-394), samples are written in deterministic input
order; ingest/hashing is parallelised over a host thread pool, and the
hash/bin compute can run on the device backends (sketch_torch) in batches.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor

from ..formats.skd import SketchDataWriter
from ..ingest.fastx import aa_stream_from_string, read_aa_sample, read_dna_sample
from .sketch import HashType, Sketch, sketch_aa_sample, sketch_dna_sample

log = logging.getLogger("sketchtpu")


def sketch_files(
    output_prefix: str,
    input_files: list[tuple[str, list[str]]],
    concat_fasta: bool,
    kmers: list[int],
    sketch_bins: int,
    seq_type: HashType,
    rc: bool,
    min_count: int,
    min_qual: int,
    threads: int = 1,
    backend=None,
    progress=None,
    convert_pdb: bool = False,
) -> list[Sketch]:
    """Sketch every input sample and write {output_prefix}.skd.

    Returns the sketch metadata list (with .skd indices assigned, usigs
    dropped). `backend` optionally provides a batched device sketcher: for
    DNA its `sketch_dna_streams(streams, names, kmers, sketch_bins, rc,
    min_count, threads)`, for AA/3Di its `sketch_aa_streams(streams, names,
    kmers, sketch_bins, level, rc)`.
    """
    if concat_fasta and seq_type.kind in ("dna", "pdb"):
        raise ValueError("--concat-fasta currently only supported with --seq-type aa")
    split = concat_fasta and seq_type.kind == "aa"
    level = seq_type.level if seq_type.kind == "aa" else 1

    def sample_streams(name, files, threads=1):
        """The streams of one input sample (one per record with
        --concat-fasta) and their sketch names."""
        if seq_type.kind == "dna":
            return [read_dna_sample(files, min_qual, threads=threads)], [name]
        if seq_type.kind == "pdb":  # 3Di sequences, hashed as AA level 1
            streams = _pdb_streams(name, files, convert_pdb)
        else:
            streams = read_aa_sample(files, split)
        if split:
            return streams, [f"{name}_{i + 1}" for i in range(len(streams))]
        return streams, [name] * len(streams)

    def build_sample(name_files):
        name, files = name_files
        streams, names = sample_streams(name, files)
        out = []
        for stream, sample_name in zip(streams, names):
            if stream.seq_len == 0:
                raise ValueError(f"{sample_name} has no valid sequence")
            if seq_type.kind == "dna":
                out.append(sketch_dna_sample(stream, sample_name, kmers,
                                             sketch_bins, rc, min_count))
            else:
                out.append(sketch_aa_sample(stream, sample_name, kmers,
                                            sketch_bins, level, rc))
        return out

    sketches: list[Sketch] = []
    with SketchDataWriter(f"{output_prefix}.skd") as writer:
        if backend is not None:
            # Device-batched path: parse on host threads, hash/bin on the card.
            # Inputs are processed in chunks with one chunk of parse-ahead,
            # so host memory stays bounded (~2 chunks of decoded streams)
            # and parsing chunk i+1 overlaps device compute on chunk i —
            # the streaming analogue of the reference's rayon producers
            # feeding a serial writer (sketch/mod.rs:318-391).
            chunks = _chunk_inputs(input_files)
            with ThreadPoolExecutor(max_workers=max(threads, 1)) as io_pool:
                with ThreadPoolExecutor(max_workers=1) as ahead:

                    def parse_chunk(chunk):
                        # threads split across samples first; leftover
                        # workers parallelise WITHIN each large FASTA
                        per_file = max(1, threads // max(1, len(chunk)))
                        return list(
                            io_pool.map(
                                lambda nf: sample_streams(
                                    nf[0], nf[1], threads=per_file
                                ),
                                chunk,
                            )
                        )

                    fut = ahead.submit(parse_chunk, chunks[0]) if chunks else None
                    for ci, chunk in enumerate(chunks):
                        parsed = fut.result()
                        fut = (
                            ahead.submit(parse_chunk, chunks[ci + 1])
                            if ci + 1 < len(chunks)
                            else None
                        )
                        streams = [s for ss, _ in parsed for s in ss]
                        names = [n for _, nn in parsed for n in nn]
                        for name, stream in zip(names, streams):
                            if stream.seq_len == 0:
                                raise ValueError(f"{name} has no valid sequence")
                        if seq_type.kind == "dna":
                            batch = backend.sketch_dna_streams(
                                streams, names, kmers, sketch_bins, rc,
                                min_count, threads=threads,
                            )
                        else:
                            batch = backend.sketch_aa_streams(
                                streams, names, kmers, sketch_bins, level, rc
                            )
                        # progress ticks once per input sample, not per
                        # sketch (--concat-fasta makes one per record)
                        emitted = 0
                        for ss, _ in parsed:
                            for sketch in batch[emitted : emitted + len(ss)]:
                                sketch.index = writer.write_sketch(sketch.usigs)
                                sketch.usigs = None
                                sketches.append(sketch)
                            emitted += len(ss)
                            if progress is not None:
                                progress()
            return sketches

        if threads > 1:
            with ThreadPoolExecutor(max_workers=threads) as pool:
                results = pool.map(build_sample, input_files)
                for sample_sketches in results:
                    for sketch in sample_sketches:
                        sketch.index = writer.write_sketch(sketch.usigs)
                        sketch.usigs = None
                        sketches.append(sketch)
                    if progress is not None:
                        progress()
        else:
            for name_files in input_files:
                for sketch in build_sample(name_files):
                    sketch.index = writer.write_sketch(sketch.usigs)
                    sketch.usigs = None
                    sketches.append(sketch)
                if progress is not None:
                    progress()
    return sketches


# Device-path chunking: bounds on samples and on-disk bytes per chunk.
# Big enough that device groups (<=96 samples / 16M bases) never straddle
# a chunk boundary in a way that matters; small enough that two chunks of
# decoded streams fit comfortably in host RAM.
_CHUNK_SAMPLES = 512
_CHUNK_FILE_BYTES = 1 << 30


def _chunk_inputs(
    input_files: list[tuple[str, list[str]]],
) -> list[list[tuple[str, list[str]]]]:
    """Split the input list into parse chunks by sample count and summed
    (compressed, on-disk) file size."""
    import os

    chunks: list[list[tuple[str, list[str]]]] = []
    cur: list[tuple[str, list[str]]] = []
    cur_bytes = 0
    for nf in input_files:
        size = 0
        for f in nf[1]:
            try:
                size += os.path.getsize(f)
            except OSError:
                pass
        if cur and (
            len(cur) >= _CHUNK_SAMPLES or cur_bytes + size > _CHUNK_FILE_BYTES
        ):
            chunks.append(cur)
            cur = []
            cur_bytes = 0
        cur.append(nf)
        cur_bytes += size
    if cur:
        chunks.append(cur)
    return chunks



def _pdb_streams(name: str, files: list[str], convert_pdb: bool):
    """3Di streams for one sample: from .pdb via mini3di when convert_pdb
    (sketch/mod.rs:301-306), else the files already hold 3Di text."""
    if convert_pdb:
        from ..ingest.pdb3di import pdb_to_3di

        # one sample = one 3Di stream; chains/files join on ',' (an invalid
        # aa byte, so it breaks hash windows like the reference's comma join)
        joined = ",".join(pdb_to_3di(name, f) for f in files)
        return [aa_stream_from_string(joined)]
    return read_aa_sample(files, False)
