"""sketch_files: the batch sketching pipeline driving ingest -> hashing ->
sign extraction -> .skd writing.

Unlike the reference's rayon + mpsc + serial-writer arrangement
(src/sketch/mod.rs:283-394), samples are written in deterministic input
order; ingest/hashing is parallelised over a host thread pool, and the
hash/bin compute can run on the device backend (sketch_torch) in batches.
DNA only: AA and 3Di input is not ported yet.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor

from ..formats.skd import SketchDataWriter
from ..ingest.fastx import read_dna_sample
from .sketch import HashType, Sketch, sketch_dna_sample

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
) -> list[Sketch]:
    """Sketch every input sample and write {output_prefix}.skd.

    Returns the sketch metadata list (with .skd indices assigned, usigs
    dropped). `backend` optionally provides a batched device sketcher with a
    `sketch_dna_streams(streams, kmers, sketch_bins, rc)` method.
    """
    if seq_type.kind != "dna":
        raise NotImplementedError(
            "AA/3Di sketching is not ported to sketchtpu_torch yet (ROADMAP "
            "queue 1 item 7)"
        )
    if concat_fasta:
        raise ValueError("--concat-fasta currently only supported with --seq-type aa")

    def build_sample(name_files):
        name, files = name_files
        stream = read_dna_sample(files, min_qual)
        if stream.seq_len == 0:
            raise ValueError(f"{name} has no valid sequence")
        return [sketch_dna_sample(stream, name, kmers, sketch_bins, rc, min_count)]

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
                                lambda nf: read_dna_sample(
                                    nf[1], min_qual, threads=per_file
                                ),
                                chunk,
                            )
                        )

                    fut = ahead.submit(parse_chunk, chunks[0]) if chunks else None
                    for ci, chunk in enumerate(chunks):
                        streams = fut.result()
                        fut = (
                            ahead.submit(parse_chunk, chunks[ci + 1])
                            if ci + 1 < len(chunks)
                            else None
                        )
                        for (name, _files), stream in zip(chunk, streams):
                            if stream.seq_len == 0:
                                raise ValueError(f"{name} has no valid sequence")
                        batch = backend.sketch_dna_streams(
                            streams,
                            [name for name, _ in chunk],
                            kmers,
                            sketch_bins,
                            rc,
                            min_count,
                            threads=threads,
                        )
                        for sketch in batch:
                            sketch.index = writer.write_sketch(sketch.usigs)
                            sketch.usigs = None
                            sketches.append(sketch)
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

