"""Input list / auxiliary file parsing (rfiles, subsets, completeness,
species labels, metadata; from sketchlib.rust src/io.rs)."""

from __future__ import annotations

import logging
import re

log = logging.getLogger("sketchtpu")

# Matches the file name (with fastx extension) at the end of a path
# (io.rs:22-27). Note the captured "name" keeps the extension.
_RE_PATH = re.compile(
    r"^.+/(.+\.(fa|fasta|fa\.gz|fasta\.gz|fastq|fastq\.gz|fq|fq\.gz))$"
)
_RE_NAME = re.compile(
    r"^(.+\.(fa|fasta|fa\.gz|fasta\.gz|fastq|fastq\.gz|fq|fq\.gz))$"
)


def read_input_fastas(seq_files: list[str]) -> list[tuple[str, list[str]]]:
    out = []
    for path in seq_files:
        m = _RE_PATH.match(path) or _RE_NAME.match(path)
        name = m.group(1) if m else path
        out.append((name, [path]))
    return out


def get_input_list(
    file_list: str | None, seq_files: list[str] | None
) -> list[tuple[str, list[str]]]:
    """rfile lines: 1 col = file (name = file); 2 cols = name, file;
    3+ cols = name, files... (io.rs:182-224)."""
    if file_list is None and seq_files is None:
        # clap: the "input" ArgGroup is required (cli.rs:121-126)
        raise SystemExit(
            "error: provide input FASTA files or -f FILE_LIST"
        )
    if file_list is not None and seq_files:
        # clap: "input" group members are mutually exclusive
        raise SystemExit(
            "error: positional sequence files and -f FILE_LIST are "
            "mutually exclusive"
        )
    if file_list is not None:
        out = []
        with open(file_list) as f:
            for line in f:
                fields = line.split()
                if not fields:
                    raise ValueError("Unable to parse line in file_list")
                if len(fields) == 1:
                    out.append((fields[0], [fields[0]]))
                else:
                    out.append((fields[0], fields[1:]))
        return out
    return read_input_fastas(seq_files)


def parse_kmers(k_vals, k_seq) -> list[int]:
    if k_vals is not None and k_seq is not None:
        raise ValueError("Only one of --k-vals or --k-seq should be specified")
    if k_vals is not None:
        kmers = list(k_vals)
    elif k_seq is not None:
        start, end, step = k_seq
        kmers = list(range(start, end + 1, step))
    else:
        raise ValueError("Must specify --k-vals or --k-seq")
    kmers.sort()
    if not all(k >= 3 for k in kmers):
        raise ValueError("K-mers must be >=3")
    return kmers


def read_subset_names(subset_file: str) -> list[str]:
    with open(subset_file) as f:
        return [line.rstrip("\n") for line in f]


def read_completeness_file(completeness_file: str, ms) -> list[float]:
    """genome_id<tab>completeness in [0,1]; percentages rejected with the
    offender list; missing genomes default to 1.0 (io.rs:240-324)."""
    n = ms.number_samples_loaded()
    completeness_vec = [1.0] * n
    out_of_range = []
    not_in_sketch = []
    updates = []
    with open(completeness_file) as f:
        for line in f:
            line = line.rstrip("\n")
            if "\t" not in line:
                continue
            genome_id, _, completeness_str = line.partition("\t")
            try:
                completeness = float(completeness_str.strip())
            except ValueError:
                log.warning(
                    "Could not parse completeness value for '%s': '%s' — skipping",
                    genome_id,
                    completeness_str,
                )
                continue
            if not (0.0 <= completeness <= 1.0):
                out_of_range.append(f"{genome_id}: {completeness:g}")
                continue
            index = ms.get_sample_index(genome_id)
            if index is not None:
                updates.append((index, completeness))
            else:
                not_in_sketch.append(genome_id)
    if out_of_range:
        raise ValueError(
            "Completeness values must be in [0.0, 1.0], not percentages. "
            f"Found {len(out_of_range)} out-of-range value(s) in "
            f"{completeness_file}:\n  " + "\n  ".join(out_of_range)
        )
    matched = [False] * n
    for index, completeness in updates:
        completeness_vec[index] = completeness
        matched[index] = True
    if not_in_sketch:
        log.warning(
            "%d genome(s) in completeness file not found in sketch database "
            "(ignored): %s",
            len(not_in_sketch),
            ", ".join(not_in_sketch),
        )
    missing = [ms.sketch_name(i) for i, m in enumerate(matched) if not m]
    if missing:
        log.warning(
            "%d genome(s) not found in completeness file, using default 1.0: %s",
            len(missing),
            ", ".join(missing),
        )
    return completeness_vec


def reorder_input_files(input_files, species_name_file: str):
    """Reorder samples so equal labels are adjacent (io.rs:40-115).

    Returns (sample_order, name->label map or None). sample_order[i] is the
    index the i-th input sample should take.
    """
    input_names = {name for name, _ in input_files}
    species_labels: dict[str, int] = {}
    map_names_labels: dict[str, str] = {}
    label_order: list[tuple[str, int]] = []
    order_idx = 0
    with open(species_name_file) as f:
        for lineno, line in enumerate(f, 1):
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 2:
                raise ValueError(
                    f"{species_name_file}:{lineno}: expected "
                    f"'sample\\tspecies', got {line.rstrip()!r}"
                )
            if fields[0] in input_names:
                if fields[0] in map_names_labels:
                    # a repeated sample row would otherwise claim two
                    # output indices, colliding with the fallthrough
                    # new_idx assignment below (the reference's version
                    # has exactly that collision — first row wins here)
                    continue
                if fields[1] in species_labels:
                    label_order.append((fields[0], species_labels[fields[1]]))
                else:
                    species_labels[fields[1]] = order_idx
                    label_order.append((fields[0], order_idx))
                    order_idx += 1
            map_names_labels[fields[0]] = fields[1]
    log.info(
        "%d samples with %d unique labels", len(label_order), len(species_labels)
    )
    label_order.sort(key=lambda kv: kv[1])
    reordered = {name: idx for idx, (name, _) in enumerate(label_order)}
    if not reordered:
        log.warning("Could not find any sample names in %s", species_name_file)
        return list(range(len(input_files))), None
    sample_order = []
    new_idx = len(reordered) - 1
    for name, _files in input_files:
        if name in reordered:
            sample_order.append(reordered[name])
        else:
            new_idx += 1
            sample_order.append(new_idx)
    return sample_order, map_names_labels


def parse_metadata_info(metadata_file: str) -> dict[str, str]:
    out: dict[str, str] = {}
    with open(metadata_file) as f:
        for lineno, line in enumerate(f, 1):
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 2:
                raise ValueError(
                    f"{metadata_file}:{lineno}: expected "
                    f"'sample\\tmetadata', got {line.rstrip()!r}"
                )
            if fields[0] in out:
                raise ValueError("Some entry in metadata is duplicated")
            out[fields[0]] = fields[1]
    return out
