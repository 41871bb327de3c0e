"""sketchtpu_torch: genome sketching and distances on PyTorch and CUDA.

A port of the JAX package `sketchtpu` to an NVIDIA H100. It imports
nothing of `sketchtpu` and keeps its own copies of the host layers it
needs (constants, formats, ingest, the native helper, the f64 oracle,
output, the CLI), so the two packages meet only through `.skd/.skm/.ski/
.skq` files. It sketches DNA assemblies and reads, amino acids and 3Di,
computes dense and sparse (kNN) distances, self and ref-vs-query, builds
and queries the inverted index, and runs as several ranks (one GPU each,
shard/distributed.py). Its kernels are written by hand in CUDA C++ for
sm_90a under `csrc/`, built with nvcc into `_build/` at first use; each
has a plain PyTorch twin that runs on CPU tensors.

    python -m sketchtpu_torch sketch -o db -k 17,21,25 genome1.fa ...
    python -m sketchtpu_torch dist db [--knn 50]
    torchrun --nproc-per-node 2 -m sketchtpu_torch dist db --knn 50 -o out

This module is the library surface of the JAX package's `__init__` (the
reference's public Rust API, sketchlib.rust src/lib.rs):

    import sketchtpu_torch as st

    inputs = st.get_input_list(None, ["r1.fa.gz", "r2.fa.gz"])
    ms = st.sketch_database("db", inputs, kmers=[17, 21], sketch_size=1000)
    ms = st.load_database("db")          # .skm metadata + .skd bins
    dt = st.set_k(ms, 17, ani=False)     # single-k Jaccard (None: core/acc)
    dists = st.self_dists_all(ms, dt)    # condensed upper triangle

The distance functions here run their samebits on the card unless the
caller passes `engine` (None: the NumPy oracle): the values are the same,
since samebits are exact integers and the f64 chain runs on the host.
SKETCHTPU_TORCH_BACKEND=cuda|cpu|host selects the engines (runtime.py;
host mode selects none). Importing this package imports neither jax nor
torch.
"""

from __future__ import annotations

import functools
import inspect

from .constants import BBITS, SIGN_MOD, num_bins
from .dist import api as _api
from .dist.api import DistType, set_k
from .formats.skm import MultiSketch
from .ingest.inputs import (
    get_input_list,
    parse_kmers,
    read_completeness_file,
    read_subset_names,
)
from .inverted.index import Inverted
from .sketchcore.pipeline import sketch_files
from .sketchcore.sketch import HashType, Sketch

__version__ = "0.1.0"


def _card_engine(fn):
    """fn (a dist/api.py function whose first argument is the reference
    database) with `engine` defaulting to runtime.select_engine of it."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def call(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        if "engine" not in bound.arguments:
            from .runtime import select_engine

            bound.arguments["engine"] = select_engine(bound.args[0])
        return fn(*bound.args, **bound.kwargs)

    return call


self_dists_all = _card_engine(_api.self_dists_all)
self_dists_knn = _card_engine(_api.self_dists_knn)
cross_dists_all = _card_engine(_api.cross_dists_all)
cross_dists_knn = _card_engine(_api.cross_dists_knn)
self_dists_knn_precluster = _card_engine(_api.self_dists_knn_precluster)


def load_database(prefix: str, subset: list[str] | None = None) -> MultiSketch:
    """Load `{prefix}.skm` metadata and the `.skd` sketch bins (the whole
    file, or a subset of samples — multisketch.rs:167-210)."""
    ms = MultiSketch.load_metadata(prefix)
    if subset is None:
        ms.read_sketch_data(prefix)
    else:
        ms.read_sketch_data_block(prefix, subset)
    return ms


def sketch_database(
    output_prefix: str,
    input_files: list[tuple[str, list[str]]],
    kmers: list[int],
    sketch_size: int = 1000,
    seq_type: HashType = HashType("dna"),
    rc: bool = True,
    min_count: int = 5,
    min_qual: int = 20,
    concat_fasta: bool = False,
    threads: int = 1,
) -> MultiSketch:
    """Sketch samples and write `{prefix}.skd` + `{prefix}.skm`; returns the
    in-memory MultiSketch (metadata only — call load_database to get bins).
    Equivalent to the reference's sketch command (lib.rs:242-302): kmers are
    sorted, sketch_size is rounded up to a multiple of 64 bins. Sketches on
    the card unless SKETCHTPU_TORCH_BACKEND says otherwise."""
    from .runtime import select_backend

    kmers = sorted(kmers)
    _s64, nbins, _u = num_bins(sketch_size)
    sketches = sketch_files(
        output_prefix,
        input_files,
        concat_fasta,
        kmers,
        nbins,
        seq_type,
        rc,
        min_count,
        min_qual,
        threads=threads,
        backend=select_backend(seq_type, len(input_files)),
    )
    ms = MultiSketch(sketches, nbins, kmers, seq_type)
    ms.save_metadata(output_prefix)
    return ms


__all__ = [
    "BBITS",
    "SIGN_MOD",
    "DistType",
    "HashType",
    "Inverted",
    "MultiSketch",
    "Sketch",
    "cross_dists_all",
    "cross_dists_knn",
    "get_input_list",
    "load_database",
    "num_bins",
    "parse_kmers",
    "read_completeness_file",
    "read_subset_names",
    "self_dists_all",
    "self_dists_knn",
    "self_dists_knn_precluster",
    "set_k",
    "sketch_database",
    "sketch_files",
    "__version__",
]
