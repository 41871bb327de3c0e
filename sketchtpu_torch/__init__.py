"""sketchtpu_torch: the sketchtpu main path and sparse kNN on PyTorch and
CUDA.

A port of the JAX package `sketchtpu` to an NVIDIA H100. It imports
nothing of `sketchtpu` and keeps its own copies of the host layers it
needs (constants, formats, ingest, the native helper, the f64 oracle,
output, the CLI), so the two packages meet only through `.skd/.skm` files.
It runs DNA assembly sketching (`sketch`), dense distances (`dist`:
single-k Jaccard/ANI and multi-k core/accessory, f32 and `--exact`) and
sparse kNN (`dist --knn`), self and ref-vs-query. Its kernels are written
by hand in CUDA C++ for sm_90a under `csrc/`, built with nvcc into
`_build/` at first use; each has a plain PyTorch twin that runs on CPU
tensors.

    python -m sketchtpu_torch sketch -o db -k 17,21,25 genome1.fa ...
    python -m sketchtpu_torch dist db [--knn 50]

SKETCHTPU_TORCH_BACKEND=cuda|cpu|host selects the engines (runtime.py).
Importing this package imports neither jax nor anything CUDA-specific.
"""
