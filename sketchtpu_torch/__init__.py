"""sketchtpu_torch: the sketchtpu main path on PyTorch and CUDA.

A port of the JAX package `sketchtpu` to an NVIDIA H100. It shares the
JAX-free host layers of `sketchtpu` (formats, ingest, the native helper,
the f64 oracle, output, the CLI surface) and replaces every module on the
main path that imports jax: DNA assembly sketching (`sketch`) and dense
distances (`dist`: single-k Jaccard/ANI and multi-k core/accessory, f32
and `--exact`, self and ref-vs-query). Its kernels are written by hand in
CUDA C++ for sm_90a under `csrc/`, built with nvcc into `_build/` at first
use; each has a plain PyTorch twin that runs on CPU tensors.

    python -m sketchtpu_torch sketch -o db -k 17,21,25 genome1.fa ...
    python -m sketchtpu_torch dist db

SKETCHTPU_TORCH_BACKEND=cuda|cpu|host selects the engines (runtime.py).
Importing this package imports neither jax nor anything CUDA-specific.
"""
