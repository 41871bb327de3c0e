"""ntHash bin minima: the port's twin (and its wrapper on CPU tensors)
against the JAX hash_bin_kernel + combine_bin_minima and against the host
oracle, bit-exact; and the port's sketch backend against the host
sketches."""

import numpy as np
import pytest
import torch

from sketchtpu.hash.nthash_jax import (
    combine_bin_minima,
    hash_bin_kernel,
    tap_tables_u32,
)
from sketchtpu.hash.nthash_np import nthash_valid
from sketchtpu.ingest.fastx import DnaStream, read_dna_sample
from sketchtpu.sketchcore.signs import bin_minima, signs_from_hashes
from sketchtpu.sketchcore.sketch import sketch_dna_sample
from sketchtpu.sketchcore.sketch_jax import DeviceSketchBackend, bin_magic
from sketchtpu_torch.hash.nthash_torch import nthash_bin, pack_group, tap_tables
from sketchtpu_torch.sketchcore.sketch_torch import (
    DeviceSketchBackend as TorchSketchBackend,
)
from sketchtpu_torch.synth import related_assemblies

NBINS = 1024


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """Parsed assemblies with N runs and several records each, plus a
    genome shorter than most k."""
    rfile = related_assemblies(tmp_path_factory.mktemp("nthash"), 3, 20000,
                               seed=9, max_contigs=6)
    out = [read_dna_sample([ln.split("\t")[1]])
           for ln in rfile.read_text().splitlines()]
    assert all(s.breaks.size > 1 for s in out)
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, 60).astype(np.uint8)
    out.append(DnaStream(codes=codes, breaks=np.array([12, 60]),
                         acgt=np.bincount(codes, minlength=4)))
    return out


def _port(streams, k, rc):
    seq, starts = pack_group(streams)
    tf, tr = (torch.from_numpy(t) for t in tap_tables(k))
    out = nthash_bin(torch.from_numpy(seq), k, tf, tr, rc,
                     torch.from_numpy(starts), NBINS)
    return out.numpy().view(np.uint64)


@pytest.mark.parametrize("rc", [True, False])
@pytest.mark.parametrize("k", [3, 17, 31, 64])
def test_bin_minima_match_jax_and_oracle(streams, k, rc):
    got = _port(streams, k, rc)
    host = np.stack([
        bin_minima(signs_from_hashes(nthash_valid(s, k, rc)), NBINS)
        for s in streams
    ])
    np.testing.assert_array_equal(got, host)

    g = len(streams)
    packed, breakbits, starts, total = DeviceSketchBackend()._prepare_group(
        streams, k
    )
    taps_fwd, taps_rev = tap_tables_u32(k, rc)
    min_hi, min_lo, found = hash_bin_kernel(
        packed, breakbits, DeviceSketchBackend._pad_starts(starts, total),
        np.int32(total), np.int32(k), taps_fwd, taps_rev, rc=rc,
        num_bins=NBINS, magic=bin_magic(NBINS), out_rows=7,
    )
    jax_minima = combine_bin_minima(
        np.asarray(min_hi).reshape(-1, NBINS)[:g],
        np.asarray(min_lo).reshape(-1, NBINS)[:g],
        np.asarray(found).reshape(-1, NBINS)[:g],
    )
    np.testing.assert_array_equal(got, jax_minima)


def test_window_longer_than_batch_gives_empty_bins(streams):
    got = _port(streams[-1:], 64, True)
    assert (got == np.uint64(2**64 - 1)).all()


def test_sketch_backend_matches_host(streams):
    kmers = [17, 21, 29]
    names = [f"g{i}" for i in range(len(streams))]
    dev = TorchSketchBackend(torch.device("cpu")).sketch_dna_streams(
        streams, names, kmers, 1024, True, 0
    )
    for s, name, d in zip(streams, names, dev):
        h = sketch_dna_sample(s, name, kmers, 1024, True, 0)
        np.testing.assert_array_equal(d.usigs, h.usigs)
        assert (d.seq_length, d.densified, d.acgt, d.non_acgt) == (
            h.seq_length, h.densified, h.acgt, h.non_acgt
        )
    assert dev[-1].densified  # the short genome leaves bins to densify


def test_sketch_backend_refuses_reads(streams):
    reads = DnaStream(codes=streams[0].codes, breaks=streams[0].breaks,
                      reads=True)
    with pytest.raises(NotImplementedError, match="item 5"):
        TorchSketchBackend(torch.device("cpu")).sketch_dna_streams(
            [reads], ["r"], [17], 1024, True, 2
        )
