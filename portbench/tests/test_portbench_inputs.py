"""The frozen generator and writers: deterministic by seed, and their files
load in the port with the bins and metadata the generator made."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.databases import index, sketches

SKETCHES = {"samples": 120, "sketch_size": 1000, "kmers": [17, 21, 25],
            "parents": 3, "divergence": [0.001, 0.05],
            "parent_divergence": [0.005, 0.05]}
INDEX = {"samples": 700, "sketch_size": 100, "k": 17, "clusters": 9,
         "redraw": 0.3}
BIG_SEED = 2**31 + 12345  # past 32 signed bits: seeds may be that large


@pytest.mark.parametrize("gen,config", [(sketches.generate, SKETCHES),
                                        (index.generate, INDEX)])
def test_generator_is_deterministic_by_seed(gen, config):
    a, b = gen(config, BIG_SEED), gen(config, BIG_SEED)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert not np.array_equal(a, gen(config, BIG_SEED + 1))


def test_sketches_are_related_by_lineage():
    words = sketches.generate(SKETCHES, 5)
    x = ~(words[:, None, 0] ^ words[None, :, 0])
    same = np.bitwise_count(np.bitwise_and.reduce(x, axis=-1)).sum(-1)
    off = same[~np.eye(len(words), dtype=bool)]
    # unrelated sketches share a bin with the chance 2^-14 (1024 bins:
    # ~0.06); the farthest related pairs (5 % from their parents, which
    # are up to 5 % from the ancestor) still share tens
    assert off.min() > 20 and off.max() < 1024 and np.median(off) > 200


def test_sketch_files_load_in_the_port(tmp_path):
    from sketchtpu_torch.formats.skm import MultiSketch

    db = sketches.make(SKETCHES, BIG_SEED, tmp_path)
    ms = MultiSketch.load_metadata(str(db.prefix))
    ms.read_sketch_data(str(db.prefix))
    assert ms.number_samples_loaded() == db.n == SKETCHES["samples"]
    assert ms.kmer_lengths == SKETCHES["kmers"]
    assert (ms.sketch_size, ms.sketchsize64) == (1024, 16)
    assert [ms.sketch_name(i) for i in range(db.n)] == db.names
    assert np.array_equal(ms.sketch_bins.reshape(db.words.shape), db.words)


def test_skm_bytes_match_the_ports_writer(tmp_path):
    from sketchtpu_torch.formats.skm import MultiSketch

    db = sketches.make(SKETCHES, 11, tmp_path)
    ms = MultiSketch.load_metadata(str(db.prefix))
    ms.save_metadata(str(tmp_path / "port"))
    assert (tmp_path / "port.skm").read_bytes() == \
        db.prefix.with_suffix(".skm").read_bytes()


def test_index_file_loads_in_the_port_and_matches_its_writer(tmp_path):
    from sketchtpu_torch.inverted.index import Inverted
    from sketchtpu_torch.synth import write_derived_inverted

    db = index.make(INDEX, BIG_SEED, tmp_path)
    inv = Inverted.load(str(db.prefix.with_suffix("")))
    assert np.array_equal(inv.sign_matrix, db.signs)
    assert inv.sample_names == db.names and inv.kmer_size == INDEX["k"]
    write_derived_inverted(str(tmp_path / "port"), db.names, db.signs,
                           INDEX["k"])
    assert (tmp_path / "port.ski").read_bytes() == db.prefix.read_bytes()


def test_snappy_frame_reads_back_with_its_checksums():
    from portbench.databases import native

    data = bytes(range(256)) * 600  # compressible, past one 64 KiB chunk
    framed = native.snappy_frame(data)
    assert framed[:10] == b"\xff\x06\x00\x00sNaPpY"
    from sketchtpu_torch.formats.snappy import frame_decompress

    assert frame_decompress(framed, verify_checksums=True) == data
    assert frame_decompress(native.snappy_frame(b"")) == b""
