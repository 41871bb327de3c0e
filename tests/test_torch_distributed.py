"""Multi-process runs of the port (sketchtpu_torch/shard/distributed.py and
the CLI's rank branches) against the JAX package's, case for case with
tests/test_distributed.py: the row splits, sharded sketching and its
merge, every `dist` mode at 2 ranks and at more ranks than rows, the
inverted index's build, query and precluster by rank, and a live run of
two processes under torchrun's environment on gloo.

The ranks of a case run in turn in one process with rank 0 last (a rank's
work depends only on its (rank, count), and rank 0 merges once every
shard exists), in the port's cpu mode (the kernels' twins) and host mode
(its NumPy oracle); the JAX package runs on its host oracle. Parts
concatenate byte for byte into the port's single-process output and into
the JAX package's parts, except where the port's f32 core/accessory tile
(cpu mode, dense) is held within 1e-5 of the f64 chain as everywhere."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sketchtpu import cli as jax_cli
from sketchtpu.shard import distributed as jax_dist
from sketchtpu_torch import cli as port_cli
from sketchtpu_torch.constants import num_bins
from sketchtpu_torch.formats.skm import MultiSketch
from sketchtpu_torch.shard import distributed as port_dist
from sketchtpu_torch.sketchcore.pipeline import sketch_files
from sketchtpu_torch.sketchcore.sketch import HashType
from sketchtpu_torch.synth import read_samples, related_assemblies

REPO = Path(__file__).resolve().parent.parent
BACKENDS = ["cpu", "host"]
ATOL = 1e-5  # the port's f32 core/accessory tile against the f64 chain
KMERS = "17,21,25,29"


def _port(monkeypatch, backend, argv) -> None:
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", backend)
    assert port_cli.main(argv) == 0, argv


def _jax(monkeypatch, argv) -> None:
    monkeypatch.setenv("SKETCHTPU_BACKEND", "host")
    assert jax_cli.main(argv) in (0, None), argv


def _ranks(run, argv, n_proc: int) -> None:
    """run(argv + this rank's flags) for every rank, rank 0 last."""
    for rank in [*range(1, n_proc), 0]:
        run(argv + ["--n-processes", str(n_proc), "--process-id", str(rank)])


def _parts(prefix, n_proc: int) -> bytes:
    return b"".join(Path(f"{prefix}.part{r}").read_bytes()
                    for r in range(n_proc))


def _make_db(tmp_path, monkeypatch, name, n_samples, seed):
    """A database of n related synthetic assemblies, sketched by the JAX
    package's host oracle at the k and size of tests/test_torch_cli.py."""
    rfile = related_assemblies(tmp_path / name, n_samples, 20000, seed,
                               max_contigs=3)
    rfile.write_text("".join(f"{name}{i}\t{ln.split(chr(9))[1]}\n" for i, ln
                             in enumerate(rfile.read_text().splitlines())))
    _jax(monkeypatch, ["sketch", "-f", str(rfile), "-o", str(tmp_path / name),
                       "-k", KMERS, "-s", "256", "--quiet"])
    return str(tmp_path / name)


def _table(data: bytes):
    rows = [ln.split("\t") for ln in data.decode().splitlines()]
    return [r[:2] for r in rows], np.array([[float(v) for v in r[2:]]
                                            for r in rows])


def _run_dist(tmp_path, monkeypatch, backend, dist_args, tag, n_proc=2):
    """(port single, port parts, JAX host single, JAX host parts)."""
    out = {}
    for who, run in (("port", lambda a: _port(monkeypatch, backend, a)),
                     ("jax", lambda a: _jax(monkeypatch, a))):
        single = tmp_path / f"{tag}_{who}_single.txt"
        run(["dist", *dist_args, "-o", str(single), "--quiet"])
        multi = tmp_path / f"{tag}_{who}_multi.txt"
        _ranks(run, ["dist", *dist_args, "-o", str(multi), "--quiet"], n_proc)
        out[who] = (single.read_bytes(), _parts(multi, n_proc))
    return (*out["port"], *out["jax"])


def _check(single, parts, jsingle, jparts, f32: bool = False):
    assert parts == single and jparts == jsingle and single
    if f32:  # the port's f32 tile: same pairs, values within ATOL
        names, got = _table(parts)
        jnames, want = _table(jparts)
        assert names == jnames
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    else:
        assert parts == jparts


def test_process_slice_partitions():
    for n in (0, 1, 5, 7, 8, 100):
        for p in (1, 2, 3, 8):
            slices = [port_dist.process_slice(n, i, p) for i in range(p)]
            assert slices == [jax_dist.process_slice(n, i, p)
                              for i in range(p)]
            covered = []
            for s in slices:
                covered.extend(range(n)[s])
            assert covered == list(range(n))


def test_triangle_row_slice_covers():
    for n in (0, 1, 2, 9, 100, 6610):
        for p in (1, 2, 3, 8):
            slices = [port_dist.triangle_row_slice(n, i, p) for i in range(p)]
            assert slices == [jax_dist.triangle_row_slice(n, i, p)
                              for i in range(p)], (n, p)
            covered = []
            for s in slices:
                covered.extend(range(n)[s])
            assert covered == list(range(n)), (n, p)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_sketch_merges_bit_exact(tmp_path, monkeypatch, backend):
    """sketch_shard for each of 3 ranks, then merge_shards: the .skd/.skm
    of a direct sketch of the whole list, and the JAX package's merge."""
    from sketchtpu.constants import num_bins as jax_num_bins
    from sketchtpu.sketchcore.sketch import HashType as JaxHashType

    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", backend)
    monkeypatch.setenv("SKETCHTPU_BACKEND", "host")
    rfile = related_assemblies(tmp_path / "fa", 4, 6000, 3)
    files = [(ln.split("\t")[0], [ln.split("\t")[1]])
             for ln in rfile.read_text().splitlines()]
    kmers = [17, 21]
    _, bins, _ = num_bins(100)
    direct = tmp_path / "direct"
    sketches = sketch_files(str(direct), files, False, kmers, bins,
                            HashType("dna"), True, 0, 20)
    MultiSketch(sketches, bins, kmers, HashType("dna")).save_metadata(
        str(direct))
    for dist, tag, ht, nb in (
            (port_dist, "port", HashType("dna"), bins),
            (jax_dist, "jax", JaxHashType("dna"), jax_num_bins(100)[1])):
        for rank in range(3):
            dist.sketch_shard(str(tmp_path / tag), files, rank, 3,
                              concat_fasta=False, kmers=kmers, sketch_bins=nb,
                              seq_type=ht, rc=True, min_count=0, min_qual=20)
        dist.merge_shards(str(tmp_path / tag), 3)
        for ext in (".skd", ".skm"):
            assert (tmp_path / f"{tag}{ext}").read_bytes() == (
                direct.with_suffix(ext)).read_bytes(), (tag, ext)
    assert not (tmp_path / "port.part0.skd").exists()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seq_type", ["dna", "aa"])
def test_cli_sharded_sketch(tmp_path, monkeypatch, backend, seq_type):
    """`sketch --process-id I --n-processes 3` per rank, rank 0 last (it
    merges): byte-identical to an unsharded sketch and to the JAX
    package's sharded CLI; DNA assemblies and reads, or proteomes."""
    from sketchtpu_torch.synth import related_proteomes

    if seq_type == "dna":
        rfile = related_assemblies(tmp_path / "fa", 3, 8000, 5)
        reads = read_samples(tmp_path / "fq", 2, 3000, 8, 6)
        rfile.write_text(rfile.read_text() + "".join(reads))
        flags = ["-k", "17,21", "--min-count", "2"]
    else:
        rfile = related_proteomes(tmp_path / "faa", 5, 20, 150, 5)
        flags = ["-k", "6,9", "--seq-type", "aa"]
    base = ["sketch", "-f", str(rfile), *flags, "-s", "100", "--quiet"]
    _port(monkeypatch, backend, base + ["-o", str(tmp_path / "direct")])
    _ranks(lambda a: _port(monkeypatch, backend, a),
           base + ["-o", str(tmp_path / "shard")], 3)
    _ranks(lambda a: _jax(monkeypatch, a),
           base + ["-o", str(tmp_path / "jax")], 3)
    for ext in (".skd", ".skm"):
        want = (tmp_path / f"direct{ext}").read_bytes()
        assert want and (tmp_path / f"shard{ext}").read_bytes() == want
        assert (tmp_path / f"jax{ext}").read_bytes() == want
    assert not (tmp_path / "shard.part0.skd").exists()


@pytest.mark.parametrize("backend", BACKENDS)
def test_multiprocess_self_dense_coreacc(tmp_path, monkeypatch, backend):
    db = _make_db(tmp_path, monkeypatch, "db", 9, 1)
    out = _run_dist(tmp_path, monkeypatch, backend, [db], "ca")
    _check(*out, f32=backend == "cpu")
    assert out[0].count(b"\n") == 9 * 8 // 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_multiprocess_self_dense_jaccard(tmp_path, monkeypatch, backend):
    db = _make_db(tmp_path, monkeypatch, "db", 9, 2)
    out = _run_dist(tmp_path, monkeypatch, backend, [db, "-k", "17"], "jac")
    _check(*out)
    assert out[0].count(b"\n") == 9 * 8 // 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_multiprocess_self_knn(tmp_path, monkeypatch, backend):
    db = _make_db(tmp_path, monkeypatch, "db", 9, 3)
    _check(*_run_dist(tmp_path, monkeypatch, backend,
                      [db, "-k", "17", "--knn", "3"], "knn"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_multiprocess_self_knn_coreacc(tmp_path, monkeypatch, backend):
    db = _make_db(tmp_path, monkeypatch, "db", 9, 4)
    _check(*_run_dist(tmp_path, monkeypatch, backend, [db, "--knn", "3"],
                      "knnca"))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", [["-k", "17"], []])
def test_multiprocess_cross_dense(tmp_path, monkeypatch, backend, mode):
    """Ref-vs-query dense splits by rows of the reference database."""
    db = _make_db(tmp_path, monkeypatch, "db", 7, 5)
    qdb = _make_db(tmp_path, monkeypatch, "qdb", 5, 6)
    out = _run_dist(tmp_path, monkeypatch, backend, [db, qdb, *mode], "xd")
    _check(*out, f32=backend == "cpu" and not mode)
    assert out[0].count(b"\n") == 7 * 5


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", [["-k", "17"], []])
def test_multiprocess_cross_knn(tmp_path, monkeypatch, backend, mode):
    """Ref-vs-query kNN splits the queries; a rank loads only its block."""
    db = _make_db(tmp_path, monkeypatch, "db", 7, 7)
    qdb = _make_db(tmp_path, monkeypatch, "qdb", 5, 8)
    _check(*_run_dist(tmp_path, monkeypatch, backend,
                      [db, qdb, *mode, "--knn", "3"], "xknn"))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mode", [[], ["-k", "17"], ["--knn", "2"],
                                  ["-k", "17", "--knn", "2"]])
def test_multiprocess_more_ranks_than_rows(tmp_path, monkeypatch, backend,
                                           mode):
    """More processes than samples: surplus ranks write empty parts (and
    launch nothing), and the concatenation still matches."""
    db = _make_db(tmp_path, monkeypatch, "tiny", 3, 9)
    out = _run_dist(tmp_path, monkeypatch, backend, [db, *mode], "more", 5)
    _check(*out, f32=backend == "cpu" and not mode)
    split = (port_dist.process_slice if "--knn" in mode
             else port_dist.triangle_row_slice)
    empty = [r for r in range(5) if not range(3)[split(3, r, 5)]]
    assert len(empty) >= 2
    for r in empty:
        assert Path(f"{tmp_path}/more_port_multi.txt.part{r}").read_bytes() \
            == b""


@pytest.fixture
def index_inputs(tmp_path):
    """Assemblies, a read sample and a two-file sample (one .ski row), with
    species names and metadata for every sample."""
    rfile = related_assemblies(tmp_path / "fa", 5, 6000, 21, max_contigs=3)
    lines = rfile.read_text().splitlines()
    two = "\t".join([lines[4].split("\t")[0], lines[4].split("\t")[1],
                     lines[3].split("\t")[1]])
    reads = read_samples(tmp_path / "fq", 1, 3000, 8, 22)
    rfile.write_text("\n".join(lines[:4] + [two]) + "\n" + "".join(reads))
    names = [ln.split("\t")[0] for ln in rfile.read_text().splitlines()]
    (tmp_path / "species.txt").write_text(
        "".join(f"{nm}\tspecies_{i % 2}\n" for i, nm in enumerate(names)))
    (tmp_path / "meta.txt").write_text(
        "".join(f"{nm}\tmeta {i}\n" for i, nm in enumerate(names)))
    return rfile


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n_proc", [3, 8])
@pytest.mark.parametrize("labels", [False, True])
def test_multiprocess_inverted_build(tmp_path, monkeypatch, index_inputs,
                                     backend, n_proc, labels):
    """`inverted build --write-skq` by rank (rank 0 merges, with the
    global labels and metadata): the single-process .ski/.skq, and the JAX
    package's merge; 8 ranks over 6 samples write empty shards."""
    base = ["inverted", "build", "-f", str(index_inputs), "-k", "17", "-s",
            "12", "--write-skq", "--min-count", "2", "--quiet"]
    if labels:
        base += ["--species-names", str(tmp_path / "species.txt"),
                 "--metadata", str(tmp_path / "meta.txt")]
    _port(monkeypatch, backend, base + ["-o", str(tmp_path / "single")])
    _ranks(lambda a: _port(monkeypatch, backend, a),
           base + ["-o", str(tmp_path / "port")], n_proc)
    _ranks(lambda a: _jax(monkeypatch, a),
           base + ["-o", str(tmp_path / "jax")], n_proc)
    for ext in (".ski", ".skq"):
        want = (tmp_path / f"single{ext}").read_bytes()
        assert want and (tmp_path / f"port{ext}").read_bytes() == want
        assert (tmp_path / f"jax{ext}").read_bytes() == want
    assert not (tmp_path / "port.part0.ski").exists()


@pytest.fixture
def index(tmp_path, monkeypatch, index_inputs):
    """The index of index_inputs at -s 12 with its .skq, and a .skd of the
    same samples at k 13, 17, 21 (the JAX package's host oracle)."""
    _jax(monkeypatch, ["inverted", "build", "-f", str(index_inputs), "-o",
                       str(tmp_path / "inv"), "-k", "17", "-s", "12",
                       "--write-skq", "--min-count", "2", "--quiet"])
    _jax(monkeypatch, ["sketch", "-f", str(index_inputs), "-o",
                       str(tmp_path / "db"), "-k", "13,17,21", "-s", "100",
                       "--min-count", "2", "--quiet"])
    return tmp_path / "inv.ski", index_inputs


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("query_type", ["match-count", "any-bins",
                                        "all-bins"])
def test_multiprocess_inverted_query(tmp_path, monkeypatch, index, backend,
                                     query_type):
    """A rank queries its slice of the query files; only rank 0 writes the
    header."""
    ski, rfile = index
    base = ["inverted", "query", str(ski), "-f", str(rfile), "--query-type",
            query_type, "--min-count", "2", "--quiet"]
    _port(monkeypatch, backend, base + ["-o", str(tmp_path / "single.txt")])
    _ranks(lambda a: _port(monkeypatch, backend, a),
           base + ["-o", str(tmp_path / "port.txt")], 4)
    _ranks(lambda a: _jax(monkeypatch, a),
           base + ["-o", str(tmp_path / "jax.txt")], 4)
    want = (tmp_path / "single.txt").read_bytes()
    assert want.count(b"\n") == 7
    assert _parts(tmp_path / "port.txt", 4) == want
    assert _parts(tmp_path / "jax.txt", 4) == want


@pytest.mark.parametrize("backend", BACKENDS)
def test_multiprocess_precluster_count_partials(monkeypatch, capsys, index,
                                                backend):
    """Without a process group each rank prints its triangle rows'
    partial, the JAX package's line; the partials sum to the count."""
    ski, _ = index

    def lines(run):
        capsys.readouterr()
        _ranks(run, ["inverted", "precluster", str(ski), "--count",
                     "--quiet"], 3)
        return capsys.readouterr().out.splitlines()

    _port(monkeypatch, backend, ["inverted", "precluster", str(ski),
                                 "--count", "--quiet"])
    total = int(capsys.readouterr().out.split()[1])
    port = lines(lambda a: _port(monkeypatch, backend, a))
    assert port == lines(lambda a: _jax(monkeypatch, a))
    assert [ln.split("(rank ")[1][:3] for ln in port] == ["1/3", "2/3", "0/3"]
    assert sum(int(ln.split()[1]) for ln in port) == total > 0


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("flags", [["--knn", "2"],
                                   ["--knn", "2", "--ani"],
                                   ["--knn", "2", "--retain-unmatched",
                                    "bruteforce"],
                                   ["--knn", "2", "--core-acc"]])
def test_multiprocess_precluster_knn(tmp_path, monkeypatch, index, backend,
                                     flags):
    """`precluster --skd` rows split evenly over 4 ranks (more ranks than
    some splits have rows)."""
    ski, _ = index
    base = ["inverted", "precluster", str(ski), "--skd",
            str(tmp_path / "db"), *flags, "--quiet"]
    _port(monkeypatch, backend, base + ["-o", str(tmp_path / "single.txt")])
    _ranks(lambda a: _port(monkeypatch, backend, a),
           base + ["-o", str(tmp_path / "port.txt")], 4)
    _ranks(lambda a: _jax(monkeypatch, a),
           base + ["-o", str(tmp_path / "jax.txt")], 4)
    want = (tmp_path / "single.txt").read_bytes()
    assert want and _parts(tmp_path / "port.txt", 4) == want
    assert _parts(tmp_path / "jax.txt", 4) == want


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_live_two_process_sketch_and_count(tmp_path, monkeypatch, capsys):
    """Two processes under torchrun's environment (WORLD_SIZE, RANK,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) join one gloo process group:
    the barrier before rank 0's sketch merge, the sum of the `precluster
    --count` partials (rank 0 prints the total, rank 1 nothing) and the
    inverted build's barrier and merge, each against the JAX package's
    single-process output."""
    rfile = related_assemblies(tmp_path / "fa", 6, 4000, 77, max_contigs=2)

    def run_pair(args):
        port, procs = _free_port(), []
        for rank in range(2):
            env = dict(os.environ, PYTHONPATH=str(REPO), WORLD_SIZE="2",
                       RANK=str(rank), LOCAL_RANK=str(rank),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       SKETCHTPU_TORCH_BACKEND="cpu")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "sketchtpu_torch", *args], env=env,
                cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        try:
            outs = [p.communicate(timeout=120) for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, (_, err) in zip(procs, outs):
            assert p.returncode == 0, err.decode()[-2000:]
        return [o.decode() for o, _ in outs]

    sketch = ["sketch", "-f", str(rfile), "-k", "17", "-s", "100", "--quiet"]
    run_pair(sketch + ["-o", "multi"])
    _jax(monkeypatch, sketch + ["-o", str(tmp_path / "single")])
    for ext in (".skd", ".skm"):
        assert (tmp_path / f"multi{ext}").read_bytes() == (
            tmp_path / f"single{ext}").read_bytes(), ext
    assert not (tmp_path / "multi.part1.skd").exists()

    build = ["inverted", "build", "-f", str(rfile), "-k", "17", "-s", "12",
             "--write-skq", "--quiet"]
    _jax(monkeypatch, build + ["-o", str(tmp_path / "inv")])
    outs = run_pair(["inverted", "precluster", "inv.ski", "--count",
                     "--quiet"])
    capsys.readouterr()
    _jax(monkeypatch, ["inverted", "precluster", str(tmp_path / "inv.ski"),
                       "--count", "--quiet"])
    single = capsys.readouterr().out
    assert outs == [single, ""] and int(single.split()[1]) > 0

    run_pair(build + ["-o", "inv2"])
    for ext in (".ski", ".skq"):
        assert (tmp_path / f"inv2{ext}").read_bytes() == (
            tmp_path / f"inv{ext}").read_bytes(), ext
