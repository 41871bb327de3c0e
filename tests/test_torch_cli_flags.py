"""The port's CLI on the flags that no other port test drives, and on
`--knn 0`, against the JAX package's CLI on its host oracle, byte for
byte: `--k-seq`, `--single-strand` (sketch, append, inverted build),
`--min-qual` (sketch and inverted query of FASTQ with mixed qualities),
`dist --subset`, `--completeness-cutoff` (dist and precluster), and
`--knn 0` for `dist` self and ref-vs-query and for `inverted precluster
--skd` (with each --retain-unmatched), where the host oracle writes no
neighbour (and singleton rows of their own)."""

import gzip
from pathlib import Path

import numpy as np
import pytest

from sketchtpu import cli as jax_cli
from sketchtpu_torch import cli as port_cli
from sketchtpu_torch.synth import related_assemblies


def _fastq(path: Path, n_reads: int, seed: int, read_len: int = 100):
    """Reads off one random genome with qualities drawn from Q2-Q40, so
    that --min-qual masks some bases and not others."""
    rng = np.random.default_rng(seed)
    genome = rng.choice(list("ACGT"), 3000)
    with gzip.open(path, "wt") as f:
        for i in range(n_reads):
            s = int(rng.integers(0, genome.size - read_len))
            qual = "".join(chr(33 + q) for q in rng.integers(2, 41, read_len))
            f.write(f"@r{i}\n{''.join(genome[s : s + read_len])}\n+\n{qual}\n")


def _commands(d: Path, p: str) -> list[list[str]]:
    p = str(d / p)
    rfile, reads = str(d / "fa" / "rfile.txt"), str(d / "reads.txt")
    comp = ["--ref-completeness-file", str(d / "comp.txt")]
    cmds = [
        ["sketch", "-f", rfile, "-o", f"{p}kseq", "--k-seq", "15,27,4", "-s",
         "256"],
        ["sketch", "-f", rfile, "-o", f"{p}ss", "-k", "17,21", "-s", "256",
         "--single-strand"],
        ["append", f"{p}ss", "-f", str(d / "rfile_x.txt"), "-o",
         f"{p}app_ss", "--single-strand"],
        ["sketch", "-f", reads, "-o", f"{p}mq", "-k", "15,19", "-s", "256",
         "--min-count", "1", "--min-qual", "25"],
        ["inverted", "build", "-f", rfile, "-o", f"{p}inv_ss", "-s", "100",
         "-k", "19", "--single-strand", "--write-skq"],
        ["inverted", "build", "-f", rfile, "-o", f"{p}inv", "-s", "100",
         "-k", "19", "--write-skq"],
        ["inverted", "query", f"{p}inv_ss.ski", "-f", reads, "--min-qual",
         "25", "--min-count", "1", "-o", f"{p}q_mq.txt"],
        ["dist", f"{p}kseq", "--subset", str(d / "subset.txt"), "-k", "19",
         "-o", f"{p}subset_k19.txt"],
        ["dist", f"{p}kseq", "--subset", str(d / "subset.txt"), "--exact",
         "-o", f"{p}subset_exact.txt"],
        ["dist", f"{p}kseq", "--subset", str(d / "subset.txt"), "-k", "23",
         "--knn", "2", "-o", f"{p}subset_knn.txt"],
        ["dist", f"{p}kseq", "-k", "19", *comp, "--completeness-cutoff",
         "0.8", "-o", f"{p}cut_k19.txt"],
        ["dist", f"{p}kseq", "--exact", *comp, "--completeness-cutoff",
         "0.8", "-o", f"{p}cut_exact.txt"],
        ["dist", f"{p}kseq", "-k", "19", "--knn", "2", *comp,
         "--completeness-cutoff", "0.9", "-o", f"{p}cut_knn.txt"],
        ["inverted", "precluster", f"{p}inv.ski", "--skd", f"{p}kseq",
         "--knn", "2", *comp, "--completeness-cutoff", "0.8", "-o",
         f"{p}cut_pc.txt"],
        ["dist", f"{p}kseq", "-k", "19", "--knn", "0", "-o",
         f"{p}knn0_self.txt"],
        ["dist", f"{p}kseq", "-k", "19", "--ani", "--knn", "0", "-o",
         f"{p}knn0_ani.txt"],
        ["dist", f"{p}kseq", f"{p}kseq", "-k", "23", "--knn", "0", "-o",
         f"{p}knn0_cross.txt"],
        ["dist", f"{p}kseq", "--knn", "0", "-o", f"{p}knn0_ca.txt"],
    ]
    for retain in (None, "bruteforce", "singleton"):
        flags = ["--retain-unmatched", retain] if retain else []
        for ca in ([], ["--core-acc"]):
            name = f"knn0_pc_{retain}{'_ca' if ca else ''}.txt"
            cmds.append(["inverted", "precluster", f"{p}inv.ski", "--skd",
                         f"{p}kseq", "--knn", "0", *flags, *ca, "-o",
                         f"{p}{name}"])
    return [c + ["--quiet"] for c in cmds]


def _outputs(cmds) -> list[str]:
    """The files the commands write, by name without the prefix."""
    out = []
    for c in cmds:
        path = c[c.index("-o") + 1]
        name = Path(path).name.split("_", 1)[1]
        exts = (".skd", ".skm") if c[0] in ("sketch", "append") else \
            (".ski", ".skq") if c[:2] == ["inverted", "build"] else ("",)
        out += [name + e for e in exts]
    return out


def _run(main, cmds) -> None:
    for argv in cmds:
        assert main(argv) == 0, argv


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli_flags")
    rfile = related_assemblies(d / "fa", 6, 30000, seed=17)
    names = [ln.split("\t")[0] for ln in rfile.read_text().splitlines()]
    extra = related_assemblies(d / "fa_x", 2, 20000, seed=19)
    (d / "rfile_x.txt").write_text("".join(
        f"extra_{i}\t{ln.split(chr(9))[1]}\n"
        for i, ln in enumerate(extra.read_text().splitlines())))
    _fastq(d / "r1.fq.gz", 400, 21)
    _fastq(d / "r2.fq.gz", 300, 22)
    (d / "reads.txt").write_text(f"rd1\t{d / 'r1.fq.gz'}\n"
                                 f"rd2\t{d / 'r2.fq.gz'}\n")
    (d / "subset.txt").write_text("\n".join(names[1:5]) + "\n")
    rng = np.random.default_rng(23)
    (d / "comp.txt").write_text("".join(
        f"{n}\t{c:.3f}\n" for n, c in zip(names, rng.uniform(0.6, 1, 6))))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
        _run(port_cli.main, _commands(d, "port_"))
        mp.setenv("SKETCHTPU_BACKEND", "host")
        _run(jax_cli.main, _commands(d, "host_"))
    return d


OUTPUTS = _outputs(_commands(Path("."), "x_"))


@pytest.mark.parametrize("name", OUTPUTS)
def test_identical_to_the_host_oracle(runs, name):
    port = (runs / f"port_{name}").read_bytes()
    assert port == (runs / f"host_{name}").read_bytes()
    # knn 0: no neighbour, but a singleton row holds its own sample
    assert bool(port) == (not name.startswith("knn0_") or "singleton" in name)


def test_knn0_singleton_rows_are_each_samples_own(runs):
    lines = (runs / "port_knn0_pc_singleton.txt").read_text().splitlines()
    assert len(lines) == 6
    assert all(a == b and float(v) == 0.0
               for a, b, v in (ln.split("\t") for ln in lines))
