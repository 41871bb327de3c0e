"""The port's CLI end to end: `sketch`, then dense and sparse (--knn)
`dist` (single-k, ANI, core/accessory f32 and --exact; self and
ref-vs-query; with and without completeness), then `merge`, `append`,
`delete` and `info`, through `python -m sketchtpu_torch` on the CPU twins,
against the JAX package's CLI on its host oracle and on its XLA device
engines (JAX on the CPU). The packages meet only through the files."""

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sketchtpu import cli as jax_cli
from sketchtpu_torch.synth import related_assemblies

REPO = Path(__file__).resolve().parent.parent
KMERS = "17,21,25,29"
# name -> (dist flags, with completeness files)
MODES = {
    "k17": (["-k", "17"], False),
    "ani": (["-k", "17", "--ani"], False),
    "exact": (["--exact"], False),
    "coreacc": ([], False),
    "k17_comp": (["-k", "17"], True),
    "exact_comp": (["--exact"], True),
    "coreacc_comp": ([], True),
    "knn_k17": (["-k", "17", "--knn", "3"], False),
    "knn_ani": (["-k", "17", "--ani", "--knn", "3"], False),
    "knn_coreacc": (["--knn", "3"], False),
    "knn_k17_comp": (["-k", "17", "--knn", "3"], True),
    "knn_ani_comp": (["-k", "17", "--ani", "--knn", "3"], True),
    "knn_coreacc_comp": (["--knn", "3"], True),
}
BYTE_EXACT = ("k17", "ani", "exact", "k17_comp", "exact_comp", "knn_k17",
              "knn_ani", "knn_k17_comp", "knn_ani_comp")
# f32 selection, f64 values: byte-identical to the host oracle; against
# the XLA engines (whose f32 core differs in rounding) the same pairs
# apart from near-ties
KNN_COREACC = ("knn_coreacc", "knn_coreacc_comp")
ATOL = 1e-5  # f32 core/accessory against the f64 chain and the XLA f32 tile


def _commands(d: Path, prefix: str) -> list[list[str]]:
    p = str(d / prefix)
    cmds = [
        ["sketch", "-f", str(d / "fa" / "rfile.txt"), "-o", f"{p}db",
         "-k", KMERS, "-s", "256", "--quiet"],
        ["sketch", "-f", str(d / "rfile_q.txt"), "-o", f"{p}q",
         "-k", KMERS, "-s", "256", "--quiet"],
    ]
    comp_ref = ["--ref-completeness-file", str(d / "comp.txt")]
    comp_q = ["--query-completeness-file", str(d / "comp_q.txt")]
    for name, (flags, comp) in MODES.items():
        cmds.append(["dist", f"{p}db", *flags, *(comp_ref if comp else []),
                     "-o", f"{p}self_{name}.txt", "--quiet"])
        cmds.append(["dist", f"{p}db", f"{p}q", *flags,
                     *(comp_ref + comp_q if comp else []),
                     "-o", f"{p}cross_{name}.txt", "--quiet"])
    return cmds


def _db_commands(d: Path, prefix: str) -> list[list[str]]:
    """merge, append, delete and info on the sketched databases; info's
    stdout goes to the file after its ">"."""
    p = str(d / prefix)
    return [
        ["merge", f"{p}db", f"{p}x", "-o", f"{p}merged", "--quiet"],
        ["append", f"{p}db", "-f", str(d / "rfile_x.txt"), "-o",
         f"{p}appended", "--quiet"],
        ["delete", f"{p}db", str(d / "delete.txt"), f"{p}deleted", "--quiet"],
        ["info", f"{p}appended.skm", ">", f"{p}info.txt"],
        ["info", f"{p}deleted.skm", "--sample-info", ">", f"{p}info_samples.txt"],
    ]


def _run_all(main, commands) -> None:
    """main(argv) == 0 for each command, stdout to the file after ">"."""
    for argv in commands:
        out = None
        if ">" in argv:
            argv, out = argv[: argv.index(">")], argv[argv.index(">") + 1]
        with contextlib.ExitStack() as stack:
            if out is not None:
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(out, "w"))))
            assert main(argv) == 0, argv


_PORT_RUN = """
import contextlib, json, sys
from sketchtpu_torch.cli import main
for argv in json.loads(sys.argv[1]):
    out = None
    if ">" in argv:
        argv, out = argv[: argv.index(">")], argv[argv.index(">") + 1]
    with contextlib.ExitStack() as stack:
        if out is not None:
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(out, "w"))))
        assert main(argv) == 0, argv
assert "jax" not in sys.modules, "the port loaded jax"
assert not [m for m in sys.modules if m.split(".")[0] == "sketchtpu"], \\
    "the port loaded the JAX package"
print("PORT-RUN-OK no-jax no-sketchtpu")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import json

    d = tmp_path_factory.mktemp("torch_cli")
    rfile = related_assemblies(d / "fa", 6, 30000, seed=11)
    lines = rfile.read_text().splitlines()
    (d / "rfile_q.txt").write_text("\n".join(lines[2:5]) + "\n")
    extra = related_assemblies(d / "fa_x", 2, 20000, seed=13)
    (d / "rfile_x.txt").write_text("".join(
        f"extra_{i}\t{ln.split(chr(9))[1]}\n"
        for i, ln in enumerate(extra.read_text().splitlines())
    ))
    (d / "delete.txt").write_text("sample_01\nsample_04\n")
    rng = np.random.default_rng(12)
    names = [ln.split("\t")[0] for ln in lines]
    (d / "comp.txt").write_text(
        "".join(f"{n}\t{c:.3f}\n" for n, c in zip(names, rng.uniform(0.6, 1, 6)))
    )
    (d / "comp_q.txt").write_text(
        "".join(f"{n}\t{c:.3f}\n" for n, c in zip(names[2:5], rng.uniform(0.6, 1, 3)))
    )
    env = {**os.environ, "SKETCHTPU_TORCH_BACKEND": "cpu",
           "PYTHONPATH": str(REPO)}
    port_cmds = _commands(d, "port_") + _db_commands(d, "port_")
    port_cmds.insert(2, _x_sketch(d, "port_"))
    proc = subprocess.run(
        [sys.executable, "-c", _PORT_RUN, json.dumps(port_cmds)],
        env=env, capture_output=True, text=True, timeout=600, cwd=d,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    for backend in ("host", "tpu"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("SKETCHTPU_BACKEND", backend)
            _run_all(jax_cli.main, _commands(d, f"{backend}_"))
            if backend == "host":
                _run_all(jax_cli.main, [_x_sketch(d, "host_")]
                         + _db_commands(d, "host_"))
    return d, proc.stdout


def _x_sketch(d: Path, prefix: str) -> list[str]:
    return ["sketch", "-f", str(d / "rfile_x.txt"), "-o", str(d / f"{prefix}x"),
            "-k", KMERS, "-s", "256", "--quiet"]


def test_port_run_never_loads_jax(runs):
    assert "PORT-RUN-OK no-jax no-sketchtpu" in runs[1]


@pytest.mark.parametrize("ref", ["host", "tpu"])
@pytest.mark.parametrize("db", ["db", "q"])
def test_sketch_files_identical(runs, ref, db):
    d = runs[0]
    for ext in (".skd", ".skm"):
        port = (d / f"port_{db}{ext}").read_bytes()
        assert port and port == (d / f"{ref}_{db}{ext}").read_bytes()


@pytest.mark.parametrize("ref", ["host", "tpu"])
@pytest.mark.parametrize("side", ["self", "cross"])
@pytest.mark.parametrize("mode", BYTE_EXACT)
def test_dist_byte_identical(runs, ref, side, mode):
    d = runs[0]
    port = (d / f"port_{side}_{mode}.txt").read_bytes()
    assert port and port == (d / f"{ref}_{side}_{mode}.txt").read_bytes()


def _table(path):
    rows = [ln.split("\t") for ln in path.read_text().splitlines()]
    return [r[:2] for r in rows], np.array([[float(v) for v in r[2:]] for r in rows])


@pytest.mark.parametrize("ref", ["host", "tpu"])
@pytest.mark.parametrize("side", ["self", "cross"])
@pytest.mark.parametrize("mode", ["coreacc", "coreacc_comp"])
def test_dist_coreacc_f32_within_tolerance(runs, ref, side, mode):
    d = runs[0]
    names, got = _table(d / f"port_{side}_{mode}.txt")
    ref_names, want = _table(d / f"{ref}_{side}_{mode}.txt")
    assert names == ref_names and got.shape == want.shape and got.size
    assert ((got[:, 0] > 0) & (got[:, 0] < 1)).any()  # fitted pairs exist
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _pairs(table):
    return [tuple(r) for r in table]


@pytest.mark.parametrize("side", ["self", "cross"])
@pytest.mark.parametrize("mode", KNN_COREACC)
def test_knn_coreacc_identical_to_host(runs, side, mode):
    d = runs[0]
    port = (d / f"port_{side}_{mode}.txt").read_bytes()
    assert port and port == (d / f"host_{side}_{mode}.txt").read_bytes()


def _host_cores(d: Path, side: str, mode: str) -> dict:
    """{(row, column): core} of the host's dense output for the pairs a
    kNN run of `mode` ranks (self: both orders; cross: query rows)."""
    names, vals = _table(d / f"host_{side}_{mode.removeprefix('knn_')}.txt")
    cores = {}
    for (r, c), v in zip(names, vals[:, 0]):
        if side == "self":
            cores[(r, c)] = v
        cores[(c, r)] = v
    return cores


@pytest.mark.parametrize("side", ["self", "cross"])
@pytest.mark.parametrize("mode", KNN_COREACC)
def test_knn_coreacc_selects_as_xla_engine(runs, side, mode):
    """Against the XLA engine (f32 core in other rounding): each row's
    neighbour set is the same, except rows whose knn-th and next core
    distances (host f64 chain) lie within 1e-6, which are counted."""
    d = runs[0]
    names, got = _table(d / f"port_{side}_{mode}.txt")
    xla_names, _ = _table(d / f"tpu_{side}_{mode}.txt")
    cores = _host_cores(d, side, mode)
    assert got.size and ((got[:, 0] > 0) & (got[:, 0] < 1)).any()
    near_ties = 0
    for r in sorted({r for r, _ in names}):
        mine = {c for rr, c in names if rr == r}
        theirs = {c for rr, c in xla_names if rr == r}
        assert len(mine) == len(theirs) == 3, r
        if mine != theirs:
            ranked = sorted(v for (rr, _), v in cores.items() if rr == r)
            assert ranked[3] - ranked[2] <= 1e-6, r
            near_ties += 1
    assert near_ties <= 1


@pytest.mark.parametrize(
    "name", ["merged.skd", "merged.skm", "appended.skd", "appended.skm",
             "deleted.skd", "deleted.skm", "info.txt", "info_samples.txt"],
)
def test_db_commands_identical_to_host(runs, name):
    d = runs[0]
    port = (d / f"port_{name}").read_bytes()
    assert port and port == (d / f"host_{name}").read_bytes()
