"""The port's main path end to end: `sketch` then dense `dist` (single-k,
ANI, core/accessory f32 and --exact; self and ref-vs-query; with and
without completeness) through `python -m sketchtpu_torch` on the CPU twins,
against the JAX package's CLI on its host oracle and on its XLA device
engines (JAX on the CPU)."""

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
}
BYTE_EXACT = ("k17", "ani", "exact", "k17_comp", "exact_comp")
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


_PORT_DRIVER = """
import json, sys
from sketchtpu_torch.cli import main
for argv in json.loads(sys.argv[1]):
    assert main(argv) == 0, argv
assert "jax" not in sys.modules, "the port loaded jax"
print("PORT-RUN-OK no-jax")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import json

    d = tmp_path_factory.mktemp("torch_cli")
    rfile = related_assemblies(d / "fa", 6, 30000, seed=11)
    lines = rfile.read_text().splitlines()
    (d / "rfile_q.txt").write_text("\n".join(lines[2:5]) + "\n")
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
    proc = subprocess.run(
        [sys.executable, "-c", _PORT_DRIVER, json.dumps(_commands(d, "port_"))],
        env=env, capture_output=True, text=True, timeout=600, cwd=d,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    for backend in ("host", "tpu"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("SKETCHTPU_BACKEND", backend)
            for argv in _commands(d, f"{backend}_"):
                assert jax_cli.main(argv) == 0, argv
    return d, proc.stdout


def test_port_run_never_loads_jax(runs):
    assert "PORT-RUN-OK no-jax" in runs[1]


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
