"""The port's tooling: the build directory's lock (processes that build at
once wait for one compile), `warmup` (builds, reports, rejects an unknown
mode), `--jax-profile` (a torch.profiler Chrome trace, one file per
rank), tools/kernel_variants.py's patches of the shipped sources and
tools/kernel_ab.py's use."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from sketchtpu_torch import _build, _native
from sketchtpu_torch import cli as port_cli
from sketchtpu_torch import runtime
from sketchtpu_torch import warmup
from sketchtpu_torch.synth import related_assemblies

REPO = Path(__file__).resolve().parent.parent

# each process points the build at argv[1], logs every compile it starts
# to argv[2], waits for the common start time argv[3], then builds
_BUILD_AT_ONCE = {
    "host helper": """
import subprocess, sys, time
from pathlib import Path
from sketchtpu_torch import _native
_native._BUILD_DIR = Path(sys.argv[1])
real = subprocess.run
def logged(cmd, **kw):
    with open(sys.argv[2], "a") as f:
        f.write("compile\\n")
    return real(cmd, **kw)
subprocess.run = logged
while time.time() < float(sys.argv[3]):
    time.sleep(0.001)
assert _native.get_lib() is not None
print(_native.library_path())
""",
    "kernels": """
import sys, time
from pathlib import Path
from sketchtpu_torch import _build
_build.BUILD_DIR = Path(sys.argv[1])
def compile_(out):  # nvcc's stand-in: slow, then the library appears
    with open(sys.argv[2], "a") as f:
        f.write("compile\\n")
    time.sleep(1.0)
    out.write_bytes(b"library")
_build._compile = compile_
while time.time() < float(sys.argv[3]):
    time.sleep(0.001)
print(_build.build())
""",
}


@pytest.mark.parametrize("what", list(_BUILD_AT_ONCE))
def test_concurrent_builds_compile_once(tmp_path, what):
    """Two processes build into one empty build directory at the same
    moment (the ranks of a multi-process run on a fresh checkout): exactly
    one compile runs, and both get the library."""
    build_dir, log = tmp_path / "_build", tmp_path / "compiles.log"
    start = time.time() + 3.0
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("SKETCHTPU_NO_NATIVE", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_AT_ONCE[what], str(build_dir), str(log),
         str(start)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for _ in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert log.read_text() == "compile\n"
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1 and Path(paths.pop()).is_file()
    assert not list(build_dir.glob("*.tmp.*"))


def test_warmup_modes_are_the_jax_packages():
    """Every mode name of the JAX package's `warmup --modes` is accepted;
    any other name is an error (the JAX package ignores it)."""
    from sketchtpu.cli import build_parser as jax_parser

    help_text = next(
        a.help for a in jax_parser()._subparsers._group_actions[0]
        .choices["warmup"]._actions if a.dest == "modes")
    jax_modes = help_text.split("subset of ")[1].split(",")
    assert warmup.parse_modes(",".join(jax_modes)) == jax_modes
    assert sorted(jax_modes) == sorted(warmup.MODES)
    with pytest.raises(ValueError, match="unknown mode"):
        warmup.parse_modes("sketch,Sketch")


@pytest.mark.parametrize("mode", ["cpu", "cuda"])
def test_warmup_builds_and_reports(monkeypatch, capsys, mode):
    """warmup builds the host helper, and the kernels in cuda mode only
    (the stand-in for nvcc records the call), and reports each library."""
    calls = []

    def fake_build():
        calls.append(1)
        return Path("/lib/kernels.so")

    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", mode)
    monkeypatch.setattr(_build, "build", fake_build)
    assert port_cli.main(["warmup", "--modes", "dense,knn,inverted",
                          "--db-size", "100"]) == 0
    err = capsys.readouterr().err
    assert f"host helper: {_native.library_path()}" in err
    assert calls == ([1] if mode == "cuda" else [])
    assert ("CUDA kernels: /lib/kernels.so" in err) == (mode == "cuda")
    assert "warmup complete for dense,knn,inverted" in err


def _profiled(tmp_path, argv, env=None):
    out = subprocess.run(
        [sys.executable, "-m", "sketchtpu_torch", *argv, "--quiet",
         "--jax-profile", str(tmp_path / "trace")],
        env=dict(os.environ, PYTHONPATH=str(REPO),
                 SKETCHTPU_TORCH_BACKEND="cpu", **(env or {})),
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]


def test_jax_profile_writes_a_trace_in_cpu_mode(tmp_path):
    """--jax-profile DIR writes a Chrome trace of the run at exit (CPU
    activity here; CUDA too where torch sees a card): one file, and one
    per rank for a rank of a multi-process run, with the host stages'
    spans among its events."""
    rfile = related_assemblies(tmp_path / "fa", 3, 5000, 31, max_contigs=2)
    _profiled(tmp_path, ["sketch", "-f", str(rfile), "-o", "db", "-k",
                         "17,21", "-s", "64"])
    _profiled(tmp_path, ["dist", "db", "-k", "17", "--knn", "1", "-o",
                         "out", "--n-processes", "2", "--process-id", "1"])
    traces = sorted(p.name for p in (tmp_path / "trace").iterdir())
    assert traces == ["dist.rank1.pt.trace.json", "sketch.pt.trace.json"]
    for name in traces:
        events = json.loads((tmp_path / "trace" / name).read_text())
        assert events["traceEvents"], name
    dist = json.loads((tmp_path / "trace" / traces[0]).read_text())
    names = {ev.get("name") for ev in dist["traceEvents"]}
    assert {"cli.dist", "load", "load.skd", "engine", "scan", "values",
            "write"} <= names
    assert (tmp_path / "out.part1").read_text().count("\n") == 1


def test_compute_window_file(tmp_path, monkeypatch):
    """SKETCHTPU_COMPUTE_WINDOW_FILE receives the run's post-import compute
    window (the rank-scaling measurement reads it)."""
    window = tmp_path / "window.json"
    monkeypatch.setenv("SKETCHTPU_COMPUTE_WINDOW_FILE", str(window))
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cpu")
    t0 = time.time()
    assert port_cli.main(["warmup", "--quiet"]) == 0
    assert 0 <= json.loads(window.read_text())["compute_s"] <= time.time() - t0


def test_device_is_the_ranks_gpu(monkeypatch):
    """In cuda mode under torchrun, LOCAL_RANK modulo the GPUs picks the
    device and makes it current."""
    import torch

    chosen = []
    monkeypatch.setenv("SKETCHTPU_TORCH_BACKEND", "cuda")
    monkeypatch.setenv("LOCAL_RANK", "5")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: chosen[-1] if chosen else 0)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    assert runtime.device() == torch.device("cuda", 1) and chosen == [1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.device()


def _kernel_variants():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "kernel_variants", REPO / "tools" / "kernel_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", list(_kernel_variants().VARIANTS))
def test_kernel_variant_patches_apply(tmp_path, monkeypatch, name):
    """Every design variant still patches the shipped csrc (a patch that no
    longer applies fails the tool on the card), and changes it."""
    kv = _kernel_variants()
    monkeypatch.setattr(kv, "WORK", tmp_path)
    d = kv.prepare(name)
    changed = [f.name for f in (d / "csrc").iterdir() if f.is_file()
               and f.read_bytes() != (REPO / "sketchtpu_torch" / "csrc"
                                     / f.name).read_bytes()]
    patches, settings, kernels = kv.VARIANTS[name]
    assert sorted(changed) == sorted(patches)
    assert name == "shipped" or patches or settings
    assert kernels


def test_kernel_ab_without_a_checkout_prints_its_use():
    """tools/kernel_ab.py needs the other checkout's root: without it, it
    prints its use and exits 2 before touching a GPU."""
    proc = subprocess.run([sys.executable, str(REPO / "tools" / "kernel_ab.py")],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2 and "OTHER_ROOT" in proc.stderr
