"""The port's one ordered writer (sketchtpu_torch/dist/opipe.py) and the
text outputs that go through it (dist/output.py).

The pipeline: task outputs written in submission order whatever order the
tasks finish in, on a sink with and without .buffer; a task's error
re-raised at close() with nothing after it written; the bytes written
counted, on the pipeline and into the caller's open span; the worker count
the host helper's. The writers: byte for byte against the JAX package's
pure-Python writers (sketchtpu.dist.output, run with its native helper
off), the sparse rows from the device engines' arrays and from the host
oracle's lists, cut into many tasks."""

import io
import random
import threading
import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from sketchtpu.dist import output as jax_output
from sketchtpu_torch import _native, spans
from sketchtpu_torch.dist import output
from sketchtpu_torch.dist.knn_torch import SparseKnnRows
from sketchtpu_torch.dist.opipe import OutputPipeline


class _TextOut:
    """A text sink without .buffer (the str write path)."""

    def __init__(self):
        self.parts = []

    def write(self, s):
        assert isinstance(s, str)
        self.parts.append(s)

    def value(self) -> bytes:
        return "".join(self.parts).encode()


class _BufferedOut:
    """A text sink with .buffer (the bytes path)."""

    def __init__(self):
        self.buffer = self
        self.parts = []
        self.flushed = False

    def write(self, b):
        assert isinstance(b, bytes)
        self.parts.append(b)

    def flush(self):
        self.flushed = True

    def value(self) -> bytes:
        return b"".join(self.parts)


def _jittered(i: int) -> bytes:
    # tasks finish out of submission order
    time.sleep(random.Random(i).random() * 0.003)
    return b"line-%05d\n" % i


@pytest.mark.parametrize("workers", [1, 3, 8])
@pytest.mark.parametrize("sink", [_TextOut, _BufferedOut])
def test_written_in_submission_order(sink, workers):
    out = sink()
    with OutputPipeline(out, workers=workers) as pipe:
        for i in range(120):
            pipe.submit(_jittered, i)
    assert out.value() == b"".join(b"line-%05d\n" % i for i in range(120))
    assert pipe.bytes == len(out.value())
    if sink is _BufferedOut:
        assert out.flushed


def test_task_error_reraised_at_close():
    """A task's error surfaces once, at close() (or at a submit that saw
    it, which closes); nothing submitted after the failing task is
    written, and what came before it is, in order."""
    out = _BufferedOut()

    def task(i):
        if i == 5:
            raise ValueError("task 5 failed")
        time.sleep(0.001)
        return b"%d\n" % i

    pipe = OutputPipeline(out, workers=4)
    with pytest.raises(ValueError, match="task 5 failed"):
        for i in range(30):
            pipe.submit(task, i)
        pipe.close()
    pipe.close()  # the error was consumed
    assert out.value() == b"".join(b"%d\n" % i for i in range(len(out.parts)))
    assert len(out.parts) <= 5
    with pytest.raises(RuntimeError, match="closed"):
        pipe.submit(task, 0)


def test_body_error_wins_over_a_task_error():
    with pytest.raises(KeyError, match="body"):
        with OutputPipeline(_BufferedOut(), workers=2) as pipe:
            pipe.submit(lambda: (_ for _ in ()).throw(ValueError("task")))
            time.sleep(0.02)
            raise KeyError("body")


def test_backpressure_bounds_tasks_in_flight():
    gate = threading.Event()
    out = _BufferedOut()
    pipe = OutputPipeline(out, workers=2, max_pending=3)
    submitted = []

    def producer():
        for i in range(9):
            pipe.submit(lambda i=i: gate.wait(5.0) and b"%d\n" % i)
            submitted.append(i)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    time.sleep(0.2)
    assert len(submitted) == 3
    gate.set()
    t.join(5.0)
    pipe.close()
    assert out.value() == b"".join(b"%d\n" % i for i in range(9))


def test_bytes_counted_into_the_callers_span():
    """close() adds the bytes the writer thread wrote to the count of the
    span open on the caller's thread (empty chunks write nothing)."""
    before = len(spans.recorded())
    out = _BufferedOut()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("write"):
            with OutputPipeline(out, workers=3) as pipe:
                for i in range(40):
                    pipe.submit(lambda i=i: b"" if i % 3 else b"x" * i)
    (write,) = [s for s in spans.recorded()[before:] if s.name == "write"]
    assert write.counts == {"bytes": sum(range(0, 40, 3))} == {
        "bytes": len(out.value())}


def test_one_worker_count():
    """The pipeline's default workers are the host helper's WORKERS, and
    the sparse writer's task is today's chunk of lines."""
    pipe = OutputPipeline(_BufferedOut())
    pipe.close()
    assert pipe._workers == _native.WORKERS
    assert output.SPARSE_LINES == max(1 << 17, (1 << 21) // _native.WORKERS)


# --- the writers against the JAX package's Python writers ----------------------

@pytest.fixture
def python_writers(monkeypatch):
    """The JAX package's writers on their pure-Python paths."""
    monkeypatch.setattr(jax_output, "get_lib", lambda: None)
    return jax_output


def _floats(rng, n):
    """Distances in [0, 1] with the edges: 0, 1, tiny, and NaN."""
    v = rng.random(n).astype(np.float32)
    v[::7] = 0.0
    v[::11] = 1.0
    v[::13] = np.float32(1e-7) * rng.random(v[::13].size, np.float32)
    v[::17] = np.nan
    return v


NAMES = [f"s{i}" for i in range(23)] + ["né", "tab name", "x" * 40]


@pytest.mark.parametrize("coreacc", [False, True])
@pytest.mark.parametrize("rows", [None, slice(0, 26), slice(4, 17)])
def test_dense_self_equals_python(python_writers, coreacc, rows):
    rng = np.random.default_rng(3)
    n = len(NAMES)
    lo, hi = (rows.start, rows.stop) if rows else (0, n)
    pairs = sum(n - 1 - i for i in range(lo, hi))
    d = _floats(rng, pairs * (2 if coreacc else 1))
    d = d.reshape(pairs, 2) if coreacc else d
    got, want = io.StringIO(), io.StringIO()
    output.write_dense_self(got, NAMES, d, coreacc, row_range=rows)
    python_writers._write_dense_self_py(want, NAMES, d, coreacc, lo, hi)
    assert got.getvalue() == want.getvalue() and got.getvalue()


@pytest.mark.parametrize("coreacc", [False, True])
def test_dense_cross_equals_python(python_writers, coreacc):
    rng = np.random.default_rng(4)
    ref, qry = NAMES[:9], NAMES[9:]
    d = _floats(rng, len(ref) * len(qry) * (2 if coreacc else 1))
    d = d.reshape(-1, 2) if coreacc else d
    got, want = io.StringIO(), io.StringIO()
    output.write_dense_cross(got, ref, qry, d, coreacc)
    python_writers.write_dense_cross(want, ref, qry, d, coreacc)
    assert got.getvalue() == want.getvalue() and got.getvalue()


def _sparse(rng, n, knn, coreacc):
    """Device-engine rows: some entries masked off, one row's columns
    the sentinel past the names, padding (1.0 with itself) in a row, and
    NaN with itself in another."""
    idx = rng.integers(0, n, (n, knn)).astype(np.int32)
    idx[2, :] = 0x7FFFFFFF
    vals = _floats(rng, n * knn * (2 if coreacc else 1))
    vals = vals.reshape((n, knn, 2) if coreacc else (n, knn))
    idx[5, 1] = 5
    vals[5, 1] = 1.0
    idx[7, 2] = 7  # NaN with itself: skipped, as the reference reads it
    vals[7, 2] = np.nan
    valid = rng.random((n, knn)) < 0.8
    valid[2, :] = valid[5, 1] = valid[7, 2] = True
    return SparseKnnRows(idx, vals, valid)


def _as_lists(rows: SparseKnnRows, n_ref: int) -> list:
    """The host oracle's form of the same rows (no sentinel entries)."""
    return [[it for it in r if it[0] < n_ref] for r in rows]


@pytest.mark.parametrize("lines", [None, 7])
@pytest.mark.parametrize("coreacc", [False, True])
def test_sparse_equals_python(python_writers, monkeypatch, coreacc, lines):
    """Arrays and lists give the JAX package's Python text, whole or cut
    into tasks of `lines` lines."""
    if lines is not None:
        monkeypatch.setattr(output, "SPARSE_LINES", lines)
    rng = np.random.default_rng(5)
    n = len(NAMES)
    rows = _sparse(rng, n, 6, coreacc)
    lists = _as_lists(rows, n)
    want = io.StringIO()
    python_writers.write_sparse(want, NAMES, NAMES, lists, coreacc)
    assert want.getvalue().count("\n") > 40
    for given in (rows, lists):
        got = io.StringIO()
        output.write_sparse(got, NAMES, NAMES, given, coreacc)
        assert got.getvalue() == want.getvalue()


def test_sparse_lists_of_uneven_rows(python_writers):
    """The host oracle's rows of different lengths, empty ones among
    them, and no row at all."""
    lists = [[(1, np.float32(0.25)), (0, np.float32(1.0))], [],
             [(0, np.float32(0.5))], [(3, np.float32(1.0)),
                                      (2, np.float32(1.0))]]
    names = ["a", "b", "c", "d"]
    for rows in (lists, []):
        got, want = io.StringIO(), io.StringIO()
        output.write_sparse(got, names[: len(rows)], names, rows, False)
        python_writers.write_sparse(want, names[: len(rows)], names, rows,
                                    False)
        assert got.getvalue() == want.getvalue()
    assert got.getvalue() == ""


@pytest.mark.parametrize("cross", [False, True])
def test_coreacc_blocks_equal_python(python_writers, cross):
    """emit_coreacc_*_block's tasks against the JAX package's row loop."""
    rng = np.random.default_rng(6)
    n, nq, r0, r1 = len(NAMES), 7, 3, 19
    qnames = NAMES[:nq]
    block = _floats(rng, (r1 - r0) * (nq if cross else n) * 2).reshape(
        r1 - r0, nq if cross else n, 2)
    tab = output._name_table(NAMES)
    got, want = io.StringIO(), io.StringIO()
    with OutputPipeline(got) as pipe:
        if cross:
            output.emit_coreacc_cross_block(pipe, tab, output._name_table(
                qnames), block, r0, r1, nq)
        else:
            output.emit_coreacc_self_block(pipe, tab, block, r0, r1, n)
    if cross:
        python_writers.emit_coreacc_cross_block(
            want, NAMES, qnames, None, None, block, r0, r1, nq)
    else:
        python_writers.emit_coreacc_self_block(want, NAMES, None, block, r0,
                                               r1, n)
    assert got.getvalue() == want.getvalue() and got.getvalue()
