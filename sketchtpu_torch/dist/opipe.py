"""Ordered parallel output pipeline for long-form distance text.

At scale the text IS the workload: a 100k-genome all-vs-all run emits 5e9
lines (~150 GB). The native formatter runs at ~5 M lines/s/core, so the
only way the end-to-end wall clock approaches the ~12 s of device compute
is to format on every host core while one writer streams chunks to the
sink in order (matching sketchlib.rust src/distances/distance_matrix.rs:
175-209 byte for byte).

Design: _native.WORKERS pool workers (the count the host helper's other
threaded calls share) run `fn(*args) -> bytes` tasks (index generation,
the f64/f32 distance math, and the GIL-releasing native line assembly);
one writer thread consumes the futures strictly in submission order and
writes to the output. Submission backpressure bounds in-flight chunks, so
memory stays at O(workers * chunk bytes) regardless of run size. close()
adds the bytes written to the count "bytes" of the caller's innermost
open span (spans.count is per thread, so the writer thread cannot).

The pipeline spans device strips: the stream engines submit row-chunk
tasks per strip and immediately return to dispatching the next strip, so
device compute, host math/format, and the write stream all overlap.
"""

from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor

from .. import spans
from .._native import WORKERS


class OutputPipeline:
    """Ordered sink: tasks produce bytes in a pool, one thread writes them
    in submission order. Use as a context manager or call close().
    `bytes`: the bytes written so far."""

    def __init__(self, out, workers: int | None = None,
                 max_pending: int | None = None):
        self._out = out
        self._write = out.buffer.write if hasattr(out, "buffer") else None
        self._workers = workers if workers is not None else WORKERS
        self._pool = ThreadPoolExecutor(max_workers=max(1, self._workers))
        # enough slack that workers never starve while the writer drains
        self._max_pending = max_pending or (self._workers + 4)
        self._queue: deque[Future] = deque()
        self._space = threading.Semaphore(self._max_pending)
        self._ready = threading.Semaphore(0)
        self._error: BaseException | None = None
        self._writer = threading.Thread(target=self._drain, daemon=True)
        self._closed = False
        self.bytes = 0
        self._writer.start()

    # -- writer side --

    def _emit(self, chunk: bytes) -> None:
        if self._write is not None:
            self._write(chunk)
        else:
            self._out.write(chunk.decode("utf-8"))
        self.bytes += len(chunk)

    def _drain(self) -> None:
        while True:
            self._ready.acquire()
            if not self._queue:  # close() sentinel
                return
            fut = self._queue.popleft()
            try:
                if self._error is None:
                    chunk = fut.result()
                    if chunk:
                        self._emit(chunk)
                else:
                    fut.cancel()
            except BaseException as exc:  # propagate via close()
                if self._error is None:
                    self._error = exc
            finally:
                self._space.release()

    # -- producer side --

    def submit(self, fn, *args) -> None:
        """Queue fn(*args) -> bytes; its output is written in call order.
        Blocks when max_pending chunks are already in flight."""
        if self._closed:
            raise RuntimeError("OutputPipeline is closed")
        if self._error is not None:
            self.close()  # re-raises
        self._space.acquire()
        fut = self._pool.submit(fn, *args)
        self._queue.append(fut)
        self._ready.release()

    def close(self) -> None:
        """Drain all pending chunks, flush, count the bytes written, and
        re-raise any task error."""
        if self._closed:
            if self._error is not None:
                exc, self._error = self._error, None
                raise exc
            return
        self._closed = True
        self._ready.release()  # sentinel: queue empty at pop -> exit
        self._writer.join()
        self._pool.shutdown(wait=True)
        if self._write is not None:
            self._out.buffer.flush()
        spans.count("bytes", self.bytes)
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:  # don't mask the original error; still stop the writer
            try:
                self.close()
            except BaseException:
                pass
        return False
