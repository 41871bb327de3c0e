"""In-process multi-device engines and step functions over a rows x words
grid of device slots.

Port of sketchtpu/shard/mesh.py. make_mesh(n_rows, n_words) gives a Mesh,
a rows x words grid of device slots whose .shape is the JAX mesh's
({"rows": r, "words": w}); a list of devices, as runtime.py passes the
engines, is a rows-only grid (words = 1). A device may fill more than one
slot: its slots then share it (on one GPU they split the work).

The rows axis: where the JAX engines shard rows over 'rows' and replicate
the column operand, each engine here keeps one single-device engine of
the port per device (the column operand whole on each), gives every row
of slots a contiguous block of rows, runs the slots at once (one host
thread each, with its device current) and joins the blocks in row order.
Every row sees every column, so each row block is one device's, bit for
bit.

The words axis (the JAX package's psum over 'words'): the sketch's s64
64-bin chunks split into n_words contiguous ranges, and word slot w holds
only range w of every operand (only that slice is uploaded: on distinct
GPUs, holding a share of each sketch is the axis's point). Every slot of
a row block, its lead (words slot 0) too, computes its partial samebits
with K4 (samebits_full, or samebits_stack for every k in one launch) on a
stream of its own; the lead enqueues its own partial before it waits for
anything, receives the others on its receive stream (a partial made on
another GPU is copied on a stream of that GPU after an event recorded on
its producer's stream) and finishes once they are in: samebits_finish
(the sum as int32, or the f32 distances) or coreacc_chain (K2's
regression chain on the per-k sums), each taking the partials as they
stand. A finish sums at most MAX_WORDS_SLOTS partials, so a wider row
block's lead first folds its partials in groups of that many with
samebits_finish's count mode (_fold; int32 sums are exact), and a grid
may have as many words slots as the sketch has chunks. A slot's share of
an operand held on another GPU is moved by the copy engines (one 2-D
memcpy on a stream of the slot's GPU, after events the step records on
the streams of every GPU its operands are on), so it does not queue
behind the other GPU's compute. The counts are
exact, so a split result equals the unsplit one bit for bit. A sketch
whose chunks do not split evenly over the words slots is refused, as the
JAX mesh cannot shard it either. mesh.timeline() records each slot's
spans (set-up copies, partial, transfers, finish) by CUDA events, as
device spans of spans.py on its host clock.

No CLI flag, environment variable or runtime selection reaches the words
axis: the runtime passes the engines a list of devices. make_mesh, the
step functions, the words grids of ShardedSamebitsEngine and
ShardedCoreAccEngine and dist/jaccard_torch.py's jaccard_dist_block are
library surface, as in the JAX package. The kNN and inverted engines and
steps refuse words != 1, as the JAX ones do.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import spans
from .._transfer import HostCopy, copy_pitched, pitch_of
from ..constants import BBITS
from ..dist.coreacc_kernels import coreacc, coreacc_chain
from ..dist.coreacc_torch import (
    DeviceCoreAccEngine,
    _f32,
    stream_blocks,
)
from ..dist.knn_kernels import SignMask
from ..dist.knn_torch import (
    DeviceKnnEngine,
    SparseKnnRows,
    _no_neighbours,
    knn_scan_tensors,
    precluster_signs,
    scan_coreacc,
)
from ..dist.output import emit_coreacc_cross_block, emit_coreacc_self_block
from ..dist.samebits_kernels import (
    MAX_WORDS_SLOTS,
    samebits_dist,
    samebits_finish,
    samebits_full,
    samebits_stack,
    to_device_words,
    words_to_device,
)
from ..dist.sign_words import pack_signs
from ..inverted.device import DeviceInvertedEngine
from .distributed import process_slice


class Mesh:
    """A rows x words grid of device slots, grid[r][w]; .shape as the JAX
    mesh reports it."""

    def __init__(self, grid):
        self.grid = [[_resolved(d) for d in row] for row in grid]
        if not self.grid or not self.grid[0] or any(
                len(row) != len(self.grid[0]) for row in self.grid):
            raise ValueError("a mesh needs a non-empty rectangular grid of "
                             "device slots")
        self.shape = {"rows": len(self.grid), "words": len(self.grid[0])}

    @property
    def devices(self) -> list[torch.device]:
        """Every slot's device, row by row."""
        return [d for row in self.grid for d in row]

    def __repr__(self) -> str:
        return f"Mesh({self.grid})"


def _resolved(device) -> torch.device:
    """A device with its index: "cuda" is the current CUDA device, so that
    slots compare equal to the devices their tensors report."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_rows: int | None = None, n_words: int = 1,
              devices=None) -> Mesh:
    """A rows x words grid over `devices` (default: runtime.devices(), this
    process's devices), filled row by row as the JAX make_mesh reshapes
    its local devices; n_rows defaults to len(devices) // n_words. A
    device may be named more than once."""
    if devices is None:
        from ..runtime import devices as visible

        devices = visible() or []
    devices = list(devices)
    if n_rows is None:
        n_rows = len(devices) // n_words
    if n_rows < 1 or n_words < 1 or n_rows * n_words > len(devices):
        raise ValueError(f"a {n_rows} x {n_words} mesh needs "
                         f"{max(1, n_rows * n_words)} device slots, got "
                         f"{len(devices)}")
    return Mesh([devices[r * n_words:(r + 1) * n_words]
                 for r in range(n_rows)])


def as_mesh(devices) -> Mesh:
    """A Mesh as it is; a list of devices as a rows-only grid; None as
    make_mesh() over this process's devices."""
    if isinstance(devices, Mesh):
        return devices
    if devices is None:
        return make_mesh()
    devices = list(devices)
    if not devices:
        raise ValueError("a multi-device engine needs at least one device")
    return Mesh([[d] for d in devices])


def word_ranges(s64: int, n_words: int) -> list[slice]:
    """The u64 words ([chunk][plane], s64 chunks a sketch) of each words
    slot: n_words contiguous ranges of s64 / n_words whole chunks."""
    if s64 % n_words:
        raise ValueError(f"a sketch of {s64} 64-bin chunks does not split "
                         f"over {n_words} words slots")
    step = s64 // n_words * BBITS
    return [slice(w * step, (w + 1) * step) for w in range(n_words)]


def split_rows(lo: int, hi: int, parts: int) -> list[slice]:
    """[lo, hi) as `parts` contiguous blocks in order, the first
    (hi - lo) % parts of them one row longer; empty where the rows are
    fewer than the parts."""
    blocks = []
    for p in range(parts):
        s = process_slice(max(0, hi - lo), p, parts)
        blocks.append(slice(lo + s.start, lo + s.stop))
    return blocks


def split_pairs(lo: int, hi: int, n: int, parts: int) -> list[slice]:
    """[lo, hi) as `parts` contiguous blocks of near-equal upper-triangle
    pair counts (row i pairs with the n - 1 - i columns past it)."""
    cum = np.arange(lo, hi + 1, dtype=np.float64)
    cum = (cum - lo) * n - (cum * (cum + 1) - lo * (lo + 1)) / 2
    cuts = [lo] + [lo + int(np.searchsorted(cum, cum[-1] * p / parts))
                   for p in range(1, parts)] + [hi]
    return [slice(a, max(a, b)) for a, b in zip(cuts, cuts[1:])]


class DeviceSlots:
    """The device slots of an engine or a step over a Mesh: one
    single-device engine per distinct (device, words slot), made by
    make(device, w), and a thread for each slot that runs its work with
    its device current. `sources` are the devices of the operands the
    slots read (a GPU outside the grid too): the slots' work on every GPU,
    and the copies of shares from it, comes after what the caller queued
    there before."""

    def __init__(self, devices, make, sources=()):
        self.mesh = as_mesh(devices)
        self.sources = list(sources)
        grid = self.mesh.grid
        self.rows, self.words = self.mesh.shape["rows"], self.mesh.shape["words"]
        self._pool = ThreadPoolExecutor(max_workers=self.rows * self.words,
                                        thread_name_prefix="device-slot")
        # the engines are made (their data uploaded) at once
        keys = list(dict.fromkeys((d, w) for row in grid
                                  for w, d in enumerate(row)))
        after = _marks([d for d, _ in keys] + self.sources)
        made = [self._pool.submit(_on, d, make, d, w, slot=f"w{w}",
                                  after=after) for d, w in keys]
        self.engines = dict(zip(keys, [f.result() for f in _wait_all(made)]))

    def __len__(self) -> int:
        return self.rows

    def distinct_devices(self) -> list[torch.device]:
        return list(dict.fromkeys(d for d, _ in self.engines))

    def submit(self, slot, fn, *args, after=None, own=False):
        """A future of fn(engine of the slot, *args), run on the slot's
        thread with its device current; slot is (row, words slot), or a row
        (its lead slot). On the slot's own stream of the device (own) or on
        the device's current stream, which first waits for the events
        `after`."""
        r, w = slot if isinstance(slot, tuple) else (slot, 0)
        dev = self.mesh.grid[r][w]
        return self._pool.submit(_on, dev, fn, self.engines[(dev, w)], *args,
                                 slot=f"r{r}w{w}", after=after, own=own)

    def map(self, fn, items) -> list:
        """[fn(engine, item) on row slot i for the i-th item], run at once;
        the first failure raises once every slot has stopped."""
        futures = [self.submit(i, fn, item) for i, item in enumerate(items)]
        return [f.result() for f in _wait_all(futures)]

    def split_words(self, lo: int, hi: int, partial, finish) -> list:
        """Futures, one a row block of [lo, hi) in order, of finish(lead
        engine, rows, parts) on the block's lead slot. On a rows-only grid
        parts is None. With words slots, every slot of the block, the lead
        too, runs partial(engine, rows) (a tensor) on a stream of its own,
        and parts holds them on the lead's device, its own first (past
        MAX_WORDS_SLOTS folded by _fold): the lead enqueues its own
        partial before it waits for anything, receives the others on its
        receive stream (a partial of another GPU copied on a stream of
        that GPU after its producer's event), and only the finish waits
        for them. Each lead is submitted after the partials
        it waits for, so the lead threads never hold up a partial."""
        after = _marks(self.distinct_devices() + self.sources)
        if self.words == 1:
            return [self.submit(r, _whole, finish, rows, after=after)
                    for r, rows in enumerate(split_rows(lo, hi, self.rows))]
        futures = []
        for r, rows in enumerate(split_rows(lo, hi, self.rows)):
            parts = [(f"r{r}w{w}", self.submit((r, w), _produce, partial,
                                               rows, after=after, own=True))
                     for w in range(1, self.words)]
            futures.append(self.submit((r, 0), _finish, partial, finish, rows,
                                       parts, after=after, own=True))
        return futures

    def close(self) -> None:
        self._pool.shutdown(wait=True)


def _whole(eng, finish, rows):
    with _span("finish", eng.device):
        return finish(eng, rows, None)


def _produce(eng, partial, rows):
    with _span("partial", eng.device):
        out = partial(eng, rows)
    return _ready(out)


def _finish(eng, partial, finish, rows, parts):
    """The lead's work: its own partial first, then the others received
    (parts: (slot, future of a _ready() item)), then the finish, which
    alone waits for them."""
    dev = eng.device
    with _span("partial", dev):
        got = [partial(eng, rows)]
    recv = _side(dev, f"recv {_this.slot}") if dev.type == "cuda" else None
    for slot, f in parts:
        got.append(_receive(f.result(), dev, recv, slot))
    if recv is not None:
        compute = torch.cuda.current_stream(dev)
        compute.wait_stream(recv)
        for t in got[1:]:
            t.record_stream(compute)
    with _span("finish", dev):
        return finish(eng, rows, _fold(got))


def _fold(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The slots' partials, as at most MAX_WORDS_SLOTS of them, for a
    finish: past that bound, summed in groups of MAX_WORDS_SLOTS in order
    by samebits_finish's count mode (exact int32) until they are few
    enough."""
    while len(parts) > MAX_WORDS_SLOTS:
        parts = [samebits_finish(parts[i:i + MAX_WORDS_SLOTS])
                 for i in range(0, len(parts), MAX_WORDS_SLOTS)]
    return parts


def _receive(item, device: torch.device, recv, slot: str) -> torch.Tensor:
    """A partial of `slot` (a _ready() item) on the lead's `device`: from
    the same device as it stands, the receive stream `recv` waiting for its
    producer's event; from another GPU copied on a stream of that GPU after
    the event, into memory of the receive stream. recv is None for the
    CPU."""
    (t,), done = item
    if recv is None:
        return t
    if t.device == device:
        recv.wait_event(done)
        return t
    send = _side(t.device, f"from {slot}")
    send.wait_event(done)
    with _span("transfer", t.device, send, slot), torch.cuda.stream(send), \
            torch.cuda.stream(recv):
        local = t.to(device)
    t.record_stream(send)
    return local


def _ready(*ts: torch.Tensor):
    """(ts, an event recorded on the current stream of their CUDA device,
    or None): another thread can then order a read of ts after the kernels
    that wrote them."""
    if ts[0].device.type != "cuda":
        return ts, None
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(ts[0].device))
    return ts, done


def _fetch(item, device: torch.device) -> tuple:
    """The tensors of a _ready() item on `device`: the reading stream (a
    copy's, which torch runs on the source device's current stream) waits
    for the producer's event first, and the memory is not reused before
    it has read."""
    ts, done = item
    if done is not None:
        reader = torch.cuda.current_stream(ts[0].device)
        reader.wait_event(done)
        for t in ts:
            t.record_stream(reader)
    return tuple(t if t.device == device else t.to(device) for t in ts)


def _join(futures, device: torch.device) -> tuple:
    """The row blocks (futures of _ready() items) joined in order on
    `device`, one tensor a output."""
    blocks = [_fetch(f.result(), device) for f in _wait_all(futures)]
    return tuple(torch.cat(parts) for parts in zip(*blocks))


def _marks(devices) -> list:
    """Events on the calling thread's current stream of each CUDA device
    (and on its default stream, where the slots' engines were made): work
    that waits for them comes after everything queued there so far."""
    marks = []
    for d in dict.fromkeys(devices):
        if d.type != "cuda":
            continue
        cur, default = torch.cuda.current_stream(d), torch.cuda.default_stream(d)
        for stream in (cur,) if cur == default else (cur, default):
            marks.append(torch.cuda.Event())
            marks[-1].record(stream)
    return marks


_streams: dict = {}
_streams_lock = threading.Lock()


def _side(device: torch.device, name: str):
    """The stream `name` of `device` (made once and kept), made to wait
    first for the events this thread's task runs after."""
    with _streams_lock:
        stream = _streams.get((device.index, name))
        if stream is None:
            stream = torch.cuda.Stream(device=device)
            _streams[(device.index, name)] = stream
    return _wait(stream)


def _wait(stream):
    """`stream`, made to wait for the events this thread's task runs
    after."""
    for mark in _this.after:
        stream.wait_event(mark)
    return stream


def _to(x: torch.Tensor, device: torch.device, what: str) -> torch.Tensor:
    """x on `device`. From another GPU, x (a slot's share of an operand:
    rows of words at a pitch) is copied by the copy engines in one 2-D
    memcpy (copy_pitched) on a stream of `device` for this slot, after the
    work queued before the slot's task (on x's GPU too: the step marks the
    operands' devices); no kernel runs on either GPU, so the copy does not
    wait behind x's GPU's compute. An x at no one pitch is first made
    contiguous on x's GPU, and the copy waits for that. The current stream
    of `device` waits for the copy."""
    if x.device == device or "cpu" in (x.device.type, device.type):
        return x.to(device)
    gathered = None
    if pitch_of(x) is None:
        src = _wait(torch.cuda.current_stream(x.device))
        x = x.contiguous()
        gathered = torch.cuda.Event()
        gathered.record(src)
    side = _side(device, f"to {_this.slot}")
    if gathered is not None:
        side.wait_event(gathered)
    with _span(what, device, side), torch.cuda.stream(side):
        out = copy_pitched(x, device)
    x.record_stream(side)
    current = torch.cuda.current_stream(device)
    current.wait_stream(side)
    out.record_stream(current)
    return out


def _on(device: torch.device, fn, *args, slot: str = "", after=None,
        own: bool = False):
    """fn(*args) with `device` current (a CUDA device; nothing to do for
    the CPU), as the work of `slot` (the name a Timeline gives its spans),
    after the events `after`: on the slot's own stream of the device (own)
    or on its current stream."""
    _this.slot, _this.after = slot, after or []
    if device.type != "cuda":
        return fn(*args)
    with torch.cuda.device(device):
        if not own:
            _wait(torch.cuda.current_stream(device))
            return fn(*args)
        with torch.cuda.stream(_side(device, f"slot {slot}")):
            return fn(*args)


class _Task(threading.local):
    """The slot whose work this thread runs, and the events it runs
    after."""
    slot = ""
    after = ()


_this = _Task()
class Timeline:
    """The spans of words steps on the card: the set-up copy of a slot's
    share of each operand, its partial, each partial's transfer to its
    lead, the lead's finish. Each is a device span (spans.device_span),
    timed on the stream of its slot's device that runs it and placed on
    time.time_ns() by the origin event the recording took on every GPU,
    so the spans of distinct GPUs share one time axis (to the
    microseconds between an origin's record and its clock reading)."""

    def __init__(self, clock):
        self._clock = clock

    def read(self) -> list[dict]:
        """Every span as {slot, what, device, stream (its handle),
        start_ms, end_ms} (from the recording's start), in the order they
        were enqueued (waits for each span's end)."""
        t0 = self._clock.start_ns
        return [dict(slot=s.where["slot"], what=s.name,
                     device=str(s.where["stream"].device),
                     stream=s.where["stream"].cuda_stream,
                     start_ms=(s.start_ns - t0) / 1e6,
                     end_ms=(s.end_ns - t0) / 1e6)
                for s in self._clock.read()]


@contextlib.contextmanager
def timeline():
    """Record the spans of the words steps run inside (a Timeline; one
    at a time). Off, a span costs a global's None check."""
    with spans.device_spans() as clock:
        yield Timeline(clock)


def _span(what: str, device: torch.device, stream=None, slot=None):
    """Time the work enqueued inside on `stream` (default: the current
    stream of `device`) as a span of `slot` (default: this thread's)."""
    return spans.device_span(what, device, stream, slot or _this.slot)


def _wait_all(futures):
    """The futures, once all have finished (a failure does not leave the
    other slots running behind it)."""
    for f in futures:
        f.exception()
    return futures


class _JoinedCopy:
    """The pending copies of one block's row parts (futures of HostCopy):
    numpy() joins them in row order."""

    def __init__(self, futures):
        self._futures = futures

    def numpy(self) -> np.ndarray:
        parts = [f.result().numpy() for f in _wait_all(self._futures)]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)


def _join_rows(parts: list[SparseKnnRows]) -> SparseKnnRows:
    """The row blocks of a kNN result, in order, as one."""
    valid = (None if parts[0].valid is None
             else np.concatenate([p.valid for p in parts]))
    return SparseKnnRows(np.concatenate([p.idx for p in parts]),
                         np.concatenate([p.vals for p in parts]), valid)


def _put(x, device, rows: slice, cols: slice, what: str) -> torch.Tensor:
    """The rows `rows` and last-axis words `cols` of u64 sketch words x (a
    numpy array, or an int64 tensor) on `device`: only that slice moves (a
    tensor on the same device is used in place)."""
    if isinstance(x, torch.Tensor):
        return _to(x[rows][..., cols], device, what)
    with _span(what, device):
        return words_to_device(np.asarray(x)[rows][..., cols], device)


def _vec(x, device, rows=slice(None)) -> torch.Tensor | None:
    """f32 values x[rows] (numpy, or a tensor) contiguous on `device`."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return _to(x[rows], device, "setup c").to(
            dtype=torch.float32).contiguous()
    return _f32(np.asarray(x)[rows], device)


def _host(x) -> np.ndarray | None:
    return None if x is None else np.asarray(
        x.cpu() if isinstance(x, torch.Tensor) else x)


class _Operands:
    """A step's operands as one slot sees them: the slot's words range
    `cols` of the column operand b (and its packed signs) on its device,
    uploaded once a device and words slot; of the row operand a, a row
    block's on demand."""

    def __init__(self, a, b, device, cols: slice, b_sig=None):
        self.a, self.cols, self.device = a, cols, device
        self.b = _put(b, device, slice(None), cols, "setup b")
        self.b_sig = (pack_signs(b_sig, device) if b_sig is not None
                      else None)

    def rows(self, rows: slice) -> torch.Tensor:
        return _put(self.a, self.device, rows, self.cols, "setup a")


def _step(a, b, s64: int, mesh, partial, finish, b_sig=None,
          more=()) -> tuple:
    """The rows of a over the mesh's row blocks and the words of a and b
    over its words slots: finish at each lead (DeviceSlots.split_words),
    the blocks joined on the grid's first slot. `more`: the other operands
    the finish reads (completeness values)."""
    mesh = as_mesh(mesh)
    ranges = word_ranges(s64, mesh.shape["words"])
    if a.shape[-1] != s64 * BBITS or b.shape[-1] != s64 * BBITS:
        raise ValueError(f"a and b need s64 * {BBITS} = {s64 * BBITS} words "
                         f"a row, got {a.shape[-1]} and {b.shape[-1]}")
    sources = [x.device for x in (a, b, *more)
               if isinstance(x, torch.Tensor)]
    slots = DeviceSlots(mesh, lambda d, w: _Operands(a, b, d, ranges[w],
                                                     b_sig), sources)
    try:
        return _join(slots.split_words(0, a.shape[0], partial, finish),
                     mesh.grid[0][0])
    finally:
        slots.close()


def sharded_samebits(a, b, s64: int, mesh) -> torch.Tensor:
    """(na, nb) int32 samebits of the u64 sketch words a (na, W) and b
    (nb, W) (numpy arrays or int64 tensors in the .skd order, W = s64 *
    BBITS) over `mesh` (a Mesh, or a list of devices): the rows of a split
    over its rows, the chunks of both over its words slots, each slot's
    K4 partial summed at its row block's lead by samebits_finish. A tensor
    on the grid's first slot, rows joined in order (the JAX
    _sharded_samebits)."""
    def partial(op, rows):
        return samebits_full(op.rows(rows), op.b)

    def finish(op, rows, parts):
        return _ready(partial(op, rows) if parts is None
                      else samebits_finish(parts))

    return _step(a, b, s64, mesh, partial, finish)[0]


def sharded_dist_step(a, b, s64: int, mesh, k: float = 0.0,
                      ani: bool = False) -> torch.Tensor:
    """One sharded distance step, samebits to f32 distances, as
    sharded_samebits lays it out: each words slot counts its range with
    K4, and each row block's lead sums the counts and finishes
    (samebits_finish), so the distances are jaccard_dist_block's bit for
    bit; a rows-only grid runs samebits_dist on each row block. (na, nb)
    f32 1 - j, or with ani the ANI at k, on the grid's first slot."""
    def partial(op, rows):
        return samebits_full(op.rows(rows), op.b)

    def finish(op, rows, parts):
        if parts is None:
            return _ready(samebits_dist(op.rows(rows), op.b, s64, k=k,
                                        ani=ani))
        return _ready(samebits_finish(parts, s64, k=k, ani=ani))

    return _step(a, b, s64, mesh, partial, finish)[0]


def sharded_coreacc_step(a_stack, b_stack, s64: int, mesh, kmers,
                         sketch_size: int, c1=None, c2=None,
                         cutoff: float = 0.64) -> torch.Tensor:
    """Multi-k core/accessory over `mesh`: a_stack (na, nk, W) and b_stack
    (nb, nk, W) u64 words (numpy or int64 tensors, the .skd order, k
    ascending). On a rows-only grid each row block runs K2; with words
    slots each slot's per-k K4 partials (samebits_stack, one launch) go to
    the lead, which runs coreacc_chain over them as they stand (K2's chain
    on their sums, bit for bit) with c1 (na,) / c2 (nb,) f32 completeness
    applied after the sum. (na, nb, 2) f32 (core, acc) on the grid's first
    slot. The port's chain centres k (coreacc_kernels), so values differ
    from the JAX step's within ~1e-5."""
    def partial(op, rows):
        return samebits_stack(op.rows(rows), op.b)

    def finish(op, rows, parts):
        v1, v2 = _vec(c1, op.device, rows), _vec(c2, op.device)
        if parts is None:
            core, acc = coreacc(op.rows(rows), op.b, kmers, sketch_size, v1,
                                v2, cutoff)
        else:
            core, acc = coreacc_chain(parts, kmers, sketch_size, s64, v1, v2,
                                      cutoff)
        return _ready(torch.stack([core, acc], dim=-1))

    return _step(a_stack, b_stack, s64, mesh, partial, finish,
                 more=(c1, c2))[0]


def _rows_only(mesh) -> Mesh:
    mesh = as_mesh(mesh)
    if mesh.shape["words"] != 1:
        raise ValueError("sharded kNN requires an unsharded word axis")
    return mesh


def _sign_mask(a_sig, rows: slice, op) -> SignMask | None:
    if a_sig is None:
        return None
    a_sig = np.asarray(a_sig)
    return SignMask(pack_signs(a_sig[rows], op.device), op.b_sig,
                    a_sig.shape[1])


def sharded_knn_step(a, b, s64: int, mesh, knn: int, n_real: int,
                     exclude_self: bool, col_tile: int = 2048,
                     row_base: int = 0, c1=None, c2=None,
                     cutoff: float = 0.64, a_sig=None, b_sig=None):
    """Sparse kNN selection over a rows-only mesh: the rows of a (na, W)
    split over its rows, the first n_real rows of b (the real columns) whole
    on each; each row block is one K3 selection (knn_scan_tensors) with
    global row ids row_base + i. Returns (values, indices) int32 (na, knn)
    on the grid's first slot: the selected samebits and columns, value
    descending then column ascending, -0x7FFFFFFF / 0x7FFFFFFF where a row
    has fewer than knn candidates. c1 (na,) / c2 f32 select by the
    completeness-corrected Jaccard; a_sig (na, S) / b_sig u16 signs of the
    inverted index keep only pairs that share one. col_tile is the JAX
    signature's: K3 walks every column in one launch."""
    _rows_only(mesh)
    c1, c2 = _host(c1), _host(c2)
    cols = _host(b_sig)[:n_real] if b_sig is not None else None

    def finish(op, rows, parts):
        return _ready(*knn_scan_tensors(
            op.rows(rows), op.b, knn, exclude_self=exclude_self,
            comp_rows=c1[rows] if c1 is not None else None,
            comp_cols=c2[:n_real] if c2 is not None else None,
            cutoff=cutoff, row0=row_base + rows.start,
            sig=_sign_mask(a_sig, rows, op)))

    return _step(a, b[:n_real], s64, mesh, None, finish, cols)


def sharded_knn_ca_step(a_stack, b_stack, s64: int, mesh, knn: int,
                        n_real: int, exclude_self: bool, kmers,
                        sketch_size: int, col_tile: int = 2048,
                        row_base: int = 0, c1=None, c2=None,
                        cutoff: float = 0.64, a_sig=None, b_sig=None):
    """Core/accessory kNN over a rows-only mesh: the rows of a_stack (na,
    nk, W) split over its rows, the first n_real of b_stack whole on each;
    each row block selects by f32 core distance over K2's key tiles
    (knn_torch.scan_coreacc). Returns (core, acc, indices) (na, knn) on
    the grid's first slot; core = inf and index 0x7FFFFFFF where a row has
    fewer than knn candidates. c1 / c2, a_sig / b_sig and col_tile as in
    sharded_knn_step."""
    _rows_only(mesh)
    cols = _host(b_sig)[:n_real] if b_sig is not None else None

    def finish(op, rows, parts):
        return _ready(*scan_coreacc(
            op.rows(rows), op.b, kmers, sketch_size, knn, exclude_self,
            _vec(c1, op.device, rows),
            _vec(c2, op.device, slice(0, n_real)), cutoff,
            row_base + rows.start, _sign_mask(a_sig, rows, op)))

    return _step(a_stack, b_stack[:n_real], s64, mesh, None, finish, cols,
                 (c1, c2))


class ShardedSamebitsEngine:
    """samebits engine over a Mesh, or a list of devices (rows only):
    sharded_samebits of each call. Drop-in `engine` for dist/api.py."""

    def __init__(self, sketchsize64: int, devices=None):
        self.s64 = sketchsize64
        self.mesh = as_mesh(devices)
        word_ranges(sketchsize64, self.mesh.shape["words"])

    def matrix(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """All-pairs samebits: a (na, W) u64, b (nb, W) u64 -> (na, nb)."""
        return sharded_samebits(a, b, self.s64, self.mesh).cpu().numpy()


class _WordsShare:
    """One words slot of ShardedCoreAccEngine: every sample's words of the
    slot's range (`cols`) on its device, and the completeness values."""

    def __init__(self, ms, device, w: int, cols: slice, comp):
        self.device, self.key, self.cols = torch.device(device), (device, w), cols
        self.words = to_device_words(ms, self.device, cols=cols)
        self.comp = _f32(comp, self.device) if comp is not None else None


class ShardedCoreAccEngine:
    """Dense multi-k core/accessory over a Mesh, or a list of devices (rows
    only). Each tile's rows (tile rows at a time, as the JAX engine) split
    over the row blocks; on a rows-only grid every sample's words are on
    each device and each block runs K2; with words slots each slot holds
    its words range of every sample, its per-k K4 partials are summed at
    the block's lead and coreacc_chain finishes (K2's bits). The blocks of
    a tile are written in row order while the next tile runs."""

    def __init__(self, ms, devices=None, tile: int = 4096,
                 completeness_vec=None, completeness_cutoff: float = 0.64):
        self.tile = tile
        self.mesh = as_mesh(devices)
        self.words = self.mesh.shape["words"]
        self.kmers, self.sketch_size = tuple(ms.kmer_lengths), ms.sketch_size
        self.s64 = ms.sketchsize64
        self._cutoff = float(completeness_cutoff)
        if self.words == 1:
            def make(d, w):
                return DeviceCoreAccEngine(
                    ms, d, tile=tile, completeness_vec=completeness_vec,
                    completeness_cutoff=completeness_cutoff)
        else:
            ranges = word_ranges(ms.sketchsize64, self.words)

            def make(d, w):
                return _WordsShare(ms, d, w, ranges[w], completeness_vec)
        self.slots = DeviceSlots(self.mesh, make)

    def _launch(self, r0: int, r1: int, fn) -> _JoinedCopy:
        """fn(engine, a, b) launched on each row slot for its block [a, b)
        of the rows [r0, r1) (a rows-only grid)."""
        blocks = split_rows(r0, r1, len(self.slots))
        return _JoinedCopy([self.slots.submit(i, fn, b.start, b.stop)
                            for i, b in enumerate(blocks)])

    def _split(self, r0: int, r1: int, cols_of, comp_of,
               cutoff: float) -> _JoinedCopy:
        """The (rows, cols, 2) core/accessory of the rows [r0, r1) against
        the words cols_of(share) of each words slot: per-k partials on
        every slot, coreacc_chain over them at each row block's lead with
        the completeness comp_of(share, rows) -> (c1, c2) or (None,
        None)."""
        def partial(share, rows):
            return samebits_stack(share.words[rows], cols_of(share))

        def finish(share, rows, parts):
            c1, c2 = comp_of(share, rows)
            core, acc = coreacc_chain(parts, self.kmers, self.sketch_size,
                                      self.s64, c1, c2, cutoff)
            return HostCopy(torch.stack([core, acc], dim=-1))

        return _JoinedCopy(self.slots.split_words(r0, r1, partial, finish))

    def _self_comp(self, cols: slice):
        def comp_of(share, rows):
            if share.comp is None:
                return None, None
            return share.comp[rows], share.comp[cols]

        return comp_of

    def tile_dists(self, rows: slice, cols: slice) -> np.ndarray:
        """(rows, cols, 2) f32 core/accessory, rows split over the row
        blocks."""
        if self.words > 1:
            return self._split(rows.start, rows.stop,
                               lambda share: share.words[cols],
                               self._self_comp(cols), self._cutoff).numpy()
        blocks = split_rows(rows.start, rows.stop, len(self.slots))
        return np.concatenate(self.slots.map(
            lambda eng, r: eng.tile_dists(r, cols), blocks))

    def stream_self_dense(
        self, out, names: list[str], row_range: slice | None = None
    ) -> None:
        """The upper-triangle long-form output (DeviceCoreAccEngine's)."""
        n = len(names)

        def emit(block, r0, r1, tab_r, tab_q, pipe):
            emit_coreacc_self_block(out, names, tab_r, block, r0, r1, n,
                                    pipe=pipe)

        if self.words > 1:
            every = slice(0, n)

            def launch(r0, r1):
                return self._split(r0, r1, lambda share: share.words,
                                   self._self_comp(every), self._cutoff)
        else:
            def launch(r0, r1):
                return self._launch(r0, r1, DeviceCoreAccEngine.self_block)
        stream_blocks(out, names, names, row_range, self.tile, launch, emit)

    def stream_cross_dense(
        self,
        out,
        ref_names: list[str],
        query_names: list[str],
        query_ms,
        rcomp=None,
        qcomp=None,
        cutoff: float = 0.64,
        row_range: slice | None = None,
    ) -> None:
        """Ref-major rectangular output (DeviceCoreAccEngine's): reference
        rows split over the row blocks, the query words (of each words
        slot's range) whole on each device. Completeness applies only when
        both sides have values."""
        nq = query_ms.number_samples_loaded()
        comp_on = rcomp is not None and qcomp is not None
        on_device = {}
        for key, eng in self.slots.engines.items():
            on_device[key] = (
                to_device_words(query_ms, eng.device,
                                cols=getattr(eng, "cols", None)),
                _f32(rcomp, eng.device) if comp_on else None,
                _f32(qcomp, eng.device) if comp_on else None,
            )

        def emit(block, r0, r1, tab_r, tab_q, pipe):
            emit_coreacc_cross_block(out, ref_names, query_names, tab_r,
                                     tab_q, block, r0, r1, nq, pipe=pipe)

        if self.words > 1:
            def comp_of(share, rows):
                _, rc_v, qc_v = on_device[share.key]
                return (rc_v[rows], qc_v) if comp_on else (None, None)

            def launch(r0, r1):
                return self._split(r0, r1,
                                   lambda share: on_device[share.key][0],
                                   comp_of, cutoff)
        else:
            def cross(eng, a, b):
                q, rc_v, qc_v = on_device[(eng.device, 0)]
                return eng.cross_block(q, a, b, rc_v, qc_v, cutoff)

            def launch(r0, r1):
                return self._launch(r0, r1, cross)
        stream_blocks(out, ref_names, query_names, row_range, self.tile,
                      launch, emit)


class ShardedKnnEngine:
    """Sparse kNN over several devices: the rows (samples, or queries)
    split over the slots, every sample's words on each device; each slot
    runs DeviceKnnEngine on its rows, whose lists join in row order.
    Same self_knn / cross_knn / *_coreacc / precluster_knn interface as
    DeviceKnnEngine (the precluster scan splits its rows too)."""

    def __init__(self, ms, devices=None, row_tile: int = 2048,
                 col_tile: int = 8192):
        self.ms = ms
        self.n = ms.number_samples_loaded()
        self.slots = DeviceSlots(_rows_only(devices), lambda d, w:
                                 DeviceKnnEngine(ms, d, row_tile=row_tile,
                                                 col_tile=col_tile))

    def _rows(self, lo: int, hi: int, fn) -> SparseKnnRows:
        """fn(engine, block) on each slot's block of [lo, hi), joined."""
        return _join_rows(self.slots.map(
            fn, split_rows(lo, hi, len(self.slots))))

    def _span(self, row_range: slice | None, n: int) -> tuple[int, int]:
        return (row_range.start, row_range.stop) if row_range else (0, n)

    def self_knn(self, knn: int, dist_type, row_range: slice | None = None,
                 completeness_vec=None, completeness_cutoff: float = 0.64):
        return self._rows(*self._span(row_range, self.n),
                          lambda eng, rows: eng.self_knn(
                              knn, dist_type, row_range=rows,
                              completeness_vec=completeness_vec,
                              completeness_cutoff=completeness_cutoff))

    def cross_knn(self, query_ms, knn: int, dist_type,
                  ref_completeness_vec=None, query_completeness_vec=None,
                  completeness_cutoff: float = 0.64):
        return self._rows(0, query_ms.number_samples_loaded(),
                          lambda eng, rows: eng.cross_knn(
                              query_ms, knn, dist_type,
                              ref_completeness_vec=ref_completeness_vec,
                              query_completeness_vec=query_completeness_vec,
                              completeness_cutoff=completeness_cutoff,
                              query_rows=rows))

    def self_knn_coreacc(self, knn: int, row_range: slice | None = None,
                         completeness_vec=None,
                         completeness_cutoff: float = 0.64):
        return self._rows(*self._span(row_range, self.n),
                          lambda eng, rows: eng.self_knn_coreacc(
                              knn, row_range=rows,
                              completeness_vec=completeness_vec,
                              completeness_cutoff=completeness_cutoff))

    def cross_knn_coreacc(self, query_ms, knn: int,
                          ref_completeness_vec=None,
                          query_completeness_vec=None,
                          completeness_cutoff: float = 0.64):
        return self._rows(0, query_ms.number_samples_loaded(),
                          lambda eng, rows: eng.cross_knn_coreacc(
                              query_ms, knn,
                              ref_completeness_vec=ref_completeness_vec,
                              query_completeness_vec=query_completeness_vec,
                              completeness_cutoff=completeness_cutoff,
                              query_rows=rows))

    def precluster_knn(self, inverted, skq_bins: np.ndarray, knn: int,
                       dist_type, retain_unmatched: str | None = None,
                       row_range: slice | None = None,
                       completeness_vec=None,
                       completeness_cutoff: float = 0.64) -> SparseKnnRows:
        """DeviceKnnEngine.precluster_knn with the rows split over the
        slots: the signs are gathered once and packed once a device;
        candidates and --retain-unmatched bruteforce rows range over all
        samples on each."""
        lo, hi = self._span(row_range, self.n)
        if knn < 1:
            return _no_neighbours(lo, hi, dist_type, retain_unmatched)
        signs = precluster_signs(self.ms, inverted, skq_bins)
        packed = {dev: pack_signs(signs, dev)
                  for dev in self.slots.distinct_devices()}
        comp = (np.asarray(completeness_vec, dtype=np.float64)
                if completeness_vec is not None else None)
        return self._rows(lo, hi, lambda eng, rows: eng.precluster_rows(
            packed[eng.device], inverted.sketch_size, knn, dist_type,
            retain_unmatched, rows.start, rows.stop, comp,
            completeness_cutoff))


class ShardedInvertedEngine:
    """Inverted-index queries and the precluster pair count over several
    devices (DeviceInvertedEngine's interface), the packed sign matrix
    whole on each device. The count splits the index rows into blocks of
    near-equal pair counts, one a slot, and sums the exact partials in
    Python ints; a query splits the index rows too, so that each slot
    holds every query in signeq's resident query group, and the column
    blocks join in order."""

    def __init__(self, sign_matrix: np.ndarray, devices=None):
        self.n = int(sign_matrix.shape[0])
        mesh = as_mesh(devices)
        if mesh.shape["words"] != 1:
            raise ValueError("sharded inverted engine needs words=1")
        self.slots = DeviceSlots(
            mesh, lambda d, w: DeviceInvertedEngine(sign_matrix, d))

    def any_shared_bin_count(self, row_range: slice | None = None) -> int:
        lo, hi = (row_range.start, row_range.stop) if row_range else (0, self.n)
        return sum(self.slots.map(
            lambda eng, rows: eng.any_shared_bin_count(row_range=rows),
            split_pairs(lo, hi, self.n, len(self.slots))))

    def _query(self, queries: np.ndarray, mode: str) -> np.ndarray:
        return np.concatenate(self.slots.map(
            lambda eng, cols: eng.scan(queries, mode, cols),
            split_rows(0, self.n, len(self.slots))), axis=1)

    def match_counts(self, queries: np.ndarray) -> np.ndarray:
        return self._query(queries, "count").astype(np.int64)

    def any_shared_rows(self, queries: np.ndarray) -> np.ndarray:
        return self._query(queries, "any")

    def all_shared_rows(self, queries: np.ndarray) -> np.ndarray:
        return self._query(queries, "all")
