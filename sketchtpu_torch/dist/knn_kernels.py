"""K3, the kNN scan: the CUDA kernels of csrc/knn_scan.cu and their plain
PyTorch twins.

Replaces sketchtpu/dist/pallas_kernels.py::samebits_pallas_chunked
together with the key epilogue and the running top-k merge the JAX scans
wrap around it in XLA (dist/knn_jax.py::_knn_scan_block_packed,
_knn_scan_block_comp). The rows and columns are k-planes of (n, nk, W)
sketch words, read in place through their row stride as K1 reads them;
there is no chunk-group relayout. Two modes: knn_select() keeps each row's
knn best keys inside the kernel while it walks the whole column plane and
returns only (rows, knn); knn_keys() returns the keys of one tile.

Keys (see csrc/knn_scan.cu): plain mode packs (samebits, column) into one
int32 (or, past the int32 key's column range, int64); completeness mode
packs (corrected f32 Jaccard, column) into one int64. Every key holds its
column, so keys are unique and a descending top-k over them selects value
descending, then column ascending. Invalid pairs are -1, below every valid
key. With a SignMask (the inverted index's precluster) a pair whose rows
share no sign of the index is invalid too.
"""

from __future__ import annotations

import torch

from .. import _build
from ..constants import BBITS
from .sign_words import any_mask_ref
from .samebits_kernels import _check_words, samebits_ref, scalar_divisors

_MAX_GRID_Y = 65535
_TI = 64  # rows per block of knn_scan.cu
MAX_KNN = 1024  # the selection kernel's per-row lists live in shared memory
_REF_ROW_TILE, _REF_COL_TILE = 2048, 8192  # a merge step of the selection twin
INVALID = -1
COLMASK64 = (1 << 32) - 1


def pack_shift(s64: int) -> int:
    """Bits of the column field of a plain int32 key: 31 minus the bits
    samebits (<= s64*64) needs (_pack_shift of the JAX scan)."""
    return 31 - int(s64 * 64).bit_length()


def key_layout(s64: int, n_cols: int, comp: bool):
    """(dtype, shift, colmask) of the keys for columns [0, n_cols): the
    JAX scan's int32 packing while the column field holds every column,
    else int64 with a 32-bit column field."""
    shift = pack_shift(s64)
    if not comp and n_cols <= (1 << shift) - 1:
        return torch.int32, shift, (1 << shift) - 1
    return torch.int64, 32, COLMASK64


class Completeness:
    """Completeness correction of a completeness-mode scan: c1 (rows) and
    c2 (all columns) contiguous f32, applied where c1*c2 >= cutoff."""

    def __init__(self, c1: torch.Tensor, c2: torch.Tensor, cutoff: float,
                 s64: int):
        self.c1, self.c2, self.cutoff = c1, c2, float(cutoff)
        self.maxnbits = float(s64 * 64)
        self.expected = float(int(s64 * 64) >> BBITS)


class SignMask:
    """The precluster mask of a masked scan: the rows' and the columns'
    packed u16 signs (sign_words.pack_signs; the columns' from column
    id 0, or from col0 for a tile) and the sign count. A pair is a
    candidate only where its two rows hold the same sign in some bin."""

    def __init__(self, rows: torch.Tensor, cols: torch.Tensor, nsigns: int):
        self.rows, self.cols, self.nsigns = rows, cols, int(nsigns)

    def block(self, r0: int, r1: int) -> "SignMask":
        """The mask of rows [r0, r1) against the same columns."""
        return SignMask(self.rows[r0:r1], self.cols, self.nsigns)

    def tile_mask(self, ncols: int, col0: int, tc: int) -> torch.Tensor:
        """(tr, tc) bool twin mask of the columns [col0, col0 + tc), of
        which the first ncols are real (the rest False)."""
        m = torch.zeros((self.rows.shape[0], tc), dtype=torch.bool,
                        device=self.rows.device)
        m[:, :ncols] = any_mask_ref(self.rows, self.cols[col0 : col0 + ncols],
                                    self.nsigns)
        return m

    def args(self, col0: int):
        """The kernels' mask arguments: rows' and columns' (from column
        col0) sign pointers, words a row, row stride, odd sign count."""
        return (self.rows.data_ptr(), self.cols[col0:].data_ptr(),
                self.rows.shape[1], self.rows.stride(0), self.nsigns % 2)

    def check(self, tr: int, nb_real: int, device) -> None:
        words = (self.nsigns + 1) // 2
        for name, t, m in (("rows", self.rows, tr), ("cols", self.cols, None)):
            if (t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != words
                    or t.stride(1) != 1 or t.device != device
                    or (m is not None and t.shape[0] != m)):
                raise ValueError(f"sig.{name} must be int32 packed signs "
                                 f"({m or 'n'}, {words}) on {device}")
        if self.rows.stride(0) != self.cols.stride(0):
            raise ValueError("sig.rows and sig.cols need one row stride")
        if self.cols.shape[0] < nb_real:
            raise ValueError("sig.cols must hold every real column")


_NO_SIG = (None, None, 0, 0, 0)  # the kernels' mask arguments without one


def _ordered_bits(v: torch.Tensor) -> torch.Tensor:
    """int32 whose signed order is the f32 order of v."""
    b = v.view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def corrected_jaccard(sb: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
                      comp: Completeness) -> torch.Tensor:
    """The JAX completeness scan's f32 selection key, op for op."""
    maxnbits, expected = comp.maxnbits, comp.expected
    denom, mnb = scalar_divisors(sb.device, maxnbits - expected, maxnbits)
    diff = torch.clamp_min(sb.to(torch.float32) - expected, 0.0)
    j = diff * maxnbits / denom / mnb
    prod = c1[:, None] * c2[None, :]
    factor = prod / (c1[:, None] + c2[None, :] - prod)
    return torch.where(prod >= comp.cutoff, torch.clamp(j / factor, max=1.0), j)


def pack_keys(value: torch.Tensor, cols: torch.Tensor, dtype, shift: int,
              colmask: int, valid: torch.Tensor,
              invalid: int = INVALID) -> torch.Tensor:
    """Keys of a (rows, cols) tile: value (int samebits, or f32 for the
    int64 float keys) in the high field, colmask - col below it; `invalid`
    where not valid."""
    if value.dtype == torch.float32:
        hi = _ordered_bits(value).to(torch.int64) * (1 << 32)
    else:
        hi = value.to(dtype) * (1 << shift)
    key = hi + (colmask - cols).to(dtype)[None, :]
    return key.masked_fill(~valid, invalid)


def knn_keys_ref(a: torch.Tensor, b: torch.Tensor, *, row0: int = 0,
                 col0: int = 0, nb_real: int | None = None,
                 exclude_self: bool = False,
                 comp: Completeness | None = None,
                 sig: SignMask | None = None) -> torch.Tensor:
    """Plain PyTorch twin of knn_keys(): the same keys on any device."""
    tr, tc = a.shape[0], b.shape[0]
    s64 = a.shape[1] // BBITS
    nb_real = col0 + tc if nb_real is None else nb_real
    ncols = max(0, min(tc, nb_real - col0))
    dtype, shift, colmask = key_layout(s64, nb_real, comp is not None)
    sb = torch.zeros((tr, tc), dtype=torch.int32, device=a.device)
    sb[:, :ncols] = samebits_ref(a, b[:ncols])
    cols = col0 + torch.arange(tc, device=a.device)
    valid = (cols < nb_real)[None, :].expand(tr, tc)
    if exclude_self:
        rows = row0 + torch.arange(tr, device=a.device)
        valid = valid & (cols[None, :] != rows[:, None])
    if sig is not None:
        valid = valid & sig.tile_mask(ncols, col0, tc)
    value = sb
    if comp is not None:
        c2 = torch.ones(tc, dtype=torch.float32, device=a.device)
        c2[:ncols] = comp.c2[col0 : col0 + ncols]
        value = corrected_jaccard(sb, comp.c1, c2, comp)
    return pack_keys(value, cols, dtype, shift, colmask, valid)


def knn_keys(a: torch.Tensor, b: torch.Tensor, *, row0: int = 0,
             col0: int = 0, nb_real: int | None = None,
             exclude_self: bool = False,
             comp: Completeness | None = None,
             sig: SignMask | None = None) -> torch.Tensor:
    """(tr, tc) selection keys of the rows a (tr, W) against the columns
    b (tc, W) (k-planes of sketch words, rows contiguous, any row stride).

    Row i has the global id row0 + i, column j the global id col0 + j.
    Columns with id >= nb_real (default: all of b is real) are never read
    and get -1, as does column == row with exclude_self. With comp
    (comp.c1 (tr,) for these rows, comp.c2 (>= nb_real,) for all columns)
    the keys are int64 corrected-Jaccard keys; otherwise int32 samebits
    keys while nb_real fits the int32 column field, else int64. With sig
    (sig.rows (tr,) for these rows, sig.cols for every column id) a pair
    that shares no sign gets -1 too. CUDA tensors launch the kernel, CPU
    tensors run the twin."""
    nb_real = col0 + b.shape[0] if nb_real is None else nb_real
    _check_scan(a, b, min(row0, col0), nb_real, comp, sig)
    if a.device.type == "cpu":
        return knn_keys_ref(a, b, row0=row0, col0=col0, nb_real=nb_real,
                            exclude_self=exclude_self, comp=comp, sig=sig)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if a.shape[0] == 0 or b.shape[0] == 0:
        dtype = key_layout(a.shape[1] // BBITS, nb_real, comp is not None)[0]
        return torch.full((a.shape[0], b.shape[0]), INVALID, dtype=dtype,
                          device=a.device)
    out = _launch_knn_keys(a, b, row0, col0, nb_real, exclude_self, comp,
                           sig)
    knn_keys.launches += 1
    knn_keys.masked_launches += sig is not None
    return out


knn_keys.launches = 0
knn_keys.masked_launches = 0


def _launch_knn_keys(a, b, row0, col0, nb_real, exclude_self, comp, sig):
    s64 = a.shape[1] // BBITS
    dtype, shift, colmask = key_layout(s64, nb_real, comp is not None)
    tr, tc = a.shape[0], b.shape[0]
    if tr > _MAX_GRID_Y * _TI:
        raise ValueError(f"knn_keys: {tr} rows exceed one launch")
    out = torch.empty((tr, tc), dtype=dtype, device=a.device)
    ncols = max(0, min(tc, nb_real - col0))
    _build.launch(
        a.device, "stpu_knn_keys",
        a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
        out.data_ptr(), tc, tr, tc, ncols, s64, row0, col0,
        int(exclude_self), shift, colmask, out.element_size(),
        *_comp_args(comp, col0),
        *(sig.args(col0) if sig is not None else _NO_SIG),
        what="knn_keys",
    )
    return out


def knn_select_ref(rows: torch.Tensor, cols: torch.Tensor, knn: int, *,
                   row0: int = 0, nb_real: int | None = None,
                   exclude_self: bool = False,
                   comp: Completeness | None = None,
                   sig: SignMask | None = None,
                   row_tile: int = _REF_ROW_TILE,
                   col_tile: int = _REF_COL_TILE) -> torch.Tensor:
    """Plain PyTorch twin of knn_select(): per block of row_tile rows, the
    tile twin's keys per column tile, merged into the running selection
    with torch.topk."""
    nb_real = cols.shape[0] if nb_real is None else nb_real
    s64 = rows.shape[1] // BBITS
    dtype = key_layout(s64, nb_real, comp is not None)[0]
    blocks = [torch.full((0, knn), INVALID, dtype=dtype, device=rows.device)]
    for r0 in range(0, rows.shape[0], row_tile):
        part = rows[r0 : r0 + row_tile]
        c = (Completeness(comp.c1[r0 : r0 + row_tile], comp.c2, comp.cutoff,
                          s64) if comp is not None else None)
        carry = torch.full((part.shape[0], knn), INVALID, dtype=dtype,
                           device=rows.device)
        for c0 in range(0, min(cols.shape[0], nb_real), col_tile):
            keys = knn_keys_ref(
                part, cols[c0 : c0 + col_tile], row0=row0 + r0, col0=c0,
                nb_real=nb_real, exclude_self=exclude_self, comp=c,
                sig=sig.block(r0, r0 + row_tile) if sig is not None else None)
            carry = torch.topk(torch.cat([carry, keys], dim=1), knn, dim=1,
                               sorted=True).values
        blocks.append(carry)
    return torch.cat(blocks)


def _check_scan(rows, cols, row0, nb_real, comp, sig=None):
    _check_words("a", rows, 2)
    _check_words("b", cols, 2)
    if rows.shape[1] != cols.shape[1] or rows.device != cols.device:
        raise ValueError("a and b need the same width and device")
    if min(row0, nb_real) < 0 or nb_real > COLMASK64:
        raise ValueError(f"bad ids: row0={row0} nb_real={nb_real}")
    if comp is not None:
        if comp.c1.shape != (rows.shape[0],) or comp.c2.shape[0] < nb_real:
            raise ValueError("comp.c1 must hold tr values, comp.c2 nb_real")
        for name, c in (("c1", comp.c1), ("c2", comp.c2)):
            if (c.dtype != torch.float32 or c.dim() != 1
                    or not c.is_contiguous() or c.device != rows.device):
                raise ValueError(f"comp.{name} must be contiguous 1-D f32 "
                                 f"on {rows.device}")
    if sig is not None:
        sig.check(rows.shape[0], nb_real, rows.device)


def knn_select(rows: torch.Tensor, cols: torch.Tensor, knn: int, *,
               row0: int = 0, nb_real: int | None = None,
               exclude_self: bool = False, comp: Completeness | None = None,
               sig: SignMask | None = None,
               splits: int | None = None) -> torch.Tensor:
    """(tr, knn) keys: for every row of `rows` (tr, W) its knn largest
    knn_keys() keys over the whole column plane `cols` (nb, W), sorted
    descending, INVALID where the row has fewer valid columns.

    Row i has the global id row0 + i, column j the id j; columns with id
    >= nb_real are never read. Key layout, validity, the sign mask and
    completeness arithmetic are knn_keys()'s. CUDA tensors launch the kernel (at most
    MAX_KNN neighbours), CPU tensors run the twin. splits (the column
    ranges that separate blocks scan before a merge kernel joins them;
    default: enough to fill the card when there are few rows) changes no
    result."""
    nb_real = cols.shape[0] if nb_real is None else nb_real
    _check_scan(rows, cols, row0, nb_real, comp, sig)
    if knn < 1:
        raise ValueError(f"knn={knn} must be positive")
    if rows.device.type == "cpu":
        return knn_select_ref(rows, cols, knn, row0=row0, nb_real=nb_real,
                              exclude_self=exclude_self, comp=comp, sig=sig)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    if knn > MAX_KNN:
        raise ValueError(f"knn={knn} exceeds the kernel's limit of {MAX_KNN}")
    ncols = min(cols.shape[0], nb_real)
    if rows.shape[0] == 0 or ncols == 0:
        dtype = key_layout(rows.shape[1] // BBITS, nb_real, comp is not None)[0]
        return torch.full((rows.shape[0], knn), INVALID, dtype=dtype,
                          device=rows.device)
    out = _launch_knn_select(rows, cols, knn, row0, nb_real, exclude_self,
                             comp, splits, sig)
    knn_select.launches += 1
    knn_select.masked_launches += sig is not None
    return out


knn_select.launches = 0
knn_select.masked_launches = 0


_COLD_TILES = 8  # a split's empty-list start costs about 8 column tiles


def default_splits(tr: int, ncols: int, rows_per_block: int,
                   slots: int) -> int:
    """Column splits of a selection launch on a card that holds `slots`
    blocks at once. The blocks run in waves of `slots`; a block walks its
    share of the column tiles and pays for starting its lists empty (many
    inserts on its first tiles), so a launch takes about
    waves x (column tiles / splits + _COLD_TILES): the least of that, the
    fewest splits among equals."""
    row_tiles = -(-tr // rows_per_block)
    col_tiles = -(-ncols // _TI)

    def cost(splits):
        return -(-row_tiles * splits // slots) * (col_tiles / splits
                                                  + _COLD_TILES)

    return min(range(1, min(col_tiles, slots) + 1), key=cost)


def _launch_knn_select(rows, cols, knn, row0, nb_real, exclude_self, comp,
                       splits, sig):
    s64 = rows.shape[1] // BBITS
    dtype, shift, colmask = key_layout(s64, nb_real, comp is not None)
    tr, ncols = rows.shape[0], min(cols.shape[0], nb_real)
    key_bytes = 4 if dtype == torch.int32 else 8
    if splits is None:
        rows_per_block = _build.query(
            rows.device, "stpu_knn_select_rows", knn, key_bytes,
            int(sig is not None))
        if rows_per_block < 1:
            raise RuntimeError(f"knn_select: knn={knn} does not fit a block")
        splits = default_splits(tr, ncols, rows_per_block,
                                _block_slots(rows.device, knn, key_bytes,
                                             comp is not None,
                                             sig is not None))
    splits = max(1, min(int(splits), -(-ncols // _TI)))
    out = torch.empty((tr, knn), dtype=dtype, device=rows.device)
    part = (torch.empty((splits, tr, knn), dtype=dtype, device=rows.device)
            if splits > 1 else None)
    _build.launch(
        rows.device, "stpu_knn_select",
        rows.data_ptr(), rows.stride(0), cols.data_ptr(), cols.stride(0),
        out.data_ptr(), part.data_ptr() if part is not None else None, tr,
        ncols, s64, knn, splits, row0, int(exclude_self), shift, colmask,
        key_bytes, *_comp_args(comp, 0),
        *(sig.args(0) if sig is not None else _NO_SIG),
        what="knn_select",
    )
    return out


def _block_slots(device, knn: int, key_bytes: int, comp: bool,
                 mask: bool = False) -> int:
    """Selection blocks the card holds at once."""
    per_sm = _build.query(device, "stpu_knn_select_blocks_per_sm", knn,
                          key_bytes, int(comp), int(mask))
    if per_sm < 1:
        raise RuntimeError("knn_select: the kernel does not fit an SM")
    return per_sm * torch.cuda.get_device_properties(
        device).multi_processor_count


def _comp_args(comp, col0: int):
    """The kernels' completeness arguments: c1, c2 (from column col0 on),
    cutoff, expected, maxnbits, denom."""
    if comp is None:
        return None, None, 0.0, 0.0, 0.0, 0.0
    return (comp.c1.data_ptr(), comp.c2[col0:].data_ptr(), comp.cutoff,
            comp.expected, comp.maxnbits, comp.maxnbits - comp.expected)
