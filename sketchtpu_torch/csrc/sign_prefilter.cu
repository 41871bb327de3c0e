// The reads path's sign prefilter on Hopper: one row of signs (one k, one
// segment of a read stream) to its keep flags. Port of the XLA program
// sketchtpu/sketchcore/sign_prefilter.py::prefilter_signs_device (:118),
// whose two full sorts and segmented scans it replaces.
//
// Input: signs as nthash_signs writes them (int64, -1 for an invalid
// window). A sign s is binned when 0 <= s < top = nbins * bin_size; its
// bin is s / bin_size. Output: flags[p] (a bool) for every window p, set
// iff the count filter could consult the occurrence at p: with the
// binned windows of bin b ordered by (sign, position), runs of one sign,
// and pmc(r) the position of run r's min_count-th occurrence (none if the
// run is shorter), the occurrence at p of run r is kept iff
// min{pmc(r') : r' < r in b} >= p.
//
// Bound: bytes, each sign read once and each flag written once, 9 bytes a
// window (0.0451 ms for 2^24 windows at 3.35 TB/s). The design moves
// about 70 bytes a window in up to ten launches:
// 1. A stable partition of the binned windows into 2^bits buckets, the
//    sign's top `bits` of 61 bits (contiguous key ranges of ~2 k windows;
//    the signs at or past 2^61, only a bin's tail past SIGN_MOD, in the
//    last), as one or two stable passes of at most 8 bits each, the low
//    digit first (LSD). Per pass: pf_count (each tile's digit counts; the
//    first also zeroes the flags, so no separate memset runs, and the
//    look-back state), pf_scan_chunks and pf_scan_sums (each tile's
//    offset in each digit), and pf_scatter, which ranks a tile's windows
//    by digit in shared memory (warp by warp, peers found by one ballot a
//    digit bit) and writes them out in digit order, so that each digit's
//    run of a tile leaves as whole sectors (a pass into thousands of
//    buckets at once would write each window into a sector of its own).
//    The first pass drops invalid windows and signs past the last bin
//    and writes (sign, 32-bit position); pf_bounds finds the buckets'
//    starts.
// 2. pf_keep: one block per bucket, in ticket order, two an SM. A
//    bucket of at most `cap` windows is ordered on chip: split stably by
//    the next SUB_BITS key bits into shared memory (groups in stream
//    order, mostly one run of one sign, so already in order; in a group
//    of more signs each window is placed by its rank by (sign,
//    position), all such windows in parallel), so that the rule reads
//    contiguous shared memory. The keep rule is a block scan of maps of
//    the state (before, running) that reset at bin boundaries. A bin may
//    span buckets, so the min pmc of its earlier runs comes from the
//    buckets before by a decoupled look-back over one 64-bit status word
//    a bucket (bin known early, then the bucket's aggregate, then its
//    inclusive prefix). Only the kept flags leave the chip: byte stores
//    at stream positions, ~1 per 10 k stream bytes within a bucket, so no
//    two share a sector and a bit mask or a sort of them would not
//    coalesce them either.
//    A bucket past `cap` (skew: a sign repeated more than `cap` times,
//    or distinct signs crowded into one key range) takes a path in
//    device memory: a stable LSD radix sort of the bucket by the 8-bit
//    digits that vary in it, between the partition buffer and the first
//    pass's output (dead by then), then two streaming passes of the same
//    block scan. Nothing falls back to a library sort.
#include <cub/block/block_scan.cuh>

namespace {

typedef long long i64;
typedef unsigned long long u64;
typedef unsigned int u32;
typedef unsigned short u16;

constexpr u32 NONE = 0xFFFFFFFFu;  // no position
constexpr unsigned FULL = 0xFFFFFFFFu;

// partition kernels
constexpr int PW = 8;              // warps a block
constexpr int PT = PW * 32;
constexpr int ROUNDS = 32;         // rounds of 32 windows a warp and tile
constexpr int TILE = PW * 32 * ROUNDS;  // windows a tile
constexpr int DIGIT_BITS = 8;      // a pass's digit at most
constexpr int DIGITS = 1 << DIGIT_BITS;
constexpr int MAX_BITS = 2 * DIGIT_BITS;

constexpr int SCAN_PT = 16;  // counts a thread of a scan block
constexpr int SCAN_CHUNK = PT * SCAN_PT;
constexpr int SCAN_SUMS = 8192;  // chunks at most (rows below 2^30)

// keep kernel
constexpr int KT = 256;  // threads
constexpr int KW = KT / 32;
constexpr int SUB_BITS = 11;
constexpr int SUBS = 1 << SUB_BITS;
constexpr int SPT = SUBS / KT;  // groups a thread
constexpr int CAP = 4096;  // windows of a bucket ordered in shared memory
constexpr int KR = CAP / KT;  // rounds of 32 windows a warp
constexpr int OIPT = 8;    // windows a thread and tile, in device memory
constexpr size_t KEEP_SMEM =
    (size_t)CAP * (8 + 4 + 1) + (size_t)KW * SUBS * 2 + (SUBS + 1) * 4;
static_assert(CAP <= 65535 && CAP >= SUBS, "u16 cursors, group flags in F");
constexpr size_t SCATTER_SMEM =
    (size_t)TILE * (8 + 4) + (PW + 2) * DIGITS * 4;

// the look-back's status word: state (2 bits), bin (30), value (32)
constexpr u64 ST_BIN = 1ull << 62, ST_AGG = 2ull << 62, ST_PRE = 3ull << 62;
constexpr u32 BIN_MASK = 0x3FFFFFFFu;
constexpr u32 EMPTY = BIN_MASK;  // an empty bucket: the identity

// A map of the state (bf, rn): rn, the min pmc of the runs seen in the
// current bin; bf, its value where the current run started.
//   rn' = RR ? x : min(rn, x)
//   bf' = RS ? (RA ? a : min(rn, a)) : bf
// RR: a bin started in the span; RS: a run started; RA: a bin started at
// or before the last run start.
constexpr u32 RR = 1, RS = 2, RA = 4;
struct Step {
  u32 a, x, f;
};
struct State {
  u32 bf, rn;
};

struct Then {  // s1, then s2
  __device__ __forceinline__ Step operator()(const Step& s1,
                                             const Step& s2) const {
    Step r;
    r.x = (s2.f & RR) ? s2.x : min(s1.x, s2.x);
    const u32 rr = (s1.f | s2.f) & RR;
    if (s2.f & RS) {
      r.a = (s2.f & RA) ? s2.a : min(s1.x, s2.a);
      r.f = rr | RS | (((s2.f & RA) || (s1.f & RR)) ? RA : 0u);
    } else {
      r.a = s1.a;
      r.f = rr | (s1.f & (RS | RA));
    }
    return r;
  }
};

__device__ __forceinline__ Step ident() { return Step{NONE, NONE, 0u}; }

__device__ __forceinline__ State apply(const Step& s, State st) {
  State r;
  r.rn = (s.f & RR) ? s.x : min(st.rn, s.x);
  r.bf = (s.f & RS) ? ((s.f & RA) ? s.a : min(st.rn, s.a)) : st.bf;
  return r;
}

// one window: run start, bin start (only at a run start past the first
// window), and its position if it is its run's min_count-th
__device__ __forceinline__ Step window_step(bool rs, bool bs, u32 c) {
  return Step{NONE, c, bs ? (RR | RS | RA) : (rs ? RS : 0u)};
}

__device__ __forceinline__ State walk(State st, bool rs, bool bs, u32 c) {
  if (bs) {
    st.bf = NONE;
    st.rn = c;
  } else {
    if (rs) st.bf = st.rn;
    st.rn = min(st.rn, c);
  }
  return st;
}

__device__ __forceinline__ u32 bin_of(i64 s, i64 bsz) {
  return (u32)((u64)s / (u64)bsz);
}

__device__ __forceinline__ u64 word(u64 st, u32 bin, u32 v) {
  return st | ((u64)bin << 32) | v;
}

__device__ __forceinline__ void publish(u64* status, int h, u64 w) {
  atomicExch(status + h, w);
}

// min pmc of the runs of bin `first` in the buckets before h
__device__ u32 look_back(const u64* status, int h, u32 first) {
  u32 acc = NONE;
  for (int j = h - 1; j >= 0; --j) {
    u64 w;
    for (;;) {
      w = *(const volatile u64*)(status + j);
      const u64 st = w >> 62;
      const u32 bin = (u32)(w >> 32) & BIN_MASK;
      if (st != 0 && (bin == EMPTY || bin != first || st >= 2)) break;
      __nanosleep(32);
    }
    const u32 bin = (u32)(w >> 32) & BIN_MASK;
    if (bin == EMPTY) continue;
    if (bin != first) return acc;  // the bin starts after j
    acc = min(acc, (u32)w);
    if ((w >> 62) == 3) return acc;  // j's inclusive prefix
  }
  return acc;
}

// the bucket of a binned sign, -1 for the rest: its key bits from `shift`
// up, the signs at or past 2^61 in the last of the 2^bits buckets
__device__ __forceinline__ int key_of(i64 s, i64 top, int shift, int bits) {
  return (s >= 0 && s < top) ? (int)min(s >> shift, (1ll << bits) - 1) : -1;
}

__device__ __forceinline__ u32 lanes_below() {
  u32 r;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(r));
  return r;
}

// the lanes whose digit d (of dbits bits; -1 for none) equals this lane's:
// one ballot a bit
__device__ __forceinline__ u32 peers_of(int d, int dbits) {
  u32 m = __ballot_sync(FULL, d >= 0);
  for (int b = 0; b < dbits; ++b) {
    const bool bit = (d >> b) & 1;
    const u32 v = __ballot_sync(FULL, bit);
    m &= bit ? v : ~v;
  }
  return d >= 0 ? m : 0u;
}

// a pass's digit counts per tile of its input (n windows: *count, or m);
// the first pass also zeroes the flags and the look-back state
__global__ void __launch_bounds__(PT) pf_count(
    const i64* __restrict__ src, i64 m, const u32* __restrict__ count,
    i64 top, int shift, int bits, int dshift, int dbits, int first,
    u32* __restrict__ hist, unsigned char* __restrict__ flags,
    u64* __restrict__ status, u32* __restrict__ ticket) {
  __shared__ u32 cnt[DIGITS];
  const int nd = 1 << dbits;
  for (int d = threadIdx.x; d < nd; d += PT) cnt[d] = 0u;
  if (first) {
    const i64 nb = 1ll << bits;
    for (i64 b = (i64)blockIdx.x * PT + threadIdx.x; b < nb;
         b += (i64)gridDim.x * PT) {
      status[b] = 0;
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) *ticket = 0;
  }
  __syncthreads();
  const i64 n = count ? (i64)*count : m;
  const i64 t0 = (i64)blockIdx.x * TILE;
  const int nt = (int)max((i64)0, min((i64)TILE, n - t0));
  for (int i = threadIdx.x; i < nt; i += PT) {
    const int k = key_of(src[t0 + i], top, shift, bits);
    if (k >= 0) atomicAdd(&cnt[(k >> dshift) & (nd - 1)], 1u);
  }
  if (first) {
    const int nf = (int)max((i64)0, min((i64)TILE, m - t0));
    for (int i = threadIdx.x; i < nf; i += PT) flags[t0 + i] = 0;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < nd; d += PT) {
    hist[(size_t)d * gridDim.x + blockIdx.x] = cnt[d];
  }
}

// The counts, digit-major (hist[d][t]), scanned exclusively in place in
// chunks of SCAN_CHUNK: then tile t's offset in digit d is hist[d][t] +
// sums[(d * tiles + t) / SCAN_CHUNK] (pf_scan_sums scans the chunks'
// sums) and the binned windows are *total.
__global__ void __launch_bounds__(PT) pf_scan_chunks(u32* __restrict__ x,
                                                     i64 n,
                                                     u32* __restrict__ sums) {
  using Scan = cub::BlockScan<u32, PT>;
  __shared__ typename Scan::TempStorage tmp;
  const i64 base = (i64)blockIdx.x * SCAN_CHUNK + threadIdx.x * SCAN_PT;
  u32 v[SCAN_PT];
#pragma unroll
  for (int j = 0; j < SCAN_PT; ++j) v[j] = base + j < n ? x[base + j] : 0u;
  u32 total;
  Scan(tmp).ExclusiveSum(v, v, total);
#pragma unroll
  for (int j = 0; j < SCAN_PT; ++j) {
    if (base + j < n) x[base + j] = v[j];
  }
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(1024) pf_scan_sums(u32* __restrict__ sums,
                                                     int nsums,
                                                     u32* __restrict__ total) {
  constexpr int PER = SCAN_SUMS / 1024;
  using Scan = cub::BlockScan<u32, 1024>;
  __shared__ typename Scan::TempStorage tmp;
  u32 v[PER];
  const int b0 = threadIdx.x * PER;
#pragma unroll
  for (int j = 0; j < PER; ++j) v[j] = b0 + j < nsums ? sums[b0 + j] : 0u;
  u32 all;
  Scan(tmp).ExclusiveSum(v, v, all);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (b0 + j < nsums) sums[b0 + j] = v[j];
  }
  if (threadIdx.x == 0) *total = all;
}

// a stable pass: each tile's windows ranked by digit in shared memory,
// then written out in digit order at the tile's offset in each digit;
// src_p null: the positions are the windows' indices
__global__ void __launch_bounds__(PT, 2) pf_scatter(
    const i64* __restrict__ src, const u32* __restrict__ src_p, i64 m,
    const u32* __restrict__ count, i64 top, int shift, int bits, int dshift,
    int dbits, const u32* __restrict__ hist, const u32* __restrict__ sums,
    i64* __restrict__ out_s, u32* __restrict__ out_p) {
  extern __shared__ __align__(16) unsigned char scatter_smem[];
  i64* st_s = (i64*)scatter_smem;
  u32* st_p = (u32*)(st_s + TILE);
  u32* wc = st_p + TILE;      // [warp][digit]: counts, then cursors
  u32* off = wc + PW * DIGITS;
  u32* tstart = off + DIGITS;  // the tile's digit starts
  using Scan = cub::BlockScan<u32, PT>;
  __shared__ typename Scan::TempStorage tmp;
  __shared__ u32 nvalid;
  const i64 n = count ? (i64)*count : m;
  const i64 t0 = (i64)blockIdx.x * TILE;
  if (t0 >= n) return;
  const int nd = 1 << dbits;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < PW * DIGITS; i += PT) wc[i] = 0u;
  for (int d = threadIdx.x; d < nd; d += PT) {
    const size_t at = (size_t)d * gridDim.x + blockIdx.x;
    off[d] = hist[at] + sums[at / SCAN_CHUNK];
  }
  const i64 w0 = t0 + (i64)warp * 32 * ROUNDS;
  i64 v[ROUNDS];
  u32 p[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const i64 i = w0 + r * 32 + lane;
    v[r] = i < n ? src[i] : -1;
    p[r] = i < n ? (src_p ? src_p[i] : (u32)i) : 0u;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int k = key_of(v[r], top, shift, bits);
    if (k >= 0) atomicAdd(&wc[warp * DIGITS + ((k >> dshift) & (nd - 1))], 1u);
  }
  __syncthreads();
  {
    const int d = threadIdx.x;  // PT == DIGITS
    u32 total = 0;
    for (int w = 0; w < PW; ++w) total += wc[w * DIGITS + d];
    u32 start, all;
    Scan(tmp).ExclusiveSum(total, start, all);
    tstart[d] = start;
    for (int w = 0; w < PW; ++w) {
      const u32 c = wc[w * DIGITS + d];
      wc[w * DIGITS + d] = start;
      start += c;
    }
    if (d == 0) nvalid = all;
  }
  __syncthreads();
  const u32 below = lanes_below();
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int k = key_of(v[r], top, shift, bits);
    const int d = k >= 0 ? (k >> dshift) & (nd - 1) : -1;
    const u32 peers = peers_of(d, dbits);
    if (d >= 0) {
      const u32 at = wc[warp * DIGITS + d] + __popc(peers & below);
      st_s[at] = v[r];
      st_p[at] = p[r];
    }
    __syncwarp();
    if (d >= 0 && lane == __ffs(peers) - 1) {
      wc[warp * DIGITS + d] += __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();
  for (u32 j = threadIdx.x; j < nvalid; j += PT) {
    const i64 s = st_s[j];
    const int d = (key_of(s, top, shift, bits) >> dshift) & (nd - 1);
    const u32 dest = off[d] + (j - tstart[d]);
    out_s[dest] = s;
    out_p[dest] = st_p[j];
  }
}

// each bucket's start in the partition (sorted by key): bstart[2^bits]
// = the binned windows
__global__ void pf_bounds(const i64* __restrict__ part_s,
                          const u32* __restrict__ count, i64 m, i64 top,
                          int shift, int bits, u32* __restrict__ bstart) {
  const i64 n = *count, nb = 1ll << bits;
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (n == 0) {
    for (i64 b = i; b <= nb; b += (i64)gridDim.x * blockDim.x) bstart[b] = 0;
    return;
  }
  if (i >= n) return;
  const int k = key_of(part_s[i], top, shift, bits);
  const int kp = i > 0 ? key_of(part_s[i - 1], top, shift, bits) : -1;
  for (int b = kp + 1; b <= k; ++b) bstart[b] = (u32)i;
  if (i == n - 1) {
    for (i64 b = k + 1; b <= nb; ++b) bstart[b] = (u32)n;
  }
}

// the state map of window k of sorted signs s (k in [0, n)), with the
// run's first window min_count - 1 back
template <class Sign>
__device__ __forceinline__ void window_at(const Sign& s, int k, int mc,
                                          i64 bsz, u32 p, bool& rs, bool& bs,
                                          u32& c) {
  const i64 v = s(k);
  rs = k == 0 || s(k - 1) != v;
  bs = rs && k > 0 && bin_of(v, bsz) != bin_of(s(k - 1), bsz);
  const int r0 = k - (mc - 1);
  c = (r0 >= 0 && s(r0) == v && (r0 == 0 || s(r0 - 1) != v)) ? p : NONE;
}

union KeepTemp {
  typename cub::BlockScan<Step, KT>::TempStorage step;
  typename cub::BlockScan<u32, KT>::TempStorage sum;
};

struct KeepShared {
  int h;
  u32 carry;
  u64 mn, mx, o, a;
};

// after the block scan: publish the aggregate, look back, publish the
// inclusive prefix; returns the carry into the bucket's first bin
__device__ u32 resolve(KeepShared& sh, u64* status, int h, u32 first,
                       u32 last, const Step& total) {
  if (threadIdx.x == 0) {
    publish(status, h, word(ST_AGG, last, total.x));
    const u32 carry = look_back(status, h, first);
    publish(status, h, word(ST_PRE, last,
                            (total.f & RR) ? total.x : min(carry, total.x)));
    sh.carry = carry;
  }
  __syncthreads();
  return sh.carry;
}

__device__ void keep_in_smem(unsigned char* smem, KeepTemp& tmp,
                             KeepShared& sh, int h, int n, int shift, int mc,
                             i64 bsz, u64* status, const i64* a_s,
                             const u32* a_p, unsigned char* flags) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  i64* S = (i64*)smem;  // (sign, position) order
  u32* P = (u32*)(S + CAP);
  u32* gs = P + CAP;          // the groups' starts
  u16* wc = (u16*)(gs + SUBS + 1);  // [warp][digit]: counts, then cursors
  unsigned char* F = (unsigned char*)(wc + KW * SUBS);  // RS, BS, MTH
  for (int i = tid; i < KW * SUBS / 2; i += KT) ((u32*)wc)[i] = 0u;
  // a warp's range of the bucket, in stream order, in registers
  const int per_w = (n + KW - 1) / KW;
  const int w0 = min(n, warp * per_w), w1 = min(n, w0 + per_w);
  i64 sv[KR];
  u32 pv[KR];
  u64 mn = ~0ull, mx = 0;
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const int i = w0 + r * 32 + lane;
    sv[r] = i < w1 ? a_s[i] : -1;
    pv[r] = i < w1 ? a_p[i] : 0u;
    if (i < w1) {
      mn = min(mn, (u64)sv[r]);
      mx = max(mx, (u64)sv[r]);
    }
  }
  atomicMin(&sh.mn, mn);
  atomicMax(&sh.mx, mx);
  __syncthreads();
  const u32 first = bin_of((i64)sh.mn, bsz), last = bin_of((i64)sh.mx, bsz);
  if (tid == 0) publish(status, h, word(ST_BIN, last, NONE));

  // a stable split by the next key bits (the last bucket's signs past its
  // key range in the last group): groups in stream order
  const int sh2 = max(shift - SUB_BITS, 0);
  const u64 dmask = (1ull << (shift - sh2)) - 1;
  const u64 dbase = (u64)h << (shift - sh2);
  const auto digit = [&](i64 x) {
    return x < 0 ? -1 : (int)min(((u64)x >> sh2) - dbase, dmask);
  };
  u16* cursor = wc + warp * SUBS;
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const int d = digit(sv[r]);
    if (d >= 0) atomicAdd((u32*)cursor + (d >> 1), 1u << ((d & 1) * 16));
  }
  __syncthreads();
  {
    u32 tot[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      tot[j] = 0;
      for (int w = 0; w < KW; ++w) tot[j] += wc[w * SUBS + tid * SPT + j];
    }
    cub::BlockScan<u32, KT>(tmp.sum).ExclusiveSum(tot, tot);
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int d = tid * SPT + j;
      u32 run = tot[j];
      gs[d] = run;
      for (int w = 0; w < KW; ++w) {
        const u32 c = wc[w * SUBS + d];
        wc[w * SUBS + d] = (u16)run;
        run += c;
      }
    }
    if (tid == 0) gs[SUBS] = (u32)n;
  }
  __syncthreads();
  const u32 below = lanes_below();
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    if (w0 + r * 32 >= w1) break;  // the warp's rounds end (uniform)
    const int d = digit(sv[r]);
    const u32 peers = __match_any_sync(FULL, d);
    if (d >= 0) {
      const u32 at = cursor[d] + __popc(peers & below);
      S[at] = sv[r];
      P[at] = pv[r];
    }
    __syncwarp();
    if (d >= 0 && lane == __ffs(peers) - 1) {
      cursor[d] = (u16)(cursor[d] + __popc(peers));
    }
    __syncwarp();
  }
  __syncthreads();
  // a group holding one run of one sign is in order already; in a group
  // of more signs each window finds its place by its rank by (sign,
  // position), in parallel
  unsigned char* mixed = F;  // F's first SUBS bytes until the scan
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int d = tid * SPT + j, g0 = gs[d], g1 = gs[d + 1];
    bool sorted = true;
    for (int k = g0 + 1; k < g1 && sorted; ++k) sorted = S[k - 1] <= S[k];
    mixed[d] = !sorted;
  }
  __syncthreads();
  {
    i64 xs[KR];
    u32 xp[KR], at[KR];
#pragma unroll
    for (int j = 0; j < KR; ++j) {
      const int k = tid + j * KT;
      at[j] = NONE;
      if (j * KT >= n) continue;  // uniform
      const int d = k < n ? digit(S[k]) : 0;
      if (k < n && mixed[d]) {
        xs[j] = S[k];
        xp[j] = P[k];
        u32 r = gs[d];
        for (u32 i = gs[d]; i < gs[d + 1]; ++i) {
          r += S[i] < xs[j] || (S[i] == xs[j] && P[i] < xp[j]);
        }
        at[j] = r;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KR; ++j) {
      if (at[j] != NONE) {
        S[at[j]] = xs[j];
        P[at[j]] = xp[j];
      }
    }
  }
  __syncthreads();

  // the keep rule over the sorted bucket, a contiguous range a thread;
  // its bin followed by multiplication, a division a thread
  const int per = (n + KT - 1) / KT;
  const int k0 = min(n, tid * per), k1 = min(n, k0 + per);
  Step mine = ident();
  u32 bin = k0 > 0 ? bin_of(S[k0 - 1], bsz) : first;
  for (int k = k0; k < k1; ++k) {
    const i64 v = S[k];
    const bool rs = k == 0 || S[k - 1] != v;
    bool bs = false;
    if (rs) {
      u32 b = bin;
      while ((u64)v >= (u64)(b + 1) * (u64)bsz) ++b;
      bs = b != bin;
      bin = b;
    }
    const int r0 = k - (mc - 1);
    const bool mth = r0 >= 0 && S[r0] == v && (r0 == 0 || S[r0 - 1] != v);
    F[k] = (unsigned char)(rs | (bs << 1) | (mth << 2));
    mine = Then()(mine, window_step(rs, bs, mth ? P[k] : NONE));
  }
  Step prefix, total;
  cub::BlockScan<Step, KT>(tmp.step).ExclusiveScan(mine, prefix, ident(),
                                                   Then(), total);
  const u32 carry = resolve(sh, status, h, first, last, total);
  State st = apply(prefix, State{NONE, carry});
  for (int k = k0; k < k1; ++k) {
    const u32 p = P[k];
    const unsigned f = F[k];
    st = walk(st, f & 1, f & 2, (f & 4) ? p : NONE);
    if (st.bf >= p) flags[p] = 1;
  }
}

// a bucket past cap: sorted in device memory, then scanned twice
__device__ void keep_in_global(unsigned char* smem, KeepTemp& tmp,
                               KeepShared& sh, int h, int n, int shift,
                               int mc, i64 bsz, u64* status, i64* a_s,
                               u32* a_p, i64* b_s, u32* b_p,
                               unsigned char* flags) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  u64 mn = ~0ull, mx = 0, o = 0, a = ~0ull;
  for (int i = tid; i < n; i += KT) {
    const u64 s = (u64)a_s[i];
    mn = min(mn, s);
    mx = max(mx, s);
    o |= s;
    a &= s;
  }
  atomicMin(&sh.mn, mn);
  atomicMax(&sh.mx, mx);
  atomicOr(&sh.o, o);
  atomicAnd(&sh.a, a);
  __syncthreads();
  const u32 first = bin_of((i64)sh.mn, bsz), last = bin_of((i64)sh.mx, bsz);
  if (tid == 0) publish(status, h, word(ST_BIN, last, NONE));
  const u64 varying = sh.o ^ sh.a;

  // stable LSD radix sort by the 8-bit digits that vary in the bucket
  u32* cur = (u32*)smem;  // 256 cursors
  u32* wc = cur + 256;    // [warp][digit]
  constexpr int R = 8, WT = KW * 32 * R;
  i64* ss = a_s;
  u32* sp = a_p;
  i64* ds = b_s;
  u32* dp = b_p;
  const u32 below = lanes_below();
  for (int q = 0; q < 64; q += 8) {
    if (((varying >> q) & 0xFFu) == 0) continue;
    for (int d = tid; d < 256; d += KT) cur[d] = 0u;
    __syncthreads();
    for (int i = tid; i < n; i += KT) {
      atomicAdd(&cur[((u64)ss[i] >> q) & 0xFFu], 1u);
    }
    __syncthreads();
    if (tid == 0) {
      u32 run = 0;
      for (int d = 0; d < 256; ++d) {
        const u32 c = cur[d];
        cur[d] = run;
        run += c;
      }
    }
    __syncthreads();
    for (int t0 = 0; t0 < n; t0 += WT) {
      for (int i = tid; i < KW * 256; i += KT) wc[i] = 0u;
      __syncthreads();
      const int r0 = min(n, t0 + warp * 32 * R), r1 = min(n, r0 + 32 * R);
      for (int i = r0 + lane; i < r1; i += 32) {
        atomicAdd(&wc[warp * 256 + (((u64)ss[i] >> q) & 0xFFu)], 1u);
      }
      __syncthreads();
      for (int d = tid; d < 256; d += KT) {
        u32 run = cur[d];
        for (int w = 0; w < KW; ++w) {
          const u32 c = wc[w * 256 + d];
          wc[w * 256 + d] = run;
          run += c;
        }
        cur[d] = run;
      }
      __syncthreads();
      for (int r = r0; r < r1; r += 32) {
        const int i = r + lane;
        const int d = i < r1 ? (int)(((u64)ss[i] >> q) & 0xFFu) : -1;
        const u32 peers = peers_of(d, 8);
        if (d >= 0) {
          const u32 at = wc[warp * 256 + d] + __popc(peers & below);
          ds[at] = ss[i];
          dp[at] = sp[i];
        }
        __syncwarp();
        if (d >= 0 && lane == __ffs(peers) - 1) {
          wc[warp * 256 + d] += __popc(peers);
        }
        __syncwarp();
      }
      __syncthreads();
    }
    i64* ts = ss;
    ss = ds;
    ds = ts;
    u32* tp = sp;
    sp = dp;
    dp = tp;
  }

  const auto sign = [&](int k) { return ss[k]; };
  Step agg = ident();
  for (int t0 = 0; t0 < n; t0 += KT * OIPT) {
    const int i0 = min(n, t0 + tid * OIPT), i1 = min(n, i0 + OIPT);
    Step mine = ident();
    for (int i = i0; i < i1; ++i) {
      bool rs, bs;
      u32 c;
      window_at(sign, i, mc, bsz, sp[i], rs, bs, c);
      mine = Then()(mine, window_step(rs, bs, c));
    }
    Step prefix, total;
    cub::BlockScan<Step, KT>(tmp.step).ExclusiveScan(mine, prefix, ident(),
                                                     Then(), total);
    agg = Then()(agg, total);
    __syncthreads();
  }
  const u32 carry = resolve(sh, status, h, first, last, agg);
  State entry = {NONE, carry};
  for (int t0 = 0; t0 < n; t0 += KT * OIPT) {
    const int i0 = min(n, t0 + tid * OIPT), i1 = min(n, i0 + OIPT);
    Step mine = ident();
    for (int i = i0; i < i1; ++i) {
      bool rs, bs;
      u32 c;
      window_at(sign, i, mc, bsz, sp[i], rs, bs, c);
      mine = Then()(mine, window_step(rs, bs, c));
    }
    Step prefix, total;
    cub::BlockScan<Step, KT>(tmp.step).ExclusiveScan(mine, prefix, ident(),
                                                     Then(), total);
    State st = apply(prefix, entry);
    for (int i = i0; i < i1; ++i) {
      const u32 p = sp[i];
      bool rs, bs;
      u32 c;
      window_at(sign, i, mc, bsz, p, rs, bs, c);
      st = walk(st, rs, bs, c);
      if (st.bf >= p) flags[p] = 1;
    }
    entry = apply(total, entry);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(KT, 2) pf_keep(
    const u32* __restrict__ bstart, int shift, int mc, i64 bsz, int cap,
    u32* ticket, u64* status, i64* a_s, u32* a_p, i64* b_s, u32* b_p,
    unsigned char* __restrict__ flags) {
  extern __shared__ __align__(16) unsigned char keep_smem[];
  __shared__ KeepTemp tmp;
  __shared__ KeepShared sh;
  if (threadIdx.x == 0) {
    sh.h = (int)atomicAdd(ticket, 1u);
    sh.mn = ~0ull;
    sh.mx = 0;
    sh.o = 0;
    sh.a = ~0ull;
  }
  __syncthreads();
  const int h = sh.h;
  const u32 lo = bstart[h], n = bstart[h + 1] - lo;
  if (n == 0) {
    if (threadIdx.x == 0) publish(status, h, word(ST_PRE, EMPTY, NONE));
  } else if (n <= (u32)cap) {
    keep_in_smem(keep_smem, tmp, sh, h, (int)n, shift, mc, bsz, status,
                 a_s + lo, a_p + lo, flags);
  } else {
    keep_in_global(keep_smem, tmp, sh, h, (int)n, shift, mc, bsz, status,
                   a_s + lo, a_p + lo, b_s + lo, b_p + lo, flags);
  }
}

int bit_length(u64 x) { return x ? 64 - __builtin_clzll(x) : 0; }

}  // namespace

// The wrapper's constants: most bucket bits (0), windows of a bucket
// ordered in shared memory (1), windows a partition tile (2), a pass's
// digits (3), the scan's chunk sums (4). It sizes the int32 workspace as
// tiles * digits + chunk sums + 2^bits + 4 words.
extern "C" int stpu_sign_prefilter_limits(int which) {
  const int v[5] = {MAX_BITS, CAP, TILE, DIGITS, SCAN_SUMS};
  return which >= 0 && which < 5 ? v[which] : -1;
}

extern "C" int stpu_sign_prefilter(const void* signs, long long m,
                                   int min_count, long long bin_size,
                                   int nbins, int bits, int cap, void* ws,
                                   void* status, void* part_sign,
                                   void* part_pos, void* scr_sign,
                                   void* scr_pos, void* flags, void* stream) {
  if (m < 1 || m > (1ll << 30) - 1 || min_count < 1 || bin_size < 1 ||
      nbins < 1 || (u32)nbins >= EMPTY || bits < 0 || bits > MAX_BITS ||
      cap < 1 || cap > CAP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const i64 top = (i64)nbins * bin_size;
  const i64 span = top < (1ll << 61) ? top : 1ll << 61;  // signs < 2^61 - 1
  const int len = bit_length((u64)(span - 1));
  const int shift = len > bits ? len - bits : 0;
  // the passes' digits, low first: (shift within the key, bits)
  const int low = bits > DIGIT_BITS ? bits - DIGIT_BITS : 0;
  const int passes = low > 0 ? 2 : 1;
  const int dshift[2] = {0, low}, dbits[2] = {low > 0 ? low : bits,
                                              bits - low};
  const int ntiles = (int)((m + TILE - 1) / TILE);
  u32* w = static_cast<u32*>(ws);
  u32* hist = w;  // a pass's counts, digit-major
  u32* sums = hist + (size_t)ntiles * DIGITS;
  u32* binned = sums + SCAN_SUMS;  // each pass's binned windows
  u32* bstart = binned + 2;
  u32* ticket = bstart + (1 << bits) + 1;
  const i64* sg = static_cast<const i64*>(signs);
  u64* stat = static_cast<u64*>(status);
  unsigned char* fl = static_cast<unsigned char*>(flags);
  i64* ps = static_cast<i64*>(part_sign);
  u32* pp = static_cast<u32*>(part_pos);
  i64* ss = static_cast<i64*>(scr_sign);
  u32* sp = static_cast<u32*>(scr_pos);

  cudaError_t err = cudaFuncSetAttribute(
      pf_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SCATTER_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(pf_keep,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)KEEP_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  // pass 0 reads the signs; with two passes it writes the scratch, which
  // pass 1 reads (its count: pass 0's binned windows)
  for (int q = 0; q < passes; ++q) {
    const i64* src = q == 0 ? sg : ss;
    const u32* src_p = q == 0 ? nullptr : sp;
    const u32* count = q == 0 ? nullptr : binned;
    i64* out_s = q + 1 == passes ? ps : ss;
    u32* out_p = q + 1 == passes ? pp : sp;
    const i64 n = (i64)ntiles << dbits[q];
    const int chunks = (int)((n + SCAN_CHUNK - 1) / SCAN_CHUNK);
    pf_count<<<ntiles, PT, 0, st>>>(src, m, count, top, shift, bits,
                                    dshift[q], dbits[q], q == 0, hist, fl,
                                    stat, ticket);
    pf_scan_chunks<<<chunks, PT, 0, st>>>(hist, n, sums);
    pf_scan_sums<<<1, 1024, 0, st>>>(sums, chunks, binned + q);
    pf_scatter<<<ntiles, PT, SCATTER_SMEM, st>>>(
        src, src_p, m, count, top, shift, bits, dshift[q], dbits[q], hist,
        sums, out_s, out_p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const u32* total = binned + passes - 1;
  pf_bounds<<<(int)((m + 255) / 256), 256, 0, st>>>(ps, total, m, top, shift,
                                                    bits, bstart);
  pf_keep<<<1 << bits, KT, KEEP_SMEM, st>>>(bstart, shift, min_count,
                                            bin_size, cap, ticket, stat, ps,
                                            pp, ss, sp, fl);
  return static_cast<int>(cudaGetLastError());
}
