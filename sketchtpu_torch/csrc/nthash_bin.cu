// ntHash + Mersenne-61 sign + per-(k, genome, bin) minimum for every k of a
// sketch in one launch: the port of sketchtpu/hash/nthash_jax.py
// hash_bin_kernel (an XLA program, the whole compute of the sketch stage).
// Its signs mode is the port of nthash_jax.hash_signs_kernel (the reads
// path): the same hash, break rule and sign, written at every window start
// in sequence order (u64 max for a window that is not valid; signs are
// below 2^61, so the value is free) for the host's order-dependent count
// filter, with no minimum table.
//
// For every window start s of a batch of concatenated genomes and every k:
//   fwd = XOR_j srol^(k-1-j)(SEED[c(s+j)]), rev = XOR_j srol^j(RC[c(s+j)])
//   h = rc ? min(fwd, rev) : fwd         (min as unsigned 64-bit)
//   sign = h mod (2^61 - 1)              (shift-add, signs.py)
//   bin = sign / binsize
//   out[k][genome][bin] = min(out, sign) (64-bit atomicMin)
// with srol the split 33/31-bit rotation of the reference. The window is
// dropped when a break flag sits at s+1..s+k-1 (a break at p forbids
// s < p < s+k; the packer puts one at every genome start) or when it runs
// past the batch. seq bytes are code | break << 2.
//
// Bound: integer ALU. Design:
// - Rolling hash. A thread owns a run of L = 64 consecutive window
//   starts (of 16, 32, 64 and 128 the fastest on an H100, see PERF.md). It builds the first window's hashes in Horner form,
//     fwd <- srol(fwd) ^ SEED[c],  v <- sror(v ^ RC[c])  (rev = srol^k(v)),
//   which extends from one k to the next larger one by the bases between
//   them, so all k of the launch (ascending) share one pass over the first
//   max k bases. Then it rolls, per k, in O(1) per window:
//     fwd' = srol(fwd) ^ srol^k(SEED[out]) ^ SEED[in]
//     rev' = sror(rev ^ RC[out]) ^ srol^(k-1)(RC[in])
//   with eight precomputed words per k instead of a (k, 4) tap table.
// - One staging for all k. The block's span of bytes (256 L + max k - 1)
//   is staged once, transposed so that byte q lies at
//   [q % L][q / L]: at every step the threads of a warp read neighbouring
//   bytes, free of bank conflicts.
// - The break rule is the position of the last flag: a window at relative
//   start w is valid when no flag lies past w among the bytes read so far.
// - sign / binsize is a multiply-high by a host-computed magic number (see
//   stpu_magic_div below for the proof; rolling.cuh, shared with
//   aahash_bin.cu); the genome comes from one binary
//   search per run and a compare with the next start per window.
// - Minima: a plain L2 read of the slot skips the atomic for every sign that
//   cannot lower it; with smin the block first reduces the signs of its
//   first genome in a shared-memory table per k and flushes that.
// - Signs mode, a kernel of its own (nthash_signs_kernel) with the same
//   rolling (rolling.cuh): the launch holds one stream (or a chunk of one);
//   out is (nk, n_out), one row per k over the first n_out window starts.
//   Bound: the 8 bytes a window and k that the host must read back. A
//   thread owns a shorter run, SL = 16 starts (of 16, 32 and 64 the
//   fastest on an H100, see PERF.md), so that the reads path's chunk of
//   4.8 M starts launches 1171 blocks, several waves; it stages each 16
//   signs of its run in shared memory, and the block writes them back
//   with 16-byte streaming stores (st.global.cs), eight lanes to a whole
//   128-byte line, where one lane a line took 64 strided 8-byte stores.
#include <cuda_runtime.h>

#include "rolling.cuh"

using namespace stpu;

namespace {

constexpr int NT = 256;
constexpr int KWORDS = 10;  // table words per k
constexpr int LG = 6;       // log2 of the window starts per thread
constexpr int L = 1 << LG;

// ktab: per k (ascending) KWORDS words: srol^k(SEED[0..3]),
// srol^(k-1)(RC[0..3]), k, (k % 33) | (k % 31) << 32; then SEED[0..3],
// RC[0..3]. out is (nk, n_genomes, nbins), filled with u64 max.
__global__ void __launch_bounds__(NT)
    nthash_multi_kernel(const unsigned char* __restrict__ seq, long long total,
                        const u64* __restrict__ ktab, int nk, int rc,
                        const long long* __restrict__ starts, int n_genomes,
                        u64 magic, int mshift, int nbins, int pitch, int smin,
                        u64* __restrict__ out) {
  extern __shared__ __align__(8) unsigned char smem[];
  u64* stab = reinterpret_cast<u64*>(smem);
  const u64* seed = stab + nk * KWORDS;
  const u64* rcs = seed + 4;
  u64* stbl = stab + nk * KWORDS + 8;  // nbins minima when smin
  unsigned char* sseq =
      reinterpret_cast<unsigned char*>(stbl + (smin ? nbins : 0));
  const int tid = threadIdx.x;
  for (int e = tid; e < nk * KWORDS + 8; e += NT) stab[e] = ktab[e];
  if (smin) {
    for (int e = tid; e < nbins; e += NT) stbl[e] = ~0ull;
  }
  __syncthreads();
  const int kmax = (int)stab[(nk - 1) * KWORDS + 8];
  const long long base = (long long)blockIdx.x * NT * L;
  const int span = NT * L + kmax - 1;
  for (int e = tid; e < span; e += NT) {
    const long long p = base + e;
    sseq[(e & (L - 1)) * pitch + (e >> LG)] = p < total ? seq[p] : 0;
  }
  __syncthreads();
  auto byte_at = [&](int q) -> unsigned {
    return sseq[(q & (L - 1)) * pitch + (q >> LG)];
  };
  auto genome_of = [&](long long s) {  // last genome with starts[g] <= s
    int lo = 0, hi = n_genomes - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (starts[mid] <= s) lo = mid; else hi = mid - 1;
    }
    return lo;
  };

  const int q0 = tid * L;  // the run's first window start, block-relative
  const long long s0 = base + q0;
  const int g0 = genome_of(s0);
  const int gblock = smin ? genome_of(base) : -1;
  u64 fh = 0, v = 0;  // Horner state of the window at q0, j bases long
  int j = 0, last = 0;  // last: the last flag among bases 1..j-1 (0: none)
  for (int ki = 0; ki < nk; ++ki) {
    const u64* t = stab + ki * KWORDS;
    const int k = (int)t[8];
    if (s0 + k <= total) {
      for (; j < k; ++j) {
        const unsigned b = byte_at(q0 + j);
        if (j > 0 && (b & 4u)) last = j;
        nt_extend(fh, v, b, seed, rcs);
      }
      u64 f = fh;
      u64 r = srolk(v, (int)(t[9] & 0xFFFFFFFFull), (int)(t[9] >> 32));
      int lf = last, g = g0;
      long long next = g + 1 < n_genomes ? starts[g + 1] : total;
      const long long left = total - k + 1 - s0;  // windows from s0 on
      const int nwin = left < L ? (int)left : L;
      u64* plane = out + (long long)ki * n_genomes * nbins;
      for (int w = 0; w < nwin; ++w) {
        if (w > 0) {
          const unsigned bo = byte_at(q0 + w - 1) & 3u;
          const unsigned bi = byte_at(q0 + w + k - 1);
          if (bi & 4u) lf = w + k - 1;
          nt_roll(f, r, bo, bi, t, seed, rcs);
        }
        if (lf > w) continue;  // a flag inside the window
        const u64 x = nt_sign(f, r, rc);
        const u64 bin = magic_div(x, magic, mshift);
        const long long s = s0 + w;
        while (s >= next && g + 1 < n_genomes) {
          ++g;
          next = g + 1 < n_genomes ? starts[g + 1] : total;
        }
        if (g == gblock) {
          if (x < stbl[bin]) atomicMin(&stbl[bin], x);
        } else {
          global_min(plane + (long long)g * nbins + (long long)bin, x);
        }
      }
    }
    if (smin) {  // flush this k's table and reset it for the next
      __syncthreads();
      u64* row = out + ((long long)ki * n_genomes + gblock) * nbins;
      for (int e = tid; e < nbins; e += NT) {
        const u64 m = stbl[e];
        if (m != ~0ull) {
          global_min(row + e, m);
          stbl[e] = ~0ull;
        }
      }
      __syncthreads();
    }
  }
}

// Signs mode: its own kernel. A thread owns a run of SL window starts
// (shorter runs than the bin mode's, so that a reads chunk launches a few
// waves of blocks), computes ROUND signs of it at a time into shared
// memory, and the block writes each round back as whole 128-byte lines.
constexpr int SLG = 4;  // log2 of the window starts a run
constexpr int SL = 1 << SLG;
constexpr int ROUND = 16;  // a run's signs staged at a time: 128 bytes
static_assert(SL % ROUND == 0, "a run is whole rounds");

// out (nk, n_out): row ki holds k's signs of window starts [0, n_out).
// Shared memory: the table, NT x ROUND staged signs (thread t's sign w at
// t * ROUND + (w ^ t % ROUND): a round's stores and its 16-byte write-back
// both fill whole bank rows), then the span transposed as in the bin mode
// with SL rows of `pitch` bytes.
__global__ void __launch_bounds__(NT)
    nthash_signs_kernel(const unsigned char* __restrict__ seq, long long total,
                        const u64* __restrict__ ktab, int nk, int rc,
                        int pitch, long long n_out, u64* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* stab = reinterpret_cast<u64*>(smem);
  const u64* seed = stab + nk * KWORDS;
  const u64* rcs = seed + 4;
  u64* sout = stab + nk * KWORDS + 8;
  unsigned char* sseq = reinterpret_cast<unsigned char*>(sout + NT * ROUND);
  const int tid = threadIdx.x;
  for (int e = tid; e < nk * KWORDS + 8; e += NT) stab[e] = ktab[e];
  __syncthreads();
  const int kmax = (int)stab[(nk - 1) * KWORDS + 8];
  const long long base = (long long)blockIdx.x * NT * SL;
  const int span = NT * SL + kmax - 1;
  for (int e = tid; e < span; e += NT) {
    const long long p = base + e;
    sseq[(e & (SL - 1)) * pitch + (e >> SLG)] = p < total ? seq[p] : 0;
  }
  __syncthreads();
  auto byte_at = [&](int q) -> unsigned {
    return sseq[(q & (SL - 1)) * pitch + (q >> SLG)];
  };

  const int q0 = tid * SL;  // the run's first window start, block-relative
  const long long s0 = base + q0;
  const long long nout = max(0ll, min((long long)SL, n_out - s0));
  u64 fh = 0, v = 0;  // Horner state of the window at q0, j bases long
  int j = 0, last = 0;  // last: the last flag among bases 1..j-1 (0: none)
  for (int ki = 0; ki < nk; ++ki) {
    const u64* t = stab + ki * KWORDS;
    const int k = (int)t[8];
    // the run's windows that have a slot and end inside the stream
    const int nwin = (int)max(0ll, min(nout, total - k + 1 - s0));
    u64 f = 0, r = 0;
    int lf = 0;
    if (nwin > 0) {
      for (; j < k; ++j) {
        const unsigned b = byte_at(q0 + j);
        if (j > 0 && (b & 4u)) last = j;
        nt_extend(fh, v, b, seed, rcs);
      }
      f = fh;
      r = srolk(v, (int)(t[9] & 0xFFFFFFFFull), (int)(t[9] >> 32));
      lf = last;
    }
    u64* row = out + (long long)ki * n_out;
    const bool vec = (reinterpret_cast<unsigned long long>(row) & 15ull) == 0;
    for (int rd = 0; rd < SL / ROUND; ++rd) {
#pragma unroll
      for (int ww = 0; ww < ROUND; ++ww) {
        const int w = rd * ROUND + ww;
        u64 x = ~0ull;  // no window, or a flag inside it
        if (w < nwin) {
          if (w > 0) {
            const unsigned bo = byte_at(q0 + w - 1) & 3u;
            const unsigned bi = byte_at(q0 + w + k - 1);
            if (bi & 4u) lf = w + k - 1;
            nt_roll(f, r, bo, bi, t, seed, rcs);
          }
          if (lf <= w) x = nt_sign(f, r, rc);
        }
        sout[tid * ROUND + (ww ^ (tid & (ROUND - 1)))] = x;
      }
      __syncthreads();
      // the round's signs, two a lane: eight lanes write one run's 128
      // bytes, streamed past L1 (the host reads them once)
      for (int p = tid; p < NT * ROUND / 2; p += NT) {
        const int g = p / (ROUND / 2), h = p % (ROUND / 2);
        const long long s = base + (long long)g * SL + rd * ROUND + 2 * h;
        if (s >= n_out) continue;
        const u64* seg = sout + g * ROUND;
        const int sw = g & (ROUND - 1);
        const u64 v0 = seg[(2 * h) ^ sw], v1 = seg[(2 * h + 1) ^ sw];
        if (vec && s + 1 < n_out) {
          __stcs(reinterpret_cast<uint4*>(row + s),
                 make_uint4((unsigned)v0, (unsigned)(v0 >> 32),
                            (unsigned)v1, (unsigned)(v1 >> 32)));
        } else {
          __stcs(row + s, v0);
          if (s + 1 < n_out) __stcs(row + s + 1, v1);
        }
      }
      __syncthreads();
    }
  }
}

__global__ void magic_div_kernel(const u64* __restrict__ x, int n, u64 magic,
                                 int shift, u64* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = magic_div(x[i], magic, shift);
}

}  // namespace

// smem_bytes: nk * 80 + 64 table bytes, nbins * 8 when smin, then the
// transposed span, 64 * pitch bytes with
// pitch >= 256 + ((max k - 2) >> 6) + 1. Needs at least one window at the
// smallest k (total >= k[0]).
extern "C" int stpu_nthash_multi(const void* seq, long long total,
                                 const void* ktab, int nk, int kmin, int rc,
                                 const void* starts, int n_genomes,
                                 unsigned long long magic, int mshift,
                                 int nbins, int pitch, int smin,
                                 int smem_bytes, void* out, void* stream) {
  const long long windows = total - kmin + 1;
  if (windows <= 0 || nk < 1 || smem_bytes > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long per_block = (long long)NT * L;
  const long long blocks = (windows + per_block - 1) / per_block;
  nthash_multi_kernel<<<(unsigned)blocks, NT, smem_bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(seq), total,
      static_cast<const u64*>(ktab), nk, rc,
      static_cast<const long long*>(starts), n_genomes, magic, mshift, nbins,
      pitch, smin, static_cast<u64*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Signs mode: out (nk, n_out) u64 gets, for every k of ktab (ascending) and
// window start s < n_out, the sign of the window [s, s + k) of seq, or u64
// max where that window crosses a break flag or runs past total. The
// caller owns starts [0, n_out) and passes at least the max k - 1 bases
// past them where the stream has them. run_lg must be the kernel's SLG
// (a launch of another run length is refused); smem_bytes: nk * 80 + 64 table bytes,
// 256 * 16 * 8 staged signs, then the span, 2^run_lg * pitch bytes with
// pitch >= 256 + ((max k - 2) >> run_lg) + 1.
extern "C" int stpu_nthash_signs(const void* seq, long long total,
                                 const void* ktab, int nk, int rc,
                                 int run_lg, int pitch, int smem_bytes,
                                 long long n_out, void* out, void* stream) {
  if (n_out < 1 || total < 1 || nk < 1 || run_lg != SLG ||
      smem_bytes > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaFuncSetAttribute(nthash_signs_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_bytes);
  const long long per_block = (long long)NT * SL;
  const long long blocks = (n_out + per_block - 1) / per_block;
  nthash_signs_kernel<<<(unsigned)blocks, NT, smem_bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(seq), total,
      static_cast<const u64*>(ktab), nk, rc, pitch, n_out,
      static_cast<u64*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Resident signs-mode blocks per SM at smem_bytes, or -1.
extern "C" int stpu_nthash_signs_blocks_per_sm(int smem_bytes) {
  int b = 0;
  cudaFuncSetAttribute(nthash_signs_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem_bytes);
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &b, nthash_signs_kernel, NT, smem_bytes);
  return err == cudaSuccess ? b : -1;
}

// out[i] = floor(x[i] / d) by the kernel's magic division, for its tests.
// With l = ceil(log2 d) and magic = ceil(2^(61 + l) / d), shift = l - 3:
// magic * d = 2^(61 + l) + e with 0 <= e < d <= 2^l, so for x < 2^61
//   x * magic / 2^(61 + l) = x / d + x * e / (d * 2^(61 + l)) < x / d + 1 / d,
// and since the fraction of x / d is at most (d - 1) / d the floor is that
// of x / d. magic < 2^62 + 1 fits a u64; binsize >= 2^30 (at most 2^31
// bins) gives l >= 30, so the shift past the high word is not negative.
extern "C" int stpu_magic_div(const void* x, int n, unsigned long long magic,
                              int shift, void* out, void* stream) {
  if (n < 1) return 0;
  magic_div_kernel<<<(n + 255) / 256, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(x), n, magic, shift, static_cast<u64*>(out));
  return static_cast<int>(cudaGetLastError());
}
