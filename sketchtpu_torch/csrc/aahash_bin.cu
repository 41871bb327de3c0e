// aaHash + Mersenne-61 sign + per-(k, sample, bin) minimum for every k of a
// sketch in one launch, with a per-(k, sample) reachability flag: the port
// of sketchtpu/hash/aahash_jax.py aa_hash_bin_kernel (:355) and
// aa_hash_bin_kernel_devmask (:320) and of sketchtpu/hash/aahash_multik.py
// multik_aa_hash_bin_kernel (:60), XLA programs that together are the whole
// compute of the amino-acid (and 3Di) sketch stage.
//
// For every window start s of a batch of concatenated samples and every k:
//   fwd = XOR_j srol^(k-1-j)(SEED[c(s+j)])   (forward only, no rc)
//   sign = fwd mod (2^61 - 1)                (shift-add, signs.py)
//   out[k][sample][sign / binsize] = min(out, sign)  (64-bit atomicMin)
// where c is a residue's 5-bit code (the level's 20 letters in either case
// are 0..19, anything else 20, whose seed is 0) and SEED the level's seeds.
// A window is emitted exactly where aahash_np.aa_window_valid emits it in
// its own sample:
// - all k residues are valid and the window lies inside one sample;
// - the final window of a sample (s = end - k) also needs the residue
//   before it valid and inside the sample (length > k): the reference's
//   final-window quirk (aahash_iterator.rs:138-210).
// reach[k][sample] = 1 where the sample emitted a window other than its
// final one at that k (the `counts` of aahash_jax._aa_window_mask_device);
// where it stays 0 the host raises aa_window_valid's "K-mer larger than
// smallest valid sequence". Input bytes: code | INV (an invalid residue)
// | START (the first residue of a sample).
//
// Bound: integer issue; the batch (1 byte a residue) is read once. The
// loop waits on shared-memory latency more than it issues, so the design
// trades registers for blocks an SM. Design, for Hopper:
// - A thread owns a run of `run` consecutive window starts (run = 8 u + 4,
//   chosen by the wrapper) and builds the first window's hash in Horner
//   form, fwd <- srol(fwd) ^ SEED[c], which extends from one k to the next
//   larger one, so all k of the launch (ascending) share one pass over the
//   first max k residues. Then it rolls in O(1) a window:
//     fwd' = srol(fwd) ^ srol^k(SEED[out]) ^ SEED[in]
//   from a 32-word table of srol^k(SEED[c]) per k in shared memory.
// - k is the inner loop: KG k at a time roll as independent chains over
//   the run's windows, sharing the outgoing residue's byte, the window's
//   sample and its position tests.
// - A block walks `tiles` consecutive tiles of 256 runs; the wrapper sizes
//   run and tiles so that the grid is one wave of equal blocks (or whole
//   waves). A tile's span (from the residue before its first window start
//   to 256 run + max k - 1 past it) is staged once in residue order: with
//   run / 4 odd, the 32 lanes of a warp read 32 banks.
// - The block's first and last sample come from one binary search over
//   `starts`; a thread searches only between them.
// - The emission rule is one running number per run and k, the barrier of
//   the last flagged residue read: p + 1 for an invalid residue at p, p
//   for a sample start at p (a later residue never has a smaller barrier).
//   The window at w is valid when the barrier is <= w. The final window of
//   a sample needs it < w, which also asks for the residue at w - 1 to be
//   valid and not before the sample.
// - sign / binsize is a shift where nbins is a power of two (sign >> (61 -
//   log2 nbins) is that quotient for every sign below 2^61 - 1), else a
//   multiply-high (rolling.cuh).
// - Minima: atomicMin in device memory (a native REDG.MIN.64; a 64-bit
//   shared-memory atomicMin is a compare-and-swap loop). With smin, a
//   shared-memory cache per k of the pass holds, per bin of the block's
//   first sample, the top 32 bits (sign >> 29) of a sign already sent; a
//   sign whose top bits exceed them cannot lower the bin and is dropped.
//   The cache only ever holds keys of sent signs, so a racing plain store
//   can only let more signs through. Other samples' signs read the slot in
//   L2 first.
#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

#include "rolling.cuh"

using namespace stpu;

namespace {

constexpr int NT = 256;
constexpr int KG = 4;       // k rolled together
constexpr int NC = 32;      // table words per k, one per 5-bit code
constexpr int KW = NC + 1;  // and k
constexpr unsigned CODE = 31u, INV = 0x20u, START = 0x40u;

// The last sample g in [lo, hi] with starts[g] <= s.
__device__ __forceinline__ int sample_in(const long long* starts, long long s,
                                         int lo, int hi) {
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (starts[mid] <= s) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// ktab: per k (ascending) KW words: srol^k(SEED[0..31]), k; then
// SEED[0..31]. out is (nk, n_samples, nbins), filled with u64 max; reach is
// (nk, n_samples), filled with 0. POW2: bin = sign >> mshift.
// Blocks an SM each bin mode is compiled for: the register cap that the
// shift mode meets without spills (48) and the multiply-high mode (64).
template <bool POW2>
constexpr int aahash_min_blocks() {
  return POW2 ? 5 : 4;
}

template <bool POW2>
__global__ void __launch_bounds__(NT, aahash_min_blocks<POW2>())
    aahash_multi_kernel(const unsigned char* __restrict__ seq,
                        long long total, const u64* __restrict__ ktab, int nk,
                        const long long* __restrict__ starts, int n_samples,
                        u64 magic, int mshift, int nbins, int run, int tiles,
                        int smin, u64* __restrict__ out,
                        int* __restrict__ reach) {
  extern __shared__ __align__(8) unsigned char smem[];
  __shared__ int sg[2];
  u64* stab = reinterpret_cast<u64*>(smem);
  const u64* seed = stab + nk * KW;
  // min(KG, nk) x nbins cache keys when smin
  unsigned* stbl = reinterpret_cast<unsigned*>(stab + nk * KW + NC);
  unsigned char* sseq = reinterpret_cast<unsigned char*>(
      stbl + (smin ? min(KG, nk) * nbins : 0));
  const int tid = threadIdx.x;
  for (int e = tid; e < nk * KW + NC; e += NT) stab[e] = ktab[e];
  if (smin) {
    for (int e = tid; e < min(KG, nk) * nbins; e += NT) stbl[e] = ~0u;
  }
  const int kmax = (int)ktab[(nk - 1) * KW + NC];
  const long long first = (long long)blockIdx.x * tiles * NT * run;
  if (tid == 0) {
    sg[0] = sample_in(starts, first, 0, n_samples - 1);
    const long long last = min(first + (long long)tiles * NT * run, total) - 1;
    sg[1] = sample_in(starts, last, sg[0], n_samples - 1);
  }
  for (int tile = 0; tile < tiles; ++tile) {
    const long long base = first + (long long)tile * NT * run;
    if (base >= total) break;
    __syncthreads();  // the previous tile is done with the span
    // staged byte e is residue base - 1 + e
    const int span = NT * run + kmax + 1;
    for (int e = tid; e < span; e += NT) {
      const long long p = base - 1 + e;
      sseq[e] = p >= 0 && p < total ? seq[p] : 0;
    }
    __syncthreads();
    const int glo = sg[0], ghi = sg[1];
    const int gtab = smin ? glo : -1;  // the table's sample
    const int q0 = tid * run;  // the run's first window start, tile-relative
    const long long s0 = base + q0;
    const unsigned char* rb = sseq + q0 + 1;  // rb[j]: residue s0 + j
    const int g0 = sample_in(starts, s0, glo, ghi);
    u64 fh = 0;   // Horner state of the window at s0, j residues long
    int j = 0;
    int bar = -2;  // barrier of the last flagged residue read, run-relative
    {
      const unsigned b = rb[-1];
      if (b & INV) bar = 0; else if (b & START) bar = -1;
    }
    // One pass: the KC k from k0 on roll together over the run's windows.
    auto pass = [&](int k0, auto kc_tag) {
      constexpr int KC = decltype(kc_tag)::value;
      u64 f[KC];
      int kk[KC], lb[KC];
      const int trel = (int)min(total - s0, (long long)INT_MAX);
      int full = run;  // windows that every chain has: the largest k's
      int nw0 = 0;     // windows of the smallest k
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        kk[c] = (int)stab[(k0 + c) * KW + NC];
        const int left = trel - kk[c] + 1;  // windows from s0 on
        f[c] = 0;
        lb[c] = 0;
        if (left > 0) {
          for (; j < kk[c]; ++j) {
            const unsigned b = rb[j];
            if (b & INV) bar = j + 1; else if (b & START) bar = j;
            fh = srol1(fh) ^ seed[b & CODE];
          }
          f[c] = fh;
          lb[c] = bar;
        }
        const int nwc = max(0, min(left, run));
        if (c == 0) nw0 = nwc;
        full = min(full, nwc);
      }
      int g = g0;
      long long nxt = g + 1 < n_samples ? starts[g + 1] : total;
      int nrel = (int)min(nxt - s0, (long long)INT_MAX);  // run-relative
      // chains that emitted a window of sample g other than its final one
      unsigned seen = 0u;
      auto mark_reach = [&]() {
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          if (seen >> c & 1u) reach[(long long)(k0 + c) * n_samples + g] = 1;
        }
        seen = 0u;
      };
      const long long kplane = (long long)n_samples * nbins;
      u64* trow = out + (long long)max(gtab, 0) * nbins;  // the cache's row
      long long grow = (long long)g * nbins;  // sample g's row in a plane
      // The roll into window w > 0 of chain c, from the residues leaving
      // (bo) and entering (bi).
      auto roll = [&](int c, int w, unsigned bo, unsigned bi) {
        if (bi & INV) lb[c] = w + kk[c];
        else if (bi & START) lb[c] = w + kk[c] - 1;
        f[c] = srol1(f[c]) ^ stab[(k0 + c) * KW + (bo & CODE)] ^
               seed[bi & CODE];
      };
      // Window w of every chain (CHECK: of the chains whose window fits).
      auto emit = [&](int w, auto check) {
        constexpr bool CHECK = decltype(check)::value;
        while (w >= nrel && g + 1 < n_samples) {
          mark_reach();
          ++g;
          nxt = g + 1 < n_samples ? starts[g + 1] : total;
          nrel = (int)min(nxt - s0, (long long)INT_MAX);
          grow = (long long)g * nbins;
        }
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const bool valid = (!CHECK || w + kk[c] <= trel) && lb[c] <= w;
          const bool fin = w + kk[c] == nrel;  // the sample's final window
          seen |= (unsigned)(valid && !fin) << c;
          if (!valid || (fin && lb[c] == w)) continue;
          u64 x = (f[c] & M61) + (f[c] >> 61);
          if (x >= M61) x -= M61;
          const u64 bin = POW2 ? x >> mshift : magic_div(x, magic, mshift);
          // (the device-memory address only where a sign goes there: most
          // stop at the cache)
          if (g == gtab) {
            unsigned* slot = stbl + c * nbins + bin;
            const unsigned key = (unsigned)(x >> 29);
            if (key <= *slot) {  // the cache: a plain store
              *slot = key;
              atomicMin(trow + (k0 + c) * kplane + (long long)bin, x);
            }
          } else {
            global_min(out + (k0 + c) * kplane + grow + (long long)bin, x);
          }
        }
      };
      if (nw0 > 0) emit(0, std::true_type{});
      // the windows every chain has, with the next window's residues read
      // ahead (the span holds one byte past the last one read)
      unsigned bo = rb[0], bi[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) bi[c] = rb[kk[c]];
      int w = 1;
      for (; w < full; ++w) {
        const unsigned obo = bo;
        unsigned obi[KC];
#pragma unroll
        for (int c = 0; c < KC; ++c) obi[c] = bi[c];
        bo = rb[w];
#pragma unroll
        for (int c = 0; c < KC; ++c) bi[c] = rb[w + kk[c]];
#pragma unroll
        for (int c = 0; c < KC; ++c) roll(c, w, obo, obi[c]);
        emit(w, std::false_type{});
      }
      for (; w < nw0; ++w) {  // the batch's end: the larger k run out
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          if (w + kk[c] <= trel) roll(c, w, rb[w - 1], rb[w + kk[c] - 1]);
        }
        emit(w, std::true_type{});
      }
      mark_reach();
      // the caches hold this pass's k: with more passes, empty them
      if (smin && nk > KG) {
        __syncthreads();
        for (int e = tid; e < KC * nbins; e += NT) stbl[e] = ~0u;
        __syncthreads();
      }
    };
    for (int k0 = 0; k0 < nk; k0 += KG) {
      switch (min(KG, nk - k0)) {
        case 4: pass(k0, std::integral_constant<int, 4>{}); break;
        case 3: pass(k0, std::integral_constant<int, 3>{}); break;
        case 2: pass(k0, std::integral_constant<int, 2>{}); break;
        default: pass(k0, std::integral_constant<int, 1>{}); break;
      }
    }
  }
}

template <bool POW2>
cudaError_t aahash_attr(int smem_bytes) {
  return cudaFuncSetAttribute(aahash_multi_kernel<POW2>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

}  // namespace

// smem_bytes: (nk * 33 + 32) * 8 table bytes, min(4, nk) * nbins * 8 when
// smin, then the span, 256 * run + max k + 1 bytes. run = 8 u + 4; a block
// walks `tiles` tiles of 256 runs. pow2: nbins is a power of two and
// mshift = 61 - log2(nbins) (magic unused). Needs at least one window at
// the smallest k (total >= k[0]).
extern "C" int stpu_aahash_multi(const void* seq, long long total,
                                 const void* ktab, int nk, int kmin,
                                 const void* starts, int n_samples,
                                 unsigned long long magic, int mshift,
                                 int pow2, int nbins, int run, int tiles,
                                 int smin, int smem_bytes, void* out,
                                 void* reach, void* stream) {
  const long long windows = total - kmin + 1;
  if (windows <= 0 || nk < 1 || n_samples < 1 || run < 4 || run % 8 != 4 ||
      tiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      pow2 ? aahash_attr<true>(smem_bytes) : aahash_attr<false>(smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per_block = (long long)tiles * NT * run;
  const long long blocks = (windows + per_block - 1) / per_block;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pseq = static_cast<const unsigned char*>(seq);
  const auto* ptab = static_cast<const u64*>(ktab);
  const auto* pst = static_cast<const long long*>(starts);
  auto* pout = static_cast<u64*>(out);
  auto* preach = static_cast<int*>(reach);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pow2) {
    aahash_multi_kernel<true><<<(unsigned)blocks, NT, smem_bytes, st>>>(
        pseq, total, ptab, nk, pst, n_samples, magic, mshift, nbins, run,
        tiles, smin, pout, preach);
  } else {
    aahash_multi_kernel<false><<<(unsigned)blocks, NT, smem_bytes, st>>>(
        pseq, total, ptab, nk, pst, n_samples, magic, mshift, nbins, run,
        tiles, smin, pout, preach);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM at smem_bytes in the bin mode pow2, or -1.
extern "C" int stpu_aahash_blocks_per_sm(int smem_bytes, int pow2) {
  int b = 0;
  cudaError_t err;
  if (pow2) {
    err = aahash_attr<true>(smem_bytes);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &b, aahash_multi_kernel<true>, NT, smem_bytes);
    }
  } else {
    err = aahash_attr<false>(smem_bytes);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &b, aahash_multi_kernel<false>, NT, smem_bytes);
    }
  }
  return err == cudaSuccess ? b : -1;
}
