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
// Bound: integer ALU; the batch (1 byte a residue) is read once. Design:
// the rolling hash of nthash_bin.cu, forward only.
// - A thread owns a run of L = 64 consecutive window starts. It builds the
//   first window's hash in Horner form, fwd <- srol(fwd) ^ SEED[c], which
//   extends from one k to the next larger one, so all k of the launch
//   (ascending) share one pass over the first max k residues. Then it
//   rolls, per k, in O(1) a window:
//     fwd' = srol(fwd) ^ srol^k(SEED[out]) ^ SEED[in]
//   from a 32-word table of srol^k(SEED[c]) per k in shared memory.
// - The block's span (from the residue before its first window start to
//   256 L + max k - 1 past it) is staged once, transposed so that the
//   threads of a warp read neighbouring bytes, free of bank conflicts. The
//   span bounds k: the wrapper's MAX_K_AA_CUDA.
// - The emission rule is one running number per run, the barrier of the
//   last flagged residue read: p + 1 for an invalid residue at p, p for a
//   sample start at p (a later residue never has a smaller barrier). The
//   window at w is valid when the barrier is <= w. The final window of a
//   sample needs it < w, which also asks for the residue at w - 1 to be
//   valid and not before the sample.
// - sign / binsize by a multiply-high, minima by a plain read and an
//   atomicMin (rolling.cuh); with smin the block first reduces the signs of
//   its first sample in a shared-memory table per k and flushes that.
#include <cuda_runtime.h>

#include "rolling.cuh"

using namespace stpu;

namespace {

constexpr int NT = 256;
constexpr int LG = 6;  // log2 of the window starts per thread
constexpr int L = 1 << LG;
constexpr int NC = 32;      // table words per k, one per 5-bit code
constexpr int KW = NC + 1;  // and k
constexpr unsigned CODE = 31u, INV = 0x20u, START = 0x40u;

// ktab: per k (ascending) KW words: srol^k(SEED[0..31]), k; then
// SEED[0..31]. out is (nk, n_samples, nbins), filled with u64 max; reach is
// (nk, n_samples), filled with 0.
__global__ void __launch_bounds__(NT)
    aahash_multi_kernel(const unsigned char* __restrict__ seq,
                        long long total, const u64* __restrict__ ktab, int nk,
                        const long long* __restrict__ starts, int n_samples,
                        u64 magic, int mshift, int nbins, int pitch, int smin,
                        u64* __restrict__ out, int* __restrict__ reach) {
  extern __shared__ __align__(8) unsigned char smem[];
  u64* stab = reinterpret_cast<u64*>(smem);
  const u64* seed = stab + nk * KW;
  u64* stbl = stab + nk * KW + NC;  // nbins minima when smin
  unsigned char* sseq =
      reinterpret_cast<unsigned char*>(stbl + (smin ? nbins : 0));
  const int tid = threadIdx.x;
  for (int e = tid; e < nk * KW + NC; e += NT) stab[e] = ktab[e];
  if (smin) {
    for (int e = tid; e < nbins; e += NT) stbl[e] = ~0ull;
  }
  __syncthreads();
  const int kmax = (int)stab[(nk - 1) * KW + NC];
  const long long base = (long long)blockIdx.x * NT * L;
  // staged byte e is residue base - 1 + e
  const int span = NT * L + kmax;
  for (int e = tid; e < span; e += NT) {
    const long long p = base - 1 + e;
    sseq[(e & (L - 1)) * pitch + (e >> LG)] =
        p >= 0 && p < total ? seq[p] : 0;
  }
  __syncthreads();
  auto byte_at = [&](int q) -> unsigned {  // residue base + q, q >= -1
    const int e = q + 1;
    return sseq[(e & (L - 1)) * pitch + (e >> LG)];
  };
  auto sample_of = [&](long long s) {  // last sample with starts[g] <= s
    int lo = 0, hi = n_samples - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (starts[mid] <= s) lo = mid; else hi = mid - 1;
    }
    return lo;
  };

  const int q0 = tid * L;  // the run's first window start, block-relative
  const long long s0 = base + q0;
  const int g0 = sample_of(s0);
  const int gblock = smin ? sample_of(base) : -1;
  u64 fh = 0;   // Horner state of the window at q0, j residues long
  int j = 0;
  int bar = -2;  // barrier of the last flagged residue read, run-relative
  {
    const unsigned b = byte_at(q0 - 1);
    if (b & INV) bar = 0; else if (b & START) bar = -1;
  }
  for (int ki = 0; ki < nk; ++ki) {
    const u64* t = stab + ki * KW;
    const int k = (int)t[NC];
    if (s0 + k <= total) {
      for (; j < k; ++j) {
        const unsigned b = byte_at(q0 + j);
        if (b & INV) bar = j + 1; else if (b & START) bar = j;
        fh = srol1(fh) ^ seed[b & CODE];
      }
      u64 f = fh;
      int lb = bar, g = g0, flagged = -1;
      long long next = g + 1 < n_samples ? starts[g + 1] : total;
      const long long left = total - k + 1 - s0;  // windows from s0 on
      const int nwin = left < L ? (int)left : L;
      u64* plane = out + (long long)ki * n_samples * nbins;
      for (int w = 0; w < nwin; ++w) {
        if (w > 0) {
          const unsigned bo = byte_at(q0 + w - 1);
          const unsigned bi = byte_at(q0 + w + k - 1);
          if (bi & INV) lb = w + k; else if (bi & START) lb = w + k - 1;
          f = srol1(f) ^ t[bo & CODE] ^ seed[bi & CODE];
        }
        if (lb > w) continue;  // an invalid residue or a sample start inside
        const long long s = s0 + w;
        while (s >= next && g + 1 < n_samples) {
          ++g;
          next = g + 1 < n_samples ? starts[g + 1] : total;
        }
        if (s + k == next) {  // the sample's final window
          if (lb == w) continue;
        } else if (g != flagged) {
          reach[(long long)ki * n_samples + g] = 1;
          flagged = g;
        }
        u64 x = (f & M61) + (f >> 61);
        if (x >= M61) x -= M61;
        const u64 bin = magic_div(x, magic, mshift);
        if (g == gblock) {
          if (x < stbl[bin]) atomicMin(&stbl[bin], x);
        } else {
          global_min(plane + (long long)g * nbins + (long long)bin, x);
        }
      }
    }
    if (smin) {  // flush this k's table and reset it for the next
      __syncthreads();
      u64* row = out + ((long long)ki * n_samples + gblock) * nbins;
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

}  // namespace

// smem_bytes: (nk * 33 + 32) * 8 table bytes, nbins * 8 when smin, then the
// transposed span, 64 * pitch bytes with pitch >= 256 + ((max k - 1) >> 6)
// + 1; above 48 KB the launch opts in to more dynamic shared memory. Needs
// at least one window at the smallest k (total >= k[0]).
extern "C" int stpu_aahash_multi(const void* seq, long long total,
                                 const void* ktab, int nk, int kmin,
                                 const void* starts, int n_samples,
                                 unsigned long long magic, int mshift,
                                 int nbins, int pitch, int smin,
                                 int smem_bytes, void* out, void* reach,
                                 void* stream) {
  const long long windows = total - kmin + 1;
  if (windows <= 0 || nk < 1 || n_samples < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        aahash_multi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long per_block = (long long)NT * L;
  const long long blocks = (windows + per_block - 1) / per_block;
  aahash_multi_kernel<<<(unsigned)blocks, NT, smem_bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(seq), total,
      static_cast<const u64*>(ktab), nk,
      static_cast<const long long*>(starts), n_samples, magic, mshift, nbins,
      pitch, smin, static_cast<u64*>(out), static_cast<int*>(reach));
  return static_cast<int>(cudaGetLastError());
}
