// ntHash + Mersenne-61 sign + per-(genome, bin) minimum: the port of
// sketchtpu/hash/nthash_jax.py hash_bin_kernel (an XLA program, the whole
// compute of the sketch stage).
//
// One thread per window start s of a batch of concatenated genomes:
//   fwd = XOR_j tf[j][c(s+j)], rev = XOR_j tr[j][c(s+j)]  (nthash_np.py)
//   h = rc ? min(fwd, rev) : fwd         (min as unsigned 64-bit)
//   sign = h mod (2^61 - 1)              (shift-add, signs.py)
//   bin = sign / binsize                 (plain u64 division)
//   out[genome][bin] = min(out, sign)    (64-bit atomicMin)
// The window is dropped when a break flag sits at s+1..s+k-1 (a break at p
// forbids s < p < s+k; the packer puts one at every genome start) or when
// it runs past the batch. seq bytes are code | break << 2.
//
// Bound: integer ALU (2k 64-bit table XORs per window) and, per bin, the
// atomic traffic. Design: the block's k tap tables and its span of
// sequence bytes are staged in shared memory; a plain L2 read of the slot
// skips the atomic for every sign that cannot lower it, which is nearly
// all of them once a bin's minimum has settled.
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;
constexpr u64 M61 = (1ull << 61) - 1;
constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
    nthash_bin_kernel(const unsigned char* __restrict__ seq, long long total,
                      int k, const u64* __restrict__ tf,
                      const u64* __restrict__ tr, int rc,
                      const long long* __restrict__ starts, int n_genomes,
                      u64 binsize, int nbins, u64* __restrict__ out) {
  extern __shared__ u64 smem[];
  u64* stf = smem;
  u64* str = smem + 4 * k;
  unsigned char* sseq = reinterpret_cast<unsigned char*>(smem + 8 * k);
  for (int e = threadIdx.x; e < 4 * k; e += blockDim.x) {
    stf[e] = tf[e];
    str[e] = rc ? tr[e] : 0ull;
  }
  const long long base = (long long)blockIdx.x * blockDim.x;
  for (int e = threadIdx.x; e < (int)blockDim.x + k - 1; e += blockDim.x) {
    const long long p = base + e;
    sseq[e] = p < total ? seq[p] : 0;
  }
  __syncthreads();

  const long long s = base + threadIdx.x;
  if (s + k > total) return;
  const unsigned char* w = sseq + threadIdx.x;
  u64 fh = 0, rh = 0;
  unsigned brk = 0;
  for (int j = 0; j < k; ++j) {
    const unsigned v = w[j];
    const unsigned c = v & 3u;
    if (j > 0) brk |= v & 4u;
    fh ^= stf[4 * j + c];
    rh ^= str[4 * j + c];
  }
  if (brk) return;
  const u64 h = (rc && rh < fh) ? rh : fh;
  u64 x = (h & M61) + (h >> 61);
  if (x >= M61) x -= M61;
  const u64 bin = x / binsize;

  int lo = 0, hi = n_genomes - 1;  // last genome with starts[g] <= s
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (starts[mid] <= s) lo = mid; else hi = mid - 1;
  }
  u64* slot = out + (long long)lo * nbins + (long long)bin;
  if (x < __ldcg(slot)) atomicMin(slot, x);
}

}  // namespace

extern "C" int stpu_nthash_bin(const void* seq, long long total, int k,
                               const void* tf, const void* tr, int rc,
                               const void* starts, int n_genomes,
                               unsigned long long binsize, int nbins,
                               void* out, void* stream) {
  const long long windows = total - k + 1;
  if (windows <= 0) return 0;
  const long long blocks = (windows + NT - 1) / NT;
  const size_t smem = 64 * (size_t)k + NT + k;
  nthash_bin_kernel<<<(unsigned)blocks, NT, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(seq), total, k,
      static_cast<const u64*>(tf), static_cast<const u64*>(tr), rc,
      static_cast<const long long*>(starts), n_genomes, binsize, nbins,
      static_cast<u64*>(out));
  return static_cast<int>(cudaGetLastError());
}
