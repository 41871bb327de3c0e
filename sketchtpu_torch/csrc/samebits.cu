// K1 and K4: exact samebits, the port of sketchtpu/dist/pallas_kernels.py
// samebits_strip_fused (K1, kernel _samebits_strip_kernel) and
// samebits_pallas (K4, the same function with int32 output and no
// triangle); samebits_dist, K4 with an f32 distance epilogue, the
// counterpart of sketchtpu/dist/jaccard_jax.py jaccard_dist_block (an XLA
// program); and samebits_finish, the distance finish of a words split of
// the sketch (sharded_dist_step's tile after its psum over 'words').
//
// out[i][j] = sum_c popcount(AND_p ~(a[i][c][p] ^ b[j][c][p])) as int16 (the
// dense-stream strips; exact since samebits <= s64*64 <= 32767) or int32
// (the all-pairs matrix the host distance functions call). With tri (global
// row = row0 + i), pairs with column <= row are zero: tiles wholly at or
// below the diagonal are written as zeros without computing them, and the
// diagonal tiles zero those pairs in the epilogue. A multi-plane launch
// (stpu_samebits_planes: K4 at every k of (n, nk, W) words) takes the
// plane from blockIdx.y and offsets a, b and out by their plane strides
// before the body, so each k's counts land in their plane of one (nk, na,
// nb) slab; a one-plane launch has blockIdx.y = 0.
//
// The distance epilogue (the DIST instantiation, stpu_samebits_dist): j =
// (max(sb - expected, 0) * maxnbits / denom) / maxnbits and 1 - j, or the
// ANI max(0, 1 + inv_k * ln(2j / (1 + j))), in f32 (dist_value); the
// constants are the whole sketch's. Every float operation is the twin's
// (samebits_kernels.samebits_dist_ref), in its order, without FMA. The
// mode is a template argument, so K1's and K4's instantiations keep their
// code.
//
// Bound: integer issue. A pair costs s64 * BBITS * 2 LOP3 (one per 32-bit
// word and plane: acc & ~(a ^ b) is one three-input logic op) plus 2
// popcounts per chunk, against (na + nb) * s64 * BBITS * 8 bytes read.
// Design:
// - a 64 x 64 pair tile per 256-thread block, 4 x 4 pairs per thread in
//   registers (8 x 4 and 4 x 8 spill under the two-blocks-per-SM register
//   cap and ran no faster);
// - both operands staged through the two-stage cp.async ring of tile.cuh,
//   RING_G chunks per barrier with the next stage in flight, any s64 (a
//   missing chunk of the last stage is neither copied nor computed); each
//   warp stages 8 rows of both operands, which measured ~2 % faster than
//   ring_role's one operand per warp;
// - a 1-D grid of tiles with row tiles fastest (the blocks resident
//   together read the same few column tiles, so a strip whose rows fit L2
//   reads its column plane from device memory once, however wide it is),
//   and the k-plane as grid.y.
//
// samebits_finish (stpu_samebits_finish): the w int32 (n,) partial counts
// of a words split (each slot's K4 over its range of chunks, the lead's
// own among them) summed in registers, written as int32 (count mode) or
// through dist_value as f32 1 - j or ANI: bit for bit the samebits_dist of
// the whole sketch, since the sums are exact and dist_value is shared. Bound:
// bytes (w * 4 read and 4 written an entry against a few float
// operations). Design: 256 threads a block, 4 entries a thread at a block
// stride, so each warp's loads and stores are coalesced 128-byte lines
// and every thread has 4 * w independent loads in flight; any alignment.
#include "tile.cuh"

using namespace stpu;

namespace {

constexpr int TX = 16, TY = 16;  // threads
constexpr int RM = 4, RN = 4;    // pairs per thread
constexpr int TI = TY * RM, TJ = TX * RN, NT = TX * TY;
constexpr int LDS = RING_LDS;
constexpr int RING_BYTES = 2 * RING_OPERAND * 8;
// rows of each operand that one warp stages
constexpr int WARP_ROWS = TI / (NT / 32);
static_assert(TI == RING_ROWS && TJ == RING_ROWS,
              "the ring stages 64 rows of each operand");

// One staged chunk of the samebits count for the thread's RM x RN pairs:
// rows ty + i*TY of sa, columns tx + j*TX of sb ([plane][row], pitch LDS).
__device__ __forceinline__ void chunk_count(int (&cnt)[RM][RN],
                                            const u64* __restrict__ sa,
                                            const u64* __restrict__ sb,
                                            int ty, int tx) {
  u64 acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = ~0ull;
#pragma unroll
  for (int p = 0; p < BBITS; ++p) {
    u64 bv[RN];
#pragma unroll
    for (int j = 0; j < RN; ++j) bv[j] = sb[p * LDS + tx + j * TX];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const u64 av = sa[p * LDS + ty + i * TY];
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] &= ~(av ^ bv[j]);
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) cnt[i][j] += __popcll(acc[i][j]);
}

// The distance epilogue's arguments (unused by the count instantiations).
struct DistArgs {
  float expected, maxnbits, denom, inv_k;
  int ani;
};

// Plane strides (elements) of a, b and out in a multi-plane launch.
struct Planes {
  long long a, b, out;
};

// The f32 distance of a whole sketch's samebits count sb.
__device__ __forceinline__ float dist_value(int sb, const DistArgs& d) {
  const float diff = fmaxf((float)sb - d.expected, 0.f);
  const float j = (diff * d.maxnbits / d.denom) / d.maxnbits;
  if (!d.ani) return 1.f - j;
  const float v = 1.f + d.inv_k * logf((2.f * j) / (1.f + j));
  return v < 0.f ? 0.f : v;  // NaN-propagating max, as jnp.maximum
}

template <typename OutT, bool DIST>
__global__ void __launch_bounds__(NT, 2)
    samebits_kernel(const u64* __restrict__ a, long long lda,
                    const u64* __restrict__ b, long long ldb,
                    OutT* __restrict__ out, long long ldo, int na, int nb,
                    int s64, int tri, long long row0, const Planes pl,
                    const DistArgs d) {
  a += blockIdx.y * pl.a;
  b += blockIdx.y * pl.b;
  out += blockIdx.y * pl.out;
  extern __shared__ __align__(16) unsigned char smem[];
  u64* sA = reinterpret_cast<u64*>(smem);
  u64* sB = sA + RING_OPERAND;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;

  const int nrt = (na + TI - 1) / TI;  // row tiles run fastest
  const int i0 = (int)(blockIdx.x % nrt) * TI;
  const int j0 = (int)(blockIdx.x / nrt) * TJ;

  int cnt[RM][RN] = {};
  if (!(tri && tile_below_diagonal(i0, j0, TJ, nb, row0))) {
    // lane < 28 copies plane lane % 14 of every other one of its warp's
    // WARP_ROWS rows of each operand
    const int warp = tid / 32, lane = tid % 32;
    const bool stager = lane < 2 * BBITS;
    const int plane = lane % BBITS;
    const int row = warp * WARP_ROWS + lane / BBITS;
    const u64* a_src = a + (long long)(i0 + row) * lda + plane;
    const u64* b_src = b + (long long)(j0 + row) * ldb + plane;
    u64* a_dst = sA + plane * LDS + row;
    u64* b_dst = sB + plane * LDS + row;
    const int nstage = (s64 + RING_G - 1) / RING_G;
    auto load_stage = [&](int s) {
      if (!stager) return;
      const int buf = s % RING_STAGES;
#pragma unroll
      for (int g = 0; g < RING_G; ++g) {
        const int c = s * RING_G + g;
        if (c >= s64) break;
        const long long off = (long long)c * BBITS;
        const int at = (buf * RING_G + g) * RING_CHUNK;
        ring_copy<WARP_ROWS / 2>(a_dst + at, a_src + off, lda, na - i0 - row,
                                 a);
        ring_copy<WARP_ROWS / 2>(b_dst + at, b_src + off, ldb, nb - j0 - row,
                                 b);
      }
    };

    load_stage(0);
    cp_async_commit();
    for (int s = 0; s < nstage; ++s) {
      cp_async_wait_all();
      __syncthreads();  // stage s is in; everyone is done with stage s - 1
      if (s + 1 < nstage) load_stage(s + 1);
      cp_async_commit();
      const int buf = s % RING_STAGES;
#pragma unroll
      for (int g = 0; g < RING_G; ++g) {
        if (s * RING_G + g < s64) {
          const int at = (buf * RING_G + g) * RING_CHUNK;
          chunk_count(cnt, sA + at, sB + at, ty, tx);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gi = i0 + ty + i * TY;
    if (gi >= na) continue;
    const long long diag = row0 + gi;  // tri: columns <= diag are zero
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int gj = j0 + tx + j * TX;
      if (gj >= nb) continue;
      if constexpr (DIST) {
        out[(long long)gi * ldo + gj] = dist_value(cnt[i][j], d);
      } else {
        out[(long long)gi * ldo + gj] =
            (OutT)(tri && gj <= diag ? 0 : cnt[i][j]);
      }
    }
  }
}

template <typename OutT, bool DIST = false>
cudaError_t launch(const u64* a, long long lda, const u64* b, long long ldb,
                   OutT* out, long long ldo, int na, int nb, int s64,
                   int tri, long long row0, cudaStream_t st,
                   const DistArgs& d = DistArgs{}, int planes = 1,
                   const Planes& pl = Planes{}) {
  // every launch: the attribute belongs to the current device only
  const cudaError_t configured = cudaFuncSetAttribute(
      samebits_kernel<OutT, DIST>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, RING_BYTES);
  if (configured != cudaSuccess) return configured;
  const long long blocks =
      (long long)((na + TI - 1) / TI) * ((nb + TJ - 1) / TJ);
  if (blocks > 0x7FFFFFFFLL || planes < 1 || planes > 65535) {
    return cudaErrorInvalidValue;
  }
  samebits_kernel<OutT, DIST>
      <<<dim3((unsigned)blocks, (unsigned)planes), NT, RING_BYTES, st>>>(
          a, lda, b, ldb, out, ldo, na, nb, s64, tri, row0, pl, d);
  return cudaGetLastError();
}

constexpr int FIN_NT = 256, FIN_EACH = 4;

template <bool DIST>
__global__ void __launch_bounds__(FIN_NT)
    samebits_finish_kernel(const WordsParts parts, long long n,
                           void* __restrict__ out, const DistArgs d) {
  const long long at =
      (long long)blockIdx.x * (FIN_NT * FIN_EACH) + threadIdx.x;
  int sb[FIN_EACH] = {};
#pragma unroll
  for (int q = 0; q < MAX_WORDS_SLOTS; ++q) {
    if (q < parts.n) {
      const int* __restrict__ src = parts.p[q];
#pragma unroll
      for (int e = 0; e < FIN_EACH; ++e) {
        const long long i = at + e * FIN_NT;
        if (i < n) sb[e] += src[i];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < FIN_EACH; ++e) {
    const long long i = at + e * FIN_NT;
    if (i >= n) continue;
    if constexpr (DIST) {
      static_cast<float*>(out)[i] = dist_value(sb[e], d);
    } else {
      static_cast<int*>(out)[i] = sb[e];
    }
  }
}

}  // namespace

extern "C" int stpu_samebits(const void* a, long long lda, const void* b,
                             long long ldb, void* out, long long ldo, int na,
                             int nb, int s64, int out_bytes, int tri,
                             long long row0, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const u64* pa = static_cast<const u64*>(a);
  const u64* pb = static_cast<const u64*>(b);
  cudaError_t err = cudaErrorInvalidValue;
  if (out_bytes == 2) {
    err = launch(pa, lda, pb, ldb, static_cast<short*>(out), ldo, na, nb, s64,
                 tri, row0, st);
  } else if (out_bytes == 4) {
    err = launch(pa, lda, pb, ldb, static_cast<int*>(out), ldo, na, nb, s64,
                 tri, row0, st);
  }
  return static_cast<int>(err);
}

// K4 at each of nk k-planes: out (nk, na, nb) int32, plane p from a + p *
// aks and b + p * bks (strides in words), rows at lda / ldb.
extern "C" int stpu_samebits_planes(const void* a, long long lda,
                                    long long aks, const void* b,
                                    long long ldb, long long bks, void* out,
                                    int na, int nb, int s64, int nk,
                                    void* stream) {
  const Planes pl{aks, bks, (long long)na * nb};
  return static_cast<int>(launch(
      static_cast<const u64*>(a), lda, static_cast<const u64*>(b), ldb,
      static_cast<int*>(out), nb, na, nb, s64, 0, 0,
      static_cast<cudaStream_t>(stream), DistArgs{}, nk, pl));
}

// samebits_dist: f32 distances (out, row stride ldo) of the chunks s64 of
// a and b that this launch reads, with the whole sketch's constants; ani
// 0: 1 - j, 1: ANI.
extern "C" int stpu_samebits_dist(const void* a, long long lda,
                                  const void* b, long long ldb, void* out,
                                  long long ldo, int na, int nb, int s64,
                                  float expected, float maxnbits, float denom,
                                  float inv_k, int ani, void* stream) {
  const DistArgs d{expected, maxnbits, denom, inv_k, ani};
  return static_cast<int>(launch<float, true>(
      static_cast<const u64*>(a), lda, static_cast<const u64*>(b), ldb,
      static_cast<float*>(out), ldo, na, nb, s64, 0, 0,
      static_cast<cudaStream_t>(stream), d));
}

// samebits_finish: the sum of nparts int32 arrays of n entries (parts: a
// host array of device pointers) into out, as int32 (dist 0) or as the f32
// distance of each sum (dist 1; ani 0: 1 - j, 1: ANI) with the whole
// sketch's constants.
extern "C" int stpu_samebits_finish(const void* const* parts, int nparts,
                                    long long n, void* out, int dist,
                                    float expected, float maxnbits,
                                    float denom, float inv_k, int ani,
                                    void* stream) {
  if (nparts < 1 || nparts > MAX_WORDS_SLOTS || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WordsParts pp{};
  for (int q = 0; q < nparts; ++q) pp.p[q] = static_cast<const int*>(parts[q]);
  pp.n = nparts;
  const long long blocks = (n + FIN_NT * FIN_EACH - 1) / (FIN_NT * FIN_EACH);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const DistArgs d{expected, maxnbits, denom, inv_k, ani};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dist) {
    samebits_finish_kernel<true><<<(unsigned)blocks, FIN_NT, 0, st>>>(
        pp, n, out, d);
  } else {
    samebits_finish_kernel<false><<<(unsigned)blocks, FIN_NT, 0, st>>>(
        pp, n, out, d);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* stpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
