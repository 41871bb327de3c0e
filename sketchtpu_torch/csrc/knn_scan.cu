// K3: the kNN scan tile, the port of sketchtpu/dist/pallas_kernels.py
// samebits_pallas_chunked (kernel _samebits_chunked_kernel) fused with the
// key epilogue that the JAX scans run in XLA around it
// (dist/knn_jax.py _knn_scan_block_packed and _knn_scan_block_comp).
//
// For rows [0, tr) of `a` (global row ids row0 + i) and columns [0, tc) of
// `b` (global column ids col0 + j), the exact samebits of each pair becomes
// one selection key, written to out[i][j]:
// - plain mode: sb << shift | (colmask - col), as int32 (shift from
//   _pack_shift, colmask = 2^shift - 1) or int64 (shift 32);
// - completeness mode (c1 != null): the corrected f32 Jaccard, computed
//   with the JAX expression's operations in its order,
//     max(sb - expected, 0) * maxnbits / (maxnbits - expected) / maxnbits,
//   then j / (prod / (c1 + c2 - prod)) clamped at 1 where c1*c2 >= cutoff,
//   as int64 (order-preserving int32 of its bits) << 32 | (colmask - col).
// Pairs whose column is >= nb_real (j >= ncols) or, with exclude_self,
// equals the row get -1, below every valid key (valid keys are >= 0).
// Since every key holds its column, keys are unique and a top-k over them
// orders value descending, then column ascending, whatever the sort's ties.
//
// Bound: integer ALU, as K1 (this is K1's pair tile and staging); the
// epilogue adds a few ops and one 4- or 8-byte store per pair.
#include "tile.cuh"

using namespace stpu;

namespace {

constexpr int TX = 16, TY = 16;  // threads
constexpr int RM = 4, RN = 4;    // pairs per thread
constexpr int TI = TY * RM, TJ = TX * RN, NT = TX * TY;
constexpr int LDS_A = TI + 1, LDS_B = TJ + 1;

__device__ __forceinline__ int ordered_bits(float v) {
  const int b = __float_as_int(v);
  return b < 0 ? b ^ 0x7FFFFFFF : b;
}

template <typename KeyT, bool COMP>
__global__ void __launch_bounds__(NT)
    knn_keys_kernel(const u64* __restrict__ a, long long lda,
                    const u64* __restrict__ b, long long ldb,
                    KeyT* __restrict__ out, long long ldo, int tr, int tc,
                    int ncols, int s64, long long row0, long long col0,
                    int exclude_self, int shift, long long colmask,
                    const float* __restrict__ c1,
                    const float* __restrict__ c2, float cutoff,
                    float expected, float maxnbits, float denom) {
  __shared__ u64 sa[BBITS][LDS_A];
  __shared__ u64 sb[BBITS][LDS_B];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int i0 = blockIdx.y * TI, j0 = blockIdx.x * TJ;

  int cnt[RM][RN] = {};
  if (j0 < ncols) {  // a tile wholly past nb_real holds invalid keys only
    for (int c = 0; c < s64; ++c) {
      stage_chunk<TI, LDS_A>(sa, a, lda, (long long)c * BBITS, i0, tr);
      stage_chunk<TJ, LDS_B>(sb, b, ldb, (long long)c * BBITS, j0, ncols);
      __syncthreads();
      samebits_chunk<RM, RN, TY, TX, LDS_A, LDS_B>(cnt, sa, sb, ty, tx);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gi = i0 + ty + i * TY;
    if (gi >= tr) continue;
    const long long row = row0 + gi;
    float c1v = 1.f;
    if (COMP) c1v = c1[gi];
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int gj = j0 + tx + j * TX;
      if (gj >= tc) continue;
      const long long col = col0 + gj;
      KeyT key = -1;
      if (gj < ncols && !(exclude_self && col == row)) {
        if (COMP) {
          const float diff = fmaxf((float)cnt[i][j] - expected, 0.f);
          float jac = (diff * maxnbits / denom) / maxnbits;
          const float c2v = c2[gj];
          const float prod = c1v * c2v;
          const float factor = prod / (c1v + c2v - prod);
          if (prod >= cutoff) {
            const float q = jac / factor;
            jac = q > 1.f ? 1.f : q;  // NaN-propagating min, as jnp.minimum
          }
          const unsigned long long hi =
              (unsigned long long)(long long)ordered_bits(jac) << 32;
          key = (KeyT)(hi | (unsigned long long)(colmask - col));
        } else {
          key = ((KeyT)cnt[i][j] << shift) | (KeyT)(colmask - col);
        }
      }
      out[(long long)gi * ldo + gj] = key;
    }
  }
}

template <typename KeyT, bool COMP>
void launch(const void* a, long long lda, const void* b, long long ldb,
            void* out, long long ldo, int tr, int tc, int ncols, int s64,
            long long row0, long long col0, int exclude_self, int shift,
            long long colmask, const void* c1, const void* c2, float cutoff,
            float expected, float maxnbits, float denom, cudaStream_t st) {
  const dim3 grid((tc + TJ - 1) / TJ, (tr + TI - 1) / TI);
  knn_keys_kernel<KeyT, COMP><<<grid, NT, 0, st>>>(
      static_cast<const u64*>(a), lda, static_cast<const u64*>(b), ldb,
      static_cast<KeyT*>(out), ldo, tr, tc, ncols, s64, row0, col0,
      exclude_self, shift, colmask, static_cast<const float*>(c1),
      static_cast<const float*>(c2), cutoff, expected, maxnbits, denom);
}

}  // namespace

// key_bytes 4: int32 plain keys; 8: int64 keys, completeness mode when c1
// is not null. c1 (tr) and c2 (tc) are the rows' and columns' completeness.
extern "C" int stpu_knn_keys(const void* a, long long lda, const void* b,
                             long long ldb, void* out, long long ldo, int tr,
                             int tc, int ncols, int s64, long long row0,
                             long long col0, int exclude_self, int shift,
                             long long colmask, int key_bytes, const void* c1,
                             const void* c2, float cutoff, float expected,
                             float maxnbits, float denom, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (key_bytes == 4 && c1 == nullptr) {
    launch<int, false>(a, lda, b, ldb, out, ldo, tr, tc, ncols, s64, row0,
                       col0, exclude_self, shift, colmask, c1, c2, cutoff,
                       expected, maxnbits, denom, st);
  } else if (key_bytes == 8 && c1 == nullptr) {
    launch<long long, false>(a, lda, b, ldb, out, ldo, tr, tc, ncols, s64,
                             row0, col0, exclude_self, shift, colmask, c1, c2,
                             cutoff, expected, maxnbits, denom, st);
  } else if (key_bytes == 8) {
    launch<long long, true>(a, lda, b, ldb, out, ldo, tr, tc, ncols, s64,
                            row0, col0, exclude_self, shift, colmask, c1, c2,
                            cutoff, expected, maxnbits, denom, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
