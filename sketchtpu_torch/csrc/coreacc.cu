// K2: fused multi-k core/accessory distances, the port of
// sketchtpu/dist/coreacc_pallas.py coreacc_pallas (kernel _coreacc_kernel).
//
// Per pair, for each k in ascending order: samebits -> bias-corrected
// Jaccard j -> optional completeness correction -> y = ln j -> the early
// break (a k counts only while every y so far is >= tolerance) -> running
// regression sums. Then the closed-form least squares gives beta and alpha,
// and core/acc follow the branches of coreacc_jax.coreacc_tile exactly.
// The sums use x = k - kc (kc: the middle k, so x is a small exact
// integer): in f32, sum(k*y) - sum(k)*sum(y)/n cancels two numbers of
// order 1e2 and costs the accessory distance up to ~2e-5 against the f64
// chain; centred, the same slope and intercept stay within ~1e-6.
//
// Bound: integer ALU, as K1, times nk; the float chain is a few dozen
// flops per pair and k. Design: a 32 x 64 pair tile per 256-thread block,
// 2 x 4 pairs per thread. The chain consumes each k's samebits as soon as
// its chunks are summed, so only four running values per pair stay live
// (the included-k count and the y, k*y and y*y sums; the k and k*k sums
// follow from the count), for any nk.
#include <math.h>

#include "tile.cuh"

using namespace stpu;

namespace {

constexpr int TX = 16, TY = 16;
constexpr int RM = 2, RN = 4;
constexpr int TI = TY * RM, TJ = TX * RN, NT = TX * TY;
constexpr int LDS_A = TI + 1, LDS_B = TJ + 1;

__global__ void __launch_bounds__(NT)
    coreacc_kernel(const u64* __restrict__ a, long long lda,
                   const u64* __restrict__ b, long long ldb,
                   long long kstride, int na, int nb, int s64, int nk,
                   const float* __restrict__ kf, float kc,
                   const float* __restrict__ c1,
                   const float* __restrict__ c2, float cutoff, float expected,
                   float maxnbits, float denom, float tolerance,
                   float* __restrict__ core, float* __restrict__ acc,
                   long long ldo, int tri, long long row0) {
  __shared__ u64 sa[BBITS][LDS_A];
  __shared__ u64 sb[BBITS][LDS_B];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int i0 = blockIdx.y * TI, j0 = blockIdx.x * TJ;

  if (tri && tile_below_diagonal(i0, j0, TJ, nb, row0)) {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int gi = i0 + ty + i * TY;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int gj = j0 + tx + j * TX;
        if (gi < na && gj < nb) {
          core[(long long)gi * ldo + gj] = 0.f;
          acc[(long long)gi * ldo + gj] = 0.f;
        }
      }
    }
    return;
  }

  const bool comp = c1 != nullptr;
  float c1v[RM], c2v[RN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gi = i0 + ty + i * TY;
    c1v[i] = comp && gi < na ? c1[gi] : 1.f;
  }
#pragma unroll
  for (int j = 0; j < RN; ++j) {
    const int gj = j0 + tx + j * TX;
    c2v[j] = comp && gj < nb ? c2[gj] : 1.f;
  }

  int ninc[RM][RN] = {};
  float ysum[RM][RN] = {}, xysum[RM][RN] = {}, ysq[RM][RN] = {};
  for (int ki = 0; ki < nk; ++ki) {
    int cnt[RM][RN] = {};
    for (int c = 0; c < s64; ++c) {
      const long long off = (long long)ki * kstride + (long long)c * BBITS;
      stage_chunk<TI, LDS_A>(sa, a, lda, off, i0, na);
      stage_chunk<TJ, LDS_B>(sb, b, ldb, off, j0, nb);
      __syncthreads();
      samebits_chunk<RM, RN, TY, TX, LDS_A, LDS_B>(cnt, sa, sb, ty, tx);
      __syncthreads();
    }
    const float kv = kf[ki];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float diff = fmaxf((float)cnt[i][j] - expected, 0.f);
        float jac = (diff * maxnbits / denom) / maxnbits;
        if (comp) {
          const float prod = c1v[i] * c2v[j];
          const float factor = prod / (c1v[i] + c2v[j] - prod);
          if (prod >= cutoff) {
            const float q = jac / factor;
            jac = q > 1.f ? 1.f : q;  // NaN-propagating min, as jnp.minimum
          }
        }
        const float y = logf(jac);
        if (ninc[i][j] == ki && y >= tolerance) {
          ninc[i][j] += 1;
          ysum[i][j] += y;
          xysum[i][j] += kv * y;
          ysq[i][j] += y * y;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gi = i0 + ty + i * TY;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int gj = j0 + tx + j * TX;
      if (gi >= na || gj >= nb) continue;
      float xsum = 0.f, xsq = 0.f;  // of the centred x over included k
      for (int q = 0; q < ninc[i][j]; ++q) {
        xsum += kf[q];
        xsq += kf[q] * kf[q];
      }
      const float n = (float)ninc[i][j];
      const float xbar = xsum / n + kc;
      const float ybar = ysum[i][j] / n;
      const float x_diff = xsq - xsum * xsum / n;
      const float y_diff = ysq[i][j] - ysum[i][j] * ysum[i][j] / n;
      const float beta = (xysum[i][j] - xsum * ysum[i][j] / n) / x_diff;
      const float alpha = -beta * xbar + ybar;
      float cd = beta < 0.f ? 1.f - expf(beta) : (beta > 0.f ? 1.f : 0.f);
      float ad = alpha < 0.f ? 1.f - expf(alpha) : 0.f;
      if (y_diff <= 0.f) cd = ad = 0.f;
      const float ys = ysum[i][j];
      if (isnan(ys) || (isinf(ys) && ys < 0.f) || n < 3.f) cd = ad = 1.f;
      core[(long long)gi * ldo + gj] = cd;
      acc[(long long)gi * ldo + gj] = ad;
    }
  }
}

}  // namespace

extern "C" int stpu_coreacc(const void* a, long long lda, const void* b,
                            long long ldb, long long kstride, int na, int nb,
                            int s64, int nk, const void* kf, float kc,
                            const void* c1,
                            const void* c2, float cutoff, float expected,
                            float maxnbits, float denom, float tolerance,
                            void* core, void* acc, long long ldo, int tri,
                            long long row0, void* stream) {
  const dim3 grid((nb + TJ - 1) / TJ, (na + TI - 1) / TI);
  coreacc_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(a), lda, static_cast<const u64*>(b), ldb,
      kstride, na, nb, s64, nk, static_cast<const float*>(kf), kc,
      static_cast<const float*>(c1), static_cast<const float*>(c2), cutoff,
      expected, maxnbits, denom, tolerance, static_cast<float*>(core),
      static_cast<float*>(acc), ldo, tri, row0);
  return static_cast<int>(cudaGetLastError());
}
