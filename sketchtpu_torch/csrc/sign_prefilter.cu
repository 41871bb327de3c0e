// The reads path's sign prefilter: the keep mask of the port of the XLA
// program sketchtpu/sketchcore/sign_prefilter.py::prefilter_signs_device
// (:118), which replaces its segmented min-scans.
//
// Input, for one k and one segment of a read stream (sign_prefilter.py's
// sorted_keys): the signs sorted stably, those of no bin and the invalid
// windows at INT64_MAX after the rest (keys), and each one's stream
// position (pos, the sort's indices). Runs of equal keys hold a sign's
// occurrences in stream order; bin b is the run range of the keys in
// [b * bin_size, (b + 1) * bin_size). Output: flags[p] = 1 (a bool) for
// each kept occurrence (the wrapper zeroes flags). For run r, pmc(r) is
// the position of its min_count-th occurrence (none if the run is
// shorter); the occurrence at p of run r in bin b is kept iff
// min{pmc(r') : r' < r in b} >= p.
//
// Bound: bytes, the sorted keys and positions read once and the flags
// written once, 17 bytes a window (0.085 ms for a 2^24-window segment at
// 3.35 TB/s). Design, simple first:
// - One block per bin finds the bin's span by two binary searches and
//   walks it in tiles of NT x IPT windows, loaded through shared memory
//   (cub::BlockLoad, warp-transposed) into IPT consecutive windows a
//   thread.
// - The state (before, running): running, the min of the pmc values of
//   the runs seen; before, its value where the current run started. A
//   window that starts a run sets before = running; the min_count-th
//   window of a run then adds its position to running. Each window is a
//   map of that state, maps compose associatively (Then), so each thread
//   composes its IPT windows, cub::BlockScan scans the threads' maps
//   (exclusive) and the block carries the state from tile to tile.
// - A window is the min_count-th of its run iff the key min_count - 1
//   windows back is equal and the one before that (or the bin's start) is
//   not: two read-only loads that the tile has just brought into L1.
// - Only the kept windows are written, a byte at their stream position.
#include <climits>

#include <cub/block/block_load.cuh>
#include <cub/block/block_scan.cuh>

namespace {

typedef long long i64;

constexpr int NT = 256;  // threads a block
constexpr int IPT = 8;   // windows a thread and tile
constexpr int TILE = NT * IPT;
constexpr i64 NONE = LLONG_MAX;  // no position, and the key of no bin

// A map of the state: running' = min(running, x);
// before' = f ? min(running, a) : before.
struct Step {
  i64 a, x;
  int f;
};

struct Then {  // s1, then s2
  __device__ __forceinline__ Step operator()(const Step& s1,
                                             const Step& s2) const {
    Step r;
    r.f = s1.f | s2.f;
    r.a = s2.f ? min(s1.x, s2.a) : s1.a;
    r.x = min(s1.x, s2.x);
    return r;
  }
};

__device__ i64 lower_bound(const i64* __restrict__ keys, i64 n, i64 v) {
  i64 lo = 0, hi = n;
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    if (keys[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(NT) sign_prefilter_keep_kernel(
    const i64* __restrict__ keys, const i64* __restrict__ pos, i64 m, int mc,
    i64 bin_size, unsigned char* __restrict__ flags) {
  using Load = cub::BlockLoad<i64, NT, IPT, cub::BLOCK_LOAD_WARP_TRANSPOSE>;
  using Scan = cub::BlockScan<Step, NT>;
  __shared__ union {
    typename Load::TempStorage load;
    typename Scan::TempStorage scan;
  } tmp;
  __shared__ i64 span[2];
  if (threadIdx.x < 2) {
    span[threadIdx.x] =
        lower_bound(keys, m, ((i64)blockIdx.x + threadIdx.x) * bin_size);
  }
  __syncthreads();
  const i64 lo = span[0], hi = span[1];
  i64 before = NONE, running = NONE;  // the same in every thread
  for (i64 t0 = lo; t0 < hi; t0 += TILE) {
    const int n = (int)min((i64)TILE, hi - t0);
    i64 k[IPT], p[IPT], c[IPT];
    Load(tmp.load).Load(keys + t0, k, n, NONE);
    __syncthreads();
    Load(tmp.load).Load(pos + t0, p, n, (i64)0);
    __syncthreads();
    const i64 i0 = t0 + (i64)threadIdx.x * IPT;
    Step mine = {NONE, NONE, 0};
    unsigned starts = 0;  // bit j: window j starts a run
#pragma unroll
    for (int j = 0; j < IPT; ++j) {
      const i64 i = i0 + j;
      c[j] = NONE;
      if (i < hi) {
        const bool start =
            i == lo || k[j] != (j > 0 ? k[j - 1] : __ldg(keys + i - 1));
        const i64 s = i - (mc - 1);  // the run's start if i is its mc-th
        if (s >= lo && __ldg(keys + s) == k[j] &&
            (s == lo || __ldg(keys + s - 1) != k[j])) {
          c[j] = p[j];
        }
        starts |= (unsigned)start << j;
        mine = Then()(mine, Step{NONE, c[j], (int)start});
      }
    }
    Step prefix, tile;
    Scan(tmp.scan).ExclusiveScan(mine, prefix, Step{NONE, NONE, 0}, Then(),
                                 tile);
    i64 bf = prefix.f ? min(running, prefix.a) : before;
    i64 rn = min(running, prefix.x);
#pragma unroll
    for (int j = 0; j < IPT; ++j) {
      if (i0 + j < hi) {
        if (starts >> j & 1u) bf = rn;
        rn = min(rn, c[j]);
        if (bf >= p[j]) flags[p[j]] = 1;
      }
    }
    before = tile.f ? min(running, tile.a) : before;
    running = min(running, tile.x);
    __syncthreads();  // tmp is loaded again
  }
}

}  // namespace

extern "C" int stpu_sign_prefilter_keep(const void* keys, const void* pos,
                                        long long m, int min_count,
                                        long long bin_size, int nbins,
                                        void* flags, void* stream) {
  if (m < 1 || min_count < 1 || bin_size < 1 || nbins < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sign_prefilter_keep_kernel<<<nbins, NT, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const i64*>(keys), static_cast<const i64*>(pos), m,
      min_count, bin_size, static_cast<unsigned char*>(flags));
  return static_cast<int>(cudaGetLastError());
}
