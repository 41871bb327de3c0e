// Pitched device copies for the words axis's set-up shares
// (shard/mesh.py): a words slot's share of an operand held on another GPU
// is rows of contiguous words at one pitch (a range of each sample's and
// k's chunks). One cudaMemcpy2DAsync moves it on a stream of the receiving
// GPU: the copy engines do the work, so the copy runs no kernel on either
// GPU and does not queue behind the source GPU's compute, as a strided
// tensor copy (a copy kernel on the source GPU) does. No TPU kernel is
// replaced: it is the data movement of the JAX package's device_put of a
// sharded array. Bound: the link's bytes.
#include <cuda_runtime.h>

// dst: height rows of width bytes at pitch dpitch on the current device;
// src: the same rows at pitch spitch on device src_device (peer access
// from the current device to it is enabled where the pair allows it, as
// torch does for its peer copies). Enqueued on `stream`.
extern "C" int stpu_copy2d(void* dst, long long dpitch, const void* src,
                           long long spitch, long long width,
                           long long height, int src_device, void* stream) {
  if (width < 0 || height < 0 || dpitch < width || spitch < width) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (width == 0 || height == 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (src_device != dev) {
    int can = 0;
    err = cudaDeviceCanAccessPeer(&can, dev, src_device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (can) {
      err = cudaDeviceEnablePeerAccess(src_device, 0);
      if (err == cudaErrorPeerAccessAlreadyEnabled) {
        (void)cudaGetLastError();  // enabled before: nothing to do
      } else if (err != cudaSuccess) {
        return static_cast<int>(err);
      }
    }
  }
  return static_cast<int>(cudaMemcpy2DAsync(
      dst, static_cast<size_t>(dpitch), src, static_cast<size_t>(spitch),
      static_cast<size_t>(width), static_cast<size_t>(height),
      cudaMemcpyDefault, static_cast<cudaStream_t>(stream)));
}
