// Hand-written Hopper (sm_90a) kernel of the training path: BCE loss and
// segmentation statistics in one pass over the logits and the mask.
//
// It replaces the Pallas kernel _fwd_kernel (via _sums_pallas) of
// fedcrack_tpu/ops/pallas_bce.py. Over flat f32 logits x[n] and mask y[n]
// it computes five f32 sums:
//
//   out[0] = sum bce,  bce = max(x, 0) - x*y + log1p(exp(-|x|))
//   out[1] = sum [(x > 0) == (y > 0.5)]        correct pixels
//   out[2] = sum [(x > 0) && (y > 0.5)]        IoU intersection
//   out[3] = sum [(x > 0) || (y > 0.5)]        IoU union
//   out[4] = sum y * bce                       crack-pixel BCE
//
// Design. The TPU kernel walks row blocks in order on one core and carries
// the sums in one VMEM output block. Here blocks run in parallel and in no
// order, so the reduction has two passes and no atomics:
//
// * Pass 1 (bce_partials_kernel): a grid whose size depends on n alone
//   (fc_bce_sums_blocks), so one n always reduces in the same order. Each
//   thread walks its share with 16-byte float4 loads (neighbouring threads
//   on neighbouring addresses) and keeps five f32 accumulators; the ragged
//   tail (n % 4, or every element when a base pointer is not 16-byte
//   aligned) is masked by global index. The block reduces with warp
//   shuffles, then across its warps in shared memory, and writes one row of
//   partials[blocks][5].
// * Pass 2 (bce_final_kernel): one block sums the partial rows in a fixed
//   order into out[5].
//
// The result is bitwise repeatable run to run; the count lanes (1-3) are
// exact integers while n < 2^24. expf and log1pf are the accurate library
// functions (no --use_fast_math).
//
// What bounds it on an H100: device memory. It reads 8 bytes per element
// (x and y once each) and does ~20 operations per element, so at the
// training path's 16 x 128 x 128 logits (262,144 elements, 2.1 MB) the
// bound is 0.63 us of bytes at 3.35 TB/s against 0.08 us of f32 arithmetic
// at 67 TFLOP/s. At that size the two launches dominate; a larger grid or
// one fused launch is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LANES = 5;
// One float4 of x and of y per thread per pass-1 grid sweep; the grid
// grows with n up to MAX_BLOCKS, beyond which threads stride.
constexpr long long ELEMS_PER_BLOCK = THREADS * 4;
constexpr long long MAX_BLOCKS = 1024;

struct Sums {
  float v[LANES];
};

__device__ __forceinline__ void accumulate(Sums& s, float x, float y) {
  const float bce = fmaxf(x, 0.0f) - x * y + log1pf(expf(-fabsf(x)));
  const bool pred = x > 0.0f;
  const bool tgt = y > 0.5f;
  s.v[0] += bce;
  s.v[1] += (pred == tgt) ? 1.0f : 0.0f;
  s.v[2] += (pred && tgt) ? 1.0f : 0.0f;
  s.v[3] += (pred || tgt) ? 1.0f : 0.0f;
  s.v[4] += y * bce;
}

// Sum of each lane over the block, valid in thread 0. Fixed order: a
// shuffle tree inside each warp, then warp 0 folds the warps' sums.
__device__ __forceinline__ void block_reduce(Sums& s) {
  __shared__ float warp_sums[WARPS][LANES];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < LANES; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      s.v[k] += __shfl_down_sync(0xffffffffu, s.v[k], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < LANES; ++k) warp_sums[warp][k] = s.v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < LANES; ++k) {
      s.v[k] = lane < WARPS ? warp_sums[lane][k] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        s.v[k] += __shfl_down_sync(0xffffffffu, s.v[k], off);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
bce_partials_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    float* __restrict__ partials, long long n) {
  Sums s;
#pragma unroll
  for (int k = 0; k < LANES; ++k) s.v[k] = 0.0f;

  const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  // The same for every thread: a misaligned view takes the scalar path.
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16) == 0 &&
                       (reinterpret_cast<uintptr_t>(y) % 16) == 0;
  const long long n4 = aligned ? n / 4 : 0;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  for (long long i = tid; i < n4; i += stride) {
    const float4 xv = x4[i];
    const float4 yv = y4[i];
    accumulate(s, xv.x, yv.x);
    accumulate(s, xv.y, yv.y);
    accumulate(s, xv.z, yv.z);
    accumulate(s, xv.w, yv.w);
  }
  // Ragged tail, masked by global index.
  for (long long i = 4 * n4 + tid; i < n; i += stride) {
    accumulate(s, x[i], y[i]);
  }

  block_reduce(s);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < LANES; ++k) partials[blockIdx.x * LANES + k] = s.v[k];
  }
}

__global__ void __launch_bounds__(THREADS)
bce_final_kernel(const float* __restrict__ partials, float* __restrict__ out,
                 int blocks) {
  Sums s;
#pragma unroll
  for (int k = 0; k < LANES; ++k) s.v[k] = 0.0f;
  for (int b = threadIdx.x; b < blocks; b += THREADS) {
#pragma unroll
    for (int k = 0; k < LANES; ++k) s.v[k] += partials[b * LANES + k];
  }
  block_reduce(s);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < LANES; ++k) out[k] = s.v[k];
  }
}

int blocks_for(long long n) {
  long long blocks = (n + ELEMS_PER_BLOCK - 1) / ELEMS_PER_BLOCK;
  if (blocks < 1) blocks = 1;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  return static_cast<int>(blocks);
}

}  // namespace

// Plain C interface, loaded with ctypes.
extern "C" {

// Rows of the partials buffer fc_bce_sums needs for n elements (the
// pass-1 grid); the caller allocates partials[blocks * 5] floats.
int fc_bce_sums_blocks(long long n) { return blocks_for(n); }

// Launches both passes on the given stream, does not synchronise,
// allocates nothing, and returns the first launch error (0 = launched).
int fc_bce_sums(const void* x, const void* y, void* partials, void* out,
                long long n, int blocks, void* stream) {
  if (blocks != blocks_for(n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bce_partials_kernel<<<blocks, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(partials), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bce_final_kernel<<<1, THREADS, 0, s>>>(static_cast<const float*>(partials),
                                         static_cast<float*>(out), blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
