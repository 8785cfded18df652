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
// order, so one launch reduces in two stages, with no float atomics:
//
// * Every block: a grid whose size depends on n alone (blocks_for), so one
//   n always reduces in the same order. Each thread walks its share with
//   16-byte float4 loads (neighbouring threads on neighbouring addresses)
//   and keeps five f32 accumulators; the ragged tail (n % 4, or every
//   element when a base pointer is not 16-byte aligned) is masked by global
//   index. The block reduces with warp shuffles, then across its warps in
//   shared memory, and writes one row of partials[blocks][5].
// * The last block: each block draws a ticket from an unsigned-int
//   fetch_add with acquire-release order at device scope (the fence that
//   publishes its row, and for the last block the one that makes every
//   row visible; cheaper than __threadfence's sequentially consistent
//   fence followed by a plain atomicAdd). The block that draws the last
//   ticket reads every row through L2 (__ldcg: its L1 may hold rows of an
//   earlier call), folds them in fixed block order with the same loop and
//   tree as every block's own reduction, writes out[5] and resets the
//   ticket to 0 for the next call. Which block finishes last does not
//   change the order, so the result is bitwise repeatable. The only
//   atomic is that integer ticket: no float atomics.
//
// The partials and the ticket are a persistent workspace that the caller
// keeps per (device, stream): launches on one stream run in order, so no
// two calls share it at once. The count lanes (1-3) are exact integers
// while n < 2^24. expf and log1pf are the accurate library functions (no
// --use_fast_math).
//
// What bounds it on an H100: device memory. It reads 8 bytes per element
// (x and y once each) and does ~20 operations per element, so at the
// training path's 16 x 128 x 128 logits (262,144 elements, 2.1 MB) the
// bound is 0.63 us of bytes at 3.35 TB/s against 0.08 us of f32 arithmetic
// at 67 TFLOP/s. At that size the launch, the first loads' latency and the
// last block's fold (two L2 round trips and a block reduction after the
// slowest block) are most of the time. 512-thread blocks halve the rows
// the fold reads against 256-thread ones.

#include <cuda/atomic>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int LANES = 5;
// One float4 of x and of y per thread per grid sweep; the grid grows with n
// up to MAX_BLOCKS (ops/bce.py sizes the workspace to it), beyond which
// threads stride.
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
bce_sums_kernel(const float* __restrict__ x, const float* __restrict__ y,
                float* partials, unsigned int* ticket, float* __restrict__ out,
                long long n) {
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
  __shared__ bool last;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < LANES; ++k) partials[blockIdx.x * LANES + k] = s.v[k];
    // Release: the row is visible device-wide before the ticket is drawn.
    // Acquire: the last block sees every row drawn before its ticket.
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> tickets(*ticket);
    last = tickets.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
  }
  __syncthreads();  // also: warp 0 is done reading block_reduce's shared sums
  if (!last) return;

  // The last block: every row has landed. Fold them in block order.
#pragma unroll
  for (int k = 0; k < LANES; ++k) s.v[k] = 0.0f;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += THREADS) {
#pragma unroll
    for (int k = 0; k < LANES; ++k) s.v[k] += __ldcg(&partials[b * LANES + k]);
  }
  block_reduce(s);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < LANES; ++k) out[k] = s.v[k];
    *ticket = 0u;  // the next launch on this stream starts after this one ends
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

// Launches the kernel on the given stream, does not synchronise, allocates
// nothing, and returns the launch error (0 = launched). partials holds
// capacity rows of 5 floats and ticket one unsigned int that is 0 between
// calls: the caller's workspace for this stream.
int fc_bce_sums(const void* x, const void* y, void* partials, void* ticket, void* out,
                long long n, int capacity, void* stream) {
  const int blocks = blocks_for(n);
  if (blocks > capacity) return static_cast<int>(cudaErrorInvalidValue);
  bce_sums_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(partials), static_cast<unsigned int*>(ticket),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
