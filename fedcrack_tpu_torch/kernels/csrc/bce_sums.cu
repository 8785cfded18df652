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
// What bounds it on an H100: device memory. It reads 8 bytes per element
// (x and y once each) and does ~20 operations per element, so at the
// training path's 16 x 128 x 128 logits (262,144 elements, 2.1 MB) the
// bound is 0.63 us of bytes at 3.35 TB/s against 0.08 us of f32 arithmetic
// at 67 TFLOP/s. At that size the launch, the first loads' latency and the
// fold across blocks after the slowest block are most of the time. The TPU
// kernel walks row blocks in order on one core and carries the sums in one
// VMEM block; here blocks run in parallel and in no order, and there are
// no float atomics.
//
// The launch plan (ops/bce.py::bce_plan, a function of n alone, checked
// again by plan_ok below) gives the grid, at most one wave of blocks, and
// the stages of STAGE_ELEMS elements each block reduces. Block b reduces
// the contiguous share [b * stages * STAGE_ELEMS, ...) of the input; in
// stage s of it thread t holds the four elements at 4t .. 4t + 3, so one n
// always reduces in the same order, and the result is bitwise repeatable.
//
// * Loads: each thread reads its float4s of x and y directly, two stages
//   in flight. A misaligned view, and the grid's last n % 4 elements, are
//   read one element at a time.
// * The count lanes are integers: (x > 0), (y > 0.5) and both, counted
//   exactly in any order for n < 2^31; out[1..3] come from them and n. The
//   two BCE lanes are f32 in a fixed order: each thread's elements in
//   order, a shuffle tree in each warp, the same tree over the warps' rows
//   and over the workspace's rows (lane l adding rows l, l + 32, ... in
//   order first).
// * The fold: each block writes its row to a per-stream workspace and
//   draws a ticket from an unsigned-int fetch_add with acquire-release
//   order at device scope; the block that draws the last ticket reads
//   every row through L2 with one warp and writes out[5], then resets the
//   ticket for the next call. A grid of one block writes out[5] itself.
//   Thread block clusters folding through distributed shared memory, and
//   1-D bulk copies (TMA) for the loads, were timed slower than this at
//   the main path's sizes (PERF.md).
//
// expf and log1pf are the accurate library functions (no --use_fast_math).

#include <cuda/atomic>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int STAGE_ELEMS = 4 * THREADS;  // one float4 of x and of y a thread
constexpr int DIRECT_DEPTH = 2;   // stages a thread has in flight
constexpr int MAX_GRID = 132;     // one wave on an H100 SXM's SMs; rows of the workspace
constexpr long long MAX_N = (1LL << 31) - 1;

// One block's or grid's sums; the workspace holds one a block.
struct Row {
  float bce;
  float pos;
  int pred;  // x > 0
  int tgt;   // y > 0.5
  int both;
};

__device__ __forceinline__ void add(Row& a, const Row& b) {
  a.bce += b.bce;
  a.pos += b.pos;
  a.pred += b.pred;
  a.tgt += b.tgt;
  a.both += b.both;
}

// What this file launches; ops/bce.py::check_bce_plan says the same.
bool plan_ok(long long n, int blocks, int stages) {
  if (n < 0 || n > MAX_N) return false;
  if (blocks < 1 || blocks > MAX_GRID || stages < 1) return false;
  return static_cast<long long>(blocks) * stages * STAGE_ELEMS >= n;
}

__device__ __forceinline__ void write_out(float* out, const Row& r, long long n) {
  const long long pred = r.pred, tgt = r.tgt, both = r.both;
  out[0] = r.bce;
  out[1] = static_cast<float>(n - pred - tgt + 2 * both);
  out[2] = static_cast<float>(both);
  out[3] = static_cast<float>(pred + tgt - both);
  out[4] = r.pos;
}

// The five sums of four elements into r; MASKED skips those at or past end.
template <bool MASKED>
__device__ __forceinline__ void accumulate(Row& r, const float4& x4, const float4& y4, long long e, long long end) {
  const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
  const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (MASKED && e + j >= end) continue;
    const float bce = fmaxf(xv[j], 0.0f) - xv[j] * yv[j] + log1pf(expf(-fabsf(xv[j])));
    const bool pred = xv[j] > 0.0f;
    const bool tgt = yv[j] > 0.5f;
    r.bce += bce;
    r.pos += yv[j] * bce;
    r.pred += pred;
    r.tgt += tgt;
    r.both += pred && tgt;
  }
}

// The four elements from e on, each read alone; zeros at or past end.
__device__ __forceinline__ float4 load_scalar(const float* __restrict__ p, long long e, long long end) {
  return make_float4(e < end ? p[e] : 0.0f, e + 1 < end ? p[e + 1] : 0.0f, e + 2 < end ? p[e + 2] : 0.0f,
                     e + 3 < end ? p[e + 3] : 0.0f);
}

// Lane 0 gets the sum of the warp's 32 rows by a shuffle tree (lane l
// takes lane l + off, off = 16, 8, 4, 2, 1).
__device__ __forceinline__ Row warp_fold(Row r) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    r.bce += __shfl_down_sync(0xffffffffu, r.bce, off);
    r.pos += __shfl_down_sync(0xffffffffu, r.pos, off);
    r.pred += __shfl_down_sync(0xffffffffu, r.pred, off);
    r.tgt += __shfl_down_sync(0xffffffffu, r.tgt, off);
    r.both += __shfl_down_sync(0xffffffffu, r.both, off);
  }
  return r;
}

__global__ void __launch_bounds__(THREADS, 2)
bce_sums_kernel(const float* __restrict__ x, const float* __restrict__ y, long long n, int stages, int aligned,
                Row* partials, unsigned int* ticket, float* __restrict__ out) {
  __shared__ Row warp_rows[WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long share = static_cast<long long>(stages) * STAGE_ELEMS;
  const long long begin = static_cast<long long>(blockIdx.x) * share;
  const long long end = begin + share < n ? begin + share : n;
  const int filled = begin < end ? static_cast<int>((end - begin + STAGE_ELEMS - 1) / STAGE_ELEMS) : 0;
  // Stage i of the share starts at first_of(i); it is whole unless it is
  // the grid's last, and a whole stage of aligned inputs is read a float4
  // at a time.
  auto first_of = [&](int i) { return begin + static_cast<long long>(i) * STAGE_ELEMS; };
  auto whole = [&](int i) { return aligned && first_of(i) + STAGE_ELEMS <= end; };

  Row r = {0.0f, 0.0f, 0, 0, 0};
  for (int i0 = 0; i0 < filled; i0 += DIRECT_DEPTH) {
    float4 a[DIRECT_DEPTH], b[DIRECT_DEPTH];
#pragma unroll
    for (int d = 0; d < DIRECT_DEPTH; ++d) {
      const long long e = first_of(i0 + d) + 4 * tid;
      const bool vec = i0 + d < filled && whole(i0 + d);
      a[d] = vec ? *reinterpret_cast<const float4*>(x + e) : load_scalar(x, e, end);
      b[d] = vec ? *reinterpret_cast<const float4*>(y + e) : load_scalar(y, e, end);
    }
#pragma unroll
    for (int d = 0; d < DIRECT_DEPTH; ++d) {
      if (i0 + d >= filled) break;
      if (whole(i0 + d)) {
        accumulate<false>(r, a[d], b[d], 0, 0);
      } else {
        accumulate<true>(r, a[d], b[d], first_of(i0 + d) + 4 * tid, end);
      }
    }
  }

  // The block: a shuffle tree in each warp, then warp 0 folds the warps'
  // rows by the same tree.
  r = warp_fold(r);
  if (lane == 0) warp_rows[tid / 32] = r;
  __syncthreads();
  if (tid >= 32) return;
  const Row zero = {0.0f, 0.0f, 0, 0, 0};
  r = warp_fold(lane < WARPS ? warp_rows[lane] : zero);

  if (gridDim.x == 1) {
    if (lane == 0) write_out(out, r, n);
    return;
  }
  // Across blocks: the last to draw a ticket folds every block's row.
  unsigned int drawn = 0;
  if (lane == 0) {
    partials[blockIdx.x] = r;
    // Release: the row is visible device-wide before the ticket is drawn.
    // Acquire: the last block sees every row drawn before its ticket.
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> tickets(*ticket);
    drawn = tickets.fetch_add(1u, cuda::memory_order_acq_rel);
  }
  if (__shfl_sync(0xffffffffu, drawn, 0) != gridDim.x - 1) return;
  __syncwarp();  // orders lane 0's acquire before the other lanes' reads
  // Through L2 (this SM's L1 may hold rows of an earlier call): lane l
  // adds the rows l, l + 32, ... in order, then the tree.
  r = zero;
  for (int c = lane; c < static_cast<int>(gridDim.x); c += 32) {
    const Row* p = partials + c;
    add(r, Row{__ldcg(&p->bce), __ldcg(&p->pos), __ldcg(&p->pred), __ldcg(&p->tgt), __ldcg(&p->both)});
  }
  r = warp_fold(r);
  if (lane == 0) {
    write_out(out, r, n);
    *ticket = 0u;  // the next launch on this stream starts after this one ends
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.
extern "C" {

// Launches the kernel on the given stream, does not synchronise, allocates
// nothing, and returns the launch error (0 = launched), or refuses a plan
// (blocks and stages from ops/bce.py::bce_plan) that plan_ok does not
// take. partials holds MAX_GRID rows of five 32-bit words and ticket one
// unsigned int that is 0 between calls: the caller's workspace for this
// stream, touched only by a grid of several blocks.
int fc_bce_sums(const void* x, const void* y, void* partials, void* ticket, void* out, long long n, int blocks,
                int stages, void* stream) {
  if (!plan_ok(n, blocks, stages)) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 1 && (partials == nullptr || ticket == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const int aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  bce_sums_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), n, stages, aligned, static_cast<Row*>(partials),
      static_cast<unsigned int*>(ticket), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
