// Hand-written Hopper (sm_90a) kernel of the quantized serving path's
// depthwise 3x3 conv, with the expansion of its codes folded in.
//
// dequant_dwconv3x3_kernel <- the Pallas _dequant_kernel of
// fedcrack_tpu/kernels/dequant.py (float(q) * scale, which here runs in the
// kernel's prologue, into registers) together with the depthwise conv that
// the JAX _sepconv (fedcrack_tpu/kernels/forward.py) leaves to XLA, and the
// ReLU before it:
// y[N,H,W,C] = depthwise_conv3x3_SAME_stride1(relu(x[N,H,W,C] f32 NHWC),
// float(q[3,3,1,C] HWIO codes) * scale[C]), with int8 or fp8 e4m3 codes.
// The 6 depthwise stages of the fused U-Net forward (kernels/forward.py)
// land here, one launch each: no expanded weights, no ReLU'd copy and no
// padded copy of the activation exist in device memory.
//
// Contract: bitwise equal to _dequant_dwconv3x3_plain (dequant.py). A tap
// is one f32 multiply, code_to_float(q) * scale[c] (_dequant_codes_plain's
// rounding); an input is v < 0 ? 0 : v (-0.0 and NaN pass); the nine taps
// are summed in (dy, dx) row-major order, acc = v00 * w00, then
// acc = acc + v * w, each multiply and add rounded on its own (no FMA);
// a tap that falls outside the image reads 0. An output depends on its
// 3 x 3 window and nothing else: not on the tile, the grid or the batch.
//
// What bounds it on an H100: bytes. At bucket 256 x batch 8 the six stages
// hold 22,020,096 activations; read once and written once in f32 that is
// 176 MB, 0.0526 ms at 3.35 TB/s, against 9 multiplies and 8 adds an
// output (~11 us of f32 issue on 132 SMs). So the design streams, and
// keeps the instructions an output costs low enough to stay under the
// bytes:
//
// * A unit of work is TH x TW output pixels of one image and UC channels
//   (32, or 64 where C is a multiple of 64: then a box row is a whole
//   pixel). A persistent grid of at most 132 blocks walks the units,
//   channel block by channel block (dequant.py's dwconv_unit_origin). One
//   producer warp keeps a ring of stages in flight on mbarriers: per unit
//   one TMA load (cp.async.bulk.tensor.4d) brings the (TH + 2) x (TW + 2)
//   x UC halo box at (c0, w0 - 1, h0 - 1, n) of a 4-D tiled map over NHWC
//   into shared memory, unswizzled. TMA zero-fills what lies outside the
//   image (and past C): that fill is the SAME padding. Where C % 4 != 0 or
//   x is not 16-byte aligned TMA has no map (its row strides must be
//   multiples of 16 bytes), and the producer warp loads the same box
//   itself, zero-filled by hand.
// * Eight consumer warps, in UC / 32 groups of 32 channels. Lane l owns
//   one channel of its group, so a warp's 32 lanes read one 128-byte run
//   of shared memory: no bank conflicts. Its nine taps are expanded in
//   registers when the block's channel block changes (the prologue of its
//   first unit there). Each thread walks COLS = 4 neighbouring columns of
//   the tile down with a window of three halo rows: 6 shared-memory loads
//   and 6 ReLUs a row give 4 outputs. A strip wholly inside the image and
//   C stores unmasked. Every store is one coalesced 128-byte row a warp.
// * The plan (dequant.py, dwconv_tile_plan) takes TH = 16 where that still
//   gives three quarters of the SMs a unit and 8 rows would not give each
//   SM three, else 8, and as many stages (up to 4) as fit a block's 227 KB.
//   Timed against each other as edited copies on an H100: 8 warps of 4
//   columns beat 16 of 2 and 16 of 1, and the unmasked walk beat the
//   masked one at every stage of the forward; larger tiles beat more units
//   a block; channel-minor unit order, an L2 prefetch of the next unit and
//   other L2 promotions did not help.
//
// Why one launch per layer: the stage's input is the output of the BN
// before it, and its output feeds the pointwise GEMM after it
// (dequant_matmul), so a layer's launch is the only place the ReLU, the
// padding and the expansion can go without a pass of their own.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime, no -lcuda
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cstring>

#include "dequant_common.cuh"

namespace {

using fc::code_to_float;
using fc::mbar_arrive;
using fc::mbar_arrive_expect_tx;
using fc::mbar_init;
using fc::mbar_wait;
using fc::smem_u32;

constexpr int CHUNK = 32;               // channels of a warp: a lane each, 128 bytes of f32 a pixel
constexpr int CONSUMER_WARPS = 8;
constexpr int COLS = 4;                 // tile columns a consumer thread walks down together
constexpr int SPAN = CONSUMER_WARPS * COLS;  // TW x UC / CHUNK: one strip a consumer warp a unit
constexpr int THREADS = (CONSUMER_WARPS + 1) * 32;
constexpr int STAGE_ALIGN = 128;        // TMA's shared-memory destination
constexpr int MAX_STAGES = 4;
constexpr int MAX_BLOCKS = 132;         // one block an SM of an H100 SXM
constexpr int SMEM_LIMIT = 232448;      // dynamic shared memory a block may have on sm_90

// Mirrored by dequant.py's dwconv_smem_bytes. Per stage a halo tile of UC
// channels a pixel (a multiple of 128 bytes), a full and an empty barrier;
// the slack that aligns the dynamic shared memory's base to STAGE_ALIGN.
__host__ __device__ constexpr int halo_bytes(int th, int tw, int uc) { return (th + 2) * (tw + 2) * uc * 4; }
__host__ __device__ constexpr int dw_smem(int th, int tw, int uc, int stages) {
  return stages * (halo_bytes(th, tw, uc) + 16) + STAGE_ALIGN;
}

// Unit u is channel block u / tiles (UC channels) and pixel tile u % tiles
// of the images in order, tiles row-major within an image (dequant.py's
// dwconv_unit_origin).
struct Unit {
  int img, h0, w0, c0;
};

__device__ __forceinline__ Unit unit_origin(int u, int H, int W, int N, int TH, int TW, int UC) {
  const int tiles_w = (W + TW - 1) / TW;
  const int per_image = tiles_w * ((H + TH - 1) / TH);
  const int tiles = per_image * N;
  const int block = u / tiles;
  const int tile = u - block * tiles;
  const int img = tile / per_image;
  const int t = tile - img * per_image;
  return {img, t / tiles_w * TH, t % tiles_w * TW, block * UC};
}

__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

// One output: the nine taps of the window (rows a, b, c; columns 0, 1, 2)
// in (dy, dx) row-major order, every product and sum rounded on its own.
__device__ __forceinline__ float window_sum(const float (&w)[9], float a0, float a1, float a2, float b0,
                                            float b1, float b2, float c0, float c1, float c2) {
  float acc = __fmul_rn(a0, w[0]);
  acc = __fadd_rn(acc, __fmul_rn(a1, w[1]));
  acc = __fadd_rn(acc, __fmul_rn(a2, w[2]));
  acc = __fadd_rn(acc, __fmul_rn(b0, w[3]));
  acc = __fadd_rn(acc, __fmul_rn(b1, w[4]));
  acc = __fadd_rn(acc, __fmul_rn(b2, w[5]));
  acc = __fadd_rn(acc, __fmul_rn(c0, w[6]));
  acc = __fadd_rn(acc, __fmul_rn(c1, w[7]));
  return __fadd_rn(acc, __fmul_rn(c2, w[8]));
}

// One consumer thread's strip of a unit: columns 0 .. COLS - 1 from src
// (its halo columns 0 .. COLS + 1, a halo row `stride` floats apart, a
// pixel UC floats apart), walked down with a window of three halo rows.
// FULL: every output of the strip lies inside the image and C, so no
// store is masked; else rows (0 past C) and cols bound them.
template <int TH, bool FULL>
__device__ __forceinline__ void walk(const float (&taps)[9], const float* src, int stride, int UC, float* out,
                                     long long row_step, int C, int rows, int cols) {
  float win[3][COLS + 2];
#pragma unroll
  for (int j = 0; j < COLS + 2; ++j) {
    win[0][j] = relu(src[j * UC]);
    win[1][j] = relu(src[stride + j * UC]);
  }
#pragma unroll
  for (int r = 0; r < TH; ++r) {
#pragma unroll
    for (int j = 0; j < COLS + 2; ++j) win[2][j] = relu(src[(r + 2) * stride + j * UC]);
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const float v = window_sum(taps, win[0][k], win[0][k + 1], win[0][k + 2], win[1][k], win[1][k + 1],
                                 win[1][k + 2], win[2][k], win[2][k + 1], win[2][k + 2]);
      if (FULL || (r < rows && k < cols)) out[r * row_step + k * C] = v;
    }
#pragma unroll
    for (int j = 0; j < COLS + 2; ++j) {
      win[0][j] = win[1][j];
      win[1][j] = win[2][j];
    }
  }
}

// Warps 0 .. CONSUMER_WARPS - 1 compute, the last warp produces. A unit's
// UC channels split the consumer warps into UC / 32 groups of 32 channels;
// the warps of a group take COLS columns each, so TW x UC / 32 = SPAN. TH
// is a template argument so a column's walk unrolls; TW and UC are not.
template <typename CodeT, int TH>
__global__ void __launch_bounds__(THREADS, 1)
dequant_dwconv3x3_kernel(const __grid_constant__ CUtensorMap x_map, const float* __restrict__ x,
                         const CodeT* __restrict__ q, const float* __restrict__ scale, float* __restrict__ y,
                         int N, int H, int W, int C, int TW, int UC, int stages, int tma) {
  const int halo_w = TW + 2;
  const int halo_pixels = (TH + 2) * halo_w;
  const int halo = halo_bytes(TH, TW, UC);

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + STAGE_ALIGN - 1) & ~static_cast<uint32_t>(STAGE_ALIGN - 1);
  unsigned char* smem = smem_raw + (base - raw);
  // [stages] halo tiles, [stages] full barriers, [stages] empty barriers.
  const uint32_t full0 = base + stages * halo;
  const uint32_t empty0 = full0 + 8 * stages;

  const int units = N * ((H + TH - 1) / TH) * ((W + TW - 1) / TW) * ((C + UC - 1) / UC);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 32);  // the producer warp's lanes (lane 0's with the TMA bytes)
      mbar_init(empty0 + 8 * s, CONSUMER_WARPS * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // ---- producer warp: one halo box a unit ----
    int it = 0;  // units filled so far: stage it % stages, pass it / stages
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++it) {
      const Unit un = unit_origin(u, H, W, N, TH, TW, UC);
      const int s = it % stages;
      const uint32_t full = full0 + 8 * s;
      mbar_wait(empty0 + 8 * s, ((it / stages) & 1) ^ 1);  // the first pass finds it free
      if (tma) {
        if (lane == 0) {
          mbar_arrive_expect_tx(full, halo);
          fc::tma_load_4d(base + s * halo, &x_map, full, un.c0, un.w0 - 1, un.h0 - 1, un.img);
        } else {
          mbar_arrive(full);
        }
      } else {
        // The same box by hand: lane l loads channels c0 + l, c0 + l + 32,
        // ... of every halo pixel, zero outside the image and past C.
        float* tile = reinterpret_cast<float*>(smem + s * halo);
        for (int p = 0; p < halo_pixels; ++p) {
          const int h = un.h0 - 1 + p / halo_w;
          const int w = un.w0 - 1 + p % halo_w;
          const bool inside = h >= 0 && h < H && w >= 0 && w < W;
          for (int k = lane; k < UC; k += 32) {
            const int c = un.c0 + k;
            tile[p * UC + k] = inside && c < C
                                   ? __ldg(x + ((static_cast<long long>(un.img) * H + h) * W + w) * C + c)
                                   : 0.0f;
          }
        }
        mbar_arrive(full);
      }
    }
    return;
  }

  // ---- consumer warps ----
  // This warp's group of 32 channels within a unit, and its strip of COLS
  // columns within the group's TW.
  const int group_warps = CONSUMER_WARPS * CHUNK / UC;
  const int group = warp / group_warps;
  const int col = warp % group_warps * COLS;
  float taps[9];
  int taps_c0 = -1;
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++it) {
    const Unit un = unit_origin(u, H, W, N, TH, TW, UC);
    const int c = un.c0 + group * CHUNK + lane;
    if (un.c0 != taps_c0) {
      // The prologue of the channel block: this lane's nine taps, float(q) * scale.
      taps_c0 = un.c0;
      const float sc = c < C ? __ldg(scale + c) : 0.0f;
#pragma unroll
      for (int t = 0; t < 9; ++t) taps[t] = c < C ? __fmul_rn(code_to_float(q[t * C + c]), sc) : 0.0f;
    }
    const int s = it % stages;
    mbar_wait(full0 + 8 * s, (it / stages) & 1);
    const int rows = H - un.h0 < TH ? H - un.h0 : TH;
    const int cols = W - un.w0 - col;  // of the strip's columns, those inside the image
    const float* src = reinterpret_cast<const float*>(smem + s * halo) + col * UC + group * CHUNK + lane;
    float* out = y + ((static_cast<long long>(un.img) * H + un.h0) * W + un.w0 + col) * C + c;
    if (c < C && rows == TH && cols >= COLS) {
      walk<TH, true>(taps, src, halo_w * UC, UC, out, static_cast<long long>(W) * C, C, rows, cols);
    } else {
      walk<TH, false>(taps, src, halo_w * UC, UC, out, static_cast<long long>(W) * C, C, c < C ? rows : 0, cols);
    }
    mbar_arrive(empty0 + 8 * s);  // this thread is done with the stage's halo tile
  }
}

// ---- host side ----

using fc::encode_tiled;

constexpr int MAX_DEVICES = 64;

template <typename CodeT, int TH>
int launch_tile(const CUtensorMap& map, const void* x, const void* q, const void* scale, void* y, int blocks,
                int N, int H, int W, int C, int TW, int UC, int stages, int smem, int tma, cudaStream_t stream) {
  // The shared-memory limit is raised once per device to the most a plan
  // may ask for; the launch is on the caller's current device.
  static std::atomic<bool> raised[MAX_DEVICES];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= MAX_DEVICES || !raised[device].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(dequant_dwconv3x3_kernel<CodeT, TH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < MAX_DEVICES) raised[device].store(true, std::memory_order_release);
  }
  dequant_dwconv3x3_kernel<CodeT, TH><<<blocks, THREADS, smem, stream>>>(
      map, static_cast<const float*>(x), static_cast<const CodeT*>(q), static_cast<const float*>(scale),
      static_cast<float*>(y), N, H, W, C, TW, UC, stages, tma);
  return static_cast<int>(cudaGetLastError());
}

// Checks the tile plan (TH, TW, UC, stages, smem and blocks from
// dequant.py's dwconv_tile_plan) against what this file launches, encodes
// x's tensor map where TMA can address x, and launches.
template <typename CodeT>
int launch_dwconv3x3(const void* x, const void* q, const void* scale, void* y, int n_img, int H, int W, int C,
                     int TH, int TW, int UC, int stages, int smem, int blocks, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n_img < 1 || H < 1 || W < 1 || C < 1) return bad;
  if ((TH != 8 && TH != 16) || (UC != 32 && UC != 64) || TW * (UC / CHUNK) != SPAN) return bad;
  if (stages < 1 || stages > MAX_STAGES || smem != dw_smem(TH, TW, UC, stages) || smem > SMEM_LIMIT) return bad;
  const long long units = static_cast<long long>(n_img) * ((H + TH - 1) / TH) * ((W + TW - 1) / TW) *
                          ((C + UC - 1) / UC);
  if (units >= (1LL << 31) || blocks < 1 || blocks > units || blocks > MAX_BLOCKS) return bad;

  CUtensorMap map;
  std::memset(&map, 0, sizeof(map));
  const int tma = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (tma) {
    const fc::EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(n_img)};
    const cuuint64_t strides[3] = {4ULL * C, 4ULL * C * W, 4ULL * C * W * H};  // bytes, dims 1..3
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(UC), static_cast<cuuint32_t>(TW + 2),
                               static_cast<cuuint32_t>(TH + 2), 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(x), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return bad;
    }
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (TH == 8) return launch_tile<CodeT, 8>(map, x, q, scale, y, blocks, n_img, H, W, C, TW, UC, stages, smem, tma, s);
  return launch_tile<CodeT, 16>(map, x, q, scale, y, blocks, n_img, H, W, C, TW, UC, stages, smem, tma, s);
}

}  // namespace

// Plain C interface, loaded with ctypes. Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched) or the error that refused the launch.
extern "C" {

int fc_dequant_dwconv3x3_i8(const void* x, const void* q, const void* scale, void* y, int n_img, int H, int W,
                            int C, int TH, int TW, int UC, int stages, int smem, int blocks, void* stream) {
  return launch_dwconv3x3<int8_t>(x, q, scale, y, n_img, H, W, C, TH, TW, UC, stages, smem, blocks, stream);
}

int fc_dequant_dwconv3x3_e4m3(const void* x, const void* q, const void* scale, void* y, int n_img, int H, int W,
                              int C, int TH, int TW, int UC, int stages, int smem, int blocks, void* stream) {
  return launch_dwconv3x3<__nv_fp8_e4m3>(x, q, scale, y, n_img, H, W, C, TH, TW, UC, stages, smem, blocks,
                                         stream);
}

}  // extern "C"
