// Hand-written Hopper (sm_90a) kernel of the quantized serving path's
// stride-1 3x3 conv.
//
// dequant_conv3x3_kernel <- the Pallas _matmul_kernel of
// fedcrack_tpu/kernels/dequant.py behind the JAX _conv3x3
// (fedcrack_tpu/kernels/forward.py), whose im2col patches XLA materialises:
// y[N,H,W,F] = conv3x3_SAME_stride1(x[N,H,W,C] f32 NHWC,
// float(q[3,3,C,F] HWIO codes) * scale[F]), with int8 or fp8 e4m3 codes.
// The 8 decoder convs of the fused U-Net forward (kernels/forward.py) land
// here.
//
// Contract: dequant.cu's, held against the plain version in dequant.py.
// Codes are exact in bf16; x is split into hi, mid and lo bf16 terms
// (dequant_common.cuh), and each 16-deep K step accumulates lo, then mid,
// then hi into one f32 accumulator; the scale multiplies the finished
// accumulator once; no split-K, no atomics. K runs over chunks of 32 input
// channels, then the taps (kh, kw), then the chunk's channels in two k16
// steps: a function of C alone. The tile plan (dequant.py, conv_tile_plan)
// picks the pixel tile, the column block and the ring depth from the shape,
// and none of them changes an entry's sums, so a pixel's result does not
// depend on its neighbours in the batch or on the grid, and it is the same
// bit for bit run to run.
//
// What bounds it on an H100: at bucket 256 x batch 8 the forward's 8 convs
// are 80 GFLOP as three bf16 passes, 0.081 ms at 989 TFLOP/s dense, against
// 0.047 ms of device-memory bytes (each activation read once, each output
// written once). So the tensor cores bound it, and the design feeds them:
//
// * A unit of work is TH x TW output pixels of one image (8 x 8 or 8 x 16)
//   and BN output channels; one block an SM walks over the units, its ring
//   running on from one unit into the next. For each chunk of a unit, one
//   TMA load (cp.async.bulk.tensor.4d, completing on an mbarrier) brings
//   the (TH + 2) x (TW + 2) x 32 halo box of x into shared memory with the
//   128-byte swizzle. The box starts at
//   (h0 - 1, w0 - 1), and TMA zero-fills what lies outside the image: that
//   is the SAME padding. The nine taps read shifted windows of that one
//   tile, so x crosses device memory (TH + 2)(TW + 2) / (TH TW) times per
//   column block, not nine times.
// * A producer warpgroup fills a ring of stages: its thread 0 issues the
//   halo's TMA load, and all 128 threads read the chunk's 9 x 32 x BN codes
//   and store them once, converted to bf16, in the K-major 64-byte-swizzled
//   layout that a wgmma B descriptor reads. The codes pass through
//   registers, not TMA: TMA wants 16-byte row strides (F % 16 == 0), and
//   ragged F has none. Consumers release a stage through its empty barrier.
// * One or two consumer warpgroups of 64 pixels each split the chunk's halo
//   once (split3) into hi, mid and lo bf16 planes in shared memory. Per tap
//   and k16 step each warp loads its 16 pixels' fragments of the three
//   planes at the tap's shifted window with ldmatrix (A in registers, in
//   mma.sync m16n8k16's layout, which wgmma's register A shares), and
//   issues three wgmma.mma_async.m64nBNk16 (lo, mid, hi) against the
//   stage's codes. Three fragment buffers, loaded two steps ahead, keep the
//   tensor cores fed while a step's wgmma wait for the one before. Splitting
//   per chunk, not per tap, does the split's ALU work once instead of nine
//   times.
// * The epilogue scales the accumulators, applies the fused epilogue
//   (dequant_common.cuh: the bias and an eval BatchNorm, then a ReLU where
//   the launch has one; the column block's vectors and scales staged in
//   shared memory the launch adds past the plan's, conv_epilogue_smem,
//   which every plan has room for) and stores them, masked at the
//   image's edge and past F, while the producer fills the next unit's
//   stages. relu_input takes torch.relu of x as the halo is
//   split into its planes (the ReLU before each decoder block's first conv,
//   whose input the block's residual needs unclamped); the halo's zero fill
//   stays +0.0, and a -0.0 input cannot reach an output bit, since every
//   accumulator starts at +0.0.
//
// What holds it at ~30% of the bound: shared-memory traffic. With A in
// registers, each k16 step reads three A fragments (ldmatrix) and the
// stage's codes three times (one wgmma a term), about as many bytes as the
// SM's shared memory moves in the step's tensor time at BN = 64, more at
// BN = 32; the consumers' split pass and the producer's conversion of the
// codes come on top. PERF.md (PR 20) has the measurements.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime, no -lcuda
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cstring>

#include "dequant_common.cuh"

namespace {

using fc::b_desc;
using fc::bf16x2_bits;
using fc::byte_code;
using fc::Epilogue;
using fc::epilogue_pair;
using fc::fence_acc;
using fc::ldsm_x4;
using fc::mbar_arrive;
using fc::mbar_arrive_expect_tx;
using fc::mbar_init;
using fc::mbar_wait;
using fc::Mma;
using fc::relu_torch;
using fc::smem_u32;
using fc::split3;
using fc::swizzle64;
using fc::wgmma_commit;
using fc::wgmma_fence;
using fc::wgmma_wait;

constexpr int CHUNK = 32;               // input channels a stage: 128 B of f32, one swizzle row
constexpr int TAPS = 9;
constexpr int STEPS = TAPS * CHUNK / 16;  // k16 steps a chunk
constexpr int WG = 128;                 // threads of a warpgroup
constexpr int PIXEL_BYTES = CHUNK * 4;  // one halo pixel's chunk in f32
constexpr int ROW_BYTES = CHUNK * 2;    // one pixel's (or column's) chunk in bf16: a 64-byte swizzle row
constexpr int HALO_ALIGN = 1024;        // the 128-byte swizzle repeats every 8 rows
constexpr int ATOM_BYTES = 8 * ROW_BYTES;  // the 64-byte swizzle repeats every 8 rows
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;      // dynamic shared memory a block may have on sm_90

// Mirrored by dequant.py's conv_smem_bytes.
__host__ __device__ constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }
__host__ __device__ constexpr int halo_bytes(int th, int tw) {
  return round_up((th + 2) * (tw + 2) * PIXEL_BYTES, HALO_ALIGN);
}
__host__ __device__ constexpr int plane_bytes(int th, int tw) {
  return round_up((th + 2) * (tw + 2) * ROW_BYTES, HALO_ALIGN);
}
__host__ __device__ constexpr int tap_bytes(int bn) { return bn / 8 * ATOM_BYTES; }
__host__ __device__ constexpr int codes_bytes(int bn) { return TAPS * tap_bytes(bn); }
// Per stage a halo tile, the bf16 codes, a full and an empty barrier; the
// three bf16 planes of the chunk being computed; and the slack that aligns
// the dynamic shared memory's base to HALO_ALIGN.
__host__ __device__ constexpr int conv_smem(int th, int tw, int bn, int stages) {
  return stages * (halo_bytes(th, tw) + codes_bytes(bn) + 16) + 3 * plane_bytes(th, tw) + HALO_ALIGN;
}
// What a launch with an epilogue adds past the plan's shared memory: the
// column block's rows of the epilogue table and its scales. Mirrored by
// dequant.py's conv_epilogue_smem.
__host__ __device__ constexpr int conv_epilogue_smem(int bn) { return (fc::EPI_VECTORS + 1) * bn * 4; }

static_assert(ROW_BYTES == fc::B_ROW_BYTES && ATOM_BYTES == fc::B_ATOM_BYTES, "the shared B layout");

// ---- the producer's codes ----

// One task of store_codes: a channel pair (k, k + 1) at four neighbouring
// columns of one tap. A warp's 32 tasks at a time are 4 pairs x 4 chunks x
// 2 column quads, whose stores fall in 16 banks twice.
struct CodeTask {
  int pair;  // channel pair within its 16-byte chunk
  int kc;    // 16-byte chunk of the row: 8 channels
  int quad;  // column quad of the block
  int tap;
};

template <int BN>
__device__ __forceinline__ CodeTask code_task(int task) {
  constexpr int QUADS = BN / 4;
  return {task & 3, (task >> 2) & 3, (task >> 4) % QUADS, task / (16 * QUADS)};
}

// The chunk's codes q[tap][c0 + k][n0 + j] (k < 32, j < BN), zero past C
// and past F, into bf16 at dst: per tap, per column, the chunk's 32 k as
// one 64-byte row of the 64-byte swizzle (tap_bytes apart). A task loads
// two 4-byte words of codes (byte loads where F % 4 != 0 or q is
// misaligned: !vec) and stores four 4-byte bf16 pairs. A thread's tasks
// go in batches of up to 9 whose loads are all issued before any is used:
// a chunk costs one or two round trips to L2, not one a task.
template <typename CodeT, int BN>
__device__ __forceinline__ void store_codes(const CodeT* __restrict__ q, unsigned char* dst, int pt,
                                            int c0, int n0, int C, int F, bool vec) {
  constexpr int TASKS = TAPS * (CHUNK / 2) * (BN / 4);
  constexpr int ITERS = (TASKS + WG - 1) / WG;
  constexpr int BATCH = ITERS < 9 ? ITERS : 9;
  static_assert(ITERS % BATCH == 0, "code batches");
  const auto* qb = reinterpret_cast<const unsigned char*>(q);
#pragma unroll
  for (int i0 = 0; i0 < ITERS; i0 += BATCH) {
    uint32_t lo[BATCH], hi[BATCH];  // channels c and c + 1 at columns n..n+3, the first in the low byte
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int task = pt + (i0 + b) * WG;
      const CodeTask tk = code_task<BN>(task);
      const int c = c0 + 8 * tk.kc + 2 * tk.pair;  // C % 4 == 0: c < C means c + 1 < C
      const int n = n0 + 4 * tk.quad;
      const long long at = (static_cast<long long>(tk.tap) * C + c) * F + n;
      const bool ok = (TASKS % WG == 0 || task < TASKS) && c < C;
      lo[b] = 0;
      hi[b] = 0;
      if (vec) {
        if (ok && n < F) {
          lo[b] = __ldg(reinterpret_cast<const uint32_t*>(qb + at));
          hi[b] = __ldg(reinterpret_cast<const uint32_t*>(qb + at + F));
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (ok && n + e < F) {
            lo[b] |= static_cast<uint32_t>(qb[at + e]) << (8 * e);
            hi[b] |= static_cast<uint32_t>(qb[at + F + e]) << (8 * e);
          }
        }
      }
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int task = pt + (i0 + b) * WG;
      if (TASKS % WG != 0 && task >= TASKS) break;
      const CodeTask tk = code_task<BN>(task);
      unsigned char* out = dst + tk.tap * tap_bytes(BN) + tk.pair * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(byte_code<CodeT>(lo[b], j), byte_code<CodeT>(hi[b], j));
        *reinterpret_cast<uint32_t*>(out + swizzle64(4 * tk.quad + j, tk.kc)) = bf16x2_bits(v);
      }
    }
  }
}

// ---- the kernel ----

// A unit of work is one pixel tile of one image and BN output channels:
// unit u is column block u / tiles and pixel tile u % tiles of the images
// in order, tiles row-major within an image (dequant.py's
// conv_unit_origin). Block b computes units b, b + gridDim.x, ... while its
// producer fills the ring ahead, across units. NC consumer warpgroups
// (threads 0 .. 128 NC - 1), then the producer warpgroup; TH = 8, TW = 8 NC.
struct Unit {
  int img, h0, w0, n0;
};

template <int TH, int TW, int BN>
__device__ __forceinline__ Unit unit_origin(int u, int H, int W, int N) {
  const int tiles_w = (W + TW - 1) / TW;
  const int per_image = tiles_w * ((H + TH - 1) / TH);
  const int tiles = per_image * N;
  const int col = u / tiles;
  const int tile = u - col * tiles;
  const int img = tile / per_image;
  const int t = tile - img * per_image;
  return {img, t / tiles_w * TH, t % tiles_w * TW, col * BN};
}

// KIND: what follows the scale (dequant_common.cuh: EPI_NONE, or
// EPI_AFFINE with the ReLU of EPI_AFFINE_RELU a select; no residual), an
// instantiation of its own, so that the epilogue's code and registers are
// only in the kernels that run it; epi: its vectors; relu_input:
// torch.relu on x as the halo is split (the halo's zero fill stays +0.0).
template <typename CodeT, int BN, int NC, int KIND>
__global__ void __launch_bounds__((NC + 1) * WG, 1)
dequant_conv3x3_kernel(const __grid_constant__ CUtensorMap x_map, const CodeT* __restrict__ q,
                       const float* __restrict__ scale, float* __restrict__ y, const Epilogue epi,
                       int relu_input, int N, int H, int W, int C, int F, int stages, int vec) {
  constexpr int TH = 8;
  constexpr int TW = 8 * NC;
  constexpr int HALO_W = TW + 2;
  constexpr int HALO_PIXELS = (TH + 2) * HALO_W;
  constexpr int HALO = halo_bytes(TH, TW);
  constexpr int PLANE = plane_bytes(TH, TW);
  constexpr int CODES = codes_bytes(BN);
  constexpr int ACC = BN / 2;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + HALO_ALIGN - 1) & ~static_cast<uint32_t>(HALO_ALIGN - 1);
  unsigned char* smem = smem_raw + (base - raw);
  // [stages] halo tiles, [stages] code tiles, the hi, mid and lo planes,
  // [stages] full barriers, [stages] empty barriers.
  const int codes_off = stages * HALO;
  const int planes_off = codes_off + stages * CODES;
  const uint32_t full0 = base + planes_off + 3 * PLANE;
  const uint32_t empty0 = full0 + 8 * stages;

  const int units = N * ((H + TH - 1) / TH) * ((W + TW - 1) / TW) * ((F + BN - 1) / BN);
  const int chunks = (C + CHUNK - 1) / CHUNK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, WG + 1);  // the producers, and thread 0's expect_tx
      mbar_init(empty0 + 8 * s, NC * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NC * WG) {
    // ---- producer warpgroup: chunk after chunk, unit after unit ----
    const int pt = threadIdx.x - NC * WG;
    int it = 0;  // chunks filled so far: stage it % stages, pass it / stages
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit un = unit_origin<TH, TW, BN>(u, H, W, N);
      for (int cc = 0; cc < chunks; ++cc, ++it) {
        const int s = it % stages;
        mbar_wait(empty0 + 8 * s, ((it / stages) & 1) ^ 1);  // the first pass finds it free
        if (pt == 0) {
          mbar_arrive_expect_tx(full0 + 8 * s, HALO_PIXELS * PIXEL_BYTES);
          fc::tma_load_4d(base + s * HALO, &x_map, full0 + 8 * s, cc * CHUNK, un.w0 - 1, un.h0 - 1, un.img);
        }
        store_codes<CodeT, BN>(q, smem + codes_off + s * CODES, pt, cc * CHUNK, un.n0, C, F, vec != 0);
        fc::fence_proxy_async();  // the stores, seen by wgmma
        mbar_arrive(full0 + 8 * s);
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int ct = threadIdx.x;
  const int warp = ct >> 5;  // the warp's 16 rows of the tile's 64 NC
  const int lane = ct & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  unsigned char* planes = smem + planes_off;  // [hi, mid, lo][halo pixel][32 channels], 64-byte swizzle
  const uint32_t planes_u32 = base + planes_off;
  // This lane's ldmatrix row: matrix lane / 8 is rows 0-7 or 8-15 of the
  // warp's 16 (lane & 8) at k 0-7 or 8-15 of the step (lane & 16).
  int ld_pixel;
  {
    const int m = warp * 16 + (lane & 7) + (lane & 8);
    ld_pixel = m / TW * HALO_W + m % TW;  // halo pixel at tap (0, 0)
  }
  const int ld_half = lane >> 4;
  uint32_t frag[3][3][4];  // [buffer][lo, mid, hi][fragment register]
  // The column block's epilogue vectors and scales ([EPI_VECTORS + 1][BN])
  // past the barriers, in what the launch adds for an epilogue.
  float* vectors = reinterpret_cast<float*>(smem + planes_off + 3 * PLANE + 16 * stages);

  int it = 0;
  int resident = -1;  // the column block whose vectors are staged
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit un = unit_origin<TH, TW, BN>(u, H, W, N);
    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;

    for (int cc = 0; cc < chunks; ++cc, ++it) {
      const int s = it % stages;
      mbar_wait(full0 + 8 * s, (it / stages) & 1);
      __syncwarp();
      const unsigned char* halo = smem + s * HALO;
      const uint32_t codes = base + codes_off + s * CODES;

      // The chunk's halo split once into hi, mid and lo bf16 planes: a
      // unit is 4 channels (16 bytes) of a pixel. The f32 tile is in TMA's
      // 128-byte swizzle; the planes are in the 64-byte one, which ldmatrix
      // reads free of bank conflicts for 8 neighbouring pixels.
      fc::named_sync(1, NC * WG);  // every consumer warp is done with the last chunk's planes and epilogue
      if (KIND != fc::EPI_NONE && un.n0 != resident) {
        fc::stage_vectors(epi, vectors, BN, ct, un.n0);
        if (ct < BN) vectors[fc::EPI_VECTORS * BN + ct] = un.n0 + ct < F ? __ldg(scale + un.n0 + ct) : 0.0f;
        resident = un.n0;  // seen by the epilogue past the chunk's barriers
      }
      for (int e = ct; e < HALO_PIXELS * (CHUNK / 4); e += NC * WG) {
        const int p = e >> 3;
        const int j = e & 7;
        float4 v = *reinterpret_cast<const float4*>(halo + p * PIXEL_BYTES + ((j ^ (p & 7)) << 4));
        if (relu_input) v = make_float4(relu_torch(v.x), relu_torch(v.y), relu_torch(v.z), relu_torch(v.w));
        uint32_t hi[2], mid[2], lo[2];
        split3(make_float2(v.x, v.y), hi[0], mid[0], lo[0]);
        split3(make_float2(v.z, v.w), hi[1], mid[1], lo[1]);
        unsigned char* out = planes + swizzle64(p, j >> 1) + (j & 1) * 8;
        *reinterpret_cast<uint2*>(out) = make_uint2(hi[0], hi[1]);
        *reinterpret_cast<uint2*>(out + PLANE) = make_uint2(mid[0], mid[1]);
        *reinterpret_cast<uint2*>(out + 2 * PLANE) = make_uint2(lo[0], lo[1]);
      }
      fc::named_sync(1, NC * WG);  // the planes are whole

      // Step (tap, k16 step ks): the fragments of rows g and g + 8 from the
      // tap's shifted window of each plane.
      auto load = [&](int step, uint32_t (&f)[3][4]) {
        const int tap = step >> 1;
        const int p = ld_pixel + tap / 3 * HALO_W + tap % 3;
        const uint32_t at = planes_u32 + swizzle64(p, 2 * (step & 1) + ld_half);
        ldsm_x4(at, f[2]);              // hi
        ldsm_x4(at + PLANE, f[1]);      // mid
        ldsm_x4(at + 2 * PLANE, f[0]);  // lo
      };

      // Three fragment buffers, loaded two steps ahead: when a step's
      // wgmma are issued, its fragments are in registers, and the step
      // before it is still in the tensor cores.
      load(0, frag[0]);
      load(1, frag[1]);
#pragma unroll
      for (int step = 0; step < STEPS; ++step) {
        const uint64_t desc = b_desc(codes + (step >> 1) * tap_bytes(BN) + (step & 1) * 32);
        wgmma_fence();
        fence_acc(acc);
        Mma<BN>::run(acc, frag[step % 3][0], desc);  // lo
        Mma<BN>::run(acc, frag[step % 3][1], desc);  // mid
        Mma<BN>::run(acc, frag[step % 3][2], desc);  // hi
        wgmma_commit();
        fence_acc(acc);
        if (step + 2 < STEPS) {
          wgmma_wait<1>();  // the step before is done with the buffer loaded next
          load(step + 2, frag[(step + 2) % 3]);
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive(empty0 + 8 * s);  // the halo tile and the codes of this stage are free
    }

    // Epilogue: the scale multiplies the finished accumulator once, then
    // the steps of epi's kind, per output; an epilogue's scales are staged
    // beside its vectors.
    const float* scales = vectors + fc::EPI_VECTORS * BN;
    const bool relu = epi.kind == fc::EPI_AFFINE_RELU;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const int n = un.n0 + c;
      const float2 sc = KIND != fc::EPI_NONE
                            ? make_float2(scales[c], scales[c + 1])
                            : make_float2(n < F ? scale[n] : 0.0f, n + 1 < F ? scale[n + 1] : 0.0f);
      const fc::ChannelPair ch = fc::channel_pair<KIND>(vectors, BN, c);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = warp * 16 + g + 8 * i;
        const int h = un.h0 + m / TW;
        const int w = un.w0 + m % TW;
        if (h >= H || w >= W || n >= F) continue;
        float* out = y + ((static_cast<long long>(un.img) * H + h) * W + w) * F + n;
        const float2 v =
            epilogue_pair<KIND>(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1], sc, ch, make_float2(0.0f, 0.0f), relu);
        if (F % 2 == 0) {
          *reinterpret_cast<float2*>(out) = v;
        } else {
          out[0] = v.x;
          if (n + 1 < F) out[1] = v.y;
        }
      }
    }
  }
}

// ---- host side ----

using fc::encode_tiled;

constexpr int MAX_DEVICES = 64;

template <typename CodeT, int BN, int NC, int KIND>
int launch_tile(const CUtensorMap& map, const void* q, const void* scale, void* y, const Epilogue& epi,
                int relu_input, int blocks, int N, int H, int W, int C, int F, int stages, int smem, int vec,
                cudaStream_t stream) {
  // The shared-memory limit is raised once per device to the most a plan
  // may ask for; the launch is on the caller's current device.
  static std::atomic<bool> raised[MAX_DEVICES];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= MAX_DEVICES || !raised[device].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(dequant_conv3x3_kernel<CodeT, BN, NC, KIND>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < MAX_DEVICES) raised[device].store(true, std::memory_order_release);
  }
  dequant_conv3x3_kernel<CodeT, BN, NC, KIND><<<blocks, (NC + 1) * WG, smem, stream>>>(
      map, static_cast<const CodeT*>(q), static_cast<const float*>(scale), static_cast<float*>(y), epi,
      relu_input, N, H, W, C, F, stages, vec);
  return static_cast<int>(cudaGetLastError());
}

// launch_tile of the kernel instantiation for epi's kind.
template <typename CodeT, int BN, int NC>
int launch_kind(const CUtensorMap& map, const void* q, const void* scale, void* y, const Epilogue& epi,
                int relu_input, int blocks, int N, int H, int W, int C, int F, int stages, int smem, int vec,
                cudaStream_t stream) {
  if (epi.kind == fc::EPI_NONE) {
    return launch_tile<CodeT, BN, NC, fc::EPI_NONE>(map, q, scale, y, epi, relu_input, blocks, N, H, W, C, F, stages,
                                                      smem, vec, stream);
  }
  return launch_tile<CodeT, BN, NC, fc::EPI_AFFINE>(map, q, scale, y, epi, relu_input, blocks, N, H, W, C, F, stages,
                                                      smem, vec, stream);
}

// Checks the tile plan (TH, TW, BN, stages, smem and blocks from
// dequant.py's conv_tile_plan) against what this file launches, encodes
// x's tensor map and launches.
template <typename CodeT>
int launch_conv3x3(const void* x, const void* q, const void* scale, void* y, const Epilogue& epi, int relu_input,
                   int n_img, int H, int W, int C, int F, int TH, int TW, int BN, int stages, int smem, int blocks,
                   void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n_img < 1 || H < 1 || W < 1 || C < 1 || F < 1) return bad;
  if (!fc::epilogue_ok(epi, F) || epi.kind == fc::EPI_BIAS_RESIDUAL) return bad;  // the forward's conv mixes
  if (C % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0) return bad;  // TMA's strides, address
  if (9LL * C * F >= (1LL << 31)) return bad;
  if (TH != 8 || (TW != 8 && TW != 16) || (BN != 16 && BN != 32 && BN != 64)) return bad;
  if (stages < 1 || stages > MAX_STAGES || smem != conv_smem(TH, TW, BN, stages) || smem > SMEM_LIMIT) {
    return bad;
  }
  const long long units = static_cast<long long>(n_img) * ((H + TH - 1) / TH) * ((W + TW - 1) / TW) *
                          ((F + BN - 1) / BN);
  if (units >= (1LL << 31) || blocks < 1 || blocks > units) return bad;
  const fc::EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);

  CUtensorMap map;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(n_img)};
  const cuuint64_t strides[3] = {4ULL * C, 4ULL * C * W, 4ULL * C * W * H};  // bytes, dims 1..3
  const cuuint32_t box[4] = {CHUNK, static_cast<cuuint32_t>(TW + 2), static_cast<cuuint32_t>(TH + 2), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(x), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return bad;
  }
  const int vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  const int launch_smem = smem + (epi.kind != fc::EPI_NONE ? conv_epilogue_smem(BN) : 0);
  if (launch_smem > SMEM_LIMIT) return bad;  // every plan of conv_tile_plan has room
  const auto s = static_cast<cudaStream_t>(stream);
#define FC_TILE(BN_, NC_)                                                                          \
  if (BN == BN_ && TW == 8 * NC_)                                                                  \
    return launch_kind<CodeT, BN_, NC_>(map, q, scale, y, epi, relu_input, blocks, n_img, H, W, C, F, stages, \
                                        launch_smem, vec, s);
  FC_TILE(16, 1) FC_TILE(32, 1) FC_TILE(64, 1) FC_TILE(16, 2) FC_TILE(32, 2) FC_TILE(64, 2)
#undef FC_TILE
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

}  // namespace

// Plain C interface, loaded with ctypes. Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched) or the error that refused the launch.
extern "C" {

// The epilogue's table, table_stride and kind as dequant.cu's
// fc_dequant_matmul_* (EPI_NONE, EPI_AFFINE or EPI_AFFINE_RELU; no
// residual); relu_input != 0 takes torch.relu of x as it is read.
int fc_dequant_conv3x3_i8(const void* x, const void* q, const void* scale, void* y, const void* table,
                          int table_stride, int kind, int relu_input, int n_img, int H, int W,
                          int C, int F, int TH, int TW, int BN, int stages, int smem, int blocks, void* stream) {
  return launch_conv3x3<int8_t>(x, q, scale, y, fc::make_epilogue(table, nullptr, table_stride, kind), relu_input,
                                n_img, H, W, C, F, TH, TW, BN, stages, smem, blocks, stream);
}

int fc_dequant_conv3x3_e4m3(const void* x, const void* q, const void* scale, void* y, const void* table,
                            int table_stride, int kind, int relu_input, int n_img, int H,
                            int W, int C, int F, int TH, int TW, int BN, int stages, int smem, int blocks,
                            void* stream) {
  return launch_conv3x3<__nv_fp8_e4m3>(x, q, scale, y, fc::make_epilogue(table, nullptr, table_stride, kind),
                                       relu_input, n_img, H, W, C, F, TH, TW, BN, stages, smem, blocks, stream);
}

}  // extern "C"
