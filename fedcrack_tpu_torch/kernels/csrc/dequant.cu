// Hand-written Hopper (sm_90a) kernels of the quantized serving path.
//
// They replace the two Pallas kernels of fedcrack_tpu/kernels/dequant.py:
//
// * dequant_matmul_kernel <- _matmul_kernel (via _dequant_matmul_pallas):
//   y[M,N] = (x[M,K] f32 @ float(q[K,N] codes)) * scale[N], with int8 or
//   fp8 e4m3 codes. The 1x1 convs and the stride-2 stem of the fused U-Net
//   forward (kernels/forward.py) land here.
// * dequant_codes_kernel <- _dequant_kernel (via _dequant_codes_pallas):
//   out[i] = float(q[i]) * scale[i % N], the depthwise-kernel expansion,
//   for up to 16 leaves in one launch (see its section below).
//
// The stride-1 3x3 conv, the same _matmul_kernel behind the JAX _conv3x3,
// has its own Hopper kernel in dequant_conv.cu under the same contract.
//
// Contract (held against the plain PyTorch versions in dequant.py):
//
// * Codes are exact in bf16: an int8 code in [-128, 127] has at most 8
//   significant bits, a finite e4m3 value 4 and an exponent inside bf16's
//   range. They are converted to bf16 as they are staged into shared
//   memory.
// * The f32 activation is split in registers into three bf16 terms,
//   hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), which carry
//   x's 24-bit significand (|x - (hi + mid + lo)| <= 2^-24 |x| for normal x
//   of the activations' range). Each term x code product is exact in the
//   tensor core (8 x 8 significant bits), and the sums accumulate in f32
//   registers: three wgmma per 16-deep K step against the same codes, lo
//   then mid then hi. What differs from the plain f32 product is the order
//   and rounding of the f32 sums, the same float reassociation as the JAX
//   kernel's K blocking, so an entry stays within one per-channel scale of
//   x @ (q * scale) (the JAX bound; in code units the sums' rounding error
//   is orders of magnitude below 1).
// * The per-output-channel scale multiplies the finished accumulator once,
//   in the epilogue, as the Pallas kernel does after its last K block; the
//   fused bias, BatchNorm, ReLU and residual follow it, each one correctly
//   rounded op, bit for bit the torch ops they replace.
// * Deterministic: every output tile owns its whole K loop, in order; no
//   split-K, no atomics. K runs over chunks of 32, each two k16 steps; within
//   a step the 16 k sit in the MMA's slots in a fixed order (below). So an
//   entry's sum is the same sequence of MMAs whatever tile or grid the plan
//   picked: it depends on K and N only, never on M, and a served image's
//   result does not depend on how many rows share its launch.
// * Ragged M, K and N are masked in the kernel (zero-filled loads, clipped
//   or guarded stores); the caller pads nothing.
//
// What bounds it on an H100: at bucket 256 x batch 8 the forward's 15 GEMMs
// (K = 27..256, N = 1..256) are bound by device-memory bytes, 0.110 ms at
// 3.35 TB/s (each operand read once, y written once), against 0.034 ms of
// three bf16 passes at 989 TFLOP/s; the large-M GEMMs write as many bytes as
// they read or more. So the design keeps bytes moving both ways and gives
// each SM one block that never waits on a round trip it could have started
// earlier:
//
// * Persistent grid, tiles from Python. dequant.py's matmul_tile_plan picks
//   the row tile BM (128, two consumer warpgroups of 64 rows; 256, four,
//   where K is one chunk and the column block at most 32 wide, whose short
//   chains of dependent wgmma leave the tensor cores waiting on latency
//   unless more warpgroups interleave theirs; 64 where M is), the column
//   block BN (8..128), the ring depth and the grid; the entry
//   point refuses a plan whose shared memory it computes otherwise. A unit
//   of work is BM rows x BN columns; unit u is column block u / mtiles, row
//   tile u % mtiles, and block b computes units b, b + gridDim.x, ...
// * Resident codes. At its first unit, and again only where its next unit
//   is in another column block, a block's consumers load the column block's
//   K x BN codes with batched, row-coalesced 32-bit loads (its scales in
//   flight with them), convert them to bf16 once, and store them in the
//   K-major 64-byte-swizzled layout a wgmma
//   B descriptor reads (with the block's BN scales). The codes then stay in
//   shared memory across all the block's row tiles: at most 8 x 32 x 128
//   bf16 = 64 KB for K <= 256.
// * A TMA-fed A ring across tiles. A producer warp keeps loads of A in
//   flight, one stage a chunk of 32 f32 of BM rows (a 128-byte swizzle row a
//   row), ahead across K and across the next unit, signalling full
//   mbarriers with the bytes; consumers free a stage (empty mbarriers) as
//   soon as its values are in registers. TMA wants 16-byte row strides and
//   a 16-byte aligned x: where K % 4 != 0 (the stem's K = 27) or x is
//   misaligned, the producer's 32 lanes fill the same ring with cp.async
//   that arrive on the same barrier: where K < 32, a unit's rows as one
//   contiguous span (one bulk copy where it is 16-byte aligned and sized),
//   kept linear, the consumers reading zeros past K; else row by row, 4
//   bytes a lane, zero-filled past M and K, in the swizzle TMA would use.
// * wgmma on the three-term split. Each consumer thread reads its rows' A
//   values of a k16 step as two 16-byte loads, splits them in registers, and
//   issues wgmma.mma_async.m64nBNk16 with A from registers and the resident
//   codes as B, lo then mid then hi; two fragment sets let one chunk's
//   split overlap the last chunk's wgmma (one set with four warpgroups,
//   which hide each other's waits and have fewer registers). Splitting in
//   registers, not into
//   bf16 planes in shared memory as the conv does, is right here: each A
//   value is used once per column block (the conv reads each nine times,
//   once a tap), so a plane pass would add shared-memory traffic for no
//   saved work. To make the 16-byte loads possible, the 16 k of a step take
//   the MMA's k slots permuted: thread t's four k 4t..4t+3 fill slots 2t,
//   2t + 1 (a[0], a[1]) and 2t + 8, 2t + 9 (a[2], a[3]), and the codes are
//   stored in the same slots. The permutation is fixed: it reorders the
//   step's products the same way for every entry of every launch.
// * A TMA store epilogue. Each consumer warpgroup scales its 64 x BN
//   accumulators once, applies the fused epilogue (dequant_common.cuh: the
//   bias, an eval BatchNorm, a ReLU, a residual, in a straight-line copy of
//   the code for each mix the forward launches; the column block's rows of
//   the host's epilogue table read through L1, prefetched there when the
//   block's codes are loaded), writes them into its staging tile (the
//   swizzle of the store's box), and one thread stores the tile with
//   cp.async.bulk.tensor, clipped at M and N, and goes straight on to the
//   next unit: the store drains while the ring's next loads are in flight.
//   Two staging tiles alternate, so a store is waited for only two units
//   later, before its tile is written again. A residual (16-byte aligned)
//   lands in the unit's staging tile by TMA in y's boxes while the K loop
//   runs, and the epilogue adds in place. Where N % 4 != 0 (the head's
//   N = 1) y's rows have no 16-byte stride, and the consumers store from
//   registers, masked, reading the residual beside each store.
//
// What holds it short of its bound (PERF.md has the readings): the deep
// GEMMs (M <= 8,192, K = 128..256) are one unit a block, so a block's loads,
// wgmma and store follow one another behind a fixed start of a few
// microseconds; the one- and two-chunk GEMMs wait on short chains of
// dependent wgmma; where A is read from device memory the large GEMMs run
// near its practical rate.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime, no -lcuda
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cstring>

#include "dequant_common.cuh"

namespace {

using fc::B_ROW_BYTES;
using fc::b_desc;
using fc::bf16x2_bits;
using fc::byte_code;
using fc::code_to_float;
using fc::Epilogue;
using fc::epilogue_pair;
using fc::fence_acc;
using fc::fence_proxy_async;
using fc::mbar_arrive;
using fc::mbar_arrive_expect_tx;
using fc::mbar_init;
using fc::mbar_wait;
using fc::Mma;
using fc::named_sync;
using fc::smem_u32;
using fc::split3;
using fc::swizzle64;
using fc::wgmma_commit;
using fc::wgmma_fence;
using fc::wgmma_wait;

constexpr int CHUNK = 32;               // K of a ring stage: 32 f32, one 128-byte swizzle row a row of A
constexpr int WG = 128;                 // threads of a warpgroup
constexpr int WG_ROWS = 64;             // rows of a unit a consumer warpgroup owns: one wgmma m64
constexpr int A_ROW_BYTES = CHUNK * 4;  // a row of A's chunk in f32
constexpr int ALIGN = 1024;             // the 128-byte swizzle repeats every 8 rows
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;      // dynamic shared memory a block may have on sm_90
constexpr int STORE_COLS = 32;          // columns of a TMA store box: 128 bytes of f32, one swizzle row
constexpr int CODE_BATCH = 16;          // code tasks whose loads a consumer issues before using any

// Mirrored by dequant.py's matmul_smem_bytes.
__host__ __device__ constexpr int k_chunks(int k) { return (k + CHUNK - 1) / CHUNK; }
__host__ __device__ constexpr int stage_bytes(int bm) { return bm * A_ROW_BYTES; }
__host__ __device__ constexpr int out_bytes(int bm, int bn) { return bm * bn * 4; }
__host__ __device__ constexpr int codes_bytes(int k, int bn) { return k_chunks(k) * bn * B_ROW_BYTES; }
// The ring's stages with a full and an empty barrier each; two staged
// output tiles; a column block's codes in bf16 and its scales; and the
// slack that aligns the dynamic shared memory's base to ALIGN.
__host__ __device__ constexpr int matmul_smem(int bm, int bn, int k, int stages) {
  return stages * (stage_bytes(bm) + 16) + 2 * out_bytes(bm, bn) + codes_bytes(k, bn) + bn * 4 + ALIGN;
}
// What a launch with a residual adds past the plan's shared memory: a
// residual barrier for each of up to 4 consumer warpgroups. Mirrored by
// dequant.py's MATMUL_RESIDUAL_SMEM.
constexpr int RESIDUAL_SMEM = 32;
// The most K a block can hold codes for (at BN = 8, with nothing else).
constexpr int MAX_K = SMEM_LIMIT / (8 * B_ROW_BYTES) * CHUNK;

// The byte of column `col` (even) of row `row` in a warpgroup's staging
// tile: boxes of min(BN, 32) columns one after another, each 64 rows of
// the box's width in the TMA swizzle of that width (32, 64 or 128 bytes:
// address bits 7.. XORed into the 16-byte chunk).
template <int BN>
__device__ __forceinline__ int staged_offset(int row, int col) {
  constexpr int COLS = BN < STORE_COLS ? BN : STORE_COLS;
  constexpr int ROW = COLS * 4;
  const int a = row * ROW + (col % COLS) * 4;
  return (col / COLS) * WG_ROWS * ROW + (a ^ (((a >> 7) & (ROW / 16 - 1)) << 4));
}

// src_bytes = 0 reads nothing and zero-fills the destination.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// An arrival on bar once this thread's cp.async so far have landed (one of
// the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// `bytes` (a multiple of 16) from src to dst (both 16-byte aligned) in one
// bulk copy, completing on the mbarrier bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// One task of load_codes: a k pair (k, k + 1) at four neighbouring columns.
// Tasks run pair-in-quartet fastest, then column quad, then quartet, then
// chunk: a warp's loads read 8 rows of up to 32 contiguous bytes, and its
// bf16 stores fall at most 4 to a bank.
struct CodeTask {
  int k;     // the pair's first k
  int quad;  // column quad of the block
};

template <int BN>
__device__ __forceinline__ CodeTask code_task(int task) {
  constexpr int QUADS = BN / 4;
  const int rest = (task >> 2) / QUADS;
  return {(rest >> 2) * CHUNK + 2 * ((rest & 3) * 4 + (task & 3)), (task >> 2) % QUADS};
}

// The column block's codes q[k][n0 + j] (j < BN, every k < K), zero past K
// and past N, into bf16 at dst: per 32-k chunk, per column, one 64-byte row
// of the 64-byte swizzle, each k in its MMA slot (the header's
// permutation: k 16s + 4t + 2h + e of a chunk in slot 16s + 2t + 8h + e);
// and the block's BN scales, zero past N. A task loads two 32-bit words of
// codes (byte loads where N % 4 != 0 or q is misaligned) and stores four
// bf16 pairs.
template <typename CodeT, int BN, int THREADS>
__device__ __forceinline__ void load_codes(const CodeT* __restrict__ q, const float* __restrict__ scale,
                                           unsigned char* dst, float* scales, int ct, int n0, int K, int N) {
  const int tasks = k_chunks(K) * (CHUNK / 2) * (BN / 4);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  const auto* qb = reinterpret_cast<const unsigned char*>(q);
  static_assert(THREADS >= BN, "a scale a thread");
  const float sc = ct < BN && n0 + ct < N ? scale[n0 + ct] : 0.0f;  // in flight with the codes
  for (int first = ct; first < tasks; first += CODE_BATCH * THREADS) {
    uint32_t lo[CODE_BATCH], hi[CODE_BATCH];  // k and k + 1 at columns n..n+3, the first in the low byte
#pragma unroll
    for (int b = 0; b < CODE_BATCH; ++b) {
      const int task = first + b * THREADS;
      const CodeTask tk = code_task<BN>(task);
      const int n = n0 + 4 * tk.quad;
      const long long at = static_cast<long long>(tk.k) * N + n;
      lo[b] = 0;
      hi[b] = 0;
      if (task >= tasks) continue;
      if (vec) {
        if (n < N && tk.k < K) lo[b] = __ldg(reinterpret_cast<const uint32_t*>(qb + at));
        if (n < N && tk.k + 1 < K) hi[b] = __ldg(reinterpret_cast<const uint32_t*>(qb + at + N));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (n + e >= N) break;
          if (tk.k < K) lo[b] |= static_cast<uint32_t>(qb[at + e]) << (8 * e);
          if (tk.k + 1 < K) hi[b] |= static_cast<uint32_t>(qb[at + N + e]) << (8 * e);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < CODE_BATCH; ++b) {
      const int task = first + b * THREADS;
      if (task >= tasks) break;
      const CodeTask tk = code_task<BN>(task);
      const int r = tk.k % CHUNK;        // 16 s + 4 t + 2 h
      const int chunk16 = 2 * (r >> 4) + ((r >> 1) & 1);  // slot 16 s + 8 h + 2 t: chunk 2 s + h, word t
      unsigned char* out = dst + (tk.k / CHUNK) * BN * B_ROW_BYTES + 4 * ((r & 15) >> 2);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(byte_code<CodeT>(lo[b], j), byte_code<CodeT>(hi[b], j));
        *reinterpret_cast<uint32_t*>(out + swizzle64(4 * tk.quad + j, chunk16)) = bf16x2_bits(v);
      }
    }
  }
  if (ct < BN) scales[ct] = sc;
}

// ---- the kernel ----

// How A reaches a stage: by TMA through x_map (K % 4 == 0, x 16-byte
// aligned), into the 128-byte swizzle; as rows, by 4-byte cp.async into the
// same swizzle; or, where all of K is one chunk (K < 32), as the unit's
// span of rows x K contiguous floats, in one bulk copy where the span is
// 16-byte aligned and sized (else by 4-byte cp.async), kept linear: row r's
// k at r K + k.
enum AMode { A_TMA = 0, A_ROWS = 1, A_SPAN = 2 };

// NC consumer warpgroups (threads 0 .. 128 NC - 1), each owning 64 rows of
// a unit's BM = 64 NC, then the producer warp. store_tma: y moves by TMA
// through y_map (else by stores from registers). KIND: what follows the
// scale (dequant_common.cuh: EPI_NONE, EPI_AFFINE with the ReLU of
// EPI_AFFINE_RELU a select, or EPI_BIAS_RESIDUAL), an instantiation of its
// own, so that an epilogue's code and registers are only in the kernels
// that run it; epi: its vectors and residual ([M, N] like y).
template <typename CodeT, int BN, int NC, int KIND>
__global__ void __launch_bounds__(NC * WG + 32, 1)
dequant_matmul_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap y_map,
                      const __grid_constant__ CUtensorMap r_map, const float* __restrict__ x,
                      const CodeT* __restrict__ q, const float* __restrict__ scale, float* __restrict__ y,
                      const Epilogue epi, int M, int K, int N, int stages, int a_mode, int store_tma) {
  constexpr int BM = NC * WG_ROWS;
  constexpr int STAGE = stage_bytes(BM);
  constexpr int ACC = BN / 2;
  constexpr int BOXES = (BN + STORE_COLS - 1) / STORE_COLS;
  constexpr int BOX_BYTES = WG_ROWS * (BN < STORE_COLS ? BN : STORE_COLS) * 4;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + ALIGN - 1) & ~static_cast<uint32_t>(ALIGN - 1);
  unsigned char* smem = smem_raw + (base - raw);
  // [stages] A tiles, the staging tiles ([NC][2] of 64 x BN), the codes,
  // the scales, [stages] full barriers, [stages] empty barriers, and with a
  // residual (RESIDUAL_SMEM past the plan) [NC] residual barriers.
  const int out_off = stages * STAGE;
  const int codes_off = out_off + 2 * out_bytes(BM, BN);
  const int scales_off = codes_off + codes_bytes(K, BN);
  const uint32_t full0 = base + scales_off + BN * 4;
  const uint32_t empty0 = full0 + 8 * stages;
  const uint32_t rbar0 = empty0 + 8 * stages;  // a residual barrier a consumer warpgroup

  const int mtiles = (M + BM - 1) / BM;
  const int units = mtiles * ((N + BN - 1) / BN);
  const int chunks = k_chunks(K);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, a_mode == A_TMA ? 1 : 32);  // lane 0's expect_tx, or each lane's arrival
      mbar_init(empty0 + 8 * s, NC * WG);
    }
    if (KIND == fc::EPI_BIAS_RESIDUAL && store_tma && epi.residual != nullptr) {
      for (int w = 0; w < NC; ++w) mbar_init(rbar0 + 8 * w, 1);  // thread 0 of warpgroup w's expect_tx
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NC * WG) {
    // ---- the producer warp: chunk after chunk, unit after unit ----
    const int lane = threadIdx.x & 31;
    int it = 0;  // chunks filled so far: stage it % stages, pass it / stages
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int m0 = (u % mtiles) * BM;
      for (int cc = 0; cc < chunks; ++cc, ++it) {
        const int s = it % stages;
        mbar_wait(empty0 + 8 * s, ((it / stages) & 1) ^ 1);  // the first pass finds it free
        if (a_mode == A_TMA) {
          if (lane == 0) {
            mbar_arrive_expect_tx(full0 + 8 * s, STAGE);
            fc::tma_load_2d(base + s * STAGE, &x_map, full0 + 8 * s, cc * CHUNK, m0);
          }
        } else if (a_mode == A_SPAN) {
          const int n = (M - m0 < BM ? M - m0 : BM) * K;  // the unit's floats
          const float* src = x + static_cast<long long>(m0) * K;
          if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && n % 4 == 0) {
            if (lane == 0) {
              mbar_arrive_expect_tx(full0 + 8 * s, 4 * n);
              bulk_load(base + s * STAGE, src, 4 * n, full0 + 8 * s);
            } else {
              mbar_arrive(full0 + 8 * s);
            }
          } else {
            for (int i = lane; i < n; i += 32) cp_async4(base + s * STAGE + 4 * i, src + i, true);
            cp_async_arrive(full0 + 8 * s);
          }
        } else {
          // Lane l copies k = cc * 32 + l of every row, into the 128-byte swizzle TMA would use.
          const int k = cc * CHUNK + lane;
          const float* src = x + static_cast<long long>(m0) * K + k;
          const uint32_t dst = base + s * STAGE + (lane & 3) * 4;
          for (int r = 0; r < BM; ++r, src += K) {
            const bool ok = k < K && m0 + r < M;
            cp_async4(dst + r * A_ROW_BYTES + (((lane >> 2) ^ (r & 7)) << 4), ok ? src : x, ok);
          }
          cp_async_arrive(full0 + 8 * s);
        }
      }
    }
    cp_async_wait_all();  // no copy outlives the thread
    return;
  }

  // ---- the consumer warpgroups ----
  const int ct = threadIdx.x;
  const int wg = ct / WG;
  const int wt = ct % WG;    // thread of its warpgroup
  const int warp = wt >> 5;  // the warp's 16 rows of the warpgroup's 64
  const int lane = ct & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int a_row = (wg * WG_ROWS + warp * 16 + g) * A_ROW_BYTES;  // row g; row g + 8 is 8 rows on
  const int a_span = (wg * WG_ROWS + warp * 16 + g) * K;            // the same row in the linear span
  unsigned char* staged0 = smem + out_off + wg * 2 * WG_ROWS * BN * 4;
  const uint32_t staged0_u32 = base + out_off + wg * 2 * WG_ROWS * BN * 4;
  int stored = 0;  // units through the epilogue: the two staging tiles alternate
  const float* scales = reinterpret_cast<const float*>(smem + scales_off);
  const uint32_t codes_u32 = base + codes_off;
  int rloads = 0;  // residual tiles this warpgroup's barrier has received: its phase
  uint32_t frag_a[2][3][4], frag_b[2][3][4];  // [k16 step][lo, mid, hi][fragment register], two chunks

  int it = 0;         // chunks consumed so far
  int resident = -1;  // the column block whose codes are in shared memory
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int col = u / mtiles;
    const int m0 = (u - col * mtiles) * BM;
    const int n0 = col * BN;
    if (col != resident) {
      named_sync(1, NC * WG);  // every consumer is done with the last block's codes and scales
      load_codes<CodeT, BN, NC * WG>(q, scale, smem + codes_off, reinterpret_cast<float*>(smem + scales_off),
                                     ct, n0, K, N);
      if constexpr (KIND != fc::EPI_NONE) fc::prefetch_vectors(epi, BN, ct, n0);
      fence_proxy_async();     // the codes, seen by wgmma
      named_sync(1, NC * WG);  // the codes are whole
      resident = col;
    }

    // A residual on the TMA store path lands by TMA through r_map (y's
    // boxes and swizzle) in the staging tile where this unit's outputs will
    // be written, during the K loop, and the epilogue adds in place. The
    // tile is free once the store that last read it (two units ago) is done
    // reading.
    if (KIND == fc::EPI_BIAS_RESIDUAL && store_tma && epi.residual != nullptr) {
      const int row0 = m0 + wg * WG_ROWS;
      if (wt == 0 && row0 < M) {
        fc::bulk_wait_read<1>();
        mbar_arrive_expect_tx(rbar0 + 8 * wg, WG_ROWS * BN * 4);
        const uint32_t staged_u32 = staged0_u32 + (stored & 1) * WG_ROWS * BN * 4;
#pragma unroll
        for (int b = 0; b < BOXES; ++b) {
          fc::tma_load_2d(staged_u32 + b * BOX_BYTES, &r_map, rbar0 + 8 * wg, n0 + b * STORE_COLS, row0);
        }
      }
    }

    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;

    // One chunk: its two k16 steps' A values of rows g and g + 8 (thread
    // t's k 4t..4t+3 of the step: 16-byte chunk 4 step + t of the row in
    // the 128-byte swizzle, or four floats of the linear span, zero past
    // K), the stage freed, then split and multiplied.
    auto chunk = [&](uint32_t (&f)[2][3][4], int cc) {
      const int s = it % stages;
      mbar_wait(full0 + 8 * s, (it / stages) & 1);
      float4 v[2][2];  // [step][row g, row g + 8]
      if (a_mode == A_SPAN) {
        const float* a = reinterpret_cast<const float*>(smem + s * STAGE) + a_span;
#pragma unroll
        for (int step = 0; step < 2; ++step) {
          const int k = 16 * step + 4 * t;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float* r = a + i * 8 * K + k;
            v[step][i] = make_float4(k < K ? r[0] : 0.0f, k + 1 < K ? r[1] : 0.0f, k + 2 < K ? r[2] : 0.0f,
                                     k + 3 < K ? r[3] : 0.0f);
          }
        }
      } else {
        const unsigned char* a = smem + s * STAGE + a_row;
#pragma unroll
        for (int step = 0; step < 2; ++step) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            v[step][i] = *reinterpret_cast<const float4*>(a + i * 8 * A_ROW_BYTES + (((4 * step + t) ^ g) << 4));
          }
        }
      }
      mbar_arrive(empty0 + 8 * s);
      ++it;
      if constexpr (NC == 4) {
        wgmma_wait<0>();  // one fragment set: the last chunk, which read f, is done
      } else {
        wgmma_wait<1>();  // the chunk before last, which read f, is done
      }
#pragma unroll
      for (int step = 0; step < 2; ++step) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          split3(make_float2(v[step][i].x, v[step][i].y), f[step][2][i], f[step][1][i], f[step][0][i]);
          split3(make_float2(v[step][i].z, v[step][i].w), f[step][2][2 + i], f[step][1][2 + i],
                 f[step][0][2 + i]);
        }
      }
      wgmma_fence();
      fence_acc(acc);
#pragma unroll
      for (int step = 0; step < 2; ++step) {
        const uint64_t desc = b_desc(codes_u32 + cc * BN * B_ROW_BYTES + step * 32);
        Mma<BN>::run(acc, f[step][0], desc);  // lo
        Mma<BN>::run(acc, f[step][1], desc);  // mid
        Mma<BN>::run(acc, f[step][2], desc);  // hi
      }
      wgmma_commit();
      fence_acc(acc);
    };
    int cc = 0;
    if constexpr (NC == 4) {
      for (; cc < chunks; ++cc) chunk(frag_a, cc);
    } else {
      for (; cc + 1 < chunks; cc += 2) {
        chunk(frag_a, cc);
        chunk(frag_b, cc + 1);
      }
      if (cc < chunks) chunk(frag_a, cc);
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // Epilogue: the scale multiplies the finished accumulator once, then
    // the steps of epi's kind, per output.
    const int row0 = m0 + wg * WG_ROWS;
    const bool r_staged = KIND == fc::EPI_BIAS_RESIDUAL && store_tma && epi.residual != nullptr;
    const bool relu = epi.kind == fc::EPI_AFFINE_RELU;
    if (store_tma) {
      unsigned char* staged = staged0 + (stored & 1) * WG_ROWS * BN * 4;
      const uint32_t staged_u32 = staged0_u32 + (stored & 1) * WG_ROWS * BN * 4;
      ++stored;
      if (r_staged && row0 < M) {
        mbar_wait(rbar0 + 8 * wg, rloads++ & 1);  // the residual tile has landed
      } else {
        if (wt == 0) fc::bulk_wait_read<1>();  // the store before last has read this staging tile
        named_sync(2 + wg, WG);
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 sc = *reinterpret_cast<const float2*>(scales + c);
        const fc::ChannelPair ch = fc::channel_pair<KIND>(epi.table + n0, epi.stride, c);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float2* at = reinterpret_cast<float2*>(staged + staged_offset<BN>(warp * 16 + g + 8 * i, c));
          const float2 r = r_staged ? *at : make_float2(-0.0f, -0.0f);
          *at = epilogue_pair<KIND>(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1], sc, ch, r, relu);
        }
      }
      fence_proxy_async();  // the staging tile, seen by the TMA store
      named_sync(2 + wg, WG);
      if (wt == 0) {
        if (row0 < M) {
#pragma unroll
          for (int b = 0; b < BOXES; ++b) {
            fc::tma_store_2d(&y_map, staged_u32 + b * BOX_BYTES, n0 + b * STORE_COLS, row0);
          }
        }
        fc::bulk_commit();  // a group a unit, stored or not: the wait above counts units
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + 2 * t;
        const int n = n0 + c;
        if (n >= N) continue;
        const float2 sc = *reinterpret_cast<const float2*>(scales + c);
        const fc::ChannelPair ch = fc::channel_pair<KIND>(epi.table + n0, epi.stride, c);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = row0 + warp * 16 + g + 8 * i;
          if (m >= M) continue;
          const long long at = static_cast<long long>(m) * N + n;
          float2 r = make_float2(-0.0f, -0.0f);
          if (KIND == fc::EPI_BIAS_RESIDUAL && epi.residual != nullptr) {
            if (N % 2 == 0) {
              r = *reinterpret_cast<const float2*>(epi.residual + at);
            } else {
              r.x = epi.residual[at];
              if (n + 1 < N) r.y = epi.residual[at + 1];
            }
          }
          const float2 v = epilogue_pair<KIND>(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1], sc, ch, r, relu);
          float* out = y + at;
          if (N % 2 == 0) {
            *reinterpret_cast<float2*>(out) = v;
          } else {
            out[0] = v.x;
            if (n + 1 < N) out[1] = v.y;
          }
        }
      }
    }
  }
  if (store_tma && wt == 0) fc::bulk_wait_read<0>();  // no store outlives the staging tile it reads
}

// ---- host side ----

constexpr int MAX_DEVICES = 64;

template <typename CodeT, int BN, int NC, int KIND>
int launch_tile(const CUtensorMap& x_map, const CUtensorMap& y_map, const CUtensorMap& r_map, const void* x,
                const void* q, const void* scale, void* y, const Epilogue& epi, int M, int K, int N, int stages,
                int smem, int blocks, int a_mode, int store_tma, cudaStream_t stream) {
  // The shared-memory limit is raised once per device to the most a plan
  // may ask for; the launch is on the caller's current device.
  static std::atomic<bool> raised[MAX_DEVICES];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= MAX_DEVICES || !raised[device].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(dequant_matmul_kernel<CodeT, BN, NC, KIND>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < MAX_DEVICES) raised[device].store(true, std::memory_order_release);
  }
  dequant_matmul_kernel<CodeT, BN, NC, KIND><<<blocks, NC * WG + 32, smem, stream>>>(
      x_map, y_map, r_map, static_cast<const float*>(x), static_cast<const CodeT*>(q),
      static_cast<const float*>(scale), static_cast<float*>(y), epi, M, K, N, stages, a_mode, store_tma);
  return static_cast<int>(cudaGetLastError());
}

// launch_tile of the kernel instantiation for epi's kind.
template <typename CodeT, int BN, int NC>
int launch_kind(const CUtensorMap& x_map, const CUtensorMap& y_map, const CUtensorMap& r_map, const void* x,
                const void* q, const void* scale, void* y, const Epilogue& epi, int M, int K, int N, int stages,
                int smem, int blocks, int a_mode, int store_tma, cudaStream_t stream) {
  switch (epi.kind) {
    case fc::EPI_AFFINE:
    case fc::EPI_AFFINE_RELU:
      return launch_tile<CodeT, BN, NC, fc::EPI_AFFINE>(x_map, y_map, r_map, x, q, scale, y, epi, M, K, N, stages,
                                                          smem, blocks, a_mode, store_tma, stream);
    case fc::EPI_BIAS_RESIDUAL:
      return launch_tile<CodeT, BN, NC, fc::EPI_BIAS_RESIDUAL>(x_map, y_map, r_map, x, q, scale, y, epi, M, K, N,
                                                                 stages, smem, blocks, a_mode, store_tma, stream);
    default:
      return launch_tile<CodeT, BN, NC, fc::EPI_NONE>(x_map, y_map, r_map, x, q, scale, y, epi, M, K, N, stages,
                                                        smem, blocks, a_mode, store_tma, stream);
  }
}

// A row-major [rows, cols] f32 tensor map with boxes of box_cols x
// box_rows in the swizzle of the box's row bytes (32, 64 or 128).
bool encode_2d(fc::EncodeTiled encode, CUtensorMap* map, const void* ptr, int rows, int cols, int box_cols,
               int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {4ULL * cols};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapSwizzle swizzle = box_cols == 32   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_cols == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Checks the tile plan (BM, BN, stages, smem and blocks from dequant.py's
// matmul_tile_plan) against what this file launches, picks how A moves,
// encodes the tensor maps of x (for TMA) and y (where N % 4 == 0), and
// launches.
template <typename CodeT>
int launch_matmul(const void* x, const void* q, const void* scale, void* y, const Epilogue& epi, int M, int K,
                  int N, int BM, int BN, int stages, int smem, int blocks, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (M < 1 || K < 1 || N < 1 || K > MAX_K) return bad;
  if (reinterpret_cast<uintptr_t>(y) % 16 != 0 || !fc::epilogue_ok(epi, N)) return bad;
  if ((BM != 64 && BM != 128 && BM != 256) || (BN != 8 && BN != 16 && BN != 32 && BN != 64 && BN != 128)) {
    return bad;
  }
  if (BM == 256 && BN > 32) return bad;
  if (stages < 1 || stages > MAX_STAGES || smem != matmul_smem(BM, BN, K, stages) || smem > SMEM_LIMIT) {
    return bad;
  }
  const long long units = static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (units >= (1LL << 31) || blocks < 1 || blocks > units) return bad;
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int a_mode = vec ? A_TMA : K < CHUNK ? A_SPAN : A_ROWS;
  const int store_tma = N % 4 == 0;
  CUtensorMap x_map, y_map, r_map;
  memset(&x_map, 0, sizeof(x_map));
  memset(&y_map, 0, sizeof(y_map));
  memset(&r_map, 0, sizeof(r_map));
  if (vec || store_tma) {
    const fc::EncodeTiled encode = fc::encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    if (vec && !encode_2d(encode, &x_map, x, M, K, CHUNK, BM)) return bad;
    if (store_tma && !encode_2d(encode, &y_map, y, M, N, BN < STORE_COLS ? BN : STORE_COLS, WG_ROWS)) return bad;
    if (store_tma && epi.residual != nullptr &&
        !encode_2d(encode, &r_map, epi.residual, M, N, BN < STORE_COLS ? BN : STORE_COLS, WG_ROWS)) {
      return bad;
    }
  }
  const int launch_smem = smem + (epi.residual != nullptr ? RESIDUAL_SMEM : 0);
  if (launch_smem > SMEM_LIMIT) return bad;  // no room for the residual's barriers past this plan
  const auto s = static_cast<cudaStream_t>(stream);
#define FC_TILE(BN_, NC_)                                                                                 \
  if (BN == BN_ && BM == NC_ * WG_ROWS)                                                                   \
    return launch_kind<CodeT, BN_, NC_>(x_map, y_map, r_map, x, q, scale, y, epi, M, K, N, stages,        \
                                        launch_smem, blocks, a_mode, store_tma, s);
  FC_TILE(8, 1) FC_TILE(16, 1) FC_TILE(32, 1) FC_TILE(64, 1) FC_TILE(128, 1)
  FC_TILE(8, 2) FC_TILE(16, 2) FC_TILE(32, 2) FC_TILE(64, 2) FC_TILE(128, 2)
  FC_TILE(8, 4) FC_TILE(16, 4) FC_TILE(32, 4)
#undef FC_TILE
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

// ---- grouped code expansion ----
//
// One launch expands every leaf of a group (the six depthwise kernels of a
// forward): out[offset_s + i] = float(q_s[i]) * scale_s[i % n_s]. The
// segment table travels by value as a kernel parameter (no host-to-device
// copy, no table in device memory). Work is cut into units of 4 codes; the
// grid covers the units of all segments end to end, and a thread finds its
// segment by scanning the <= 16 prefix offsets. A unit moves as one 32-bit
// load of codes and one float4 store where its codes are 4-byte aligned and
// its output slice 16-byte aligned (the host starts each slice at a
// multiple of 4 floats); a segment's ragged last unit, or every unit of a
// misaligned view, takes the scalar path. Each element is one f32 multiply
// of its exactly converted code, so the result is bitwise the plain
// version's whatever path it took.
//
// What bounds it on an H100: nothing on the device. A forward's six leaves
// hold 6,048 codes, ~33 KB of traffic (0.01 us at 3.35 TB/s); one launch
// and the wrapper's host work are the whole cost, which is why the six
// expansions share one launch.

constexpr int MAX_SEGMENTS = 16;
constexpr int CODES_PER_UNIT = 4;  // one 32-bit load of 1-byte codes
constexpr int CODES_THREADS = 256;

// Mirrored field for field by dequant.py's _CodeSegments (ctypes).
struct CodeSegments {
  const void* q[MAX_SEGMENTS];             // each leaf's codes, contiguous
  const float* scale[MAX_SEGMENTS];        // each leaf's [n] scales
  long long out_offset[MAX_SEGMENTS];      // first float of the leaf's slice, a multiple of 4
  long long numel[MAX_SEGMENTS];           // codes in the leaf
  long long unit_start[MAX_SEGMENTS + 1];  // prefix sums of ceil(numel / 4)
  int n[MAX_SEGMENTS];                     // the leaf's last-axis size
  int count;                               // segments in use, 1..MAX_SEGMENTS
};

template <typename CodeT>
__global__ void __launch_bounds__(CODES_THREADS)
dequant_codes_kernel(const CodeSegments table, float* __restrict__ out) {
  const long long unit = static_cast<long long>(blockIdx.x) * CODES_THREADS + threadIdx.x;
  if (unit >= table.unit_start[table.count]) return;
  int s = 0;
  while (unit >= table.unit_start[s + 1]) ++s;
  const CodeT* q = static_cast<const CodeT*>(table.q[s]);
  const float* scale = table.scale[s];
  const long long numel = table.numel[s];
  const int n = table.n[s];
  float* o = out + table.out_offset[s];
  const long long e = CODES_PER_UNIT * (unit - table.unit_start[s]);
  int col = static_cast<int>(e % n);
  // The same for every unit of a segment.
  const bool aligned = (reinterpret_cast<uintptr_t>(q) % 4) == 0 &&
                       (reinterpret_cast<uintptr_t>(o) % 16) == 0;
  if (aligned && e + CODES_PER_UNIT <= numel) {
    const uint32_t packed = *reinterpret_cast<const uint32_t*>(q + e);
    CodeT codes[CODES_PER_UNIT];
    memcpy(codes, &packed, sizeof(packed));
    float v[CODES_PER_UNIT];
#pragma unroll
    for (int j = 0; j < CODES_PER_UNIT; ++j) {
      v[j] = code_to_float(codes[j]) * scale[col];
      if (++col == n) col = 0;
    }
    *reinterpret_cast<float4*>(o + e) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    const long long end = e + CODES_PER_UNIT < numel ? e + CODES_PER_UNIT : numel;
    for (long long i = e; i < end; ++i) {
      o[i] = code_to_float(q[i]) * scale[col];
      if (++col == n) col = 0;
    }
  }
}

// Checks the table's invariants (the host builds them; a table that breaks
// one would address outside its slices), then launches over all units.
template <typename CodeT>
int launch_codes(const void* table_ptr, void* out, void* stream) {
  const CodeSegments& t = *static_cast<const CodeSegments*>(table_ptr);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (t.count < 1 || t.count > MAX_SEGMENTS || t.unit_start[0] != 0) return bad;
  long long end = 0;  // end of the previous slice
  for (int i = 0; i < t.count; ++i) {
    if (t.n[i] < 1 || t.numel[i] < 0 || t.numel[i] % t.n[i] != 0) return bad;
    if (t.out_offset[i] % CODES_PER_UNIT != 0 || t.out_offset[i] < end) return bad;
    const long long units = (t.numel[i] + CODES_PER_UNIT - 1) / CODES_PER_UNIT;
    if (t.unit_start[i + 1] != t.unit_start[i] + units) return bad;
    end = t.out_offset[i] + t.numel[i];
  }
  const long long units = t.unit_start[t.count];
  if (units == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (units + CODES_THREADS - 1) / CODES_THREADS;
  dequant_codes_kernel<CodeT><<<static_cast<unsigned int>(blocks), CODES_THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(t, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched) or the error that refused the launch.
extern "C" {

// The tile plan's BM, BN, stages, shared-memory bytes and blocks come from
// dequant.py's matmul_tile_plan; a plan this file does not launch is refused.
// The epilogue (dequant_common.cuh): table, [4][table_stride] floats (bias,
// mean, inv, beta), null for no epilogue; residual, [M, N] (16-byte
// aligned) or null; kind, one of EPI_*.
int fc_dequant_matmul_i8(const void* x, const void* q, const void* scale, void* y, const void* table,
                         const void* residual, int table_stride, int kind, int M, int K, int N, int BM, int BN,
                         int stages, int smem, int blocks, void* stream) {
  return launch_matmul<int8_t>(x, q, scale, y, fc::make_epilogue(table, residual, table_stride, kind), M, K, N, BM,
                               BN, stages, smem, blocks, stream);
}

int fc_dequant_matmul_e4m3(const void* x, const void* q, const void* scale, void* y, const void* table,
                           const void* residual, int table_stride, int kind, int M, int K, int N, int BM, int BN,
                           int stages, int smem, int blocks, void* stream) {
  return launch_matmul<__nv_fp8_e4m3>(x, q, scale, y, fc::make_epilogue(table, residual, table_stride, kind), M, K,
                                      N, BM, BN, stages, smem, blocks, stream);
}

// table: a CodeSegments in host memory, read before the launch returns;
// out: the arena that holds every segment's slice.
int fc_dequant_codes_i8(const void* table, void* out, void* stream) {
  return launch_codes<int8_t>(table, out, stream);
}

int fc_dequant_codes_e4m3(const void* table, void* out, void* stream) {
  return launch_codes<__nv_fp8_e4m3>(table, out, stream);
}

}  // extern "C"
