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
//   range. They are converted to bf16 as their tile is staged into shared
//   memory.
// * The f32 activation is split in registers into three bf16 terms,
//   hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), which carry
//   x's 24-bit significand (|x - (hi + mid + lo)| <= 2^-24 |x| for normal x
//   of the activations' range). Each term x code product is exact in the
//   tensor core (8 x 8 significant bits), and the sums accumulate in f32
//   registers: three mma.sync per 16-deep K step against the same B
//   fragment, lo then mid then hi. What differs from the plain f32 product
//   is the order and rounding of the f32 sums, the same float reassociation
//   as the JAX kernel's K blocking, so an entry stays within one
//   per-channel scale of x @ (q * scale) (the JAX bound; in code units the
//   sums' rounding error is orders of magnitude below 1).
// * The per-output-channel scale multiplies the finished accumulator once,
//   in the epilogue, as the Pallas kernel does after its last K block.
// * Deterministic: every output tile owns its whole K loop, in order; no
//   split-K, no atomics. An entry's sum is the same sequence of MMAs over
//   16-deep K steps whatever tile the launch picked, so it depends on K and
//   N only, never on M: a served image's result does not depend on how many
//   rows share its launch.
// * Ragged M, K and N are masked in the kernel (zero-filled copies, guarded
//   stores); the caller pads nothing.
//
// What bounds it on an H100, and what the design does about it: at bucket
// 256 x batch 8 the 1x1 GEMMs (K = 27..256) are bound by device-memory
// bytes (0.11 ms at 3.35 TB/s). So A goes through a 3-stage cp.async ring
// (16-byte copies, zero-filled at the edges) that keeps two K tiles in
// flight while the tensor cores run; B (small) is prefetched into registers
// a stage ahead and stored converted.
// The N tile fits the layer (8 for the head's N = 1, up to 128), and the M
// tile (64 or 128) is picked so that small-M GEMMs still fill 132 SMs. Each
// warp owns a 32 x 32 output tile (16 rows in a 64 x 32 block, fewer
// columns for small N) and issues its MMAs term-major, so back-to-back MMAs
// never wait on each other.
// mma.sync.m16n8k16 is used instead of wgmma: at these K the bytes, not the
// tensor cores, bound the GEMM, and the three-term split is cheapest on
// mma.sync's fragments.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "dequant_common.cuh"

namespace {

using fc::bf16x2_bits;
using fc::code_to_float;
using fc::smem_u32;
using fc::split3;

constexpr int BK = 32;            // K depth of one staged tile: two k16 MMA steps
constexpr int STAGES = 3;         // cp.async ring depth
constexpr int A_STRIDE = BK + 8;  // floats per staged A row (conflict-free float2 reads)
constexpr int B_STRIDE = BK + 8;  // bf16 per staged B column (conflict-free 32-bit reads)
constexpr int MAX_WARP_N = 32;    // columns per warp: up to four n8 tiles

// Rows per warp: two m16 tiles, or one where a 64-row block no wider than
// 32 columns would otherwise have only two warps to hide latency with.
__host__ __device__ constexpr int warp_m(int bm, int bn) { return bm == 64 && bn <= 32 ? 16 : 32; }
__host__ __device__ constexpr int warp_n(int bn) { return bn < MAX_WARP_N ? bn : MAX_WARP_N; }
__host__ __device__ constexpr int tile_threads(int bm, int bn) {
  return 32 * (bm / warp_m(bm, bn)) * (bn / warp_n(bn));
}
__host__ __device__ constexpr int tile_smem(int bm, int bn) {
  return STAGES * (bm * A_STRIDE * 4 + bn * B_STRIDE * 2);
}

// src_bytes = 0 reads nothing and zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Not volatile: the compiler may interleave independent MMAs; the "+f"
// operands keep each accumulator's own sequence in order.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The GEMM body: x[M, K] row-major. vec: K % 4 == 0 and x 16-byte aligned,
// so A moves in 16-byte copies; else in 4-byte ones.
template <typename CodeT, int BM, int BN>
__device__ __forceinline__ void mma_body(const float* __restrict__ x,
                                         const CodeT* __restrict__ q,
                                         const float* __restrict__ scale,
                                         float* __restrict__ y, int M, int K, int N,
                                         bool vec) {
  constexpr int WARP_M = warp_m(BM, BN);
  constexpr int WARP_N = warp_n(BN);
  constexpr int WM = BM / WARP_M;
  constexpr int THREADS = tile_threads(BM, BN);
  constexpr int MT = WARP_M / 16;  // m16 tiles per warp
  constexpr int NT = WARP_N / 8;   // n8 tiles per warp
  constexpr int CHUNKS_PER_ROW = BK / 4;
  constexpr int A_CHUNKS = BM * CHUNKS_PER_ROW / THREADS;  // 16-byte A chunks per thread
  constexpr int ROWS_PER_PASS = THREADS / CHUNKS_PER_ROW;
  constexpr int B_PAIRS = (BK / 2) * BN / THREADS;  // (k, k+1) code pairs per thread
  static_assert(A_CHUNKS * THREADS == BM * CHUNKS_PER_ROW, "A tile split");
  static_assert(B_PAIRS * THREADS == (BK / 2) * BN && B_PAIRS >= 1, "B tile split");

  extern __shared__ __align__(16) unsigned char smem[];
  float* a_smem = reinterpret_cast<float*>(smem);  // [STAGES][BM][A_STRIDE]
  __nv_bfloat16* b_smem = reinterpret_cast<__nv_bfloat16*>(
      smem + STAGES * BM * A_STRIDE * sizeof(float));  // [STAGES][BN][B_STRIDE], k fastest

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % WM;
  const int wn = warp / WM;
  const int g = lane >> 2;  // MMA group: fragment row / column
  const int t = lane & 3;   // thread in group: fragment k / column pair
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int ktiles = (K + BK - 1) / BK;

  // Each thread copies the same rows and the same 4-wide K column of every
  // A tile: their offsets into x (m * K) are computed once. The host keeps
  // every offset inside 32 bits.
  const int a_col = (tid % CHUNKS_PER_ROW) * 4;
  int a_off[A_CHUNKS];
#pragma unroll
  for (int j = 0; j < A_CHUNKS; ++j) {
    const long long m = m0 + tid / CHUNKS_PER_ROW + j * ROWS_PER_PASS;
    a_off[j] = m < M ? static_cast<int>(m) * K : -1;  // -1: a row past M
  }

  auto load_a = [&](int stage, int k0) {
    float* dst_tile = a_smem + stage * BM * A_STRIDE;
    const int k = k0 + a_col;
#pragma unroll
    for (int j = 0; j < A_CHUNKS; ++j) {
      float* dst = dst_tile + (tid / CHUNKS_PER_ROW + j * ROWS_PER_PASS) * A_STRIDE + a_col;
      const bool row_ok = a_off[j] >= 0;
      if (vec) {
        const bool ok = row_ok && k < K;
        cp_async16(dst, ok ? x + a_off[j] + k : x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = row_ok && k + e < K;
          cp_async4(dst + e, ok ? x + a_off[j] + k + e : x, ok);
        }
      }
    }
  };

  CodeT b_regs[B_PAIRS][2];
  auto fetch_b = [&](int k0) {
#pragma unroll
    for (int j = 0; j < B_PAIRS; ++j) {
      const int p = tid + j * THREADS;
      const int gn = n0 + p % BN;
      const int gk = k0 + 2 * (p / BN);
      const bool n_ok = gn < N;
      CodeT zero;
      memset(&zero, 0, sizeof(zero));
      b_regs[j][0] = (n_ok && gk < K) ? q[static_cast<long long>(gk) * N + gn] : zero;
      b_regs[j][1] = (n_ok && gk + 1 < K) ? q[static_cast<long long>(gk + 1) * N + gn] : zero;
    }
  };
  auto store_b = [&](int stage) {
    __nv_bfloat16* dst_tile = b_smem + stage * BN * B_STRIDE;
#pragma unroll
    for (int j = 0; j < B_PAIRS; ++j) {
      const int p = tid + j * THREADS;
      const __nv_bfloat162 v = __floats2bfloat162_rn(code_to_float(b_regs[j][0]),
                                                     code_to_float(b_regs[j][1]));
      *reinterpret_cast<__nv_bfloat162*>(dst_tile + (p % BN) * B_STRIDE + 2 * (p / BN)) = v;
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    }
  }

  // Prologue: the first STAGES - 1 tiles in flight (one commit group each).
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) {
      load_a(s, s * BK);
      fetch_b(s * BK);
      store_b(s);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile kt have landed
    __syncthreads();              // everyone's have; everyone is done with tile kt - 1
    const int pre = kt + STAGES - 1;
    const bool prefetch = pre < ktiles;
    if (prefetch) {
      load_a(pre % STAGES, pre * BK);  // into the stage tile kt - 1 used
      fetch_b(pre * BK);
    }
    cp_async_commit();

    const float* a_tile = a_smem + (kt % STAGES) * BM * A_STRIDE;
    const __nv_bfloat16* b_tile = b_smem + (kt % STAGES) * BN * B_STRIDE;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a_frag[3][MT][4];  // [lo, mid, hi][m16 tile][fragment register]
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* r0 = a_tile + (wm * WARP_M + mt * 16 + g) * A_STRIDE + ks + 2 * t;
        const float* r8 = r0 + 8 * A_STRIDE;
        // Fragment registers: (row g, k 2t), (row g+8, k 2t), (row g, k 2t+8), (row g+8, k 2t+8).
        const float* src[4] = {r0, r8, r0 + 8, r8 + 8};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          split3(*reinterpret_cast<const float2*>(src[i]), a_frag[2][mt][i], a_frag[1][mt][i],
                 a_frag[0][mt][i]);
        }
      }
      uint32_t b_frag[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* col = b_tile + (wn * WARP_N + nt * 8 + g) * B_STRIDE + ks + 2 * t;
        b_frag[nt][0] = *reinterpret_cast<const uint32_t*>(col);
        b_frag[nt][1] = *reinterpret_cast<const uint32_t*>(col + 8);
      }
      // Term-major: the MMAs issued back to back are independent, and every
      // accumulator still takes lo, then mid, then hi of each k16 step.
#pragma unroll
      for (int term = 0; term < 3; ++term) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma_bf16(acc[mt][nt], a_frag[term][mt], b_frag[nt][0], b_frag[nt][1]);
          }
        }
      }
    }
    if (prefetch) store_b(pre % STAGES);
  }
  cp_async_wait<0>();  // no copy outlives the block

  // Epilogue: the scale multiplies the finished accumulator once.
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int gn = n0 + wn * WARP_N + nt * 8 + 2 * t;
    const float s0 = gn < N ? scale[gn] : 0.0f;
    const float s1 = gn + 1 < N ? scale[gn + 1] : 0.0f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const long long gm = m0 + wm * WARP_M + mt * 16 + g;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = gm + 8 * half;
        if (row >= M) continue;
        float* out = y + row * N + gn;
        if (gn < N) out[0] = acc[mt][nt][2 * half] * s0;
        if (gn + 1 < N) out[1] = acc[mt][nt][2 * half + 1] * s1;
      }
    }
  }
}

template <typename CodeT, int BM, int BN>
__global__ void __launch_bounds__(tile_threads(BM, BN))
dequant_matmul_kernel(const float* __restrict__ x, const CodeT* __restrict__ q,
                      const float* __restrict__ scale, float* __restrict__ y,
                      int M, int K, int N, int vec) {
  mma_body<CodeT, BM, BN>(x, q, scale, y, M, K, N, vec != 0);
}

// One launch at a fixed tile.
template <typename CodeT, int BM, int BN>
int launch_tile(const void* x, const void* q, const void* scale, void* y,
                int M, int K, int N, int vec, cudaStream_t stream) {
  constexpr int smem = tile_smem(BM, BN);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  const cudaError_t err = cudaFuncSetAttribute(dequant_matmul_kernel<CodeT, BM, BN>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dequant_matmul_kernel<CodeT, BM, BN><<<grid, tile_threads(BM, BN), smem, stream>>>(
      static_cast<const float*>(x), static_cast<const CodeT*>(q), static_cast<const float*>(scale),
      static_cast<float*>(y), M, K, N, vec);
  return static_cast<int>(cudaGetLastError());
}

long long tile_blocks(int M, int N, int bm, int bn) {
  return static_cast<long long>((M + bm - 1) / bm) * ((N + bn - 1) / bn);
}

constexpr long long SMS = 132;  // H100 SXM

// The tile fits the layer: the narrowest N tile of 8..128 that holds N (wider
// N takes several column blocks); M tile 128 (N tile up to 64) where that
// still gives two blocks per SM, else 64; and where 64-row blocks alone
// would leave SMs idle, the N tile halved down to 32. None of this changes
// an entry's K order.
template <typename CodeT>
int launch_gemm(const void* x, const void* q, const void* scale, void* y,
                int M, int K, int N, int vec, void* stream_ptr) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  constexpr long long OFFSET_LIMIT = 1LL << 31;  // the kernel's A offsets are 32-bit
  if (static_cast<long long>(M) * K >= OFFSET_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  int bn = N <= 8 ? 8 : N <= 16 ? 16 : N <= 32 ? 32 : N <= 64 ? 64 : 128;
  const int bm = bn <= 64 && tile_blocks(M, N, 128, bn) >= 2 * SMS ? 128 : 64;
  while (bm == 64 && bn > 32 && tile_blocks(M, N, 64, bn) < SMS) bn /= 2;
#define FC_TILE(BM_, BN_)                                                          \
  if (bm == BM_ && bn == BN_)                                                      \
    return launch_tile<CodeT, BM_, BN_>(x, q, scale, y, M, K, N, vec, stream);
  FC_TILE(128, 8) FC_TILE(128, 16) FC_TILE(128, 32) FC_TILE(128, 64)
  FC_TILE(64, 8) FC_TILE(64, 16) FC_TILE(64, 32) FC_TILE(64, 64) FC_TILE(64, 128)
#undef FC_TILE
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

template <typename CodeT>
int launch_matmul(const void* x, const void* q, const void* scale, void* y,
                  int M, int K, int N, void* stream) {
  const int vec = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  return launch_gemm<CodeT>(x, q, scale, y, M, K, N, vec, stream);
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

int fc_dequant_matmul_i8(const void* x, const void* q, const void* scale,
                         void* y, int M, int K, int N, void* stream) {
  return launch_matmul<int8_t>(x, q, scale, y, M, K, N, stream);
}

int fc_dequant_matmul_e4m3(const void* x, const void* q, const void* scale,
                           void* y, int M, int K, int N, void* stream) {
  return launch_matmul<__nv_fp8_e4m3>(x, q, scale, y, M, K, N, stream);
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
