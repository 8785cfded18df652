// Device helpers shared by the dequant kernels (dequant.cu, dequant_conv.cu):
// the exact code-to-float conversion and the three-term bf16 split of an f32
// activation, whose arithmetic both kernels' contracts rest on; the fused
// epilogue (scale, bias, BatchNorm, ReLU, residual) both apply; and the
// Hopper machinery both are built from: mbarriers, TMA loads and stores,
// the 64-byte swizzle of a K-major wgmma B tile and its descriptor,
// ldmatrix, named barriers, and wgmma.mma_async with A from registers.

#pragma once

#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime, no -lcuda
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace fc {

__device__ __forceinline__ float code_to_float(int8_t c) {
  return static_cast<float>(c);
}

__device__ __forceinline__ float code_to_float(__nv_fp8_e4m3 c) {
  return static_cast<float>(c);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  uint32_t bits;
  memcpy(&bits, &v, sizeof(bits));
  return bits;
}

// Two neighbouring-k activations into their hi/mid/lo bf16 pairs (the lower
// k in the low half, as the MMA fragment wants).
__device__ __forceinline__ void split3(float2 v, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = v.x - hf.x;  // exact: x minus its nearest bf16
  const float r1 = v.y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  hi = bf16x2_bits(h);
  mid = bf16x2_bits(m);
  lo = bf16x2_bits(l);
}

// ---- the epilogue of the two contractions ----

// What follows the scale, per output channel n, in dequant_matmul_kernel's
// and dequant_conv3x3_kernel's epilogue (dequant.py's Epilogue), in this
// order:
//   v = acc * scale[n]
//   v = v + bias[n]
//   v = ((v - mean[n]) * inv[n]) + beta[n]   (eval BatchNorm, inv = gamma * rsqrt(var + eps))
//   v = relu(v)                              (torch.relu's: NaN passes, fmaxf otherwise)
//   v = r + v                                (r: the residual, in the output's layout)
// Each step is one correctly rounded f32 operation (__fmul_rn, __fadd_rn,
// __fsub_rn: nvcc's default -fmad=true would contract a multiply and an add
// into an FMA), so a fused launch gives bit for bit what the launch without
// an epilogue followed by torch's elementwise kernels gives. A launch runs
// one of the mixes the forward has (its kind), each kind a kernel
// instantiation of its own (EPI_AFFINE_RELU runs as EPI_AFFINE with the
// ReLU a select), so no kind's code or registers weigh on another's:
// * EPI_NONE: no epilogue; the scale alone.
// * EPI_AFFINE, EPI_AFFINE_RELU: the bias and the BatchNorm, then a ReLU
//   (the forward's stem, pointwise and decoder convs).
// * EPI_BIAS_RESIDUAL: the bias, then the residual where there is one
//   (-0.0 where there is none: -0.0 + v is v, bit for bit): the forward's
//   residual convs and its head. The GEMM only.
struct Epilogue {
  const float* table;     // [EPI_VECTORS][stride]: bias, mean, inv, beta; null: no epilogue
  const float* residual;  // the output's shape and layout, 16-byte aligned; null: none
  int stride;             // a row of the table: a multiple of 128 columns, past every column block
  int kind;               // EPI_*
};

constexpr int EPI_VECTORS = 4;  // bias, mean, inv, beta
enum : int { EPI_NONE = 0, EPI_AFFINE, EPI_AFFINE_RELU, EPI_BIAS_RESIDUAL };

// The rows of the table at columns n0 .. n0 + bn - 1 into L1, in flight
// while the K loop runs, so the epilogue's reads of them hit (the GEMM's):
// thread ct prefetches one 128-byte line, of row ct / lines (a column block
// of at most 32 columns lies in one line, n0 being a multiple of its
// width).
__device__ __forceinline__ void prefetch_vectors(const Epilogue& e, int bn, int ct, int n0) {
  const int lines = (bn + 31) / 32;
  if (e.kind == EPI_NONE || ct >= EPI_VECTORS * lines) return;
  const float* at = e.table + (ct / lines) * e.stride + n0 + (ct % lines) * 32;
  asm volatile("prefetch.global.L1 [%0];\n" :: "l"(at));
}

// The per-channel vectors of two neighbouring output channels (the first
// even).
struct ChannelPair {
  float2 bias, mean, inv, beta;
};

// Columns c and c + 1 (c even) of the rows kind K uses, of the vectors at
// v, rows `stride` floats apart: the table in device memory (the GEMM) or
// its column block staged in shared memory (the conv).
template <int K>
__device__ __forceinline__ ChannelPair channel_pair(const float* v, int stride, int c) {
  ChannelPair p = {};
  if constexpr (K != EPI_NONE) p.bias = *reinterpret_cast<const float2*>(v + c);
  if constexpr (K == EPI_AFFINE) {
    p.mean = *reinterpret_cast<const float2*>(v + stride + c);
    p.inv = *reinterpret_cast<const float2*>(v + 2 * stride + c);
    p.beta = *reinterpret_cast<const float2*>(v + 3 * stride + c);
  }
  return p;
}

// The table's columns n0 .. n0 + bn - 1 into dst ([EPI_VECTORS][bn]
// floats, the conv's): thread ct < bn copies column n0 + ct of each row,
// its four loads in flight together.
__device__ __forceinline__ void stage_vectors(const Epilogue& e, float* dst, int bn, int ct, int n0) {
  if (ct >= bn) return;
  float v[EPI_VECTORS];
#pragma unroll
  for (int i = 0; i < EPI_VECTORS; ++i) v[i] = __ldg(e.table + i * e.stride + n0 + ct);
#pragma unroll
  for (int i = 0; i < EPI_VECTORS; ++i) dst[i * bn + ct] = v[i];
}

// torch.relu on the card: clamp_min(v, 0), which passes NaN and otherwise
// takes max(v, 0) (so -0.0 becomes +0.0).
__device__ __forceinline__ float relu_torch(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }

// One output: the scale, then the steps of kind K (EPI_NONE, EPI_AFFINE or
// EPI_BIAS_RESIDUAL); relu: EPI_AFFINE's ReLU, where the launch's kind is
// EPI_AFFINE_RELU.
template <int K>
__device__ __forceinline__ float epilogue_value(float acc, float scale, float bias, float mean, float inv,
                                                float beta, float r, bool relu) {
  float v = __fmul_rn(acc, scale);
  if constexpr (K != EPI_NONE) v = __fadd_rn(v, bias);
  if constexpr (K == EPI_AFFINE) v = __fadd_rn(__fmul_rn(__fsub_rn(v, mean), inv), beta);
  if constexpr (K == EPI_AFFINE) v = relu ? relu_torch(v) : v;
  if constexpr (K == EPI_BIAS_RESIDUAL) v = __fadd_rn(r, v);
  return v;
}

// Both outputs of a channel pair.
template <int K>
__device__ __forceinline__ float2 epilogue_pair(float acc0, float acc1, float2 scale, const ChannelPair& c,
                                                float2 r, bool relu) {
  return make_float2(epilogue_value<K>(acc0, scale.x, c.bias.x, c.mean.x, c.inv.x, c.beta.x, r.x, relu),
                     epilogue_value<K>(acc1, scale.y, c.bias.y, c.mean.y, c.inv.y, c.beta.y, r.y, relu));
}

// One code of a 32-bit word of four 1-byte codes, byte j.
template <typename CodeT>
__device__ __forceinline__ float byte_code(uint32_t word, int j) {
  const unsigned char byte = static_cast<unsigned char>(word >> (8 * j));
  CodeT code;
  memcpy(&code, &byte, 1);
  return code_to_float(code);
}

// ---- the K-major wgmma B layout ----

// A column's 32 k of codes in bf16 (64 bytes) is one row of the 64-byte
// swizzle (wgmma's B64 layout): the row's 16-byte chunk c of row r sits at
// chunk c ^ ((r >> 1) & 3), so 8 neighbouring rows fall in 8 different bank
// groups. The pattern repeats every 8 rows (an atom of 512 bytes).
constexpr int B_ROW_BYTES = 64;
constexpr int B_ATOM_BYTES = 8 * B_ROW_BYTES;

__host__ __device__ constexpr int swizzle64(int row, int chunk) {
  return row * B_ROW_BYTES + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// Descriptor of a K-major B tile in the 64-byte swizzle: each column's 32
// k (64 bytes) a row, 8-row atoms of 512 bytes one after another (the
// stride byte offset); the leading byte offset is unused in this layout.
// A k16 step starts 32 bytes into the row.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ULL << 16) |
         (static_cast<uint64_t>(B_ATOM_BYTES >> 4) << 32) | (2ULL << 62);
}

// ---- mbarriers, TMA, fences, named barriers ----

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// An arrival that also expects `bytes` of transactions (the TMA load's).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// The box at (c0, c1) of a 2-D tensor map into shared memory at dst,
// completing on the mbarrier bar.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The box at (c0, c1, c2, c3) of a 4-D tensor map.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// Shared memory at src into the box at (c0, c1) of a 2-D tensor map; what
// lies outside the tensor is not written. Tracked by the issuing thread's
// bulk groups.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// This thread's bulk stores but the last PENDING groups have read their
// shared memory.
template <int PENDING>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(PENDING) : "memory");
}

// Generic-proxy writes to shared memory, made visible to the async proxy
// (wgmma's operand reads, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, which lands in register i.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// ---- wgmma ----

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(PENDING) : "memory");
}

// Keeps the compiler from moving accumulator accesses across a point where
// wgmma may still be writing them.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[64 x BN] += a[64 x 16] (registers, bf16) @ b[16 x BN] (shared, bf16).
// Accumulator d[4j + 2i + e] is row 16 warp + g + 8i, column 8j + 2t + e;
// a holds rows g and g + 8 at k 2t (a[0], a[1]) and 2t + 8 (a[2], a[3]),
// mma.sync m16n8k16's fragment (g = lane / 4, t = lane % 4).
template <int BN>
struct Mma;

template <>
struct Mma<8> {
  static __device__ __forceinline__ void run(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
          "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// ---- host: the epilogue's arguments, the TMA tensor-map encoder ----

inline Epilogue make_epilogue(const void* table, const void* residual, int stride, int kind) {
  return {static_cast<const float*>(table), static_cast<const float*>(residual), stride, kind};
}

// What the kernels assume of an epilogue over n output channels: no table
// and no residual for EPI_NONE; else a table (8-byte aligned, rows of a
// multiple of 128 columns, at least n), and a residual only for
// EPI_BIAS_RESIDUAL, 16-byte aligned.
inline bool epilogue_ok(const Epilogue& e, int n) {
  if (e.kind == EPI_NONE) return e.table == nullptr && e.residual == nullptr;
  if (e.kind < EPI_NONE || e.kind > EPI_BIAS_RESIDUAL || e.table == nullptr) return false;
  if (e.residual != nullptr && (e.kind != EPI_BIAS_RESIDUAL || reinterpret_cast<uintptr_t>(e.residual) % 16 != 0)) {
    return false;
  }
  return reinterpret_cast<uintptr_t>(e.table) % 8 == 0 && e.stride % 128 == 0 && e.stride >= n;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found once through the runtime.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                      : nullptr;
  }();
  return fn;
}

}  // namespace fc
