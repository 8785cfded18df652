// Hand-written Hopper (sm_90a) kernels of the quantized serving path.
//
// They replace the two Pallas kernels of fedcrack_tpu/kernels/dequant.py:
//
// * dequant_matmul_kernel <- _matmul_kernel (via _dequant_matmul_pallas):
//   y[M,N] = (x[M,K] f32 @ float(q[K,N] codes)) * scale[N], with int8 or
//   fp8 e4m3 codes. Every 1x1 and 3x3 conv of the fused U-Net forward
//   (kernels/forward.py) lands here in im2col form.
// * dequant_codes_kernel <- _dequant_kernel (via _dequant_codes_pallas):
//   out[i] = float(q[i]) * scale[i % N], the depthwise-kernel expansion.
//
// Contract (held against the plain PyTorch versions in dequant.py):
//
// * f32 activations, f32 accumulation in plain FMA: no TF32 and no int8/fp8
//   tensor-core product, because the JAX contract accumulates the f32
//   activations against the dequantized codes in f32.
// * Codes are converted to float when their tile is staged into shared
//   memory; the per-output-channel scale multiplies the finished
//   accumulator once, in the epilogue, as the Pallas kernel does after its
//   last K block.
// * Deterministic: every output tile owns its whole K loop, in order. There
//   is no split-K and there are no atomics, so a run is bitwise repeatable
//   and an output entry does not depend on which rows share its batch.
// * The ragged edges of M, K and N are masked in the kernel (zero-filled
//   tiles, guarded stores); the caller pads nothing.
//
// What bounds it on an H100: the f32 FMA rate of the CUDA cores (67 TFLOP/s
// at 700 W) for the deep decoder GEMMs (K = 2304, N = 256), and device
// memory (3.35 TB/s) for the wide, shallow ones, where the im2col
// activations (M = 131072 rows at bucket 256 x batch 8) are most of the
// bytes. This first version is a classic shared-memory SGEMM tile
// (64 x 64 x 16, a 4 x 4 register tile per thread). Feeding wgmma through
// TMA, or running e4m3 codes on the fp8 tensor cores against a rescaled
// fp8 activation, is later work that would change the accumulation
// contract and needs its own parity bound.

#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float code_to_float(int8_t c) {
  return static_cast<float>(c);
}

__device__ __forceinline__ float code_to_float(__nv_fp8_e4m3 c) {
  return static_cast<float>(c);
}

constexpr int BM = 64;  // rows of x / y per block
constexpr int BN = 64;  // output channels per block
constexpr int BK = 16;  // depth of one staged K tile
constexpr int TM = 4;   // rows per thread
constexpr int TN = 4;   // channels per thread
constexpr int ROW_THREADS = BM / TM;  // 16
constexpr int COL_THREADS = BN / TN;  // 16
constexpr int MATMUL_THREADS = ROW_THREADS * COL_THREADS;  // 256

template <typename CodeT>
__global__ void __launch_bounds__(MATMUL_THREADS)
dequant_matmul_kernel(const float* __restrict__ x, const CodeT* __restrict__ q,
                      const float* __restrict__ scale, float* __restrict__ y,
                      int M, int K, int N) {
  // x tile stored transposed (k-major) so the inner loop reads rows of it;
  // +4 columns of padding spread the transposing stores over the banks.
  __shared__ float xs[BK][BM + 4];
  __shared__ float qs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int tcol = tid % COL_THREADS;
  const int trow = tid / COL_THREADS;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Stage x[m0:m0+BM, k0:k0+BK]: neighbouring threads read neighbouring k
    // of one row, zero outside the matrix.
#pragma unroll
    for (int i = tid; i < BM * BK; i += MATMUL_THREADS) {
      const int r = i / BK;
      const int c = i % BK;
      const long long gm = m0 + r;
      const int gk = k0 + c;
      xs[c][r] = (gm < M && gk < K) ? x[gm * K + gk] : 0.0f;
    }
    // Stage the code tile q[k0:k0+BK, n0:n0+BN], converted to float here.
#pragma unroll
    for (int i = tid; i < BK * BN; i += MATMUL_THREADS) {
      const int r = i / BN;
      const int c = i % BN;
      const int gk = k0 + r;
      const int gn = n0 + c;
      qs[r][c] = (gk < K && gn < N)
                     ? code_to_float(q[static_cast<long long>(gk) * N + gn])
                     : 0.0f;
    }
    __syncthreads();

    // Thread (trow, tcol) owns rows trow + 16 i and channels tcol + 16 j:
    // the channel reads of a warp are 16 consecutive words (no bank
    // conflict) and the row reads are broadcasts.
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      float b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][trow + i * ROW_THREADS];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = qs[kk][tcol + j * COL_THREADS];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // Epilogue: the scale multiplies the finished accumulator once.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long gm = m0 + trow + i * ROW_THREADS;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tcol + j * COL_THREADS;
      if (gn < N) y[gm * N + gn] = acc[i][j] * scale[gn];
    }
  }
}

constexpr int CODES_PER_THREAD = 16;  // one 16-byte load of 1-byte codes
constexpr int CODES_THREADS = 256;

template <typename CodeT>
__global__ void __launch_bounds__(CODES_THREADS)
dequant_codes_kernel(const CodeT* __restrict__ q, const float* __restrict__ scale,
                     float* __restrict__ out, long long total, int N) {
  const long long base =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) *
      CODES_PER_THREAD;
  if (base >= total) return;
  // The alignment test is the same for every thread (base is a multiple of
  // 16), so a misaligned view takes the scalar path everywhere.
  const bool aligned = (reinterpret_cast<uintptr_t>(q) % 16) == 0 &&
                       (reinterpret_cast<uintptr_t>(out) % 16) == 0;
  if (aligned && base + CODES_PER_THREAD <= total) {
    const uint4 packed = *reinterpret_cast<const uint4*>(q + base);
    const CodeT* codes = reinterpret_cast<const CodeT*>(&packed);
    int col = static_cast<int>(base % N);
    float v[CODES_PER_THREAD];
#pragma unroll
    for (int j = 0; j < CODES_PER_THREAD; ++j) {
      v[j] = code_to_float(codes[j]) * scale[col];
      if (++col == N) col = 0;
    }
    float4* o = reinterpret_cast<float4*>(out + base);
#pragma unroll
    for (int j = 0; j < CODES_PER_THREAD / 4; ++j) {
      o[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    }
  } else {
    const long long end =
        base + CODES_PER_THREAD < total ? base + CODES_PER_THREAD : total;
    for (long long i = base; i < end; ++i) {
      out[i] = code_to_float(q[i]) * scale[i % N];
    }
  }
}

template <typename CodeT>
int launch_matmul(const void* x, const void* q, const void* scale, void* y,
                  int M, int K, int N, void* stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  dequant_matmul_kernel<CodeT><<<grid, MATMUL_THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const CodeT*>(q),
      static_cast<const float*>(scale), static_cast<float*>(y), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename CodeT>
int launch_codes(const void* q, const void* scale, void* out, long long total,
                 int N, void* stream) {
  const long long groups = (total + CODES_PER_THREAD - 1) / CODES_PER_THREAD;
  const long long blocks = (groups + CODES_THREADS - 1) / CODES_THREADS;
  dequant_codes_kernel<CodeT><<<static_cast<unsigned int>(blocks),
                                CODES_THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const CodeT*>(q), static_cast<const float*>(scale),
      static_cast<float*>(out), total, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Each entry point launches on the
// given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched).
extern "C" {

int fc_dequant_matmul_i8(const void* x, const void* q, const void* scale,
                         void* y, int M, int K, int N, void* stream) {
  return launch_matmul<int8_t>(x, q, scale, y, M, K, N, stream);
}

int fc_dequant_matmul_e4m3(const void* x, const void* q, const void* scale,
                           void* y, int M, int K, int N, void* stream) {
  return launch_matmul<__nv_fp8_e4m3>(x, q, scale, y, M, K, N, stream);
}

int fc_dequant_codes_i8(const void* q, const void* scale, void* out,
                        long long total, int N, void* stream) {
  return launch_codes<int8_t>(q, scale, out, total, N, stream);
}

int fc_dequant_codes_e4m3(const void* q, const void* scale, void* out,
                          long long total, int N, void* stream) {
  return launch_codes<__nv_fp8_e4m3>(q, scale, out, total, N, stream);
}

}  // extern "C"
