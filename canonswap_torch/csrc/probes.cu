// The three toolchain probe kernels, for Hopper (sm_90a).
//
// Replace the Pallas probes of the JAX package's tools:
//
//   probes_gather  tools/profile_r2b.py::dyn_gather -> dg_kernel
//                  out[b, r, c] = x[b, idx[b, r, c], c]
//                  (take_along_axis over the row axis, once per batch element)
//   probes_double  tools/profile_r2c.py::dbl -> dbl_kernel
//                  out = x * 2
//   probes_matmul  tools/profile_r2c.py::mm -> mm_kernel
//                  out = a @ b, f32 in, f32 sums, f32 out
//
// The TPU kernels load each whole array into VMEM as one block and compute
// there.  Here none of them holds more than a tile on chip.
//
// Gather.  One thread per output element over (B, R, C).  The index follows
// JAX's semantics: an index in [-R, 0) wraps to index + R, and one outside
// [-R, R) gives NaN (take_along_axis's fill mode).  Neighbouring threads read
// neighbouring indices and write neighbouring outputs (coalesced); their
// reads of x land on unrelated rows, one 32-byte sector each.  What bounds it
// on the H100: bytes.  At the probe's shape (B = 16, R = 1024, C = 2048, f32
// x, int32 idx) it reads 16 x 8 MiB of x and of idx and writes 16 x 8 MiB:
// 403 MB, 0.120 ms at 3.35 TB/s.  Each batch element's 8 MiB of x fits the
// 50 MB L2, so the scattered sector reads should mostly hit there.
//
// Doubling.  One elementwise pass, four floats a thread where the size
// allows (16-byte loads and stores).  Bound: bytes (1 MiB at the probe's
// (256, 512)), which is far below a launch's cost.
//
// Matmul.  A shared-memory tiled f32 kernel: 64 x 32 output tiles, 16-deep
// k steps, 128 threads each holding a 4 x 4 block of sums in registers and
// updating it with fmaf from the tiles in shared memory.  No tensor cores:
// the contract is f32 arithmetic (TF32 would keep 10 bits of mantissa).
// Bound: operations, 268 MFLOP at (512, 512) @ (512, 512), 4.0 us at
// 67 TFLOP/s f32; the 512 x 512 output gives 128 tiles, about one per SM.
//
// Every entry point returns the cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) gather_kernel(const float* __restrict__ x,
                                                          const int* __restrict__ idx,
                                                          float* __restrict__ out, int R,
                                                          int C, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int64_t plane = (int64_t)R * C;
  const int64_t b = i / plane;
  const int c = (int)(i % C);
  int j = __ldg(idx + i);
  if (j < 0) j += R;
  // the quiet NaN PyTorch writes for float("nan")
  out[i] = (j >= 0 && j < R) ? __ldg(x + b * plane + (int64_t)j * C + c)
                             : __int_as_float(0x7fc00000);
}

__global__ void __launch_bounds__(kThreads) double_kernel(const float* __restrict__ x,
                                                          float* __restrict__ out,
                                                          int64_t n, int vec4) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t base = 4 * i;
  if (vec4 && base + 3 < n) {
    float4 v = __ldg(reinterpret_cast<const float4*>(x) + i);
    v.x *= 2.0f;
    v.y *= 2.0f;
    v.z *= 2.0f;
    v.w *= 2.0f;
    reinterpret_cast<float4*>(out)[i] = v;
  } else {
    for (int64_t k = base; k < n && k < base + 4; ++k) out[k] = x[k] * 2.0f;
  }
}

constexpr int kBM = 64;  // rows of a tile
constexpr int kBN = 32;  // columns of a tile
constexpr int kBK = 16;  // depth of one k step
constexpr int kTM = 4;   // rows of a thread's block of sums
constexpr int kTN = 4;   // columns of a thread's block of sums
constexpr int kMmThreads = (kBM / kTM) * (kBN / kTN);  // 128

__global__ void __launch_bounds__(kMmThreads) matmul_kernel(const float* __restrict__ a,
                                                            const float* __restrict__ b,
                                                            float* __restrict__ out, int M,
                                                            int K, int N) {
  // a's tile stored k-major so a thread's 4 rows are adjacent; one column
  // of padding spreads the 16 k of one row's store over 16 banks
  __shared__ float as[kBK][kBM + 1];
  __shared__ float bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);  // 0..7: column block
  const int ty = tid / (kBN / kTN);  // 0..15: row block
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // a: 64 x 16 = 1024 values, 8 a thread; consecutive threads take
    // consecutive k of one row (reads along a's rows)
#pragma unroll
    for (int e = tid; e < kBM * kBK; e += kMmThreads) {
      const int r = e / kBK, k = e % kBK;
      const int gr = row0 + r, gk = k0 + k;
      as[k][r] = (gr < M && gk < K) ? a[(int64_t)gr * K + gk] : 0.0f;
    }
    // b: 16 x 32 = 512 values, 4 a thread, along b's rows
#pragma unroll
    for (int e = tid; e < kBK * kBN; e += kMmThreads) {
      const int k = e / kBN, cc = e % kBN;
      const int gk = k0 + k, gc = col0 + cc;
      bs[k][cc] = (gk < K && gc < N) ? b[(int64_t)gk * N + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = as[k][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = bs[k][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gr = row0 + ty * kTM + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gc = col0 + tx * kTN + j;
      if (gc < N) out[(int64_t)gr * N + gc] = acc[i][j];
    }
  }
}

}  // namespace

// x (B, R, C) f32, idx (B, R, C) int32, out (B, R, C) f32: contiguous device
// tensors.
extern "C" int probes_gather(const void* x, const void* idx, void* out, int B, int R, int C,
                             void* stream) {
  if (B < 0 || R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)B * R * C;
  if (total == 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  gather_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx), static_cast<float*>(out), R, C,
      total);
  return (int)cudaGetLastError();
}

// x and out: n contiguous f32 values on the device.  Four a thread with
// 16-byte accesses where n divides by 4 and both pointers are 16-byte
// aligned, else one at a time.
extern "C" int probes_double(const void* x, void* out, int64_t n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int vec4 = (n % 4 == 0) && ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const int64_t threads = (n + 3) / 4;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  double_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, vec4);
  return (int)cudaGetLastError();
}

// a (M, K), b (K, N), out (M, N): contiguous f32 device tensors.
extern "C" int probes_matmul(const void* a, const void* b, void* out, int M, int K, int N,
                             void* stream) {
  if (M < 0 || K < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const dim3 grid((unsigned)((N + kBN - 1) / kBN), (unsigned)((M + kBM - 1) / kBM));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  matmul_kernel<<<grid, kMmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out), M, K,
      N);
  return (int)cudaGetLastError();
}

extern "C" const char* probes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
