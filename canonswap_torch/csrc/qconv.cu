// Dynamic W8A8 convolution (2D and 3D, stride 1, SAME) for Hopper, sm_90a.
//
// Replaces canonswap_tpu/ops/pallas/qconv.py::qconv2d_pallas (`_run` ->
// `_kernel`), whose function is canonswap_tpu/ops/qconv.py::conv2d_w8a8, and
// serves the int8 3D chains (canonswap_tpu/nn/conv3d.py, conv3d_packed /
// conv3d_stacked with int8=True), which are the same conv with a depth axis:
//
//   xq  = clip(rint(x / sx[n]), -127, 127)          per-sample step sx
//   acc = sum over taps and Cin of xq * wq           int32, zero padding
//   y   = fma(float(acc), sx[n] * sw[co], bias[co])  f32, then x's dtype
//
// The plain version is canonswap_torch/ops/qconv.py::conv_w8a8_plain.  The
// steps are those of ops/quant.py: s = max|v| * f32(1/127) + f32(1e-12) in
// f64 (the product is exact there), rounded once to f32.
//
// Four kernels, launched back to back by qconv_forward, after a memset of
// the per-sample maxima:
//
// 1. absmax_kernel: max |x| per sample, a block reduction and one atomicMax
//    per block on the float's bits (non-negative floats order as unsigned).
// 2. quantize_weight_kernel: one block per output channel: its step from
//    max |w[co]|, then w (Cout, Cin, taps) -> wk (Cout, taps, Cp) int8,
//    channels zero-padded, and the bias to f32.  The weight is quantized at
//    every call, as the JAX package does inside its jitted function.
// 3. quantize_act_kernel: x (N, C, P) f32/bf16 (P = D*H*W) -> xq (N, P, Cp)
//    int8, channels contiguous and zero-padded to Cp (a multiple of 32),
//    transposed through shared memory so that reads (along P) and writes
//    (along C) are both coalesced.  IEEE division and rintf (round half to
//    even, as jnp.round), never roundf or __fdividef.
// 4. qconv_gemm_kernel: an implicit GEMM on the int8 tensor cores,
//    M = N*P output points, N = Cout, K = taps * Cp, with
//    mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32.  A block computes a
//    BM x BN tile; each k-step loads two 32-byte k-chunks per row (one tap,
//    32 channels: the input pixel at that tap's offset, or zeros where the
//    tap falls in the padding) with 16-byte cp.async into a 3-stage ring.
//    Each warp owns a 64 x 32 sub-tile (4 x 4 mma tiles).  Inside a 32-byte
//    chunk the bytes are read as 8-byte pairs, which permutes k the same
//    way for A and B and so leaves the dot product unchanged; with 32-byte
//    rows those 64-bit shared loads are free of bank conflicts.  The
//    epilogue dequantizes with one fused multiply-add and writes NC(D)HW.
//
// What bounds it on the H100: at the main path's 512-channel shapes, the
// tensor cores and the shared-memory bandwidth that feeds mma.sync (each
// warp reads 3 KB of fragments per 16 mma); the 32-channel 3D chains move
// more bytes per operation (K = 864).  A narrow tile (BN = 32) serves
// Cout <= 32 so that those chains do not compute four times the outputs.
// wgmma with TMA would lift the fragment-bandwidth bound; that is later work.
//
// Overflow: |acc| <= 127 * 127 * Cin * taps, below 2**31 for every shape of
// the path (at most 127^2 * 512 * 9).  Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ int8_t quantize_one(float v, float step) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, step)), -127.0f), 127.0f);
  return (int8_t)(int)r;
}

// max|v| -> the step, as ops/quant.py::absmax_step: f32(1/127) and f32(1e-12)
__device__ __forceinline__ float step_of(float absmax) {
  const double inv127 = 0x1.0204080000000p-7, eps = 0x1.1979980000000p-40;
  return __double2float_rn(__dadd_rn(__dmul_rn((double)absmax, inv127), eps));
}

// a running max that keeps a NaN, as torch's max does
__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// the max over the block's threads, returned to every thread
__device__ float block_max(float m) {
  __shared__ float part[32];
  __shared__ float result;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (int)(blockDim.x >> 5) ? part[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) result = m;
  }
  __syncthreads();
  return result;
}

// ---------------------------------------------------------------------------
// 1. per-sample max |x| over (C, P); amax zeroed before

template <typename T>
__global__ void __launch_bounds__(256) absmax_kernel(const T* __restrict__ x,
                                                     unsigned* __restrict__ amax, int64_t len) {
  const T* xn = x + (int64_t)blockIdx.y * len;
  float m = 0.0f;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < len;
       i += (int64_t)gridDim.x * blockDim.x)
    m = nan_max(m, fabsf(to_f32(xn[i])));
  m = block_max(m);
  if (threadIdx.x == 0) atomicMax(amax + blockIdx.y, __float_as_uint(m));
}

// ---------------------------------------------------------------------------
// 2. the weight: (Cout, Cin, taps) -> (Cout, taps, Cp) int8, steps, f32 bias

template <typename WT>
__global__ void __launch_bounds__(256) quantize_weight_kernel(
    const WT* __restrict__ w, const void* __restrict__ bias, int bias_bf16,
    int8_t* __restrict__ wk, float* __restrict__ sw, float* __restrict__ b32, int Cin, int Cp,
    int taps) {
  const int co = blockIdx.x;
  const int len = Cin * taps;
  const WT* wc = w + (int64_t)co * len;
  float m = 0.0f;
  for (int i = threadIdx.x; i < len; i += blockDim.x) m = nan_max(m, fabsf(to_f32(wc[i])));
  const float step = step_of(block_max(m));
  int8_t* out = wk + (int64_t)co * taps * Cp;
  for (int i = threadIdx.x; i < taps * Cp; i += blockDim.x) {
    const int tap = i / Cp, c = i - tap * Cp;
    out[i] = c < Cin ? quantize_one(to_f32(wc[(int64_t)c * taps + tap]), step) : (int8_t)0;
  }
  if (threadIdx.x == 0) {
    sw[co] = step;
    if (bias)
      b32[co] = bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[co])
                          : static_cast<const float*>(bias)[co];
  }
}

// ---------------------------------------------------------------------------
// 3. quantize and transpose: (N, C, P) -> (N, P, Cp) int8

constexpr int QP = 64;  // points per tile
constexpr int QC = 32;  // channels per tile

template <typename T>
__global__ void __launch_bounds__(256) quantize_act_kernel(
    const T* __restrict__ x, const float* __restrict__ amax, int8_t* __restrict__ xq,
    int C, int Cp, int64_t P) {
  __shared__ __align__(16) int8_t tile[QP][QC];
  const int n = blockIdx.y;
  const int64_t p0 = (int64_t)blockIdx.x * QP;
  const float step = step_of(amax[n]);
  const T* xn = x + (int64_t)n * C * P;
  int8_t* qn = xq + (int64_t)n * P * Cp;
  const int tid = threadIdx.x;
  const int pl = tid % QP;
  const int cs = tid / QP;  // 0..3
  const int64_t p = p0 + pl;
  for (int c0 = 0; c0 < Cp; c0 += QC) {
#pragma unroll
    for (int j = 0; j < QC / 4; ++j) {
      const int cl = cs + 4 * j;
      const int c = c0 + cl;
      int8_t q = 0;
      if (c < C && p < P) q = quantize_one(to_f32(xn[(int64_t)c * P + p]), step);
      tile[pl][cl] = q;
    }
    __syncthreads();
    if (tid < QP * 2) {
      const int row = tid >> 1, half = tid & 1;
      if (p0 + row < P)
        *reinterpret_cast<int4*>(qn + (p0 + row) * Cp + c0 + half * 16) =
            *reinterpret_cast<const int4*>(&tile[row][half * 16]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// 4. implicit GEMM on the int8 tensor cores

constexpr int STAGES = 3;
constexpr int CHUNK = 32;  // bytes (= int8 channels) per k-chunk

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Geometry {
  int Cp, D, H, W, Cout, kd, kh, kw;
  int64_t P;   // D*H*W
  int64_t M;   // N*P
  int KC;      // k-chunks: taps * Cp / 32
  int CPC;     // chunks per tap: Cp / 32
};

template <int WARPS_M, int WARPS_N>
struct Tile {
  static constexpr int THREADS = WARPS_M * WARPS_N * 32;
  static constexpr int BM = WARPS_M * 64;
  static constexpr int BN = WARPS_N * 32;
  static constexpr int A_BYTES = 2 * BM * CHUNK;  // two k-chunks per stage
  static constexpr int B_BYTES = 2 * BN * CHUNK;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + BM * (int)sizeof(int4);
};

template <int WARPS_M, int WARPS_N, typename OT>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32) qconv_gemm_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ wk,
    const float* __restrict__ amax, const float* __restrict__ sw,
    const float* __restrict__ bias, OT* __restrict__ out, Geometry g) {
  using T = Tile<WARPS_M, WARPS_N>;
  extern __shared__ __align__(16) int8_t smem[];
  int4* rows = reinterpret_cast<int4*>(smem + STAGES * T::STAGE_BYTES);

  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const int64_t HW = (int64_t)g.H * g.W;

  // the tile's output points: (n, z, y, x), n = -1 past the end
  for (int r = tid; r < T::BM; r += T::THREADS) {
    const int64_t m = m0 + r;
    int4 ri = make_int4(-1, 0, 0, 0);
    if (m < g.M) {
      const int64_t n = m / g.P;
      const int64_t sp = m - n * g.P;
      const int64_t z = sp / HW;
      const int64_t yx = sp - z * HW;
      ri = make_int4((int)n, (int)z, (int)(yx / g.W), (int)(yx % g.W));
    }
    rows[r] = ri;
  }
  __syncthreads();

  const int64_t kbytes = (int64_t)g.KC * CHUNK;
  const int pz = g.kd / 2, py = g.kh / 2, px = g.kw / 2;

  auto load_stage = [&](int stage, int kt) {
    int8_t* As = smem + stage * T::STAGE_BYTES;
    int8_t* Bs = As + T::A_BYTES;
    for (int i = tid; i < T::BM * 4; i += T::THREADS) {
      const int row = i >> 2, kk = (i >> 1) & 1, half = i & 1;
      const int kc = kt * 2 + kk;
      const int8_t* src = xq;
      int bytes = 0;
      const int4 ri = rows[row];
      if (kc < g.KC && ri.x >= 0) {
        const int tap = kc / g.CPC;
        const int cb = kc - tap * g.CPC;
        const int dx = tap % g.kw;
        const int t2 = tap / g.kw;
        const int dy = t2 % g.kh;
        const int dz = t2 / g.kh;
        const int zi = ri.y + dz - pz, yi = ri.z + dy - py, xi = ri.w + dx - px;
        if (zi >= 0 && zi < g.D && yi >= 0 && yi < g.H && xi >= 0 && xi < g.W) {
          src = xq + ((((int64_t)ri.x * g.D + zi) * g.H + yi) * g.W + xi) * g.Cp +
                cb * CHUNK + half * 16;
          bytes = 16;
        }
      }
      cp_async16(As + (kk * T::BM + row) * CHUNK + half * 16, src, bytes);
    }
    for (int i = tid; i < T::BN * 4; i += T::THREADS) {
      const int row = i >> 2, kk = (i >> 1) & 1, half = i & 1;
      const int kc = kt * 2 + kk;
      const int co = n0 + row;
      const bool ok = kc < g.KC && co < g.Cout;
      const int8_t* src = ok ? wk + (int64_t)co * kbytes + kc * CHUNK + half * 16 : wk;
      cp_async16(Bs + (kk * T::BN + row) * CHUNK + half * 16, src, ok ? 16 : 0);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int gq = lane >> 2, tq = lane & 3;

  int acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0;

  const int KT = (g.KC + 1) / 2;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk % STAGES, nk);
    cp_async_commit();

    const int8_t* As = smem + (kt % STAGES) * T::STAGE_BYTES;
    const int8_t* Bs = As + T::A_BYTES;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = wm * 64 + mt * 16 + gq;
        const uint2 lo = *reinterpret_cast<const uint2*>(As + (kk * T::BM + r) * CHUNK + 8 * tq);
        const uint2 hi =
            *reinterpret_cast<const uint2*>(As + (kk * T::BM + r + 8) * CHUNK + 8 * tq);
        af[mt][0] = lo.x;
        af[mt][1] = hi.x;
        af[mt][2] = lo.y;
        af[mt][3] = hi.y;
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int r = wn * 32 + nt * 8 + gq;
        const uint2 v = *reinterpret_cast<const uint2*>(Bs + (kk * T::BN + r) * CHUNK + 8 * tq);
        bf[nt][0] = v.x;
        bf[nt][1] = v.y;
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
  }
  cp_async_wait<0>();

  // epilogue: y = fma(acc, sx[n] * sw[co], bias[co]), written NC(D)HW
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 64 + mt * 16 + gq + half * 8;
      const int4 ri = rows[r];
      if (ri.x < 0) continue;
      const float sxn = step_of(amax[ri.x]);
      const int64_t sp = ((int64_t)ri.y * g.H + ri.z) * g.W + ri.w;
      OT* on = out + (int64_t)ri.x * g.Cout * g.P + sp;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int co = n0 + wn * 32 + nt * 8 + 2 * tq + j;
          if (co >= g.Cout) continue;
          const float scale = __fmul_rn(sxn, sw[co]);
          const float b = bias ? bias[co] : 0.0f;
          const float y = __fmaf_rn((float)acc[mt][nt][half * 2 + j], scale, b);
          on[(int64_t)co * g.P] = from_f32<OT>(y);
        }
      }
    }
  }
}

template <int WARPS_M, int WARPS_N, typename T>
cudaError_t launch_gemm(const int8_t* xq, const int8_t* wk, const float* amax, const float* sw,
                        const float* bias, void* out, const Geometry& g, cudaStream_t s) {
  using TL = Tile<WARPS_M, WARPS_N>;
  auto kern = qconv_gemm_kernel<WARPS_M, WARPS_N, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((g.M + TL::BM - 1) / TL::BM), (unsigned)((g.Cout + TL::BN - 1) / TL::BN));
  kern<<<grid, TL::THREADS, TL::SMEM, s>>>(xq, wk, amax, sw, bias, static_cast<T*>(out), g);
  return cudaGetLastError();
}

struct Buffers {
  const void* w;
  const void* bias;  // NULL: no bias
  void* out;
  int8_t* xq;        // (N, P, Cp)
  int8_t* wk;        // (Cout, taps * Cp)
  float* amax;       // (N,)
  float* sw;         // (Cout,)
  float* b32;        // (Cout,)
};

template <typename T>
cudaError_t run(const T* x, const Buffers& b, int w_bf16, int bias_bf16, int N, int C,
                const Geometry& g, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(b.amax, 0, sizeof(float) * N, s);
  if (err != cudaSuccess) return err;
  const int64_t len = (int64_t)C * g.P;
  const int64_t per = (len + 256 * 16 - 1) / (256 * 16);
  const dim3 agrid((unsigned)(per < 256 ? per : 256), (unsigned)N);
  absmax_kernel<T><<<agrid, 256, 0, s>>>(x, reinterpret_cast<unsigned*>(b.amax), len);
  const int taps = g.kd * g.kh * g.kw;
  if (w_bf16)
    quantize_weight_kernel<__nv_bfloat16><<<g.Cout, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(b.w), b.bias, bias_bf16, b.wk, b.sw, b.b32, C, g.Cp,
        taps);
  else
    quantize_weight_kernel<float><<<g.Cout, 256, 0, s>>>(
        static_cast<const float*>(b.w), b.bias, bias_bf16, b.wk, b.sw, b.b32, C, g.Cp, taps);
  const dim3 qgrid((unsigned)((g.P + QP - 1) / QP), (unsigned)N);
  quantize_act_kernel<T><<<qgrid, 256, 0, s>>>(x, b.amax, b.xq, C, g.Cp, g.P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* bias = b.bias ? b.b32 : nullptr;
  if (g.Cout <= 32) return launch_gemm<4, 1, T>(b.xq, b.wk, b.amax, b.sw, bias, b.out, g, s);
  return launch_gemm<2, 4, T>(b.xq, b.wk, b.amax, b.sw, bias, b.out, g, s);
}

}  // namespace

// x (N, C, D, H, W) contiguous (2D: D = 1, kd = 1); w (Cout, C, kd, kh, kw)
// contiguous; bias (Cout,) or NULL; dtype codes 0 = float32, 1 = bfloat16 for
// x, w and bias each; out (N, Cout, D, H, W) in x's dtype.  Scratch: xq
// (N, D*H*W, Cp) int8, wk (Cout, kd*kh*kw*Cp) int8, f32 (N + 2 * Cout).
// Returns the cudaError_t of the launches (0 on success).
extern "C" int qconv_forward(const void* x, const void* w, const void* bias, void* out,
                             void* xq, void* wk, void* scratch, int dtype, int w_dtype,
                             int bias_dtype, int N, int C, int Cp, int D, int H, int W,
                             int Cout, int kd, int kh, int kw, void* stream) {
  if (Cp % CHUNK != 0 || Cp < C || kd % 2 == 0 || kh % 2 == 0 || kw % 2 == 0 ||
      (dtype | w_dtype | bias_dtype) & ~1)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.Cp = Cp;
  g.D = D;
  g.H = H;
  g.W = W;
  g.Cout = Cout;
  g.kd = kd;
  g.kh = kh;
  g.kw = kw;
  g.P = (int64_t)D * H * W;
  g.M = (int64_t)N * g.P;
  g.CPC = Cp / CHUNK;
  g.KC = kd * kh * kw * g.CPC;
  if (g.M == 0 || Cout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(scratch);
  const Buffers b{w, bias, out, static_cast<int8_t*>(xq), static_cast<int8_t*>(wk),
                  f, f + N, f + N + Cout};
  if (dtype == 0) return (int)run(static_cast<const float*>(x), b, w_dtype, bias_dtype, N, C, g, s);
  return (int)run(static_cast<const __nv_bfloat16*>(x), b, w_dtype, bias_dtype, N, C, g, s);
}

extern "C" const char* qconv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
