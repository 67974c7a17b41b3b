// Symmetric int8 quantization on the card, shared by the W8A8 conv
// (qconv.cu) and the W8A8 warp (warp3d_q.cu).  The arithmetic of
// canonswap_torch/ops/quant.py:
//
//   s = max|v| * f32(1/127) + f32(1e-12)   in f64 (the product is exact), rounded once to f32
//   q = clip(rint(v / s), -127, 127)       IEEE division, round half to even
//
// so both kernels equal their plain versions bit for bit.  Two passes:
// absmax_kernel (per-sample max |x|, into a zeroed f32 array by atomicMax)
// and quantize_act_kernel (x (N, C, P) -> xq (N, P, Cp) int8, channels
// contiguous and zero-padded to Cp).
//
// Both passes let the next kernel on the stream start early (Hopper's
// programmatic dependent launch, chain.cuh): a kernel launched by
// launch_after_prior runs its prologue while the one before it drains and
// waits in wait_for_prior_grid before it reads what that one wrote.
// Launched without it, as qconv.cu launches them, the wait returns at once
// and the early start does nothing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chain.cuh"

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

// the VEC = 16 / sizeof(T) values of one 16-byte load, as f32
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* f) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) f[i] = to_f32(e[i]);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// per-sample max |x| over len values (blockIdx.y: the sample); amax zeroed
// before: a block reduction, then one atomicMax per block on the float's
// bits (non-negative floats order as unsigned)

template <typename T>
__global__ void __launch_bounds__(256) absmax_kernel(const T* __restrict__ x,
                                                     unsigned* __restrict__ amax, int64_t len) {
  constexpr int VEC = 16 / (int)sizeof(T);
  allow_next_grid();
  const T* xn = x + (int64_t)blockIdx.y * len;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  float m = 0.0f;
  if (len % VEC == 0 && aligned16(x)) {  // then every sample starts 16-byte aligned
#pragma unroll 4
    for (int64_t i = first; i < len / VEC; i += stride) {
      float f[VEC];
      load16(xn + i * VEC, f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) m = nan_max(m, fabsf(f[e]));
    }
  } else {
    for (int64_t i = first; i < len; i += stride) m = nan_max(m, fabsf(to_f32(xn[i])));
  }
  m = block_max(m);
  if (threadIdx.x == 0) atomicMax(amax + blockIdx.y, __float_as_uint(m));
}

// the absmax grid for N samples of len values each
inline dim3 absmax_grid(int64_t len, int N) {
  const int64_t per = (len + 256 * 16 - 1) / (256 * 16);
  return dim3((unsigned)(per < 256 ? per : 256), (unsigned)N);
}

// ---------------------------------------------------------------------------
// quantize and transpose: (N, C, P) -> (N, P, Cp) int8, Cp a multiple of 16.
// Grid (ceil(P / QP), N), 256 threads: 16-byte loads along P, transposed
// through shared memory, 16-byte stores along C.  It runs right after
// absmax_kernel, which walks x from the first sample to the last, so the
// blocks take the samples and tiles in reverse order: they start on what
// absmax_kernel read last, which the 50 MB L2 still holds where x is larger.
// The loads of the first pass are issued before the wait for the maxima.

constexpr int QP = 128;  // points per tile
constexpr int QC = 32;   // channels per pass
constexpr int QLD = QP + 12;  // a padded channel row of the tile: conflict-free byte reads

template <typename T>
__global__ void __launch_bounds__(256) quantize_act_kernel(
    const T* __restrict__ x, const float* __restrict__ amax, int8_t* __restrict__ xq,
    int C, int Cp, int64_t P) {
  constexpr int VEC = 16 / (int)sizeof(T);  // points per 16-byte load
  constexpr int VPR = QP / VEC;             // loads per channel row
  constexpr int ROWS = 256 / VPR;           // channel rows per sweep of the block
  constexpr int NR = QC / ROWS;             // sweeps per pass
  __shared__ __align__(16) int8_t tile[QC][QLD];  // [channel][point]
  allow_next_grid();
  const int n = gridDim.y - 1 - blockIdx.y;
  const int64_t p0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * QP;
  float step = 0.0f;
  const T* xn = x + (int64_t)n * C * P;
  int8_t* qn = xq + (int64_t)n * P * Cp;
  const int tid = threadIdx.x;
  const bool vec = P % VEC == 0 && aligned16(x);
  const int v = tid % VPR;
  const int64_t p = p0 + v * VEC;
  for (int c0 = 0; c0 < Cp; c0 += QC) {
    // read: 16-byte runs of points along each channel, all of a thread's
    // loads issued before any is used, then quantized
    float f[NR][VEC];
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int c = c0 + tid / VPR + i * ROWS;
      if (c < C && vec && p < P) load16(xn + (int64_t)c * P + p, f[i]);
    }
    // x is the caller's; only the maxima come from the kernel before
    if (c0 == 0) {
      wait_for_prior_grid();
      step = step_of(amax[n]);
    }
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int cr = tid / VPR + i * ROWS, c = c0 + cr;
      uint32_t packed[VEC / 4] = {};
      if (c < C && vec && p < P) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          packed[e / 4] |= (uint32_t)(uint8_t)quantize_one(f[i][e], step) << (8 * (e % 4));
      } else if (c < C) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (p + e < P)
            packed[e / 4] |= (uint32_t)(uint8_t)quantize_one(to_f32(xn[(int64_t)c * P + p + e]),
                                                              step)
                             << (8 * (e % 4));
      }
#pragma unroll
      for (int k = 0; k < VEC / 4; ++k)
        *reinterpret_cast<uint32_t*>(&tile[cr][v * VEC + 4 * k]) = packed[k];
    }
    __syncthreads();
    // write: each point's 32 channels, two 16-byte stores (the second only
    // where Cp reaches it)
    {
      const int row = tid >> 1, half = tid & 1;
      if (p0 + row < P && c0 + half * 16 < Cp) {
        uint32_t w[4] = {};
#pragma unroll
        for (int k = 0; k < 16; ++k)
          w[k / 4] |= (uint32_t)(uint8_t)tile[half * 16 + k][row] << (8 * (k % 4));
        *reinterpret_cast<int4*>(qn + (p0 + row) * Cp + c0 + half * 16) =
            make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
      }
    }
    __syncthreads();
  }
}

}  // namespace
