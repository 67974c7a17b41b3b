// W8A8 trilinear 3D grid sample (the fast bundle's warp) for Hopper, sm_90a.
//
// Replaces the quant=True forms of canonswap_tpu/ops/pallas/warp.py's
// `_kernel` and `_kernel_win` with the quantization of
// grid_sample_3d_onehot (warp.py:459-481).  Per sample b and output point:
//
//   q      = clip(rint(vol / s_b), -127, 127)         s_b = max|vol_b|/127 + 1e-12
//   t(a)   = max(0, 1 - |a - coord|)                  coord = ((g + 1) * size - 1) / 2
//   qw     = rint(t_y * t_x * 127)                    per in-volume xy corner, int
//   acc_z  = sum over xy corners of qw * q[z, y, x]   int, per in-volume z tap
//   out    = sum over z taps of (acc_z * (s_b * f32(1/127))) * t_z   f32, then vol's dtype
//
// Every product and sum is rounded exactly where the JAX kernel rounds it
// (no contraction into fused multiply-adds), so the kernel equals its plain
// version (canonswap_torch/ops/cuda/warp.py::grid_sample_3d_quant_plain)
// bit for bit.  The tents are computed as JAX computes them, 1 - |a - coord|,
// not as 1 - frac: an ulp there flips rint(127 * w) at half-integers.  The
// step is quant.cuh's step_of, the arithmetic of ops/quant.py::absmax_step.
//
// The TPU kernel turned the gather into int8 MXU matmuls (a quantized tent
// one-hot over a z-packed, channels-last slab); its windowed and full-table
// branches share the int8 slab, the step and the tap weights, so one gather
// covers both.  Here one warp3d_q_forward call enqueues, on its stream:
//
//   1. a memset of the per-sample maxima, then quant.cuh's absmax_kernel
//      (16-byte loads, a NaN-keeping max, one atomicMax per block);
//   2. quant.cuh's quantize_act_kernel: vol (B, C, D*H*W) -> q (B, D, H, W,
//      Cp) int8 in one pass, channels last and zero-padded to Cp (C rounded
//      up to 16), 16-byte reads along the points, the sample from the
//      block's y index (no division per element), its step from the maxima;
//   3. the gather, two threads per output point, each over every other
//      16-channel chunk (16 corner loads per point at C = 32, 8 in each
//      thread, where one thread per point needed 120 registers): the 4 xy
//      corners' rows and int8 weights (packed into one word) and the 2 z
//      taps, clamped into the volume with weight 0 outside, so every load
//      is unconditional; a chunk's 8 corner loads (16 bytes each) issued
//      before any sum; the 4 xy corners' bytes of each channel gathered
//      into one word by byte permutes and summed with the weights by
//      __dp4a; the dequant and the z mix in f32 in the plain version's
//      order; outputs written (B, C, P) in vol's dtype.
//
// Steps 2 and 3 are launched so that each may start while the kernel before
// it drains (programmatic dependent launch, chain.cuh's launch_after_prior):
// the quantize pass issues its loads of the volume, and the gather computes
// its taps from the grid, before they wait for the maxima and the int8 copy.
// That hides two of the three gaps between kernels of one call, where the
// exact warp (warp3d.cu) is one kernel.
//
// What bounds it on the H100: bytes.  At the fast path's call (B=8, C=32,
// (16, 64, 64) volume and grid, bf16) it must read the volume (33.6 MB) and
// the grid (3.1 MB) and write the output (33.6 MB): 21 us at 3.35 TB/s.  The
// quantization passes read the volume twice and write the 16.8 MB int8 copy
// (about 25 us at the memory rate); a corner of the copy is one 32-byte
// sector of the 50 MB L2 (the NCDHW copy spread it over 32 byte planes), so
// the gather's corner reads cost sectors, not load instructions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant.cuh"

namespace {

constexpr int GATHER_THREADS = 128;

// One axis: the two taps' integer positions, their tent weights and
// whether each lies inside [0, size).
struct Taps {
  int i0;
  float t0, t1;
  bool v0, v1;
};

__device__ __forceinline__ Taps tent_taps(float g, int size) {
  const float c =
      __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), (float)size), 1.0f), 0.5f);
  const float a0 = floorf(c);
  const float a1 = __fadd_rn(a0, 1.0f);
  Taps t;
  t.t0 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(a0, c))));
  t.t1 = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(a1, c))));
  t.v0 = a0 >= 0.0f && a0 <= (float)(size - 1);
  t.v1 = a1 >= 0.0f && a1 <= (float)(size - 1);
  // clamp before the cast so a point far outside (or NaN) gives a defined
  // integer; its taps are invalid and read with weight 0
  t.i0 = (int)fminf(fmaxf(a0, -1.0f), (float)size);
  return t;
}

__device__ __forceinline__ uint32_t word(const int4& v, int i) {
  return (uint32_t)(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w);
}

// the 4 channels of one word of each xy corner, summed with the corners'
// int8 weights: the words' bytes transposed so that word i holds channel i
// of corners 0..3, then one __dp4a per channel
__device__ __forceinline__ void corner_dots(uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                            int wts, int acc[4]) {
  const uint32_t lo01 = __byte_perm(a0, a1, 0x5140), hi01 = __byte_perm(a0, a1, 0x7362);
  const uint32_t lo23 = __byte_perm(a2, a3, 0x5140), hi23 = __byte_perm(a2, a3, 0x7362);
  acc[0] = __dp4a((int)__byte_perm(lo01, lo23, 0x5410), wts, 0);
  acc[1] = __dp4a((int)__byte_perm(lo01, lo23, 0x7632), wts, 0);
  acc[2] = __dp4a((int)__byte_perm(hi01, hi23, 0x5410), wts, 0);
  acc[3] = __dp4a((int)__byte_perm(hi01, hi23, 0x7632), wts, 0);
}

// Two threads per output point: lanes 0-15 of a warp take 16 points, lanes
// 16-31 the same points; each thread takes every other 16-channel chunk of
// the int8 copy (lane >> 4 first), so a point's corner loads are spread
// over two threads and a thread holds 8 of them in flight.  Grid
// (ceil(2 * P / GATHER_THREADS), B): the sample is the block's y index.
template <typename VT, typename GT>
__global__ void __launch_bounds__(GATHER_THREADS) warp3d_q_kernel(
    const int8_t* __restrict__ q, const float* __restrict__ amax, const GT* __restrict__ grid,
    VT* __restrict__ out, int C, int Cp, int D, int H, int W, int P) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int p = (int)(((int64_t)blockIdx.x * GATHER_THREADS + threadIdx.x) / 32 * 16) + (lane & 15);
  if (p >= P) return;

  const GT* gp = grid + ((int64_t)b * P + p) * 3;
  const Taps ax = tent_taps(to_f32(gp[0]), W);
  const Taps ay = tent_taps(to_f32(gp[1]), H);
  const Taps az = tent_taps(to_f32(gp[2]), D);

  // xy corner k = (dy, dx): in-plane point (0 outside) and int8 weight
  // (0 outside), the four weights packed into one word for __dp4a
  int plane_pt[4];
  int wts = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dy = k >> 1, dx = k & 1;
    const float w = __fmul_rn(dy ? ay.t1 : ay.t0, dx ? ax.t1 : ax.t0);
    const bool ok = (dy ? ay.v1 : ay.v0) && (dx ? ax.v1 : ax.v0);
    const int qw = ok ? (int)rintf(__fmul_rn(w, 127.0f)) : 0;  // 0..127
    plane_pt[k] = ok ? (ay.i0 + dy) * W + (ax.i0 + dx) : 0;
    wts |= qw << (8 * k);
  }
  const bool vz[2] = {az.v0, az.v1};
  const float tz[2] = {az.t0, az.t1};
  const int64_t plane = (int64_t)H * W;
  const int64_t zpt[2] = {vz[0] ? (int64_t)az.i0 * plane : 0,
                          vz[1] ? (int64_t)(az.i0 + 1) * plane : 0};
  // the grid is the caller's; the steps and the int8 copy come from the
  // kernels before, which may still be draining
  wait_for_prior_grid();
  const float scale = __fmul_rn(step_of(amax[b]), (float)(1.0 / 127.0));

  const int8_t* qb = q + (int64_t)b * D * plane * Cp;
  VT* ob = out + (int64_t)b * C * P + p;
  for (int c0 = 16 * (lane >> 4); c0 < Cp; c0 += 32) {
    // the 8 corners' 16-byte words of these 16 channels, all in flight
    int4 v[2][4];
#pragma unroll
    for (int dz = 0; dz < 2; ++dz)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[dz][k] = __ldg(reinterpret_cast<const int4*>(qb + (zpt[dz] + plane_pt[k]) * Cp + c0));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int acc[2][4];
#pragma unroll
      for (int dz = 0; dz < 2; ++dz)
        corner_dots(word(v[dz][0], i), word(v[dz][1], i), word(v[dz][2], i), word(v[dz][3], i),
                    wts, acc[dz]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 4 * i + e;
        if (c >= C) break;
        float o = 0.0f;
#pragma unroll
        for (int dz = 0; dz < 2; ++dz) {
          if (!vz[dz]) continue;
          const float s = __fmul_rn((float)acc[dz][e], scale);
          o = __fadd_rn(o, __fmul_rn(s, tz[dz]));
        }
        ob[c * (int64_t)P] = from_f32<VT>(o);
      }
    }
  }
}

template <typename VT, typename GT>
cudaError_t launch(const void* vol, const void* grid, void* out, int8_t* q, float* amax, int B,
                   int C, int Cp, int D, int H, int W, int P, cudaStream_t s) {
  const VT* v = static_cast<const VT*>(vol);
  const int64_t points = (int64_t)D * H * W;
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(float) * B, s);
  if (err != cudaSuccess) return err;
  absmax_kernel<VT><<<absmax_grid(C * points, B), 256, 0, s>>>(
      v, reinterpret_cast<unsigned*>(amax), C * points);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 qgrid((unsigned)((points + QP - 1) / QP), (unsigned)B);
  err = launch_after_prior(quantize_act_kernel<VT>, qgrid, dim3(256), s, v, amax, q, C, Cp,
                           points);
  if (err != cudaSuccess) return err;
  // two threads per output point
  const dim3 ggrid((unsigned)((2 * (int64_t)P + GATHER_THREADS - 1) / GATHER_THREADS),
                   (unsigned)B);
  return launch_after_prior(warp3d_q_kernel<VT, GT>, ggrid, dim3(GATHER_THREADS), s, q, amax,
                            static_cast<const GT*>(grid), static_cast<VT*>(out), C, Cp, D, H, W,
                            P);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.
// vol (B, C, D, H, W), grid (B, P, 3), out (B, C, P), all contiguous;
// scratch: q (B, D, H, W, Cp) int8 with Cp = C rounded up to 16, amax (B,)
// f32.  Returns the cudaError_t of the launches (0 on success).
extern "C" int warp3d_q_forward(const void* vol, const void* grid, void* out, void* q,
                                void* amax, int vol_dtype, int grid_dtype, int B, int C, int Cp,
                                int D, int H, int W, int P, void* stream) {
  if (Cp != (C + 15) / 16 * 16 || B > 65535) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * P == 0 || (int64_t)C * D * H * W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* qq = static_cast<int8_t*>(q);
  float* am = static_cast<float*>(amax);
  if (vol_dtype == 0 && grid_dtype == 0)
    return launch<float, float>(vol, grid, out, qq, am, B, C, Cp, D, H, W, P, s);
  if (vol_dtype == 0 && grid_dtype == 1)
    return launch<float, __nv_bfloat16>(vol, grid, out, qq, am, B, C, Cp, D, H, W, P, s);
  if (vol_dtype == 1 && grid_dtype == 0)
    return launch<__nv_bfloat16, float>(vol, grid, out, qq, am, B, C, Cp, D, H, W, P, s);
  if (vol_dtype == 1 && grid_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(vol, grid, out, qq, am, B, C, Cp, D, H, W, P,
                                                s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* warp3d_q_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
