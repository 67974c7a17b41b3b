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
// not as 1 - frac: an ulp there flips rint(127 * w) at half-integers.
//
// The TPU kernel turned the gather into int8 MXU matmuls (a quantized tent
// one-hot over a z-packed slab); its windowed and full-table branches share
// the int8 slab, the step and the tap weights, so one gather covers both.
// Here, as in warp3d.cu: one thread per output point computes the 4 xy
// corner offsets and int8 weights and the 2 z taps once, then loops over
// the C channel planes with integer sums.
//
// Two kernels, launched back to back by warp3d_q_forward: the per-sample
// quantization of the volume into an int8 copy (NCDHW, the volume's own
// layout), then the gather.  What bounds it on the H100: bytes and load
// instructions, as warp3d.cu; the int8 copy reads a quarter of the f32
// (half of the bf16) volume bytes per corner, at the cost of one extra
// read and write of the volume for the quantization.

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

template <typename T>
__global__ void __launch_bounds__(256) quantize_vol_kernel(
    const T* __restrict__ vol, const float* __restrict__ step, int8_t* __restrict__ q,
    int64_t per_sample, int64_t total) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float r = rintf(__fdiv_rn(to_f32(vol[i]), step[i / per_sample]));
    q[i] = (int8_t)(int)fminf(fmaxf(r, -127.0f), 127.0f);
  }
}

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
  // integer; its taps are invalid and never read
  t.i0 = (int)fminf(fmaxf(a0, -1.0f), (float)size);
  return t;
}

template <typename VT, typename GT>
__global__ void __launch_bounds__(256) warp3d_q_kernel(
    const int8_t* __restrict__ q, const float* __restrict__ step,
    const GT* __restrict__ grid, VT* __restrict__ out, int B, int C, int D, int H, int W,
    int P) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)B * P) return;
  const int64_t b = idx / P;
  const int64_t p = idx - b * P;

  const GT* gp = grid + idx * 3;
  const Taps ax = tent_taps(to_f32(gp[0]), W);
  const Taps ay = tent_taps(to_f32(gp[1]), H);
  const Taps az = tent_taps(to_f32(gp[2]), D);

  // xy corner k = (dy, dx): in-plane offset and int8 weight
  int off[4], qw[4];
  bool ok[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dy = k >> 1, dx = k & 1;
    const float w = __fmul_rn(dy ? ay.t1 : ay.t0, dx ? ax.t1 : ax.t0);
    qw[k] = (int)rintf(__fmul_rn(w, 127.0f));
    ok[k] = (dy ? ay.v1 : ay.v0) && (dx ? ax.v1 : ax.v0);
    off[k] = ok[k] ? (ay.i0 + dy) * W + (ax.i0 + dx) : 0;
  }
  const bool vz[2] = {az.v0, az.v1};
  const float tz[2] = {az.t0, az.t1};
  const int64_t plane = (int64_t)H * W;
  const int64_t zoff[2] = {vz[0] ? (int64_t)az.i0 * plane : 0,
                           vz[1] ? (int64_t)(az.i0 + 1) * plane : 0};
  const float scale = __fmul_rn(step[b], (float)(1.0 / 127.0));

  const int64_t vsize = (int64_t)D * plane;
  const int8_t* qb = q + b * C * vsize;
  VT* ob = out + b * C * (int64_t)P + p;
  for (int c = 0; c < C; ++c) {
    const int8_t* qc = qb + c * vsize;
    float o = 0.0f;
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      if (!vz[dz]) continue;
      const int8_t* qz = qc + zoff[dz];
      int acc = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (ok[k]) acc += qw[k] * (int)qz[off[k]];
      const float s = __fmul_rn((float)acc, scale);
      o = __fadd_rn(o, __fmul_rn(s, tz[dz]));
    }
    ob[c * (int64_t)P] = from_f32<VT>(o);
  }
}

template <typename VT, typename GT>
cudaError_t launch(const void* vol, const void* grid, void* out, int8_t* q, const float* step,
                   int B, int C, int D, int H, int W, int P, cudaStream_t s) {
  const int64_t per_sample = (int64_t)C * D * H * W;
  const int64_t total = (int64_t)B * per_sample;
  const int64_t want = (total + 255) / 256;
  const unsigned qblocks = (unsigned)(want < 65536 * 8 ? want : 65536 * 8);
  quantize_vol_kernel<VT><<<qblocks, 256, 0, s>>>(static_cast<const VT*>(vol), step, q,
                                                   per_sample, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  const int64_t n = (int64_t)B * P;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  warp3d_q_kernel<VT, GT><<<blocks, threads, 0, s>>>(
      q, step, static_cast<const GT*>(grid), static_cast<VT*>(out), B, C, D, H, W, P);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.
// vol (B, C, D, H, W), grid (B, P, 3), out (B, C, P), all contiguous;
// q scratch (B, C, D, H, W) int8; step (B,) f32 per-sample steps.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int warp3d_q_forward(const void* vol, const void* grid, void* out, void* q,
                                const void* step, int vol_dtype, int grid_dtype, int B, int C,
                                int D, int H, int W, int P, void* stream) {
  if ((int64_t)B * P == 0 || (int64_t)C * D * H * W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* qq = static_cast<int8_t*>(q);
  const float* st = static_cast<const float*>(step);
  if (vol_dtype == 0 && grid_dtype == 0)
    return launch<float, float>(vol, grid, out, qq, st, B, C, D, H, W, P, s);
  if (vol_dtype == 0 && grid_dtype == 1)
    return launch<float, __nv_bfloat16>(vol, grid, out, qq, st, B, C, D, H, W, P, s);
  if (vol_dtype == 1 && grid_dtype == 0)
    return launch<__nv_bfloat16, float>(vol, grid, out, qq, st, B, C, D, H, W, P, s);
  if (vol_dtype == 1 && grid_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(vol, grid, out, qq, st, B, C, D, H, W, P, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* warp3d_q_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
