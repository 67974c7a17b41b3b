// Trilinear 3D grid sample (the warp) for Hopper, sm_90a.
//
// Replaces canonswap_tpu/ops/pallas/warp.py::grid_sample_3d_onehot (the
// full-table `_kernel` and the windowed `_kernel_win`, quant=False).  Same
// function as canonswap_tpu/ops/grid_sample.py::grid_sample_3d_ref and as
// F.grid_sample(mode="bilinear", padding_mode="zeros", align_corners=False):
//
//   out[b, c, p] = sum over the 8 corners k of w_k * vol[b, c, z_k, y_k, x_k]
//
// with the coordinate ((g + 1) * size - 1) / 2 per axis, and a corner outside
// the volume contributing 0.  Coordinates and weights are f32, the sum is
// accumulated in f32, the result is written in the volume's dtype.
//
// The TPU kernel turned the gather into MXU work (a bilinear "tent" one-hot
// matmul over a z-packed slab, a z tent, a group-sum matmul) because the TPU's
// row gather is slow.  Hopper gathers natively, so here it is one gather per
// corner and nothing else: no one-hot matrix, no window.
//
// What bounds it on the H100: the gather, not the bytes.  It does 16 flops
// per corner read.  At CANONICAL B=8 in bf16, one call reads the 34 MB
// volume, the 6 MB grid (12 MB in f32) and writes 34 MB: 0.021 ms at the
// memory rate.  Each output point reads 8 corners x C channel planes, every
// read a 2- or 4-byte gather, so the time goes to the load path: for a
// smooth field (what dense motion emits) neighbouring points read
// neighbouring addresses and the loads' issue and latency bound it; for a
// random field every corner is its own 32-byte sector, and the L2's sector
// rate bounds it.
//
// Layout: the volume stays NCDHW (B, C, D, H, W), the port's own layout, so
// no transpose is needed around the call.  One thread takes one output point
// (b, p): it computes the 8 corner offsets and weights once, then loops over
// the C channel planes.  Consecutive threads take consecutive output points
// along W, so for smooth fields their corner reads land on neighbouring
// addresses of the same plane (coalesced), and their writes
// out[b, c, p..p+31] are contiguous for every channel.  A corner outside the
// volume is never read (a predicated load), so no NaN there can leak in.
// Offsets of b*C*D*H*W and c*D*H*W are 64-bit.
//
// Launch shape, measured on the H100 at CANONICAL B=8 (chip_smoke.py's
// smooth and random fields): blocks of 1024 points, and the channel loop
// left rolled (8 loads in flight per thread, the block's 32 warps walking the
// planes close together).  Blocks of 256 with the loop unrolled by 2 were
// 8 % slower than F.grid_sample in bf16 on the smooth field; loads from
// clamped addresses without predication were faster there but up to twice
// as slow on the random field.

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

// One axis: the two taps' integer positions, their weights and whether each
// lies inside [0, size).  floorf, never a truncating cast: coordinates are
// negative for every point left of the volume.
struct Axis {
  int i0;
  float w0, w1;
  bool v0, v1;
};

__device__ __forceinline__ Axis axis_taps(float g, int size) {
  const float t = ((g + 1.0f) * (float)size - 1.0f) * 0.5f;
  const float t0 = floorf(t);
  const float f = t - t0;
  Axis a;
  a.v0 = t0 >= 0.0f && t0 <= (float)(size - 1);
  a.v1 = t0 + 1.0f >= 0.0f && t0 + 1.0f <= (float)(size - 1);
  // clamp before the cast so a point far outside (or NaN) gives a defined
  // integer; its taps are invalid and never read
  a.i0 = (int)fminf(fmaxf(t0, -1.0f), (float)size);
  a.w0 = 1.0f - f;
  a.w1 = f;
  return a;
}

constexpr int THREADS = 1024;  // points per block

template <typename VT, typename GT>
__global__ void __launch_bounds__(THREADS) warp3d_kernel(
    const VT* __restrict__ vol, const GT* __restrict__ grid, VT* __restrict__ out,
    int B, int C, int D, int H, int W, int P) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)B * P) return;
  const int64_t b = idx / P;
  const int64_t p = idx - b * P;

  const GT* g = grid + idx * 3;
  const Axis ax = axis_taps(to_f32(g[0]), W);
  const Axis ay = axis_taps(to_f32(g[1]), H);
  const Axis az = axis_taps(to_f32(g[2]), D);

  // corner k = (dz, dy, dx) in the order of grid_sample_3d_ref's sum
  int64_t off[8];
  float wgt[8];
  bool ok[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
    const float wz = dz ? az.w1 : az.w0;
    const float wy = dy ? ay.w1 : ay.w0;
    const float wx = dx ? ax.w1 : ax.w0;
    ok[k] = (dz ? az.v1 : az.v0) && (dy ? ay.v1 : ay.v0) && (dx ? ax.v1 : ax.v0);
    wgt[k] = wz * wy * wx;
    off[k] = ok[k] ? ((int64_t)(az.i0 + dz) * H + (ay.i0 + dy)) * W + (ax.i0 + dx) : 0;
  }

  const int64_t plane = (int64_t)D * H * W;
  const VT* vb = vol + b * C * plane;
  VT* ob = out + b * C * (int64_t)P + p;
#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    const VT* vc = vb + c * plane;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float v = ok[k] ? to_f32(vc[off[k]]) : 0.0f;
      acc += wgt[k] * v;
    }
    ob[c * (int64_t)P] = from_f32<VT>(acc);
  }
}

template <typename VT, typename GT>
cudaError_t launch(const void* vol, const void* grid, void* out, int B, int C, int D,
                   int H, int W, int P, cudaStream_t stream) {
  const int64_t n = (int64_t)B * P;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  warp3d_kernel<VT, GT><<<blocks, THREADS, 0, stream>>>(
      static_cast<const VT*>(vol), static_cast<const GT*>(grid), static_cast<VT*>(out),
      B, C, D, H, W, P);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.
// vol (B, C, D, H, W), grid (B, P, 3), out (B, C, P); all contiguous.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int warp3d_forward(const void* vol, const void* grid, void* out, int vol_dtype,
                              int grid_dtype, int B, int C, int D, int H, int W, int P,
                              void* stream) {
  if ((int64_t)B * P == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vol_dtype == 0 && grid_dtype == 0)
    return launch<float, float>(vol, grid, out, B, C, D, H, W, P, s);
  if (vol_dtype == 0 && grid_dtype == 1)
    return launch<float, __nv_bfloat16>(vol, grid, out, B, C, D, H, W, P, s);
  if (vol_dtype == 1 && grid_dtype == 0)
    return launch<__nv_bfloat16, float>(vol, grid, out, B, C, D, H, W, P, s);
  if (vol_dtype == 1 && grid_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(vol, grid, out, B, C, D, H, W, P, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* warp3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
