// Multi-scale deformable attention, forward, for Hopper (sm_90a).
//
// Replaces canonswap_tpu/ops/pallas/ms_deform_attn.py::ms_deform_attn_pallas
// (`_run_level` -> `_level_kernel`).  Same function as
// canonswap_tpu/ops/ms_deform_attn.py::ms_deform_attn_ref and the plain
// version in canonswap_torch/ops/cuda/ms_deform_attn.py:
//
//   out[n, q, m*D + d] = sum over levels l and points p of
//       a[n, q, m, l, p] * bilinear(value_l[n, :, :, m, d], loc[n, q, m, l, p])
//
// with loc (x, y) in [0, 1], align_corners=False and zero padding: the
// coordinate ((g + 1) * W - 1) * 0.5 with g = 2 * loc - 1 (grid_sample's
// arithmetic), corner weights formed as grid_sample forms them, a corner
// outside the level contributing 0.  f32 throughout.
//
// The TPU kernel ran one program per level and query block and turned the
// gather into a one-hot (BLK*P, H*W) matrix times the level's features, for
// the TPU's matrix unit.  At H*W = 16,800 (the largest level at full width)
// that is 16,800 multiply-adds per useful one.  Hopper gathers natively, so
// here it is a direct gather, one launch for all levels:
//
//   - one warp per (n, q, m); its lanes run over the D channels of the head
//     (D <= 128: up to four 32-channel chunks held in registers);
//   - lanes 0..L*P-1 each compute one sample's four corner rows and weights
//     (bilinear weight times the attention weight, 0 where the corner is
//     outside) once; the warp then walks the samples, taking each one's
//     rows and weights from its lane with __shfl_sync;
//   - per corner, 32 lanes read 32 adjacent channels of
//     value[n, start_l + y*W_l + x, m, :]: one 128-byte line;
//   - the sum stays in registers and out[n, q, m*D + d] is written once.
//
// What bounds it on the H100: bytes.  At the full-width encoder call
// (N=1, Lq=22,323, M=8, D=32, L=P=4) it must read the locations (22.9 MB),
// the weights (11.4 MB) and the value (22.9 MB) and write the output
// (22.9 MB): 80 MB, 24 us at 3.35 TB/s, against about 0.9 GFLOP (14 us at
// 67 TFLOP/s f32).  The corner reads are 1.46 GB of 128-byte lines; the
// 22.9 MB value fits the 50 MB L2, so most of them should come from L2, and
// the gathers' L2 traffic, not device memory, is the likelier limit.
// Level starts and shapes come in as a kernel argument; offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxChunks = 4;  // D <= 32 * kMaxChunks
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];  // first row of the level on value's S axis
};

// The level's shape and start, by a select over the fixed-size table (no
// dynamic indexing into the parameter space).
__device__ __forceinline__ void level_of(const Levels& lv, int l, int& h, int& w,
                                         int& start) {
  h = lv.h[0];
  w = lv.w[0];
  start = lv.start[0];
#pragma unroll
  for (int k = 1; k < kMaxLevels; ++k) {
    if (k == l) {
      h = lv.h[k];
      w = lv.w[k];
      start = lv.start[k];
    }
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32) msda_kernel(
    const float* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ attw, float* __restrict__ out, const Levels lv, int N,
    int S, int M, int D, int Lq, int L, int P) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  // the whole warp leaves together, so every __shfl_sync below has all lanes
  if (warp >= (int64_t)N * Lq * M) return;
  const int m = (int)(warp % M);
  const int n = (int)(warp / M / Lq);
  const int LP = L * P;

  // loc (N, Lq, M, L, P, 2) and weights (N, Lq, M, L, P): this warp's
  // samples are contiguous, starting at warp * L*P
  const float* loc_w = loc + warp * (int64_t)LP * 2;
  const float* att_w = attw + warp * (int64_t)LP;
  // value (N, S, M, D): row r of head m at ((n*S + r)*M + m)*D
  const float* vbase = value + ((int64_t)n * S * M + m) * D;
  const int64_t row_stride = (int64_t)M * D;

  float acc[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) acc[c] = 0.0f;

  for (int s0 = 0; s0 < LP; s0 += 32) {
    // this lane's sample: corner rows (-1: outside) and weights
    float wk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int rk[4] = {-1, -1, -1, -1};
    const int s = s0 + lane;
    if (s < LP) {
      int h, w, start;
      level_of(lv, s / P, h, w, start);
      const float a = att_w[s];
      const float gx = 2.0f * loc_w[2 * s] - 1.0f;
      const float gy = 2.0f * loc_w[2 * s + 1] - 1.0f;
      const float x = ((gx + 1.0f) * (float)w - 1.0f) * 0.5f;
      const float y = ((gy + 1.0f) * (float)h - 1.0f) * 0.5f;
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      // grid_sample's weights: nw = (x1 - x)(y1 - y), ne = (x - x0)(y1 - y),
      // sw = (x1 - x)(y - y0), se = (x - x0)(y - y0)
      const float wx0 = (x0f + 1.0f) - x, wx1 = x - x0f;
      const float wy0 = (y0f + 1.0f) - y, wy1 = y - y0f;
      // clamp before the cast so a far (or NaN) location gives a defined
      // integer; its corners are outside and never read
      const int x0 = (int)fminf(fmaxf(x0f, -2.0f), (float)w);
      const int y0 = (int)fminf(fmaxf(y0f, -2.0f), (float)h);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int dy = k >> 1, dx = k & 1;
        const int xx = x0 + dx, yy = y0 + dy;
        if (xx >= 0 && xx < w && yy >= 0 && yy < h) {
          rk[k] = start + yy * w + xx;
          wk[k] = a * ((dy ? wy1 : wy0) * (dx ? wx1 : wx0));
        }
      }
    }
    const int count = min(32, LP - s0);
    for (int j = 0; j < count; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float wj = __shfl_sync(kFull, wk[k], j);
        const int rj = __shfl_sync(kFull, rk[k], j);
        if (rj >= 0) {  // the same for every lane: no divergence
          const float* vr = vbase + (int64_t)rj * row_stride;
#pragma unroll
          for (int c = 0; c < kMaxChunks; ++c) {
            const int d = c * 32 + lane;
            if (d < D) acc[c] = fmaf(wj, __ldg(vr + d), acc[c]);
          }
        }
      }
    }
  }

  // out (N, Lq, M*D): ((n*Lq + q)*M + m)*D = warp*D
  float* o = out + warp * (int64_t)D;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int d = c * 32 + lane;
    if (d < D) o[d] = acc[c];
  }
}

}  // namespace

// value (N, S, M, D), loc (N, Lq, M, L, P, 2), attw (N, Lq, M, L, P) and out
// (N, Lq, M*D) are contiguous f32 device tensors; shapes_hw is host memory
// holding (H_l, W_l) for l < L, whose H*W sum to S.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ms_deform_attn_forward(const void* value, const void* loc, const void* attw,
                                      void* out, const void* shapes_hw, int N, int S, int M,
                                      int D, int Lq, int L, int P, void* stream) {
  if (L < 1 || L > kMaxLevels || D < 1 || D > 32 * kMaxChunks || P < 0)
    return (int)cudaErrorInvalidValue;
  const int* hw = static_cast<const int*>(shapes_hw);
  Levels lv;
  int64_t rows = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.h[l] = l < L ? hw[2 * l] : 0;
    lv.w[l] = l < L ? hw[2 * l + 1] : 0;
    lv.start[l] = (int)rows;
    rows += (int64_t)lv.h[l] * lv.w[l];
  }
  if (rows != S) return (int)cudaErrorInvalidValue;
  const int64_t warps = (int64_t)N * Lq * M;
  if (warps == 0) return 0;
  const unsigned blocks = (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  msda_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attw), static_cast<float*>(out), lv, N, S, M, D, Lq, L, P);
  return (int)cudaGetLastError();
}

extern "C" const char* ms_deform_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
