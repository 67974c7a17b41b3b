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
// the TPU's matrix unit.  Hopper gathers natively, so here it is a direct
// gather, one launch for all levels.
//
// What bounds it on the H100.  At the full-width encoder call (N=1,
// Lq=22,323, M=8, D=32, L=P=4) it must read the locations (22.9 MB), the
// weights (11.4 MB) and the value (22.9 MB) and write the output (22.9 MB):
// 80 MB, 24 us at 3.35 TB/s, against about 0.9 GFLOP (14 us at 67 TFLOP/s
// f32).  But the corner reads are 1.46 GB of 128-byte lines (one line per
// corner, sample, query and head), 64 per query and head; the 22.9 MB value
// fits the 50 MB L2, so the gathers' latency and L2 traffic are the limit.
// A kernel that walks the 16 samples one after the other keeps only 4
// lines in flight per warp and waits on L2 sixteen times per query.  So:
//
//   - A block is a run of 16 consecutive queries of one head: grid (query
//     tile, m, n), 8 warps, each warp one query at a time (queries q0 + w
//     and q0 + w + 8).  A block's warps read one head's 128-byte slice of
//     the value rows, so the small levels' lines (level 3 is 35 KB per
//     head at full width) can stay in the SM's L1.  Neighbouring encoder
//     queries also sample overlapping corners, but tiles of 32 to 128
//     queries ran slower than 16 on the card, at random locations and at
//     locations near each query's own pixel (a throwaway sweep, not kept):
//     the gain is in loads in flight, not in reuse between queries.
//   - Every corner load of a query is in flight before the first sum.  The
//     lanes first compute the (row, weight) pair of every sample and corner
//     (L*P*4 = 64 at XPose's shape, two per lane); a corner outside its
//     level gets row 0 and weight 0 by a select, so every load is
//     unconditional and a far or NaN location adds exactly 0 (the location
//     is clamped before the float-to-int cast, so its row is defined).
//   - XPose's shape (D = 32, L*P = 16) is an instantiation unrolled at
//     compile time: 8 lanes read one corner's 128-byte line as float4s, so
//     one warp instruction fetches 4 corners and a query-head is 16
//     independent loads, all issued before the first sum in the source;
//     each lane sums its 4 channels over its 16 corners, two
//     __shfl_xor_sync steps per channel add the 4 corner groups, and 8
//     lanes write the 128-byte output row.  ptxas fits this instantiation
//     in 42 registers, fewer than 16 float4s take, so it overlaps part of
//     the loads with the sums; 6 blocks (48 warps) per SM cover the rest.
//   - Every other shape (D <= 128, any L*P) takes the instantiation with
//     loops: 8 samples' 32 corners at a time, lanes over channels in
//     32-channel chunks, each chunk's 32 loads issued before its sums.
//
// Sums stay in f32, in another order than the plain version's (within its
// 1e-5 relative tolerance).  Level starts and shapes come in as a kernel
// argument; offsets are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxChunks = 4;  // D <= 32 * kMaxChunks
constexpr int kWarps = 8;      // warps per block
constexpr int kQueriesPerWarp = 2;  // a block's tile: 16 queries
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];  // first row of the level on value's S axis
};

struct Geometry {
  int S, M, D, Lq, L, P;
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

// Corner k = (dy, dx) of sample s (s < L*P, else row 0, weight 0): its row
// of value and its weight, the attention weight times grid_sample's
// bilinear weight, or row 0 and weight 0 where the corner lies outside.
__device__ __forceinline__ void corner_pair(const Levels& lv, const Geometry& g,
                                            const float* loc_w, const float* att_w, int s,
                                            int k, int& row, float& wt) {
  row = 0;
  wt = 0.0f;
  if (s >= g.L * g.P) return;
  int h, w, start;
  level_of(lv, s / g.P, h, w, start);
  const float a = __ldg(att_w + s);
  const float gx = 2.0f * __ldg(loc_w + 2 * s) - 1.0f;
  const float gy = 2.0f * __ldg(loc_w + 2 * s + 1) - 1.0f;
  const float x = ((gx + 1.0f) * (float)w - 1.0f) * 0.5f;
  const float y = ((gy + 1.0f) * (float)h - 1.0f) * 0.5f;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const int dy = k >> 1, dx = k & 1;
  // grid_sample's weights: nw = (x1 - x)(y1 - y), ne = (x - x0)(y1 - y),
  // sw = (x1 - x)(y - y0), se = (x - x0)(y - y0)
  const float wx = dx ? x - x0f : (x0f + 1.0f) - x;
  const float wy = dy ? y - y0f : (y0f + 1.0f) - y;
  // clamp before the cast so a far (or NaN) location gives a defined
  // integer; its corners are outside
  const int xx = (int)fminf(fmaxf(x0f, -2.0f), (float)w) + dx;
  const int yy = (int)fminf(fmaxf(y0f, -2.0f), (float)h) + dy;
  const bool inside = xx >= 0 && xx < w && yy >= 0 && yy < h;
  row = inside ? start + yy * w + xx : 0;
  wt = inside ? a * (wy * wx) : 0.0f;  // a select: 0 * NaN would be NaN
}

// XPose's shape, D = 32 and L*P = 16: 16 float4 loads per lane, all in flight
__device__ __forceinline__ void gather_d32_s16(const Levels& lv, const Geometry& g,
                                               const float* vbase, int64_t row_stride,
                                               const float* loc_w, const float* att_w,
                                               float* o, int lane) {
  // pair p = 4 * sample + corner lives in lane p % 32, register p / 32
  int row[2];
  float wt[2];
  corner_pair(lv, g, loc_w, att_w, lane >> 2, lane & 3, row[0], wt[0]);
  corner_pair(lv, g, loc_w, att_w, 8 + (lane >> 2), lane & 3, row[1], wt[1]);
  const int grp = lane >> 3;        // the corner this lane reads
  const int ch = (lane & 7) * 4;    // and its 4 channels
  float4 v[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int r = __shfl_sync(kFull, row[j >> 3], 4 * (j & 7) + grp);
    v[j] = __ldg(reinterpret_cast<const float4*>(vbase + (int64_t)r * row_stride + ch));
  }
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float w = __shfl_sync(kFull, wt[j >> 3], 4 * (j & 7) + grp);
    acc.x = fmaf(w, v[j].x, acc.x);
    acc.y = fmaf(w, v[j].y, acc.y);
    acc.z = fmaf(w, v[j].z, acc.z);
    acc.w = fmaf(w, v[j].w, acc.w);
  }
  // lanes l, l ^ 8, l ^ 16 and l ^ 24 hold the same channels of the 4 corners
#pragma unroll
  for (int off = 8; off <= 16; off <<= 1) {
    acc.x += __shfl_xor_sync(kFull, acc.x, off);
    acc.y += __shfl_xor_sync(kFull, acc.y, off);
    acc.z += __shfl_xor_sync(kFull, acc.z, off);
    acc.w += __shfl_xor_sync(kFull, acc.w, off);
  }
  if (lane < 8) *reinterpret_cast<float4*>(o + ch) = acc;
}

// Any shape: 8 samples' 32 corners at a time, lanes over channels
__device__ __forceinline__ void gather_any(const Levels& lv, const Geometry& g,
                                           const float* vbase, int64_t row_stride,
                                           const float* loc_w, const float* att_w, float* o,
                                           int lane) {
  float acc[kMaxChunks];
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) acc[c] = 0.0f;
  for (int s0 = 0; s0 < g.L * g.P; s0 += 8) {
    int row;
    float wt;
    corner_pair(lv, g, loc_w, att_w, s0 + (lane >> 2), lane & 3, row, wt);
    int r[32];
    float w[32];
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      r[t] = __shfl_sync(kFull, row, t);
      w[t] = __shfl_sync(kFull, wt, t);
    }
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (c * 32 >= g.D) break;  // the same for every lane
      const int d = c * 32 + lane;
      float v[32];
#pragma unroll
      for (int t = 0; t < 32; ++t)
        v[t] = d < g.D ? __ldg(vbase + (int64_t)r[t] * row_stride + d) : 0.0f;
#pragma unroll
      for (int t = 0; t < 32; ++t) acc[c] = fmaf(w[t], v[t], acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int d = c * 32 + lane;
    if (d < g.D) o[d] = acc[c];
  }
}

template <bool kD32S16>
__global__ void __launch_bounds__(kWarps * 32) msda_kernel(
    const float* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ attw, float* __restrict__ out, const Levels lv, const Geometry g) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.y, n = blockIdx.z;
  const int LP = g.L * g.P;
  // value (N, S, M, D): row r of head m at ((n*S + r)*M + m)*D
  const float* vbase = value + ((int64_t)n * g.S * g.M + m) * g.D;
  const int64_t row_stride = (int64_t)g.M * g.D;
  const int q0 = blockIdx.x * kWarps * kQueriesPerWarp + (threadIdx.x >> 5);
#pragma unroll 1
  for (int i = 0; i < kQueriesPerWarp; ++i) {
    const int q = q0 + i * kWarps;
    if (q >= g.Lq) return;  // the whole warp leaves together
    // loc (N, Lq, M, L, P, 2), weights (N, Lq, M, L, P), out (N, Lq, M*D):
    // this query-head's samples and output row start at task * L*P, * D
    const int64_t task = ((int64_t)n * g.Lq + q) * g.M + m;
    const float* loc_w = loc + task * LP * 2;
    const float* att_w = attw + task * LP;
    float* o = out + task * g.D;
    if (kD32S16)
      gather_d32_s16(lv, g, vbase, row_stride, loc_w, att_w, o, lane);
    else
      gather_any(lv, g, vbase, row_stride, loc_w, att_w, o, lane);
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
  if (L < 1 || L > kMaxLevels || D < 1 || D > 32 * kMaxChunks || P < 0 || N > 65535 ||
      M > 65535)
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
  if ((int64_t)N * Lq * M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 0)  // no value rows: every corner lies outside
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * N * Lq * M * D, s);
  const Geometry g{S, M, D, Lq, L, P};
  constexpr int tile = kWarps * kQueriesPerWarp;
  const dim3 grid((unsigned)((Lq + tile - 1) / tile), (unsigned)M, (unsigned)N);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(value) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const float* v = static_cast<const float*>(value);
  const float* lc = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(attw);
  float* o = static_cast<float*>(out);
  if (D == 32 && L * P == 16 && aligned)
    msda_kernel<true><<<grid, kWarps * 32, 0, s>>>(v, lc, a, o, lv, g);
  else
    msda_kernel<false><<<grid, kWarps * 32, 0, s>>>(v, lc, a, o, lv, g);
  return (int)cudaGetLastError();
}

extern "C" const char* ms_deform_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
