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

#include "chain.cuh"

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


// ---------------------------------------------------------------------------
// The backward (f32): the gradients of the function above with respect to the
// volume and the grid.  The TPU package has no counterpart: its trainer
// differentiates the XLA warp (warp_impl="packed") with autodiff.  This is
// what the port's training step runs on the card instead.
//
//   grad_vol[b, c, corner_k(p)] += w_k(p) * grad_out[b, c, p]
//   grad_grid[b, p, a] = size_a / 2 * sum_c grad_out[b, c, p]
//                        * sum_k vol[b, c, corner_k] * d w_k / d t_a
//
// with w_k the product of the three tents and d w_k / d t_a the product of the
// other two axes' tents times -1 (the tap at floor(t)) or +1 (the tap above).
// A corner outside the volume contributes nothing to either: its value is
// zero.  At an integer coordinate this takes the cell above it, as
// F.grid_sample's backward does.
//
// Design, for the H100: three kernels on the stream, chained with
// programmatic dependent launch (chain.cuh), each started while the one
// before it drains.
//
//   prep    vol (B, C, D, H, W) -> vol_cl (B, D, H, W, Cp), channels
//           contiguous and zero-padded to Cp = C rounded up to 4, and the
//           accumulator acc (B, D, H, W, Cp) zeroed; 32 x 32 tiles through
//           shared memory, read and written along their contiguous axes.
//   tiles   one block per tile of TILE_Z x TILE_Y x TILE_X output points
//           of one sample, 8 lanes per point, lane j holding channels
//           4j .. 4j + 3 of each chunk of 32 (the tail of C masked).  A lane
//           computes its point's taps with axis_taps, as the forward does;
//           per corner inside the volume it loads its 4 channels of vol_cl
//           with one 16-byte load, adds its share of grad_grid, and adds
//           w_k * grad_out into acc with one vector RED (atomicAdd on a
//           float4: red.global.add.v4.f32, sm_90).  A corner's 32 channels
//           are one 128-byte line of vol_cl and of acc, where NCDHW spread
//           them over 32 planes: at C = 32 a point issues 64 vector REDs and
//           64 16-byte loads, where the first backward kernel issued 256
//           scalar REDs and 256 scalar gathers.  grad_grid is summed over
//           the 8 lanes with shuffles and written once per point.
//   finish  acc -> grad_vol (B, C, D, H, W), tiled as prep.
//
// The kernels write grad_vol and grad_grid whole, so the wrapper allocates
// them empty; vol_cl and acc are its scratch.  Offsets are 64-bit.
//
// What bounds it.  The function's own bytes (vol, grid and grad_out read
// once, grad_vol and grad_grid written once) are 214 MB at CANONICAL B=8,
// C=32: 0.064 ms at 3.35 TB/s (chip_smoke.py's warp_bwd_bound; the first
// kernel's header said 0.10 ms, counting also the 67 MB memset of grad_vol
// and the 67 MB its REDs read back).  This design moves about 616 MB: prep
// 201, tiles 281 or more (vol_cl, grad_out, the grid and grad_grid, and
// acc read and written under the REDs: 67 MB does not stay in the 50 MB
// L2), finish 134; 0.18 ms at the memory rate.  The tiles kernel takes
// about two thirds of the call: each lane runs a chain of dependent memory
// operations (grid, grad_out, then per corner a load and a RED), so the
// warps resident per SM set its time, not the bytes or the REDs' count.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md section 6 row 9), whole
// call at CANONICAL B=8 f32: 0.352 ms on the noisy smooth field, 0.374 on
// the random one, 0.342 on a turned one (a head turning), against 1.225,
// 2.084 and 0.849 for the first backward kernel (one thread per point,
// scalar f32 atomics into a zeroed NCDHW grad_vol) and 1.247, 1.972 and
// 0.850 for aten::grid_sampler_3d_backward.  On the training step's seeded,
// near-identity fields it takes 0.339 and 0.342 against the first kernel's
// 0.356 and 0.373, but the library is faster (0.275 and 0.291): there its
// NCDHW atomics from neighbouring threads fall on one line, and this design
// pays its 0.13 ms layout round trip.  Tried and dropped:
//   - a per-tile box of grad_vol in shared memory, flushed with one RED per
//     box voxel and 4 channels, in two forms (f32 shared atomics; the
//     tile's (point, corner) pairs sorted by voxel): 1.3 to 1.9x slower on
//     the smooth field, where every tile's box fitted, since the REDs do
//     not bound the tiles kernel and the box costs barriers and occupancy;
//   - gathering the corners from the NCDHW volume and skipping vol_cl:
//     1.35x slower on the smooth field, 3.2x on the random one;
//   - tiles whose rows of 32 points fall on distinct voxels of at most 4
//     lines scattered in NCDHW with scalar REDs, the round trip skipped
//     where no tile needs it: 0.37 to 0.49 ms on the training step's
//     fields, which it classed coherent, against 0.34 without it;
//   - returning acc as a channels_last_3d grad_vol, without finish: the
//     consumer's copy to NCDHW (PyTorch's) takes 0.144 ms, finish 0.059.
//
// Constants, chosen on the card by timing variants of this source built with
// other values: tiles of 1 x 4 x 32 points (rows of 32 along x:
// neighbouring lanes read and RED neighbouring lines), blocks of 256
// threads (4 passes of 32 points), at most 80 registers with 3 blocks per
// SM, no spills.  4 blocks per SM (64 registers, 16 bytes spilled), tiles
// of 2 x 8 x 8 or 1 x 1 x 32 and blocks of 512 were within 3 %; 5 blocks
// per SM (48 registers) 11 to 19 % slower.

constexpr int TILE_Z = 1, TILE_Y = 4, TILE_X = 32;
constexpr int TILE_POINTS = TILE_Z * TILE_Y * TILE_X;
constexpr int BWD_THREADS = 256;
constexpr int BWD_MIN_BLOCKS = 3;  // blocks per SM: at most 80 registers
constexpr int LANES = 8;           // lanes per output point, 4 channels each
constexpr int CHUNK = 4 * LANES;   // channels per sweep over the tile
constexpr int POINTS_PER_PASS = BWD_THREADS / LANES;
constexpr int PASSES = (TILE_POINTS + POINTS_PER_PASS - 1) / POINTS_PER_PASS;
constexpr int TT = 32;  // transpose tile: 32 voxels x 32 channels

struct BwdShape {
  int C, Cp, D, H, W, Do, Ho, Wo, tiles_z, tiles_y, tiles_x;
};

// vol (B, C, S) -> vol_cl (B, S, Cp), channels zero-padded to Cp; the
// accumulator acc (B, S, Cp) zeroed.  Blocks of 32 x 8 threads, one 32 x 32
// tile each through shared memory, so both sides are read and written along
// their contiguous axis.
__global__ void __launch_bounds__(TT * 8) bwd_prep_kernel(const float* __restrict__ vol,
                                                         float* __restrict__ vol_cl,
                                                         float* __restrict__ acc, int C, int Cp,
                                                         int64_t S) {
  __shared__ float t[TT][TT + 1];
  allow_next_grid();
  const int64_t s0 = (int64_t)blockIdx.x * TT, b = blockIdx.z;
  const int c0 = blockIdx.y * TT, tx = threadIdx.x;
#pragma unroll
  for (int r = threadIdx.y; r < TT; r += 8) {
    const int c = c0 + r;
    const int64_t s = s0 + tx;
    t[r][tx] = (c < C && s < S) ? vol[(b * C + c) * S + s] : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int r = threadIdx.y; r < TT; r += 8) {
    const int64_t s = s0 + r;
    const int c = c0 + tx;
    if (s < S && c < Cp) {
      const int64_t o = (b * S + s) * Cp + c;
      vol_cl[o] = t[tx][r];
      acc[o] = 0.0f;
    }
  }
}

// acc (B, S, Cp) -> grad_vol (B, C, S), the same tiling
__global__ void __launch_bounds__(TT * 8) bwd_finish_kernel(const float* __restrict__ acc,
                                                           float* __restrict__ gvol, int C,
                                                           int Cp, int64_t S) {
  __shared__ float t[TT][TT + 1];
  wait_for_prior_grid();
  const int64_t s0 = (int64_t)blockIdx.x * TT, b = blockIdx.z;
  const int c0 = blockIdx.y * TT, tx = threadIdx.x;
#pragma unroll
  for (int r = threadIdx.y; r < TT; r += 8) {
    const int64_t s = s0 + r;
    const int c = c0 + tx;
    t[r][tx] = (s < S && c < C) ? acc[(b * S + s) * Cp + c] : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int r = threadIdx.y; r < TT; r += 8) {
    const int c = c0 + r;
    const int64_t s = s0 + tx;
    if (c < C && s < S) gvol[(b * C + c) * S + s] = t[tx][r];
  }
}

// point i of a tile (x fastest) -> its flat index p in (Do, Ho, Wo); false
// where the tile overhangs the output's edge
__device__ __forceinline__ bool tile_point(int i, int tz, int ty, int tx, const BwdShape& sh,
                                           int64_t& p) {
  const int zo = tz * TILE_Z + i / (TILE_Y * TILE_X);
  const int yo = ty * TILE_Y + (i / TILE_X) % TILE_Y;
  const int xo = tx * TILE_X + i % TILE_X;
  p = ((int64_t)zo * sh.Ho + yo) * sh.Wo + xo;
  return i < TILE_POINTS && zo < sh.Do && yo < sh.Ho && xo < sh.Wo;
}

// one vector RED of 4 f32 (red.global.add.v4.f32, sm_90)
__device__ __forceinline__ void red_add4(float* p, float a, float b, float c, float d) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}

// One block per tile of TILE_Z x TILE_Y x TILE_X output points of one
// sample; 8 lanes per point, lane j holding channels c0 + 4j .. + 3 of each
// chunk of 32.
__global__ void __launch_bounds__(BWD_THREADS, BWD_MIN_BLOCKS) warp3d_backward_kernel(
    const float* __restrict__ vol_cl, const float* __restrict__ grid,
    const float* __restrict__ gout, float* __restrict__ acc, float* __restrict__ ggrid,
    BwdShape sh) {
  int t = blockIdx.x;
  const int tx = t % sh.tiles_x;
  t /= sh.tiles_x;
  const int ty = t % sh.tiles_y;
  t /= sh.tiles_y;
  const int tz = t % sh.tiles_z;
  const int64_t b = t / sh.tiles_z;
  const int64_t P = (int64_t)sh.Do * sh.Ho * sh.Wo;
  const int64_t S = (int64_t)sh.D * sh.H * sh.W;
  const int lane = threadIdx.x % LANES, slot = threadIdx.x / LANES;
  const float* vb = vol_cl + b * S * sh.Cp;
  float* ab = acc + b * S * sh.Cp;
  const float* gob = gout + b * sh.C * P;

  wait_for_prior_grid();  // vol_cl written, acc zeroed
  allow_next_grid();

#pragma unroll 1
  for (int q = 0; q < PASSES; ++q) {
    int64_t p;
    const bool mine = tile_point(q * POINTS_PER_PASS + slot, tz, ty, tx, sh, p);
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
    if (mine) {
      const float* g = grid + (b * P + p) * 3;
      const Axis ax = axis_taps(g[0], sh.W);
      const Axis ay = axis_taps(g[1], sh.H);
      const Axis az = axis_taps(g[2], sh.D);
#pragma unroll 1
      for (int c = 4 * lane; c < sh.C; c += CHUNK) {
        float go[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) go[e] = c + e < sh.C ? gob[(int64_t)(c + e) * P + p] : 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int dz = k >> 2, dy = (k >> 1) & 1, dx = k & 1;
          if (!((dz ? az.v1 : az.v0) && (dy ? ay.v1 : ay.v0) && (dx ? ax.v1 : ax.v0))) continue;
          const float wz = dz ? az.w1 : az.w0;
          const float wy = dy ? ay.w1 : ay.w0;
          const float wx = dx ? ax.w1 : ax.w0;
          const int64_t vox = ((int64_t)(az.i0 + dz) * sh.H + (ay.i0 + dy)) * sh.W + (ax.i0 + dx);
          const float4 v = __ldg(reinterpret_cast<const float4*>(vb + vox * sh.Cp + c));
          const float s = go[0] * v.x + go[1] * v.y + go[2] * v.z + go[3] * v.w;
          sx += (dx ? 1.0f : -1.0f) * wy * wz * s;
          sy += (dy ? 1.0f : -1.0f) * wx * wz * s;
          sz += (dz ? 1.0f : -1.0f) * wx * wy * s;
          const float w = wz * wy * wx;
          red_add4(ab + vox * sh.Cp + c, w * go[0], w * go[1], w * go[2], w * go[3]);
        }
      }
    }
    // grad_grid: the sum over the point's 8 lanes, written by its first lane
#pragma unroll
    for (int o = 1; o < LANES; o <<= 1) {
      sx += __shfl_xor_sync(0xffffffffu, sx, o);
      sy += __shfl_xor_sync(0xffffffffu, sy, o);
      sz += __shfl_xor_sync(0xffffffffu, sz, o);
    }
    if (mine && lane == 0) {
      float* gg = ggrid + (b * P + p) * 3;
      gg[0] = sx * (float)sh.W * 0.5f;
      gg[1] = sy * (float)sh.H * 0.5f;
      gg[2] = sz * (float)sh.D * 0.5f;
    }
  }
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

// f32 only, all contiguous: vol (B, C, D, H, W), grid (B, Do, Ho, Wo, 3),
// grad_out (B, C, Do, Ho, Wo); writes grad_vol (B, C, D, H, W) and
// grad_grid (B, Do, Ho, Wo, 3) whole.  scratch holds 2 * B * D * H * W * Cp
// floats (the channels-last volume, then the accumulator), Cp = C rounded up
// to a multiple of 4.  Three kernels, chained: prep, tiles, finish.  Returns
// the cudaError_t of the launches (0 on success).
extern "C" int warp3d_backward(const void* vol, const void* grid, const void* grad_out,
                               void* grad_vol, void* grad_grid, void* scratch, int B, int C,
                               int Cp, int D, int H, int W, int Do, int Ho, int Wo,
                               void* stream) {
  const int64_t S = (int64_t)D * H * W;
  if ((int64_t)B * C * Do * Ho * Wo == 0 || S == 0) return 0;
  if (Cp % 4 != 0 || Cp < C || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* vol_cl = static_cast<float*>(scratch);
  float* acc = vol_cl + (int64_t)B * S * Cp;
  const dim3 tgrid((unsigned)((S + TT - 1) / TT), (unsigned)((Cp + TT - 1) / TT), (unsigned)B);
  bwd_prep_kernel<<<tgrid, dim3(TT, 8), 0, s>>>(static_cast<const float*>(vol), vol_cl, acc, C,
                                                 Cp, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const BwdShape sh{C,  Cp, D,  H,  W, Do, Ho, Wo, (Do + TILE_Z - 1) / TILE_Z,
                    (Ho + TILE_Y - 1) / TILE_Y, (Wo + TILE_X - 1) / TILE_X};
  const int64_t tiles = (int64_t)B * sh.tiles_z * sh.tiles_y * sh.tiles_x;
  err = launch_after_prior(warp3d_backward_kernel, dim3((unsigned)tiles), dim3(BWD_THREADS), s,
                           static_cast<const float*>(vol_cl), static_cast<const float*>(grid),
                           static_cast<const float*>(grad_out),
                           acc, static_cast<float*>(grad_grid), sh);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_after_prior(bwd_finish_kernel, tgrid, dim3(TT, 8), s,
                                 static_cast<const float*>(acc), static_cast<float*>(grad_vol),
                                 C, Cp, S);
}
