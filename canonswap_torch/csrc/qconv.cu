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
// 1. absmax_kernel (quant.cuh, shared with the W8A8 warp): max |x| per
//    sample, 16-byte loads, a block reduction and one atomicMax per block on
//    the float's bits (non-negative floats order as unsigned).
// 2. quantize_weight_kernel: one block per output channel: its step from
//    max |w[co]|, then w (Cout, Cin, taps) -> wk (Cout, taps, Cp) int8,
//    channels zero-padded, and the bias to f32.  The weight is quantized at
//    every call, as the JAX package does inside its jitted function.
// 3. quantize_act_kernel (quant.cuh): x (N, C, P) f32/bf16 (P = D*H*W) ->
//    xq (N, P, Cp) int8, channels contiguous and zero-padded to Cp (here a
//    multiple of 32):
//    16-byte loads along P, transposed through shared memory, 16-byte stores
//    along C.  IEEE division and rintf (round half to even, as jnp.round),
//    never roundf or __fdividef.
// 4. The implicit GEMM on the int8 tensor cores, M = N*P output points,
//    N = Cout, K = taps * Cp, with wgmma.mma_async m64nNk32.s32.s8.s8 (both
//    operands K-major in shared memory, as int8 requires; xq and wk already
//    are).  One of two kernels, chosen by shape:
//
//    qconv_wgmma_kernel: a 128 x BN tile (BN = 256 for Cout > 128, 128, or
//    32), 384 threads: two consumer warpgroups of 64 rows each and one
//    producer warpgroup, joined by a ring of 4 stages (full and empty
//    mbarriers).  A stage is 128 bytes of K in 128-byte-swizzled rows: B (wk)
//    comes by TMA (tiled); A by TMA im2col where one stage is one tap's 128
//    channels of a 2D conv (Cp % 128 == 0: the hardware walks the 128 points
//    of the tile from the filter window's origin and fills the SAME padding
//    with zeros), else by the producer's 16-byte cp.async gathers (four
//    32-byte chunks of (tap, 32 channels) per row and stage, the tap
//    advanced by counters, no division per copy), written in the same
//    swizzled layout and completed on the same mbarrier.
//
//    qconv_halo_kernel, the 3D chains (Cp = 32, W = 64, Cout <= 32): a CTA
//    loads once the input halo its 256 points share and B whole; each tap's
//    A operand is a descriptor offset into the halo (see the kernel).
//
//    Epilogue (store_tile): y = fma(float(acc), sx[n] * sw[co], bias[co]),
//    the scale product rounded first as in the plain version, staged through
//    shared memory and written NC(D)HW in 16-byte runs of points.
//
// What bounds it on the H100: the adaptive and middle sites (Cin 512, K =
// 4,608) are bound by operations; the 128 x 256 tile with a ring of 4
// stages keeps the tensor cores fed from L2 (48 KB per stage for 8.4 M
// operations).  Short-K sites (K = 1,152, Cin 128) spend a larger share in
// the tile's prologue and epilogue, which one tile per CTA does not hide.
// The 3D chains move more bytes than they compute: their gathers from L2
// (27 taps of every pixel) were what bounded them, which the halo tile
// removes; the quantization passes then read and write at the memory rate
// and are a large share of the small sites' time.
//
// Overflow: |acc| <= 127 * 127 * Cin * taps, below 2**31 for every shape of
// the path (at most 127^2 * 512 * 9).  Offsets are 64-bit where they can
// pass 2**31; the wrapper holds the sizes below it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "quant.cuh"

namespace {

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
// 4. implicit GEMM on the int8 tensor cores: wgmma, fed through an mbarrier ring

constexpr int BM = 128;     // output points per tile: one 64-row slab per consumer warpgroup
constexpr int BK = 128;     // bytes (= int8 channels) of K per stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and one producer warpgroup
constexpr int CHUNK = 32;   // bytes of K per gathered chunk (cp.async path)
constexpr int A_BYTES = BM * BK;

struct Geometry {
  int Cp, D, H, W, Cout, kd, kh, kw;
  int P;       // D*H*W
  int M;       // N*P
  int KT;      // stages of K: ceil(taps * Cp / BK)
  int KC;      // 32-byte chunks of K: taps * Cp / 32
  int tma_a;   // 1: A by TMA im2col (2D, Cp % 128 == 0); 0: cp.async gathers
};

template <int BN>
struct Tile {
  static constexpr int B_BYTES = BN * BK;
  static constexpr int STAGE = A_BYTES + B_BYTES;  // a multiple of 1024
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + slack to align to 1024
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// the barrier counts one arrival when the thread's cp.asyncs so far complete
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// B: a (BK bytes of K) x (BN rows) box of wk at (k0, row0)
__device__ __forceinline__ void tma_tile_2d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int k0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k0), "r"(row0)
      : "memory");
}

// A: BM pixels of 128 channels from c0, walking (w, h, n) from the filter
// window's origin (w, h) of the tile's first output point, each read at
// (w + dx, h + dy); outside the image the hardware fills zeros
__device__ __forceinline__ void tma_im2col_4d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                              int c0, int w, int h, int n, uint16_t dx,
                                              uint16_t dy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(w), "r"(h),
      "r"(n), "h"(dx), "h"(dy)
      : "memory");
}

// a K-major operand in 128-byte-swizzled rows, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

template <int BN>
__device__ void wgmma_s8(int* d, uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<32>(int* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int R>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The epilogue of a 128-point tile held as two 64-row wgmma accumulators
// (consumer warpgroup tid / 128 holds rows 64 * (tid / 128) ..):
// y = fma(acc, sx[n] * sw[co], bias[co]) in f32, the scale product first (the
// plain version's order), staged through shared memory (idle by then) as
// [channel][point] and written NC(D)HW in 16-byte runs of points; ragged M,
// Cout and samples masked.  Called by the 256 consumer threads together.
template <int BN, typename OT>
__device__ __forceinline__ void store_tile(const int* acc, uint8_t* smem, int m0, int n0, int tid,
                                           const float* __restrict__ amax,
                                           const float* __restrict__ sw,
                                           const float* __restrict__ bias, OT* __restrict__ out,
                                           const Geometry& g) {
  constexpr int LD = BM + 16 / (int)sizeof(OT);  // a padded channel row
  OT* stage_out = reinterpret_cast<OT*>(smem);
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");  // both slabs done with smem
  const int cw = tid / 128, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = cw * 64 + warp * 16 + (lane >> 2);
  float sxn[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + r0 + 8 * h;
    sxn[h] = m < g.M ? step_of(amax[m / g.P]) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int cl = 8 * i + 2 * (lane & 3) + j;
      const int co = n0 + cl;
      const float swc = co < g.Cout ? sw[co] : 0.0f;
      const float b = (bias && co < g.Cout) ? bias[co] : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float scale = __fmul_rn(sxn[h], swc);
        const float y = __fmaf_rn((float)acc[4 * i + 2 * h + j], scale, b);
        stage_out[cl * LD + r0 + 8 * h] = from_f32<OT>(y);
      }
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  constexpr int VEC = 16 / (int)sizeof(OT);  // points per 16-byte store
  constexpr int VPR = BM / VEC;
  const bool whole = g.P % VEC == 0;  // every run of VEC points lies in one sample
  for (int i = tid; i < BN * VPR; i += CONSUMERS) {
    const int cl = i / VPR, v = i - cl * VPR;
    const int co = n0 + cl;
    const int m = m0 + v * VEC;
    if (co >= g.Cout || m >= g.M) continue;
    const OT* src = stage_out + cl * LD + v * VEC;
    if (whole) {
      const int n = m / g.P;
      *reinterpret_cast<int4*>(out + ((int64_t)n * g.Cout + co) * g.P + (m - n * g.P)) =
          *reinterpret_cast<const int4*>(src);
    } else {
      for (int e = 0; e < VEC && m + e < g.M; ++e) {
        const int n = (m + e) / g.P;
        out[((int64_t)n * g.Cout + co) * g.P + (m + e - n * g.P)] = src[e];
      }
    }
  }
}

// The kernel: 384 threads, one BM x BN output tile.  Warpgroups 0 and 1
// consume (64 rows each, m64nBNk32 products, the sums in registers);
// warpgroup 2 produces (the loads of each stage into a ring of STAGES).
template <int BN, typename OT>
__global__ void __launch_bounds__(THREADS, BN == 32 ? 2 : 1) qconv_wgmma_kernel(
    __grid_constant__ const CUtensorMap a_map, __grid_constant__ const CUtensorMap b_map,
    const int8_t* __restrict__ xq, const float* __restrict__ amax,
    const float* __restrict__ sw, const float* __restrict__ bias, OT* __restrict__ out,
    const Geometry g) {
  using T = Tile<BN>;
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // full: the TMA thread's expect_tx, and in the cp.async path one
      // arrival per producer thread as well; empty: one per consumer warp
      mbar_init(&full_bar[s], g.tma_a ? 1 : 1 + 128);
      mbar_init(&empty_bar[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warpgroup ----
    if constexpr (BN == 256) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int pt = tid - CONSUMERS;
    const int pz = g.kd / 2, py = g.kh / 2, px = g.kw / 2;
    if (g.tma_a) {
      if (pt == 0) {
        // one thread: the tile's first point, then per stage one tap x 128
        // channels of A (im2col) and the matching 128 bytes of K of B
        const int n = m0 / g.P, sp = m0 - n * g.P;
        const int y = sp / g.W, x = sp - y * g.W;
        const int cpt = g.Cp / BK;  // stages per tap
        int cb = 0, dx = 0, dy = 0;
        for (int kt = 0; kt < g.KT; ++kt) {
          const int s = kt % STAGES;
          mbar_wait(&empty_bar[s], ((kt / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full_bar[s], A_BYTES + T::B_BYTES);
          const uint32_t as = smem_u32(smem + s * T::STAGE);
          tma_im2col_4d(as, &a_map, &full_bar[s], cb * BK, x - px, y - py, n, (uint16_t)dx,
                        (uint16_t)dy);
          tma_tile_2d(as + A_BYTES, &b_map, &full_bar[s], kt * BK, n0);
          if (++cb == cpt) {
            cb = 0;
            if (++dx == g.kw) { dx = 0; ++dy; }
          }
        }
      }
    } else {
      // every thread gathers its row: per stage four 32-byte chunks (a tap's
      // 32 channels each), two 16-byte cp.asyncs per chunk, written where
      // the 128-byte swizzle puts them; zeros outside the volume
      const int m = m0 + pt;
      const bool row_ok = m < g.M;
      int n = 0, z = 0, y = 0, x = 0;
      if (row_ok) {
        n = m / g.P;
        const int sp = m - n * g.P;
        z = sp / (g.H * g.W);
        const int yx = sp - z * g.H * g.W;
        y = yx / g.W;
        x = yx - y * g.W;
      }
      const int8_t* xn = xq + (int64_t)n * g.P * g.Cp;
      const int cpt = g.Cp / CHUNK;  // chunks per tap
      const int swz = pt & 7;
      int kc = 0, cb = 0, dx = 0, dy = 0, dz = 0;
      for (int kt = 0; kt < g.KT; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty_bar[s], ((kt / STAGES) & 1) ^ 1);
        const uint32_t as = smem_u32(smem + s * T::STAGE);
        if (pt == 0) {
          mbar_arrive_expect_tx(&full_bar[s], T::B_BYTES);
          tma_tile_2d(as + A_BYTES, &b_map, &full_bar[s], kt * BK, n0);
        }
        const uint32_t row = as + pt * BK;
#pragma unroll
        for (int j = 0; j < BK / CHUNK; ++j, ++kc) {
          const int zi = z + dz - pz, yi = y + dy - py, xi = x + dx - px;
          const bool ok = row_ok && kc < g.KC && zi >= 0 && zi < g.D && yi >= 0 && yi < g.H &&
                          xi >= 0 && xi < g.W;
          const int8_t* src =
              ok ? xn + ((int64_t)(zi * g.H + yi) * g.W + xi) * g.Cp + cb * CHUNK : xq;
          cp_async16(row + (((2 * j) ^ swz) << 4), src, ok ? 16 : 0);
          cp_async16(row + (((2 * j + 1) ^ swz) << 4), ok ? src + 16 : xq, ok ? 16 : 0);
          if (++cb == cpt) {
            cb = 0;
            if (++dx == g.kw) {
              dx = 0;
              if (++dy == g.kh) { dy = 0; ++dz; }
            }
          }
        }
        cp_async_arrive_noinc(&full_bar[s]);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
  } else {
    // ---- consumer warpgroups ----
    if constexpr (BN == 256) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int cw = tid / 128;  // rows cw * 64 .. cw * 64 + 63 of the tile
    int acc[BN / 2];  // the first product overwrites it (scale-d 0)
    for (int kt = 0; kt < g.KT; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full_bar[s], (kt / STAGES) & 1);
      // cp.async wrote A through the generic proxy; wgmma reads the async one
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint32_t as = smem_u32(smem + s * T::STAGE);
      const uint64_t da = smem_desc(as + cw * 64 * BK), db = smem_desc(as + A_BYTES);
      fence_regs<BN / 2>(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk, (kt | kk) != 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the previous stage's products are done: hand its buffers back
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_regs<BN / 2>(acc);
      if (kt > 0 && (tid & 31) == 0) mbar_arrive(&empty_bar[(kt - 1) % STAGES]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs<BN / 2>(acc);

    store_tile<BN, OT>(acc, smem, m0, n0, tid, amax, sw, bias, out, g);
  }
}

// The 3D chains' kernel: Cp = 32 (a tap is one 32-byte step of K, a
// single m64n32k32 product), W = 64 (a 64-row slab is one row of points),
// Cout <= 32.  A CTA of the two consumer warpgroups computes 2 * HALO_SLABS
// rows of points of one (sample, z); it loads once the input they share,
// kd z-slabs x (2 * HALO_SLABS + kh - 1) rows x (W + kw - 1) pixels with
// zeros outside the volume, in the no-swizzle K-major layout: each 16-byte
// half of a pixel in its own array, pixel i at 16 * i.  An 8-row core matrix
// is then 128 contiguous bytes from any pixel, so each tap's A operand is a
// descriptor offset into the halo, not a copy: the taps read shared memory
// kd * kh * kw times and device memory once.  B (all of K, at most 32 rows)
// is loaded whole, in the ring's swizzled layout.
constexpr int HALO_SLABS = 2;  // 64-point slabs per consumer warpgroup

struct HaloShape {
  int rows, cols, pix;  // the halo tile: rows and pixels per z-slab row, pixels in all
  int bytes;            // B then the halo's two arrays
};

__host__ __device__ inline HaloShape halo_shape(const Geometry& g) {
  HaloShape h;
  h.rows = 2 * HALO_SLABS + g.kh - 1;
  h.cols = g.W + g.kw - 1;
  h.pix = g.kd * h.rows * h.cols;
  h.bytes = g.KT * 32 * BK + 2 * h.pix * 16;
  return h;
}

// a K-major operand without swizzle: 8-row core matrices of 128 contiguous
// bytes, the two 16-byte halves of K `lbo` bytes apart, 8-row groups 128
__device__ __forceinline__ uint64_t halo_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

template <typename OT>
__global__ void __launch_bounds__(CONSUMERS, 3) qconv_halo_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ wk,
    const float* __restrict__ amax, const float* __restrict__ sw,
    const float* __restrict__ bias, OT* __restrict__ out, const Geometry g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const HaloShape hs = halo_shape(g);
  uint8_t* bsm = smem;                     // B: KT stages of 32 rows x 128 bytes
  uint8_t* halo = smem + g.KT * 32 * BK;   // A: halves at halo, halo + 16 * pix
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * (2 * HALO_SLABS * 64);
  const int n = m0 / g.P, sp = m0 - n * g.P;
  const int z = sp / (g.H * g.W), y0 = (sp - z * g.H * g.W) / g.W;
  const int pz = g.kd / 2, py = g.kh / 2, px = g.kw / 2;
  const int kbytes = g.KC * CHUNK;
  for (int i = tid; i < g.KT * 32 * 8; i += CONSUMERS) {
    const int st = i >> 8, r = (i >> 3) & 31, u = i & 7;
    const int k = st * BK + u * 16;
    const bool ok = r < g.Cout && k < kbytes;
    cp_async16(smem_u32(bsm + st * 32 * BK + r * BK + ((u ^ (r & 7)) << 4)),
               ok ? wk + (int64_t)r * kbytes + k : wk, ok ? 16 : 0);
  }
  const int8_t* xn = xq + (int64_t)n * g.P * 32;
  const int plane = hs.rows * hs.cols;
  for (int i = tid; i < 2 * hs.pix; i += CONSUMERS) {
    const int h = i & 1, p = i >> 1;
    const int lz = p / plane, rem = p - lz * plane;
    const int ly = rem / hs.cols, lx = rem - ly * hs.cols;
    const int zi = z + lz - pz, yi = y0 + ly - py, xi = lx - px;
    const bool ok = zi >= 0 && zi < g.D && yi >= 0 && yi < g.H && xi >= 0 && xi < g.W;
    cp_async16(smem_u32(halo + h * hs.pix * 16 + p * 16),
               ok ? xn + ((int64_t)(zi * g.H + yi) * g.W + xi) * 32 + 16 * h : xq, ok ? 16 : 0);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // the cp.asyncs wrote through the generic proxy; wgmma reads the async one
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int cw = tid / 128;  // this warpgroup's slabs: rows 2 * s + cw of the CTA's
  int acc[HALO_SLABS][16];   // the first product overwrites them (scale-d 0)
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  const uint32_t bs0 = smem_u32(bsm), h0 = smem_u32(halo);
  int t = 0;
  for (int dz = 0; dz < g.kd; ++dz)
    for (int dy = 0; dy < g.kh; ++dy)
      for (int dx = 0; dx < g.kw; ++dx, ++t) {
        const uint64_t db = smem_desc(bs0 + (t >> 2) * 32 * BK) + 2 * (t & 3);
#pragma unroll
        for (int s = 0; s < HALO_SLABS; ++s) {
          const int base = (dz * hs.rows + 2 * s + cw + dy) * hs.cols + dx;
          wgmma_s8<32>(acc[s], halo_desc(h0 + base * 16, hs.pix * 16), db, t != 0);
        }
      }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < HALO_SLABS; ++s) {
    fence_regs<16>(acc[s]);
    store_tile<32, OT>(acc[s], smem, m0 + s * BM, 0, tid, amax, sw, bias, out, g);
  }
}

// the tensor-map encoders of libcuda, looked up through the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
typedef CUresult (*EncodeIm2col)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                 cuuint32_t, cuuint32_t, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

template <typename F>
cudaError_t entry_point(const char* name, F* fn) {
  if (*fn) return cudaSuccess;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
  const cudaError_t err = cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &q);
  if (err != cudaSuccess) return err;
  if (q != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
  *fn = reinterpret_cast<F>(p);
  return cudaSuccess;
}

EncodeTiled encode_tiled = nullptr;
EncodeIm2col encode_im2col = nullptr;

template <int BN, typename T>
cudaError_t launch_gemm(const int8_t* xq, const int8_t* wk, const float* amax, const float* sw,
                        const float* bias, void* out, int N, const Geometry& g, cudaStream_t s) {
  using TL = Tile<BN>;
  cudaError_t err = entry_point("cuTensorMapEncodeTiled", &encode_tiled);
  if (err != cudaSuccess) return err;
  CUtensorMap a_map, b_map;
  memset(&a_map, 0, sizeof(a_map));
  const int taps = g.kd * g.kh * g.kw;
  {
    const cuuint64_t dims[2] = {(cuuint64_t)taps * g.Cp, (cuuint64_t)g.Cout};
    const cuuint64_t strides[1] = {(cuuint64_t)taps * g.Cp};
    const cuuint32_t box[2] = {BK, BN};
    const cuuint32_t estr[2] = {1, 1};
    if (encode_tiled(&b_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(wk), dims,
                     strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  if (g.tma_a) {
    err = entry_point("cuTensorMapEncodeIm2col", &encode_im2col);
    if (err != cudaSuccess) return err;
    // xq as (N, H, W, Cp); the box of filter-window origins runs from
    // (-pw, -ph) to (W - 1 - pw, H - 1 - ph): one per output point
    const cuuint64_t dims[4] = {(cuuint64_t)g.Cp, (cuuint64_t)g.W, (cuuint64_t)g.H,
                                (cuuint64_t)N};
    const cuuint64_t strides[3] = {(cuuint64_t)g.Cp, (cuuint64_t)g.W * g.Cp,
                                   (cuuint64_t)g.H * g.W * g.Cp};
    const int lower[2] = {-(g.kw / 2), -(g.kh / 2)};
    const int upper[2] = {-(g.kw / 2), -(g.kh / 2)};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    if (encode_im2col(&a_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<int8_t*>(xq), dims,
                      strides, lower, upper, BK, BM, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  auto kern = qconv_wgmma_kernel<BN, T>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((g.M + BM - 1) / BM), (unsigned)((g.Cout + BN - 1) / BN));
  kern<<<grid, THREADS, TL::SMEM, s>>>(a_map, b_map, xq, amax, sw, bias, static_cast<T*>(out), g);
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
  absmax_kernel<T><<<absmax_grid(len, N), 256, 0, s>>>(x, reinterpret_cast<unsigned*>(b.amax),
                                                       len);
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
  if (g.Cp == 32 && g.W == 64 && g.H % (2 * HALO_SLABS) == 0 && g.Cout <= 32 &&
      halo_shape(g).bytes + 1024 <= 227 * 1024) {
    const int smem = halo_shape(g).bytes + 1024;
    auto kern = qconv_halo_kernel<T>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kern<<<g.M / (2 * HALO_SLABS * 64), CONSUMERS, smem, s>>>(b.xq, b.wk, b.amax, b.sw, bias,
                                                              static_cast<T*>(b.out), g);
    return cudaGetLastError();
  }
  // the tile's width by Cout: the 3D chains' 32 channels, 128, or 256
  if (g.Cout <= 32) return launch_gemm<32, T>(b.xq, b.wk, b.amax, b.sw, bias, b.out, N, g, s);
  if (g.Cout <= 128) return launch_gemm<128, T>(b.xq, b.wk, b.amax, b.sw, bias, b.out, N, g, s);
  return launch_gemm<256, T>(b.xq, b.wk, b.amax, b.sw, bias, b.out, N, g, s);
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
  g.P = D * H * W;
  g.M = N * g.P;
  g.KC = kd * kh * kw * (Cp / CHUNK);
  g.KT = (g.KC * CHUNK + BK - 1) / BK;
  // A by TMA im2col where a stage is one tap's 128 channels of a 2D conv;
  // the 3D chains (32 channels) and ragged channel counts gather by cp.async
  g.tma_a = kd == 1 && D == 1 && Cp % BK == 0;
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
