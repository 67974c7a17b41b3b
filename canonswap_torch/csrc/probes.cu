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
// Gather.  The index follows JAX's semantics: an index in [-R, 0) wraps to
// index + R, and one outside [-R, R) gives NaN (take_along_axis's fill
// mode).  What bounds it on the H100: bytes.  At the probe's shape (B = 16,
// R = 1024, C = 2048, f32 x, int32 idx) it reads 16 x 8 MiB of x and of idx
// and writes 16 x 8 MiB: 403 MB, 0.120 ms at 3.35 TB/s.  Two paths, chosen
// by shape alone (ops/cuda/probes.py::gather_strip_ok):
//
//   - Strip, wherever R x 128 bytes and an 8-byte barrier fit the 232,448
//     bytes of shared memory a block may use (R <= 1815), for any C.  A
//     one-thread-per-element gather reads x where the indices point: the
//     32 lanes of a warp read 32 unrelated rows, one 32-byte sector for
//     each 4-byte value, 1.07 GB of sectors at the probe's shape, and it
//     took 0.313 ms against 0.201 on a coalesced copy of the same bytes
//     (PERF.md §6).  Here block (b, s) copies the strip x[b, :, 32 s :
//     32 s + 32] into shared memory, [R][32] f32: each row of the strip is
//     one whole 128-byte line, so x crosses the memory once, in full lines,
//     whatever the indices.  The copy is one bulk copy (the TMA unit) per
//     row, issued across the block's threads and completed on an mbarrier's
//     byte count, where C % 4 == 0 and x is 16-byte aligned; else 4-byte
//     cp.async.  A warp then writes one output row of the strip at a time:
//     lane l reads strip[j][l], bank l whatever j is, so no index pattern
//     conflicts.  Reads of idx and writes of out are 128-byte lines, marked
//     streaming; each warp keeps 8 rows of idx in flight, the first asked
//     for before the strip has landed.  What bounds it: bytes, in two
//     phases per block (the strip, then idx and out), which one block per
//     SM at R = 1024 cannot overlap: 0.146 to 0.149 ms at the probe's
//     shape, 81 to 82 % of the bound, the same on every index pattern
//     (PERF.md §6).
//   - Direct, past R = 1815: one thread per output element, as above.
//     Bound by the scattered sectors of x (and by L2 where a batch
//     element's x fits it).
//
// Strip: up to 1024 threads (32 warps, fewer where R < 32), 40 registers,
// no spills, R x 128 + 8 bytes of dynamic shared memory (131,080 at R =
// 1024: one block per SM); direct: 256 threads, 26 registers; as
// `-Xptxas -v` prints them for sm_90a (chip_smoke.py prints the build log).
//
// Doubling.  One elementwise pass, four floats a thread where the size
// allows (16-byte loads and stores).  Bound: bytes (1 MiB at the probe's
// (256, 512)), which is far below a launch's cost.
//
// Matmul.  f32 products and sums with FFMA, no tensor cores: the contract is
// f32 arithmetic (TF32 would keep 10 bits of mantissa).  Bound: operations,
// 268 MFLOP at (512, 512) @ (512, 512), 4.0 us at 67 TFLOP/s f32.  What holds
// a tiled FFMA kernel back at this size is parallelism and latency, not
// arithmetic: 64 x 32 output tiles over the whole of K give 128 blocks, one
// block of four warps per SM, each waiting on its tile loads.  The design:
//
//   - Split K over a thread block cluster of 8 (cudaLaunchKernelEx, cluster
//     dimension (1, 1, 8)): the 8 blocks of a cluster compute the same
//     64 x 64 tile, each over one eighth of K (rounded up to 32-deep steps;
//     an eighth may be empty).  512 blocks of 128 threads at the probe's
//     shape: about 4 blocks, 15.5 warps, per SM.
//   - Reduce through distributed shared memory in a fixed order: each block
//     writes its partial tile to its own shared memory, cluster.sync(), rank r
//     sums rows [8 r, 8 r + 8) of the eight partial tiles in rank order
//     0, 1, ..., 7 (map_shared_rank), arrives at the cluster barrier, stores
//     its rows, and waits there before it exits (no block leaves while
//     another reads its tile).  No atomics, no second launch, no workspace:
//     the same bits on every run.  Every block reaches both barriers,
//     including blocks whose rows or K range are empty.
//   - Keep loads in flight: a's and b's tiles are double-buffered in shared
//     memory and filled with cp.async, step s + 1's copies issued before step
//     s's FMAs; 16-byte copies where K (for a) or N (for b) divides by 4 and
//     the pointer is 16-byte aligned, else 4-byte copies; a copy outside the
//     matrix or the block's K range fills zeros (cp.async's source size 0).
//   - Wide shared reads: a's tile is stored row-major (32 k and 4 of padding
//     a row), so a 16-byte copy lands as it is read; a thread owns rows ty,
//     ty + 8, ..., ty + 56 and 4 adjacent columns, and per 4 k reads one
//     float4 of each of its 8 rows and one float4 of b per k: 12 LDS.128 per
//     128 FMAs (the padding puts a warp's two rows on distinct banks).
//
// Per block: 128 threads (4 warps), 32 sums a thread; shared memory
// 2 x 64 x 36 x 4 (a) + 2 x 32 x 64 x 4 (b) = 34,816 bytes, the partial tile
// (64 x 64 x 4) reusing a's buffers after the last step.  Registers: 96
// (95 where b takes 16-byte copies), no spills, as `-Xptxas -v` prints them
// for sm_90a (chip_smoke.py prints the build log).  Tile, depth, thread tile and split were chosen on the H100 among
// 4 x 4 / 8 x 4 / 4 x 8 / 8 x 8 thread tiles, 32 to 128 rows, 16 to 64 deep
// steps and splits of 1, 2, 4 and 8 (PERF.md).
//
// Every entry point returns the cudaError_t of its launch (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; with ok false it reads nothing and fills zeros
// (source size 0), src must then still be a valid address
__device__ __forceinline__ void cp_async16(void* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

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

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until phase 0 of the barrier has completed
__device__ __forceinline__ void mbar_wait0(uint64_t* bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
}

// one bulk copy (the TMA unit, no tensor map) of `bytes` (a multiple of 16,
// both addresses 16-byte aligned), completed on the barrier's byte count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

constexpr int kStripCols = 32;       // a strip's columns: one 128-byte line of a row
constexpr int kStripThreads = 1024;  // at most: 32 warps, fewer where R < 32
constexpr int kAhead = 8;            // rows of idx a warp keeps in flight

// the next kAhead rows of a warp's idx (rows r, r + warps, ...), streaming
__device__ __forceinline__ void load_rows(int (&j)[kAhead], const int* __restrict__ ib, int r,
                                          int warps, int R, int C, bool col) {
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int row = r + k * warps;
    j[k] = (col && row < R) ? __ldcs(ib + (int64_t)row * C) : 0;
  }
}

// The strip path.  Block (b, s) stages x[b, :, 32 s : 32 s + 32] in shared
// memory as [R][32] f32 (the barrier after it), then a warp writes one
// output row of the strip at a time: lane l reads strip[j][l], bank l for
// any j.  bulk: one bulk copy per row (C % 4 == 0, x 16-byte aligned);
// else 4-byte cp.async.  Columns past C are neither copied nor read.
__global__ void __launch_bounds__(kStripThreads, 1)
    gather_strip_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                        float* __restrict__ out, int R, int C, int strips, int bulk) {
  extern __shared__ __align__(16) float strip[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(strip + (int64_t)R * kStripCols);
  const int b = blockIdx.x / strips;
  const int c0 = (blockIdx.x % strips) * kStripCols;
  const int width = min(kStripCols, C - c0);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  const int64_t plane = (int64_t)b * R * C + c0;
  const float* xs = x + plane;

  if (bulk) {
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      mbar_arrive_expect_tx(bar, (unsigned)R * width * 4);
    }
    __syncthreads();
    // a row a thread: a warp's 32 copies issue one lane after another, so
    // one warp issuing them all would serialize the strip's load
    for (int r = threadIdx.x; r < R; r += blockDim.x)
      bulk_copy(strip + r * kStripCols, xs + (int64_t)r * C, width * 4, bar);
  } else {
    for (int e = threadIdx.x; e < R * kStripCols; e += blockDim.x) {
      const int r = e / kStripCols, c = e % kStripCols;
      if (c < width) cp_async4(strip + e, xs + (int64_t)r * C + c, true);
    }
    cp_async_commit();
  }
  // this lane's column of idx and out; the first rows' indices are asked
  // for before the strip has landed
  const bool col = lane < width;
  const int* ib = idx + plane + lane;
  float* ob = out + plane + lane;
  const int step = warps * kAhead;
  int next[kAhead];
  load_rows(next, ib, warp, warps, R, C, col);
  if (bulk) {
    mbar_wait0(bar);
  } else {
    cp_async_wait_all();
    __syncthreads();
  }
  for (int r0 = warp; r0 < R; r0 += step) {
    int j[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) j[k] = next[k];
    load_rows(next, ib, r0 + step, warps, R, C, col);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int row = r0 + k * warps;
      if (col && row < R) {
        int q = j[k];
        if (q < 0) q += R;
        __stcs(ob + (int64_t)row * C,
               (q >= 0 && q < R) ? strip[q * kStripCols + lane] : __int_as_float(0x7fc00000));
      }
    }
  }
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

constexpr int kBM = 64;     // rows of a tile
constexpr int kBN = 64;     // columns of a tile
constexpr int kBK = 32;     // depth of one k step
constexpr int kPadK = 36;   // a's row in shared memory: 32 k + 4 of padding
constexpr int kTM = 8;      // rows of a thread's block of sums
constexpr int kTN = 4;      // columns of a thread's block of sums
constexpr int kSplit = 8;   // blocks of a cluster, each one eighth of K
constexpr int kColThreads = kBN / kTN;                  // 16
constexpr int kRowGroups = kBM / kTM;                   // 8: a thread's row stride
constexpr int kMmThreads = kColThreads * kRowGroups;    // 128
constexpr int kTileA = 2 * kBM * kPadK;                 // floats, two stages
constexpr int kTileB = 2 * kBK * kBN;
static_assert(kBM * kBN <= kTileA, "the partial tile reuses a's buffers");
static_assert(kBM / kSplit * (kBN / 4) == kMmThreads, "one float4 a thread in the reduction");

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// a (M, K), b (K, N), out (M, N) row-major f32.  Grid (ceil(N / 64),
// ceil(M / 64), 8) in clusters of (1, 1, 8); k_slice: the depth of one
// rank's eighth of K, a multiple of kBK.
template <bool kVecA, bool kVecB>
__global__ void __launch_bounds__(kMmThreads)
    matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, int M, int K, int N, int k_slice, int vec_out) {
  __shared__ __align__(16) float smem[kTileA + kTileB];
  float(*as)[kBM][kPadK] = reinterpret_cast<float(*)[kBM][kPadK]>(smem);
  float(*bs)[kBK][kBN] = reinterpret_cast<float(*)[kBK][kBN]>(smem + kTileA);
  float(*part)[kBN] = reinterpret_cast<float(*)[kBN]>(smem);  // after the last step
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int tx = tid % kColThreads;  // 0..15: columns 4 tx .. 4 tx + 3
  const int ty = tid / kColThreads;  // 0..7: rows ty + 8 i
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int kbeg = (int)min((int64_t)K, (int64_t)rank * k_slice);
  const int kend = kbeg + min(k_slice, K - kbeg);
  const int steps = (kend - kbeg + kBK - 1) / kBK;

  auto load = [&](int st, int k0) {
    if (kVecA) {  // 64 rows x 8 chunks of 16 bytes, 4 a thread
#pragma unroll
      for (int e = tid; e < kBM * kBK / 4; e += kMmThreads) {
        const int r = e / (kBK / 4), c = 4 * (e % (kBK / 4));
        const int gr = row0 + r, gk = k0 + c;
        const bool ok = gr < M && gk < kend;
        cp_async16(&as[st][r][c], ok ? a + (int64_t)gr * K + gk : a, ok);
      }
    } else {  // 2048 values, 16 a thread
#pragma unroll
      for (int e = tid; e < kBM * kBK; e += kMmThreads) {
        const int r = e / kBK, c = e % kBK;
        const int gr = row0 + r, gk = k0 + c;
        const bool ok = gr < M && gk < kend;
        cp_async4(&as[st][r][c], ok ? a + (int64_t)gr * K + gk : a, ok);
      }
    }
    if (kVecB) {  // 32 rows x 16 chunks of 16 bytes, 4 a thread
#pragma unroll
      for (int e = tid; e < kBK * kBN / 4; e += kMmThreads) {
        const int r = e / (kBN / 4), c = 4 * (e % (kBN / 4));
        const int gk = k0 + r, gc = col0 + c;
        const bool ok = gk < kend && gc < N;
        cp_async16(&bs[st][r][c], ok ? b + (int64_t)gk * N + gc : b, ok);
      }
    } else {  // 2048 values, 16 a thread
#pragma unroll
      for (int e = tid; e < kBK * kBN; e += kMmThreads) {
        const int r = e / kBN, c = e % kBN;
        const int gk = k0 + r, gc = col0 + c;
        const bool ok = gk < kend && gc < N;
        cp_async4(&bs[st][r][c], ok ? b + (int64_t)gk * N + gc : b, ok);
      }
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  if (steps > 0) load(0, kbeg);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int st = s & 1;
    if (s + 1 < steps) load(st ^ 1, kbeg + (s + 1) * kBK);
    cp_async_commit();  // possibly empty: the wait below counts groups
    cp_async_wait_one();  // step s's copies have landed
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; k += 4) {
      float4 av[kTM], bv[4];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        av[i] = *reinterpret_cast<const float4*>(&as[st][ty + kRowGroups * i][k]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        bv[kk] = *reinterpret_cast<const float4*>(&bs[st][k + kk][tx * kTN]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float x = lane(av[i], kk);
          acc[i][0] = fmaf(x, bv[kk].x, acc[i][0]);
          acc[i][1] = fmaf(x, bv[kk].y, acc[i][1]);
          acc[i][2] = fmaf(x, bv[kk].z, acc[i][2]);
          acc[i][3] = fmaf(x, bv[kk].w, acc[i][3]);
        }
    }
    __syncthreads();  // the stage is refilled by step s + 2's copies
  }
  cp_async_wait_all();  // a's buffers take the partial tile next
  __syncthreads();

  // the partial tile, to this block's shared memory, then the cluster's sum
#pragma unroll
  for (int i = 0; i < kTM; ++i)
    *reinterpret_cast<float4*>(&part[ty + kRowGroups * i][tx * kTN]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  cluster.sync();
  const int r = rank * (kBM / kSplit) + tid / (kBN / 4);
  const int c = 4 * (tid % (kBN / 4));
  float4 sum = *cluster.map_shared_rank(reinterpret_cast<float4*>(&part[r][c]), 0);
#pragma unroll
  for (int q = 1; q < kSplit; ++q) {
    const float4 v = *cluster.map_shared_rank(reinterpret_cast<float4*>(&part[r][c]), q);
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  // done reading the cluster's tiles: arrive now, wait after the stores
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  const int gr = row0 + r, gc = col0 + c;
  if (gr < M) {
    float* o = out + (int64_t)gr * N + gc;
    if (vec_out && gc + 3 < N) {
      *reinterpret_cast<float4*>(o) = sum;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gc + j < N) o[j] = lane(sum, j);
    }
  }
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

}  // namespace

// x (B, R, C) f32, idx (B, R, C) int32, out (B, R, C) f32: contiguous device
// tensors.  strip: 1 for the strip path (R x 128 bytes of shared memory and
// the barrier must fit a block; ops/cuda/probes.py::gather_strip_ok decides),
// 0 for the direct path.
extern "C" int probes_gather(const void* x, const void* idx, void* out, int B, int R, int C,
                             int strip, void* stream) {
  if (B < 0 || R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)B * R * C;
  if (total == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (strip) {
    const int strips = (int)(((int64_t)C + kStripCols - 1) / kStripCols);
    const int64_t blocks = (int64_t)B * strips;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)R * kStripCols * sizeof(float) + sizeof(uint64_t);
    const cudaError_t err = cudaFuncSetAttribute(
        gather_strip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int bulk = C % 4 == 0 && (uintptr_t)x % 16 == 0;
    gather_strip_kernel<<<(unsigned)blocks, 32 * min(R, kStripThreads / 32), smem, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(idx), static_cast<float*>(out), R,
        C, strips, bulk);
    return (int)cudaGetLastError();
  }
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  gather_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
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

// a (M, K), b (K, N), out (M, N): contiguous f32 device tensors.  Clusters
// of kSplit blocks along the grid's z; gridDim.y (row tiles) at most 65535.
extern "C" int probes_matmul(const void* a, const void* b, void* out, int M, int K, int N,
                             void* stream) {
  if (M < 0 || K < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + (int64_t)kBN - 1) / kBN),
                     (unsigned)((M + (int64_t)kBM - 1) / kBM), kSplit);
  if (cfg.gridDim.y > 65535 || cfg.gridDim.z % kSplit != 0) return (int)cudaErrorInvalidValue;
  cfg.blockDim = dim3(kMmThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = kSplit;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const int k_slice = (int)(((K + (int64_t)kSplit - 1) / kSplit + kBK - 1) / kBK * kBK);
  const bool vec_a = K % 4 == 0 && (uintptr_t)a % 16 == 0;
  const bool vec_b = N % 4 == 0 && (uintptr_t)b % 16 == 0;
  const int vec_out = N % 4 == 0 && (uintptr_t)out % 16 == 0;
  void (*kernel)(const float*, const float*, float*, int, int, int, int, int) =
      vec_a ? (vec_b ? matmul_kernel<true, true> : matmul_kernel<true, false>)
            : (vec_b ? matmul_kernel<false, true> : matmul_kernel<false, false>);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(a), static_cast<const float*>(b),
                         static_cast<float*>(out), M, K, N, k_slice, vec_out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* probes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
