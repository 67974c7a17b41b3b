// Chaining kernels on one stream with Hopper's programmatic dependent
// launch: a kernel launched by launch_after_prior may start its prologue
// while the kernel before it on the stream drains, and calls
// wait_for_prior_grid before it reads what that one wrote.  Launched
// without it, the wait returns at once and the early start does nothing.
// Used by the W8A8 passes (quant.cuh, warp3d_q.cu) and the warp's backward
// (warp3d.cu).

#pragma once

#include <cuda_runtime.h>

namespace {

// the next kernel on the stream may start (griddepcontrol.launch_dependents)
__device__ __forceinline__ void allow_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// wait until the kernel before this one has finished and its writes are
// visible (griddepcontrol.wait); at once where there is no such kernel
__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// launch kernel<<<grid, block, 0, s>>>(args...) so that it may start
// while the kernel before it on s drains; it calls wait_for_prior_grid
// before it reads that kernel's output
template <typename... Params, typename... Args>
cudaError_t launch_after_prior(void (*kernel)(Params...), dim3 grid, dim3 block,
                               cudaStream_t s, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

}  // namespace
