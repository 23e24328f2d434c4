// Programmatic dependent launch (PDL) on Hopper, for short kernels whose
// fixed cost is a large part of their time (rmsnorm_quant.cu, rope.cu).
//
// A kernel launched by launch_pdl may start while the kernel before it on
// the stream is still draining: its blocks are scheduled once every block
// of the predecessor has exited (or signalled), before the predecessor's
// grid has completed and its writes are flushed.  Until it calls
// grid_dependency_wait() (`griddepcontrol.wait`), the kernel may read only
// memory that no kernel of the step writes (weights, or inputs completed
// before the predecessor started, as they are when the predecessor was
// launched without PDL).  After the wait every earlier kernel on the
// stream has completed and its writes are visible.  Every read of an
// activation (by a coherent load, never the non-coherent path: the kernel
// was alive while the predecessor wrote it) and every write of an output
// comes after the wait: an output buffer may be memory that the caching
// allocator handed back while the predecessor still reads it.  Launched
// without a predecessor, or after a kernel that has completed, the wait
// returns at once.  The attribute works the same inside a captured CUDA
// graph.
//
// On an H100 with CUDA 12.8, ptxas issues the wait (SASS ACQBULK) ahead of
// every load, weights included: moving a load past the wait is always
// safe, and it does.  So what PDL overlaps with the predecessor's drain is
// the launch, the blocks' scheduling and the index arithmetic, not a
// weight's fetch.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Launch `kernel` on `stream` with programmatic stream serialization.
// Returns the launch's error, or the last error if the launch was taken.
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block,
                       cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}
