// cuTensorMapEncodeTiled, the libcuda entry point that encodes a TMA tensor
// map on the host, looked up once a process through the runtime
// (cudaGetDriverEntryPoint: the library links no -lcuda). Shared by the
// wgmma kernels' launchers (w8a8_wgmma.cu, flash_attention.cu).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace ragtorch {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// null when libcuda lacks it; an inline function's static is one object
// across the library's translation units
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

}  // namespace ragtorch
