// Eager load of a library's kernels: kernels_preload() (every library's
// own copy; ops/_build.py::preload calls it through ctypes).
//
// CUDA 12 loads modules lazily by default (CUDA_MODULE_LOADING=LAZY): a
// kernel's code reaches the device at its first launch. A parked
// replica or a background warm wants that paid before the first request,
// so this walks the library's own module and loads every function in it.
// The module is found through an anchor kernel compiled into the same
// translation unit; cuFuncGetModule, cuModuleGetFunctionCount,
// cuModuleEnumerateFunctions and cuFuncLoad (the last three need CUDA
// 12.4) are fetched at run time, as the TMA encoder is, so nothing links
// libcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <vector>

__global__ void kernels_preload_anchor() {}

extern "C" int kernels_preload() {
  typedef CUresult (*FuncGetModule)(CUmodule*, CUfunction);
  typedef CUresult (*ModuleGetFunctionCount)(unsigned int*, CUmodule);
  typedef CUresult (*ModuleEnumerateFunctions)(CUfunction*, unsigned int, CUmodule);
  typedef CUresult (*FuncLoad)(CUfunction);
  auto entry = [](const char* name) -> void* {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
    return p;
  };
  auto get_module = (FuncGetModule)entry("cuFuncGetModule");
  auto count = (ModuleGetFunctionCount)entry("cuModuleGetFunctionCount");
  auto enumerate = (ModuleEnumerateFunctions)entry("cuModuleEnumerateFunctions");
  auto load = (FuncLoad)entry("cuFuncLoad");
  if (!get_module || !count || !enumerate || !load) return -1;
  cudaFunction_t anchor;
  cudaError_t err = cudaGetFuncBySymbol(&anchor, (const void*)kernels_preload_anchor);
  if (err != cudaSuccess) return -(int)err;
  CUmodule mod;
  CUresult r = get_module(&mod, (CUfunction)anchor);
  if (r != CUDA_SUCCESS) return -(int)r;
  unsigned int n = 0;
  if ((r = count(&n, mod)) != CUDA_SUCCESS) return -(int)r;
  std::vector<CUfunction> fns(n);
  if (n && (r = enumerate(fns.data(), n, mod)) != CUDA_SUCCESS) return -(int)r;
  for (CUfunction f : fns)
    if ((r = load(f)) != CUDA_SUCCESS) return -(int)r;
  return (int)n;
}
