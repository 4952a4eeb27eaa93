// K1: the elementwise multiplicative-update ratio  out = arr * neg / (pos + reg).
//
// Replaces tnmf_tpu/experimental/pallas_mu.py::mu_ratio (body _ratio_kernel).
// The port uses it for the W epilogue W * neg / (pos + EPS) of the MU step
// (the H epilogue is fused into K3, mu_h.cu).
//
// Bound: device-memory bandwidth (three reads and one write of 4 bytes per
// element, no reuse).  Design: a grid-stride loop with 16-byte vector loads
// and stores when all four pointers are 16-byte aligned, and a scalar loop
// for the remainder.  The division is IEEE (no fast-math), in the same
// order as the plain version, (arr * neg) / (pos + reg).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 4096;

__global__ void mu_ratio_vec4(const float4* __restrict__ arr,
                              const float4* __restrict__ neg,
                              const float4* __restrict__ pos, float reg,
                              float4* __restrict__ out, int64_t n4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const float4 a = arr[i], g = neg[i], p = pos[i];
    float4 o;
    o.x = a.x * g.x / (p.x + reg);
    o.y = a.y * g.y / (p.y + reg);
    o.z = a.z * g.z / (p.z + reg);
    o.w = a.w * g.w / (p.w + reg);
    out[i] = o;
  }
}

__global__ void mu_ratio_scalar(const float* __restrict__ arr,
                                const float* __restrict__ neg,
                                const float* __restrict__ pos, float reg,
                                float* __restrict__ out, int64_t start,
                                int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = start + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = arr[i] * neg[i] / (pos[i] + reg);
  }
}

int blocks_for(int64_t work) {
  return static_cast<int>(std::min((work + kThreads - 1) / kThreads, kMaxBlocks));
}

}  // namespace

extern "C" int tnmf_mu_ratio(const float* arr, const float* neg,
                             const float* pos, float reg, float* out,
                             int64_t n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(arr) |
                         reinterpret_cast<uintptr_t>(neg) |
                         reinterpret_cast<uintptr_t>(pos) |
                         reinterpret_cast<uintptr_t>(out);
  const int64_t n4 = (bits % 16 == 0) ? n / 4 : 0;
  if (n4 > 0) {
    mu_ratio_vec4<<<blocks_for(n4), kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(arr), reinterpret_cast<const float4*>(neg),
        reinterpret_cast<const float4*>(pos), reg, reinterpret_cast<float4*>(out), n4);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t rest = n - 4 * n4;
  if (rest > 0) {
    mu_ratio_scalar<<<blocks_for(rest), kThreads, 0, st>>>(arr, neg, pos, reg, out,
                                                           4 * n4, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tnmf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
