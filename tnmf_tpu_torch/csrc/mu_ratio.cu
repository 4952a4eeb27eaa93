// K1: the elementwise multiplicative-update ratio  out = arr * neg / (pos + reg),
// and the W epilogue of the MU step built on it.
//
// Replaces tnmf_tpu/experimental/pallas_mu.py::mu_ratio (body _ratio_kernel),
// a TPU kernel that nothing in the JAX package calls.  On fft and dot
// tnmf_mu_ratio is the H epilogue, which the JAX engine forms in jnp
// (tnmf_tpu/engine.py:479); on the conv strategy the H epilogue is fused
// into K3 (mu_h.cu); K4 (inhibited_mu_h.cu) forms it with lateral
// inhibition on every strategy.
//
// tnmf_mu_ratio: the ratio alone, the direct counterpart of the Pallas
// kernel.  Bound: device-memory bandwidth (three reads and one write of 4
// bytes per element, no reuse).  Design: a grid-stride loop with 16-byte
// vector loads and stores when all four pointers are 16-byte aligned, and a
// scalar loop for the remainder.
//
// tnmf_mu_w: the whole W epilogue of tnmf_tpu_torch/engine.py::_mu_W in one
// launch, the ratio W * neg / (pos + EPS) and the atom normalisation of the
// JAX package's _normalize_W: each (atom, channel) row is divided by its
// sum over the shift axes, an all-zero row stays zero.  W is small (16 x 1 x
// 9 x 9 at the flagship), so the launch bounds it, and the five launches of
// the sum, compare, where and divide that followed the ratio are the cost
// it removes.  Design: one block per row; the threads form the ratio in a
// strided loop, write it out and keep a float32 partial sum; the block
// reduces in a fixed order (warp shuffles, then the warp sums in shared
// memory by one warp), so two launches give the same bits; each thread then
// divides the elements it wrote.  Any row length runs.
//
// The model axis: tnmf_mu_ratio takes the S models of a sweep in one launch
// when it is given a per-model vector regs: the tensors are (S, ...) stacks
// of per_model elements each, and element i reads its model's
// regs[i / per_model] from device memory (per-model strengths never come
// to the host).  The vector loop then runs when per_model is a multiple of
// 4 (a vector lies within one model), so each model gets the bits of its
// own launch with the scalar reg.  mu_w takes a model axis with no change:
// W's reg is the constant EPS and its rows are independent, so S models are
// S * M * C rows of one launch.
//
// Both divisions are IEEE (no fast-math), in the plain version's order,
// (arr * neg) / (pos + reg).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 4096;

// element i's reg: its model's regs[i / per_model], else the scalar
__device__ __forceinline__ float reg_of(const float* regs, float reg, int64_t i,
                                        int64_t per_model) {
  return regs != nullptr ? regs[i / per_model] : reg;
}

__global__ void mu_ratio_vec4(const float4* __restrict__ arr,
                              const float4* __restrict__ neg,
                              const float4* __restrict__ pos, float reg,
                              const float* __restrict__ regs, int64_t per_model4,
                              float4* __restrict__ out, int64_t n4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const float4 a = arr[i], g = neg[i], p = pos[i];
    const float r = reg_of(regs, reg, i, per_model4);
    float4 o;
    o.x = a.x * g.x / (p.x + r);
    o.y = a.y * g.y / (p.y + r);
    o.z = a.z * g.z / (p.z + r);
    o.w = a.w * g.w / (p.w + r);
    out[i] = o;
  }
}

__global__ void mu_ratio_scalar(const float* __restrict__ arr,
                                const float* __restrict__ neg,
                                const float* __restrict__ pos, float reg,
                                const float* __restrict__ regs, int64_t per_model,
                                float* __restrict__ out, int64_t start, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = start + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = arr[i] * neg[i] / (pos[i] + reg_of(regs, reg, i, per_model));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

__global__ void __launch_bounds__(kThreads)
mu_w_kernel(const float* __restrict__ w, const float* __restrict__ neg,
            const float* __restrict__ pos, float reg, float* __restrict__ out,
            int64_t row_len) {
  __shared__ float partial[kThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * row_len;
  float sum = 0.f;
  for (int64_t i = threadIdx.x; i < row_len; i += kThreads) {
    const float r = w[base + i] * neg[base + i] / (pos[base + i] + reg);
    out[base + i] = r;
    sum += r;
  }
  sum = warp_sum(sum);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x < 32) {
    sum = warp_sum(threadIdx.x < kThreads / 32 ? partial[threadIdx.x] : 0.f);
    if (threadIdx.x == 0) partial[0] = sum;
  }
  __syncthreads();
  const float s = partial[0] == 0.f ? 1.f : partial[0];
  for (int64_t i = threadIdx.x; i < row_len; i += kThreads) out[base + i] = out[base + i] / s;
}

int blocks_for(int64_t work) {
  return static_cast<int>(std::min((work + kThreads - 1) / kThreads, kMaxBlocks));
}

}  // namespace

extern "C" int tnmf_mu_ratio(const float* arr, const float* neg, const float* pos,
                             float reg, const float* regs, int64_t per_model, float* out,
                             int64_t n, void* stream) {
  // regs: the per-model vector of a launch over a model axis of per_model
  // elements per model, or null (every element reads reg)
  if (regs != nullptr && per_model <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(arr) |
                         reinterpret_cast<uintptr_t>(neg) |
                         reinterpret_cast<uintptr_t>(pos) |
                         reinterpret_cast<uintptr_t>(out);
  const int64_t n4 = (bits % 16 == 0 && (regs == nullptr || per_model % 4 == 0)) ? n / 4 : 0;
  if (n4 > 0) {
    mu_ratio_vec4<<<blocks_for(n4), kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(arr), reinterpret_cast<const float4*>(neg),
        reinterpret_cast<const float4*>(pos), reg, regs, per_model / 4,
        reinterpret_cast<float4*>(out), n4);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t rest = n - 4 * n4;
  if (rest > 0) {
    mu_ratio_scalar<<<blocks_for(rest), kThreads, 0, st>>>(arr, neg, pos, reg, regs, per_model,
                                                           out, 4 * n4, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tnmf_mu_w(const float* w, const float* neg, const float* pos, float reg,
                         float* out, int64_t rows, int64_t row_len, void* stream) {
  if (rows > 2147483647) return static_cast<int>(cudaErrorInvalidValue);
  mu_w_kernel<<<static_cast<unsigned>(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w, neg, pos, reg, out, row_len);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tnmf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
