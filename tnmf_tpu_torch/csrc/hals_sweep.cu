// K5: the Gauss-Seidel component sweep of the HALS solvers.
//
// Replaces no Pallas kernel.  The JAX package runs this sweep as one
// on-device lax.fori_loop of m dependent steps (tnmf_tpu/engine_hals.py:98,
// _sweep_H); in eager PyTorch that loop would be about six launches per
// component, 3000 per iteration of plain NMF at 16384 x 4096 with 256
// components, so the port runs the whole sweep as one kernel.  One
// function serves the three sweeps of the port, which are one computation
// on different operands: the H sweep (X = H, G = W W^T, P = V W^T), the W
// sweep (X = W^T, G = A^T = (H^T H)^T, P = B^T = (H^T V)^T) and the
// per-phase sweep of the shift-invariant solver (rows (n*K, M),
// tnmf_tpu/engine_hals_conv.py:137).
//
// For each pass and each component j, every row r of X (rows, m) becomes
//   u     = P[r, j] - sum_k X[r, k] G[k, j] + X[r, j] G[j, j] - l1
//   X[r, j] = max(u / max(G[j, j] + l2, FLT_MIN), 0)   where G[j, j] + l2 > 0
// and keeps its value elsewhere (sklearn's `hess != 0` skip), the sum over
// k reading the components < j already updated in this pass.
//
// Bound: latency.  The rows are independent and the components sequential,
// so the work is m * inner dependent steps of an m-term dot product per row
// (2 rows m^2 inner operations), too few per step to fill the card at the
// row counts of the main path.  Design: one thread per row runs all
// inner * m steps in one launch.  The operands are component-major,
// X^T (m, rows) and P^T (m, rows), so a warp's loads of one component are
// coalesced, and G is passed as G^T (row j = column j of G), one address
// for the whole warp at each step (a broadcast).  A block stages its rows of
// X^T in shared memory, [component][thread] (no bank conflicts), where they
// fit; else each thread works on its row of the output in device memory
// (cached in L1/L2).  Each thread reads and writes only its own row, so no
// barrier is needed.  Any m and any row count run.  The dot product keeps
// four partial sums (a fixed order, so two launches give the same bits);
// the division is IEEE (no fast-math).

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

__global__ void hals_sweep_kernel(const float* __restrict__ xt_in,
                                  const float* __restrict__ gt,
                                  const float* __restrict__ pt, float l1, float l2,
                                  int inner, float* __restrict__ xt, int64_t rows, int m,
                                  int staged) {
  extern __shared__ float stage[];
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  float* x = staged ? stage + threadIdx.x : xt + row;
  const int64_t stride = staged ? static_cast<int64_t>(blockDim.x) : rows;
  for (int k = 0; k < m; ++k) x[k * stride] = xt_in[k * rows + row];
  for (int pass = 0; pass < inner; ++pass) {
    for (int j = 0; j < m; ++j) {
      const float* g = gt + static_cast<int64_t>(j) * m;  // column j of G
      const float gjj = __ldg(g + j);
      const float denom = gjj + l2;
      if (!(denom > 0.f)) continue;  // dead component: the column keeps its values
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      int k = 0;
      for (; k + 4 <= m; k += 4) {
        s0 = fmaf(x[k * stride], __ldg(g + k), s0);
        s1 = fmaf(x[(k + 1) * stride], __ldg(g + k + 1), s1);
        s2 = fmaf(x[(k + 2) * stride], __ldg(g + k + 2), s2);
        s3 = fmaf(x[(k + 3) * stride], __ldg(g + k + 3), s3);
      }
      for (; k < m; ++k) s0 = fmaf(x[k * stride], __ldg(g + k), s0);
      const float dot = (s0 + s1) + (s2 + s3);
      const float xj = x[j * stride];
      const float u = pt[j * rows + row] - dot + xj * gjj - l1;
      x[j * stride] = fmaxf(u / fmaxf(denom, FLT_MIN), 0.f);
    }
  }
  if (staged) {
    for (int k = 0; k < m; ++k) xt[k * rows + row] = x[k * stride];
  }
}

}  // namespace

// xt_in, pt, out: (m, rows) component-major; gt: (m, m), row j = column j
// of G.  smem_bytes > 0 stages each block's rows (threads * m floats).
extern "C" int tnmf_hals_sweep(const float* xt_in, const float* gt, const float* pt,
                               float l1, float l2, int inner, float* out, int64_t rows,
                               int m, int threads, int smem_bytes, void* stream) {
  if (rows <= 0 || m <= 0) return 0;
  const int64_t blocks = (rows + threads - 1) / threads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hals_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  hals_sweep_kernel<<<static_cast<unsigned>(blocks), threads, smem_bytes,
                      static_cast<cudaStream_t>(stream)>>>(xt_in, gt, pt, l1, l2, inner, out,
                                                            rows, m, smem_bytes > 0);
  return static_cast<int>(cudaGetLastError());
}
