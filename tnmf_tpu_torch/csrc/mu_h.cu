// K3: the fused multiplicative H update.
//
// Replaces tnmf_tpu/experimental/pallas_phased.py::mu_h (body _kernel).  For
// the mode-extended data Vp and reconstruction Rx, (N, C, Ex, Ey) with
// E = T + A - 1, the dictionary W (M, C, Ax, Ay) and the activations
// H (N, M, Tx, Ty) it computes
//
//     neg[n,m,t] = sum_{c,a} Vp[n,c,t+a] * W[m,c,a]
//     pos[n,m,t] = sum_{c,a} Rx[n,c,t+a] * W[m,c,a]  (+ pos_extra[n,m,t])
//     out[n,m,t] = H[n,m,t] * neg / (pos + denom_add)
//
// with both correlations accumulated in float32 registers: the two
// gradient maps never reach device memory.  Only H is read and out written
// at activation size (the saving the TPU kernel was built for).  2-D only;
// a 1-D problem comes in with Ax = 1.  The TPU kernel's phase-blocked
// layout and im2col scratch are not carried over: they exist for Mosaic.
//
// Bound: 23 GFLOP of FP32 FMAs at the flagship (64 x 1 x 256 x 256, 16 atoms
// of 9 x 9) against about 0.72 GB of traffic (H in, H' out, the two data
// windows with their halos), so FP32 FMA issue bounds it.
//
// Design.  A block computes a 16 x 64 tile of (tx, ty) positions of one
// sample for 8 atoms (blockIdx.z walks the atom groups).  It stages the
// (16 + Ax - 1) x (64 + Ay - 1) windows of Vp and Rx for all channels and
// its 8 atoms of W (transposed to [c][ax][ay][8], so each thread reads its
// 8 weights as two broadcast float4 loads) in shared memory.  Each thread
// owns 4 positions strided by 16 along ty (conflict-free shared loads,
// coalesced global stores) for the 8 atoms: per tap it makes 8 shared
// loads of data and 2 of weights for 64 FMAs.  The window pitch is padded
// to 16 mod 32 words so the two rows a warp spans fall on disjoint banks.
//
// The shared-memory size and pitch come from the wrapper
// (tnmf_tpu_torch/kernels/mu_h.py, _geometry), which must use the same
// tile constants as here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 16;              // threads along ty
constexpr int kRows = 16;              // threads along tx
constexpr int kPT = 4;                 // ty positions per thread, strided by kCols
constexpr int kMB = 8;                 // atoms per block
constexpr int kTileX = kRows;          // block tile along tx
constexpr int kTileY = kCols * kPT;    // block tile along ty

struct MuHShape {
  int n, m, c, ex, ey, tx, ty, ax, ay;
  int pitch;  // staged window row pitch (floats)
};

__global__ void __launch_bounds__(kCols * kRows, 2)
mu_h_kernel(const float* __restrict__ vp, const float* __restrict__ rx,
            const float* __restrict__ w, const float* __restrict__ h,
            const float* __restrict__ pos_extra, float denom_add,
            float* __restrict__ out, MuHShape s) {
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int xr = kTileX + s.ax - 1;
  const int xw = kTileY + s.ay - 1;
  const int win = s.c * xr * s.pitch;
  float* vs = smem;            // [c][xr][pitch]
  float* rs = smem + win;      // [c][xr][pitch]
  float* wt = smem + 2 * win;  // [c][ax][ay][kMB]

  const int tid = threadIdx.y * kCols + threadIdx.x;
  const int n_ty = (s.ty + kTileY - 1) / kTileY;
  const int tx0 = (blockIdx.x / n_ty) * kTileX;
  const int ty0 = (blockIdx.x % n_ty) * kTileY;
  const int n = blockIdx.y;
  const int m0 = blockIdx.z * kMB;

  const int taps = s.c * s.ax * s.ay;
  for (int i = tid; i < taps * kMB; i += kCols * kRows) {
    const int k = i % kMB;
    const int tap = i / kMB;
    const int mm = m0 + k;
    wt[i] = mm < s.m ? w[static_cast<int64_t>(mm) * taps + tap] : 0.f;
  }
  for (int i = tid; i < s.c * xr * xw; i += kCols * kRows) {
    const int j = i % xw;
    const int r = (i / xw) % xr;
    const int cc = i / (xw * xr);
    const int gx = tx0 + r, gy = ty0 + j;
    float v = 0.f, q = 0.f;
    if (gx < s.ex && gy < s.ey) {
      const int64_t g = ((static_cast<int64_t>(n) * s.c + cc) * s.ex + gx) * s.ey + gy;
      v = vp[g];
      q = rx[g];
    }
    const int d = (cc * xr + r) * s.pitch + j;
    vs[d] = v;
    rs[d] = q;
  }
  __syncthreads();

  float neg[kMB][kPT], pos[kMB][kPT];
#pragma unroll
  for (int k = 0; k < kMB; ++k)
#pragma unroll
    for (int p = 0; p < kPT; ++p) {
      neg[k][p] = 0.f;
      pos[k][p] = 0.f;
    }

  const int row = threadIdx.y, col = threadIdx.x;
  for (int cc = 0; cc < s.c; ++cc) {
    for (int a = 0; a < s.ax; ++a) {
      const float* vrow = vs + (cc * xr + row + a) * s.pitch + col;
      const float* rrow = rs + (cc * xr + row + a) * s.pitch + col;
      const float4* wrow = reinterpret_cast<const float4*>(wt + (cc * s.ax + a) * s.ay * kMB);
      for (int b = 0; b < s.ay; ++b) {
        float v[kPT], r[kPT];
#pragma unroll
        for (int p = 0; p < kPT; ++p) {
          v[p] = vrow[b + p * kCols];
          r[p] = rrow[b + p * kCols];
        }
        const float4 w0 = wrow[2 * b], w1 = wrow[2 * b + 1];
        const float wv[kMB] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int k = 0; k < kMB; ++k)
#pragma unroll
          for (int p = 0; p < kPT; ++p) {
            neg[k][p] = fmaf(wv[k], v[p], neg[k][p]);
            pos[k][p] = fmaf(wv[k], r[p], pos[k][p]);
          }
      }
    }
  }

  const int gx = tx0 + row;
  if (gx >= s.tx) return;
#pragma unroll
  for (int k = 0; k < kMB; ++k) {
    const int mm = m0 + k;
#pragma unroll
    for (int p = 0; p < kPT; ++p) {
      const int gy = ty0 + col + p * kCols;
      if (mm < s.m && gy < s.ty) {
        const int64_t g = ((static_cast<int64_t>(n) * s.m + mm) * s.tx + gx) * s.ty + gy;
        float d = pos[k][p];
        if (pos_extra != nullptr) d += pos_extra[g];
        out[g] = h[g] * neg[k][p] / (d + denom_add);
      }
    }
  }
}

}  // namespace

extern "C" int tnmf_mu_h(const float* vp, const float* rx, const float* w,
                         const float* h, const float* pos_extra, float denom_add,
                         float* out, int n, int m, int c, int ex, int ey, int tx,
                         int ty, int ax, int ay, int pitch, int smem_bytes,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const MuHShape s{n, m, c, ex, ey, tx, ty, ax, ay, pitch};
  cudaError_t err = cudaFuncSetAttribute(
      mu_h_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((tx + kTileX - 1) / kTileX) * ((ty + kTileY - 1) / kTileY), n,
                  (m + kMB - 1) / kMB);
  mu_h_kernel<<<grid, dim3(kCols, kRows), smem_bytes, st>>>(vp, rx, w, h, pos_extra,
                                                            denom_add, out, s);
  return static_cast<int>(cudaGetLastError());
}
