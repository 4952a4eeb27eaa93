// K2: the W-gradient statistics (neg, pos) of the multiplicative W update.
//
// Replaces tnmf_tpu/experimental/pallas_gw.py::grad_w_gemm.  With the
// mode-extended data and reconstruction stacked along channels,
// X2 = [Vp | Rx] of shape (N, C2, Ex, Ey) where E = T + A - 1, it computes
//
//     G[m, c2, ax, ay] = sum_{n, tx, ty} X2[n, c2, tx+ax, ty+ay] * H[n, m, tx, ty]
//
// and stores it as out[2][M][C][Ax][Ay] with C = C2 / 2: out[0] is neg
// (c2 < C, from V), out[1] is pos (c2 >= C, from R).  2-D only; a 1-D problem
// comes in with Ax = 1.
//
// Bound: a contraction over a huge axis (N*Tx*Ty = 4.5 M at the flagship
// 64 x 1 x 256 x 256 with 16 atoms of 9 x 9) into a tiny output
// (2*M*C*Ax*Ay = 2,592): 23 GFLOP against about 0.37 GB of reads, so FP32 FMA
// issue and shared-memory load bandwidth bound it, not device memory.
//
// Design.  Pass 1 splits the contraction into chunks of (n, TR rows of tx,
// TC columns of ty).  A persistent grid walks the chunks; for each one the
// block stages H (all atoms) and the X2 window with its Ax-1 / Ay-1 halo in
// shared memory.  Each thread owns a fixed register tile of 4 atoms x 4
// consecutive ay offsets of one (c2, ax) and keeps it across all of the
// block's chunks.  Along ty the X values slide through a 4-register window,
// so each step costs 1 + 4 shared loads (the H loads are broadcasts within a
// warp) for 16 FMAs.  blockIdx.y splits the tiles when there are more than
// 256.  Each block writes its partial sums to scratch[blockIdx.x]; pass 2
// adds the partials in block order, so the result is deterministic and no
// float atomics are used.
//
// The tile sizes TR, TC, the grid and the shared-memory size come from the
// wrapper (tnmf_tpu_torch/kernels/gw.py, _geometry), which must use the
// same kMT, kAT and kThreads as here.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMT = 4;  // atoms per thread tile
constexpr int kAT = 4;  // ay offsets per thread tile (the sliding window below is written for 4)
static_assert(kAT == 4, "the register window in grad_w_partial holds 4 values");

struct GradWShape {
  int n, m, c2, ex, ey, tx, ty, ax, ay;
  int tr, tc;  // chunk rows (along tx) and columns (along ty)
};

__global__ void __launch_bounds__(kThreads)
grad_w_partial(const float* __restrict__ x2, const float* __restrict__ h,
               float* __restrict__ scratch, GradWShape s) {
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int n_mt = (s.m + kMT - 1) / kMT;
  const int n_at = (s.ay + kAT - 1) / kAT;
  const int mp = n_mt * kMT;
  const int xr = s.tr + s.ax - 1;        // staged X2 rows per channel
  const int xw = s.tc + n_at * kAT - 1;  // staged X2 columns
  const int hsz = mp * s.tr * s.tc;
  float* hs = smem;        // [mp][tr][tc]
  float* xs = smem + hsz;  // [c2][xr][xw]

  // this thread's output tile: atoms mt*4.., channel c2, row offset axo,
  // column offsets at*4..
  const int n_tiles = n_mt * s.c2 * s.ax * n_at;
  int t = blockIdx.y * kThreads + threadIdx.x;
  const bool active = t < n_tiles;
  const int at = t % n_at;
  t /= n_at;
  const int axo = t % s.ax;
  t /= s.ax;
  const int c2 = t % s.c2;
  const int mt = t / s.c2;

  float acc[kMT][kAT];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int k = 0; k < kAT; ++k) acc[i][k] = 0.f;

  const int n_rx = (s.tx + s.tr - 1) / s.tr;
  const int n_ry = (s.ty + s.tc - 1) / s.tc;
  const int64_t n_chunks = static_cast<int64_t>(s.n) * n_rx * n_ry;
  const int xsz = s.c2 * xr * xw;
  for (int64_t q = blockIdx.x; q < n_chunks; q += gridDim.x) {
    const int ry = static_cast<int>(q % n_ry);
    const int rx = static_cast<int>((q / n_ry) % n_rx);
    const int n = static_cast<int>(q / (static_cast<int64_t>(n_ry) * n_rx));
    const int tx0 = rx * s.tr;
    const int ty0 = ry * s.tc;

    __syncthreads();  // the previous chunk's reads are done
    for (int i = threadIdx.x; i < hsz; i += kThreads) {
      const int j = i % s.tc;
      const int r = (i / s.tc) % s.tr;
      const int mm = i / (s.tc * s.tr);
      const int gx = tx0 + r, gy = ty0 + j;
      float v = 0.f;
      if (mm < s.m && gx < s.tx && gy < s.ty)
        v = h[((static_cast<int64_t>(n) * s.m + mm) * s.tx + gx) * s.ty + gy];
      hs[i] = v;
    }
    for (int i = threadIdx.x; i < xsz; i += kThreads) {
      const int j = i % xw;
      const int r = (i / xw) % xr;
      const int c = i / (xw * xr);
      const int gx = tx0 + r, gy = ty0 + j;
      float v = 0.f;
      if (gx < s.ex && gy < s.ey)
        v = x2[((static_cast<int64_t>(n) * s.c2 + c) * s.ex + gx) * s.ey + gy];
      xs[i] = v;
    }
    __syncthreads();

    if (active) {
      const int hstride = s.tr * s.tc;
      for (int r = 0; r < s.tr; ++r) {
        const float* xrow = xs + (c2 * xr + r + axo) * xw + at * kAT;
        const float* hrow = hs + (mt * kMT * s.tr + r) * s.tc;
        float x0 = xrow[0], x1 = xrow[1], x2v = xrow[2];
        for (int j = 0; j < s.tc; ++j) {
          const float x3 = xrow[j + 3];
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            const float hv = hrow[i * hstride + j];
            acc[i][0] = fmaf(hv, x0, acc[i][0]);
            acc[i][1] = fmaf(hv, x1, acc[i][1]);
            acc[i][2] = fmaf(hv, x2v, acc[i][2]);
            acc[i][3] = fmaf(hv, x3, acc[i][3]);
          }
          x0 = x1;
          x1 = x2v;
          x2v = x3;
        }
      }
    }
  }

  if (active) {
    const int64_t n_out = static_cast<int64_t>(s.m) * s.c2 * s.ax * s.ay;
    float* part = scratch + blockIdx.x * n_out;
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int m = mt * kMT + i;
#pragma unroll
      for (int k = 0; k < kAT; ++k) {
        const int a = at * kAT + k;
        if (m < s.m && a < s.ay) part[((m * s.c2 + c2) * s.ax + axo) * s.ay + a] = acc[i][k];
      }
    }
  }
}

__global__ void grad_w_reduce(const float* __restrict__ scratch,
                              float* __restrict__ out, int n_parts,
                              GradWShape s) {
  const int64_t a_sz = static_cast<int64_t>(s.ax) * s.ay;
  const int64_t n_out = static_cast<int64_t>(s.m) * s.c2 * a_sz;
  const int c = s.c2 / 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       o < n_out; o += stride) {
    float sum = 0.f;
    for (int b = 0; b < n_parts; ++b) sum += scratch[b * n_out + o];
    // o = ((m * c2 + cc) * ax + axo) * ay + ayo  ->  out[half][m][ch][axo][ayo]
    const int64_t sp = o % a_sz;
    const int cc = static_cast<int>((o / a_sz) % s.c2);
    const int m = static_cast<int>(o / (a_sz * s.c2));
    const int half = cc / c, ch = cc % c;
    out[((static_cast<int64_t>(half) * s.m + m) * c + ch) * a_sz + sp] = sum;
  }
}

}  // namespace

extern "C" int tnmf_grad_w(const float* x2, const float* h, float* out,
                           float* scratch, int n, int m, int c2, int ex, int ey,
                           int tx, int ty, int ax, int ay, int tile_rows,
                           int tile_cols, int grid_x, int grid_y, int smem_bytes,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const GradWShape s{n, m, c2, ex, ey, tx, ty, ax, ay, tile_rows, tile_cols};
  cudaError_t err = cudaFuncSetAttribute(
      grad_w_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  grad_w_partial<<<dim3(grid_x, grid_y), kThreads, smem_bytes, st>>>(x2, h, scratch, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_out = static_cast<int64_t>(m) * c2 * ax * ay;
  const int blocks = static_cast<int>(std::min<int64_t>((n_out + 255) / 256, 1024));
  grad_w_reduce<<<blocks, 256, 0, st>>>(scratch, out, grid_x, s);
  return static_cast<int>(cudaGetLastError());
}
