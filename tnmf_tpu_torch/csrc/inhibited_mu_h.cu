// K4: the multiplicative H update with lateral inhibition.
//
// Replaces tnmf_tpu/experimental/pallas_mu.py::inhibited_mu_h (bodies
// _make_kernel_2d and _make_kernel_1d).  For the activations H and the H
// gradient parts neg, pos, all (N, M, X, Y) (a 1-D problem comes in with
// X = 1 and one x tap), it computes per sample
//
//     g[m]   = H[m] (*) k_x (*) k_y                (separable, zero-padded)
//     p[m]   = pos[m] + inh * (g[m] - H[m])         (use_same)
//                     + cross * (sum_m' g[m'] - g[m])   (use_cross)
//     out[m] = H[m] * neg[m] / (p[m] + reg)
//
// with cross already divided by M - 1 and reg = EPS + sparsity, in float32.
// The taps are odd, centred and zero-padded at the sample edge in every
// reconstruction mode.
//
// Bound: device-memory bandwidth.  Per element it reads H, neg and pos and
// writes out (16 bytes) against tx + ty FMAs of the stencil: at the
// inhibited flagship (64 x 16 x 264 x 264, 17 x 17 taps) 1.14 GB against
// 4.9 GFLOP, 0.34 ms of HBM time against 0.07 ms of FP32 issue on an H100.
//
// Design.  A block owns one sample's tile of tile_x x tile_y positions for
// all M atoms, so the cross-atom sum stays on chip (the TPU kernel keeps
// all atoms in its block for the same reason).  It walks the atoms: it
// stages one atom's H tile with its rx / ry halo in shared memory (zero
// outside the sample), runs the y pass into a shared scratch over the halo
// rows, and the x pass with the sum in a register, leaving the atom's
// field g in shared memory ([M][tile_x][tile_y]).  The epilogue sums g over
// the atoms per position and forms the ratio, reading H, neg and pos and
// writing out coalesced along y (16-byte vectors when Y % 4 == 0 and the
// pointers are aligned).  The taps sit in shared memory; the three scalars
// are kernel arguments.  H' goes to a new tensor.  The tile sizes and the
// shared-memory size come from the wrapper
// (tnmf_tpu_torch/kernels/inhibit.py, _geometry), which must use the same
// layout as here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct InhShape {
  int n, m, x, y;        // H is (n, m, x, y); a 1-D problem has x = 1
  int tx, ty;            // odd tap counts along x and y (tx = 1 in 1-D)
  int tile_x, tile_y;    // output positions of one block
  float inh, cross, reg;
  int use_same, use_cross;
};

template <int kVec>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = p[i];
  }
}

template <int kVec>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) p[i] = v[i];
  }
}

template <bool kTwoD, int kVec>
__global__ void __launch_bounds__(kThreads)
inhibited_mu_h_kernel(const float* __restrict__ h, const float* __restrict__ neg,
                      const float* __restrict__ pos, const float* __restrict__ taps,
                      float* __restrict__ out, InhShape s) {
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int rx = s.tx / 2, ry = s.ty / 2;
  const int hx = s.tile_x + 2 * rx;  // staged rows (tile + halo)
  const int hy = s.tile_y + 2 * ry;  // staged columns (tile + halo)
  const int tile = s.tile_x * s.tile_y;
  float* gs = smem;                  // [m][tile_x][tile_y] inhibition field
  float* hs = gs + s.m * tile;       // [hx][hy] one atom's H with its halo
  float* ys = hs + hx * hy;          // [hx][tile_y] y pass (2-D only)
  float* ks = ys + (kTwoD ? hx * s.tile_y : 0);  // kx[tx], ky[ty]
  const float* kx = ks;
  const float* ky = ks + s.tx;

  const int tid = threadIdx.x;
  const int n_ty = (s.y + s.tile_y - 1) / s.tile_y;
  const int x0 = (blockIdx.x / n_ty) * s.tile_x;
  const int y0 = (blockIdx.x % n_ty) * s.tile_y;
  const int n = blockIdx.y;
  const int64_t plane = static_cast<int64_t>(s.x) * s.y;

  for (int i = tid; i < s.tx + s.ty; i += kThreads) ks[i] = taps[i];

  for (int mm = 0; mm < s.m; ++mm) {
    const float* hp = h + (static_cast<int64_t>(n) * s.m + mm) * plane;
    float* gm = gs + mm * tile;
    __syncthreads();  // the previous atom's passes are done with hs and ys
    for (int i = tid; i < hx * hy; i += kThreads) {
      const int gx = x0 - rx + i / hy, gy = y0 - ry + i % hy;
      hs[i] = (gx >= 0 && gx < s.x && gy >= 0 && gy < s.y)
                  ? hp[static_cast<int64_t>(gx) * s.y + gy] : 0.f;
    }
    __syncthreads();
    // y pass over all staged rows; in 1-D (hx = tile_x = 1) it is g itself
    float* ydst = kTwoD ? ys : gm;
    for (int i = tid; i < hx * s.tile_y; i += kThreads) {
      const float* src = hs + (i / s.tile_y) * hy + i % s.tile_y;
      float acc = 0.f;
      for (int t = 0; t < s.ty; ++t) acc = fmaf(ky[t], src[t], acc);
      ydst[i] = acc;
    }
    if constexpr (kTwoD) {
      __syncthreads();
      for (int i = tid; i < tile; i += kThreads) {
        const float* src = ys + i;  // row i / tile_y of the tile is halo row i / tile_y
        float acc = 0.f;
        for (int t = 0; t < s.tx; ++t) acc = fmaf(kx[t], src[t * s.tile_y], acc);
        gm[i] = acc;
      }
    }
  }
  __syncthreads();

  const int vy = s.tile_y / kVec;
  for (int i = tid; i < s.tile_x * vy; i += kThreads) {
    const int r = i / vy, c = (i % vy) * kVec;
    const int gx = x0 + r, gy = y0 + c;
    // with kVec = 4, Y % 4 == 0 and gy % 4 == 0, so gy + 3 < Y as well
    if (gx >= s.x || gy >= s.y) continue;
    const int off = r * s.tile_y + c;
    float sum[kVec];
#pragma unroll
    for (int v = 0; v < kVec; ++v) sum[v] = 0.f;
    if (s.use_cross) {
      for (int mm = 0; mm < s.m; ++mm) {
        float gv[kVec];
        load_vec<kVec>(gs + mm * tile + off, gv);
#pragma unroll
        for (int v = 0; v < kVec; ++v) sum[v] += gv[v];
      }
    }
    for (int mm = 0; mm < s.m; ++mm) {
      const int64_t g = ((static_cast<int64_t>(n) * s.m + mm) * s.x + gx) * s.y + gy;
      float hv[kVec], nv[kVec], pv[kVec], gv[kVec], ov[kVec];
      load_vec<kVec>(h + g, hv);
      load_vec<kVec>(neg + g, nv);
      load_vec<kVec>(pos + g, pv);
      load_vec<kVec>(gs + mm * tile + off, gv);
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        float p = pv[v];
        if (s.use_same) p += s.inh * (gv[v] - hv[v]);
        if (s.use_cross) p += s.cross * (sum[v] - gv[v]);
        ov[v] = hv[v] * nv[v] / (p + s.reg);
      }
      store_vec<kVec>(out + g, ov);
    }
  }
}

template <bool kTwoD, int kVec>
cudaError_t launch(const float* h, const float* neg, const float* pos,
                   const float* taps, float* out, const InhShape& s,
                   int smem_bytes, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(inhibited_mu_h_kernel<kTwoD, kVec>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return err;
  const int n_tiles =
      ((s.x + s.tile_x - 1) / s.tile_x) * ((s.y + s.tile_y - 1) / s.tile_y);
  inhibited_mu_h_kernel<kTwoD, kVec><<<dim3(n_tiles, s.n), kThreads, smem_bytes, st>>>(
      h, neg, pos, taps, out, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tnmf_inhibited_mu_h(const float* h, const float* neg, const float* pos,
                                   const float* taps, float* out, int n, int m, int x,
                                   int y, int tx, int ty, int tile_x, int tile_y,
                                   float inh, float cross, float reg, int use_same,
                                   int use_cross, int two_d, int smem_bytes,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const InhShape s{n, m, x, y, tx, ty, tile_x, tile_y, inh, cross, reg,
                   use_same, use_cross};
  const uintptr_t bits = reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(neg) |
                         reinterpret_cast<uintptr_t>(pos) | reinterpret_cast<uintptr_t>(out);
  const bool vec = y % 4 == 0 && tile_y % 4 == 0 && bits % 16 == 0;
  cudaError_t err;
  if (two_d) {
    err = vec ? launch<true, 4>(h, neg, pos, taps, out, s, smem_bytes, st)
              : launch<true, 1>(h, neg, pos, taps, out, s, smem_bytes, st);
  } else {
    err = vec ? launch<false, 4>(h, neg, pos, taps, out, s, smem_bytes, st)
              : launch<false, 1>(h, neg, pos, taps, out, s, smem_bytes, st);
  }
  return static_cast<int>(err);
}
