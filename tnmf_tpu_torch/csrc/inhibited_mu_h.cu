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
// The first CUDA design kept every atom's field in shared memory (64 KB at
// M = 16, two blocks per SM) and did all its HBM traffic in an epilogue after
// the last atom's stencil, so loads and stencil never overlapped.
//
// Design: a block owns one sample's tile_x x tile_y tile and streams the
// atoms through it, forming each atom's output as soon as its field is
// known.  Per atom: the H tile with its rx / ry halo (zero outside the
// sample) is already in shared memory, copied by cp.async during the last
// atom's passes (two H buffers); the x pass runs down the staged columns
// into a transposed buffer; the y pass runs along it into registers; the
// epilogue takes H from the staged tile and neg / pos from shared memory,
// where cp.async put them during the x pass, and writes H' with 16-byte
// stores when Y % 4 == 0.  Shared memory does not depend on M (46 KB at the
// flagship, 54 KB with the cross-atom sums: four blocks per SM).  The
// cross-atom term needs sum_m g[m] before any output; the stencil is
// linear, so that sum is the stencil of sum_m H[m]: one sweep sums the H
// tiles of all atoms (a second read of H, mostly from L2) and one stencil
// gives the sum, held for the same-atom sweep.
//
// Instruction count: each thread owns 8 outputs of a line (8 rows of a
// column in the x pass, 8 columns of a row in the y pass).  A 2-D stencil
// of at most 17 taps a side comes with a tap count compiled in (9 or 17:
// the wrapper centres the taps in zeros), so every input and tap of a line
// is loaded once and the taps stay in registers; wider stencils slide a
// register window along the line, the taps four at a time.  Bank
// conflicts: consecutive lanes take consecutive columns (x pass) or
// consecutive rows of the transposed buffer (y pass), whose pitch the
// wrapper picks by counting conflicts; the H tile's pitch is odd.  Work
// items are walked with precomputed steps and carries, so no loop divides
// by a runtime extent.
//
// Wide taps: when two H buffers do not fit, one does (the next atom's tile
// is copied after this one's epilogue); when no 8-row tile fits, the
// stencil runs on tiles of one row (also the 1-D kernel: no x pass, one
// output per thread, the y pass of each of the tx staged rows weighted by
// its x tap).  So every shape the first CUDA design took still runs.
//
// Streamed route (kStream, runtime taps, one H buffer): for a stencil whose
// halo tile no block holds in one piece, the taps are walked in segments and
// each segment stages only its part of the halo.  2-D tiles: a segment of
// seg_x x taps stages the tile_x + seg_x - 1 halo rows it reads (all hw
// columns) and adds its x pass into the transposed buffer, which holds
// tile_x x hw whatever tx is; the y pass and the ratio run once, after the
// last segment.  Rows: a segment of seg_x x taps and seg_y y taps stages
// those rows, the tile_y + seg_y - 1 columns they read and the two slices
// of the taps, and each thread adds its output's share in a register.  The
// cross-atom field is the same walk over the atoms' summed segment tiles.
// H at the outputs comes from device memory in the epilogue (the staged
// rows are the last segment's).  Only the streamed route sums in another
// order than one piece (tnmf_tpu_torch/kernels/inhibit.py,
// inhibited_mu_h_segments_plain, sums in its order); every stencil that
// fits in one piece runs the kernel above.
//
// The summed route (kSummed, the cross-atom term under a mesh over the
// atoms): the block holds a rank's atoms, and the atoms' sum over every
// rank arrives as one (N, 1, X, Y) plane hsum, reduced by the engine.  Where
// the cross-atom sweep above sums the H tiles of the block's atoms, this
// route stages the sample's tile of hsum, with its halo, into the same
// buffer (the streamed route: into each segment's staged rows) and runs the
// same stencil on it; each atom's own field is subtracted as before, and
// cross comes divided by the global map count less one.  Only instances
// with kCross and without kModels exist; the others keep their code.
//
// The model axis: a sweep of S models is one launch over S * N samples,
// the models' (N, M, X, Y) stacks back to back.  With a per-model vector
// of strengths (inh[S], cross[S], reg[S] in device memory) sample n reads
// its model's at n / N (the kernel's kModels instances); without one every
// sample reads the scalars (the instances of a single launch).  A
// strength of 0 adds 0 * term, so a sweep that turns an inhibition term on
// for some models leaves the others' updates as they were.
//
// The tile sizes, pitches, buffers, segments and shared memory come from
// the wrapper (tnmf_tpu_torch/kernels/inhibit.py, _geometry), which must use
// the same layout and items as here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct InhShape {
  int n, m, x, y;        // H is (n, m, x, y); a 1-D problem has x = 1
  int tx, ty;            // odd tap counts along x and y (tx = 1 in 1-D)
  int tile_x, tile_y;    // output positions of one block
  int hp, xtp, npp;      // pitches: staged H rows, transposed x pass, neg/pos rows
  float inh, cross, reg;
  int use_same;
  int h_vec;             // stage H with 16-byte copies (hp = 4 mod 8; else hp odd)
  int h_bufs;            // H tile buffers: 2 (the next atom's copied during this one's
                         // passes) or 1 (copied after its epilogue)
  int seg_x, seg_y;      // taps of a segment along x and y (tx and ty: one piece)
};

// the model axis, a kernel parameter of its own: inside InhShape it moved
// the register allocation of the single launches' instances
struct ModelAxis {
  const float* strengths;  // per model: inh[models], cross[models], reg[models]; or null
  int n_per_model, models;
};

// sample n's strengths.  A launch over a model axis (kModels) reads its
// model's (n / n_per_model) from the per-model vector once; a single
// launch holds nothing and reads the scalars from the kernel's parameters
// where they are used
template <bool kModels>
struct SampleStrengths {
  __device__ __forceinline__ SampleStrengths(int64_t, const ModelAxis&) {}
  __device__ __forceinline__ float inh(const InhShape& s) const { return s.inh; }
  __device__ __forceinline__ float cross(const InhShape& s) const { return s.cross; }
  __device__ __forceinline__ float reg(const InhShape& s) const { return s.reg; }
};

template <>
struct SampleStrengths<true> {
  float inh_, cross_, reg_;
  __device__ __forceinline__ SampleStrengths(int64_t n, const ModelAxis& a) {
    const int64_t y = n / a.n_per_model;
    inh_ = a.strengths[y];
    cross_ = a.strengths[a.models + y];
    reg_ = a.strengths[2 * a.models + y];
  }
  __device__ __forceinline__ float inh(const InhShape&) const { return inh_; }
  __device__ __forceinline__ float cross(const InhShape&) const { return cross_; }
  __device__ __forceinline__ float reg(const InhShape&) const { return reg_; }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(n));
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// kS outputs of a 1-D correlation along a line of stride st:
// acc[j] = sum_t k[t] * src[(j + t) * st].  With a compile-time tap count
// kN every input and tap is loaded once into registers; otherwise a
// register window slides along the line, the taps four at a time, then one
// at a time.
template <int kS, int kN>
__device__ __forceinline__ void stencil_line(const float* src, int st, const float* k, int nt,
                                             float (&acc)[kS]) {
  if constexpr (kN > 0) {
    float kv[kN], v[kS + kN - 1];
#pragma unroll
    for (int t = 0; t < kN; ++t) kv[t] = k[t];
#pragma unroll
    for (int i = 0; i < kS + kN - 1; ++i) v[i] = src[i * st];
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      acc[j] = 0.f;
#pragma unroll
      for (int t = 0; t < kN; ++t) acc[j] = fmaf(kv[t], v[j + t], acc[j]);
    }
    return;
  }
  float w[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) { w[j] = src[j * st]; acc[j] = 0.f; }
  int t = 0;
  for (; t + 4 <= nt; t += 4) {
    float c[kS + 3];
#pragma unroll
    for (int j = 0; j < kS; ++j) c[j] = w[j];
#pragma unroll
    for (int q = 0; q < 3; ++q) c[kS + q] = src[(t + kS + q) * st];
    const float k0 = k[t], k1 = k[t + 1], k2 = k[t + 2], k3 = k[t + 3];
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      acc[j] = fmaf(k0, c[j], acc[j]);
      acc[j] = fmaf(k1, c[j + 1], acc[j]);
      acc[j] = fmaf(k2, c[j + 2], acc[j]);
      acc[j] = fmaf(k3, c[j + 3], acc[j]);
    }
    if (t + 4 < nt) {
#pragma unroll
      for (int j = 0; j < kS; ++j) w[j] = j + 4 < kS + 3 ? c[j + 4] : src[(t + 4 + j) * st];
    }
  }
  for (; t < nt; ++t) {
    const float kv = k[t];
#pragma unroll
    for (int j = 0; j < kS; ++j) acc[j] = fmaf(kv, w[j], acc[j]);
    if (t + 1 < nt) {
#pragma unroll
      for (int j = 0; j + 1 < kS; ++j) w[j] = w[j + 1];
      w[kS - 1] = src[(t + kS) * st];
    }
  }
}

// 2-D: 8 x-pass rows and 8 y-pass columns per thread; rows (1-D, and 2-D
// taps too wide for 8-row tiles): tiles of one row, no x pass and one
// output per thread (lanes on consecutive columns)
template <bool kTwoD>
struct Tiling {
  static constexpr int kSX = 8;
  static constexpr int kSY = kTwoD ? 8 : 1;
};

// The streamed route (see the header): one block's tile, the taps walked in
// segments through one H buffer.
template <bool kTwoD, int kVec, bool kCross, bool kModels, bool kSummed>
__device__ __forceinline__ void streamed(const float* __restrict__ h,
                                         const float* __restrict__ neg,
                                         const float* __restrict__ pos,
                                         const float* __restrict__ taps,
                                         float* __restrict__ out, const InhShape& s,
                                         const ModelAxis& a,
                                         const float* __restrict__ hsum_in) {
  constexpr int kSX = Tiling<kTwoD>::kSX;
  constexpr int kSY = Tiling<kTwoD>::kSY;
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int rx = s.tx / 2, ry = s.ty / 2;
  const int hw = s.tile_y + 2 * ry;        // the tile's halo columns (2-D)
  const int seg_rows = kTwoD ? s.tile_x + s.seg_x - 1 : s.seg_x;
  const int nps_sz = s.tile_x * s.npp;
  float* nps = smem;                       // [2][tile_x][npp] neg, pos
  float* hs = nps + 2 * nps_sz;            // [seg_rows][hp] one segment of H
  float* xst = hs + seg_rows * s.hp;       // [hw][xtp] x pass, transposed (2-D)
  float* ssum = xst + (kTwoD ? hw * s.xtp : 0);  // [kSY][threads] cross-atom sums (2-D)
  float* ks = ssum + (kTwoD && kCross ? kSY * kThreads : 0);  // 2-D: kx, ky; rows:
                                                              // the segment's slices

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t n = static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  if (n >= s.n) return;
  const SampleStrengths<kModels> sv(n, a);
  const int n_ty = (s.y + s.tile_y - 1) / s.tile_y;
  const int x0 = (blockIdx.x / n_ty) * s.tile_x;
  const int y0 = (blockIdx.x % n_ty) * s.tile_y;
  const int64_t plane = static_cast<int64_t>(s.x) * s.y;
  const int64_t sample = n * s.m * plane;
  const int n_sx = (s.tx + s.seg_x - 1) / s.seg_x;
  const int n_sy = (s.ty + s.seg_y - 1) / s.seg_y;  // 1 in 2-D tiles

  if constexpr (kTwoD) {
    for (int i = tid; i < s.tx + s.ty; i += kThreads) ks[i] = taps[i];
  }
  const int n_xseg = s.tile_x / kSX;
  const int x_c0 = tid % hw, x_s0 = tid / hw;
  const int x_dc = kThreads % hw, x_ds = kThreads / hw;
  const int yr = tid % s.tile_x, yu = tid / s.tile_x;
  const bool y_on = yu < s.tile_y / kSY;
  const int yc0 = yu * kSY;

  auto stage_np = [&](int mm) {
    const int64_t base = sample + mm * plane;
    for (int r = warp; r < s.tile_x; r += kWarps) {
      const int gx = x0 + r;
      const int64_t row = base + static_cast<int64_t>(gx) * s.y + y0;
      for (int v = lane; v < s.tile_y / kVec; v += 32) {
        const int gy = y0 + v * kVec;
        const bool ok = gx < s.x && gy < s.y;  // kVec = 4: Y % 4 == 0, whole vectors
        copy_async<4 * kVec>(nps + r * s.npp + v * kVec, ok ? neg + row + v * kVec : neg, ok);
        copy_async<4 * kVec>(nps + nps_sz + r * s.npp + v * kVec,
                             ok ? pos + row + v * kVec : pos, ok);
      }
    }
  };
  // rows [r0, r0 + nr) and columns [c0, c0 + nc) of the halo tile of atom
  // mm (mm < 0: summed over the atoms, or the given sum) into hs, zero
  // outside the sample;
  // the threads walk the elements row by row with carries (no division)
  auto stage = [&](int mm, int r0, int nr, int c0, int nc) {
    const int dc = kThreads % nc, dr = kThreads / nc;
    for (int i = tid, r = tid / nc, c = tid % nc; i < nr * nc; i += kThreads) {
      const int gx = x0 - rx + r0 + r, gy = y0 - ry + c0 + c;
      const bool ok = gx >= 0 && gx < s.x && gy >= 0 && gy < s.y;
      const float* src = h + sample + static_cast<int64_t>(gx) * s.y + gy;
      if (mm >= 0) {
        copy_async<4>(hs + r * s.hp + c, ok ? src + mm * plane : h, ok);
      } else {
        float v = 0.f;
        if (ok) {
          if constexpr (kSummed) {
            v = __ldg(hsum_in + n * plane + static_cast<int64_t>(gx) * s.y + gy);
          } else {
#pragma unroll 8
            for (int m = 0; m < s.m; ++m) v += __ldg(src + m * plane);
          }
        }
        hs[r * s.hp + c] = v;
      }
      r += dr;
      c += dc;
      if (c >= nc) { c -= nc; ++r; }
    }
  };
  // every segment of atom mm (or of the atoms' sum): 2-D tiles add their x
  // pass into xst, rows the field at this thread's output into g
  auto walk = [&](int mm, float& g) {
    for (int qx = 0; qx < n_sx; ++qx) {
      const int t0x = qx * s.seg_x, nx = min(s.seg_x, s.tx - t0x);
      for (int qy = 0; qy < n_sy; ++qy) {
        const int t0y = qy * s.seg_y, ny = min(s.seg_y, s.ty - t0y);
        __syncthreads();  // the last segment's passes are done with hs and the taps
        if constexpr (!kTwoD) {
          for (int i = tid; i < nx; i += kThreads) ks[i] = taps[t0x + i];
          for (int i = tid; i < ny; i += kThreads) ks[s.seg_x + i] = taps[s.tx + t0y + i];
        }
        stage(mm, t0x, kTwoD ? s.tile_x + nx - 1 : nx, t0y, kTwoD ? hw : s.tile_y + ny - 1);
        commit();
        asm volatile("cp.async.wait_group 0;\n" ::);
        __syncthreads();
        if constexpr (kTwoD) {
          int c = x_c0, sg = x_s0;
          while (sg < n_xseg) {
            float acc[kSX];
            stencil_line<kSX, 0>(hs + sg * kSX * s.hp + c, s.hp, ks + t0x, nx, acc);
            float* d = xst + c * s.xtp + sg * kSX;
#pragma unroll
            for (int j = 0; j < kSX; ++j) d[j] = qx == 0 ? acc[j] : d[j] + acc[j];
            c += x_dc;
            sg += x_ds;
            if (c >= hw) { c -= hw; ++sg; }
          }
        } else if (y_on) {
          for (int i = 0; i < nx; ++i) {
            float r[1];
            stencil_line<1, 0>(hs + i * s.hp + yc0, 1, ks + s.seg_x, ny, r);
            g = fmaf(ks[i], r[0], g);
          }
        }
      }
    }
    if constexpr (kTwoD) __syncthreads();  // xst complete for the y pass
  };
  // y pass of xst at this thread's kSY outputs (2-D)
  auto pass_y = [&](float (&g)[kSY]) {
    if (y_on) stencil_line<kSY, 0>(xst + yc0 * s.xtp + yr, s.xtp, ks + s.tx, s.ty, g);
  };

  float rsum = 0.f;  // rows: the cross-atom sum of the fields at this thread's output
  if constexpr (kCross) {
    walk(-1, rsum);
    if constexpr (kTwoD) {
      float sum[kSY];
      pass_y(sum);
#pragma unroll
      for (int j = 0; j < kSY; ++j) ssum[j * kThreads + tid] = sum[j];  // read back by tid
    }
  }
  for (int mm = 0; mm < s.m; ++mm) {
    __syncthreads();  // the last atom's epilogue is done with neg and pos
    stage_np(mm);
    commit();  // lands with the first segment
    float g[kSY], g_row = 0.f;
    walk(mm, g_row);
    if constexpr (kTwoD) {
      pass_y(g);
    } else {
      g[0] = g_row;
    }
    const int gx = x0 + yr, gy0 = y0 + yc0;
    if (y_on && gx < s.x) {
      const int64_t at = sample + mm * plane + static_cast<int64_t>(gx) * s.y + gy0;
      const float* nr = nps + yr * s.npp + yc0;
      float o[kSY];
#pragma unroll
      for (int j = 0; j < kSY; ++j) {
        const float hv = gy0 + j < s.y ? __ldg(h + at + j) : 0.f;
        float p = nr[nps_sz + j];
        if (s.use_same) p += sv.inh(s) * (g[j] - hv);
        if constexpr (kCross) {
          if constexpr (kTwoD) {
            p += sv.cross(s) * (ssum[j * kThreads + tid] - g[j]);
          } else {
            p += sv.cross(s) * (rsum - g[j]);
          }
        }
        o[j] = hv * nr[j] / (p + sv.reg(s));
      }
      float* dst = out + at;
#pragma unroll
      for (int j = 0; j < kSY; j += (kVec == 4 && kSY % 4 == 0) ? 4 : 1) {
        if constexpr (kVec == 4 && kSY % 4 == 0) {
          // Y % 4 == 0 and gy0 % 4 == 0: a quad is wholly inside or outside
          if (gy0 + j < s.y)
            *reinterpret_cast<float4*>(dst + j) = make_float4(o[j], o[j + 1], o[j + 2], o[j + 3]);
        } else {
          if (gy0 + j < s.y) dst[j] = o[j];
        }
      }
    }
  }
}

// four blocks per SM (64 registers a thread) with the tap count compiled
// in; three (up to 85 registers) for the runtime tap loop, whose window
// spills at 64 (its 2-D cross-atom instances still spill a few words)
template <bool kTwoD, int kVec, bool kCross, bool kModels, int kTaps, bool kStream,
          bool kSummed>
__global__ void __launch_bounds__(kThreads, kTaps > 0 ? 4 : 3)
inhibited_mu_h_kernel(const float* __restrict__ h, const float* __restrict__ neg,
                      const float* __restrict__ pos, const float* __restrict__ taps,
                      float* __restrict__ out, InhShape s, ModelAxis a,
                      const float* __restrict__ hsum_in) {
  if constexpr (kStream) {
    streamed<kTwoD, kVec, kCross, kModels, kSummed>(h, neg, pos, taps, out, s, a, hsum_in);
    return;
  }
  constexpr int kSX = Tiling<kTwoD>::kSX;
  constexpr int kSY = Tiling<kTwoD>::kSY;
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int rx = s.tx / 2, ry = s.ty / 2;
  const int hr = s.tile_x + 2 * rx;        // staged rows (tile + halo)
  const int hw = s.tile_y + 2 * ry;        // staged columns (tile + halo)
  const int nps_sz = s.tile_x * s.npp;
  const int hsz = hr * s.hp;
  // compiled taps (at most 17) always leave room for two H buffers
  const int h_bufs = kTaps > 0 ? 2 : s.h_bufs;
  float* nps = smem;                       // [2][tile_x][npp] neg, pos
  float* hs0 = nps + 2 * nps_sz;           // [h_bufs][hr][hp] H tile with halo
  float* xst = hs0 + h_bufs * hsz;         // [hw][xtp] x pass, transposed (2-D)
  float* ssum = xst + (kTwoD ? hw * s.xtp : 0);  // [kSY][threads] cross-atom sums (2-D)
  float* ks = ssum + (kTwoD && kCross ? kSY * kThreads : 0);  // kx[tx], ky[ty]
  const float* kx = ks;
  const float* ky = ks + s.tx;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the samples run along y, and on along z past a grid's 65535 rows
  const int64_t n = static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  if (n >= s.n) return;
  const SampleStrengths<kModels> sv(n, a);
  const int n_ty = (s.y + s.tile_y - 1) / s.tile_y;
  const int x0 = (blockIdx.x / n_ty) * s.tile_x;
  const int y0 = (blockIdx.x % n_ty) * s.tile_y;
  const int64_t plane = static_cast<int64_t>(s.x) * s.y;
  const int64_t sample = n * s.m * plane;

  for (int i = tid; i < s.tx + s.ty; i += kThreads) ks[i] = taps[i];

  // x-pass items (column c, row segment sg), columns fastest, walked with
  // carries; y-pass item (row yr, column segment yu), one per thread
  const int n_xseg = s.tile_x / kSX;
  const int x_c0 = tid % hw, x_s0 = tid / hw;
  const int x_dc = kThreads % hw, x_ds = kThreads / hw;
  const int yr = tid % s.tile_x, yu = tid / s.tile_x;
  const bool y_on = yu < s.tile_y / kSY;
  const int yc0 = yu * kSY;

  auto stage_h = [&](int mm, float* hs) {
    const float* hp = h + sample + mm * plane;
    for (int r = warp; r < hr; r += kWarps) {
      const int gx = x0 - rx + r;
      const bool row_ok = gx >= 0 && gx < s.x;
      const float* src = hp + static_cast<int64_t>(gx) * s.y + y0 - ry;
      float* dst = hs + r * s.hp;
      if (s.h_vec) {
        // Y % 4 == 0 and (y0 - ry) % 4 == 0: a quad is wholly inside or outside
        for (int c = 4 * lane; c < hw; c += 128) {
          const int gy = y0 - ry + c;
          const bool ok = row_ok && gy >= 0 && gy < s.y;
          copy_async<16>(dst + c, ok ? src + c : h, ok);
        }
      } else {
        for (int c = lane; c < hw; c += 32) {
          const int gy = y0 - ry + c;
          const bool ok = row_ok && gy >= 0 && gy < s.y;
          copy_async<4>(dst + c, ok ? src + c : h, ok);
        }
      }
    }
  };
  auto stage_np = [&](int mm) {
    const int64_t base = sample + mm * plane;
    for (int r = warp; r < s.tile_x; r += kWarps) {
      const int gx = x0 + r;
      const int64_t row = base + static_cast<int64_t>(gx) * s.y + y0;
      for (int v = lane; v < s.tile_y / kVec; v += 32) {
        const int gy = y0 + v * kVec;
        const bool ok = gx < s.x && gy < s.y;  // kVec = 4: Y % 4 == 0, whole vectors
        copy_async<4 * kVec>(nps + r * s.npp + v * kVec, ok ? neg + row + v * kVec : neg, ok);
        copy_async<4 * kVec>(nps + nps_sz + r * s.npp + v * kVec,
                             ok ? pos + row + v * kVec : pos, ok);
      }
    }
  };
  // x pass of the staged tile hs into xst (2-D only)
  auto pass_x = [&](const float* hs) {
    if constexpr (kTwoD) {
      int c = x_c0, sg = x_s0;
      while (sg < n_xseg) {
        float acc[kSX];
        stencil_line<kSX, kTaps>(hs + sg * kSX * s.hp + c, s.hp, kx, s.tx, acc);
#pragma unroll
        for (int j = 0; j < kSX; ++j) xst[c * s.xtp + sg * kSX + j] = acc[j];
        c += x_dc;
        sg += x_ds;
        if (c >= hw) { c -= hw; ++sg; }
      }
    }
  };
  // y pass: the field at this thread's kSY outputs (from xst in 2-D; in
  // rows, the y pass of each staged row weighted by its x tap)
  auto pass_y = [&](const float* hs, float (&g)[kSY]) {
    if (!y_on) return;
    if constexpr (kTwoD) {
      stencil_line<kSY, kTaps>(xst + yc0 * s.xtp + yr, s.xtp, ky, s.ty, g);
    } else {
      g[0] = 0.f;
      for (int i = 0; i < s.tx; ++i) {
        float r[1];
        stencil_line<1, 0>(hs + i * s.hp + yc0, 1, ky, s.ty, r);
        g[0] = fmaf(kx[i], r[0], g[0]);
      }
    }
  };
  auto stage_first = [&]() {
    stage_h(0, hs0);
    commit();
    stage_np(0);
    commit();
  };

  // with one H buffer the cross-atom sweep below needs it, so the first
  // atom's copies start after that sweep
  const bool first_early = h_bufs == 2 || !kCross;
  if (first_early) stage_first();

  float rsum[kSY];  // rows: the cross-atom sum of the fields at this thread's output
  if constexpr (kCross) {
    // the field is linear in H: sum_m (H[m] (*) k) = (sum_m H[m]) (*) k, so
    // one sweep sums the H tiles (into the last H buffer; the summed route
    // stages the given sum there) and one stencil gives the sum of the fields
    float* hsum = hs0 + (h_bufs - 1) * hsz;
    const float* sum_src = kSummed ? hsum_in + n * plane : h + sample;
    for (int r = warp; r < hr; r += kWarps) {
      const int gx = x0 - rx + r;
      const bool row_ok = gx >= 0 && gx < s.x;
      const float* row = sum_src + static_cast<int64_t>(gx) * s.y + y0 - ry;
      if (s.h_vec) {
        // quads wholly inside or outside, as in stage_h; eight atoms in flight
        for (int c = 4 * lane; c < hw; c += 128) {
          const int gy = y0 - ry + c;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (row_ok && gy >= 0 && gy < s.y) {
            if constexpr (kSummed) {
              v = __ldg(reinterpret_cast<const float4*>(row + c));
            } else {
#pragma unroll 8
              for (int mm = 0; mm < s.m; ++mm) {
                const float4 q = __ldg(reinterpret_cast<const float4*>(row + c + mm * plane));
                v.x += q.x; v.y += q.y; v.z += q.z; v.w += q.w;
              }
            }
          }
          *reinterpret_cast<float4*>(hsum + r * s.hp + c) = v;
        }
      } else {
        for (int c = lane; c < hw; c += 32) {
          const int gy = y0 - ry + c;
          float v = 0.f;
          if (row_ok && gy >= 0 && gy < s.y) {
            if constexpr (kSummed) {
              v = __ldg(row + c);
            } else {
#pragma unroll 8
              for (int mm = 0; mm < s.m; ++mm) v += __ldg(row + c + mm * plane);
            }
          }
          hsum[r * s.hp + c] = v;
        }
      }
    }
    __syncthreads();
    pass_x(hsum);
    __syncthreads();
    if constexpr (kTwoD) {
      // kept in shared memory (each thread reads back its own) rather than
      // registers, which the same-atom sweep needs
      float sum[kSY];
      pass_y(hsum, sum);
#pragma unroll
      for (int j = 0; j < kSY; ++j) ssum[j * kThreads + tid] = sum[j];
    } else {
      pass_y(hsum, rsum);
    }
    __syncthreads();  // xst and the H buffer may be reused
  }
  if (!first_early) stage_first();

  for (int mm = 0; mm < s.m; ++mm) {
    float* hs = hs0 + (h_bufs == 2 ? (mm & 1) * hsz : 0);
    wait_all_but_last();  // this atom's H tile has landed (neg/pos may not)
    __syncthreads();
    if (h_bufs == 2 && mm + 1 < s.m) stage_h(mm + 1, hs0 + ((mm + 1) & 1) * hsz);
    commit();
    pass_x(hs);
    wait_all_but_last();  // this atom's neg and pos have landed
    __syncthreads();
    float g[kSY];
    pass_y(hs, g);

    const int gx = x0 + yr, gy0 = y0 + yc0;
    if (y_on && gx < s.x) {
      const float* hc = hs + (yr + rx) * s.hp + yc0 + ry;
      const float* nr = nps + yr * s.npp + yc0;
      float nv[kSY], pv[kSY], hv[kSY], o[kSY];
      if constexpr (kSY % 4 == 0) {
        if (s.h_vec) {  // yc0 % 8 == 0, ry % 4 == 0 and hp % 8 == 4: aligned float4s
#pragma unroll
          for (int j = 0; j < kSY; j += 4) {
            const float4 a = *reinterpret_cast<const float4*>(hc + j);
            hv[j] = a.x; hv[j + 1] = a.y; hv[j + 2] = a.z; hv[j + 3] = a.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < kSY; ++j) hv[j] = hc[j];
        }
        // lanes on consecutive rows: float4s with an npp of 4 mod 8 floats
#pragma unroll
        for (int j = 0; j < kSY; j += 4) {
          const float4 a = *reinterpret_cast<const float4*>(nr + j);
          const float4 b = *reinterpret_cast<const float4*>(nr + nps_sz + j);
          nv[j] = a.x; nv[j + 1] = a.y; nv[j + 2] = a.z; nv[j + 3] = a.w;
          pv[j] = b.x; pv[j + 1] = b.y; pv[j + 2] = b.z; pv[j + 3] = b.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kSY; ++j) { nv[j] = nr[j]; pv[j] = nr[nps_sz + j]; hv[j] = hc[j]; }
      }
#pragma unroll
      for (int j = 0; j < kSY; ++j) {
        float p = pv[j];
        if (s.use_same) p += sv.inh(s) * (g[j] - hv[j]);
        if constexpr (kCross) {
          if constexpr (kTwoD) {
            p += sv.cross(s) * (ssum[j * kThreads + tid] - g[j]);
          } else {
            p += sv.cross(s) * (rsum[j] - g[j]);
          }
        }
        o[j] = hv[j] * nv[j] / (p + sv.reg(s));
      }
      float* dst = out + sample + mm * plane + static_cast<int64_t>(gx) * s.y + gy0;
#pragma unroll
      for (int j = 0; j < kSY; j += (kVec == 4 && kSY % 4 == 0) ? 4 : 1) {
        if constexpr (kVec == 4 && kSY % 4 == 0) {
          // Y % 4 == 0 and gy0 % 4 == 0: a quad is wholly inside or outside
          if (gy0 + j < s.y)
            *reinterpret_cast<float4*>(dst + j) = make_float4(o[j], o[j + 1], o[j + 2], o[j + 3]);
        } else {
          if (gy0 + j < s.y) dst[j] = o[j];
        }
      }
    }
    __syncthreads();  // neg/pos, xst and (one buffer) the H tile may be refilled
    if (h_bufs == 1) {
      if (mm + 1 < s.m) stage_h(mm + 1, hs0);
      commit();
    }
    if (mm + 1 < s.m) stage_np(mm + 1);
    commit();
  }
}

template <bool kTwoD, int kVec, bool kCross, bool kModels, bool kSummed, int kTaps,
          bool kStream = false>
cudaError_t launch(const float* h, const float* neg, const float* pos,
                   const float* taps, float* out, const InhShape& s, const ModelAxis& a,
                   const float* hsum, int smem_bytes, cudaStream_t st) {
  auto kernel = inhibited_mu_h_kernel<kTwoD, kVec, kCross, kModels, kTaps, kStream, kSummed>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return err;
  const int n_tiles =
      ((s.x + s.tile_x - 1) / s.tile_x) * ((s.y + s.tile_y - 1) / s.tile_y);
  const int ny = s.n < 65535 ? s.n : 65535;
  kernel<<<dim3(n_tiles, ny, (s.n + ny - 1) / ny), kThreads, smem_bytes, st>>>(h, neg, pos,
                                                                              taps, out, s, a,
                                                                              hsum);
  return cudaGetLastError();
}

// 2-D tiles with a tap count compiled in (the wrapper pads the taps of both
// axes with zeros to it), else the runtime tap loop, in one piece or streamed
template <bool kTwoD, int kVec, bool kCross, bool kModels, bool kSummed>
cudaError_t launch_taps(int compiled, const float* h, const float* neg, const float* pos,
                        const float* taps, float* out, const InhShape& s, const ModelAxis& a,
                        const float* hsum, int smem_bytes, cudaStream_t st) {
  if (s.seg_x < s.tx || s.seg_y < s.ty)
    return launch<kTwoD, kVec, kCross, kModels, kSummed, 0, true>(h, neg, pos, taps, out, s, a, hsum, smem_bytes, st);
  if constexpr (kTwoD) {
    if (compiled == 9) return launch<kTwoD, kVec, kCross, kModels, kSummed, 9>(h, neg, pos, taps, out, s, a, hsum, smem_bytes, st);
    if (compiled == 17) return launch<kTwoD, kVec, kCross, kModels, kSummed, 17>(h, neg, pos, taps, out, s, a, hsum, smem_bytes, st);
  }
  if (compiled) return cudaErrorInvalidValue;
  return launch<kTwoD, kVec, kCross, kModels, kSummed, 0>(h, neg, pos, taps, out, s, a, hsum, smem_bytes, st);
}

// the summed route (hsum given) only with the cross-atom term and without a
// model axis
template <bool kTwoD, int kVec, bool kCross>
cudaError_t launch_models(const float* h, const float* neg, const float* pos,
                          const float* taps, float* out, const InhShape& s, const ModelAxis& a,
                          const float* hsum, int compiled, int smem_bytes, cudaStream_t st) {
  if (hsum != nullptr) {
    if constexpr (kCross) {
      if (a.strengths != nullptr) return cudaErrorInvalidValue;
      return launch_taps<kTwoD, kVec, true, false, true>(compiled, h, neg, pos, taps, out, s, a, hsum, smem_bytes, st);
    }
    return cudaErrorInvalidValue;
  }
  return a.strengths != nullptr
      ? launch_taps<kTwoD, kVec, kCross, true, false>(compiled, h, neg, pos, taps, out, s, a, nullptr, smem_bytes, st)
      : launch_taps<kTwoD, kVec, kCross, false, false>(compiled, h, neg, pos, taps, out, s, a, nullptr, smem_bytes, st);
}

template <bool kTwoD, int kVec>
cudaError_t launch_cross(bool cross, int compiled, const float* h, const float* neg,
                         const float* pos, const float* taps, float* out, const InhShape& s,
                         const ModelAxis& a, const float* hsum, int smem_bytes, cudaStream_t st) {
  return cross
      ? launch_models<kTwoD, kVec, true>(h, neg, pos, taps, out, s, a, hsum, compiled, smem_bytes, st)
      : launch_models<kTwoD, kVec, false>(h, neg, pos, taps, out, s, a, hsum, compiled, smem_bytes, st);
}

}  // namespace

extern "C" int tnmf_inhibited_mu_h(const float* h, const float* neg, const float* pos,
                                   const float* taps, float* out, int n, int m, int x,
                                   int y, int tx, int ty, int tile_x, int tile_y, int hp,
                                   int xtp, int npp, float inh, float cross, float reg,
                                   int use_same, int use_cross, int two_d, int vec,
                                   int h_vec, int h_bufs, int compiled, int seg_x, int seg_y,
                                   int smem_bytes, const float* strengths, int n_per_model,
                                   int models, const float* hsum, void* stream) {
  // vec: Y % 4 == 0 and 16-byte aligned tensors (neg/pos copies, H' stores);
  // h_vec: vec and ry % 4 == 0 as well (H tile copies); compiled: 0, or the
  // tap count of both axes (2-D tiles); seg_x, seg_y: the taps of a segment
  // (tx and ty: one piece; else the streamed route, one H buffer, 4-byte H
  // copies, and 2-D tiles take every y tap in each segment); hsum: the summed
  // route's (N, 1, X, Y) atoms' sum (with use_cross, no model axis), or null
  if (compiled && (!two_d || tx != compiled || ty != compiled || h_bufs != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool segmented = seg_x < tx || seg_y < ty;
  if (seg_x < 1 || seg_y < 1 || seg_x > tx || seg_y > ty ||
      (segmented && (compiled || h_vec || h_bufs != 1 || (two_d && seg_y != ty))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (models < 1 || n_per_model < 1 || static_cast<int64_t>(n_per_model) * models != n)
    return static_cast<int>(cudaErrorInvalidValue);
  const InhShape s{n, m, x, y, tx, ty, tile_x, tile_y, hp, xtp, npp, inh, cross, reg,
                   use_same, h_vec, h_bufs, seg_x, seg_y};
  const ModelAxis a{strengths, n_per_model, models};
  const bool c = use_cross != 0;
  cudaError_t err;
  if (two_d) {
    err = vec ? launch_cross<true, 4>(c, compiled, h, neg, pos, taps, out, s, a, hsum, smem_bytes, st)
              : launch_cross<true, 1>(c, compiled, h, neg, pos, taps, out, s, a, hsum, smem_bytes, st);
  } else {
    err = vec ? launch_cross<false, 4>(c, compiled, h, neg, pos, taps, out, s, a, hsum, smem_bytes, st)
              : launch_cross<false, 1>(c, compiled, h, neg, pos, taps, out, s, a, hsum, smem_bytes, st);
  }
  return static_cast<int>(err);
}
