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
// Two kernels; the wrapper (tnmf_tpu_torch/kernels/mu_h.py, _geometry)
// picks one from the shapes before the launch:
//
// mu_h_mma_kernel, the tensor-core route (whenever its windows and the
// split dictionary fit a block).  Per sample the update is a GEMM:
// (atoms) x (C*Ax*Ay taps) x (positions), 23 GFLOP at the flagship
// (64 x 1 x 256 x 256, 16 atoms of 9 x 9).  On mma.sync m16n8k8 TF32 with
// 3xTF32 (tf32_mma.cuh) that is 69 GFLOP at 495 TFLOP/s, 0.14 ms, under
// the 0.18 ms that its 609 MB of traffic take at 3.35 TB/s, so bytes bound
// it.  Rows are the atoms (16 per row tile; atoms past M are zero), k the
// flattened (c, ax, ay) taps padded to a multiple of 8 (81 -> 88), columns
// runs of 8 consecutive ty positions.  The block splits W once into big and
// small TF32 planes stored in fragment order (two float4 loads per lane and
// k step).  The B fragments are sliding-window reads of the staged Vp and
// Rx windows at per-tap offsets fixed for the whole kernel (a table in
// shared memory); the two correlations share the A fragment, so each k step
// makes 6 MMAs per column tile, and the MMA sums run over all k steps in
// float32 (3 * 11 accumulations at the flagship).  The ratio is taken
// straight from the accumulators.  A persistent grid walks chunks of
// (n, Tr rows of tx, Tc columns of ty) with every channel and every atom in
// one block, so each window is staged once: cp.async copies (16 bytes when
// the rows allow it, zero-filled outside the arrays) bring it into a raw
// plane, the block splits it once into big and small TF32 planes (splitting
// at every fragment load cost more than the MMAs), and the next chunk's
// copies into the raw plane overlap this chunk's MMAs.  A warp owns work
// items of one tx row and up to kNT column tiles.  In one TF32 pass
// (kPasses = 1, the TF32 precision levels) W and each window are rounded once
// (cvt.rna) into a big plane alone and each k step makes 2 MMAs per column
// tile: a third of the tensor-core work, no small plane to stage or load,
// so shared memory holds the dictionary's fragments once and two window
// planes, and larger chunks fit; bytes bound it there (0.05 ms of MMAs at
// the flagship against 0.18 ms of traffic).
//
// mu_h_kernel, the FP32 route of the first port (for shapes whose windows
// and split dictionary no block can hold).  A block computes a 16 x 64 tile
// of (tx, ty) positions of one sample for 8 atoms (blockIdx.z walks the atom
// groups; blockIdx.x the tiles of every sample, so any number of samples
// launches).  Its reduction streams over the taps k = (c, ax, ay) in
// segments: each segment stages its channels' (16 + rows - 1) x (64 + cols - 1)
// windows of Vp and Rx and its 8 atoms' slice of W (transposed to
// [c][ax][ay][8], so each thread reads its 8 weights as two broadcast float4
// loads) in shared memory, and accumulates into the same registers; the
// ratio is taken once, after the last segment.  A segment is all the taps
// when they fit a block (the first port's kernel), else whole channels, else
// whole atom rows of one channel, else a stretch of one atom row: the taps
// stay in (c, ax, ay) order, so every segmentation sums in the same order.
// Each thread owns 4 positions strided by 16 along ty (conflict-free shared
// loads, coalesced global stores) for the 8 atoms: per tap it makes 8 shared
// loads of data and 2 of weights for 64 FMAs.  The window pitch is padded to
// 16 mod 32 words so the two rows a warp spans fall on disjoint banks.
//
// The model axis: a sweep of S models is one launch, the models along
// gridDim.y of either route.  Model y reads its own Rx, W, H and pos_extra
// and writes its own out (contiguous S stacks), and Vp at a model stride of
// its own: 0 where the sweep's models share one data stream (beta = 2
// without a mask), so Vp is never copied S times.  Its denom_add is
// denoms[y] from its per-model vector.  The tensor-core route's blocks are
// persistent per model: each stages its model's split dictionary once and
// walks that model's chunks as a single launch does, so no block restages
// W, and every model gets the bits of its own single launch.  The model
// offsets and the vector are in the kModels instances of either kernel: a
// single launch runs instances with no model-axis code, which keep a
// single model's registers and schedule.
//
// The shared-memory sizes, pitches and tiles come from the wrapper, which
// must use the same tile constants and shared layouts as here.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr int kCols = 16;              // threads along ty
constexpr int kRows = 16;              // threads along tx
constexpr int kPT = 4;                 // ty positions per thread, strided by kCols
constexpr int kMB = 8;                 // atoms per block
constexpr int kTileX = kRows;          // block tile along tx
constexpr int kTileY = kCols * kPT;    // block tile along ty

struct MuHShape {
  int n, m, c, ex, ey, tx, ty, ax, ay;
  int pitch;       // staged window row pitch (floats)
  int sc, sa, sb;  // a segment's channels, atom rows and atom columns
  int64_t vp_ms;   // Vp's model stride (floats; 0: shared by the models)
  const float* denoms;  // the models' denom_add (the kModels instance)
};

// where model blockIdx.y of a launch over the model axis starts in each
// operand (floats)
struct ModelOffsets {
  int64_t vp, rx, w, h;
};

__device__ __forceinline__ ModelOffsets model_offsets(int64_t vp_ms, int n, int m, int c,
                                                      int ex, int ey, int tx, int ty, int ax,
                                                      int ay) {
  const int64_t y = blockIdx.y;
  return ModelOffsets{y * vp_ms, y * (static_cast<int64_t>(n) * c * ex * ey),
                      y * (static_cast<int64_t>(m) * c * ax * ay),
                      y * (static_cast<int64_t>(n) * m * tx * ty)};
}

// model blockIdx.y's operands and denom_add (denoms[y])
#define TO_MODEL(s)                                                                         \
  do {                                                                                      \
    const ModelOffsets mo =                                                                 \
        model_offsets(s.vp_ms, s.n, s.m, s.c, s.ex, s.ey, s.tx, s.ty, s.ax, s.ay);          \
    vp += mo.vp;                                                                            \
    rx += mo.rx;                                                                            \
    w += mo.w;                                                                              \
    h += mo.h;                                                                              \
    out += mo.h;                                                                            \
    if (pos_extra != nullptr) pos_extra += mo.h;                                            \
    denom_add = s.denoms[blockIdx.y];                                                       \
  } while (0)

template <bool kModels>
__global__ void __launch_bounds__(kCols * kRows, 2)
mu_h_kernel(const float* __restrict__ vp, const float* __restrict__ rx,
            const float* __restrict__ w, const float* __restrict__ h,
            const float* __restrict__ pos_extra, float denom_add,
            float* __restrict__ out, MuHShape s) {
  if constexpr (kModels) TO_MODEL(s);
  extern __shared__ float4 smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int xr = kTileX + s.sa - 1;  // window rows of a segment (the row stride)
  const int win = s.sc * xr * s.pitch;
  float* vs = smem;            // [sc][xr][pitch]
  float* rs = smem + win;      // [sc][xr][pitch]
  float* wt = smem + 2 * win;  // [sc][sa][sb][kMB]

  const int tid = threadIdx.y * kCols + threadIdx.x;
  const int n_ty = (s.ty + kTileY - 1) / kTileY;
  const int n_tiles = ((s.tx + kTileX - 1) / kTileX) * n_ty;
  const int n = blockIdx.x / n_tiles;
  const int tile = blockIdx.x % n_tiles;
  const int tx0 = (tile / n_ty) * kTileX;
  const int ty0 = (tile % n_ty) * kTileY;
  const int m0 = blockIdx.z * kMB;
  const int taps = s.c * s.ax * s.ay;

  float neg[kMB][kPT], pos[kMB][kPT];
#pragma unroll
  for (int k = 0; k < kMB; ++k)
#pragma unroll
    for (int p = 0; p < kPT; ++p) {
      neg[k][p] = 0.f;
      pos[k][p] = 0.f;
    }

  const int row = threadIdx.y, col = threadIdx.x;
  for (int c0 = 0; c0 < s.c; c0 += s.sc) {
    const int nc = min(s.sc, s.c - c0);
    for (int a0 = 0; a0 < s.ax; a0 += s.sa) {
      const int na = min(s.sa, s.ax - a0);
      for (int b0 = 0; b0 < s.ay; b0 += s.sb) {
        const int nb = min(s.sb, s.ay - b0);
        __syncthreads();  // the last segment's taps are done with the shared tiles
        for (int i = tid; i < nc * na * nb * kMB; i += kCols * kRows) {
          const int k = i % kMB;
          const int t = i / kMB;
          const int b = t % nb, a = (t / nb) % na, cc = t / (nb * na);
          const int mm = m0 + k;
          wt[i] = mm < s.m
              ? w[static_cast<int64_t>(mm) * taps + ((c0 + cc) * s.ax + a0 + a) * s.ay + b0 + b]
              : 0.f;
        }
        const int rows = kTileX + na - 1, xw = kTileY + nb - 1;
        for (int i = tid; i < nc * rows * xw; i += kCols * kRows) {
          const int j = i % xw;
          const int r = (i / xw) % rows;
          const int cc = i / (xw * rows);
          const int gx = tx0 + a0 + r, gy = ty0 + b0 + j;
          float v = 0.f, q = 0.f;
          if (gx < s.ex && gy < s.ey) {
            const int64_t g =
                ((static_cast<int64_t>(n) * s.c + c0 + cc) * s.ex + gx) * s.ey + gy;
            v = vp[g];
            q = rx[g];
          }
          const int d = (cc * xr + r) * s.pitch + j;
          vs[d] = v;
          rs[d] = q;
        }
        __syncthreads();

        for (int cc = 0; cc < nc; ++cc) {
          for (int a = 0; a < na; ++a) {
            const float* vrow = vs + (cc * xr + row + a) * s.pitch + col;
            const float* rrow = rs + (cc * xr + row + a) * s.pitch + col;
            const float4* wrow = reinterpret_cast<const float4*>(wt + (cc * na + a) * nb * kMB);
            for (int b = 0; b < nb; ++b) {
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

// ------------------------------------------------------ tensor-core route

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNT = 4;  // column tiles (8 ty positions each) per work item

struct MuHMmaShape {
  int n, m, c, ex, ey, tx, ty, ax, ay;
  int tr, tc;      // chunk rows (along tx) and columns (along ty, a multiple of 8)
  int xr, xw, xp;  // staged window rows (tr + ax - 1), width and row pitch (floats)
  int ks;          // k steps of 8 over the flattened (c, ax, ay) taps
  int n_mt;        // row tiles of 16 atoms
  int n_groups;    // work items per chunk row: groups of up to kNT column tiles
  int pair;        // H, pos_extra and out rows take float2 accesses
  int64_t vp_ms;   // Vp's model stride (floats; 0: shared by the models)
  const float* denoms;  // the models' denom_add (the kModels instance)
};

// stage the Vp and Rx windows of chunk q = (n, rx, ry) into buf
// ([2][c][xr][xp]); warps take whole rows, lanes the vectors of a row
template <int kVec>
__device__ __forceinline__ void stage_windows(const float* __restrict__ vp,
                                              const float* __restrict__ rx, float* buf,
                                              int64_t q, const MuHMmaShape& s) {
  const int n_rx = (s.tx + s.tr - 1) / s.tr;
  const int n_ry = (s.ty + s.tc - 1) / s.tc;
  const int ty0 = static_cast<int>(q % n_ry) * s.tc;
  const int tx0 = static_cast<int>((q / n_ry) % n_rx) * s.tr;
  const int64_t n = q / (static_cast<int64_t>(n_ry) * n_rx);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = s.xw / kVec;
  for (int t = 0; t < 2; ++t) {
    const float* x = t ? rx : vp;
    for (int c = 0; c < s.c; ++c) {
      for (int r = warp; r < s.xr; r += kWarps) {
        const bool row_ok = tx0 + r < s.ex;
        const float* src = x + ((n * s.c + c) * s.ex + tx0 + r) * s.ey + ty0;
        float* dst = buf + ((t * s.c + c) * s.xr + r) * s.xp;
        for (int v = lane; v < nv; v += 32) {
          const bool ok = row_ok && ty0 + v * kVec < s.ey;
          copy_async<kVec>(dst + v * kVec, ok ? src + v * kVec : x, ok);
        }
      }
    }
  }
}

// where tap k = (c, ax, ay) starts in a staged window; the padding taps
// past the last one read offset 0 (their A elements are zero)
__device__ __forceinline__ int tap_offset(int k, const MuHMmaShape& s) {
  const int a_sz = s.ax * s.ay;
  if (k >= s.c * a_sz) return 0;
  const int c = k / a_sz, a = k % a_sz;
  return (c * s.xr + a / s.ay) * s.xp + a % s.ay;
}

template <int kVec, int kPasses, bool kModels>
__global__ void __launch_bounds__(kThreads, 2)
mu_h_mma_kernel(const float* __restrict__ vp, const float* __restrict__ rx,
                const float* __restrict__ w, const float* __restrict__ h,
                const float* __restrict__ pos_extra, float denom_add,
                float* __restrict__ out, MuHMmaShape s) {
  if constexpr (kModels) TO_MODEL(s);
  extern __shared__ float4 smem_raw[];
  // the A fragments [n_mt][ks][32 lanes] as big and (3xTF32) small TF32
  // halves, the tap offset table [ks][4 lanes] (taps 8 st + tig and + 4),
  // and window planes of the same layout [2 (Vp, Rx)][c][xr][xp]: raw (the
  // cp.async target) and this chunk's big and (3xTF32) small TF32 halves
  const int frags = s.n_mt * s.ks * 32;
  float4* a_big = smem_raw;
  float4* a_small = a_big + frags;
  int2* offs = reinterpret_cast<int2*>(a_big + (kPasses == 3 ? 2 : 1) * frags);
  float* raw = reinterpret_cast<float*>(offs + 4 * s.ks);
  const int win = s.c * s.xr * s.xp;  // one tensor's window
  const int plane = 2 * win;          // a multiple of 4
  float* big = raw + plane;
  float* small = big + plane;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int taps = s.c * s.ax * s.ay;
  const int n_rx = (s.tx + s.tr - 1) / s.tr;
  const int n_ry = (s.ty + s.tc - 1) / s.tc;
  const int64_t n_chunks = static_cast<int64_t>(s.n) * n_rx * n_ry;

  if (blockIdx.x < n_chunks) stage_windows<kVec>(vp, rx, raw, blockIdx.x, s);
  commit();
  // while the first windows arrive: W split once, in fragment order (lane
  // (g, tig) of k step st holds atoms g and g + 8, taps 8 st + tig and + 4)
  for (int i = threadIdx.x; i < frags; i += kThreads) {
    const int ln = i & 31, st = (i >> 5) % s.ks, mt = (i >> 5) / s.ks;
    float hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int mm = mt * 16 + (ln >> 2) + 8 * (e & 1);
      const int k = 8 * st + (ln & 3) + 4 * (e >> 1);
      const float x = mm < s.m && k < taps ? w[static_cast<int64_t>(mm) * taps + k] : 0.f;
      if constexpr (kPasses == 3) {
        uint32_t b, l;
        split_tf32(x, b, l);
        hi[e] = __uint_as_float(b);
        lo[e] = __uint_as_float(l);
      } else {
        hi[e] = __uint_as_float(to_tf32(x));
      }
    }
    a_big[i] = make_float4(hi[0], hi[1], hi[2], hi[3]);
    if constexpr (kPasses == 3) a_small[i] = make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
  for (int i = threadIdx.x; i < 4 * s.ks; i += kThreads) {
    const int k = 8 * (i >> 2) + (i & 3);
    offs[i] = make_int2(tap_offset(k, s), tap_offset(k + 4, s));
  }

  for (int64_t q = blockIdx.x; q < n_chunks; q += gridDim.x) {
    wait_copies();
    __syncthreads();  // the chunk is in raw, and the last chunk's MMAs are done
    // split once per chunk rather than at every fragment load
    for (int i = 4 * threadIdx.x; i < plane; i += 4 * kThreads) {
      const float4 x = *reinterpret_cast<const float4*>(raw + i);
      if constexpr (kPasses == 3) {
        uint32_t b[4], l[4];
        split_tf32(x.x, b[0], l[0]);
        split_tf32(x.y, b[1], l[1]);
        split_tf32(x.z, b[2], l[2]);
        split_tf32(x.w, b[3], l[3]);
        *reinterpret_cast<float4*>(big + i) = make_float4(
            __uint_as_float(b[0]), __uint_as_float(b[1]), __uint_as_float(b[2]), __uint_as_float(b[3]));
        *reinterpret_cast<float4*>(small + i) = make_float4(
            __uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
      } else {
        *reinterpret_cast<float4*>(big + i) =
            make_float4(__uint_as_float(to_tf32(x.x)), __uint_as_float(to_tf32(x.y)),
                        __uint_as_float(to_tf32(x.z)), __uint_as_float(to_tf32(x.w)));
      }
    }
    __syncthreads();  // raw may be refilled: the next chunk's copies overlap the MMAs
    if (q + gridDim.x < n_chunks) stage_windows<kVec>(vp, rx, raw, q + gridDim.x, s);
    commit();
    const int ty0 = static_cast<int>(q % n_ry) * s.tc;
    const int tx0 = static_cast<int>((q / n_ry) % n_rx) * s.tr;
    const int64_t n = q / (static_cast<int64_t>(n_ry) * n_rx);
    const int n_ct = (min(s.tc, s.ty - ty0) + 7) / 8;  // column tiles holding a position

    for (int item = warp; item < s.tr * s.n_groups; item += kWarps) {
      const int r = item / s.n_groups;
      const int j0 = (item % s.n_groups) * kNT;
      const int nt = min(kNT, n_ct - j0);
      const int gx = tx0 + r;
      if (gx >= s.tx || nt <= 0) continue;
      // B element (k, col g) of column tile j: at offs(k) + 8 j from xb (Vp's
      // big half), + win (Rx), + plane (the small halves)
      const float* xb = big + r * s.xp + 8 * j0 + g;
      for (int mt = 0; mt < s.n_mt; ++mt) {
        float neg[kNT][4], pos[kNT][4];
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) neg[j][e] = pos[j][e] = 0.f;
        const float4* fb = a_big + mt * s.ks * 32 + lane;
        const float4* fs = a_small + mt * s.ks * 32 + lane;
        for (int st = 0; st < s.ks; ++st) {
          const int2 o = offs[4 * st + tig];
          const float4 wb = fb[32 * st];
          const uint32_t ab[4] = {__float_as_uint(wb.x), __float_as_uint(wb.y),
                                  __float_as_uint(wb.z), __float_as_uint(wb.w)};
          uint32_t as[4];
          if constexpr (kPasses == 3) {
            const float4 wl = fs[32 * st];
            as[0] = __float_as_uint(wl.x);
            as[1] = __float_as_uint(wl.y);
            as[2] = __float_as_uint(wl.z);
            as[3] = __float_as_uint(wl.w);
          }
          uint32_t vb[kNT][2], vs[kNT][2], rb[kNT][2], rs[kNT][2];
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            if (j < nt) {
              const float* x0 = xb + o.x + 8 * j;
              const float* x1 = xb + o.y + 8 * j;
              vb[j][0] = __float_as_uint(x0[0]);
              vb[j][1] = __float_as_uint(x1[0]);
              rb[j][0] = __float_as_uint(x0[win]);
              rb[j][1] = __float_as_uint(x1[win]);
              if constexpr (kPasses == 3) {
                vs[j][0] = __float_as_uint(x0[plane]);
                vs[j][1] = __float_as_uint(x1[plane]);
                rs[j][0] = __float_as_uint(x0[plane + win]);
                rs[j][1] = __float_as_uint(x1[plane + win]);
              }
            }
          }
          if constexpr (kPasses == 3) {
            // 3xTF32, the small terms first; the tiles and the two
            // correlations interleave so that independent MMAs are in flight
#pragma unroll
            for (int j = 0; j < kNT; ++j) {
              if (j < nt) {
                mma_tf32(neg[j], as, vb[j][0], vb[j][1]);
                mma_tf32(pos[j], as, rb[j][0], rb[j][1]);
              }
            }
#pragma unroll
            for (int j = 0; j < kNT; ++j) {
              if (j < nt) {
                mma_tf32(neg[j], ab, vs[j][0], vs[j][1]);
                mma_tf32(pos[j], ab, rs[j][0], rs[j][1]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            if (j < nt) {
              mma_tf32(neg[j], ab, vb[j][0], vb[j][1]);
              mma_tf32(pos[j], ab, rb[j][0], rb[j][1]);
            }
          }
        }

        // the ratio from the accumulators: element e of tile j is atom
        // g (+ 8 for e >= 2), position 8 j + 2 tig (+ 1 for odd e)
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int y = ty0 + 8 * (j0 + j) + 2 * tig;
          if (j >= nt || y >= s.ty) continue;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int mm = mt * 16 + g + 8 * hr;
            if (mm >= s.m) continue;
            const int64_t o = ((n * s.m + mm) * s.tx + gx) * s.ty + y;
            const float n0 = neg[j][2 * hr], n1 = neg[j][2 * hr + 1];
            float p0 = pos[j][2 * hr], p1 = pos[j][2 * hr + 1];
            if (s.pair) {  // ty is even, so y + 1 < ty too
              const float2 hv = *reinterpret_cast<const float2*>(h + o);
              if (pos_extra != nullptr) {
                const float2 pe = *reinterpret_cast<const float2*>(pos_extra + o);
                p0 += pe.x;
                p1 += pe.y;
              }
              *reinterpret_cast<float2*>(out + o) =
                  make_float2(hv.x * n0 / (p0 + denom_add), hv.y * n1 / (p1 + denom_add));
            } else {
              if (pos_extra != nullptr) p0 += pos_extra[o];
              out[o] = h[o] * n0 / (p0 + denom_add);
              if (y + 1 < s.ty) {
                if (pos_extra != nullptr) p1 += pos_extra[o + 1];
                out[o + 1] = h[o + 1] * n1 / (p1 + denom_add);
              }
            }
          }
        }
      }
    }
  }
}

template <int kVec, int kPasses, bool kModels>
cudaError_t launch_mma(const float* vp, const float* rx, const float* w, const float* h,
                       const float* pos_extra, float denom_add, float* out,
                       const MuHMmaShape& s, int grid_x, int models, int smem_bytes,
                       cudaStream_t st) {
  auto kernel = mu_h_mma_kernel<kVec, kPasses, kModels>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(grid_x, models), kThreads, smem_bytes, st>>>(vp, rx, w, h, pos_extra,
                                                             denom_add, out, s);
  return cudaGetLastError();
}

template <int kVec, int kPasses>
cudaError_t launch_models(const float* vp, const float* rx, const float* w, const float* h,
                          const float* pos_extra, float denom_add, float* out,
                          const MuHMmaShape& s, int grid_x, int models, int smem_bytes,
                          cudaStream_t st) {
  return s.denoms != nullptr
      ? launch_mma<kVec, kPasses, true>(vp, rx, w, h, pos_extra, denom_add, out, s, grid_x, models, smem_bytes, st)
      : launch_mma<kVec, kPasses, false>(vp, rx, w, h, pos_extra, denom_add, out, s, grid_x, models, smem_bytes, st);
}

}  // namespace

extern "C" int tnmf_mu_h_mma(const float* vp, const float* rx, const float* w,
                             const float* h, const float* pos_extra, float denom_add,
                             float* out, int n, int m, int c, int tx, int ty, int ax, int ay,
                             const int* geometry, int grid_x, int smem_bytes,
                             const float* denoms, int models, int64_t vp_model_stride,
                             void* stream) {
  // geometry: tr, tc, xr, xw, xp, ks, n_mt, n_groups, vec, pair, passes;
  // models: the S stacked models along the grid's y, denoms their
  // denom_add, vp_model_stride Vp's model stride (0: shared); a single
  // problem is null denoms and one model
  if (models < 1 || models > 65535 || (denoms == nullptr && models != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* g = geometry;
  const MuHMmaShape s{n, m, c, tx + ax - 1, ty + ay - 1, tx, ty, ax, ay,
                      g[0], g[1], g[2], g[3], g[4], g[5], g[6], g[7], g[9], vp_model_stride,
                      denoms};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = g[8] == 4;
  cudaError_t err;
  switch (g[10]) {
    case 1:
      err = vec ? launch_models<4, 1>(vp, rx, w, h, pos_extra, denom_add, out, s, grid_x, models, smem_bytes, st)
                : launch_models<1, 1>(vp, rx, w, h, pos_extra, denom_add, out, s, grid_x, models, smem_bytes, st);
      break;
    case 3:
      err = vec ? launch_models<4, 3>(vp, rx, w, h, pos_extra, denom_add, out, s, grid_x, models, smem_bytes, st)
                : launch_models<1, 3>(vp, rx, w, h, pos_extra, denom_add, out, s, grid_x, models, smem_bytes, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int tnmf_mu_h(const float* vp, const float* rx, const float* w,
                         const float* h, const float* pos_extra, float denom_add,
                         float* out, int n, int m, int c, int ex, int ey, int tx, int ty,
                         int ax, int ay, int pitch, int seg_c, int seg_ax, int seg_ay,
                         int smem_bytes, const float* denoms, int models,
                         int64_t vp_model_stride, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (models < 1 || models > 65535 || (denoms == nullptr && models != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const MuHShape s{n, m, c, ex, ey, tx, ty, ax, ay, pitch, seg_c, seg_ax, seg_ay,
                   vp_model_stride, denoms};
  // the tiles of every sample along x (at most 2^31 - 1 blocks), the atom groups along z
  const int64_t blocks = static_cast<int64_t>((tx + kTileX - 1) / kTileX) *
                         ((ty + kTileY - 1) / kTileY) * n;
  if (blocks > 2147483647 || (m + kMB - 1) / kMB > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = denoms != nullptr ? mu_h_kernel<true> : mu_h_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks), models, (m + kMB - 1) / kMB);
  kernel<<<grid, dim3(kCols, kRows), smem_bytes, st>>>(vp, rx, w, h, pos_extra, denom_add,
                                                       out, s);
  return static_cast<int>(cudaGetLastError());
}
