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
// Bound: operations, 2 rows m^2 inner FP32 operations against about 12
// bytes per element of X moved once.  The rows are independent; the
// components are a chain.  A thread per row that runs the chain as m-term
// dot products (the first design) gives the card almost no parallelism, so
// the chain is split as the JAX package's _sweep_H_blocked splits it
// (tnmf_tpu/engine_hals.py:124): the columns go in panels of kPanel, and
//   S[:, J] = P[:, J] - X G[:, J]
// taken with the current X at the start of panel J carries all the
// coupling across panels.  Inside the panel a running correlation carries
// the rest: column j's minimiser reads u = S[r, j] + X[r, j] G[j, j] - l1,
// and its change d = x_new - x_old updates S[r, k] -= d G[j, k] for the
// panel's later columns k.  Each column's minimiser so sees every column
// updated before it in the pass, as in the plain version; only the order
// of the sums differs.
//
// Design.  One block of kThreads threads owns a tile of rt rows (16, 32
// or 64: launch_geometry in kernels/hals.py picks the largest that fits and
// still gives every multiprocessor a block) for all `inner` passes; blocks
// never talk to each other.
//   * The tile of X lives in shared memory for the whole launch (row
//     pitch = m rounded up to kChunk, plus 4), staged once with cp.async and
//     written back once.  Where no tile of 16 rows fits (m beyond about
//     3400) the tile stays in the output in device memory and each chunk
//     of it is read through L1 as the product needs it.
//   * G[:, J] and P[:, J] do not depend on X, so they stream: G's column
//     panel in chunks of kChunk rows through a ring of kStages slots, kStages
//     - 1 chunks ahead across panels and passes, P's panel one panel ahead
//     (two buffers), all by cp.async (16 bytes a copy along a contiguous,
//     aligned row, else 4 bytes; a column-major operand in blocks of 8 rows
//     x 4 columns).  A column-major G (the W side's A^T, kGT) is copied
//     column by column into its slot, with its 16-byte quarters swizzled.
//     G[J, J], which the steps read, is copied from the panel's own chunk.
//     One barrier per chunk.
//   * The panel product is register-tiled: each thread holds tr x 4
//     entries of S (tr = rt / 16 rows, 4 columns), reads X as float4 along
//     k (one address for 8 lanes) and G as float4 (8 lanes on 128 bytes
//     of distinct banks).  Each chunk's 32 terms go to a partial sum that
//     is then added to the running one (blocked summation: the rounding
//     grows with kChunk + m / kChunk, not m).  P's panel is staged into
//     S's buffer and the product is subtracted from it.
//   * Inside the panel each of the rt first threads takes one row: it holds
//     the row's kPanel entries of S and of X in registers and runs the
//     panel's kPanel steps on them, reading G[J, J] from shared memory (one
//     address for the warp).  A step's chain is one division and one FMA,
//     with no branch; there is no shuffle, no block barrier and no
//     redundant division inside a panel (a lane per column, with the change
//     broadcast by shuffles, would divide on all 32 lanes at every step).
//   * FP32 FMAs on the CUDA cores in a fixed order and no atomics, so two
//     launches give the same bits, whatever the operands' layout; the
//     division is IEEE (no fast-math).
//   * Operands through strides: X, G, P and the output are read and written
//     with a row and a column stride (int64), so the H side's row-major H,
//     the W side's transposed views W^T, A^T, B^T and the phase rows launch
//     with no copy, and the output takes X's layout.
// Any m and any row count run: the last panel and the last chunk may be
// partial (zero-filled), the last tile may have fewer rows.
//
// The model axis (a sweep's S models, tnmf_hals_sweep_models): model
// blockIdx.y reads its X, G and P and writes its output at their own model
// strides (0 for an operand the models share), and its l1 and l2 from
// per-model vectors.  Each model keeps the single launch's geometry and sum
// order, so its bits are those of its own single launch.  The model offsets
// are in the kModels instances: a single launch runs instances with no
// model-axis code.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;                      // four warps
constexpr int kPanel = 32;                         // columns of a panel
constexpr int kChunk = 32;                         // rows of G[:, J] per streamed chunk
constexpr int kStages = 4;                         // chunks of G[:, J] in flight or in use
constexpr int kColGroups = kPanel / 4;             // product threads per tile row: 4 columns each
constexpr int kRowGroups = kThreads / kColGroups;  // 16
// pitches = 4 (mod 32): float4 reads of 8 consecutive rows, and the 8 x 4
// blocks in which a column-major operand is staged, fall on distinct banks
constexpr int kSPitch = kPanel + 4;                // S's panel, rt x kSPitch
constexpr int kGPitch = kPanel + 4;                // a chunk of G[:, J] and G[J, J]
constexpr int kCPitch = kChunk + 4;                // a streamed chunk of X, rt x kCPitch
// G[J, J] is the panel's own chunk, and a column's 8 quarters swizzle by
// the 8 column groups
static_assert(kChunk == kPanel && kChunk / 4 == kColGroups, "K5's tiling");

struct Operand {
  const float* p;
  int64_t sr, sc;  // row and column strides, elements
};

// the model axis of a kModels instance: each operand's model stride
// (elements; 0 where the models share it) and the models' l1 and l2
struct Models {
  int64_t x, g, p, out;
  const float* l1;
  const float* l2;
};

__device__ __forceinline__ void copy_async4(float* dst, const float* src, bool valid) {
  // src-size 0 zero-fills the destination without reading
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src),
                  "r"(valid ? 4 : 0));
}

// 16 bytes, of which the first `bytes` are read and the rest zero-filled
__device__ __forceinline__ void copy_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src),
                  "r"(bytes));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// Element i of an R x C tile (R a multiple of 8, C of 4) in the order the
// threads walk it: along the rows of a row-major operand, and in blocks of
// 8 rows x 4 columns down a column-major one (down_rows), so that a warp
// reads 32-byte sectors whole and writes a pitch = 4 (mod 32) buffer
// without bank conflicts.
__device__ __forceinline__ void tile_coords(int i, int R, int C, bool down_rows, int& r,
                                            int& c) {
  if (down_rows) {
    const int b = i >> 5, w = i & 31, rb = R >> 3;
    r = b % rb * 8 + (w & 7);
    c = b / rb * 4 + (w >> 3);
  } else {
    r = i / C;
    c = i % C;
  }
}

// dst[r * pitch + c] = src[r, c] for r < nr and c < nc, 0 elsewhere in the
// R x C tile, by cp.async: 16 bytes a copy where the source's rows are
// contiguous and 16-byte aligned (pitch a multiple of 4), else 4 bytes a
// copy, walked as tile_coords walks it.
__device__ __forceinline__ void load_tile(float* dst, int pitch, const float* src, int64_t sr,
                                          int64_t sc, int nr, int nc, int R, int C) {
  if (sc == 1 && sr % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = threadIdx.x; i < R * C / 4; i += kThreads) {
      const int r = i / (C / 4), c = i % (C / 4) * 4;
      const int n = r < nr ? (nc - c < 0 ? 0 : nc - c < 4 ? nc - c : 4) : 0;
      copy_async16(dst + r * pitch + c, n > 0 ? src + r * sr + c : src, 4 * n);
    }
    return;
  }
  const bool down_rows = sc != 1 && sr == 1;
  for (int i = threadIdx.x; i < R * C; i += kThreads) {
    int r, c;
    tile_coords(i, R, C, down_rows, r, c);
    const bool valid = r < nr && c < nc;
    copy_async4(dst + r * pitch + c, valid ? src + r * sr + c * sc : src, valid);
  }
}

template <int kTR, bool kResident, bool kGT, bool kModels>
__global__ void __launch_bounds__(kThreads)
hals_sweep_kernel(Operand x, Operand g, Operand p, float* out, int64_t osr, int64_t osc,
                  float l1, float l2, int inner, int64_t rows, int m, Models models) {
  if constexpr (kModels) {  // model blockIdx.y's operands and strengths
    const int64_t y = blockIdx.y;
    x.p += y * models.x;
    g.p += y * models.g;
    p.p += y * models.p;
    out += y * models.out;
    l1 = models.l1[y];
    l2 = models.l2[y];
  }
  constexpr int kRT = kRowGroups * kTR;  // rows of the tile
  extern __shared__ __align__(16) float smem[];
  const int mc = (m + kChunk - 1) / kChunk * kChunk;  // m in whole chunks
  const int xpitch = mc + 4;
  float* xs = smem;  // the tile (rt x xpitch), or one streamed chunk of it (rt x kCPitch)
  float* ss = xs + (kResident ? kRT * xpitch : kRT * kCPitch);  // two panels of S
  float* gs = ss + 2 * kRT * kSPitch;                           // kStages chunks of G[:, J]
  float* gd = gs + kStages * kChunk * kGPitch;                  // two blocks G[J, J]
  // a chunk's slot holds G[k0 + k, j0 + c] at gs[k * kGPitch + c], or, for a
  // column-major G (kGT), at gs[c * kChunk + 4 (k / 4 ^ c / 4) + k % 4]: its
  // columns copied whole, their 16-byte quarters swizzled so that the
  // product's float4 reads of 8 columns fall on distinct banks

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRT;
  const int nr = static_cast<int>(rows - r0 < kRT ? rows - r0 : kRT);
  const float* xg = x.p + r0 * x.sr;
  const float* pg = p.p + r0 * p.sr;
  float* og = out + r0 * osr;
  const bool out_down_rows = osc != 1 && osr == 1;

  const int nq = mc / kChunk;                            // chunks per panel
  const int npan = (m + kPanel - 1) / kPanel;            // panels per pass
  const int panels = inner * npan, chunks = panels * nq;  // over all passes
  // G[:, J] and P's panels do not depend on X: they stream ahead, kStages - 1
  // chunks ahead for G, one panel ahead for P (a double buffer); G[J, J] is
  // copied from the panel's own chunk of G[:, J] (kChunk = kPanel)
  auto issue_chunk = [&](int s) {
    const int k0 = s % nq * kChunk, j0 = s / nq % npan * kPanel;
    const int nk = m - k0 < kChunk ? m - k0 : kChunk, nb = m - j0 < kPanel ? m - j0 : kPanel;
    float* dst = gs + s % kStages * kChunk * kGPitch;
    const float* src = g.p + k0 * g.sr + j0 * g.sc;
    if constexpr (kGT) {  // column c of the chunk: nk contiguous floats at src + c g.sc
      const bool wide = g.sc % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
      for (int i = threadIdx.x; i < kPanel * kChunk / 4; i += kThreads) {
        const int c = i >> 3, kq = i & 7;
        float* d = dst + c * kChunk + 4 * (kq ^ (c >> 2));
        const float* from = src + c * g.sc + 4 * kq;
        const int n = c < nb ? (nk - 4 * kq < 0 ? 0 : nk - 4 * kq < 4 ? nk - 4 * kq : 4) : 0;
        if (wide) {
          copy_async16(d, n > 0 ? from : src, 4 * n);
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t) copy_async4(d + t, t < n ? from + t : src, t < n);
        }
      }
    } else {
      load_tile(dst, kGPitch, src, g.sr, g.sc, nk, nb, kChunk, kPanel);
    }
  };
  auto issue_panel = [&](int pi) {
    const int j0 = pi % npan * kPanel, nb = m - j0 < kPanel ? m - j0 : kPanel;
    load_tile(ss + (pi & 1) * kRT * kSPitch, kSPitch, pg + j0 * p.sc, p.sr, p.sc, nr, nb, kRT,
              kPanel);
  };

  // prologue: the tile (resident), the first panel's P and the first
  // kStages - 1 chunks, one commit group each
  if constexpr (kResident) {
    load_tile(xs, xpitch, xg, x.sr, x.sc, nr, m, kRT, mc);
  } else {  // the tile lives in the output; plain loads and stores keep it coherent
    for (int64_t i = threadIdx.x; i < static_cast<int64_t>(nr) * m; i += kThreads) {
      const int64_t r = out_down_rows ? i % nr : i / m;
      const int64_t c = out_down_rows ? i / nr : i % m;
      og[r * osr + c * osc] = xg[r * x.sr + c * x.sc];
    }
  }
  issue_panel(0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) issue_chunk(s);
    commit();
  }

  const int lane = threadIdx.x & 31;
  const int cg = lane & 7;                                // columns 4 cg .. 4 cg + 3
  const int rg = (threadIdx.x >> 5) * 4 + (lane >> 3);    // rows kTR rg .. kTR rg + kTR - 1

  for (int pi = 0; pi < panels; ++pi) {
    const int j0 = pi % npan * kPanel;
    const int nb = m - j0 < kPanel ? m - j0 : kPanel;
    float* sp = ss + (pi & 1) * kRT * kSPitch;
    const float* gdp = gd + (pi & 1) * kPanel * kGPitch;
    float acc[kTR][4];
#pragma unroll
    for (int i = 0; i < kTR; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int q = 0; q < nq; ++q) {
      const int s = pi * nq + q;
      wait_groups<kStages - 2>();  // chunk s has landed (this thread's copies)
      __syncthreads();             // everyone's copies; the last panel's steps are done
      if (s + kStages - 1 < chunks) issue_chunk(s + kStages - 1);  // into chunk s - 1's slot
      if (q == 0 && pi + 1 < panels) issue_panel(pi + 1);   // into panel pi - 1's buffers
      commit();
      const float* xq;
      int xp;
      if constexpr (kResident) {
        xq = xs + kTR * rg * xpitch + q * kChunk;
        xp = xpitch;
      } else {  // the chunk of X as the last panel's steps left it
        const int k0 = q * kChunk, nk = m - k0 < kChunk ? m - k0 : kChunk;
        for (int i = threadIdx.x; i < kRT * kChunk; i += kThreads) {
          int r, c;
          tile_coords(i, kRT, kChunk, out_down_rows, r, c);
          xs[r * kCPitch + c] = r < nr && c < nk ? og[r * osr + (k0 + c) * osc] : 0.f;
        }
        __syncthreads();
        xq = xs + kTR * rg * kCPitch;
        xp = kCPitch;
      }
      const float* gq = gs + s % kStages * kChunk * kGPitch;
      if (q == pi % npan) {  // the panel's own chunk: G[J, J], row-major, for its steps
        float* gdp_w = gd + (pi & 1) * kPanel * kGPitch;
        if constexpr (kGT) {
          for (int i = threadIdx.x; i < kPanel * kPanel; i += kThreads) {
            const int j = i >> 5, k = i & 31;
            gdp_w[j * kGPitch + k] = gq[k * kChunk + 4 * ((j >> 2) ^ (k >> 2)) + (j & 3)];
          }
        } else {
          for (int i = threadIdx.x; i < kPanel * kPanel / 4; i += kThreads) {
            const int j = i >> 3, k = (i & 7) * 4;
            *reinterpret_cast<float4*>(gdp_w + j * kGPitch + k) =
                *reinterpret_cast<const float4*>(gq + j * kGPitch + k);
          }
        }
      }
      // a chunk's partial sums, then the running sum: blocked summation,
      // its rounding error grows with kChunk + m / kChunk, not with m
      float part[kTR][4];
#pragma unroll
      for (int i = 0; i < kTR; ++i) part[i][0] = part[i][1] = part[i][2] = part[i][3] = 0.f;
#pragma unroll
      for (int k = 0; k < kChunk; k += 4) {
        float4 xv[kTR], gv[4];
#pragma unroll
        for (int i = 0; i < kTR; ++i) xv[i] = *reinterpret_cast<const float4*>(xq + i * xp + k);
        float gk[4][4];  // G[k + t, 4 cg + e] at gk[t][e]
        if constexpr (kGT) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            gv[e] = *reinterpret_cast<const float4*>(gq + (4 * cg + e) * kChunk +
                                                     4 * ((k >> 2) ^ cg));
            gk[0][e] = gv[e].x;
            gk[1][e] = gv[e].y;
            gk[2][e] = gv[e].z;
            gk[3][e] = gv[e].w;
          }
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            gv[t] = *reinterpret_cast<const float4*>(gq + (k + t) * kGPitch + 4 * cg);
            gk[t][0] = gv[t].x;
            gk[t][1] = gv[t].y;
            gk[t][2] = gv[t].z;
            gk[t][3] = gv[t].w;
          }
        }
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          const float xk[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {  // k + t in order
#pragma unroll
            for (int e = 0; e < 4; ++e) part[i][e] = fmaf(xk[t], gk[t][e], part[i][e]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] += part[i][c];
      }
    }
    // P's panel was issued 2 nq - 1 commit groups ago; with fewer than
    // kStages - 1 the waits above have not covered it
    if (2 * nq - 1 < kStages - 1) {
      wait_groups<0>();
      __syncthreads();
    }
    // S = P - X G[:, J]
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      float4* s = reinterpret_cast<float4*>(sp + (kTR * rg + i) * kSPitch + 4 * cg);
      float4 v = *s;
      v.x -= acc[i][0];
      v.y -= acc[i][1];
      v.z -= acc[i][2];
      v.w -= acc[i][3];
      *s = v;
    }
    __syncthreads();

    // the panel's steps, one row per thread (the next chunk's barrier
    // orders them before anything reads X or reuses the buffers)
    if (threadIdx.x < nr) {
      const int r = threadIdx.x;
      float s[kPanel], xr[kPanel];
#pragma unroll
      for (int q = 0; q < kPanel / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(sp + r * kSPitch)[q];
        s[4 * q] = v.x;
        s[4 * q + 1] = v.y;
        s[4 * q + 2] = v.z;
        s[4 * q + 3] = v.w;
      }
      if constexpr (kResident) {  // the pad columns past m are zeros
#pragma unroll
        for (int q = 0; q < kPanel / 4; ++q) {
          const float4 v = reinterpret_cast<const float4*>(xs + r * xpitch + j0)[q];
          xr[4 * q] = v.x;
          xr[4 * q + 1] = v.y;
          xr[4 * q + 2] = v.z;
          xr[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kPanel; ++j) xr[j] = j < nb ? og[r * osr + (j0 + j) * osc] : 0.f;
      }
      // no branch: past the panel's last column, or at a dead component
      // (the column keeps its values), the step's change is 0 and leaves S
      // as it was
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        const float gjj = gdp[j * kGPitch + j];
        const float denom = gjj + l2;
        const float u = fmaf(xr[j], gjj, s[j]) - l1;
        const float step = fmaxf(u / fmaxf(denom, FLT_MIN), 0.f);
        const float xn = j < nb && denom > 0.f ? step : xr[j];
        const float d = xn - xr[j];
        xr[j] = xn;
        const float4* grow = reinterpret_cast<const float4*>(gdp + j * kGPitch);
#pragma unroll
        for (int q = (j + 1) / 4; q < kPanel / 4; ++q) {
          const float4 v = grow[q];
          const float gk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (4 * q + e > j) s[4 * q + e] = fmaf(-d, gk[e], s[4 * q + e]);
          }
        }
      }
      if constexpr (kResident) {
#pragma unroll
        for (int q = 0; q < kPanel / 4; ++q) {
          reinterpret_cast<float4*>(xs + r * xpitch + j0)[q] =
              make_float4(xr[4 * q], xr[4 * q + 1], xr[4 * q + 2], xr[4 * q + 3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kPanel; ++j) {
          if (j < nb) og[r * osr + (j0 + j) * osc] = xr[j];
        }
      }
    }
  }
  __syncthreads();

  if constexpr (kResident) {  // the tile back, once
    if (osc == 1 && osr % 4 == 0 && (reinterpret_cast<uintptr_t>(og) & 15) == 0) {
      for (int i = threadIdx.x; i < kRT * mc / 4; i += kThreads) {
        const int r = i / (mc / 4), c = i % (mc / 4) * 4;
        if (r >= nr || c >= m) continue;
        const float4 v = *reinterpret_cast<const float4*>(xs + r * xpitch + c);
        if (c + 4 <= m) {
          *reinterpret_cast<float4*>(og + r * osr + c) = v;
        } else {  // the row's last 1-3 columns
          og[r * osr + c] = v.x;
          if (c + 1 < m) og[r * osr + c + 1] = v.y;
          if (c + 2 < m) og[r * osr + c + 2] = v.z;
        }
      }
    } else {
      for (int i = threadIdx.x; i < kRT * mc; i += kThreads) {
        int r, c;
        tile_coords(i, kRT, mc, out_down_rows, r, c);
        if (r < nr && c < m) og[r * osr + c * osc] = xs[r * xpitch + c];
      }
    }
  }
}

// shared memory of a launch, bytes (kernels/hals.py: smem_bytes)
int64_t required_smem(int rt, int m, bool resident) {
  const int64_t mc = (static_cast<int64_t>(m) + kChunk - 1) / kChunk * kChunk;
  const int64_t xs = resident ? rt * (mc + 4) : rt * kCPitch;
  return 4 * (xs + 2 * rt * kSPitch + (kStages * kChunk + 2 * kPanel) * kGPitch);
}

template <int kTR, bool kResident, bool kGT, bool kModels>
cudaError_t launch(const Operand& x, const Operand& g, const Operand& p, float* out,
                   int64_t osr, int64_t osc, float l1, float l2, int inner, int64_t rows, int m,
                   const Models& models, unsigned n_models, unsigned blocks, int smem_bytes,
                   cudaStream_t stream) {
  auto kernel = hals_sweep_kernel<kTR, kResident, kGT, kModels>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(blocks, n_models), kThreads, smem_bytes, stream>>>(x, g, p, out, osr, osc, l1,
                                                                   l2, inner, rows, m, models);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const Operand&, const Operand&, const Operand&, float*, int64_t,
                               int64_t, float, float, int, int64_t, int, const Models&,
                               unsigned, unsigned, int, cudaStream_t);

// the instance of a geometry: rows_per_block 16, 32 or 64, the tile
// resident or streamed, G column-major (kGT: its chunks are copied column by
// column) or not
template <bool kModels>
Launch pick(int rows_per_block, bool resident, bool gt) {
  const Launch table[3][2][2] = {
      {{&launch<1, false, false, kModels>, &launch<1, false, true, kModels>},
       {&launch<1, true, false, kModels>, &launch<1, true, true, kModels>}},
      {{&launch<2, false, false, kModels>, &launch<2, false, true, kModels>},
       {&launch<2, true, false, kModels>, &launch<2, true, true, kModels>}},
      {{&launch<4, false, false, kModels>, &launch<4, false, true, kModels>},
       {&launch<4, true, false, kModels>, &launch<4, true, true, kModels>}}};
  return table[rows_per_block / 32][resident][gt];
}

// the checks both entries make: 0 when the geometry may launch
int check_geometry(int64_t rows, int m, int rows_per_block, int resident, int smem_bytes,
                   int64_t& blocks) {
  if (rows_per_block != 16 && rows_per_block != 32 && rows_per_block != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > INT_MAX || smem_bytes < required_smem(rows_per_block, m, resident != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// x, g, p, out: (rows, m), (m, m), (rows, m), (rows, m) float32 with row and
// column strides in elements (out must not overlap the others);
// rows_per_block 16, 32 or 64; resident: the tile stays in shared memory;
// smem_bytes at least what that geometry needs.
extern "C" int tnmf_hals_sweep(const float* x, int64_t x_sr, int64_t x_sc, const float* g,
                               int64_t g_sr, int64_t g_sc, const float* p, int64_t p_sr,
                               int64_t p_sc, float* out, int64_t o_sr, int64_t o_sc, float l1,
                               float l2, int inner, int64_t rows, int m, int rows_per_block,
                               int resident, int smem_bytes, void* stream) {
  if (rows <= 0 || m <= 0) return 0;
  int64_t blocks;
  if (const int err = check_geometry(rows, m, rows_per_block, resident, smem_bytes, blocks))
    return err;
  const Operand xo{x, x_sr, x_sc}, go{g, g_sr, g_sc}, po{p, p_sr, p_sc};
  const Launch fn = pick<false>(rows_per_block, resident != 0, g_sc != 1 && g_sr == 1);
  return static_cast<int>(fn(xo, go, po, out, o_sr, o_sc, l1, l2, inner, rows, m, Models{}, 1,
                             static_cast<unsigned>(blocks), smem_bytes,
                             static_cast<cudaStream_t>(stream)));
}

// The model axis: `models` problems of tnmf_hals_sweep's shapes in one
// launch, model s at x + s x_ms, g + s g_ms, p + s p_ms and out + s o_ms
// (a model stride of 0 shares the operand; out's must not), with l1[s] and
// l2[s] from device vectors; each model on the geometry given, the single
// launch's of (rows, m).  G is column-major (kGT) when model 0's is.
extern "C" int tnmf_hals_sweep_models(
    const float* x, int64_t x_ms, int64_t x_sr, int64_t x_sc, const float* g, int64_t g_ms,
    int64_t g_sr, int64_t g_sc, const float* p, int64_t p_ms, int64_t p_sr, int64_t p_sc,
    float* out, int64_t o_ms, int64_t o_sr, int64_t o_sc, const float* l1, const float* l2,
    int models, int inner, int64_t rows, int m, int rows_per_block, int resident,
    int smem_bytes, void* stream) {
  if (models < 1 || models > 65535 || l1 == nullptr || l2 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || m <= 0) return 0;
  int64_t blocks;
  if (const int err = check_geometry(rows, m, rows_per_block, resident, smem_bytes, blocks))
    return err;
  const Operand xo{x, x_sr, x_sc}, go{g, g_sr, g_sc}, po{p, p_sr, p_sc};
  const Models mo{x_ms, g_ms, p_ms, o_ms, l1, l2};
  const Launch fn = pick<true>(rows_per_block, resident != 0, g_sc != 1 && g_sr == 1);
  return static_cast<int>(fn(xo, go, po, out, o_sr, o_sc, 0.f, 0.f, inner, rows, m, mo,
                             static_cast<unsigned>(models), static_cast<unsigned>(blocks),
                             smem_bytes, static_cast<cudaStream_t>(stream)));
}
