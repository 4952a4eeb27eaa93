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
// 64 x 1 x 256 x 256 with 16 atoms of 9 x 9) into a tiny output (2,592
// values): 23 GFLOP against 0.33 GB of reads.  It is a GEMM, so the tensor
// cores bound it: with three TF32 products per product (below) 69 GFLOP at
// 495 TFLOP/s, 0.14 ms, against 0.10 ms of HBM time; in one TF32 pass
// (kPasses = 1, the TF32 precision levels) 23 GFLOP, 0.05 ms, so the bytes
// bound it there.  The FP32 FMA kernel of
// the first port was bound by shared-memory bank conflicts instead (its
// 64-float X row pitch put a warp's loads in three banks).  Here the
// fragment loads from shared memory take most of the time: mma.sync needs
// its operands in registers, and the B operand (a sliding window of X2) is
// loaded per k step.
//
// Design: an implicit GEMM on mma.sync.m16n8k8 TF32.  Rows are the atoms
// (16 per row tile; rows past the last atom read the last atom's H and
// their sums are dropped); columns are the (c2, ax, ay) offsets flattened
// over all channels and padded to a multiple of 8 (162 -> 168 at the
// flagship); the contraction runs along ty within one tx row of one sample.
// The B fragment is a sliding window of the staged X2 row: element
// (k, (c2, ax, ay)) is Xs[c2][r + ax][k + ay], one shared load per value at
// a per-column offset fixed for the whole kernel.
//
// Accuracy (3xTF32): each operand x is split into big = tf32_rna(x) and
// small = tf32_rna(x - big), so x = big + small + e with |e| <= 2^-22 |x|.
// The product is accumulated as small*big + big*small + big*big; the dropped
// small*small and the two rounding errors are each at most 2^-22 of |a*b|, so
// every product is within about 3 * 2^-22 = 7e-7 of exact, near float32's own
// 6e-8.  Every term is accumulated in float32.  One pass (kPasses = 1) rounds
// each operand once (cvt.rna, within 2^-11) and makes the big*big product
// alone: no small plane is staged, split or loaded, so the split layout holds
// two planes (raw and big) where 3xTF32 holds three, and chunks can be larger.  The tensor cores' float32
// accumulation loses low bits over long sums, so the MMA sums restart from
// zero for each tx row (at most 3 * Tc / 8 = 33 accumulations) and are added
// to a float32 register total with round-to-nearest; the cross-block pass
// sums in float64.  Inputs here are non-negative, so there is no
// cancellation and the result is within a few 1e-6 of float64 relative to
// its largest value.
//
// Staging: a persistent grid walks chunks of (n, Tr rows of tx, Tc columns of
// ty).  cp.async copies (16 bytes when the rows allow it, zero-filled outside
// the arrays) bring the chunk's H tile ([Tr][rows][Hp]: the atoms of the
// block's own row tiles, so that shared memory does not grow with M; a row
// pitch of 4 mod 8 floats keeps the A loads free of bank conflicts) and X2
// window ([C2][Tr+Ax-1][Xp], Xp picked by the wrapper for the fewest B-load
// conflicts) into a raw buffer.  In the split layout all threads then split
// it once into big and small planes, and the next chunk's copies into the
// raw buffer overlap this chunk's MMAs.  A chunk whose three planes no block
// can hold (large atoms or many channels) takes the compact layout: the raw
// buffer alone, split as the fragments load, the next chunk copied after
// this one's MMAs, the tightest pitches, and when ty < 8 a narrow chunk of
// ty columns whose missing k columns read column 0 with A zeroed.  Each
// warp owns one work item: a row tile and kNT column tiles, with kNT * 4
// accumulators; when there are fewer than 8 items the spare warps split the
// ty steps.  Within a row the fragment loads of one k step overlap the MMAs
// of the other (a two-step software pipeline).  Chunk indices are
// decomposed once per chunk and staging loops hold no division.  Each warp
// writes its partial sums to its own scratch slot; pass 2 adds the slots in
// a fixed order, so two launches give identical bits and no float atomics
// are used.
//
// Groups: every output G[m, c2, ax, ay] is independent of the other channels
// and offsets, so a problem whose chunk no block can hold is launched as
// groups of channels (then of atom rows, then of atom columns) that fit.  A
// group reads X2 in place, from its first channel and offset on, with X2's
// own strides, and the reduction pass writes its block of the output; a
// problem that fits runs as one group, the whole of X2.
//
// The model axis: a sweep of S models is one launch with gridDim.z = S.
// Model z reads its own X2 and H (the S stacks are contiguous, (S, N, C2,
// Ex, Ey) and (S, N, M, Tx, Ty)), its blocks walk its own chunks on the
// single model's grid and write their own scratch slots, and the reduction
// pass (gridDim.y = S) writes out[half][z]: (2, S, M, C, Ax, Ay), so each
// half is a contiguous (S, M, C, Ax, Ay) stack.  Every model is summed in
// the order of its own single launch, so it gets that launch's bits.  The
// model offsets are in the kModels instances of both passes: a single
// launch runs instances with no model-axis code, which keep a single
// model's registers and schedule.
//
// The chunk sizes, pitches, layout, work split, grid, shared memory and
// groups come from the wrapper (tnmf_tpu_torch/kernels/gw.py, _geometry), which must use
// the same tile sizes, thread count and shared layout as here.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct GradWShape {
  int n, m, c2, ex, ey, tx, ty, ax, ay;  // this group's channels, window and offsets
  int tr, tc;           // chunk rows (along tx) and columns (along ty, multiple of 8)
  int hp, hw;           // H row pitch and staged width (hw = tc, or ty < 8 when narrow)
  int xw, xp;           // staged X2 width and X2 row pitch (floats)
  int n_ct;             // column tiles of 8 over the flattened (c2, ax, ay)
  int n_groups;         // column-tile groups of kNT
  int n_items, ipb;     // work items (row tile, group) and items per block
  int ksplit;           // warps per item (ty-step split)
  int m_rows;           // H rows (atoms) a block stages: those of its row tiles
  int x_c2, x_ex, x_ey; // X2's own channels and extents (its strides)
  int c_off, a_off, b_off, x_ax, x_ay;  // where the group starts; the atoms' shape
  int models;           // the model axis (gridDim.z of the partial pass)
};

// stage chunk q = (n, rx, ry) of H and X2 into buf; warps take whole rows,
// lanes the vectors of a row
template <int kVec>
__device__ __forceinline__ void stage(const float* __restrict__ x2,
                                      const float* __restrict__ h, float* buf,
                                      int64_t q, int m_lo, int m_hi, const GradWShape& s) {
  const int n_rx = (s.tx + s.tr - 1) / s.tr;
  const int n_ry = (s.ty + s.tc - 1) / s.tc;
  const int ry = static_cast<int>(q % n_ry);
  const int rx = static_cast<int>((q / n_ry) % n_rx);
  const int n = static_cast<int>(q / (static_cast<int64_t>(n_ry) * n_rx));
  const int tx0 = rx * s.tr, ty0 = ry * s.tc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int xr = s.tr + s.ax - 1;

  float* hs = buf;  // [tr][m_rows][hp]: the atoms m_lo .. m_hi - 1
  const int hv = s.hw / kVec;
  for (int r = 0; r < s.tr; ++r) {
    const bool row_ok = tx0 + r < s.tx;
    for (int mm = m_lo + warp; mm < m_hi; mm += kWarps) {
      const float* src = h + ((static_cast<int64_t>(n) * s.m + mm) * s.tx + tx0 + r) * s.ty + ty0;
      float* dst = hs + (r * s.m_rows + mm - m_lo) * s.hp;
      for (int v = lane; v < hv; v += 32) {
        const bool ok = row_ok && ty0 + v * kVec < s.ty;
        copy_async<kVec>(dst + v * kVec, ok ? src + v * kVec : h, ok);
      }
    }
  }
  float* xs = buf + s.tr * s.m_rows * s.hp;  // [c2][xr][xp]
  const int xv = s.xw / kVec;
  for (int c = 0; c < s.c2; ++c) {
    for (int r = warp; r < xr; r += kWarps) {
      const bool row_ok = tx0 + r < s.ex;
      const float* src =
          x2 + ((static_cast<int64_t>(n) * s.x_c2 + c) * s.x_ex + tx0 + r) * s.x_ey + ty0;
      float* dst = xs + (c * xr + r) * s.xp;
      for (int v = lane; v < xv; v += 32) {
        const bool ok = row_ok && ty0 + v * kVec < s.ey;
        copy_async<kVec>(dst + v * kVec, ok ? src + v * kVec : x2, ok);
      }
    }
  }
}

// x as big + small TF32 halves, four at a time
__device__ __forceinline__ void split4(const float4 x, float4& big, float4& small) {
  uint32_t b, l;
  split_tf32(x.x, b, l); big.x = __uint_as_float(b); small.x = __uint_as_float(l);
  split_tf32(x.y, b, l); big.y = __uint_as_float(b); small.y = __uint_as_float(l);
  split_tf32(x.z, b, l); big.z = __uint_as_float(b); small.z = __uint_as_float(l);
  split_tf32(x.w, b, l); big.w = __uint_as_float(b); small.w = __uint_as_float(l);
}

// one warp's operands for one k step of 8: the A fragment and kNT B
// fragments, each as big and small TF32 halves (big alone in one pass)
template <int kNT>
struct Frags {
  uint32_t ab[4], as[4];
  uint32_t bb[kNT][2], bs[kNT][2];
};

// the fragments of the k step at offset off from the A offset a (rows g and
// g + 8 are hb apart) and the B offsets b
template <int kNT, int kPasses>
__device__ __forceinline__ void load_frags(const float* __restrict__ big,
                                           const float* __restrict__ small, int a, int hb,
                                           const int (&b)[kNT], int off, Frags<kNT>& f) {
  a += off;
  f.ab[0] = __float_as_uint(big[a]);
  f.ab[1] = __float_as_uint(big[a + hb]);
  f.ab[2] = __float_as_uint(big[a + 4]);
  f.ab[3] = __float_as_uint(big[a + hb + 4]);
  if constexpr (kPasses == 3) {
    f.as[0] = __float_as_uint(small[a]);
    f.as[1] = __float_as_uint(small[a + hb]);
    f.as[2] = __float_as_uint(small[a + 4]);
    f.as[3] = __float_as_uint(small[a + hb + 4]);
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    f.bb[j][0] = __float_as_uint(big[b[j] + off]);
    f.bb[j][1] = __float_as_uint(big[b[j] + off + 4]);
    if constexpr (kPasses == 3) {
      f.bs[j][0] = __float_as_uint(small[b[j] + off]);
      f.bs[j][1] = __float_as_uint(small[b[j] + off + 4]);
    }
  }
}

// the same from the one raw plane of the compact layout, split as they load;
// the lane's k columns are c0 and c1 (its own, or column 0 past the valid
// width of a narrow chunk, where ok0 / ok1 zero A so that B needs no mask)
template <int kNT, int kPasses>
__device__ __forceinline__ void load_frags_raw(const float* __restrict__ raw, int a, int hb,
                                               const int (&b)[kNT], int off, int c0, int c1,
                                               bool ok0, bool ok1, Frags<kNT>& f) {
  a += off;
  if constexpr (kPasses == 3) {
    split_tf32(ok0 ? raw[a + c0] : 0.f, f.ab[0], f.as[0]);
    split_tf32(ok0 ? raw[a + hb + c0] : 0.f, f.ab[1], f.as[1]);
    split_tf32(ok1 ? raw[a + c1] : 0.f, f.ab[2], f.as[2]);
    split_tf32(ok1 ? raw[a + hb + c1] : 0.f, f.ab[3], f.as[3]);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      split_tf32(raw[b[j] + off + c0], f.bb[j][0], f.bs[j][0]);
      split_tf32(raw[b[j] + off + c1], f.bb[j][1], f.bs[j][1]);
    }
  } else {
    f.ab[0] = to_tf32(ok0 ? raw[a + c0] : 0.f);
    f.ab[1] = to_tf32(ok0 ? raw[a + hb + c0] : 0.f);
    f.ab[2] = to_tf32(ok1 ? raw[a + c1] : 0.f);
    f.ab[3] = to_tf32(ok1 ? raw[a + hb + c1] : 0.f);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      f.bb[j][0] = to_tf32(raw[b[j] + off + c0]);
      f.bb[j][1] = to_tf32(raw[b[j] + off + c1]);
    }
  }
}

// 3xTF32: the small terms first, the big product last; the tiles
// interleave so that kNT independent MMAs are in flight.  One pass: the big
// product alone
template <int kNT, int kPasses>
__device__ __forceinline__ void mma_step(float (&d)[kNT][4], const Frags<kNT>& f) {
  if constexpr (kPasses == 3) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma_tf32(d[j], f.as, f.bb[j][0], f.bb[j][1]);
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma_tf32(d[j], f.ab, f.bs[j][0], f.bs[j][1]);
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) mma_tf32(d[j], f.ab, f.bb[j][0], f.bb[j][1]);
}

template <int kNT, int kVec, bool kSplit, int kPasses, bool kModels>
__global__ void __launch_bounds__(kThreads, 2)
grad_w_partial(const float* __restrict__ x2, const float* __restrict__ h,
               float* __restrict__ scratch, GradWShape s) {
  extern __shared__ float4 smem_raw[];
  if constexpr (kModels) {
    // model blockIdx.z: its X2 and H stacks and its blocks' scratch slots
    x2 += blockIdx.z * (static_cast<int64_t>(s.n) * s.x_c2 * s.x_ex * s.x_ey);
    h += blockIdx.z * (static_cast<int64_t>(s.n) * s.m * s.tx * s.ty);
    scratch += blockIdx.z * (static_cast<int64_t>(gridDim.x) * s.ksplit * s.m * s.c2 * s.ax *
                             s.ay);
  }
  // kSplit: planes of one chunk with the same layout, raw (the cp.async
  // target) and its big and (3xTF32) small TF32 halves, split once per
  // chunk; else the compact layout, raw alone, split as fragments load
  const int xr = s.tr + s.ax - 1;
  const int hsz = s.tr * s.m_rows * s.hp;
  const int plane = hsz + s.c2 * xr * s.xp;  // a multiple of 4 when kSplit
  float* raw = reinterpret_cast<float*>(smem_raw);
  const float* big = raw + plane;
  const float* small = big + plane;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int a_sz = s.ax * s.ay;
  const int n_cols = s.c2 * a_sz;

  // this warp's work item: row tile mt, column tiles ct0 .. ct0 + kNT - 1,
  // and its share (slice) of the ty steps; the block stages the atoms of
  // its items' row tiles, m_lo .. m_hi - 1
  const int item = blockIdx.y * s.ipb + warp % s.ipb;
  const int slice = warp / s.ipb;
  const bool active = item < s.n_items && slice < s.ksplit;
  const int mt = item / s.n_groups;
  const int ct0 = (item % s.n_groups) * kNT;
  const int m0 = mt * 16 + g;
  const int m_lo = (blockIdx.y * s.ipb / s.n_groups) * 16;
  const int m_hi = min(s.m, m_lo + s.m_rows);
  // the lane's k columns: tig and tig + 4, folded into the offsets when
  // kSplit; the compact layout's narrow chunk (ty < 8) has fewer
  const int kw = min(8, s.hw);
  const bool ok0 = tig < kw, ok1 = tig + 4 < kw;
  const int c0 = ok0 ? tig : 0, c1 = ok1 ? tig + 4 : 0;
  const int lane_k = kSplit ? tig : 0;
  // shared offsets of this lane's A elements (rows g and g + 8; rows past
  // the last atom read the last atom's, and their sums are never written
  // back) and of its B column g in each tile, at the warp's first k step;
  // tiles past the last one read column 0 and are never written back
  const int r0 = min(m0, s.m - 1) - m_lo, r1 = min(m0 + 8, s.m - 1) - m_lo;
  const int ha = r0 * s.hp + lane_k + slice * 8;
  const int hb = (r1 - r0) * s.hp;
  int boff[kNT];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = (ct0 + j) * 8 + g;
    const int c2 = col / a_sz, w = col % a_sz;
    boff[j] = hsz + lane_k + slice * 8 +
              (col < n_cols ? (c2 * xr + w / s.ay) * s.xp + w % s.ay : 0);
  }
  auto load = [&](int a, const int (&b)[kNT], int off, Frags<kNT>& f) {
    if constexpr (kSplit) {
      load_frags<kNT, kPasses>(big, small, a, hb, b, off, f);
    } else {
      load_frags_raw<kNT, kPasses>(raw, a, hb, b, off, c0, c1, ok0, ok1, f);
    }
  };

  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int n_rx = (s.tx + s.tr - 1) / s.tr;
  const int n_ry = (s.ty + s.tc - 1) / s.tc;
  const int64_t n_chunks = static_cast<int64_t>(s.n) * n_rx * n_ry;
  const int n_steps = (s.tc / 8 - slice + s.ksplit - 1) / s.ksplit;  // this warp's k steps
  const int kstep = 8 * s.ksplit;

  if (blockIdx.x < n_chunks) stage<kVec>(x2, h, raw, blockIdx.x, m_lo, m_hi, s);
  commit();
  for (int64_t q = blockIdx.x; q < n_chunks; q += gridDim.x) {
    wait_copies();
    __syncthreads();  // the chunk is in raw, and the last chunk's MMAs are done
    if constexpr (kSplit) {
      for (int i = 4 * threadIdx.x; i < plane; i += 4 * kThreads) {
        const float4 x = *reinterpret_cast<const float4*>(raw + i);
        if constexpr (kPasses == 3) {
          float4 b, l;
          split4(x, b, l);
          *reinterpret_cast<float4*>(raw + plane + i) = b;
          *reinterpret_cast<float4*>(raw + 2 * plane + i) = l;
        } else {
          *reinterpret_cast<float4*>(raw + plane + i) =
              make_float4(__uint_as_float(to_tf32(x.x)), __uint_as_float(to_tf32(x.y)),
                          __uint_as_float(to_tf32(x.z)), __uint_as_float(to_tf32(x.w)));
        }
      }
      __syncthreads();  // raw may be refilled: the next chunk's copies overlap the MMAs
      if (q + gridDim.x < n_chunks) stage<kVec>(x2, h, raw, q + gridDim.x, m_lo, m_hi, s);
      commit();
    }

    if (active) {
      for (int r = 0; r < s.tr; ++r) {
        int a = ha + r * s.m_rows * s.hp;
        int b[kNT];
#pragma unroll
        for (int j = 0; j < kNT; ++j) b[j] = boff[j] + r * s.xp;
        float d[kNT][4];
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
        // software pipeline over pairs of k steps: one step's fragments load
        // while the other step's MMAs run
        Frags<kNT> f0, f1;
        if (n_steps > 0) load(a, b, 0, f0);
        for (int i = 0; i + 1 < n_steps; i += 2) {
          load(a, b, kstep, f1);
          mma_step<kNT, kPasses>(d, f0);
          a += 2 * kstep;
#pragma unroll
          for (int j = 0; j < kNT; ++j) b[j] += 2 * kstep;
          if (i + 2 < n_steps) load(a, b, 0, f0);
          mma_step<kNT, kPasses>(d, f1);
        }
        if (n_steps & 1) mma_step<kNT, kPasses>(d, f0);
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] += d[j][e];
      }
    }

    if constexpr (!kSplit) {
      __syncthreads();  // the MMAs are done with raw: stage the next chunk
      if (q + gridDim.x < n_chunks) stage<kVec>(x2, h, raw, q + gridDim.x, m_lo, m_hi, s);
      commit();
    }
  }

  if (active) {
    const int64_t n_out = static_cast<int64_t>(s.m) * n_cols;
    float* part = scratch + (static_cast<int64_t>(blockIdx.x) * s.ksplit + slice) * n_out;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // accumulator e: row g (+8 for e >= 2), column 2 * tig + (e & 1);
        // the flattened column (c2, ax, ay) is the output's own order
        const int mm = m0 + (e >> 1) * 8;
        const int col = (ct0 + j) * 8 + 2 * tig + (e & 1);
        if (mm < s.m && col < n_cols) part[mm * n_cols + col] = acc[j][e];
      }
    }
  }
}

template <bool kModels>
__global__ void grad_w_reduce(const float* __restrict__ scratch,
                              float* __restrict__ out, int n_parts,
                              GradWShape s) {
  const int64_t a_sz = static_cast<int64_t>(s.ax) * s.ay;
  const int64_t n_out = static_cast<int64_t>(s.m) * s.c2 * a_sz;
  const int c = s.x_c2 / 2;
  if constexpr (kModels) scratch += blockIdx.y * (n_parts * n_out);  // model blockIdx.y
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       o < n_out; o += stride) {
    double sum = 0.;
    for (int b = 0; b < n_parts; ++b) sum += scratch[b * n_out + o];
    // o = ((m * c2 + cc) * ax + axo) * ay + ayo over the group  ->
    // out[half][m][ch][a_off + axo][b_off + ayo] for its channel c_off + cc
    const int sp = static_cast<int>(o % a_sz);
    const int cc = s.c_off + static_cast<int>((o / a_sz) % s.c2);
    const int m = static_cast<int>(o / (a_sz * s.c2));
    const int half = cc / c, ch = cc % c;
    const int64_t at = static_cast<int64_t>(s.a_off + sp / s.ay) * s.x_ay + s.b_off + sp % s.ay;
    if constexpr (kModels) {
      out[(((static_cast<int64_t>(half) * s.models + blockIdx.y) * s.m + m) * c + ch) *
              s.x_ax * s.x_ay + at] = static_cast<float>(sum);
    } else {
      out[((static_cast<int64_t>(half) * s.m + m) * c + ch) * s.x_ax * s.x_ay + at] =
          static_cast<float>(sum);
    }
  }
}

template <int kNT, int kVec, bool kSplit, int kPasses, bool kModels>
cudaError_t launch_partial(const float* x2, const float* h, float* scratch,
                           const GradWShape& s, int grid_x, int grid_y, int smem_bytes,
                           cudaStream_t st) {
  auto kernel = grad_w_partial<kNT, kVec, kSplit, kPasses, kModels>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(grid_x, grid_y, s.models), kThreads, smem_bytes, st>>>(x2, h, scratch, s);
  return cudaGetLastError();
}

template <int kVec, bool kSplit, int kPasses, bool kModels>
cudaError_t launch_nt(int nt, const float* x2, const float* h, float* scratch,
                      const GradWShape& s, int grid_x, int grid_y, int smem_bytes,
                      cudaStream_t st) {
  switch (nt) {
    case 1: return launch_partial<1, kVec, kSplit, kPasses, kModels>(x2, h, scratch, s, grid_x, grid_y, smem_bytes, st);
    case 2: return launch_partial<2, kVec, kSplit, kPasses, kModels>(x2, h, scratch, s, grid_x, grid_y, smem_bytes, st);
    case 3: return launch_partial<3, kVec, kSplit, kPasses, kModels>(x2, h, scratch, s, grid_x, grid_y, smem_bytes, st);
    case 4: return launch_partial<4, kVec, kSplit, kPasses, kModels>(x2, h, scratch, s, grid_x, grid_y, smem_bytes, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int kVec, int kPasses, bool kModels>
cudaError_t launch_layout(bool split, int nt, const float* x2, const float* h, float* scratch,
                          const GradWShape& s, int grid_x, int grid_y, int smem_bytes,
                          cudaStream_t st) {
  return split ? launch_nt<kVec, true, kPasses, kModels>(nt, x2, h, scratch, s, grid_x, grid_y, smem_bytes, st)
               : launch_nt<kVec, false, kPasses, kModels>(nt, x2, h, scratch, s, grid_x, grid_y, smem_bytes, st);
}

template <int kVec, bool kModels>
cudaError_t launch_passes(int passes, bool split, int nt, const float* x2, const float* h,
                          float* scratch, const GradWShape& s, int grid_x, int grid_y,
                          int smem_bytes, cudaStream_t st) {
  switch (passes) {
    case 1: return launch_layout<kVec, 1, kModels>(split, nt, x2, h, scratch, s, grid_x, grid_y, smem_bytes, st);
    case 3: return launch_layout<kVec, 3, kModels>(split, nt, x2, h, scratch, s, grid_x, grid_y, smem_bytes, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int tnmf_grad_w(const float* x2, const float* h, float* out, float* scratch,
                           int n, int m, int c2, int tx, int ty, int ax, int ay,
                           const int* geometry, const int* group, int grid_x, int grid_y,
                           int smem_bytes, int models, void* stream) {
  // geometry: tr, tc, hp, hw, xw, xp, n_ct, nt, n_items, ipb, ksplit, m_rows,
  // vec, planes, passes; group: c_off, channels, a_off, atom rows, b_off,
  // atom columns; models: the S stacked models (1: a single problem)
  if (models < 1 || models > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int* g = geometry;
  const int* gr = group;
  const int nt = g[7], vec = g[12], passes = g[14];
  const bool split = g[13] > 1;  // raw and big (and small) planes, else the compact layout
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ex = tx + ax - 1, ey = ty + ay - 1;
  const GradWShape s{n, m, gr[1], tx + gr[3] - 1, ty + gr[5] - 1, tx, ty, gr[3], gr[5],
                     g[0], g[1], g[2], g[3], g[4], g[5], g[6], (g[6] + nt - 1) / nt,
                     g[8], g[9], g[10], g[11],
                     c2, ex, ey, gr[0], gr[2], gr[4], ax, ay, models};
  const float* xg = x2 + (static_cast<int64_t>(gr[0]) * ex + gr[2]) * ey + gr[4];
  const bool axis = models > 1;
  cudaError_t err =
      vec == 4 ? (axis ? launch_passes<4, true>(passes, split, nt, xg, h, scratch, s, grid_x, grid_y, smem_bytes, st)
                       : launch_passes<4, false>(passes, split, nt, xg, h, scratch, s, grid_x, grid_y, smem_bytes, st))
               : (axis ? launch_passes<1, true>(passes, split, nt, xg, h, scratch, s, grid_x, grid_y, smem_bytes, st)
                       : launch_passes<1, false>(passes, split, nt, xg, h, scratch, s, grid_x, grid_y, smem_bytes, st));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_out = static_cast<int64_t>(m) * s.c2 * s.ax * s.ay;
  const int blocks = static_cast<int>(std::min<int64_t>((n_out + 255) / 256, 1024));
  if (axis) {
    grad_w_reduce<true><<<dim3(blocks, models), 256, 0, st>>>(scratch, out, grid_x * s.ksplit, s);
  } else {
    grad_w_reduce<false><<<blocks, 256, 0, st>>>(scratch, out, grid_x * s.ksplit, s);
  }
  return static_cast<int>(cudaGetLastError());
}
