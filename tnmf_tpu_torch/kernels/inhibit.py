"""K4: the multiplicative H update with lateral inhibition.

Replaces ``tnmf_tpu/experimental/pallas_mu.py::inhibited_mu_h``; the CUDA
kernel is ``tnmf_tpu_torch/csrc/inhibited_mu_h.cu``.  For the activations H
and the H-gradient parts ``neg``, ``pos`` (all ``(N, M, *T)``, 1 or 2 shift
axes) it computes

    g   = H (*) k_x [(*) k_y]                 (separable, zero-padded)
    pos = pos + inh * (g - H)                 (use_same)
              + cross / (M - 1) * (sum_m g - g)   (use_cross)
    H'  = H * neg / (pos + reg)

in one pass with float32 accumulation, so the inhibition field never
reaches device memory.

Bound by device-memory bandwidth: three reads and one write per element
against ``tx + ty`` FMAs of the stencil (at the inhibited flagship,
64 x 16 x 264 x 264 with 17 x 17 taps, 1.14 GB against 4.9 GFLOP, 0.34 ms
on an H100).  A block owns one sample's tile and streams the atoms through
it: the next atom's H tile (with its halo) and this atom's ``neg``/``pos``
arrive by ``cp.async`` while the stencil runs, and each atom's output is
written as soon as its field is known, so no buffer of fields is kept and
shared memory does not grow with M.  The cross-atom sum is linear in H:
the kernel first sums the H tiles of all atoms and runs the stencil once
on that sum.  A 2-D stencil of at most 17 taps a side runs with a tap count
compiled in (:data:`_COMPILED_TAPS`; the wrapper centres the taps in
zeros), wider ones with a runtime tap loop.  The wrapper picks the tile
(the least stencil and staging work for the plane, four blocks per SM),
one H buffer when two do not fit and tiles of one row when no 2-D tile
fits, and the pitches (for bank-conflict free loads, counted in
:func:`_xst_conflicts`).

A stencil whose halo tile no block can hold in one piece takes the streamed
route of the same kernel: the taps are walked in segments, each segment
stages only its part of the halo (and, in rows, its slice of the taps) in
one H buffer, and its contribution is added to the x pass (2-D tiles) or to
each thread's output (rows) before the ratio is taken once.  Every stencil
that fits in one piece runs as before, so :func:`_geometry` never raises
for a 1-D or 2-D stencil.  Only the streamed route sums in another order:
:func:`inhibited_mu_h_segments_plain` sums in its order.

The summed route (:func:`inhibited_mu_h_summed`, the cross-atom term under
a mesh over the atoms): the block holds a rank's atoms, and the atoms' sum
of every rank comes from outside as an ``(N, 1, *T)`` plane ``h_sum``
(reduced over the ranks by the engine).  The kernel stages each sample's
tile of ``h_sum``, with its halo, into the buffer where its own route sums
the H tiles of the block's atoms, runs the same stencil on it and subtracts
each atom's own field as before; ``cross`` is divided by the global map
count less one.  It is a template instance of its own (``kSummed``), so
the instances without it keep their instructions.

The model axis (:func:`inhibited_mu_h_models`, a sweep's S models in one
launch): the stacks ``(S, N, M, *T)`` are ``S * N`` samples of one launch,
and each sample reads its model's strengths (``inh``, ``cross`` and
``reg``, ``(S,)`` vectors on the card) at ``sample / N``.  A model's
strength of 0 adds ``0 * term``: its update is the uninhibited one.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.inhibition import cross_scale, inhibition_positive_term
from . import _build

# must match inhibited_mu_h.cu
_THREADS = 256
_SEG_X, _SEG_Y_2D = 8, 8  # x-pass rows and y-pass columns per thread (2-D)
_TILE_X_2D = (8, 16, 24, 32)
_TILE_Y_2D = tuple(range(8, 129, 8))
_TILE_Y_1D = tuple(range(4, _THREADS + 1, 4))
#: tap counts compiled into the 2-D kernel: a stencil of at most 17 taps a
#: side runs with the taps of both axes padded with zeros to the next one
_COMPILED_TAPS = (9, 17)
#: blocks per SM the kernel is built for (``__launch_bounds__``): four
#: blocks share the SM's 228 KB, 1 KB per block reserved
_BLOCKS_PER_SM = 4
_SMEM_BUDGET = (233472 - _BLOCKS_PER_SM * 1024) // _BLOCKS_PER_SM
#: the streamed route's budget: two blocks per SM.  Its blocks wait on each
#: segment's copies, and two blocks with longer segments beat four with
#: shorter ones (tools/k4_streamed_tiles.py)
_STREAM_BUDGET = (233472 - 2 * 1024) // 2


def inhibited_mu_h_plain(H: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor,
                         kernels: Sequence, inhibition: float, cross_inhibition: float,
                         reg: float, *, use_same: bool = True,
                         use_cross: bool = False, h_sum: Optional[torch.Tensor] = None,
                         n_total: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version: ``pos`` plus the inhibition term of
    :func:`~tnmf_tpu_torch.ops.inhibition.inhibition_positive_term`, then
    the ratio (the order of ``engine._mu_H`` in the JAX package).  Given
    ``h_sum`` and ``n_total`` the cross-atom field is the stencil of the
    given atoms' sum (:func:`inhibited_mu_h_summed`)."""
    term = inhibition_positive_term(H, kernels, H.dim() - 2, inhibition, cross_inhibition,
                                    H.shape[1], use_same, use_cross, h_sum, n_total)
    return H * neg / (pos + term + reg)


def inhibited_mu_h_summed_plain(H: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor,
                                kernels: Sequence, inhibition: float, cross_inhibition: float,
                                reg: float, h_sum: torch.Tensor, n_total: int, *,
                                use_same: bool = True) -> torch.Tensor:
    """The plain version of :func:`inhibited_mu_h_summed`: cross-atom
    inhibition against the given atoms' sum ``h_sum`` of ``n_total``
    maps."""
    return inhibited_mu_h_plain(H, neg, pos, kernels, inhibition, cross_inhibition, reg,
                                use_same=use_same, use_cross=True, h_sum=h_sum,
                                n_total=n_total)


def _corr(A: torch.Tensor, k: torch.Tensor, axis: int) -> torch.Tensor:
    """``'valid'`` correlation of ``A`` (N, M, X, Y) with taps ``k`` along
    ``axis`` (2: x, 3: y), TF32 off."""
    shape = (1, 1, k.numel(), 1) if axis == 2 else (1, 1, 1, k.numel())
    N, M = A.shape[:2]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = F.conv2d(A.reshape((N * M, 1) + A.shape[2:]), k.reshape(shape))
    return out.reshape((N, M) + out.shape[2:])


def inhibited_mu_h_segments_plain(H: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor,
                                  kernels: Sequence, inhibition: float,
                                  cross_inhibition: float, reg: float, segment: tuple, *,
                                  use_same: bool = True,
                                  use_cross: bool = False) -> torch.Tensor:
    """The streamed route's sums in its own order, ``segment = (two_d,
    seg_x, seg_y)`` of the geometry.  2-D tiles: the x pass of each segment
    of ``seg_x`` x taps, added in segment order, then the y pass of all the
    taps.  Rows: for each segment of ``seg_x`` x taps and ``seg_y`` y taps,
    in that order, each x tap's y pass of the segment's y taps, weighted by
    the x tap and added to the field.  Then ``pos`` plus the inhibition
    terms (the cross-atom field is the stencil of the atoms' sum) and the
    ratio.  The comparator of the streamed kernel."""
    nd = H.dim() - 2
    ks = [torch.as_tensor(k, dtype=H.dtype, device=H.device).reshape(-1) for k in kernels]
    if nd == 1:  # a 1-D problem is a 2-D one with one row and one x tap
        out = inhibited_mu_h_segments_plain(
            H[:, :, None], neg[:, :, None], pos[:, :, None],
            [torch.ones(1, dtype=H.dtype, device=H.device)] + ks, inhibition,
            cross_inhibition, reg, segment, use_same=use_same, use_cross=use_cross)
        return out[:, :, 0]
    two_d, sx, sy = segment
    kx, ky = ks
    tx, ty = kx.numel(), ky.numel()
    X, Y = H.shape[2:]

    def field(A):
        P = F.pad(A, (ty // 2, ty // 2, tx // 2, tx // 2))
        if two_d:
            xs = None
            for t0 in range(0, tx, sx):
                n = min(sx, tx - t0)
                part = _corr(P[:, :, t0:t0 + X + n - 1], kx[t0:t0 + n], 2)
                xs = part if xs is None else xs + part
            return _corr(xs, ky, 3)
        g = torch.zeros_like(A)
        for t0x in range(0, tx, sx):
            for t0y in range(0, ty, sy):
                n = min(sy, ty - t0y)
                for i in range(t0x, min(t0x + sx, tx)):
                    r = _corr(P[:, :, i:i + X, t0y:t0y + Y + n - 1], ky[t0y:t0y + n], 3)
                    g = g + kx[i] * r
        return g
    g = field(H)
    p = pos
    if use_same:
        p = p + inhibition * (g - H)
    if use_cross:
        p = p + cross_scale(cross_inhibition, H.shape[1]) * (field(H.sum(1, keepdim=True)) - g)
    return H * neg / (p + reg)


def _xst_conflicts(xtp: int, tile_x: int, tile_y: int, hw: int, tx: int, ty: int) -> int:
    """Extra shared-memory wavefronts of the transposed x-pass buffer (row
    pitch ``xtp``): the y pass's loads (lanes on consecutive rows of a
    column) and the x pass's stores (lanes on consecutive columns), weighted
    by the loads and stores each item makes."""
    def extra(addrs):
        banks = {}
        for a in addrs:
            banks.setdefault(a % 32, set()).add(a)
        return max(len(v) for v in banks.values()) - 1
    n_y = tile_x * (tile_y // _SEG_Y_2D)
    loads = sum(extra([(t // tile_x) * _SEG_Y_2D * xtp + t % tile_x
                       for t in range(w, min(w + 32, n_y))]) for w in range(0, n_y, 32))
    n_x = (tile_x // _SEG_X) * hw
    stores = sum(extra([(t % hw) * xtp + (t // hw) * _SEG_X for t in range(w, min(w + 32, n_x))])
                 for w in range(0, n_x, 32))
    return loads * (_SEG_Y_2D + ty - 1) + stores * _SEG_X


def _layout(tile_x: int, tile_y: int, tx: int, ty: int, two_d: bool, h_vec: bool,
            h_bufs: int, cross: bool, limit: int = _build.MAX_SMEM_BYTES,
            seg_x: int = 0, seg_y: int = 0, xtp: int = 0):
    """Pitches and shared memory of one tile, or None above ``limit`` bytes:
    neg and pos tiles (rows of 4 mod 8 floats for the y pass's float4
    loads), ``h_bufs`` H tiles with halo (rows of 4 mod 8 floats when they
    are copied and read as float4s, else odd), the transposed x pass (its
    pitch with the fewest bank conflicts that fits, unless ``xtp`` is
    given) and each thread's cross-atom sums (2-D tiles) and the taps.

    Streamed (``seg_x`` x taps and, in rows, ``seg_y`` y taps a segment;
    one H buffer, H copied by 4 bytes): the H buffer holds one segment's
    rows of the halo tile (2-D tiles: all its columns), and in rows the
    taps are the segment's slices."""
    seg_x, seg_y = seg_x or tx, seg_y or ty
    hr, hw = tile_x + seg_x - 1, tile_y + seg_y - 1
    hp = hw + (4 - hw) % 8 if h_vec else hw | 1
    npp = tile_y + 4 if two_d else tile_y
    sums = _SEG_Y_2D * _THREADS if two_d and cross else 0
    floats = 2 * tile_x * npp + h_bufs * hr * hp + sums + (tx + ty if two_d else seg_x + seg_y)
    if two_d:
        pitches = [p for p in range(tile_x, tile_x + 32) if 4 * (floats + hw * p) <= limit]
        if not pitches:
            return None
        xtp = xtp or min(pitches, key=lambda p: (_xst_conflicts(p, tile_x, tile_y, hw, tx, ty), p))
        floats += hw * xtp
    if 4 * floats > limit:
        return None
    return dict(tile_x=tile_x, tile_y=tile_y, hp=hp, xtp=xtp, npp=npp, two_d=two_d,
                h_bufs=h_bufs, h_vec=h_vec, seg_x=seg_x, seg_y=seg_y, smem_bytes=4 * floats)


def _tiles(tx: int, ty: int, two_d: bool, X: int, Y: int) -> list:
    """The tiles the kernel can walk for an ``X x Y`` plane, least stencil
    and staging work first (the halo and the ragged edge count): 2-D tiles
    hold one y-pass item per thread; row tiles (1-D, or a 2-D stencil run
    row by row) one output per thread."""
    if two_d:
        xs = [t for t in _TILE_X_2D if t < X + _SEG_X] or [_SEG_X]
        ys = [t for t in _TILE_Y_2D if t < Y + _SEG_Y_2D] or [_SEG_Y_2D]
    else:
        xs, ys = [1], [t for t in _TILE_Y_1D if t < Y + 4] or [4]
    candidates = []
    for tile_x in xs:
        for tile_y in ys:
            if two_d and tile_x * tile_y // _SEG_Y_2D > _THREADS:
                continue
            hr, hw = tile_x + tx - 1, tile_y + ty - 1
            n_tiles = -(-X // tile_x) * -(-Y // tile_y)
            stencil = tile_x * hw * tx + tile_x * tile_y * ty if two_d else tile_y * ty * tx
            candidates.append((n_tiles * (stencil + 4 * hr * hw), tile_x, tile_y))
    return [(tile_x, tile_y) for _, tile_x, tile_y in sorted(candidates)]


def _streamed(tile_x: int, tile_y: int, tx: int, ty: int, two_d: bool, cross: bool,
              limit: int):
    """The streamed layout of one tile with the largest segments that fit
    ``limit`` bytes, cut into near-equal pieces, or None.  2-D tiles:
    segments of x taps, every y tap in each.  Rows: all the taps if they
    fit, else segments of whole x rows, else one x row and a stretch of
    its y taps (the first keeps the one-piece order of the sums)."""
    if two_d:
        g = _layout(tile_x, tile_y, tx, ty, True, False, 1, cross, limit, seg_x=1)
        if g is None:
            return None
        fixed = g['smem_bytes'] // 4 - tile_x * g['hp']  # all but the H rows
        rows = (limit // 4 - fixed) // g['hp']
        n = -(-tx // (rows - tile_x + 1))
        return _layout(tile_x, tile_y, tx, ty, True, False, 1, cross, limit,
                       seg_x=-(-tx // n), xtp=g['xtp'])

    def fits(_, rows, cols):
        return _layout(1, tile_y, tx, ty, False, False, 1, cross, limit, rows, cols) is not None
    _, seg_x, seg_y = _build.segments(1, tx, ty, fits)
    return _layout(1, tile_y, tx, ty, False, False, 1, cross, limit, seg_x, seg_y)


@functools.lru_cache(maxsize=64)
def _geometry(M: int, tx: int, ty: int, two_d: bool, X: int, Y: int,
              h_vec: bool = False, cross: bool = False) -> dict:
    """The tile of one block for an ``X x Y`` plane with ``tx x ty`` taps:
    the tile with the least work whose shared memory lets four blocks share
    an SM with two H buffers, else one block with two, else one with one;
    a 2-D stencil whose taps no 8-row tile can hold runs on tiles of one
    row.  A stencil no tile holds in one piece is streamed (one H buffer,
    H copied by 4 bytes): 2-D tiles in segments of x taps if the y extent
    of a tile fits, else rows in segments, the tile and segments with the
    least stencil and staging work at two blocks per SM, else at one.
    Shared memory does not depend on the number of atoms."""
    del M  # the atoms stream through the tile
    kinds = ([True] if two_d else []) + [False]
    for kind in kinds:
        tiles = _tiles(tx, ty, kind, X, Y)
        for h_bufs, limit in ((2, _SMEM_BUDGET), (2, _build.MAX_SMEM_BYTES),
                              (1, _build.MAX_SMEM_BYTES)):
            for tile_x, tile_y in tiles:
                g = _layout(tile_x, tile_y, tx, ty, kind, h_vec, h_bufs, cross, limit)
                if g:
                    return _with_occupancy(g, 1)
    for kind in kinds:
        for limit in (_STREAM_BUDGET, _build.MAX_SMEM_BYTES):
            best = None
            for tile_x, tile_y in _tiles(tx, ty, kind, X, Y):
                g = _streamed(tile_x, tile_y, tx, ty, kind, cross, limit)
                if g is None:
                    continue
                n_x, n_y = -(-tx // g['seg_x']), -(-ty // g['seg_y'])
                hw = tile_y + g['seg_y'] - 1
                staged = n_x * n_y * (tile_x + g['seg_x'] - 1) * hw
                stencil = (tile_x * (tile_y + ty - 1) * tx + tile_x * tile_y * ty if kind
                           else tile_y * ty * tx)
                cost = -(-X // tile_x) * -(-Y // tile_y) * (stencil + 4 * staged)
                if best is None or cost < best[0]:
                    best = (cost, g, n_x * n_y)
            if best:
                return _with_occupancy(best[1], best[2])
    raise AssertionError(f'inhibited_mu_h: no layout for {tx}x{ty} taps')  # rows always fit


def _with_occupancy(g: dict, n_segments: int) -> dict:
    return dict(g, n_segments=n_segments,
                blocks_per_sm=min(_BLOCKS_PER_SM, 233472 // (g['smem_bytes'] + 1024)))


def _compiled_taps(tx: int, ty: int) -> int:
    """The compiled tap count a 2-D stencil of ``tx x ty`` taps runs with,
    or 0 for the runtime tap loop."""
    return next((c for c in _COMPILED_TAPS if c >= max(tx, ty)), 0)


def _pad_taps(k: torch.Tensor, n: int) -> torch.Tensor:
    """Odd taps ``k`` centred in ``n`` taps, zeros around them: the same
    zero-padded correlation, with a wider halo of zero-weighted inputs."""
    z = (n - k.numel()) // 2
    return torch.nn.functional.pad(k, (z, z))


def launch_geometry(shape: tuple, tap_counts: tuple, use_cross: bool = False,
                    aligned: bool = True) -> dict:
    """What a launch on tensors of ``shape`` (N, M, *T) with odd
    ``tap_counts`` per shift axis runs: the plane ``X x Y`` and taps
    ``tx x ty`` as the kernel sees them (1-D: one row, one x tap; a 2-D
    stencil of at most 17 taps a side centred in its compiled tap count),
    ``compiled`` (0: the runtime tap loop), ``vec`` (16-byte neg/pos copies
    and H' stores; ``aligned``: all four tensors on 16 bytes) and the tile
    of :func:`_geometry`."""
    nd = len(shape) - 2
    tx, ty = (1,) + tuple(tap_counts) if nd == 1 else tuple(tap_counts)
    compiled = _compiled_taps(tx, ty) if nd == 2 else 0
    if compiled:
        tx = ty = compiled
    X, Y = (1,) + tuple(shape[2:]) if nd == 1 else tuple(shape[2:])
    vec = Y % 4 == 0 and aligned           # 16-byte neg/pos copies and H' stores
    h_vec = vec and (ty // 2) % 4 == 0     # 16-byte H tile copies as well
    g = _geometry(shape[1], tx, ty, nd == 2, X, Y, h_vec, use_cross)
    if not g['two_d'] or g['h_bufs'] != 2:
        compiled = 0  # the compiled taps come with 2-D tiles and two H buffers
    return dict(g, X=X, Y=Y, tx=tx, ty=ty, compiled=compiled, vec=vec)


def inhibited_mu_h(H: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor,
                   kernels: Sequence, inhibition: float, cross_inhibition: float,
                   reg: float, *, use_same: bool = True,
                   use_cross: bool = False) -> torch.Tensor:
    """Inhibited H update: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (float32, contiguous, 1-D or 2-D shifts, odd
    taps).  The signature is the JAX package's."""
    if H.device.type == 'cpu':
        return inhibited_mu_h_plain(H, neg, pos, kernels, inhibition, cross_inhibition, reg,
                                    use_same=use_same, use_cross=use_cross)
    ks = _checked_taps(H, neg, pos, kernels)
    cross = cross_scale(cross_inhibition, H.shape[1]) if use_cross else 0.
    return _launch(H, neg, pos, ks, inhibition, cross, reg, None, 1, use_same, use_cross)


def _checked_taps(H: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor,
                  kernels: Sequence) -> list:
    """The wrapper's checks of a single launch's operands (float32, CUDA,
    contiguous, one shape, 1-D or 2-D shifts, odd taps); the taps as
    float32 tensors on H's device."""
    _build.check_inputs('inhibited_mu_h', H, neg, pos)
    nd = H.dim() - 2
    if nd not in (1, 2):
        raise ValueError(f'inhibited_mu_h: the kernel takes 1-D or 2-D shifts, got {nd}-D')
    if neg.shape != H.shape or pos.shape != H.shape:
        raise ValueError(f'inhibited_mu_h: shapes H {tuple(H.shape)}, '
                         f'neg {tuple(neg.shape)}, pos {tuple(pos.shape)} differ')
    ks = [torch.as_tensor(k, dtype=torch.float32, device=H.device).reshape(-1)
          for k in kernels]
    if len(ks) != nd or any(k.numel() % 2 == 0 for k in ks):
        raise ValueError(f'inhibited_mu_h: expected {nd} kernels of odd length, '
                         f'got lengths {[k.numel() for k in ks]}')
    return ks


def inhibited_mu_h_summed(H: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor,
                          kernels: Sequence, inhibition: float, cross_inhibition: float,
                          reg: float, h_sum: torch.Tensor, n_total: int, *,
                          use_same: bool = True) -> torch.Tensor:
    """Inhibited H update with the cross-atom term against a given atoms'
    sum: ``h_sum`` ``(N, 1, *T)``, the sum over all ``n_total`` maps of
    which ``H`` holds ``M`` (a rank's block under a mesh over the atoms).
    The plain version for CPU tensors; on CUDA tensors K4's summed route
    (float32, contiguous, ``h_sum`` checked like the others), counted in
    its own ``launches``."""
    if H.device.type == 'cpu':
        return inhibited_mu_h_summed_plain(H, neg, pos, kernels, inhibition, cross_inhibition,
                                           reg, h_sum, n_total, use_same=use_same)
    ks = _checked_taps(H, neg, pos, kernels)
    _build.check_inputs('inhibited_mu_h_summed', H, h_sum)
    want = (H.shape[0], 1) + tuple(H.shape[2:])
    if tuple(h_sum.shape) != want:
        raise ValueError(f'inhibited_mu_h_summed: h_sum of shape {tuple(h_sum.shape)}, '
                         f'not {want}')
    if int(n_total) < H.shape[1]:
        raise ValueError(f'inhibited_mu_h_summed: n_total={n_total} is fewer than the '
                         f'{H.shape[1]} maps H holds')
    cross = cross_scale(cross_inhibition, int(n_total))
    return _launch(H, neg, pos, ks, inhibition, cross, reg, None, 1, use_same, True, h_sum)


def _launch(H: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor, ks: list, inhibition: float,
            cross: float, reg: float, strengths: Optional[torch.Tensor], models: int,
            use_same: bool, use_cross: bool,
            h_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch over the ``N`` samples of ``H`` (``models`` stacked
    problems of ``N / models`` samples each): ``strengths``, the per-model
    ``[inh, cross, reg]`` vectors concatenated, or the scalars (``cross``
    already divided by the map count less one).  ``h_sum``: the summed
    route's atoms' sum (single launches only).  Counts it on its route's
    wrapper (``strengths``: as a launch over a model axis too)."""
    nd = H.dim() - 2
    N, M = H.shape[:2]
    out = torch.empty_like(H)
    if out.numel() == 0:
        return out
    operands = (H, neg, pos, out) + (() if h_sum is None else (h_sum,))
    aligned = all(t.data_ptr() % 16 == 0 for t in operands)
    g = launch_geometry(tuple(H.shape), tuple(k.numel() for k in ks), use_cross, aligned)
    X, Y, tx, ty, compiled = g['X'], g['Y'], g['tx'], g['ty'], g['compiled']
    if nd == 1:  # a 1-D problem is a 2-D one with one row and one x tap
        ks = [torch.ones(1, dtype=torch.float32, device=H.device)] + ks
    taps = torch.cat([_pad_taps(k, n) for k, n in zip(ks, (tx, ty))])
    lib = _build.library()
    with torch.cuda.device(H.device):
        err = lib.tnmf_inhibited_mu_h(
            H.data_ptr(), neg.data_ptr(), pos.data_ptr(), taps.data_ptr(), out.data_ptr(),
            N, M, X, Y, tx, ty, g['tile_x'], g['tile_y'], g['hp'], g['xtp'], g['npp'],
            float(inhibition), float(cross), float(reg), int(use_same), int(use_cross),
            int(g['two_d']), int(g['vec']), int(g['h_vec']), g['h_bufs'], compiled, g['seg_x'],
            g['seg_y'], g['smem_bytes'], None if strengths is None else strengths.data_ptr(),
            N // models, models, None if h_sum is None else h_sum.data_ptr(),
            _build.stream_of(H))
    if h_sum is not None:
        _build.check_launch(err, 'inhibited_mu_h_summed')
        inhibited_mu_h_summed.launches += 1
        return out
    _build.check_launch(err, 'inhibited_mu_h')
    inhibited_mu_h.launches += 1
    inhibited_mu_h.model_launches += strengths is not None
    return out


def inhibited_mu_h_models(H: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor,
                          kernels: Sequence, inhibition, cross_inhibition, reg, *,
                          use_same: bool = True, use_cross: bool = False) -> torch.Tensor:
    """:func:`inhibited_mu_h` over a model axis: ``H``, ``neg`` and ``pos``
    are ``(S, N, M, *T)`` stacks of a sweep's S models and each strength
    an ``(S,)`` tensor of the models' values (or one float for all).  The
    plain version model by model for CPU tensors; on CUDA tensors one
    launch over the ``S * N`` samples, each reading its model's strengths
    (each model bit-equal to its own :func:`inhibited_mu_h` launch)."""
    S = H.shape[0]
    if H.device.type == 'cpu':
        return torch.stack([
            inhibited_mu_h_plain(H[s], neg[s], pos[s], kernels,
                                 _build.model_value(inhibition, s),
                                 _build.model_value(cross_inhibition, s),
                                 _build.model_value(reg, s),
                                 use_same=use_same, use_cross=use_cross)
            for s in range(S)])
    _build.check_inputs('inhibited_mu_h', H, neg, pos)
    nd = H.dim() - 3
    if nd not in (1, 2):
        raise ValueError(f'inhibited_mu_h: the kernel takes 1-D or 2-D shifts, got {nd}-D')
    if neg.shape != H.shape or pos.shape != H.shape:
        raise ValueError(f'inhibited_mu_h: shapes H {tuple(H.shape)}, '
                         f'neg {tuple(neg.shape)}, pos {tuple(pos.shape)} differ')
    ks = [torch.as_tensor(k, dtype=torch.float32, device=H.device).reshape(-1)
          for k in kernels]
    if len(ks) != nd or any(k.numel() % 2 == 0 for k in ks):
        raise ValueError(f'inhibited_mu_h: expected {nd} kernels of odd length, '
                         f'got lengths {[k.numel() for k in ks]}')

    def vec64(x):  # the per-model values in float64, as the scalars are formed
        if isinstance(x, torch.Tensor):
            return x.to(device=H.device, dtype=torch.float64).reshape(S)
        return torch.full((S,), float(x), dtype=torch.float64, device=H.device)
    cross = (cross_scale(vec64(cross_inhibition), H.shape[2]) if use_cross
             else torch.zeros(S, dtype=torch.float64, device=H.device))
    strengths = torch.cat([vec64(inhibition), cross, vec64(reg)]).to(torch.float32)
    flat = (S * H.shape[1],) + tuple(H.shape[2:])
    return _launch(H.reshape(flat), neg.reshape(flat), pos.reshape(flat), ks, 0., 0., 0.,
                   strengths, S, use_same, use_cross).reshape(H.shape)


#: kernel launches since the last reset (plain counts, read by chip_smoke.py):
#: all of them, and those over a model axis (:func:`inhibited_mu_h_models`);
#: the summed route's apart
inhibited_mu_h.launches = 0
inhibited_mu_h.model_launches = 0
inhibited_mu_h_summed.launches = 0
