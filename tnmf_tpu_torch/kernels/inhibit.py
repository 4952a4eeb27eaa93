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
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

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


def inhibited_mu_h_plain(H: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor,
                         kernels: Sequence, inhibition: float, cross_inhibition: float,
                         reg: float, *, use_same: bool = True,
                         use_cross: bool = False) -> torch.Tensor:
    """The plain PyTorch version: ``pos`` plus the inhibition term of
    :func:`~tnmf_tpu_torch.ops.inhibition.inhibition_positive_term`, then
    the ratio (the order of ``engine._mu_H`` in the JAX package)."""
    term = inhibition_positive_term(H, kernels, H.dim() - 2, inhibition, cross_inhibition,
                                    H.shape[1], use_same, use_cross)
    return H * neg / (pos + term + reg)


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
            h_bufs: int, cross: bool, limit: int = _build.MAX_SMEM_BYTES):
    """Pitches and shared memory of one tile, or None above ``limit`` bytes:
    neg and pos tiles (rows of 4 mod 8 floats for the y pass's float4
    loads), ``h_bufs`` H tiles with halo (rows of 4 mod 8 floats when they
    are copied and read as float4s, else odd), the transposed x pass (its
    pitch with the fewest bank conflicts that fits) and each thread's
    cross-atom sums (2-D tiles) and the taps."""
    hr, hw = tile_x + tx - 1, tile_y + ty - 1
    hp = hw + (4 - hw) % 8 if h_vec else hw | 1
    npp = tile_y + 4 if two_d else tile_y
    sums = _SEG_Y_2D * _THREADS if two_d and cross else 0
    floats = 2 * tile_x * npp + h_bufs * hr * hp + sums + tx + ty
    xtp = 0
    if two_d:
        pitches = [p for p in range(tile_x, tile_x + 32) if 4 * (floats + hw * p) <= limit]
        if not pitches:
            return None
        xtp = min(pitches, key=lambda p: (_xst_conflicts(p, tile_x, tile_y, hw, tx, ty), p))
        floats += hw * xtp
    if 4 * floats > limit:
        return None
    return dict(tile_x=tile_x, tile_y=tile_y, hp=hp, xtp=xtp, npp=npp, two_d=two_d,
                h_bufs=h_bufs, smem_bytes=4 * floats)


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


@functools.lru_cache(maxsize=64)
def _geometry(M: int, tx: int, ty: int, two_d: bool, X: int, Y: int,
              h_vec: bool = False, cross: bool = False) -> dict:
    """The tile of one block for an ``X x Y`` plane with ``tx x ty`` taps:
    the tile with the least work whose shared memory lets four blocks share
    an SM with two H buffers, else one block with two, else one with one;
    a 2-D stencil whose taps no 8-row tile can hold runs on tiles of one
    row.  Shared memory does not depend on the number of atoms."""
    del M  # the atoms stream through the tile
    kinds = ([True] if two_d else []) + [False]
    for kind in kinds:
        tiles = _tiles(tx, ty, kind, X, Y)
        for h_bufs, limit in ((2, _SMEM_BUDGET), (2, _build.MAX_SMEM_BYTES),
                              (1, _build.MAX_SMEM_BYTES)):
            for tile_x, tile_y in tiles:
                g = _layout(tile_x, tile_y, tx, ty, kind, h_vec, h_bufs, cross, limit)
                if g:
                    return dict(g, blocks_per_sm=min(_BLOCKS_PER_SM,
                                                     233472 // (g['smem_bytes'] + 1024)))
    raise ValueError(
        f'inhibited_mu_h: {tx}x{ty} taps need more shared memory than a block can hold')


def _compiled_taps(tx: int, ty: int) -> int:
    """The compiled tap count a 2-D stencil of ``tx x ty`` taps runs with,
    or 0 for the runtime tap loop."""
    return next((c for c in _COMPILED_TAPS if c >= max(tx, ty)), 0)


def _pad_taps(k: torch.Tensor, n: int) -> torch.Tensor:
    """Odd taps ``k`` centred in ``n`` taps, zeros around them: the same
    zero-padded correlation, with a wider halo of zero-weighted inputs."""
    z = (n - k.numel()) // 2
    return torch.nn.functional.pad(k, (z, z))


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
    N, M = H.shape[:2]
    cross = cross_scale(cross_inhibition, M) if use_cross else 0.
    if nd == 1:  # a 1-D problem is a 2-D one with one row and one x tap
        ks = [torch.ones(1, dtype=torch.float32, device=H.device)] + ks
    compiled = _compiled_taps(ks[0].numel(), ks[1].numel()) if nd == 2 else 0
    if compiled:
        ks = [_pad_taps(k, compiled) for k in ks]
    X, Y = (1,) + tuple(H.shape[2:]) if nd == 1 else tuple(H.shape[2:])
    tx, ty = ks[0].numel(), ks[1].numel()
    out = torch.empty_like(H)
    if out.numel() == 0:
        return out
    aligned = all(t.data_ptr() % 16 == 0 for t in (H, neg, pos, out))
    vec = Y % 4 == 0 and aligned           # 16-byte neg/pos copies and H' stores
    h_vec = vec and (ty // 2) % 4 == 0     # 16-byte H tile copies as well
    g = _geometry(M, tx, ty, nd == 2, X, Y, h_vec, use_cross)
    if not g['two_d'] or g['h_bufs'] != 2:
        compiled = 0  # the compiled taps come with 2-D tiles and two H buffers
    taps = torch.cat(ks)
    lib = _build.library()
    with torch.cuda.device(H.device):
        err = lib.tnmf_inhibited_mu_h(
            H.data_ptr(), neg.data_ptr(), pos.data_ptr(), taps.data_ptr(), out.data_ptr(),
            N, M, X, Y, tx, ty, g['tile_x'], g['tile_y'], g['hp'], g['xtp'], g['npp'],
            float(inhibition), float(cross), float(reg), int(use_same), int(use_cross),
            int(g['two_d']), int(vec), int(h_vec), g['h_bufs'], compiled, g['smem_bytes'],
            _build.stream_of(H))
    _build.check_launch(err, 'inhibited_mu_h')
    inhibited_mu_h.launches += 1
    return out


#: kernel launches since the last reset (a plain count, read by chip_smoke.py)
inhibited_mu_h.launches = 0
