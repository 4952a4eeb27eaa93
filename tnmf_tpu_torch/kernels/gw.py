"""K2: the W-gradient statistics (neg, pos) of the multiplicative W update.

Replaces ``tnmf_tpu/experimental/pallas_gw.py::grad_w_gemm``; the CUDA kernel
is ``tnmf_tpu_torch/csrc/grad_w.cu``.  With ``X2 = [Vp | Rx]`` (the
mode-extended data and reconstruction stacked along channels) it computes

    G[m, c2, ax, ay] = sum_{n, tx, ty} X2[n, c2, tx+ax, ty+ay] * H[n, m, tx, ty]

and returns ``(neg, pos) = (G[:, :C], G[:, C:])``, each ``(M, C, *atom)``.

A GEMM with a huge contraction (``N*Tx*Ty``, 4.5 M at the flagship
64 x 1 x 256 x 256 with 16 atoms of 9 x 9) into a tiny output (2,592
values): 23 GFLOP against 0.33 GB of reads, a GEMM for the tensor cores.
The kernel is an implicit GEMM on ``mma.sync`` TF32 tiles (16 atoms x 8
offsets x 8 positions) with 3xTF32 splitting, which keeps float32 accuracy
(``ConvPlan.precision`` None or 'highest') at three tensor-core products
per product: 69 GFLOP at 495 TFLOP/s, a bound of 0.14 ms on an H100.  At
the TF32 levels ('default', 'high') it runs one TF32 pass: each operand
rounded once (``cvt.rna``), one product per product, no small plane, so a
chunk of the split layout needs two planes where 3xTF32 needs three.  What bounds it on the card is feeding the MMAs: the fragment loads
from shared memory.  Rows are the atoms, columns the ``(c2, ax, ay)``
offsets flattened and padded to a multiple of 8, and the contraction runs
along ``ty`` of one ``tx`` row; the H and X2 row pitches keep the fragment
loads on distinct banks.  A persistent grid walks chunks of
``(n, tx rows, ty columns)``: ``cp.async`` brings each into a raw buffer
during the previous chunk's MMAs, and the block splits it once into big and
small TF32 planes (the split layout).  A block stages only the atoms of its
own row tiles, so shared memory does not grow with M, and a chunk whose
three planes do not fit takes the compact layout (one plane, split as the
fragments load).  A problem whose chunk no block can hold either way runs
as groups of channels (then of atom rows, then of atom columns), each a
launch that reads X2 in place and writes its block of the output, so every
shape runs.
Per-warp partial sums are reduced in a second pass in a fixed order
(deterministic, no float atomics).  The TPU kernel's own fold (rows
``(ax, m)``, columns ``(ay, c)``) served the TPU's 128 x 128 matrix unit.

The model axis (:func:`grad_w_models`, a sweep's S models in one launch
per group): the models run along the grid's z, each on the single model's
geometry with its own scratch slots, so each model is summed in the order
of its own launch and gets its bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..ops import conv
from ..ops.precision import round_tf32
from . import _build

# must match grad_w.cu
_THREADS = 256
_WARPS = _THREADS // 32
_TILE_M, _TILE_N, _TILE_K = 16, 8, 8  # mma.sync.m16n8k8
#: column tiles per warp: the kernel is instantiated for these
_TILES_PER_WARP = (1, 2, 3, 4)
#: chunk rows along tx, in order of preference
_CHUNK_ROWS = (4, 2, 1)
#: the most chunk columns along ty (11 MMA steps)
_MAX_CHUNK_COLS = 88
#: blocks per SM the kernel is built for (``__launch_bounds__``); two
#: blocks' chunks must fit the SM's 228 KB, 1 KB per block reserved
_BLOCKS_PER_SM = 2
_SMEM_BUDGET = (233472 - _BLOCKS_PER_SM * 1024) // _BLOCKS_PER_SM


def grad_w_plain(X2: torch.Tensor, H: torch.Tensor, passes: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: stacked ``corr_W`` convolutions in full
    float32, one per sample, summed over the samples.  One convolution over
    all ``N*Tx*Ty`` positions is less accurate on the GPU: at the flagship
    cuDNN's float32 result was 3.3e-4 off a float64 one (relative to its
    largest value, on an H100, whatever the TF32 settings), the per-sample
    sum is not.  ``passes=1``, the one-pass route's plain version, first
    rounds both operands to TF32 as the kernel does
    (:func:`~tnmf_tpu_torch.ops.precision.round_tf32`)."""
    if passes == 1:
        X2, H = round_tf32(X2), round_tf32(H)
    G = torch.stack([conv.corr_W(X2[n:n + 1], H[n:n + 1])
                     for n in range(X2.shape[0])]).sum(dim=0)
    c = X2.shape[1] // 2
    return G[:, :c], G[:, c:]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _warp_split(n_mt: int, n_ct: int) -> dict:
    """The column tiles per warp, the work items (row tile, tile group), the
    blocks along y and the warps that split one item's ty steps.  Picks the
    tiles per warp with the fewest fragment loads per block and ty step
    (they bound the kernel): ``8 + 4 * nt`` per warp (A and B, big and
    small; one pass loads half as many, which picks the same split),
    divided over the warps that share an item and multiplied by the blocks
    that each stage the whole chunk; ties go to more tiles."""
    best = None
    for nt in _TILES_PER_WARP:
        n_items = n_mt * -(-n_ct // nt)
        ksplit = _WARPS // n_items if n_items <= _WARPS else 1
        grid_y = -(-n_items // _WARPS)
        cost = grid_y * (8 + 4 * nt) / ksplit
        if best is None or cost <= best[0]:
            best = (cost, dict(nt=nt, n_items=n_items, ipb=min(n_items, _WARPS),
                               ksplit=ksplit, grid_y=grid_y))
    return best[1]


def _b_conflicts(xp: int, xr: int, Ax: int, Ay: int, C2: int, n_ct: int) -> int:
    """Extra shared-memory wavefronts of one k step's B-fragment loads (one
    float per lane, 32 banks) over the column tiles (the first 64 stand for
    all), for X2 row pitch ``xp``."""
    a_sz, extra = Ax * Ay, 0
    for ct in range(min(n_ct, 64)):
        banks = {}
        for lane in range(32):
            col = ct * _TILE_N + (lane >> 2)
            c2, w = divmod(col, a_sz) if col < C2 * a_sz else (0, 0)
            addr = (c2 * xr + w // Ay) * xp + w % Ay + (lane & 3)
            banks.setdefault(addr % 32, set()).add(addr)
        extra += max(len(a) for a in banks.values()) - 1
    return extra


@functools.lru_cache(maxsize=256)
def _x_pitch(xw: int, xr: int, Ax: int, Ay: int, C2: int, n_ct: int) -> int:
    """The X2 row pitch (at least ``xw``, a multiple of 4 so that the shared
    planes stay 16-byte aligned) whose B-fragment loads have the fewest bank
    conflicts."""
    first = _round_up(xw, 4)
    pitches = range(first, first + 32, 4)
    return min(pitches, key=lambda p: (_b_conflicts(p, xr, Ax, Ay, C2, n_ct), p))


def _rows_per_block(M: int, split: dict, n_groups: int) -> int:
    """The most atoms one block stages: those of the row tiles its work
    items cover (all of them only when one block holds every item)."""
    rows = 0
    for y in range(split['grid_y']):
        first = y * split['ipb'] // n_groups
        last = (min((y + 1) * split['ipb'], split['n_items']) - 1) // n_groups
        rows = max(rows, min(M, _TILE_M * (last + 1)) - _TILE_M * first)
    return rows


def _pitches(planes: int, tc: int, Ty: int, xr: int, Ax: int, Ay: int, C2: int, n_ct: int,
             vec: bool):
    """``(hp, hw, xw, xp)`` choices for chunks of ``tc`` columns: an H row
    pitch of 4 mod 8 floats (A loads on distinct banks) and the X2 pitch
    with the fewest B-load conflicts; for the compact layout also the
    tightest pitches, with a narrow chunk of ``Ty < 8`` columns."""
    xw = _round_up(tc + Ay - 1, 4 if vec else 1)
    yield tc + 4, tc, xw, _x_pitch(xw, xr, Ax, Ay, C2, n_ct)
    if planes == 1:
        hw = Ty if Ty < _TILE_K else tc
        xw = _round_up(hw + Ay - 1, 4 if vec else 1)
        yield hw, hw, xw, xw


@functools.lru_cache(maxsize=256)
def _chunk(N: int, M: int, C2: int, Tx: int, Ty: int, Ax: int, Ay: int,
           n_sm: int, vec: bool, passes: int = 3) -> Optional[dict]:
    """Tiles, chunk sizes, work split, grid and shared memory of one launch
    over ``C2`` channels and ``Ax x Ay`` offsets: the split layout (raw,
    big and, for 3 passes, small planes) for two blocks per SM, else for
    one, else the compact layout (one plane, its tightest pitches last);
    ``None`` when no chunk fits."""
    n_mt = -(-M // _TILE_M)
    n_ct = -(-(C2 * Ax * Ay) // _TILE_N)  # over the flattened (c2, ax, ay)
    split = _warp_split(n_mt, n_ct)
    m_rows = _rows_per_block(M, split, -(-n_ct // split['nt']))
    n_cy = -(-Ty // _MAX_CHUNK_COLS)
    tc0 = _round_up(-(-Ty // n_cy), _TILE_K)  # near-equal chunks of whole MMA steps
    cols = [tc0] + [c for c in (64, 48, 32, 16, 8) if c < tc0]
    split_planes = 3 if passes == 3 else 2
    for planes, limit in ((split_planes, _SMEM_BUDGET), (split_planes, _build.MAX_SMEM_BYTES),
                          (1, _build.MAX_SMEM_BYTES)):
        for tr in sorted({min(r, Tx) for r in _CHUNK_ROWS}, reverse=True):
            for tc in cols:
                for hp, hw, xw, xp in _pitches(planes, tc, Ty, tr + Ax - 1, Ax, Ay, C2, n_ct,
                                               vec):
                    smem = 4 * planes * (tr * m_rows * hp + C2 * (tr + Ax - 1) * xp)
                    if smem > limit:
                        continue
                    n_chunks = N * -(-Tx // tr) * -(-Ty // tc)
                    blocks_per_sm = min(_BLOCKS_PER_SM, 233472 // (smem + 1024))
                    return dict(tile_rows=tr, tile_cols=tc, hp=hp, hw=hw, xw=xw, xp=xp,
                                planes=planes, passes=passes, smem_bytes=smem,
                                blocks_per_sm=blocks_per_sm,
                                **split, n_mt=n_mt, m_rows=m_rows, n_ct=n_ct,
                                col_pad=n_ct * _TILE_N - C2 * Ax * Ay, vec=4 if vec else 1,
                                n_chunks=n_chunks,
                                grid_x=max(1, min(n_chunks,
                                                  blocks_per_sm * n_sm // split['grid_y'])))
    return None


def _group_chunk(N: int, M: int, Tx: int, Ty: int, group: tuple, n_sm: int,
                 vec: bool, passes: int = 3) -> Optional[dict]:
    """:func:`_chunk` of one launch over ``group = (c_off, channels, a_off,
    rows, b_off, columns)`` of X2: its 16-byte copies need the group's first
    column at a multiple of 4 and whole vectors per row."""
    _, c2, _, ax, b_off, ay = group
    return _chunk(N, M, c2, Tx, Ty, ax, ay, n_sm,
                  vec and b_off % 4 == 0 and (Ty + ay - 1) % 4 == 0, passes)


@functools.lru_cache(maxsize=64)
def _geometry(N: int, M: int, C2: int, Tx: int, Ty: int, Ax: int, Ay: int,
              n_sm: int, vec: bool = True, passes: int = 3) -> dict:
    """The launches of the kernel for one problem: one over all of X2 when
    its chunk fits a block, else groups of it (:func:`_build.segments`; one
    atom column of one channel always fits).  Returns the first launch's
    geometry (:func:`_group_chunk`) with ``groups``, each launch's
    ``(c_off, channels, a_off, rows, b_off, columns)``."""
    def fits(c2, ax, ay):
        return _group_chunk(N, M, Tx, Ty, (0, c2, 0, ax, 0, ay), n_sm, vec, passes) is not None

    sc, sa, sb = _build.segments(C2, Ax, Ay, fits)
    groups = tuple((c0, min(sc, C2 - c0), a0, min(sa, Ax - a0), b0, min(sb, Ay - b0))
                   for c0 in range(0, C2, sc) for a0 in range(0, Ax, sa)
                   for b0 in range(0, Ay, sb))
    return dict(_group_chunk(N, M, Tx, Ty, groups[0], n_sm, vec, passes), groups=groups)


def _geometry_args(g: dict) -> ctypes.Array:
    """The geometry array of ``tnmf_grad_w``, in its order."""
    keys = ('tile_rows', 'tile_cols', 'hp', 'hw', 'xw', 'xp', 'n_ct', 'nt', 'n_items', 'ipb',
            'ksplit', 'm_rows', 'vec', 'planes', 'passes')
    return (ctypes.c_int * len(keys))(*(g[k] for k in keys))


def _group_args(group: tuple) -> ctypes.Array:
    """The group array of ``tnmf_grad_w``: ``(c_off, channels, a_off,
    rows, b_off, columns)``."""
    return (ctypes.c_int * 6)(*group)


def _shapes(X2: torch.Tensor, H: torch.Tensor) -> tuple:
    """``(T, A)``: the shift and atom shapes of one model's ``X2 (N, C2,
    *E)`` and ``H (N, M, *T)``, read from them (``A = E - T + 1``)."""
    T = tuple(H.shape[2:])
    A = tuple([e - t + 1 for e, t in zip(X2.shape[2:], T)])
    N, C2 = X2.shape[:2]
    if len(T) not in (1, 2):
        raise ValueError(f'grad_w: the kernel takes 1-D or 2-D shifts, got {len(T)}-D')
    if C2 % 2 or H.shape[0] != N or X2.dim() != H.dim() or min(A) < 1:
        raise ValueError(f'grad_w: X2 {tuple(X2.shape)} and H {tuple(H.shape)} '
                         'do not fit together')
    return T, A


def _launch(X2: torch.Tensor, H: torch.Tensor, T: tuple, A: tuple, passes: int,
            models: int, axis: bool = False) -> torch.Tensor:
    """The launches of the kernel for ``models`` stacked problems of
    ``(N, C2, *E)`` and ``(N, M, *T)`` each: ``out (2, models, M, C, *A)``
    over a model axis (``axis``, counted as such too), ``(2, M, C, *A)``
    for a single problem.  Counts them."""
    _build.check_inputs('grad_w', X2, H)
    N, C2 = X2.shape[-len(T) - 2:-len(T)]
    M = H.shape[-len(T) - 1]
    A_out = A
    if len(T) == 1:  # a 1-D problem is a 2-D one with one row
        T, A = (1,) + T, (1,) + A
    (Tx, Ty), (Ax, Ay) = T, A
    vec = Ty % 4 == 0 and (Ty + Ay - 1) % 4 == 0 and (X2.data_ptr() | H.data_ptr()) % 16 == 0
    n_sm = torch.cuda.get_device_properties(X2.device).multi_processor_count
    g = _geometry(N, M, C2, Tx, Ty, Ax, Ay, n_sm, vec, passes)
    C = C2 // 2
    out = torch.empty((2,) + ((models,) if axis else ()) + (M, C) + A_out, device=X2.device,
                      dtype=torch.float32)
    launches = [(grp, _group_chunk(N, M, Tx, Ty, grp, n_sm, vec, passes))
                for grp in g['groups']]
    scratch = torch.empty(models * max(gg['grid_x'] * gg['ksplit'] * M * grp[1] * grp[3] * grp[5]
                                       for grp, gg in launches),
                          device=X2.device, dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(X2.device):
        for grp, gg in launches:
            err = lib.tnmf_grad_w(
                X2.data_ptr(), H.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                N, M, C2, Tx, Ty, Ax, Ay, _geometry_args(gg), _group_args(grp), gg['grid_x'],
                gg['grid_y'], gg['smem_bytes'], models, _build.stream_of(X2))
            _build.check_launch(err, 'grad_w')
            grad_w.launches += 1
            grad_w.model_launches += axis
            if passes == 1:
                grad_w.one_pass_launches += 1
    return out


def grad_w(X2: torch.Tensor, H: torch.Tensor,
           passes: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(neg, pos)`` W-gradient statistics: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (float32, contiguous, 1-D or
    2-D shifts; the shapes are read from the tensors).  ``passes`` is the
    TF32 products per product: 3 (3xTF32, float32 accuracy) or 1 (one TF32
    pass, the TF32 precision levels)."""
    if passes not in (1, 3):
        raise ValueError(f'grad_w: passes must be 1 or 3, got {passes!r}')
    if X2.device.type == 'cpu':
        return grad_w_plain(X2, H, passes)
    out = _launch(X2, H, *_shapes(X2, H), passes, 1)
    return out[0], out[1]


def grad_w_models(X2: torch.Tensor, H: torch.Tensor,
                  passes: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`grad_w` over a model axis: ``X2 (S, N, C2, *E)`` and ``H
    (S, N, M, *T)`` stack a sweep's S models; returns ``(neg, pos)``, each
    ``(S, M, C, *A)``.  The plain version model by model for CPU tensors;
    on CUDA tensors one launch per group for all S models (the grid's z),
    each model summed in its own launch's order."""
    if passes not in (1, 3):
        raise ValueError(f'grad_w: passes must be 1 or 3, got {passes!r}')
    if X2.shape[0] != H.shape[0]:
        raise ValueError(f'grad_w: X2 {tuple(X2.shape)} and H {tuple(H.shape)} '
                         'stack different model counts')
    if X2.device.type == 'cpu':
        pairs = [grad_w_plain(X2[s], H[s], passes) for s in range(X2.shape[0])]
        return torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])
    out = _launch(X2, H, *_shapes(X2[0], H[0]), passes, X2.shape[0], axis=True)
    return out[0], out[1]


#: kernel launches since the last reset (plain counts, read by chip_smoke.py):
#: all of them, those over a model axis (:func:`grad_w_models`) and those of
#: the one-pass route
grad_w.launches = 0
grad_w.model_launches = 0
grad_w.one_pass_launches = 0
