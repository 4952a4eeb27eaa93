"""K3: the fused multiplicative H update.

Replaces ``tnmf_tpu/experimental/pallas_phased.py::mu_h``; the CUDA kernels
are in ``tnmf_tpu_torch/csrc/mu_h.cu``.  For the mode-extended data ``Vp``
and reconstruction ``Rx`` it computes

    H' = H * corr(Vp, W) / (corr(Rx, W) [+ pos_extra] + denom_add)

with both correlations and the ratio in one pass and float32 accumulation,
in the canonical ``(N, M, *T)`` layout (not the TPU kernel's phase-blocked
one).  The two gradient maps never reach device memory: only H is read and
H' written at activation size.

Per sample the update is a GEMM (atoms x ``C*Ax*Ay`` taps x positions):
23 GFLOP at the flagship (64 x 1 x 256 x 256, 16 atoms of 9 x 9).  Two
routes, chosen from the shapes before the launch (``_geometry``):

- ``'mma'``, the tensor-core route: an implicit GEMM on ``mma.sync``
  m16n8k8 TF32 with 3xTF32 splitting (full float32 accuracy at three
  tensor-core products per product: 69 GFLOP, 0.14 ms at 495 TFLOP/s, under
  the 0.18 ms its 609 MB take at 3.35 TB/s), or in one TF32 pass
  (``passes=1``, the TF32 precision levels: each operand rounded once,
  one product per product, no small planes, so larger chunks fit).  Rows are the atoms, k the
  flattened ``(c, ax, ay)`` taps padded to a multiple of 8, columns runs of
  8 ``ty`` positions; the B fragments are sliding-window reads of the staged
  Vp and Rx windows.  A persistent grid walks chunks of ``(n, tx rows, ty
  columns)`` holding every channel and atom: ``cp.async`` brings each into a
  raw plane during the previous chunk's MMAs, and the block splits it once
  into big and small TF32 planes.  Taken whenever the three planes and the
  split dictionary fit a block.
- ``'fma'``, the first port's FP32 kernel: 16 x 64 position tiles for 8
  atoms per block, its reduction streamed over the taps in segments that fit
  a block (:func:`_fma_geometry`), so it holds every shape the tensor-core
  route cannot.  A shape whose taps fit one segment runs the first port's
  kernel as it was.  It computes in float32 whatever ``passes`` says.

Every 1-D and 2-D shape takes one of the two; any number of samples
launches.

The model axis (:func:`mu_h_models`, a sweep's S models in one launch):
the models run along the grid's y on either route, each on the single
model's geometry.  Rx, W, H and ``pos_extra`` are per model, and so is
``denom_add`` (an ``(S,)`` vector read on the card); ``Vp`` is read at a
model stride of 0 where the models share it (the data stream at beta = 2
without a mask), so it is not copied S times.  The tensor-core route's
persistent blocks each serve one model: every block stages its model's
split dictionary once, as in a single launch (S times the single
launch's ``grid_x`` stagings in all, no restaging), and each model gets
its own launch's bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..ops import conv
from ..ops.precision import round_tf32
from . import _build

# the FP32 route's tiles; must match mu_h.cu (mu_h_kernel)
_TILE_X = 16
_TILE_Y = 64
_ATOMS_PER_BLOCK = 8

# the tensor-core route's tiles; must match mu_h.cu (mu_h_mma_kernel)
_TILE_M, _TILE_N, _TILE_K = 16, 8, 8  # mma.sync.m16n8k8
_TILES_PER_ITEM = 4                     # kNT: column tiles per work item
#: chunk rows along tx, in order of preference (8 warps, one row each)
_CHUNK_ROWS = (8, 4, 2, 1)
#: the most chunk columns along ty (11 column tiles)
_MAX_CHUNK_COLS = 88
#: blocks per SM the kernel is built for (``__launch_bounds__``); two
#: blocks' shared memory must fit the SM's 228 KB, 1 KB per block reserved
_BLOCKS_PER_SM = 2
_SMEM_BUDGET = (233472 - _BLOCKS_PER_SM * 1024) // _BLOCKS_PER_SM

#: the routes ``mu_h`` may take, in order of preference
_ROUTES = ('mma', 'fma')


def mu_h_plain(Vp: torch.Tensor, Rx: torch.Tensor, W: torch.Tensor,
               H: torch.Tensor, denom_add: float,
               pos_extra: Optional[torch.Tensor] = None, passes: int = 3) -> torch.Tensor:
    """The plain PyTorch version: the stacked ``corr_H`` convolution in full
    float32, then the ratio (the same order of operations as
    ``engine._mu_H``).  ``passes=1``, the one-pass route's plain version,
    first rounds the products' operands (the streams and W) to TF32 as the
    kernel does (:func:`~tnmf_tpu_torch.ops.precision.round_tf32`)."""
    if passes == 1:
        Vp, Rx, W = round_tf32(Vp), round_tf32(Rx), round_tf32(W)
    neg, pos = conv.grad_H_pair_prepared(Vp, Rx, W)
    if pos_extra is not None:
        pos = pos + pos_extra
    return H * neg / (pos + denom_add)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _fma_smem(sc: int, sa: int, sb: int) -> tuple:
    """Window pitch and shared memory (bytes) of an FP32-route segment of
    ``sc`` channels, ``sa`` atom rows and ``sb`` atom columns."""
    xw = _TILE_Y + sb - 1
    pitch = xw + (16 - xw) % 32  # 16 mod 32: a warp's two rows hit disjoint banks
    return pitch, 4 * (2 * sc * (_TILE_X + sa - 1) * pitch + sc * sa * sb * _ATOMS_PER_BLOCK)


def _fma_geometry(C: int, Ax: int, Ay: int) -> dict:
    """Segment (:func:`_build.segments`), window pitch and shared memory of
    the FP32 route: one segment of all the taps, the first port's kernel,
    whenever they fit a block."""
    sc, sa, sb = _build.segments(
        C, Ax, Ay, lambda *seg: _fma_smem(*seg)[1] <= _build.MAX_SMEM_BYTES)
    pitch, smem = _fma_smem(sc, sa, sb)
    return dict(pitch=pitch, smem_bytes=smem, seg_c=sc, seg_ax=sa, seg_ay=sb,
                n_segments=-(-C // sc) * -(-Ax // sa) * -(-Ay // sb))


def mu_h_segments_plain(Vp: torch.Tensor, Rx: torch.Tensor, W: torch.Tensor,
                        H: torch.Tensor, denom_add: float, segment: tuple,
                        pos_extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The FP32 route's sums in its own order: segment by segment of
    ``segment = (channels, atom rows, atom columns)`` taps, and tap by tap
    ``(c, ax, ay)`` within each, every product added to one running sum per
    output.  The comparator of the streamed kernel; slow (two tensor
    operations per tap)."""
    if H.dim() == 3:  # a 1-D problem is a 2-D one with one row
        Vp, Rx, W, H = Vp[:, :, None], Rx[:, :, None], W[:, :, None], H[:, :, None]
        pos_extra = None if pos_extra is None else pos_extra[:, :, None]
        return mu_h_segments_plain(Vp, Rx, W, H, denom_add, segment, pos_extra)[:, :, 0]
    _, C, Ax, Ay = W.shape
    Tx, Ty = H.shape[2:]
    sc, sa, sb = segment
    neg, pos = torch.zeros_like(H), torch.zeros_like(H)
    for c0 in range(0, C, sc):
        for a0 in range(0, Ax, sa):
            for b0 in range(0, Ay, sb):
                for c in range(c0, min(c0 + sc, C)):
                    for a in range(a0, min(a0 + sa, Ax)):
                        for b in range(b0, min(b0 + sb, Ay)):
                            w = W[None, :, c, a, b, None, None]
                            neg += w * Vp[:, None, c, a:a + Tx, b:b + Ty]
                            pos += w * Rx[:, None, c, a:a + Tx, b:b + Ty]
    if pos_extra is not None:
        pos = pos + pos_extra
    return H * neg / (pos + denom_add)


def _tap_offsets(xp: int, xr: int, C: int, Ax: int, Ay: int, n_taps: int) -> list:
    """Where each of the first ``n_taps`` (padded) taps ``(c, ax, ay)``
    starts in a staged window of ``xr`` rows of pitch ``xp`` (as
    ``tap_offset`` in mu_h.cu: 0 past the last tap)."""
    a_sz, taps = Ax * Ay, C * Ax * Ay
    return [((k // a_sz) * xr + k % a_sz // Ay) * xp + k % Ay if k < taps else 0
            for k in range(n_taps)]


def _b_conflicts(xp: int, xr: int, C: int, Ax: int, Ay: int, ks: int) -> int:
    """Extra shared-memory wavefronts of the B-fragment loads (lane (g, tig)
    reads tap ``8 st + tig`` (+ 4) at column ``g``; 32 banks) over the k
    steps (the first 64 stand for all), for window row pitch ``xp``."""
    off, extra = _tap_offsets(xp, xr, C, Ax, Ay, 8 * min(ks, 64)), 0
    for st in range(min(ks, 64)):
        for half in (0, 4):
            banks = {}
            for lane in range(32):
                addr = off[8 * st + (lane & 3) + half] + (lane >> 2)
                banks.setdefault(addr % 32, set()).add(addr)
            extra += max(len(a) for a in banks.values()) - 1
    return extra


@functools.lru_cache(maxsize=256)
def _x_pitch(xw: int, xr: int, C: int, Ax: int, Ay: int, ks: int) -> int:
    """The window row pitch (at least ``xw``, a multiple of 4 so that the
    windows stay 16-byte aligned) whose B-fragment loads have the fewest
    bank conflicts."""
    first = _round_up(xw, 4)
    return min(range(first, first + 32, 4),
               key=lambda p: (_b_conflicts(p, xr, C, Ax, Ay, ks), p))


def _mma_geometry(N: int, M: int, C: int, Tx: int, Ty: int, Ax: int, Ay: int,
                  n_sm: int, vec: bool, passes: int = 3) -> Optional[dict]:
    """Chunk, pitches, work split, grid and shared memory of the tensor-core
    route: the largest chunk whose window planes (raw, big and, for 3
    passes, small) and split dictionary fit two blocks per SM, else one;
    ``None`` when none fits a block."""
    ks = -(-(C * Ax * Ay) // _TILE_K)
    n_mt = -(-M // _TILE_M)
    halves = 2 if passes == 3 else 1  # the TF32 halves staged: big (and small)
    fixed = halves * n_mt * ks * _TILE_M * _TILE_K + 8 * ks  # A fragments; offsets
    n_cy = -(-Ty // _MAX_CHUNK_COLS)
    tc0 = _round_up(-(-Ty // n_cy), _TILE_N)  # near-equal chunks of whole column tiles
    cols = [tc0] + [c for c in (64, 48, 32, 16, 8) if c < tc0]
    for limit in (_SMEM_BUDGET, _build.MAX_SMEM_BYTES):
        for tr in sorted({min(r, Tx) for r in _CHUNK_ROWS}, reverse=True):
            for tc in cols:
                xr = tr + Ax - 1
                xw = _round_up(tc + Ay - 1, 4 if vec else 1)
                xp = _x_pitch(xw, xr, C, Ax, Ay, ks)
                smem = 4 * (fixed + (1 + halves) * 2 * C * xr * xp)  # raw and the halves
                if smem > limit:
                    continue
                n_chunks = N * -(-Tx // tr) * -(-Ty // tc)
                blocks_per_sm = min(_BLOCKS_PER_SM, 233472 // (smem + 1024))
                return dict(route='mma', tile_rows=tr, tile_cols=tc, xr=xr, xw=xw, xp=xp,
                            ks=ks, n_mt=n_mt,
                            n_groups=-(-(tc // _TILE_N) // _TILES_PER_ITEM),
                            vec=4 if vec else 1, passes=passes, smem_bytes=smem,
                            blocks_per_sm=blocks_per_sm, n_chunks=n_chunks,
                            grid_x=max(1, min(n_chunks, blocks_per_sm * n_sm)))
    return None


@functools.lru_cache(maxsize=256)
def _geometry(N: int, M: int, C: int, Tx: int, Ty: int, Ax: int, Ay: int, n_sm: int,
              vec: bool = True, routes: tuple = _ROUTES, passes: int = 3) -> dict:
    """The route and its geometry for one problem: the tensor-core route
    (in ``passes`` TF32 passes) when its chunk fits a block (and ``routes``
    offers it), else the streamed FP32 route, which holds every shape."""
    if 'mma' in routes:
        g = _mma_geometry(N, M, C, Tx, Ty, Ax, Ay, n_sm, vec, passes)
        if g is not None:
            return g
    return dict(route='fma', **_fma_geometry(C, Ax, Ay))


def _mma_args(g: dict, pair: bool) -> ctypes.Array:
    """The geometry array of ``tnmf_mu_h_mma``, in its order."""
    vals = [g[k] for k in ('tile_rows', 'tile_cols', 'xr', 'xw', 'xp', 'ks', 'n_mt',
                           'n_groups', 'vec')] + [int(pair), g['passes']]
    return (ctypes.c_int * len(vals))(*vals)


def launch_geometry(Vp: torch.Tensor, Rx: torch.Tensor, W: torch.Tensor,
                    H: torch.Tensor, passes: int = 3) -> tuple:
    """``((Tx, Ty), (Ax, Ay), geometry)`` of a launch on these CUDA tensors
    in ``passes`` TF32 passes, with the route it takes; a 1-D problem is a
    2-D one with one row."""
    N, M = H.shape[:2]
    C = W.shape[1]
    T, A = tuple(H.shape[2:]), tuple(W.shape[2:])
    if len(T) == 1:
        T, A = (1,) + T, (1,) + A
    (Tx, Ty), (Ax, Ay) = T, A
    vec = (Ty + Ay - 1) % 4 == 0 and (Vp.data_ptr() | Rx.data_ptr()) % 16 == 0
    n_sm = torch.cuda.get_device_properties(H.device).multi_processor_count
    return T, A, _geometry(N, M, C, Tx, Ty, Ax, Ay, n_sm, vec, _ROUTES, passes)


def _check(Vp: torch.Tensor, Rx: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
           pos_extra: Optional[torch.Tensor]) -> None:
    """Raise unless one model's operands fit together."""
    nd = H.dim() - 2
    if nd not in (1, 2):
        raise ValueError(f'mu_h: the kernel takes 1-D or 2-D shifts, got {nd}-D')
    N, M = H.shape[:2]
    T, A = tuple(H.shape[2:]), tuple(W.shape[2:])
    if (Vp.shape != Rx.shape or tuple(Vp.shape[:2]) != (N, W.shape[1]) or W.shape[0] != M
            or tuple(Vp.shape[2:]) != tuple(t + a - 1 for t, a in zip(T, A))
            or (pos_extra is not None and pos_extra.shape != H.shape)):
        raise ValueError(
            f'mu_h: shapes Vp {tuple(Vp.shape)}, Rx {tuple(Rx.shape)}, '
            f'W {tuple(W.shape)}, H {tuple(H.shape)} do not fit together')


def _launch(Vp: torch.Tensor, Rx: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
            denom_add: float, denoms: Optional[torch.Tensor],
            pos_extra: Optional[torch.Tensor], passes: int, models: int = 1,
            vp_model_stride: int = 0) -> torch.Tensor:
    """One launch: a single problem with ``denom_add``, or (``denoms``
    given, one per model) ``models`` problems whose operands have a leading
    model axis, ``Vp`` at ``vp_model_stride`` (0 where shared); the route
    and geometry of one model's.  Counts it (``denoms``: as a launch over a
    model axis too)."""
    Vp1, Rx1, W1, H1 = ((Vp, Rx, W, H) if denoms is None
                        else (Vp[0] if vp_model_stride else Vp, Rx[0], W[0], H[0]))
    (Tx, Ty), (Ax, Ay), g = launch_geometry(Vp1, Rx1, W1, H1, passes)
    N, M = H1.shape[:2]
    C = W1.shape[1]
    out = torch.empty_like(H)
    pe = None if pos_extra is None else pos_extra.data_ptr()
    dp = None if denoms is None else denoms.data_ptr()
    lib = _build.library()
    with torch.cuda.device(H.device):
        if g['route'] == 'mma':
            pair = Ty % 2 == 0 and (H.data_ptr() | out.data_ptr() | (pe or 0)) % 8 == 0
            err = lib.tnmf_mu_h_mma(
                Vp.data_ptr(), Rx.data_ptr(), W.data_ptr(), H.data_ptr(), pe,
                float(denom_add), out.data_ptr(), N, M, C, Tx, Ty, Ax, Ay,
                _mma_args(g, pair), g['grid_x'], g['smem_bytes'], dp, models,
                vp_model_stride, _build.stream_of(H))
        else:
            err = lib.tnmf_mu_h(
                Vp.data_ptr(), Rx.data_ptr(), W.data_ptr(), H.data_ptr(), pe,
                float(denom_add), out.data_ptr(), N, M, C, Tx + Ax - 1, Ty + Ay - 1,
                Tx, Ty, Ax, Ay, g['pitch'], g['seg_c'], g['seg_ax'], g['seg_ay'],
                g['smem_bytes'], dp, models, vp_model_stride, _build.stream_of(H))
    _build.check_launch(err, 'mu_h')
    mu_h.launches += 1
    mu_h.model_launches += denoms is not None
    if g['route'] == 'mma' and passes == 1:
        mu_h.one_pass_launches += 1
    return out


def mu_h(Vp: torch.Tensor, Rx: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
         denom_add: float, pos_extra: Optional[torch.Tensor] = None,
         passes: int = 3) -> torch.Tensor:
    """Fused H update: the plain version for CPU tensors, a CUDA kernel for
    CUDA tensors (float32, contiguous, 1-D or 2-D shifts).  ``passes`` is
    the tensor-core route's TF32 products per product: 3 (3xTF32, float32
    accuracy) or 1 (one TF32 pass, the TF32 precision levels)."""
    if passes not in (1, 3):
        raise ValueError(f'mu_h: passes must be 1 or 3, got {passes!r}')
    if Vp.device.type == 'cpu':
        return mu_h_plain(Vp, Rx, W, H, denom_add, pos_extra, passes)
    extra = () if pos_extra is None else (pos_extra,)
    _build.check_inputs('mu_h', Vp, Rx, W, H, *extra)
    _check(Vp, Rx, W, H, pos_extra)
    return _launch(Vp, Rx, W, H, denom_add, None, pos_extra, passes)


def mu_h_models(Vp: torch.Tensor, Rx: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                denom_add, pos_extra: Optional[torch.Tensor] = None,
                passes: int = 3) -> torch.Tensor:
    """:func:`mu_h` over a model axis: ``Rx (S, N, C, *E)``, ``W (S, M, C,
    *A)``, ``H`` and ``pos_extra`` ``(S, N, M, *T)`` stack a sweep's S
    models, ``denom_add`` is an ``(S,)`` tensor (or one float for all) and
    ``Vp`` is either shared, ``(N, C, *E)``, or per model.  The plain
    version model by model for CPU tensors; one launch for all S models
    on CUDA tensors, each model bit-equal to its own :func:`mu_h` launch."""
    if passes not in (1, 3):
        raise ValueError(f'mu_h: passes must be 1 or 3, got {passes!r}')
    S = H.shape[0]
    shared = Vp.dim() == H.dim() - 1
    if Vp.device.type == 'cpu':
        return torch.stack([
            mu_h_plain(Vp if shared else Vp[s], Rx[s], W[s], H[s],
                       _build.model_value(denom_add, s),
                       None if pos_extra is None else pos_extra[s], passes)
            for s in range(S)])
    extra = () if pos_extra is None else (pos_extra,)
    _build.check_inputs('mu_h', Vp, Rx, W, H, *extra)
    if Rx.shape[0] != S or W.shape[0] != S or not (shared or Vp.shape[0] == S):
        raise ValueError(f'mu_h: Vp {tuple(Vp.shape)}, Rx {tuple(Rx.shape)}, '
                         f'W {tuple(W.shape)} and H {tuple(H.shape)} stack different '
                         'model counts')
    _check(Vp if shared else Vp[0], Rx[0], W[0], H[0],
           None if pos_extra is None else pos_extra[0])
    denoms = _build.model_vector(denom_add, S, H.device)
    return _launch(Vp, Rx, W, H, 0., denoms, pos_extra, passes, S,
                   0 if shared else Vp[0].numel())


#: kernel launches since the last reset (plain counts, read by chip_smoke.py):
#: all of them, those over a model axis (:func:`mu_h_models`) and those of
#: the tensor-core route in one pass
mu_h.launches = 0
mu_h.model_launches = 0
mu_h.one_pass_launches = 0
