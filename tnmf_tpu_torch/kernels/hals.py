"""K5: the Gauss-Seidel component sweep of the HALS solvers.

A kernel of the port with no Pallas counterpart: the JAX package runs the
sweep as one on-device ``lax.fori_loop`` of ``m`` dependent steps
(``tnmf_tpu/engine_hals.py:98``, ``_sweep_H``), which eager PyTorch would
run as about six launches per component.  :func:`hals_sweep` runs ``inner``
whole sweeps in one launch of ``tnmf_tpu_torch/csrc/hals_sweep.cu``; the
source says what bounds it and how it is laid out.

The same function serves every sweep of
:mod:`tnmf_tpu_torch.engine_hals` and :mod:`tnmf_tpu_torch.engine_hals_conv`:
the H sweep ``hals_sweep(H, W W^T, V W^T, ...)``, the W sweep
``hals_sweep(W^T, A^T, B^T, ...)^T`` (``A = H^T H``, ``B = H^T V``) and the
per-phase sweep of the shift-invariant solver on the rows ``(n*K, M)``.
The kernel reads and writes its operands through their strides, so the
transposed views launch as they are, with no copy, and the output takes
X's layout (``W^T``'s output is a transposed view of a contiguous ``(m,
F)`` tensor).

:func:`hals_sweep_models` runs a sweep's S models in one launch (the
model axis of ``tnmf::hals_sweep``'s vmap rule, :mod:`.ops`): each operand
is read through its own model, row and column strides (an operand the
models share at model stride 0), each model on the single launch's
geometry, so that each model's bits are those of its own launch.

:func:`hals_sweep_panels_plain` sums in the kernel's order (panel
products, then a running correlation inside each panel); the tests hold it
to :func:`hals_sweep_plain` and to the JAX package's sweep.
"""

from __future__ import annotations

import functools

import torch

from . import _build

#: threads per block, columns per panel, rows of ``G[:, J]`` per streamed
#: chunk and chunks in flight (``kThreads``, ``kPanel``, ``kChunk``,
#: ``kStages`` of the source)
THREADS, PANEL, CHUNK, STAGES = 128, 32, 32, 4
#: rows of X per block (16 row groups of 4, 2 or 1 rows in the panel
#: product), largest first
_ROWS_PER_BLOCK = (64, 32, 16)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The HALS solvers' matrix product, accumulating in at least float32
    (the JAX package's ``_dot``), through
    :func:`~tnmf_tpu_torch.kernels.ops.matmul`: under a sweep's vmap one
    product per model, so that each model has its single fit's bits (a
    batched product sums in another order: cuBLAS's rounded up to 17 times
    more, C2; MKL's on AVX-512 apart from its single products, C3;
    ROADMAP.md queue 3).  On the CPU a float32 product accumulates in
    float64 and rounds once, so that its bits do not hang on the BLAS's
    float32 summation order, which differs between MKL's instruction sets
    and from the JAX package's XLA dot (C3); the card keeps cuBLAS's
    float32 product at the pinned precision."""
    from .ops import matmul  # ops imports this module
    acc = torch.promote_types(torch.promote_types(a.dtype, b.dtype), torch.float32)
    work = torch.float64 if a.device.type == 'cpu' and acc == torch.float32 else acc
    return matmul(a.to(work), b.to(work)).to(acc)


def hals_sweep_plain(X: torch.Tensor, G: torch.Tensor, P: torch.Tensor, l1: float, l2: float,
                     inner: int) -> torch.Tensor:
    """The plain PyTorch version: the JAX package's ``_sweep_H``
    (``tnmf_tpu/engine_hals.py:98-121``) applied ``inner`` times, a loop
    over the components vectorised over the rows of ``X (rows, m)``.  For
    each component ``j``: ``u = P[:, j] - X @ G[:, j] + X[:, j] * G[j, j] -
    l1`` and ``X[:, j] = max(u / max(G[j, j] + l2, tiny), 0)``, kept as it
    was where ``G[j, j] + l2 <= 0`` (sklearn's ``hess != 0`` skip); ``tiny``
    is float32's smallest normal, the JAX ``_TINY``.  Each product ``X @
    G[:, j]`` is a :func:`dot`: model by model under a sweep's vmap, as
    K5's vmap rule runs the models, and in float64 on the CPU."""
    X = X.clone()
    tiny = torch.finfo(torch.float32).tiny
    for _ in range(int(inner)):
        for j in range(X.shape[1]):
            gjj = G[j, j]
            xj = X[:, j]
            u = P[:, j] - dot(X, G[:, j]) + xj * gjj - l1
            denom = gjj + l2
            new = torch.clamp(u / torch.clamp(denom, min=tiny), min=0.0)
            X[:, j] = torch.where(denom > 0, new, xj)
    return X


def hals_sweep_panels_plain(X: torch.Tensor, G: torch.Tensor, P: torch.Tensor, l1: float,
                            l2: float, inner: int, panel: int = PANEL) -> torch.Tensor:
    """:func:`hals_sweep_plain`'s function summed in K5's order: for each
    panel ``J`` of ``panel`` columns, the panel product ``S = P[:, J] - X
    @ G[:, J]`` with the current X, then the columns of the panel in turn,
    column ``j`` taking ``u = S[:, j] + X[:, j] * G[j, j] - l1`` and its
    change ``d`` updating ``S[:, k] -= d * G[j, k]`` for the panel's later
    columns.  For the tests; no path of the port runs it."""
    X = X.clone()
    tiny = torch.finfo(torch.float32).tiny
    m = X.shape[1]
    for _ in range(int(inner)):
        for j0 in range(0, m, panel):
            j1 = min(j0 + panel, m)
            S = P[:, j0:j1] - X @ G[:, j0:j1]
            for j in range(j0, j1):
                gjj = G[j, j]
                denom = gjj + l2
                if not denom > 0:  # dead component: the column keeps its values
                    continue
                xj = X[:, j].clone()
                u = S[:, j - j0] + xj * gjj - l1
                X[:, j] = torch.clamp(u / torch.clamp(denom, min=tiny), min=0.0)
                S[:, j - j0 + 1:] -= (X[:, j] - xj)[:, None] * G[j, j + 1:j1][None, :]
    return X


@functools.lru_cache(maxsize=None)
def _multiprocessors(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def smem_bytes(rows_per_block: int, m: int, resident: bool) -> int:
    """Dynamic shared memory of a launch (``required_smem`` in the source):
    the tile of X (``rows_per_block`` rows, pitch ``m`` rounded up to a
    chunk plus 4) or, streamed, one chunk of it; two panels of S; ``STAGES``
    chunks of ``G[:, J]`` and two blocks ``G[J, J]`` (pitch ``PANEL + 4``)."""
    mc = -(-m // CHUNK) * CHUNK
    xs = rows_per_block * (mc + 4) if resident else rows_per_block * (CHUNK + 4)
    return 4 * (xs + 2 * rows_per_block * (PANEL + 4) + (STAGES * CHUNK + 2 * PANEL) * (PANEL + 4))


def launch_geometry(rows: int, m: int, device: torch.device) -> dict:
    """The launch of ``rows x m``: ``rows_per_block``, the largest tile that
    fits shared memory and still gives every multiprocessor a block (else
    the smallest that fits); ``resident``, whether the tile stays in shared
    memory (where no tile fits, the largest that gives every multiprocessor
    a block streams through it); ``panel``, ``threads``, ``smem_bytes`` and
    ``blocks``."""
    sms = _multiprocessors(device)
    fits = [t for t in _ROWS_PER_BLOCK if smem_bytes(t, m, True) <= _build.MAX_SMEM_BYTES]
    fills = [t for t in _ROWS_PER_BLOCK if -(-rows // t) >= sms]
    if fits:
        rt = next((t for t in fits if t in fills), fits[-1])
    else:
        rt = next(iter(fills), _ROWS_PER_BLOCK[-1])
    return dict(rows_per_block=rt, resident=bool(fits), panel=PANEL, threads=THREADS,
                smem_bytes=smem_bytes(rt, m, bool(fits)), blocks=-(-rows // rt))


def launch_operands(X: torch.Tensor, G: torch.Tensor, P: torch.Tensor,
                    out: torch.Tensor) -> tuple:
    """The tensor arguments of the C entry, as the kernel reads them: each
    operand's address and its strides in elements (row and column; model,
    row and column over a model axis; no copy: a transposed view launches
    with its base's address)."""
    return tuple(v for t in (X, G, P, out) for v in (t.data_ptr(), *t.stride()))


def _check(X: torch.Tensor, G: torch.Tensor, P: torch.Tensor, inner: int) -> None:
    rows, m = X.shape[-2:]
    if G.shape[-2:] != (m, m) or P.shape[-2:] != X.shape[-2:]:
        raise ValueError(f'hals_sweep: X {tuple(X.shape)}, G {tuple(G.shape)} and P '
                         f'{tuple(P.shape)} do not fit')
    if int(inner) < 1:
        raise ValueError(f'hals_sweep: inner must be >= 1, got {inner!r}')


def hals_sweep(X: torch.Tensor, G: torch.Tensor, P: torch.Tensor, l1: float, l2: float,
               inner: int) -> torch.Tensor:
    """``inner`` Gauss-Seidel sweeps over the ``m`` columns of ``X (rows,
    m)`` (:func:`hals_sweep_plain`'s function): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (float32; ``G (m, m)``, ``P
    (rows, m)``, any strides), one launch for all the sweeps.  Returns
    ``(rows, m)`` in X's layout (``torch.empty_like``)."""
    if X.device.type == 'cpu':
        return hals_sweep_plain(X, G, P, l1, l2, inner)
    rows, m = X.shape
    _check(X, G, P, inner)
    _build.check_inputs('hals_sweep', X, G, P, contiguous=False)
    out = torch.empty_like(X)
    if X.numel() == 0:
        return out
    geo = launch_geometry(rows, m, X.device)
    lib = _build.library()
    with torch.cuda.device(X.device):
        err = lib.tnmf_hals_sweep(*launch_operands(X, G, P, out), float(l1), float(l2),
                                  int(inner), rows, m, geo['rows_per_block'],
                                  int(geo['resident']), geo['smem_bytes'],
                                  _build.stream_of(X))
    _build.check_launch(err, 'hals_sweep')
    hals_sweep.launches += 1
    return out


def _output(X: torch.Tensor) -> torch.Tensor:
    """The output of a launch over the model axis, ``(S, rows, m)``: each
    model's in X's layout, column-major where X's models are (the W side's
    transposed views), else row-major; never at model stride 0."""
    S, rows, m = X.shape
    if X.stride(1) == 1 and X.stride(2) != 1:
        return X.new_empty((S, m, rows)).transpose(1, 2)
    return X.new_empty((S, rows, m))


def hals_sweep_models(X: torch.Tensor, G: torch.Tensor, P: torch.Tensor, l1, l2,
                      inner: int) -> torch.Tensor:
    """:func:`hals_sweep` over a model axis: ``X (S, rows, m)``, ``G (S, m,
    m)`` and ``P (S, rows, m)`` stack a sweep's S models (any strides; an
    operand the models share at model stride 0, as ``expand`` makes it),
    ``l1`` and ``l2`` are ``(S,)`` tensors or floats for all.  The plain
    version model by model for CPU tensors; one launch for all S models on
    CUDA tensors, each model on the single launch's geometry and so
    bit-equal to its own :func:`hals_sweep` launch.  Returns ``(S, rows,
    m)``, each model in X's layout (:func:`_output`)."""
    S = X.shape[0]
    if G.shape[0] != S or P.shape[0] != S:
        raise ValueError(f'hals_sweep: X {tuple(X.shape)}, G {tuple(G.shape)} and P '
                         f'{tuple(P.shape)} stack different model counts')
    _check(X, G, P, inner)
    out = _output(X)
    if X.device.type == 'cpu':
        for s in range(S):
            out[s] = hals_sweep_plain(X[s], G[s], P[s], _build.model_value(l1, s),
                                      _build.model_value(l2, s), inner)
        return out
    _build.check_inputs('hals_sweep', X, G, P, contiguous=False)
    if S > 65535:
        raise ValueError(f'hals_sweep: at most 65535 models a launch, got {S}')
    if out.numel() == 0:
        return out
    rows, m = X.shape[1:]
    l1v, l2v = (_build.model_vector(x, S, X.device) for x in (l1, l2))
    geo = launch_geometry(rows, m, X.device)
    lib = _build.library()
    with torch.cuda.device(X.device):
        err = lib.tnmf_hals_sweep_models(
            *launch_operands(X, G, P, out), l1v.data_ptr(), l2v.data_ptr(), S, int(inner),
            rows, m, geo['rows_per_block'], int(geo['resident']), geo['smem_bytes'],
            _build.stream_of(X))
    _build.check_launch(err, 'hals_sweep')
    hals_sweep.launches += 1
    hals_sweep.model_launches += 1
    return out


#: kernel launches since the last reset (plain counts, read by chip_smoke.py):
#: all of them, and those over a model axis (:func:`hals_sweep_models`)
hals_sweep.launches = 0
hals_sweep.model_launches = 0
