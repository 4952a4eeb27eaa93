"""The kernels of the MU step as PyTorch custom operators.

``tnmf::mu_ratio`` (K1's ratio), ``tnmf::mu_h`` (K3), ``tnmf::inhibited_mu_h``
(K4), ``tnmf::inhibited_mu_h_summed`` (K4's summed route, the cross-atom
term under a mesh over the atoms; no vmap rule: sweeps under a mesh are
not ported) and ``tnmf::hals_sweep`` (K5) are defined in the ``tnmf`` operator
library when this module is imported (the package imports it), so that
``torch.export`` can hold them: a traced program keeps each as one opaque
node, and the serving artifact (:mod:`tnmf_tpu_torch.serving`) calls them
when it runs.  Each operator's kernel, registered for every device, is the
kernel's own wrapper, which runs the plain version on CPU tensors and the
CUDA kernel on CUDA tensors and counts its launches there; its fake gives
the output's shape, dtype and strides without running it.  No operator
mutates or aliases its inputs.  Nothing is built at import: the wrappers
build the kernel library at their first launch.

The operators are defined through :class:`torch.library.Library`, not
:func:`torch.library.custom_op`: a call then costs one dispatch to the
Python kernel, where ``custom_op`` wraps each call in layers of its own
and imports ``torch._dynamo`` at the first one, and the shift-invariant
HALS sweep, 81 K5 calls an iteration, is bound by the host's rate of
calls.  The kernels look the wrappers up at each call, so a wrapper
replaced on its module is the one the operator runs.

The model axis (the sweeps, :mod:`tnmf_tpu_torch.models.sweep`): the MU
step's operators, K1's W epilogue ``tnmf::mu_w`` and K2 ``tnmf::grad_w``
beside them, and K5 ``tnmf::hals_sweep`` each have a
:func:`torch.library.register_vmap` rule, so that under
:func:`torch.func.vmap` over a sweep's S models each makes one launch of
the kernel's model-axis wrapper (``*_models``, or K1's wrappers with
``model_axis=True``) for all of them, never S launches.  A ``float``
argument cannot carry a per-model value, so per-model strengths come as
tensors through the ``.t`` overloads (``tnmf::mu_ratio.t``,
``tnmf::mu_h.t``, ``tnmf::inhibited_mu_h.t``, ``tnmf::hals_sweep.t``); the
default overloads keep their schemas, so that exported programs load and
compute as before.  A ``.t`` call outside vmap is a model axis of one.  A
rule materialises every per-model operand with the model axis first and
contiguous (an operand the vmap does not batch is broadcast), except
K3's ``Vp``, which the kernel reads at a model stride of 0 when the models
share it, and K5's operands, which it reads through their strides as they
are (the W side's transposed views with no copy, and on its column-major
G route; an operand the models share at model stride 0).  On CPU tensors
the model-axis wrappers run the plain version over the models.

The HALS sweeps' products (:func:`tnmf_tpu_torch.kernels.hals.dot`: the
Grams, the energy's and the plain sweep's) go through ``tnmf::matmul``, a
plain ``torch.matmul`` whose vmap rule forms one product per model rather
than one batched product: each model's products then have its single
fit's bits, where a batched product sums in another order (cuBLAS's
rounding, amplified by the nearly rank-one W-side Gram of plain NMF,
moved the sweep's models 0.17 off float64; MKL's on AVX-512 rounds apart
from its single products too: ROADMAP.md queue 3, C2 and C3).

The engine calls the kernels through the functions below, which keep the
wrappers' signatures (and pick the ``.t`` overload when a strength is a
tensor), so that a fit, a sweep and a loaded artifact run one code path.
The W step's two (``mu_w``, ``grad_w``) take the operator only for
batched tensors, under vmap; a single fit calls their wrappers directly,
since a host-bound fit pays for each dispatch.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import gw as _gw
from . import hals as _hals
from . import inhibit as _inhibit
from . import mu as _mu
from . import mu_h as _mu_h

_LIB = torch.library.Library('tnmf', 'DEF')  # kept alive: it owns the definitions


def _define(schema: str, kernel, fake) -> None:
    name = schema.split('(', 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, kernel, 'CompositeExplicitAutograd')
    torch.library.register_fake(f'tnmf::{name}', fake, lib=_LIB)


def _hals_sweep_fake(X, G, P, l1, l2, inner):
    # the kernel's output and the plain version's clone both take X's layout
    return torch.empty_like(X)


def _like_first(x, *args):
    return torch.empty_like(x)


def _like_fourth(Vp, Rx, W, H, *args):
    return torch.empty_like(H)


def _grad_w_fake(X2, H, passes=3):
    c, m = X2.shape[1] // 2, H.shape[1]
    shape = (m, c) + tuple(e - t + 1 for e, t in zip(X2.shape[2:], H.shape[2:]))
    return X2.new_empty(shape), X2.new_empty(shape)


def _one(x):
    """A per-model strength of one model: ``(1,)``."""
    return x.reshape(1)


_define('mu_ratio(Tensor arr, Tensor neg, Tensor pos, float reg) -> Tensor',
        lambda *args: _mu.mu_ratio(*args), _like_first)
_define('mu_ratio.t(Tensor arr, Tensor neg, Tensor pos, Tensor reg) -> Tensor',
        lambda arr, neg, pos, reg:
        _mu.mu_ratio(arr[None], neg[None], pos[None], _one(reg), True)[0], _like_first)
# ``passes`` (K3's TF32 passes) defaults to 3, so that a program exported
# before it existed calls the 3xTF32 route as it did
_define('mu_h(Tensor Vp, Tensor Rx, Tensor W, Tensor H, float denom_add, '
        'Tensor? pos_extra, int passes=3) -> Tensor',
        lambda *args: _mu_h.mu_h(*args), _like_fourth)
_define('mu_h.t(Tensor Vp, Tensor Rx, Tensor W, Tensor H, Tensor denom_add, '
        'Tensor? pos_extra, int passes=3) -> Tensor',
        lambda Vp, Rx, W, H, denom_add, pos_extra, passes=3:
        _mu_h.mu_h_models(Vp, Rx[None], W[None], H[None], _one(denom_add),
                          None if pos_extra is None else pos_extra[None], passes)[0],
        _like_fourth)
_define('inhibited_mu_h(Tensor H, Tensor neg, Tensor pos, Tensor[] kernels, float inhibition, '
        'float cross_inhibition, float reg, bool use_same, bool use_cross) -> Tensor',
        lambda H, neg, pos, kernels, inhibition, cross, reg, use_same, use_cross:
        _inhibit.inhibited_mu_h(H, neg, pos, kernels, inhibition, cross, reg,
                                use_same=use_same, use_cross=use_cross),
        _like_first)
_define('inhibited_mu_h.t(Tensor H, Tensor neg, Tensor pos, Tensor[] kernels, '
        'Tensor inhibition, Tensor cross_inhibition, Tensor reg, bool use_same, '
        'bool use_cross) -> Tensor',
        lambda H, neg, pos, kernels, inhibition, cross, reg, use_same, use_cross:
        _inhibit.inhibited_mu_h_models(H[None], neg[None], pos[None], kernels,
                                       _one(inhibition), _one(cross), _one(reg),
                                       use_same=use_same, use_cross=use_cross)[0],
        _like_first)
_define('inhibited_mu_h_summed(Tensor H, Tensor neg, Tensor pos, Tensor[] kernels, '
        'float inhibition, float cross_inhibition, float reg, Tensor h_sum, int n_total, '
        'bool use_same) -> Tensor',
        lambda H, neg, pos, kernels, inhibition, cross, reg, h_sum, n_total, use_same:
        _inhibit.inhibited_mu_h_summed(H, neg, pos, kernels, inhibition, cross, reg, h_sum,
                                       n_total, use_same=use_same),
        _like_first)
_define('mu_w(Tensor W, Tensor neg, Tensor pos, float reg, int n_shift_axes) -> Tensor',
        lambda *args: _mu.mu_w(*args), _like_first)
_define('grad_w(Tensor X2, Tensor H, int passes=3) -> (Tensor, Tensor)',
        lambda X2, H, passes=3: _gw.grad_w(X2, H, passes), _grad_w_fake)
# the HALS sweeps' Gram products: a plain matrix product, defined as an
# operator only for its vmap rule, which forms each model's product alone
_define('matmul(Tensor a, Tensor b) -> Tensor', lambda a, b: torch.matmul(a, b),
        lambda a, b: a.new_empty(tuple(a.shape[:-1]) + tuple(b.shape[-1:])))
_define('hals_sweep(Tensor X, Tensor G, Tensor P, float l1, float l2, int inner) -> Tensor',
        lambda *args: _hals.hals_sweep(*args), _hals_sweep_fake)
_define('hals_sweep.t(Tensor X, Tensor G, Tensor P, Tensor l1, Tensor l2, int inner) -> Tensor',
        lambda X, G, P, l1, l2, inner:
        _hals.hals_sweep_models(X[None], G[None], P[None], _one(l1), _one(l2), inner)[0],
        _hals_sweep_fake)

mu_ratio_op = torch.ops.tnmf.mu_ratio.default
mu_ratio_t_op = torch.ops.tnmf.mu_ratio.t
mu_h_op = torch.ops.tnmf.mu_h.default
mu_h_t_op = torch.ops.tnmf.mu_h.t
inhibited_mu_h_op = torch.ops.tnmf.inhibited_mu_h.default
inhibited_mu_h_t_op = torch.ops.tnmf.inhibited_mu_h.t
inhibited_mu_h_summed_op = torch.ops.tnmf.inhibited_mu_h_summed.default
mu_w_op = torch.ops.tnmf.mu_w.default
grad_w_op = torch.ops.tnmf.grad_w.default
hals_sweep_op = torch.ops.tnmf.hals_sweep.default
hals_sweep_t_op = torch.ops.tnmf.hals_sweep.t
matmul_op = torch.ops.tnmf.matmul.default


# --------------------------------------------------------------- vmap rules

def _stack(x: torch.Tensor, dim, S: int) -> torch.Tensor:
    """``x`` with its model axis first, contiguous (broadcast over the S
    models where the vmap does not batch it)."""
    x = x.expand((S,) + tuple(x.shape)) if dim is None else x.movedim(dim, 0)
    return x.contiguous()


def _strength(x, dim, S: int):
    """A strength for a model-axis wrapper: a float as it is, a tensor as
    its ``(S,)`` vector."""
    if not isinstance(x, torch.Tensor):
        return x
    return x.expand(S) if dim is None else x.movedim(dim, 0).reshape(S)


def _mu_ratio_vmap(info, in_dims, arr, neg, pos, reg):
    S = info.batch_size
    return _mu.mu_ratio(_stack(arr, in_dims[0], S), _stack(neg, in_dims[1], S),
                        _stack(pos, in_dims[2], S), _strength(reg, in_dims[3], S), True), 0


def _mu_h_vmap(info, in_dims, Vp, Rx, W, H, denom_add, pos_extra, passes=3):
    S = info.batch_size
    Vp = Vp.contiguous() if in_dims[0] is None else _stack(Vp, in_dims[0], S)
    pe = None if pos_extra is None else _stack(pos_extra, in_dims[5], S)
    return _mu_h.mu_h_models(Vp, _stack(Rx, in_dims[1], S), _stack(W, in_dims[2], S),
                             _stack(H, in_dims[3], S), _strength(denom_add, in_dims[4], S),
                             pe, passes), 0


def _inhibited_mu_h_vmap(info, in_dims, H, neg, pos, kernels, inhibition, cross, reg,
                         use_same, use_cross):
    S = info.batch_size
    if any(d is not None for d in in_dims[3]):
        raise NotImplementedError('inhibited_mu_h: the inhibition taps take no model axis')
    return _inhibit.inhibited_mu_h_models(
        _stack(H, in_dims[0], S), _stack(neg, in_dims[1], S), _stack(pos, in_dims[2], S),
        kernels, _strength(inhibition, in_dims[4], S), _strength(cross, in_dims[5], S),
        _strength(reg, in_dims[6], S), use_same=use_same, use_cross=use_cross), 0


def _mu_w_vmap(info, in_dims, W, neg, pos, reg, n_shift_axes):
    S = info.batch_size
    return _mu.mu_w(_stack(W, in_dims[0], S), _stack(neg, in_dims[1], S),
                    _stack(pos, in_dims[2], S), reg, n_shift_axes, True), 0


def _grad_w_vmap(info, in_dims, X2, H, passes=3):
    S = info.batch_size
    return _gw.grad_w_models(_stack(X2, in_dims[0], S), _stack(H, in_dims[1], S), passes), (0, 0)


def _hals_sweep_vmap(info, in_dims, X, G, P, l1, l2, inner):
    # the operands' strides as they are, not _stack's copies: the W side's
    # transposed views launch as they are (K5's column-major G route), and
    # an operand the vmap does not batch is read at model stride 0
    S = info.batch_size

    def models(x, dim):
        return x.expand((S,) + tuple(x.shape)) if dim is None else x.movedim(dim, 0)
    return _hals.hals_sweep_models(models(X, in_dims[0]), models(G, in_dims[1]),
                                   models(P, in_dims[2]), _strength(l1, in_dims[3], S),
                                   _strength(l2, in_dims[4], S), inner), 0


def _matmul_vmap(info, in_dims, a, b):
    # one product per model, each on that model's operands as a single fit
    # holds them (a model's slice keeps the single operand's strides), so
    # that every model's Gram has the bits of its single fit's; a batched
    # product sums in another order and rounds up to 17 times more
    S = info.batch_size
    aa, bb = ((x,) * S if dim is None else x.unbind(dim) for x, dim in zip((a, b), in_dims))
    return torch.stack([torch.matmul(x, y) for x, y in zip(aa, bb)]), 0


for _name, _rule in (('mu_ratio', _mu_ratio_vmap), ('mu_ratio.t', _mu_ratio_vmap),
                     ('mu_h', _mu_h_vmap), ('mu_h.t', _mu_h_vmap),
                     ('inhibited_mu_h', _inhibited_mu_h_vmap),
                     ('inhibited_mu_h.t', _inhibited_mu_h_vmap),
                     ('mu_w', _mu_w_vmap), ('grad_w', _grad_w_vmap),
                     ('hals_sweep', _hals_sweep_vmap), ('hals_sweep.t', _hals_sweep_vmap),
                     ('matmul', _matmul_vmap)):
    torch.library.register_vmap(f'tnmf::{_name}', _rule, lib=_LIB)


# ----------------------------------------------------- the engine's calls

#: whether a tensor is one that :func:`torch.func.vmap` batches
_batched = torch._C._functorch.is_batchedtensor


def _as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    """A strength as a tensor in ``like``'s dtype and on its device."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(float(x), dtype=like.dtype, device=like.device)


def mu_ratio(arr: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor, reg) -> torch.Tensor:
    """:func:`tnmf_tpu_torch.kernels.mu.mu_ratio` through ``tnmf::mu_ratio``
    (``.t`` for a tensor ``reg``)."""
    if isinstance(reg, torch.Tensor):
        return mu_ratio_t_op(arr, neg, pos, reg)
    return mu_ratio_op(arr, neg, pos, float(reg))


def mu_h(Vp: torch.Tensor, Rx: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
         denom_add, pos_extra: torch.Tensor | None = None,
         passes: int = 3) -> torch.Tensor:
    """:func:`tnmf_tpu_torch.kernels.mu_h.mu_h` through ``tnmf::mu_h``
    (``.t`` for a tensor ``denom_add``)."""
    if isinstance(denom_add, torch.Tensor):
        return mu_h_t_op(Vp, Rx, W, H, denom_add, pos_extra, int(passes))
    return mu_h_op(Vp, Rx, W, H, float(denom_add), pos_extra, int(passes))


def inhibited_mu_h(H: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor, kernels: Sequence,
                   inhibition, cross_inhibition, reg, *,
                   use_same: bool = True, use_cross: bool = False) -> torch.Tensor:
    """:func:`tnmf_tpu_torch.kernels.inhibit.inhibited_mu_h` through
    ``tnmf::inhibited_mu_h`` (the taps as a list of tensors; ``.t`` when a
    strength is a tensor)."""
    kernels = [torch.as_tensor(k) for k in kernels]
    if (isinstance(inhibition, torch.Tensor) or isinstance(cross_inhibition, torch.Tensor)
            or isinstance(reg, torch.Tensor)):
        return inhibited_mu_h_t_op(H, neg, pos, kernels, _as_tensor(inhibition, H),
                                   _as_tensor(cross_inhibition, H), _as_tensor(reg, H),
                                   bool(use_same), bool(use_cross))
    return inhibited_mu_h_op(H, neg, pos, kernels, float(inhibition), float(cross_inhibition),
                             float(reg), bool(use_same), bool(use_cross))


def inhibited_mu_h_summed(H: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor,
                          kernels: Sequence, inhibition, cross_inhibition, reg,
                          h_sum: torch.Tensor, n_total: int, *,
                          use_same: bool = True) -> torch.Tensor:
    """:func:`tnmf_tpu_torch.kernels.inhibit.inhibited_mu_h_summed` through
    ``tnmf::inhibited_mu_h_summed`` (float strengths: a single fit's)."""
    return inhibited_mu_h_summed_op(H, neg, pos, [torch.as_tensor(k) for k in kernels],
                                    float(inhibition), float(cross_inhibition), float(reg),
                                    h_sum, int(n_total), bool(use_same))


def mu_w(W: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor, reg: float,
         n_shift_axes: int) -> torch.Tensor:
    """:func:`tnmf_tpu_torch.kernels.mu.mu_w`; through ``tnmf::mu_w`` under
    vmap (a batched operand), else the wrapper itself (one dispatch less an
    iteration of a single fit)."""
    if _batched(W) or _batched(neg) or _batched(pos):
        return mu_w_op(W, neg, pos, float(reg), int(n_shift_axes))
    return _mu.mu_w(W, neg, pos, reg, n_shift_axes)


def grad_w(X2: torch.Tensor, H: torch.Tensor, passes: int = 3):
    """:func:`tnmf_tpu_torch.kernels.gw.grad_w`; through ``tnmf::grad_w``
    under vmap (a batched operand), else the wrapper itself, as for
    :func:`mu_w`."""
    if _batched(X2) or _batched(H):
        return grad_w_op(X2, H, int(passes))
    return _gw.grad_w(X2, H, passes)


def hals_sweep(X: torch.Tensor, G: torch.Tensor, P: torch.Tensor, l1, l2,
               inner: int) -> torch.Tensor:
    """:func:`tnmf_tpu_torch.kernels.hals.hals_sweep` through ``tnmf::hals_sweep``
    (``.t`` when a strength is a tensor)."""
    if isinstance(l1, torch.Tensor) or isinstance(l2, torch.Tensor):
        return hals_sweep_t_op(X, G, P, _as_tensor(l1, G), _as_tensor(l2, G), int(inner))
    return hals_sweep_op(X, G, P, float(l1), float(l2), int(inner))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(a, b)``; through ``tnmf::matmul`` under vmap (a
    batched operand), whose rule forms one product per model, else
    ``torch.matmul`` itself."""
    if _batched(a) or _batched(b):
        return matmul_op(a, b)
    return torch.matmul(a, b)
