"""The kernels of the H update as PyTorch custom operators.

``tnmf::mu_ratio`` (K1's ratio), ``tnmf::mu_h`` (K3), ``tnmf::inhibited_mu_h``
(K4) and ``tnmf::hals_sweep`` (K5) are defined in the ``tnmf`` operator
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

The engine calls the kernels through the functions below, which keep the
wrappers' signatures, so that a fit and a loaded artifact run one code
path.  K1's W epilogue ``mu_w`` and K2 ``grad_w`` compute W statistics,
which no serving program runs, and stay direct calls.
"""

from __future__ import annotations

from typing import Sequence

import torch

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


_define('mu_ratio(Tensor arr, Tensor neg, Tensor pos, float reg) -> Tensor',
        lambda *args: _mu.mu_ratio(*args), lambda arr, *args: torch.empty_like(arr))
# ``passes`` (K3's TF32 passes) defaults to 3, so that a program exported
# before it existed calls the 3xTF32 route as it did
_define('mu_h(Tensor Vp, Tensor Rx, Tensor W, Tensor H, float denom_add, '
        'Tensor? pos_extra, int passes=3) -> Tensor',
        lambda *args: _mu_h.mu_h(*args), lambda Vp, Rx, W, H, *args: torch.empty_like(H))
_define('inhibited_mu_h(Tensor H, Tensor neg, Tensor pos, Tensor[] kernels, float inhibition, '
        'float cross_inhibition, float reg, bool use_same, bool use_cross) -> Tensor',
        lambda H, neg, pos, kernels, inhibition, cross, reg, use_same, use_cross:
        _inhibit.inhibited_mu_h(H, neg, pos, kernels, inhibition, cross, reg,
                                use_same=use_same, use_cross=use_cross),
        lambda H, *args: torch.empty_like(H))
_define('hals_sweep(Tensor X, Tensor G, Tensor P, float l1, float l2, int inner) -> Tensor',
        lambda *args: _hals.hals_sweep(*args), _hals_sweep_fake)

mu_ratio_op = torch.ops.tnmf.mu_ratio.default
mu_h_op = torch.ops.tnmf.mu_h.default
inhibited_mu_h_op = torch.ops.tnmf.inhibited_mu_h.default
hals_sweep_op = torch.ops.tnmf.hals_sweep.default


def mu_ratio(arr: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor,
             reg: float) -> torch.Tensor:
    """:func:`tnmf_tpu_torch.kernels.mu.mu_ratio` through ``tnmf::mu_ratio``."""
    return mu_ratio_op(arr, neg, pos, float(reg))


def mu_h(Vp: torch.Tensor, Rx: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
         denom_add: float, pos_extra: torch.Tensor | None = None,
         passes: int = 3) -> torch.Tensor:
    """:func:`tnmf_tpu_torch.kernels.mu_h.mu_h` through ``tnmf::mu_h``."""
    return mu_h_op(Vp, Rx, W, H, float(denom_add), pos_extra, int(passes))


def inhibited_mu_h(H: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor, kernels: Sequence,
                   inhibition: float, cross_inhibition: float, reg: float, *,
                   use_same: bool = True, use_cross: bool = False) -> torch.Tensor:
    """:func:`tnmf_tpu_torch.kernels.inhibit.inhibited_mu_h` through
    ``tnmf::inhibited_mu_h`` (the taps as a list of tensors)."""
    return inhibited_mu_h_op(H, neg, pos, [torch.as_tensor(k) for k in kernels],
                             float(inhibition), float(cross_inhibition), float(reg),
                             bool(use_same), bool(use_cross))


def hals_sweep(X: torch.Tensor, G: torch.Tensor, P: torch.Tensor, l1: float, l2: float,
               inner: int) -> torch.Tensor:
    """:func:`tnmf_tpu_torch.kernels.hals.hals_sweep` through ``tnmf::hals_sweep``."""
    return hals_sweep_op(X, G, P, float(l1), float(l2), int(inner))
