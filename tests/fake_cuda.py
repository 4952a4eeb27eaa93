"""Tracing the port's CUDA serving programs without a card.

``torch.export`` runs under a ``FakeTensorMode`` on fake CUDA tensors,
which need no card.  In a CPU-only build of torch two Python bindings of
``torch.Tensor``, ``__getitem__`` and ``contiguous``, enter a CUDA device
guard before they dispatch, and such a build has none; inside
:func:`cuda_programs` they are stood in for CUDA tensors by the ATen
operators they call (``slice``, ``select``, ``unsqueeze``, ``clone``), and
any other tensor keeps the bindings.
"""

import contextlib
import dataclasses
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from tnmf_tpu_torch import engine, engine_hals, serving

aten = torch.ops.aten

#: the plain versions the engine calls by name when its gates refuse a kernel
PLAIN = ((engine, 'mu_ratio_plain'), (engine, 'mu_h_plain'),
         (engine, 'inhibited_mu_h_plain'), (engine_hals, 'hals_sweep_plain'))


def _getitem(t: torch.Tensor, index):
    index = index if isinstance(index, tuple) else (index,)
    n_axes = sum(1 for i in index if i is not None and i is not Ellipsis)
    full = []
    for i in index:
        full += [slice(None)] * (t.dim() - n_axes) if i is Ellipsis else [i]
    out, dim = t, 0
    for i in full:
        if i is None:
            out, dim = aten.unsqueeze.default(out, dim), dim + 1
        elif isinstance(i, (int, torch.SymInt)):
            out = aten.select.int(out, dim, i)
        elif isinstance(i, slice) and i.step in (None, 1):
            out = aten.slice.Tensor(out, dim, 0 if i.start is None else i.start,
                                    sys.maxsize if i.stop is None else i.stop)
            dim += 1
        else:
            raise NotImplementedError(f'index {index!r} of a fake CUDA tensor')
    return out


@contextlib.contextmanager
def _bindings_without_device_guard():
    getitem, contiguous = torch.Tensor.__getitem__, torch.Tensor.contiguous

    def fake_getitem(t, index):
        return _getitem(t, index) if t.device.type == 'cuda' else getitem(t, index)

    def fake_contiguous(t, memory_format=torch.contiguous_format):
        if t.device.type != 'cuda':
            return contiguous(t, memory_format=memory_format)
        return t if t.is_contiguous() else aten.clone.default(t, memory_format=memory_format)

    torch.Tensor.__getitem__, torch.Tensor.contiguous = fake_getitem, fake_contiguous
    try:
        yield
    finally:
        torch.Tensor.__getitem__, torch.Tensor.contiguous = getitem, contiguous


def _refuse(name):
    def call(*args, **kwargs):
        raise AssertionError(f'the CUDA program called {name}')
    return call


def cuda_programs(recipe, batch_size=None, include_decoder=False) -> dict:
    """:func:`tnmf_tpu_torch.serving._programs` of ``recipe`` on fake CUDA
    tensors (its dictionary and taps stood in by fake CUDA tensors of their
    shapes); any call of a plain version while it traces fails."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(_bindings_without_device_guard())
        mp = stack.enter_context(pytest.MonkeyPatch.context())
        for module, name in PLAIN:
            mp.setattr(module, name, _refuse(name))
        stack.enter_context(FakeTensorMode())
        dtype = recipe.W.dtype
        recipe = dataclasses.replace(
            recipe, W=torch.empty(tuple(recipe.W.shape), dtype=dtype, device='cuda'),
            kernels=tuple(torch.empty(np.shape(k), dtype=dtype, device='cuda')
                          for k in recipe.kernels))
        return serving._programs(recipe, 'cuda', batch_size, include_decoder)


def ms_cuda_programs(recipe, batch_size=None, include_decoder=False) -> dict:
    """:func:`tnmf_tpu_torch.serving._ms_programs` of a multi-scale
    ``recipe`` on fake CUDA tensors, as :func:`cuda_programs` traces a
    single-scale one."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(_bindings_without_device_guard())
        mp = stack.enter_context(pytest.MonkeyPatch.context())
        for module, name in PLAIN:
            mp.setattr(module, name, _refuse(name))
        stack.enter_context(FakeTensorMode())
        recipe = dataclasses.replace(recipe, Ws=tuple(
            torch.empty(tuple(W.shape), dtype=W.dtype, device='cuda') for W in recipe.Ws))
        return serving._ms_programs(recipe, 'cuda', batch_size, include_decoder)


def kernel_ops(program) -> list:
    """The ``tnmf::`` operators a program calls, loop bodies included, in
    graph order."""
    return [str(node.target).split('.')[1]
            for gm in program.graph_module.modules() if isinstance(gm, torch.fx.GraphModule)
            for node in gm.graph.nodes
            if node.op == 'call_function' and str(node.target).startswith('tnmf.')]


def loops(program) -> int:
    """The ``while_loop`` nodes of a program's top graph."""
    return sum(1 for node in program.graph.nodes
               if node.op == 'call_function' and 'while_loop' in str(node.target))
