"""The float32 precision pins of the port: full float32 products on the card.

cuBLAS runs float32 and complex64 products in TF32 when the process-global
``torch.set_float32_matmul_precision`` allows it ('high' or 'medium'), and
cuDNN runs float32 convolutions in TF32 while ``torch.backends.cudnn.allow_tf32``
is True (its default); the JAX package computes both in full float32.  The
engine (:mod:`tnmf_tpu_torch.engine`) runs every fft and dot product inside
:func:`full_fp32_matmul`, entered once at its outermost call (a whole fit
loop), not once per product, and every convolution inside
:func:`fp32_convolutions`.

Neither pin can be traced by ``torch.export``, and an exported program does
not carry the flags they set.  While a program is exported
(:func:`exporting`) the engine's pins stand aside, and the serving
artifact (:mod:`tnmf_tpu_torch.serving`) runs the loaded program inside
:func:`full_fp32`, both pins at once.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# the setting is process-global: one pin at a time, so that two threads'
# pins cannot restore each other's setting out of order
_LOCK = threading.RLock()


def exporting() -> bool:
    """True while ``torch.export`` traces the code: the pins, which it
    cannot trace, stand aside."""
    return torch.compiler.is_exporting()


@contextlib.contextmanager
def full_fp32_matmul():
    """Inside the block float32 matrix products (real and complex) run in
    full float32: no TF32 on the card, no reduced-precision path on the
    CPU.  The caller's setting comes back on exit; a block inside another
    (or under 'highest') leaves the setting alone.

    Not thread-safe against other code: the setting is process-global, so
    products that another thread runs while a block is open run in full
    float32 too, and a thread that changes the setting inside the block
    has it undone on exit.  Blocks of this module's own callers on other
    threads wait for the open one to close."""
    with _LOCK:
        saved = torch.get_float32_matmul_precision()
        if saved == 'highest':
            yield
            return
        torch.set_float32_matmul_precision('highest')
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(saved)


def fp32_convolutions():
    """The block's cuDNN convolutions run in full float32 (TF32 off), a
    null context while a program is exported (:func:`exporting`)."""
    if exporting():
        return contextlib.nullcontext()
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


@contextlib.contextmanager
def full_fp32():
    """Both pins at once: full float32 products and convolutions, whatever
    the caller's TF32 settings (the serving artifact runs its loaded
    programs inside it)."""
    with full_fp32_matmul(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        yield
