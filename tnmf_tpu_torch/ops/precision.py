"""The float32 matrix-product precision of the fft and dot strategies.

cuBLAS runs float32 and complex64 products in TF32 when the process-global
``torch.set_float32_matmul_precision`` allows it ('high' or 'medium'); the
JAX package computes these products in full float32.  The engine
(:mod:`tnmf_tpu_torch.engine`) runs every fft and dot product inside
:func:`full_fp32_matmul`, entered once at its outermost call (a whole fit
loop), not once per product.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# the setting is process-global: one pin at a time, so that two threads'
# pins cannot restore each other's setting out of order
_LOCK = threading.RLock()


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
