"""The float32 precision of the port's products: the level, its settings, the pins.

The JAX package's ``precision`` (``ConvPlan.precision``: None, 'default',
'high' or 'highest') sets the multiply precision of every contraction.  On
the card it maps to TF32 or full float32, per unit (:func:`settings`):

=====================  ===================  ==================  ====================
level                  cuDNN convolutions   cuBLAS products     K2, K3 tensor cores
=====================  ===================  ==================  ====================
None, 'highest'        full float32         full float32        3xTF32 (3 passes)
'default', 'high'      TF32                 TF32                one TF32 pass
=====================  ===================  ==================  ====================

'default' and 'high' are JAX's "tensorfloat32" on a GPU, so they compute
alike; None keeps the port's full-float32 bits, and 'highest' is JAX's
"float32".  On the CPU, and for tensors of any dtype but float32, every
level is full float32 (JAX on the CPU ignores ``precision``, and torch's
CPU 'high' may take reduced-precision paths).  K1, K4, K5, K3's streamed
FP32 route and the convolutions that the JAX package runs without its
precision (the plain inhibition stencil) compute in float32 at every
level.

cuBLAS runs float32 and complex64 products in TF32 when the process-global
``torch.set_float32_matmul_precision`` is 'high' or 'medium', and cuDNN runs
float32 convolutions in TF32 while ``torch.backends.cudnn.allow_tf32`` is
True (its default).  The pins set both from the level, whatever the caller
set: :func:`matmul_pin` around the engine's fft and dot products and the
HALS Grams, entered once at the outermost call (a whole fit loop), not
once per product; :func:`convolution_pin` around each convolution; and
:func:`pinned`, both at once, around a loaded serving program.  Each gives
the caller's settings back on exit.

No pin can be traced by ``torch.export``, and an exported program does not
carry the flags they set.  While a program is exported (:func:`exporting`)
the pins stand aside, and the serving artifact
(:mod:`tnmf_tpu_torch.serving`) runs the loaded program inside
:func:`pinned` at the level it was exported with.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import torch

#: the values of ``precision``, the JAX package's
LEVELS = (None, 'default', 'high', 'highest')
#: the levels that run TF32 on the card (JAX's "tensorfloat32" on a GPU)
TF32_LEVELS = ('default', 'high')

# the settings are process-global: one pin at a time, so that two threads'
# pins cannot restore each other's setting out of order
_LOCK = threading.RLock()


@dataclasses.dataclass(frozen=True)
class Settings:
    """What one level means for tensors of one device and dtype."""
    #: cuDNN's ``allow_tf32`` for the convolutions
    cudnn_tf32: bool
    #: ``torch.set_float32_matmul_precision`` for the cuBLAS products
    matmul: str
    #: TF32 products per float32 product on K2's and K3's tensor-core routes
    passes: int


def settings(level: Optional[str], device, dtype: torch.dtype = torch.float32) -> Settings:
    """The settings of ``level`` for ``dtype`` tensors on ``device``: TF32
    (one pass on K2 and K3) for 'default' and 'high' on float32 CUDA
    tensors, full float32 (3xTF32 on K2 and K3) otherwise; ``ValueError``
    (the JAX package's text) for a value outside :data:`LEVELS`."""
    if level not in LEVELS:
        raise ValueError(
            f"precision must be None, 'default', 'high' or 'highest', got {level!r}")
    tf32 = (level in TF32_LEVELS and torch.device(device).type == 'cuda'
            and dtype == torch.float32)
    return Settings(cudnn_tf32=tf32, matmul='high' if tf32 else 'highest',
                    passes=1 if tf32 else 3)


def exporting() -> bool:
    """True while ``torch.export`` traces the code: the pins, which it
    cannot trace, stand aside."""
    return torch.compiler.is_exporting()


@contextlib.contextmanager
def matmul_pin(level: Optional[str], device, dtype: torch.dtype = torch.float32):
    """Inside the block float32 matrix products (real and complex) run at
    the level's setting (:func:`settings`); the caller's setting comes back
    on exit.  A null context while a program is exported.

    Not thread-safe against other code: the setting is process-global, so
    products that another thread runs while a block is open run at its
    setting too, and a thread that changes the setting inside the block has
    it undone on exit.  Blocks of this module's own callers on other
    threads wait for the open one to close."""
    if exporting():
        yield
        return
    want = settings(level, device, dtype).matmul
    with _LOCK:
        saved = torch.get_float32_matmul_precision()
        if saved == want:
            yield
            return
        torch.set_float32_matmul_precision(want)
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(saved)


@contextlib.contextmanager
def convolution_pin(level: Optional[str], device, dtype: torch.dtype = torch.float32):
    """The block's cuDNN convolutions run at the level's setting (TF32 or
    full float32); a null context while a program is exported."""
    if exporting():
        yield
        return
    tf32 = settings(level, device, dtype).cudnn_tf32
    with _LOCK, torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
        yield


@contextlib.contextmanager
def pinned(level: Optional[str], device, dtype: torch.dtype = torch.float32):
    """Both pins at once, whatever the caller's TF32 settings (the serving
    artifact runs its loaded programs inside it)."""
    with matmul_pin(level, device, dtype), convolution_pin(level, device, dtype):
        yield


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it:
    to the nearest value with 10 mantissa bits, ties away from zero,
    subnormals kept; NaN stays NaN and infinities stay.  The one-pass
    routes' plain versions round their operands with it."""
    if x.dtype != torch.float32:
        raise TypeError(f'round_tf32 takes float32, got {x.dtype}')
    bits = x.contiguous().view(torch.int32)
    # adding half of the 13 dropped bits' weight to the magnitude bits and
    # clearing them rounds the magnitude half away from zero (sign-magnitude)
    rounded = torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)
    return torch.where(torch.isnan(x), x, rounded)
