"""Synthetic 1-D and 2-D test-signal generators (NumPy only).

A copy of :mod:`tnmf_tpu.utils.signals`, so the port can build the
repository's 1-D pulse-train fixture without importing JAX.  API-compatible
with the reference's ``tnmf/utils/signals.py`` (same function names,
signatures and output conventions).

All generators draw from the *global* NumPy RNG (``np.random``) so that
``np.random.seed(...)``-seeded scripts are reproducible, matching the
convention of the reference demo suite.
"""

from __future__ import annotations

from itertools import product
from typing import List, Optional, Tuple

import numpy as np

PULSE_SHAPES = ('n', '-', '^', 'v', '_')
PATCH_PATTERNS = ('x', '+', 's')
PATCH_COLORS = {'r': (0,), 'g': (1,), 'b': (2,), 'y': (0, 1), 'm': (0, 2), 'c': (1, 2), 'w': (0, 1, 2)}


def generate_pulse(shape: str, length: int = 20) -> np.ndarray:
    """A single L2-normalized pulse of the given shape and length.

    Shapes: ``'n'`` half-circle bump, ``'-'`` plateau, ``'^'`` triangle up,
    ``'v'`` triangle down (valley), ``'_'`` silence.
    """
    x = np.arange(length, dtype=float)
    if shape == 'n':
        r = (length - 1) / 2
        pulse = np.sqrt(np.maximum(r * r - (x - r) ** 2, 0.0))
    elif shape == '-':
        pulse = np.ones(length)
    elif shape == '^':
        pulse = np.minimum(x, length - 1 - x)
    elif shape == 'v':
        pulse = np.maximum(np.ceil(length / 2) - 1 - x, x - np.floor(length / 2))
    elif shape == '_':
        return np.zeros(length)
    else:
        raise ValueError(f'unknown pulse shape {shape!r}')
    return pulse / np.linalg.norm(pulse)


def generate_pulse_train(
        symbols: Optional[List[str]] = None,
        pulse_length: int = 20,
        n_pulses: int = 5,
) -> Tuple[np.ndarray, np.ndarray]:
    """A multi-channel signal made of a random sequence of pulse symbols.

    Each symbol is a string of per-channel pulse shapes (e.g. ``'nvn'`` is a
    3-channel symbol).  Returns ``(signal, W)`` with ``signal`` of shape
    ``(n_channels, n_pulses * pulse_length)`` and the ground-truth dictionary
    ``W`` of shape ``(n_symbols, n_channels, pulse_length)``.
    """
    if symbols is None:
        symbols = ['nnn', '---', '^^^', 'vvv', '___']
    n_channels = len(symbols[0])
    if any(len(s) != n_channels for s in symbols):
        raise ValueError('all symbols must have the same number of channels')
    W = np.stack([
        np.stack([generate_pulse(ch, pulse_length) for ch in symbol])
        for symbol in symbols
    ])
    sequence = np.random.choice(len(symbols), n_pulses)
    signal = np.concatenate([W[i] for i in sequence], axis=-1)
    return signal, W


def generate_patch(pattern: str, size: int = 10, color: Optional[str] = None) -> np.ndarray:
    """A square image patch with a pattern ('x' cross-diagonal, '+' plus,
    's' centered square), optionally colorized to 3 channels.

    Returns shape ``(1, size, size)`` grayscale or ``(3, size, size)`` RGB.
    """
    ii, jj = np.indices((size, size))
    if pattern == 'x':
        im = ((ii == jj) | (ii + jj == size - 1)).astype(float)
    elif pattern == '+':
        mid = {(size - 1) // 2, size // 2}
        im = (np.isin(ii, list(mid)) | np.isin(jj, list(mid))).astype(float)
    elif pattern == 's':
        fill = size // 3
        inside = (ii >= fill) & (ii < size - fill) & (jj >= fill) & (jj < size - fill)
        im = inside.astype(float)
    else:
        raise ValueError(f'unknown patch shape {pattern!r}')
    if not color:
        return im[None]
    patch = np.zeros((3, size, size))
    patch[list(PATCH_COLORS[color])] = im
    return patch


def generate_block_image(
        symbols: Optional[List[str]] = None,
        symbol_size: int = 10,
        n_symbols: int = 10,
) -> Tuple[np.ndarray, np.ndarray]:
    """An image tiled from ``n_symbols x n_symbols`` random patches.

    Symbols are one- or two-character strings: pattern plus optional color
    (e.g. ``'sr'`` is a red square).  Returns ``(image, W)`` where ``image``
    has shape ``(3, n*s, n*s)`` and ``W`` stacks the patch dictionary.
    """
    if symbols is None:
        symbols = [''.join(sc) for sc in product(PATCH_PATTERNS, PATCH_COLORS)]
    specs = [(s[0], s[1] if len(s) > 1 else None) for s in symbols]
    W = np.stack([generate_patch(shape, symbol_size, color) for shape, color in specs])
    sequence = np.random.choice(len(specs), n_symbols * n_symbols).reshape(n_symbols, n_symbols)
    rows = [np.concatenate([W[idx] for idx in row], axis=-1) for row in sequence]
    image = np.concatenate(rows, axis=-2)
    return image, W
