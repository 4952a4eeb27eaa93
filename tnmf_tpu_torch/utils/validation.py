"""Public-API validation helpers (port of :mod:`tnmf_tpu.utils.validation`).

``ValueError`` instead of bare ``assert``: assertions vanish under
``python -O``, silently dropping the precondition checks.
"""

from __future__ import annotations


def require(cond: bool, msg: str) -> None:
    """Raise ``ValueError(msg)`` unless ``cond``."""
    if not cond:
        raise ValueError(msg)


def require_nonneg(**params) -> None:
    """Every keyword must satisfy ``value >= 0`` (raises ``ValueError``
    naming the offending parameter)."""
    for name, value in params.items():
        if not value >= 0:
            raise ValueError(f'{name} must be >= 0, got {value!r}')
