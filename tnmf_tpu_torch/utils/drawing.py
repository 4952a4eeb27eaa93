"""matplotlib, where it is installed.

The examples and demos compute everything they show first and draw it
last.  matplotlib is optional: without it (a machine with a card and no
plotting stack) :func:`pyplot` says so once on stderr and returns None, and
the caller skips the drawing alone.
"""

from __future__ import annotations

import os
import sys

_said = []


def pyplot():
    """``matplotlib.pyplot`` (the ``Agg`` backend where there is neither a
    display nor ``MPLBACKEND``, as the JAX package's examples choose), or
    None where matplotlib is missing."""
    try:
        import matplotlib
    except ImportError:
        if not _said:
            print('matplotlib is not installed: the figures are computed, not drawn',
                  file=sys.stderr)
            _said.append(True)
        return None
    if os.environ.get('DISPLAY', '') == '' and os.environ.get('MPLBACKEND', '') == '':
        matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt
