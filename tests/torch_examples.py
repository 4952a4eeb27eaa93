"""The JAX package's examples run in-process, for the port's example tests.

``jax_lines`` runs ``examples/<name>.py`` unedited with
``runpy.run_path(path, run_name='__main__')`` under ``TNMF_TPU_SMOKE=1`` and
``MPLBACKEND=Agg`` and returns the lines it printed; ``assert_figures``
holds the port's printed lines to them figure by figure: the same lines,
the same numbers in each, every number within ``rtol`` of the JAX
example's plus the two figures' own rounding (half a unit in the last
printed place each: a figure printed with three decimals carries up to
5e-4 of rounding)."""

import os
import re
import runpy

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUMBER = re.compile(r'(?<![\w.])[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?|\binf\b|\bnan\b')


def jax_lines(name: str, monkeypatch, capsys) -> list:
    """The lines ``examples/<name>.py`` prints at its smoke settings."""
    monkeypatch.setenv('TNMF_TPU_SMOKE', '1')
    monkeypatch.setenv('MPLBACKEND', 'Agg')
    capsys.readouterr()
    runpy.run_path(os.path.join(REPO, 'examples', f'{name}.py'), run_name='__main__')
    import matplotlib.pyplot as plt
    plt.close('all')
    return capsys.readouterr().out.splitlines()


def figures(line: str) -> list:
    """``(value, rounding)`` of every number printed in ``line``: the
    rounding is half a unit in its last printed place, 0 for an integer."""
    out = []
    for m in NUMBER.finditer(line):
        text = m.group(0).lower()
        mantissa, _, exponent = text.partition('e')
        if '.' not in mantissa:
            out.append((float(text), 0.0))
            continue
        decimals = len(mantissa.split('.')[1]) - int(exponent or 0)
        out.append((float(text), 0.5 * 10.0 ** -decimals))
    return out


def text_of(line: str) -> str:
    return NUMBER.sub('#', line)


def assert_figures(port: list, jax: list, rtol: float, same_text: bool = True) -> int:
    """Every figure of ``port`` within ``rtol`` of ``jax``'s (plus their
    printed rounding); returns the number of figures compared."""
    port = [line for text in port for line in text.split('\n') if line.strip()]
    jax = [line for line in jax if line.strip()]
    assert len(port) == len(jax), f'{len(port)} lines against {len(jax)}:\n' + '\n'.join(
        port) + '\n--\n' + '\n'.join(jax)
    n = 0
    for p, j in zip(port, jax):
        if same_text:
            assert text_of(p) == text_of(j), f'{p!r} against {j!r}'
        fp, fj = figures(p), figures(j)
        assert len(fp) == len(fj), f'{p!r} against {j!r}'
        for (a, ra), (b, rb) in zip(fp, fj):
            if np.isnan(b) or np.isinf(b):
                assert a == b or (np.isnan(a) and np.isnan(b)), f'{p!r} against {j!r}'
                continue
            assert abs(a - b) <= rtol * abs(b) + ra + rb, \
                f'{a} against {b} (rtol {rtol}): {p!r} against {j!r}'
            n += 1
    return n


def check_example(name: str, monkeypatch, capsys, *, dtype, rtol: float, keep=None,
                  drop=(), same_text: bool = True, **run) -> int:
    """The port's ``tnmf_tpu_torch.examples.<name>.run(smoke=True,
    device='cpu', dtype=dtype)`` printed by its ``lines`` against the JAX
    example's printed lines: ``keep`` filters the lines of both (None keeps
    all), each ``(pattern, replacement)`` of ``drop`` is substituted in both
    (the figures that cannot match), then :func:`assert_figures`."""
    import importlib
    module = importlib.import_module(f'tnmf_tpu_torch.examples.{name}')
    jax = jax_lines(name, monkeypatch, capsys)
    port = [line for text in module.lines(module.run(smoke=True, device='cpu', dtype=dtype,
                                                     **run))
            for line in text.split('\n')]

    def clean(lines):
        lines = [line for line in lines if keep is None or keep(line)]
        for pattern, replacement in drop:
            lines = [re.sub(pattern, replacement, line) for line in lines]
        return lines
    return assert_figures(clean(port), clean(jax), rtol, same_text)
