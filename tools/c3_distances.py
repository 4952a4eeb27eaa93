#!/usr/bin/env python3
"""Fault C3's distances: the float32 HALS sweeps on the CPU.

The cases are ``tests/test_torch_sweep_hals.py``'s float32 comparison
(``CASES``, one and two inner sweeps, the plain loop, 12 iterations, the JAX
package's inits ``jax_sweep.inits(..., keys_of(5, 4))``).  For each case and
model it prints, from the port's sweep (``_sweep_from_init_hals``):

* ``single``: max|W - W1| / max|W1| and the same of H against the model's
  single ``engine_hals.fit_loop`` from the same init (0 when bit-equal);
* ``plain``: the same against the sweep with ``use_pallas=False``;
* ``jax``: the same against the JAX package's float32 ``sweep_fit``;
* ``ratio``: the port's distance from the float64 sweep over the JAX
  package's, the larger of W's and H's (the test's limit is 2 where
  ``jax`` exceeds 1e-5).

Run from the repository root on the CPU; the JAX package is the reference,
so this script imports both packages, as the tests do::

    JAX_PLATFORMS=cpu python3 tools/c3_distances.py

With ``PYTHONPATH`` pointing at another checkout first, it measures that
checkout's port against the same reference.  The last line is one JSON
object with the worst of each distance.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

sys.path.append(str(Path(__file__).resolve().parent.parent))


def _off(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def main() -> int:
    import torch
    from tnmf_tpu import sweep_fit as jax_sweep_fit
    from tnmf_tpu_torch import engine_hals
    from tnmf_tpu_torch.models.sweep import _sweep_from_init_hals

    from tests import jax_sweep
    from tests.test_torch_sweep_hals import CASES, S

    worst = dict(single=0.0, plain=0.0, jax=0.0, ratio=0.0)
    for name, V, n_atoms, kw in CASES:
        for inner in (1, 2):
            V32 = V.astype(np.float32)
            W0, H0 = jax_sweep.inits(V32, jax_sweep.keys_of(5, S), n_atoms, V.shape[2:],
                                     mode='full')
            fit = dict(n_iterations=12, hals_inner=inner, device='cpu', **kw)
            ref = jax_sweep_fit(V32, n_atoms, V.shape[2:], n_models=S, seed=5, n_iterations=12,
                                reconstruction_mode='full', solver='hals', hals_inner=inner,
                                **kw)
            res = _sweep_from_init_hals(V32, W0, H0, **fit)
            plain = _sweep_from_init_hals(V32, W0, H0, use_pallas=False, **fit)
            f64 = _sweep_from_init_hals(V, W0.astype(np.float64), H0.astype(np.float64),
                                        **fit)
            sp = np.broadcast_to(np.asarray(kw.get('sparsity', 0.0), np.float32), (S,))
            l2 = np.broadcast_to(np.asarray(kw.get('l2', 0.0), np.float32), (S,))
            k = engine_hals.auto_inner(n_atoms, int(np.prod(V.shape[1:])), inner,
                                       n_samples=V.shape[0])
            for s in range(S):
                W1, H1 = engine_hals.fit_loop(torch.tensor(V32), torch.tensor(W0[s]),
                                              torch.tensor(H0[s]), 12, float(sp[s]),
                                              float(l2[s]), 0., 0., inner=k, update_H=True,
                                              update_W=True)
                row = dict(
                    single=max(_off(res.W[s], W1), _off(res.H[s], H1)),
                    plain=max(_off(res.W[s], plain.W[s]), _off(res.H[s], plain.H[s])),
                    jax=max(_off(res.W[s], ref.W[s]), _off(res.H[s], ref.H[s])),
                    ratio=max(_off(res.W[s], f64.W[s]) / _off(ref.W[s], f64.W[s]),
                              _off(res.H[s], f64.H[s]) / _off(ref.H[s], f64.H[s])))
                print(f'{name:10s} inner {inner} model {s}: '
                      + '  '.join(f'{key} {v:.3e}' for key, v in row.items()), flush=True)
                for key, v in row.items():
                    if key != 'ratio' or row['jax'] > 1e-5:
                        worst[key] = max(worst[key], v)
    print(json.dumps(worst))
    return 0


if __name__ == '__main__':
    sys.exit(main())
