#!/usr/bin/env python3
"""Fault C2's three distances: the plain-NMF HALS sweep from float64.

The configuration is ``chip_smoke.py`` phase 19's sweep (f): plain NMF on
16384 x 1 x 4096 data (``np.random.default_rng(50)``), 256 atoms, 4 models
of sparsity 0, 0.05, 0.1 and 0.2 with ``l2 = 0.1``, 3 iterations, from the
JAX package's own sweep inits (``jax.random.split(PRNGKey(0), 4)``, its
``init_matrices``).  Each distance is phase 19's: per model the larger of
max|W - W64| / max|W64| and the same of H, worst over the models.

Two steps, one per machine, sharing the inits through a file:

    JAX_PLATFORMS=cpu python3 tools/c2_distances.py jax --out _c2
    python3 tools/c2_distances.py card --inits _c2/inits.npz

``jax`` (the CPU; imports the JAX package, never the port) draws the inits,
writes them, runs the JAX float32 sweep (``_sweep_impl_hals``) and the same
iterations in float64 from the float32 inits, and prints the float32
sweep's distance.  ``card`` (a CUDA card; imports the port, never JAX)
runs the port's sweep on the kernels from those inits (float32), each
model's single fit (``engine_hals.fit_loop``), the sweep with its Gram
products batched as one product for all the models (the route before
per-model products), and the float64 sweep (the plain versions), and
prints each one's distance.  Both print one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

N, F, M = 16384, 4096, 256
SPARSITY = np.array([0.0, 0.05, 0.1, 0.2], np.float32)
L2 = 0.1
N_ITER = 3
DATA_SEED = 50
KEY_SEED = 0

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def data() -> np.ndarray:
    return np.random.default_rng(DATA_SEED).random((N, 1, F), dtype=np.float32)


def _off(a, b) -> float:
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _worst(W, H, W64, H64) -> float:
    return max(max(_off(W[s], W64[s]), _off(H[s], H64[s])) for s in range(len(W)))


def run_jax(out: Path) -> dict:
    import jax
    import jax.numpy as jnp
    jax.config.update('jax_enable_x64', True)
    from tnmf_tpu import engine_hals
    from tnmf_tpu.models import sweep
    from tnmf_tpu.ops.modes import ConvPlan

    V = data()
    plan = ConvPlan.create('full', (F,), (F,))
    keys = jax.random.split(jax.random.PRNGKey(KEY_SEED), len(SPARSITY))
    inner = engine_hals.auto_inner(M, F, 'auto', n_samples=N)
    statics = dict(n_atoms=M, inner=inner, plan=plan)
    res = {}
    for dtype in (np.float32, np.float64):
        Vd = jnp.asarray(V, dtype)
        l1 = jnp.asarray(SPARSITY, dtype)
        l2 = jnp.full((len(SPARSITY),), L2, dtype)
        W0, H0, iter_one, _ = sweep._hals_vmap_pieces(Vd, keys, **statics)
        if dtype is np.float32:
            inits = (np.asarray(W0), np.asarray(H0))
            W, H, _ = sweep._sweep_impl_hals(Vd, keys, l1, l2, n_iterations=N_ITER,
                                             trace=False, **statics)
        else:  # the float32 inits, iterated in float64
            viter = jax.jit(jax.vmap(iter_one))
            W, H = (jnp.asarray(x, dtype) for x in inits)
            for _ in range(N_ITER):
                W, H = viter(W, H, l1, l2)
        res[dtype] = (np.asarray(W), np.asarray(H))
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / 'inits.npz', W0=inits[0], H0=inits[1])
    (W, H), (W64, H64) = res[np.float32], res[np.float64]
    return dict(inner=inner, jax_float32_from_float64=_worst(W, H, W64, H64),
                per_model=[max(_off(W[s], W64[s]), _off(H[s], H64[s]))
                           for s in range(len(SPARSITY))])


def run_card(inits: Path) -> dict:
    import subprocess

    import torch
    from tnmf_tpu_torch import engine_hals
    from tnmf_tpu_torch.models import sweep

    if not torch.cuda.is_available():
        raise SystemExit('card mode needs a CUDA card')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True).stdout.strip()
    with np.load(inits) as z:
        W0 = torch.tensor(z['W0'], device='cuda')
        H0 = torch.tensor(z['H0'], device='cuda')
    V = torch.tensor(data(), device='cuda')
    inner = engine_hals.auto_inner(M, F, 'auto', n_samples=N)

    def sweep_of(V, W0, H0, **kw):
        r = sweep._sweep_from_init_hals(V, W0, H0, n_iterations=N_ITER, device='cuda',
                                        sparsity=SPARSITY, l2=L2, **kw)
        return r.W.double().cpu().numpy(), r.H.double().cpu().numpy()

    exact = sweep_of(V.double(), W0.double(), H0.double())
    kernels = sweep_of(V, W0, H0)
    plain = sweep_of(V, W0, H0, use_pallas=False)
    per_model = engine_hals._dot
    # the earlier route: one batched product of the models' Grams
    engine_hals._dot = lambda a, b: torch.matmul(a, b.to(a.dtype))
    try:
        batched = sweep_of(V, W0, H0)
    finally:
        engine_hals._dot = per_model
    singles = [engine_hals.fit_loop(V, W0[s], H0[s], N_ITER, float(SPARSITY[s]), L2, 0., 0.,
                                    inner=inner, update_H=True, update_W=True)
               for s in range(len(SPARSITY))]
    single = (np.stack([w.double().cpu().numpy() for w, _ in singles]),
              np.stack([h.double().cpu().numpy() for _, h in singles]))
    out = dict(card=smi, inner=inner)
    for name, (W, H) in (('kernels', kernels), ('plain', plain), ('batched_grams', batched),
                         ('single_fits', single)):
        out[f'{name}_from_float64'] = _worst(W, H, *exact)
    out['kernels_from_single_fits'] = _worst(*kernels, *single)
    out['kernels_bit_equal_single_fits'] = bool(
        np.array_equal(kernels[0], single[0]) and np.array_equal(kernels[1], single[1]))
    out['batched_grams_from_single_fits'] = _worst(*batched, *single)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('mode', choices=('jax', 'card'))
    p.add_argument('--out', type=Path, default=Path('_c2'), help='jax: where inits.npz goes')
    p.add_argument('--inits', type=Path, default=Path('_c2/inits.npz'), help='card: the inits')
    a = p.parse_args()
    if a.mode == 'jax':
        os.environ.setdefault('JAX_PLATFORMS', 'cpu')
        out = run_jax(a.out)
    else:
        out = run_card(a.inits)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
