"""Deploying a trained model: memory planning, checkpoints, and a
self-contained serving artifact.

Port of ``examples/serving_deployment.py``.  The production hand-off, end
to end:

1. **Plan** the fit's device-memory footprint before allocating anything
   (``utils.memory.estimate_fit_memory``: per-tensor sizes from the port's
   own operators on meta tensors) and pick a batch size for a budget
   (``suggest_batch_size``).
2. **Train** and **checkpoint** (``save``).
3. **Export** the frozen-dictionary encoding step as ONE portable
   ``torch.export`` artifact (``export_serving``): the dictionary, geometry
   and regularizer strengths bake in, the batch dimension stays symbolic,
   the iteration count stays a runtime knob, and ``include_decoder=True``
   ships the reconstruction too — a complete codec in one file.
4. **Serve** it with ``load_serving`` — no model classes, no Python state,
   no RNG (the matched-filter H init is deterministic), any request batch
   size.

The artifact and the checkpoint are written to a temporary directory,
removed when the example ends.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from .. import TransformInvariantNMF, load_serving
from ..utils.memory import estimate_fit_memory, suggest_batch_size
from ..utils.signals import generate_pulse_train
from . import smoke_from_env

#: the memory planner's table and batch (its entries are the port's own),
#: the files' paths and sizes, and the artifact's platforms
NOT_COMPARED = ('estimate', 'budget_mib', 'n_max', 'checkpoint', 'artifact', 'platforms')


def make_batch(n, seed):
    np.random.seed(seed)
    return np.stack([generate_pulse_train(pulse_length=16, n_pulses=4)[0]
                     for _ in range(n)])


def run(smoke: bool = False, device='cuda', use_pallas=None, dtype=torch.float32) -> dict:
    model = TransformInvariantNMF(n_atoms=4, atom_shape=(16,), seed=0, h_init='correlate',
                                  device=device, use_pallas=use_pallas, dtype=dtype)

    # -- 1. plan the memory before touching the device ------------------
    V = make_batch(24, seed=0)
    est = estimate_fit_memory(model, V.shape)
    budget = 2 * est.peak_bytes  # pretend budget: twice this fit
    n_max = suggest_batch_size(model, V.shape[2:], n_channels=V.shape[1],
                               budget_bytes=budget, safety=1.0)

    # -- 2. train + checkpoint ------------------------------------------
    model.fit(V, n_iterations=50 if smoke else 500, sparsity_H=0.1)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, 'model.npz')
        model.save(ckpt)
        ckpt_size = os.path.getsize(ckpt)

        # -- 3. export the serving artifact (encode + decode) -----------
        artifact = os.path.join(tmp, 'encoder.tnmfsrv')
        model.export_serving(path=artifact, n_iterations=30 if smoke else 100,
                             sparsity_H=0.1, include_decoder=True)
        artifact_size = os.path.getsize(artifact)

        # -- 4. serve: no model classes needed from here on -------------
        encoder = load_serving(artifact)
    requests = []
    for n_req in (3, 7):  # symbolic batch: any request size, one program
        V_new = make_batch(n_req, seed=n_req)
        H = encoder.transform(V_new)
        R = encoder.inverse_transform(H)
        rel = float(((V_new - R) ** 2).sum() / (V_new ** 2).sum())
        assert rel < 0.5
        requests.append((n_req, tuple(H.shape), rel))
    # latency/quality knob without re-exporting
    H_fast = encoder.transform(make_batch(2, seed=9), n_iterations=5)
    return dict(estimate=str(est), budget_mib=budget / 2**20, n_max=n_max,
                checkpoint=(ckpt, ckpt_size), artifact=(artifact, artifact_size),
                platforms=encoder.platforms, requests=requests,
                fast_shape=tuple(H_fast.shape))


def lines(result: dict) -> list:
    out = ['predicted fit footprint:', result['estimate'],
           f'\nlargest batch within {result["budget_mib"]:.1f} MiB: {result["n_max"]} samples']
    path, size = result['checkpoint']
    out.append(f'\ncheckpoint: {path} ({size} bytes)')
    path, size = result['artifact']
    out.append(f'artifact:   {path} ({size} bytes)')
    out.append(f'artifact platforms: {result["platforms"]}')
    out += [f'request batch {n}: H {shape}, relative reconstruction error {rel:.4f}'
            for n, shape, rel in result['requests']]
    out.append(f'fast path (5 iterations): H {result["fast_shape"]}')
    return out


def plot(result: dict) -> None:
    """The JAX example draws nothing."""


def main() -> None:
    result = run(smoke=smoke_from_env())
    print('\n'.join(lines(result)))
    plot(result)


if __name__ == '__main__':
    main()
