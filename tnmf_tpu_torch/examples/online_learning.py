"""Online (out-of-core) dictionary learning with ``partial_fit``.

Port of ``examples/online_learning.py``.  A ground-truth pulse dictionary
generates a stream of signal batches; the model never sees more than one
batch at a time (the sklearn ``MiniBatchNMF`` protocol).  After the stream,
the learned dictionary is evaluated by encoding HELD-OUT data with the
dictionary frozen (``transform``) — the online-learned atoms should explain
unseen signals nearly as well as a full-batch fit that was allowed to hold
all the data in memory at once.

Also shown: chunked serving — ``transform(batch_size=...)`` encodes a
dataset in exact independent chunks, for activation tensors too large for
device memory.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import TransformInvariantNMF
from ..utils.drawing import pyplot
from ..utils.signals import generate_pulse_train
from . import smoke_from_env

BATCH_SIZE = 4
PULSE_LENGTH = 20
NOT_COMPARED = ()


def make_batch(n):
    """One batch of multi-channel pulse-train signals from the shared
    ground-truth pulse shapes (the stream source)."""
    signals = [generate_pulse_train(pulse_length=PULSE_LENGTH, n_pulses=4)[0]
               for _ in range(n)]
    return np.stack(signals)


def heldout_error(model, V, smoke: bool) -> float:
    model.transform(V, n_iterations=100 if smoke else 300)
    R = model.inverse_transform()
    return float(np.square(V - R).sum() / np.square(V).sum())


def run(smoke: bool = False, device='cuda', use_pallas=None, dtype=torch.float32) -> dict:
    n_batches = 10 if smoke else 60
    model = dict(device=device, use_pallas=use_pallas, dtype=dtype)
    np.random.seed(42)
    V_heldout = make_batch(8)

    # --- online learning: one batch at a time, nothing retained ---------
    online = TransformInvariantNMF(n_atoms=3, atom_shape=(PULSE_LENGTH,), seed=0, **model)
    errs = []
    for step in range(n_batches):
        online.partial_fit(make_batch(BATCH_SIZE), sag_lambda=0.2, sparsity_H=0.05)
        if step % 5 == 0 or step == n_batches - 1:
            errs.append((step + 1, heldout_error(online, V_heldout, smoke)))

    # --- the in-memory ceiling: a full-batch fit on ALL the data --------
    V_all = make_batch(n_batches * BATCH_SIZE)
    full = TransformInvariantNMF(n_atoms=3, atom_shape=(PULSE_LENGTH,), seed=0, **model)
    full.fit(V_all, n_iterations=100 if smoke else 500, sparsity_H=0.05)
    e_full = heldout_error(full, V_heldout, smoke)

    # --- chunked serving: encode a large set in exact independent chunks
    H = online.transform(V_heldout, n_iterations=50, batch_size=2)
    return dict(steps=errs, heldout=(errs[-1][1], e_full), chunked_shape=tuple(H.shape),
                plot=dict(W=online.W))


def lines(result: dict) -> list:
    out = [f'step {step:3d}: held-out relative error {err:.4f}'
           for step, err in result['steps']]
    e_online, e_full = result['heldout']
    out.append(f'held-out error — online: {e_online:.4f}, full batch: {e_full:.4f}')
    out.append(f'chunked transform: H {result["chunked_shape"]} from chunks of 2')
    return out


def plot(result: dict) -> None:
    plt = pyplot()
    if plt is None:
        return
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    steps, errors = zip(*result['steps'])
    axes[0].plot(steps, errors, 'o-', label='online (partial_fit)')
    axes[0].axhline(result['heldout'][1], color='k', ls='--', label='full-batch fit')
    axes[0].set_xlabel('batches seen')
    axes[0].set_ylabel('held-out relative error')
    axes[0].legend()
    for i, w in enumerate(result['plot']['W']):
        axes[1].plot(w[0] / w[0].max() + i, label=f'atom {i}')
    axes[1].set_title('online-learned atoms')
    fig.tight_layout()
    plt.show()


def main() -> None:
    result = run(smoke=smoke_from_env())
    print('\n'.join(lines(result)))
    plot(result)


if __name__ == '__main__':
    main()
