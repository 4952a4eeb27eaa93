"""Masked factorization: learning from incomplete data and inpainting.

Port of ``examples/masked_inpainting.py``.  Per-entry masks (``mask=`` on
the fit drivers): zeros mark *missing* values that neither the gradients
nor the energy ever see, and general nonnegative floats act as confidence
weights.  The multiplicative updates stay exact — both gradient halves
become correlations of mask-weighted streams.

The demonstration corrupts an image by deleting 60% of its pixels, learns
a shift-invariant dictionary from the surviving pixels only, and imputes
the missing ones from the reconstruction — compared against the same model
fit *without* the mask (which treats the zeros as real data and drags the
reconstruction down to them).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import TransformInvariantNMF
from ..utils.data_loading import racoon_image
from ..utils.drawing import pyplot
from . import smoke_from_env

MISSING = 0.6
NOT_COMPARED = ()


def run(smoke: bool = False, device='cuda', use_pallas=None, dtype=torch.float32) -> dict:
    n_iterations = 100 if smoke else 500
    img = racoon_image(gray=True, scale=0.25)  # (h, w) in [0, 1]
    rng = np.random.default_rng(0)
    mask = (rng.random(img.shape) > MISSING).astype(img.dtype)
    corrupted = img * mask

    V = corrupted[None, None]          # (1, 1, h, w)
    M = mask[None, None]

    def fit(use_mask):
        model = TransformInvariantNMF(n_atoms=16, atom_shape=(8, 8), seed=7, device=device,
                                      use_pallas=use_pallas, dtype=dtype)
        model.fit(V, n_iterations=n_iterations, sparsity_H=0.05,
                  mask=M if use_mask else None)
        return np.clip(model.inverse_transform()[0, 0], 0, 1)

    inpainted = fit(use_mask=True)
    naive = fit(use_mask=False)

    miss = mask == 0
    mse = {}
    for name, rec in (('masked fit', inpainted), ('unmasked fit', naive)):
        mse[name] = float(np.mean((rec[miss] - img[miss]) ** 2))
    return dict(mse=mse, plot=dict(img=img, corrupted=corrupted, inpainted=inpainted,
                                   naive=naive))


def lines(result: dict) -> list:
    out = []
    for name, mse in result['mse'].items():
        psnr = -10 * np.log10(mse) if mse > 0 else np.inf
        out.append(f'{name:12s}: MSE at missing pixels {mse:.5f}  (PSNR {psnr:.1f} dB)')
    return out


def plot(result: dict) -> None:
    plt = pyplot()
    if plt is None:
        return
    d = result['plot']
    fig, axes = plt.subplots(1, 4, figsize=(14, 4))
    for ax, (title, shown) in zip(axes, (
            ('original', d['img']),
            (f'{int(MISSING * 100)}% pixels deleted', d['corrupted']),
            ('inpainted (masked fit)', d['inpainted']),
            ('unmasked fit (fits the holes as zeros)', d['naive']))):
        ax.imshow(shown, cmap='gray', vmin=0, vmax=1)
        ax.set_title(title, fontsize=9)
        ax.axis('off')
    fig.tight_layout()
    plt.show()


def main() -> None:
    result = run(smoke=smoke_from_env())
    print('\n'.join(lines(result)))
    plot(result)


if __name__ == '__main__':
    main()
