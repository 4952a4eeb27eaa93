"""Masked-factorization demo: image inpainting from incomplete pixels.

Port of ``demos/demo_inpainting.py``.  Deletes a configurable fraction of
the test image's pixels, learns a shift-invariant dictionary from the
surviving ones only (``mask=`` on the fit — a capability the reference has
no counterpart for), and imputes the missing pixels from the
reconstruction.
"""

import numpy as np

from tnmf_tpu_torch.models.tnmf import TransformInvariantNMF
from tnmf_tpu_torch.utils.data_loading import racoon_image
from tnmf_tpu_torch.utils.demo import device_of, explanation, st
from tnmf_tpu_torch.utils.drawing import pyplot


def main(progress_bar=None, verbose: bool = True, *, device=None, use_pallas=None) -> dict:
    explanation(
        'Learn a dictionary from an image with most pixels deleted, then '
        'impute the holes from the reconstruction (masked multiplicative '
        'updates: the deleted pixels never enter gradients or the energy).',
        verbose)

    scale = float(st.sidebar.number_input('Image scale', min_value=0.05,
                                          max_value=1.0, value=0.25))
    missing = float(st.sidebar.slider('Fraction of pixels deleted', 0.1, 0.9, 0.6))
    n_atoms = int(st.sidebar.number_input('Number of atoms', min_value=1, value=16))
    atom_size = int(st.sidebar.number_input('Atom size', min_value=2, value=8))
    n_iterations = int(st.sidebar.number_input('Iterations', min_value=1, value=150))
    sparsity = float(st.sidebar.number_input('Sparsity weight', min_value=0.0, value=0.05))

    img = racoon_image(gray=True, scale=scale)
    rng = np.random.default_rng(0)
    mask = (rng.random(img.shape) > missing).astype(img.dtype)

    nmf = TransformInvariantNMF(n_atoms=n_atoms, atom_shape=(atom_size, atom_size),
                                seed=7, device=device_of(device), use_pallas=use_pallas)
    callback = None
    if progress_bar is not None:
        callback = (lambda model, it:
                    progress_bar.progress((it + 1) / n_iterations) or True)
    nmf.fit(img[None, None] * mask[None, None], n_iterations=n_iterations,
            sparsity_H=sparsity, mask=mask[None, None],
            progress_callback=callback,
            callback_interval=max(1, n_iterations // 20))
    inpainted = np.clip(nmf.inverse_transform()[0, 0], 0, 1)

    miss = mask == 0
    mse = float(np.mean((inpainted[miss] - img[miss]) ** 2))
    st.markdown(f'MSE at the deleted pixels: **{mse:.5f}**')

    plt = pyplot()
    if plt is not None:
        fig, axes = plt.subplots(1, 3, figsize=(12, 4))
        for ax, (title, shown) in zip(axes, (
                ('original', img),
                (f'{int(missing * 100)}% deleted', img * mask),
                ('inpainted', inpainted))):
            ax.imshow(shown, cmap='gray', vmin=0, vmax=1)
            ax.set_title(title)
            ax.axis('off')
        st.pyplot(fig)
    return dict(energy=nmf._energy_function(), mse=mse)


if __name__ == '__main__':
    main()
