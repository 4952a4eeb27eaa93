"""Patch-dictionary learning on the test image, with channel-mode selection
(grayscale / multi-channel color / color channels as separate samples).
Port of ``demos/demo_image.py``."""

import numpy as np

from tnmf_tpu_torch.utils.data_loading import racoon_image
from tnmf_tpu_torch.utils.demo import fit_nmf_model, st, st_define_nmf_params
from tnmf_tpu_torch.utils.drawing import pyplot

CHANNEL_MODES = {
    'grayscale': 'one grayscale image, one channel',
    'color': 'one color image, three channels',
    'color as samples': 'three single-channel samples, one per color channel',
}


def load_V(mode: str, scale: float) -> np.ndarray:
    if mode == 'grayscale':
        img = racoon_image(gray=True, scale=scale)
        return img[np.newaxis, np.newaxis]
    img = racoon_image(gray=False, scale=scale)
    chw = img.transpose((2, 0, 1))
    if mode == 'color':
        return chw[np.newaxis]
    return chw[:, np.newaxis]  # channels as samples


def _shown(img):
    return np.clip(np.moveaxis(img, 0, -1), 0, 1) if img.shape[0] == 3 else img[0]


def main(progress_bar=None, verbose: bool = True, *, device=None, use_pallas=None) -> dict:
    mode = st.sidebar.selectbox('Channel mode', list(CHANNEL_MODES), index=0)
    if verbose:
        st.caption(CHANNEL_MODES[mode])
    scale = float(st.sidebar.number_input('Image scale', min_value=0.05, max_value=1.0, value=0.1))
    V = load_V(mode, scale)

    nmf_params, fit_params = st_define_nmf_params(
        dict(n_atoms=10, atom_shape=(7, 7)), have_ground_truth=False, verbose=verbose)
    nmf = fit_nmf_model(V, nmf_params, fit_params, progress_bar, device=device,
                        use_pallas=use_pallas)

    energy = nmf._energy_function()
    st.markdown(f'Final reconstruction energy: **{energy:.3f}**')

    # everything the galleries show, computed whether or not they are drawn
    n = nmf.n_atoms
    W, H, R = nmf.W, nmf.H, nmf.R
    parts = [nmf.R_partial(i_atom)[0] for i_atom in range(n)]

    plt = pyplot()
    if plt is None:
        return dict(energy=energy)

    # dictionary gallery
    fig, axes = plt.subplots(1, n, figsize=(1.2 * n, 1.6))
    for i in range(n):
        atom = W[i]
        img = np.clip(np.moveaxis(atom, 0, -1), 0, None) if atom.shape[0] == 3 else atom[0]
        img = img / (img.max() + 1e-12)
        axes[i].imshow(img, cmap='gray' if img.ndim == 2 else None)
        axes[i].axis('off')
        axes[i].set_title(str(i), fontsize=7)
    st.pyplot(fig)

    # input vs reconstruction
    fig, axes = plt.subplots(1, 2, figsize=(8, 4))
    for ax, img, title in zip(axes, (V[0], R[0]), ('input', 'reconstruction')):
        shown = _shown(img)
        ax.imshow(shown, cmap='gray' if shown.ndim == 2 else None)
        ax.set_title(title)
        ax.axis('off')
    st.pyplot(fig)

    # activation maps + partial reconstructions — the full atom gallery,
    # like the reference image demo
    for i_atom in range(n):
        fig, axes = plt.subplots(1, 2, figsize=(8, 3))
        Hmap = H[0, i_atom]
        if Hmap.ndim == 3:  # transform groups: one map per transformed copy
            Hmap = Hmap.sum(axis=0)
        axes[0].imshow(Hmap, cmap='viridis')
        axes[0].set_title(f'activations, atom {i_atom}')
        shown = _shown(parts[i_atom])
        axes[1].imshow(shown, cmap='gray' if shown.ndim == 2 else None)
        axes[1].set_title(f'partial reconstruction, atom {i_atom}')
        for ax in axes:
            ax.axis('off')
        st.pyplot(fig)
    return dict(energy=energy)


if __name__ == '__main__':
    main()
