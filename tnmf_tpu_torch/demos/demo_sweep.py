"""Hyperparameter-sweep demo: restarts x sparsity grid as ONE vmapped fit
(``tnmf_tpu_torch.sweep_fit``), with per-model convergence traces.

Port of ``demos/demo_sweep.py``.  The reference can only loop sequential
fits; here the model axis is a ``torch.func.vmap`` batch dimension, so
every candidate fits at once (each kernel launched once per iteration for
all of them) and the winner is picked from the recorded objective traces.
"""

import os

import numpy as np

from tnmf_tpu_torch import sweep_fit
from tnmf_tpu_torch.utils.demo import device_of, explanation, st
from tnmf_tpu_torch.utils.drawing import pyplot
from tnmf_tpu_torch.utils.signals import generate_block_image


def main(progress_bar=None, verbose: bool = True, *, device=None, use_pallas=None) -> dict:
    explanation(
        'Fit a whole seed x sparsity grid of models in one vmapped fit '
        '(torch.func.vmap over the fit loop — the reference loops sequential '
        'fits). Convergence traces are recorded per model and the best '
        'model by final objective is shown.',
        verbose)

    default_iters = 8 if os.environ.get('TNMF_TPU_SMOKE') else 50
    n_restarts = int(st.sidebar.number_input('Restarts (seeds)', min_value=1,
                                             max_value=8, value=2))
    n_iterations = int(st.sidebar.number_input('Iterations', min_value=5,
                                               value=default_iters))
    n_atoms = int(st.sidebar.number_input('Number of atoms', min_value=1,
                                          value=5))
    sp_max = float(st.sidebar.number_input('Max sparsity weight',
                                           min_value=0.0, value=0.5))

    img, _ = generate_block_image()
    V = img[None]  # (1, channels, H, W)

    sparsities = np.linspace(0.0, sp_max, 4).astype(np.float32)
    sp = np.tile(sparsities, n_restarts)
    seeds = np.repeat(np.arange(n_restarts, dtype=np.uint32),
                      len(sparsities))

    if progress_bar is not None:
        progress_bar.progress(0.1)
    res = sweep_fit(V, n_atoms, (7, 7), seed=seeds,
                    n_iterations=n_iterations, sparsity=sp,
                    record_energies=True, device=device_of(device),
                    use_pallas=use_pallas is not False)
    traces = res.energy_traces.cpu().numpy()
    energies = res.energies.cpu().numpy()
    if progress_bar is not None:
        progress_bar.progress(1.0)

    st.markdown(f'**Best model:** #{res.best} '
                f'(seed {int(seeds[res.best])}, '
                f'sparsity {sp[res.best]:.2f}, '
                f'objective {float(energies[res.best]):.3f})')

    W_best, _ = res.model(res.best)
    plt = pyplot()
    if plt is not None:
        fig, (ax_tr, ax_w) = plt.subplots(1, 2, figsize=(12, 4))
        for s in range(traces.shape[0]):
            style = '-' if s == res.best else '--'
            ax_tr.semilogy(traces[s], style,
                           label=f'seed {int(seeds[s])}, sp {sp[s]:.2f}')
        ax_tr.set_xlabel('iteration')
        ax_tr.set_ylabel('objective')
        ax_tr.legend(fontsize=6)
        ax_tr.set_title('convergence per model (solid = best)')

        gallery = np.concatenate([W_best[m].transpose(1, 2, 0).mean(-1)
                                  for m in range(W_best.shape[0])], axis=1)
        ax_w.imshow(gallery, cmap='viridis')
        ax_w.set_title('best model: learned atoms')
        ax_w.axis('off')
        st.pyplot(fig)
    return dict(energy=energies.tolist(), best=res.best)


if __name__ == '__main__':
    main()
