"""Demo selector: entry page mapping demo names to modules.

Port of ``demos/demo_selector.py``.  Run with ``streamlit run
tnmf_tpu_torch/demos/demo_selector.py`` (or headless via ``python -m
tnmf_tpu_torch.demos.demo_selector [name]`` using the widget defaults).
"""

import sys
from importlib import import_module
from pathlib import Path

import numpy as np

if not __package__:  # run as a file (``streamlit run``): the repository on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from tnmf_tpu_torch.utils.demo import st  # noqa: E402

DEMO_NAME_DICT = {
    '1-D Synthetic Signals': ('synthetic_signals', {'n_dims': 1}),
    '2-D Synthetic Signals': ('synthetic_signals', {'n_dims': 2}),
    'Test Image': ('demo_image', {}),
    'Image Inpainting (masked fit)': ('demo_inpainting', {}),
    'Hyperparameter Sweep (vmapped)': ('demo_sweep', {}),
}


def main(demo_name: str = '2-D Synthetic Signals', **options):
    """Run the demo ``demo_name``; ``options`` (``device``, ``use_pallas``)
    go to its ``main``, whose figures are returned."""
    st.title('Transform-Invariant NMF (PyTorch)')
    progress_bar = st.sidebar.progress(1.)

    verbose = st.sidebar.checkbox('Verbose', True)
    names = list(DEMO_NAME_DICT.keys())
    selected = st.sidebar.selectbox('Demo example', names, index=names.index(demo_name))
    seed = int(st.sidebar.number_input('Random seed', value=42))
    np.random.seed(seed)

    module_name, demo_args = DEMO_NAME_DICT[selected]
    demo_module = import_module(f'tnmf_tpu_torch.demos.{module_name}')
    return demo_module.main(progress_bar, verbose=verbose, **demo_args, **options)


if __name__ == '__main__':
    main(sys.argv[1] if len(sys.argv) > 1 else '2-D Synthetic Signals')
