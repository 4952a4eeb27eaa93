"""The port's demos (port of the repository's ``demos/``): streamlit pages,
or headless runs through :mod:`tnmf_tpu_torch.utils._st_shim` with every
widget at its default.

``python -m tnmf_tpu_torch.demos.demo_selector [name]`` (or ``python -m
tnmf_tpu_torch.cli demo --headless [name]``) runs one demo headless;
``streamlit run tnmf_tpu_torch/demos/demo_selector.py -- [name]`` serves it
where streamlit is installed.  Each demo's ``main(progress_bar=None,
verbose=True, ..., device=None, use_pallas=None)`` fits on
``device`` (:data:`tnmf_tpu_torch.utils.demo.DEVICE`, the card, when None)
and returns its figures.
"""
