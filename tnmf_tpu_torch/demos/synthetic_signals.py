"""Shift-invariant decomposition of synthetic 1-D / 2-D signals (port of
``demos/synthetic_signals.py``)."""

from tnmf_tpu_torch.utils.demo import SignalTool, fit_nmf_model, st_define_nmf_params


def main(progress_bar=None, n_dims: int = 2, verbose: bool = True, *, device=None,
         use_pallas=None) -> dict:
    tool = SignalTool(n_dims=n_dims)
    V, opt_nmf_params = tool.st_generate_input(verbose=verbose)

    nmf_params, fit_params = st_define_nmf_params(opt_nmf_params, verbose=verbose)
    nmf = fit_nmf_model(V, nmf_params, fit_params, progress_bar, device=device,
                        use_pallas=use_pallas)

    R = nmf.R
    tool.st_compare_signals(V, R, verbose=verbose)
    tool.st_compare_individual_signals(V, R, verbose=verbose)
    tool.st_plot_partial_reconstructions(V, nmf, verbose=verbose)
    return dict(energy=nmf._energy_function())


if __name__ == '__main__':
    main()
