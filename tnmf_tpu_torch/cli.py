"""Command-line interface of the PyTorch port (port of :mod:`tnmf_tpu.cli`).

* ``tnmf-tpu-torch example <name>`` runs one of the port's examples
  (``python -m tnmf_tpu_torch.examples.<name>``) in a subprocess;
* ``tnmf-tpu-torch demo [name] [--headless]`` serves the demo dashboard
  through streamlit, or runs one demo once with the widget defaults
  (``--headless``, no streamlit needed);
* ``tnmf-tpu-torch export checkpoint output`` serializes a checkpoint (a
  ``.npz`` of either package's ``save``) into a serving artifact on the card
  (:func:`tnmf_tpu_torch.serving.export_serving`).

``bench`` is not ported yet (ROADMAP.md queue 1, item 5): it takes any
arguments, exits with status 1 and says so.  No command runs the JAX
package's scripts.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from .demos.demo_selector import DEMO_NAME_DICT
from .examples import EXAMPLES

DEMO_NAMES = list(DEMO_NAME_DICT)
PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
SELECTOR = os.path.join(PACKAGE_DIR, 'demos', 'demo_selector.py')


def _run_module(module: str, *args: str) -> int:
    """``python -m module args`` in a subprocess that imports this copy of
    the package (its parent directory first on ``PYTHONPATH``)."""
    path = [os.path.dirname(PACKAGE_DIR), os.environ.get('PYTHONPATH', '')]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in path if p))
    return subprocess.call([sys.executable, '-m', module, *args], env=env)


def _not_ported(what: str, item: str) -> int:
    print(f'{what} is not ported to tnmf_tpu_torch yet (ROADMAP.md queue 1, item {item}); '
          'the JAX package runs it: python -m tnmf_tpu.cli', file=sys.stderr)
    return 1


def list_examples() -> list:
    """The port's examples, by name."""
    return sorted(EXAMPLES)


def cmd_demo(args) -> int:
    if args.headless:
        return _run_module('tnmf_tpu_torch.demos.demo_selector', args.name)
    try:
        import streamlit  # noqa: F401
    except ImportError:
        print('streamlit is not installed; run with --headless for a '
              'non-interactive pass using the widget defaults.', file=sys.stderr)
        return 1
    return _run_module('streamlit', 'run', SELECTOR, '--', args.name)


def cmd_example(args) -> int:
    examples = list_examples()
    if args.name not in examples:
        print(f'unknown example {args.name!r}; available: {", ".join(examples)}',
              file=sys.stderr)
        return 1
    return _run_module(f'tnmf_tpu_torch.examples.{args.name}')


def cmd_export(args) -> int:
    from .models.tnmf import TransformInvariantNMF
    model = TransformInvariantNMF.load(args.checkpoint)
    kwargs = {}
    if args.sample_shape:
        kwargs['sample_shape'] = tuple(args.sample_shape)
    try:
        model.export_serving(
            path=args.output, n_iterations=args.iterations,
            sparsity_H=args.sparsity, include_decoder=args.decoder,
            **kwargs)
    except (RuntimeError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 1
    print(f'wrote {args.output}')
    return 0


def cmd_bench(args) -> int:
    return _not_ported("the port's benchmark", '5')


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='tnmf-tpu-torch',
        description='Transform-invariant NMF on PyTorch and CUDA: demos, examples, '
                    'serving export (the benchmark is not ported yet).')
    sub = parser.add_subparsers(dest='command', required=True)

    p_demo = sub.add_parser('demo', help='launch the interactive demo dashboard')
    p_demo.add_argument('name', nargs='?', default='2-D Synthetic Signals',
                        choices=DEMO_NAMES)
    p_demo.add_argument('--headless', action='store_true',
                        help='run once with widget defaults, no streamlit server')
    p_demo.set_defaults(func=cmd_demo)

    p_ex = sub.add_parser('example', help='run a bundled example script')
    p_ex.add_argument('name', help=f'one of: {", ".join(list_examples())}')
    p_ex.set_defaults(func=cmd_example)

    # not ported yet: takes any arguments (parse_known_args below)
    sub.add_parser('bench', help='run the benchmark harness (not ported)').set_defaults(
        func=cmd_bench)

    p_exp = sub.add_parser(
        'export', help='serialize a checkpoint into a serving artifact '
        '(torch.export; see tnmf_tpu_torch.serving)')
    p_exp.add_argument('checkpoint', help='.npz checkpoint from model.save()')
    p_exp.add_argument('output', help='artifact path to write')
    p_exp.add_argument('--iterations', type=int, default=100,
                       help='default MU refinement count baked in the header')
    p_exp.add_argument('--sparsity', type=float, default=0.,
                       help='sparsity_H strength baked into the program')
    p_exp.add_argument('--decoder', action='store_true',
                       help='also ship inverse_transform (full codec)')
    p_exp.add_argument('--sample-shape', type=int, nargs='+', default=None,
                       help='sample geometry for W-only checkpoints')
    p_exp.set_defaults(func=cmd_export)

    args, rest = parser.parse_known_args(argv)
    if rest and args.func is not cmd_bench:
        parser.error(f'unrecognized arguments: {" ".join(rest)}')
    return args.func(args)


if __name__ == '__main__':
    sys.exit(main())
