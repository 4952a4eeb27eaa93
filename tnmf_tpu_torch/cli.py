"""Command-line interface of the PyTorch port (port of :mod:`tnmf_tpu.cli`).

``tnmf-tpu-torch export checkpoint output`` serializes a checkpoint (a
``.npz`` of either package's ``save``) into a serving artifact on the card
(:func:`tnmf_tpu_torch.serving.export_serving`).  The JAX package's other
commands are not ported yet: ``demo`` and ``example`` (ROADMAP.md queue 1,
item 14d-ii) and ``bench`` (item 5) take any arguments, exit with status 1
and say so; none of them runs the JAX package's scripts.
"""

from __future__ import annotations

import argparse
import sys

def _not_ported(what: str, item: str) -> int:
    print(f'{what} is not ported to tnmf_tpu_torch yet (ROADMAP.md queue 1, item {item}); '
          'the JAX package runs it: python -m tnmf_tpu.cli', file=sys.stderr)
    return 1


def cmd_demo(args) -> int:
    return _not_ported('the demo dashboard', '14d-ii')


def cmd_example(args) -> int:
    return _not_ported('the bundled examples', '14d-ii')


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
        description='Transform-invariant NMF on PyTorch and CUDA: serving export '
                    '(demos, examples and benchmarks are not ported yet).')
    sub = parser.add_subparsers(dest='command', required=True)

    # the commands not ported yet take any arguments (parse_known_args below)
    for name, func, text in (('demo', cmd_demo, 'launch the interactive demo dashboard'),
                             ('example', cmd_example, 'run a bundled example script'),
                             ('bench', cmd_bench, 'run the benchmark harness')):
        sub.add_parser(name, help=f'{text} (not ported)').set_defaults(func=func)

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
    if rest and args.func is cmd_export:
        parser.error(f'unrecognized arguments: {" ".join(rest)}')
    return args.func(args)


if __name__ == '__main__':
    sys.exit(main())
