#!/usr/bin/env python3
"""Where an example's time goes on one CUDA card, on the kernels and plain.

    python3 tools/example_breakdown.py [--example NAME ...] [--out FILE.json]

Run from the repository root on a machine with one CUDA card and ``nvcc``.
For each example of ``tnmf_tpu_torch.examples`` (default
``shift_invariant_decomposition``) it prints:

* ``run(smoke=False)`` on the kernels and with ``use_pallas=False`` in
  turns (plain, kernels, kernels, plain, after one warm-up run of each),
  milliseconds between CUDA events around ``run``;
* one run of each route under ``torch.profiler``: the device's busy time
  (the sum of the device events, idle share against the run's wall time),
  the number of device events, and the operations with the most self
  device time and the most self CPU time;
* each kernel of ``tnmf_tpu_torch.engine`` that the run launches (``mu_h``,
  ``inhibited_mu_h``, ``grad_w``, ``mu_w``, ``mu_ratio``) alone, on a copy
  of the inputs of its first call in the run, against its plain version
  (plain, kernel, kernel, plain; CUDA events, 20 calls each).

The last line is one JSON object with every number; ``--out`` writes it
to a file as well.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: engine's kernel entry points, each beside the plain version the engine
#: calls with the same arguments when the kernels are off
KERNEL_FNS = (('mu_h', 'mu_h_plain'), ('inhibited_mu_h', 'inhibited_mu_h_plain'),
              ('grad_w', 'grad_w_plain'), ('mu_w', 'mu_w_plain'),
              ('mu_ratio', 'mu_ratio_plain'))
TOP = 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--example', nargs='+', default=['shift_invariant_decomposition'])
    ap.add_argument('--out', type=Path, help='a JSON file for the numbers')
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('example_breakdown: this script needs a CUDA card')
    from torch.profiler import ProfilerActivity, profile

    from tnmf_tpu_torch import engine
    from tnmf_tpu_torch.kernels import _build
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    _build.library()

    def event_ms(fn, reps=1):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def device_us(e):
        return getattr(e, 'self_device_time_total', None) or getattr(e, 'self_cuda_time_total', 0)

    def profiled(fn) -> dict:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = event_ms(fn)
        device = [e for e in prof.events() if str(e.device_type).endswith('CUDA')]
        busy = sum(e.time_range.elapsed_us() for e in device) / 1e3
        avg = prof.key_averages()
        by_dev = sorted(avg, key=device_us, reverse=True)[:TOP]
        by_cpu = sorted(avg, key=lambda e: e.self_cpu_time_total, reverse=True)[:TOP]
        return dict(wall_ms=wall, device_busy_ms=busy, idle_share=1 - busy / wall,
                    device_events=len(device),
                    top_device=[(e.key, device_us(e) / 1e3, e.count) for e in by_dev],
                    top_cpu=[(e.key, e.self_cpu_time_total / 1e3, e.count) for e in by_cpu])

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.detach().clone()
        if isinstance(x, (list, tuple)):
            return type(x)(clone(v) for v in x)
        return x

    out = dict(card=card, examples={})
    for name in args.example:
        module = importlib.import_module(f'tnmf_tpu_torch.examples.{name}')

        def kernels():
            return module.run(device='cuda')

        def plain():
            return module.run(device='cuda', use_pallas=False)
        kernels(), plain()
        p1, k1, k2, p2 = (event_ms(fn) for fn in (plain, kernels, kernels, plain))
        print(f'{name}: run on the kernels {k1:.1f}/{k2:.1f} ms, plain {p1:.1f}/{p2:.1f} ms '
              '(plain, kernels, kernels, plain)', flush=True)
        row = dict(kernels_ms=[k1, k2], plain_ms=[p1, p2])
        for label, fn in (('kernels', kernels), ('plain', plain)):
            row[f'profile_{label}'] = p = profiled(fn)
            print(f'  profiled {label}: wall {p["wall_ms"]:.1f} ms, device busy '
                  f'{p["device_busy_ms"]:.1f} ms (idle share {p["idle_share"]:.3f}), '
                  f'{p["device_events"]} device events', flush=True)
            for key, ms, count in p['top_device']:
                print(f'    device {ms:9.3f} ms {count:6d}x {key[:90]}')
            for key, ms, count in p['top_cpu']:
                print(f'    cpu    {ms:9.3f} ms {count:6d}x {key[:90]}')

        # the first call of each engine kernel in one run on the kernels
        first, originals = {}, {k: getattr(engine, k) for k, _ in KERNEL_FNS}

        def capture(k):
            def fn(*a, **kw):
                first.setdefault(k, (clone(a), clone(kw)))
                return originals[k](*a, **kw)
            return fn
        for k, _ in KERNEL_FNS:
            setattr(engine, k, capture(k))
        try:
            kernels()
        finally:
            for k, fn in originals.items():
                setattr(engine, k, fn)
        row['alone'] = {}
        for k, plain_name in KERNEL_FNS:
            if k not in first:
                continue
            a, kw = first[k]
            kern, ref = originals[k], getattr(engine, plain_name)
            got, want = kern(*a, **kw), ref(*a, **kw)
            got, want = (x[0] if isinstance(x, tuple) else x for x in (got, want))
            err = float((got - want).abs().max())
            q1, c1, c2, q2 = (event_ms(lambda f=f: f(*a, **kw), reps=20)
                              for f in (ref, kern, kern, ref))
            shapes = [tuple(x.shape) for x in a if isinstance(x, torch.Tensor)]
            row['alone'][k] = dict(shapes=shapes, ms=[c1, c2], plain_ms=[q1, q2],
                                   max_abs_err=err)
            print(f'  {k} alone at {shapes}: kernel {c1:.4f}/{c2:.4f} ms, plain '
                  f'{q1:.4f}/{q2:.4f} ms, max |kernel - plain| {err:.3e}', flush=True)
        out['examples'][name] = row
    line = json.dumps(out)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + '\n')
    print(line)
    return 0


if __name__ == '__main__':
    sys.exit(main())
