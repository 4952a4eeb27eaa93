#!/usr/bin/env python3
"""Time K4's streamed route on every tile and shared-memory budget on one CUDA card.

    python3 tools/k4_streamed_tiles.py [--out TABLE.json]

Run from the repository root on a machine with one CUDA card and ``nvcc``.
For stencils that no K4 tile holds in one piece (the inhibited flagship,
64 x 16 x 264 x 264, with ``inhibition_range=120``; 1 x 4 x 300 x 300 with
ranges 120 and 200; 1 x 2 x 60,000 with range 20,000), same-atom and with
the cross-atom term, it launches ``inhibited_mu_h`` on every tile of
``inhibit._tiles`` with the largest segments that fit four, three, two and
one blocks per SM (``inhibit._streamed``), times each (CUDA events) and
prints the fastest beside the geometry ``inhibit._geometry`` chooses;
``--out`` also writes the full table as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CASES = [((64, 16, 264, 264), (120, 120)), ((1, 4, 300, 300), (120, 120)),
         ((1, 4, 300, 300), (200, 200)), ((1, 2, 60000), (20000,))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', type=Path, help='a JSON file for the full table')
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('k4_streamed_tiles: this script needs a CUDA card')
    from tnmf_tpu_torch.kernels import _build, inhibit
    from tnmf_tpu_torch.ops.inhibition import inhibition_kernels
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    _build.library()
    chosen_geometry = inhibit._geometry

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    table = []
    for dims, ranges in CASES:
        H, neg, pos = (torch.rand(dims, device='cuda') for _ in range(3))
        ks = inhibition_kernels(ranges)
        two_d = len(ranges) == 2
        tx, ty = (2 * ranges[0] + 1, 2 * ranges[1] + 1) if two_d else (1, 2 * ranges[0] + 1)
        X, Y = dims[2:] if two_d else (1, dims[2])
        for cross in (False, True):
            chosen = chosen_geometry(dims[1], tx, ty, two_d, X, Y, False, cross)
            rows, seen = [], set()
            for blocks in (4, 3, 2, 1):
                limit = min((233472 - blocks * 1024) // blocks, _build.MAX_SMEM_BYTES)
                for tile_x, tile_y in inhibit._tiles(tx, ty, two_d, X, Y):
                    g = inhibit._streamed(tile_x, tile_y, tx, ty, two_d, cross, limit)
                    if g is None:
                        continue
                    key = (tile_x, tile_y, g['seg_x'], g['seg_y'])
                    if key in seen:
                        continue
                    seen.add(key)
                    n_seg = -(-tx // g['seg_x']) * -(-ty // g['seg_y'])
                    geo = dict(g, n_segments=n_seg,
                               blocks_per_sm=min(4, 233472 // (g['smem_bytes'] + 1024)))
                    inhibit._geometry = lambda *a, **k: geo
                    try:
                        t = ms(lambda: inhibit.inhibited_mu_h(H, neg, pos, ks, 0.1, 0.05, 0.1,
                                                              use_cross=cross),
                               reps=2 if dims[0] > 1 else 5)
                    finally:
                        inhibit._geometry = chosen_geometry
                    rows.append(dict(dims=dims, taps=(tx, ty), cross=cross, tile_x=tile_x,
                                     tile_y=tile_y, seg_x=g['seg_x'], seg_y=g['seg_y'],
                                     n_segments=n_seg, smem_bytes=g['smem_bytes'],
                                     blocks_per_sm=geo['blocks_per_sm'], ms=t,
                                     chosen=key == (chosen['tile_x'], chosen['tile_y'],
                                                    chosen['seg_x'], chosen['seg_y'])))
            rows.sort(key=lambda r: r['ms'])
            table += rows
            print(f'{dims} {tx}x{ty} taps, cross={cross}:', flush=True)
            for r in rows[:8] + [r for r in rows[8:] if r['chosen']]:
                print(f'  {r["tile_x"]:3d} x {r["tile_y"]:<4d} segments of {r["seg_x"]} x '
                      f'{r["seg_y"]} ({r["n_segments"]}), {r["blocks_per_sm"]} blocks/SM: '
                      f'{r["ms"]:.4f} ms{"  <- chosen" if r["chosen"] else ""}', flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(table))
    return 0


if __name__ == '__main__':
    sys.exit(main())
