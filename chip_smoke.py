#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card, ``nvcc`` and a
CUDA build of PyTorch (no JAX needed).  Phases, each of which raises on
failure (exit code != 0, no result line):

1. device: the card's name and power limit (``nvidia-smi``), torch and nvcc;
2. build: compiles ``tnmf_tpu_torch/csrc/*.cu`` for ``sm_90a`` into
   ``tnmf_tpu_torch/_build/`` (set-up time) and prints ptxas' resource report;
3. kernels: K1 ``mu_ratio``, K2 ``grad_w`` and K3 ``mu_h`` against their plain
   PyTorch versions on the card, at the flagship shapes and at two ragged
   small ones (one 1-D), within max|kernel - plain| / max|plain| <= 1e-4;
4. golden: the seeded golden 2-D fixture fit (tests/golden_values.json,
   '2d'/'valid') in float32 on the card, energy within rtol 1e-4;
5. flagship: ``TransformInvariantNMF(16, (9, 9)).fit`` on 64 x 1 x 256 x 256
   for 20 iterations with every launch counter reset before and read after;
   energy finite and below the initial one, unit-sum atoms, each kernel
   launched at least once per iteration; then MU ms/iteration (CUDA events);
6. per-kernel times at the flagship shapes, kernel against plain version.

The line before the last is ``{"kernels": [...]}`` with each kernel's
launches on the main path, error, and times; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tnmf_tpu_torch import TransformInvariantNMF, engine
from tnmf_tpu_torch.kernels import _build, gw, mu, mu_h
from tnmf_tpu_torch.ops import conv
from tnmf_tpu_torch.ops.modes import ConvPlan
from tnmf_tpu_torch.utils.data_loading import synthetic_face

ROOT = Path(__file__).resolve().parent
TOL = 1e-4            # max|kernel - plain| / max|plain|, float32 on the card
GOLDEN_RTOL = 1e-4    # float32 fit on the card against the float64 golden
N_ITER = 20
SEED = 0
FLAGSHIP = dict(N=64, C=1, S=(256, 256), M=16, A=(9, 9), mode='valid', sparsity=0.1)
KERNELS = {
    'mu_ratio': dict(wrapper=mu.mu_ratio, source='tnmf_tpu_torch/csrc/mu_ratio.cu',
                     replaces='tnmf_tpu/experimental/pallas_mu.py:62'),
    'grad_w': dict(wrapper=gw.grad_w, source='tnmf_tpu_torch/csrc/grad_w.cu',
                   replaces='tnmf_tpu/experimental/pallas_gw.py:163'),
    'mu_h': dict(wrapper=mu_h.mu_h, source='tnmf_tpu_torch/csrc/mu_h.cu',
                 replaces='tnmf_tpu/experimental/pallas_phased.py:169'),
}


def log(*args):
    print(*args, flush=True)


def sync():
    torch.cuda.synchronize()


def time_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    after one warm-up call."""
    fn()
    sync()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def reset_counts():
    for k in KERNELS.values():
        k['wrapper'].launches = 0


def counts() -> dict:
    return {name: k['wrapper'].launches for name, k in KERNELS.items()}


# ---------------------------------------------------------------- phases

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this check needs a CUDA card')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    nvcc = subprocess.run([_build.nvcc(), '--version'], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    log(f'torch {torch.__version__} (CUDA {torch.version.cuda}); nvcc: {nvcc}')
    return dict(platform='gpu', kind=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count(), smi=smi)


def phase_build():
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    log(f'build: {so.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s')
    report = so.with_name(so.name + '.log').read_text().splitlines()
    for line in report:
        if 'registers' in line or 'spill' in line or 'Compiling entry' in line:
            log('  ' + line.strip())


def _problem(N, C, S, M, A, mode, seed):
    """Random factors and the inputs each kernel gets from them on the main
    path (plain operators, float32 on the card)."""
    rng = np.random.default_rng(seed)
    plan = ConvPlan.create(mode, S, A)
    dev = dict(device='cuda', dtype=torch.float32)
    V = torch.tensor(rng.random((N, C) + S), **dev)
    W = rng.random((M, C) + A)
    W = torch.tensor(W / W.sum(axis=tuple(range(2, W.ndim)), keepdims=True), **dev)
    H = torch.tensor(rng.random((N, M) + plan.transform_shape), **dev)
    Vp = conv.prepare_data(V, plan)
    Rx = conv.extend_data(conv.reconstruct(W, H, plan), plan)
    X2 = torch.cat([Vp, Rx], dim=1)
    neg, pos = gw.grad_w_plain(X2, H, plan)
    neg, pos = neg.contiguous(), pos.contiguous()
    denom = engine.EPS + 0.1
    return {
        'mu_ratio': (lambda: mu.mu_ratio(W, neg, pos, engine.EPS),
                     lambda: mu.mu_ratio_plain(W, neg, pos, engine.EPS)),
        'grad_w': (lambda: gw.grad_w(X2, H, plan), lambda: gw.grad_w_plain(X2, H, plan)),
        'mu_h': (lambda: mu_h.mu_h(Vp, Rx, W, H, denom),
                 lambda: mu_h.mu_h_plain(Vp, Rx, W, H, denom)),
    }


def _compare(name, kernel, plain, where) -> float:
    got, want = kernel(), plain()
    sync()
    if isinstance(want, torch.Tensor):
        got, want = (got,), (want,)
    abs_err, scale = 0.0, 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f'{name} at {where}: shape {tuple(g.shape)} vs '
                                 f'{tuple(w.shape)} or non-finite output')
        abs_err = max(abs_err, float((g - w).abs().max()))
        scale = max(scale, float(w.abs().max()))
    rel = abs_err / scale
    log(f'  {name:9s} {where:28s} max_abs_err={abs_err:.3e} rel={rel:.3e}')
    if not rel <= TOL:
        raise AssertionError(f'{name} at {where}: kernel disagrees with its plain '
                             f'version (relative error {rel:.3e} > {TOL})')
    return abs_err


def phase_kernels() -> dict:
    """Each kernel against its plain version; returns the flagship errors."""
    f = FLAGSHIP
    cases = [
        ('flagship 64x1x256x256/16x9x9', (f['N'], f['C'], f['S'], f['M'], f['A'], f['mode'])),
        ('2-D 3x2x37x29/5x5x6 circular', (3, 2, (37, 29), 5, (5, 6), 'circular')),
        ('1-D 2x3x301/7x7 valid', (2, 3, (301,), 7, (7,), 'valid')),
    ]
    errors = {}
    for i, (where, args) in enumerate(cases):
        for name, (kernel, plain) in _problem(*args, seed=i).items():
            err = _compare(name, kernel, plain, where)
            if i == 0:
                errors[name] = err
    return errors


def _image_2d() -> np.ndarray:
    """The golden 2-D fixture, built as tests/fixtures.py builds it."""
    img = synthetic_face(gray=False)[::10, ::10]
    return np.repeat(img.transpose((2, 0, 1))[np.newaxis], 2, axis=0)


def _ms_per_iteration(model, sparsity, n=10) -> float:
    def run():
        model._W, model._H = engine.fit_loop(model._Vp, model._W, model._H, n, sparsity,
                                             plan=model._plan)
    return time_ms(run, reps=1) / n


def phase_golden() -> float:
    golden = json.loads((ROOT / 'tests' / 'golden_values.json').read_text())['2d']['valid']
    np.random.seed(42)
    nmf = TransformInvariantNMF(n_atoms=10, atom_shape=(7, 7), device='cuda')
    nmf.fit(_image_2d(), sparsity_H=0.1, n_iterations=10)
    e = nmf._energy_function()
    rel = abs(e - golden) / abs(golden)
    log(f'golden 2-D fixture: energy {e!r} vs {golden!r} (rel {rel:.3e})')
    if not rel <= GOLDEN_RTOL:
        raise AssertionError(f'golden energy off by {rel:.3e} > {GOLDEN_RTOL}')
    ms = _ms_per_iteration(nmf, 0.1)
    log(f'golden 2-D fixture: {ms:.4f} ms/iteration')
    return ms


def phase_flagship() -> tuple:
    f = FLAGSHIP
    V = np.random.default_rng(SEED).random((f['N'], f['C']) + f['S'], dtype=np.float32)

    def model():
        return TransformInvariantNMF(n_atoms=f['M'], atom_shape=f['A'],
                                     reconstruction_mode=f['mode'], seed=SEED, device='cuda')
    start = model()
    start.fit(V, n_iterations=0)
    e0 = start._energy_function()
    del start

    nmf = model()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    nmf.fit(V, n_iterations=N_ITER, sparsity_H=f['sparsity'])
    sync()
    wall = time.perf_counter() - t0
    launches = counts()

    e = nmf._energy_function()
    log(f'flagship: energy {e0!r} -> {e!r} after {N_ITER} iterations '
        f'({wall:.2f} s wall incl. host init); launches {launches}; '
        f'peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB')
    if not (math.isfinite(e) and e < e0):
        raise AssertionError(f'flagship energy {e} is not finite and below {e0}')
    sums = nmf._W.sum(dim=(-2, -1))
    if not torch.allclose(sums, torch.ones_like(sums), atol=1e-5):
        raise AssertionError(f'atoms do not sum to 1: {sums.flatten().tolist()}')
    for name, n in launches.items():
        if n < N_ITER:
            raise AssertionError(f'{name} launched {n} times in {N_ITER} iterations')
    ms = _ms_per_iteration(nmf, f['sparsity'])
    log(f'flagship: {ms:.4f} ms/iteration')
    return launches, ms, nmf


def phase_times(nmf) -> dict:
    """Kernel and plain version at the flagship shapes, in turns
    (plain, kernel, kernel, plain), plus the rest of one iteration."""
    f = FLAGSHIP
    fns = _problem(f['N'], f['C'], f['S'], f['M'], f['A'], f['mode'], seed=0)
    times = {}
    for name, (kernel, plain) in fns.items():
        p1, k1, k2, p2 = (time_ms(fn) for fn in (plain, kernel, kernel, plain))
        times[name] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2)
        log(f'  {name:9s} kernel {k1:.4f}/{k2:.4f} ms  plain {p1:.4f}/{p2:.4f} ms')
    W, H, plan = nmf._W, nmf._H, nmf._plan
    rec = time_ms(lambda: conv.reconstruct(W, H, plan))
    ext = time_ms(lambda: torch.cat([nmf._Vp, conv.extend_data(conv.reconstruct(W, H, plan),
                                                                plan)], dim=1)) - rec
    log(f'  reconstruct (cuDNN, TF32 off) {rec:.4f} ms; extend + stack {ext:.4f} ms')
    # K1 at the size of H, for its bandwidth (the main path calls it on W)
    big = [torch.rand_like(H) for _ in range(3)]
    k1 = time_ms(lambda: mu.mu_ratio(*big, 0.1))
    log(f'  mu_ratio at H size {tuple(H.shape)}: {k1:.4f} ms '
        f'({4 * 4 * H.numel() / k1 / 1e6:.0f} GB/s)')
    return times


def main() -> int:
    device = phase_device()
    phase_build()
    log('kernels against their plain versions:')
    errors = phase_kernels()
    phase_golden()
    launches, _, nmf = phase_flagship()
    log('per-kernel times at the flagship shapes:')
    times = phase_times(nmf)
    rows = [dict(name=name, route='cuda', source=k['source'], replaces=k['replaces'],
                 launches=launches[name], max_abs_err=errors[name], **times[name])
            for name, k in KERNELS.items()]
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': dict(platform=device['platform'],
                                                 kind=device['kind'], count=device['count'])}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
