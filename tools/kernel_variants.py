#!/usr/bin/env python3
"""Time source variants of the PyTorch port's kernels in turns on one CUDA card.

    python3 tools/kernel_variants.py [--variants base,k3_no_staging,...] [--parent DIR]

Run from the repository root on a machine with one CUDA card and ``nvcc``.
Each variant is a copy of ``tnmf_tpu_torch/`` under ``_variants/``
(git-ignored) with named edits to its CUDA sources (``VARIANTS``);
``--parent DIR`` adds the package of another checkout (for example the
parent commit unpacked with ``git archive``) as the variant ``parent``.
Each variant runs in its own process, which builds its own library and
times K3 ``mu_h`` (on the route the flagship takes and with its FP32 route
forced) and K2 ``grad_w`` at the flagship shapes (64 x 1 x 256 x 256, 16
atoms 9 x 9), K4 ``inhibited_mu_h`` at the inhibited flagship's (64 x
16 x 264 x 264, 17 x 17 taps, same + cross and same-atom only) and K5
``hals_sweep`` at the H side of plain-NMF HALS (16384 x 256, row-major),
its W side (4096 x 256 on transposed views, as the engine passes them) and
the rows of a shift-invariant phase (50176 x 16; CUDA events, two windows
of 20 launches).  The variants run
in the order given and then in reverse, so each one is timed twice around
the others.  Each process also times one MU iteration of the golden 2-D
fit and of the inhibited golden 1-D fit (nine windows of 10 iterations
each) and prints the registers of K3's
tensor-core kernel, a digest of its library's K2 SASS, which shows whether
a change meant to leave K2 alone did (with ``--parent``, each variant's
single-launch instances of K2-K5 against the parent's, function by
function), and digests of the bits of K3's, K2's
and K4's outputs at the flagship, of the golden 2-D and 1-D fits (W, H and
the energy, seeded as tests/fixtures.py seeds them), of the H updates
alone (W held) of the golden 1-D fit and of the inhibited settings of the
``sparsity_inhibition`` sweep, and of K5's outputs at its three shapes,
which show whether two packages compute the same bits.

The ablations compute wrong values: they are for finding what bounds a
kernel, never for its results.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WORK = ROOT / '_variants'
MARK = '// ------------------------------------------------------ tensor-core route'
_STAGE = 'if (q + gridDim.x < n_chunks) stage_windows<kVec>(vp, rx, raw, q + gridDim.x, s);'
_B_LOADS = [(f'{b}[j][{i}] = __float_as_uint(x{i}[{off}]);',
             f'{b}[j][{i}] = o.{"xy"[i]} + 8 * j + {off};')
            for b, off in (('vb', 0), ('rb', 'win'), ('vs', 'plane'), ('rs', 'plane + win'))
            for i in (0, 1)]
_XOR = '''__device__ __forceinline__ void xor_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  d[0] = __uint_as_float(__float_as_uint(d[0]) ^ a[0] ^ b0);
  d[1] = __uint_as_float(__float_as_uint(d[1]) ^ a[1] ^ b1);
}

''' + MARK

_SPLIT = 'for (int i = 4 * threadIdx.x; i < plane; i += 4 * kThreads) {'
# the big halves' loads, then the small halves' (3xTF32 only)
_SPLIT_PER_LOAD = ('\n'.join([' ' * 14 + old for old, _ in _B_LOADS[:4]]
                             + [' ' * 14 + 'if constexpr (kPasses == 3) {']
                             + [' ' * 16 + old for old, _ in _B_LOADS[4:]] + [' ' * 14 + '}']),
                   '\n'.join(' ' * 14 + f'split_tf32(x{i}[{off} - plane], {b}b[j][{i}], {b}s[j][{i}]);'
                             for b, off in (('v', 0), ('r', 'win')) for i in (0, 1)))

_K5_STEPS = 'if (threadIdx.x < nr) {'
_K5_PRODUCT = 'for (int k = 0; k < kChunk; k += 4) {'
_K5_LOADS = ('if (s + kStages - 1 < chunks) issue_chunk',
             'if (q == 0 && pi + 1 < panels) issue_panel')
_K5_WIDE = 'if (sc == 1 && sr % 4 == 0 && '

#: name -> edits (text, replacement) of the package's csrc/mu_h.cu, or
#: (source, text, replacement) of another csrc/ source, each applied to
#: every occurrence (and each must occur)
VARIANTS = {
    'base': [],
    # each MMA of the tensor-core kernel becomes two three-input XORs
    'k3_mma_as_xor': [(MARK, _XOR), ('mma_tf32(neg', 'xor_tf32(neg'),
                      ('mma_tf32(pos', 'xor_tf32(pos')],
    # the first version's design: the B values split into TF32 halves as
    # they load (here from the raw plane, which the next chunk refills)
    'k3_split_per_load': [
        (_SPLIT, _SPLIT.replace('i < plane', 'false && i < plane')), _SPLIT_PER_LOAD],
    # the B fragments come from registers instead of shared memory
    'k3_b_from_registers': _B_LOADS,
    # no epilogue (only neg[j][0] stays live, so the pos MMAs go too)
    'k3_no_epilogue': [('if (j >= nt || y >= s.ty) continue;',
                        'if (j >= nt || y >= s.ty || neg[j][0] != -1.f) continue;')],
    # every chunk computes on the first chunk's windows
    'k3_no_staging': [(_STAGE, _STAGE.replace('if (', 'if (false && '))],
    'k3_no_staging_no_split': [
        (_STAGE, _STAGE.replace('if (', 'if (false && ')),
        (_SPLIT, _SPLIT.replace('i < plane', 'q == blockIdx.x && i < plane'))],
    # K5 without the steps inside each panel (the running correlation)
    'k5_no_steps': [('hals_sweep.cu', _K5_STEPS,
                     _K5_STEPS.replace('if (', 'if (false && '))],
    # K5 without the panel products' FMAs (their loads and barriers stay)
    'k5_no_product': [('hals_sweep.cu', _K5_PRODUCT,
                       _K5_PRODUCT.replace('k < kChunk', 'k < 0'))],
    # K5 without the streamed copies of G[:, J], P and G[J, J] after the
    # prologue (the panels compute on stale buffers)
    'k5_no_loads': [('hals_sweep.cu', old, old.replace('if (', 'if (false && '))
                    for old in _K5_LOADS],
    # K5 staging a column-major G (the W side's A^T) element by element into
    # row-major chunks, not column by column
    'k5_g_walk': [('hals_sweep.cu', 'g_sc != 1 && g_sr == 1)', 'false)')],
    # K5 with 4-byte copies only (no 16-byte cp.async for contiguous rows)
    'k5_4byte_copies': [('hals_sweep.cu', _K5_WIDE, _K5_WIDE.replace('if (', 'if (false && '))],
}


def variant_edits(name: str) -> list:
    """The variant's edits as ``(source, text, replacement)``."""
    return [edit if len(edit) == 3 else ('mu_h.cu', *edit) for edit in VARIANTS[name]]


def make_copy(name: str) -> Path:
    """``_variants/<name>/tnmf_tpu_torch`` with the variant's edits."""
    dst = WORK / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / 'tnmf_tpu_torch', dst / 'tnmf_tpu_torch',
                    ignore=shutil.ignore_patterns('_build', '__pycache__'))
    for source, old, new in variant_edits(name):
        path = dst / 'tnmf_tpu_torch' / 'csrc' / source
        src = path.read_text()
        if old not in src:
            raise SystemExit(f'{name}: an edit of {source} no longer applies: {old!r}')
        path.write_text(src.replace(old, new))
    return dst


#: the kernels of K2-K5 whose single-launch instances :func:`single_sass`
#: compares: where each has its ``kModels`` template argument, and how many
#: template arguments it then has
_MODEL_ARG = {'grad_w_partial': (4, 5), 'grad_w_reduce': (0, 1),
              'inhibited_mu_h_kernel': (3, 6), 'mu_h_mma_kernel': (2, 3), 'mu_h_kernel': (0, 1),
              'hals_sweep_kernel': (3, 4)}
#: K4's ``kSummed`` template argument, last, after the arguments above: a
#: summed-route instance (``kSummed`` = 1) is left out like a model-axis one,
#: and a package without the summed route has no such argument
_SUMMED_ARG = {'inhibited_mu_h_kernel': 6}


def single_sass(sass: str) -> dict:
    """A digest of each single-launch instance's SASS (addresses dropped)
    in ``cuobjdump -sass`` output, by kernel and template arguments
    without ``kModels``; a model-axis instance (``kModels`` = 1) is left
    out, and a package without the model axis has no such argument."""
    out, key, lines = {}, None, []
    for line in sass.splitlines() + ['Function : end']:
        if 'Function :' in line:
            if key is not None:
                out[key] = hashlib.sha256('\n'.join(lines).encode()).hexdigest()[:16]
            key, lines = None, []
            m = re.search(r'\d+(' + '|'.join(_MODEL_ARG) + r')(I((?:L[ib]-?\d+E)+)E)?', line)
            if m:
                args = re.findall(r'L[ib](-?\d+)E', m.group(3) or '')
                at, count = _MODEL_ARG[m.group(1)]
                if m.group(1) in _SUMMED_ARG and len(args) == count + 1:
                    if args.pop(_SUMMED_ARG[m.group(1)]) == '1':
                        continue
                if len(args) == count:
                    if args.pop(at) == '1':
                        continue
                key = f'{m.group(1)}<{", ".join(args)}>'
        elif key is not None and '/*' in line and ';' in line:
            lines.append(re.sub(r'^/\*[0-9a-f]+\*/\s*', '', line.split(';')[0].strip()))
    return out


def time_package(root: Path) -> dict:
    """In this process: K3 and K2 at the flagship from the package in
    ``root``, its K3 registers and its K2 SASS digest."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import tnmf_tpu_torch
    if not Path(tnmf_tpu_torch.__file__).resolve().is_relative_to(root.resolve()):
        raise SystemExit(f'imported {tnmf_tpu_torch.__file__}, not the package in {root}')
    from tnmf_tpu_torch.kernels import _build, gw, hals, inhibit, mu_h
    from tnmf_tpu_torch.ops.inhibition import inhibition_kernels
    from tnmf_tpu_torch.ops.modes import ConvPlan
    so = _build.build()
    _build.library()
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.tensor(rng.random(shape), device='cuda', dtype=torch.float32)
    Vp, Rx, W, H = t(64, 1, 272, 272), t(64, 1, 272, 272), t(16, 1, 9, 9), t(64, 16, 264, 264)
    X2, plan = torch.cat([Vp, Rx], dim=1), ConvPlan.create('valid', (256, 256), (9, 9))
    # K2's wrapper reads its shapes from the tensors; a parent's took the plan
    k2_args = (X2, H) + ((plan,) if 'plan' in inspect.signature(gw.grad_w).parameters else ())

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(2):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(20):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / 20)
        return out
    sass = subprocess.run([str(Path(_build.nvcc()).with_name('cuobjdump')), '-sass', str(so)],
                          capture_output=True, text=True, check=True).stdout
    digest, inside = hashlib.sha256(), False
    k4_digest, k4_inside = hashlib.sha256(), False
    for line in sass.splitlines():
        if 'Function :' in line:
            # the 3xTF32 instances of a single launch alone: a parent
            # without the one-pass route and the model axis has no other (a
            # one-pass instance's name ends its template arguments with
            # kPasses = 1, or with kPasses = 1 and kModels = 0; a model-axis
            # instance's with kModels = 1)
            inside = ('grad_w' in line and not re.search(r'Li1E(?:Lb0E)?EEv', line)
                      and not re.search(r'Lb1EE+v', line))
            # the 17-tap instances of a single launch alone (a model-axis
            # instance's name has kModels = 1 just before its tap count, a
            # summed-route one kSummed = 1 after its kStream)
            k4_inside = ('inhibited_mu_h_kernel' in line and 'Li17E' in line
                         and not re.search(r'ELb[01]ELb1ELi17E', line)
                         and not re.search(r'Li17ELb0ELb1E', line))
        elif '/*' in line:
            if inside:
                digest.update(line.split(';')[0].strip().encode())
            if k4_inside:
                k4_digest.update(line.split(';')[0].strip().encode())
    regs, entry = None, ''
    for line in so.with_name(so.name + '.log').read_text().splitlines():
        if 'Compiling entry' in line:
            entry = line
        elif ('Used ' in line and 'mu_h_mma_kernelILi4E' in entry
              and 'ILi4ELi1E' not in entry  # the 3xTF32 instance
              and 'Lb1EEv' not in entry):  # of a single launch (kModels = 0)
            regs = int(line.split('Used ')[1].split()[0])
    routes = mu_h._ROUTES
    mu_h._ROUTES = ('fma',)
    fma_ms, fma_out = ms(lambda: mu_h.mu_h(Vp, Rx, W, H, 0.1)), mu_h.mu_h(Vp, Rx, W, H, 0.1)
    mu_h._ROUTES = routes
    Hi, neg, pos = t(64, 16, 264, 264), t(64, 16, 264, 264), t(64, 16, 264, 264)
    ks = [torch.tensor(k, device='cuda', dtype=torch.float32) for k in inhibition_kernels((8, 8))]

    def k4(cross):
        return inhibit.inhibited_mu_h(Hi, neg, pos, ks, 0.1, 0.05, 0.1, use_cross=cross)
    k5 = {where: k5_inputs(*shape) for where, shape in K5_SHAPES.items()}
    return dict(mu_h_ms=ms(lambda: mu_h.mu_h(Vp, Rx, W, H, 0.1)),
                inhibited_mu_h_ms=ms(lambda: k4(True)),
                inhibited_mu_h_same_ms=ms(lambda: k4(False)),
                mu_h_fma_ms=fma_ms,
                grad_w_ms=ms(lambda: gw.grad_w(*k2_args)),
                hals_sweep_ms={where: ms(lambda a=a: hals.hals_sweep(*a))
                               for where, a in k5.items()},
                mu_h_mma_registers=regs,
                grad_w_sass=digest.hexdigest()[:16],
                inhibited_mu_h_17_sass=k4_digest.hexdigest()[:16],
                single_sass=single_sass(sass),
                bits=dict(mu_h=bits(mu_h.mu_h(Vp, Rx, W, H, 0.1)), mu_h_fma=bits(fma_out),
                          grad_w=bits(*gw.grad_w(*k2_args)),
                inhibited_mu_h=bits(k4(True), k4(False)),
                hals_sweep={where: bits(hals.hals_sweep(*a)) for where, a in k5.items()},
                **golden_bits()))


#: K5's shapes: (rows, components, length of the factor the Gram sums over,
#: transposed views)
K5_SHAPES = {'H 16384x256': (16384, 256, 4096, False), 'W 4096x256': (4096, 256, 16384, True),
             'phase 50176x16': (50176, 16, 81, False)}


def k5_inputs(rows: int, m: int, length: int, views: bool) -> tuple:
    """K5's arguments as a HALS sweep meets them (``G = Y Y^T``, ``P = Z
    Y^T`` of data near the span of ``Y``, a random start; one pass,
    ``l1 = 0.1 / length``), seeded; on the W side transposed views of
    contiguous tensors."""
    import torch
    g = torch.Generator(device='cuda').manual_seed(rows + m)
    Y = torch.rand((m, length), generator=g, device='cuda')
    Y /= Y.sum(dim=1, keepdim=True)
    Z = (torch.rand((rows, m), generator=g, device='cuda') @ Y
         + 0.01 * torch.rand((rows, length), generator=g, device='cuda') / length)
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('highest')
    G, P = Y @ Y.T, Z @ Y.T
    torch.set_float32_matmul_precision(prec)
    X = torch.rand((rows, m), generator=g, device='cuda')
    if views:
        X, G, P = (t.T.contiguous().T for t in (X, G, P))
    return X, G, P, 0.1 / length, 0.0, 1


def bits(*tensors) -> str:
    """A digest of the bytes of ``tensors`` (on any device)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def golden_bits() -> dict:
    """Digests of the golden 2-D fit and the inhibited 1-D pulse-train fit
    ('valid') on the card, in float32, seeded as tests/fixtures.py seeds
    them, with their energies."""
    import numpy as np
    import torch
    from tnmf_tpu_torch import TransformInvariantNMF
    from tnmf_tpu_torch.utils.data_loading import synthetic_face
    from tnmf_tpu_torch.utils.signals import generate_pulse_train
    out = {}
    image = np.repeat(synthetic_face(gray=False)[::10, ::10].transpose((2, 0, 1))[None], 2, 0)
    np.random.seed(42)
    nmf = TransformInvariantNMF(n_atoms=10, atom_shape=(7, 7), device='cuda')
    nmf.fit(image, sparsity_H=0.1, n_iterations=10)
    out['golden_2d'] = (bits(nmf._W, nmf._H), repr(nmf._energy_function()))
    out['golden_2d_ms'] = [golden_ms(nmf, 0.1) for _ in range(9)]
    for key, update_W in (('golden_1d', True), ('golden_1d_H', False)):
        nmf = TransformInvariantNMF(n_atoms=3, atom_shape=(20,), device='cuda')
        np.random.seed(42)  # the pulse train reseeds; the fit draws after it
        signal, _ = generate_pulse_train(pulse_length=20, n_pulses=5)
        nmf.fit(signal[None], n_iterations=10, inhibition_strength=0.1, update_W=update_W)
        out[key] = (bits(nmf._W, nmf._H), repr(nmf._energy_function()))
        if update_W:
            out['golden_1d_ms'] = [golden_ms(nmf, 0.0, 0.1, 0.0, nmf._kernels,
                                             use_inhibition=True) for _ in range(9)]
    h = []
    for fit in (dict(inhibition_strength=0.1), dict(inhibition_strength=1.0),
                dict(cross_atom_inhibition_strength=0.5),
                dict(sparsity_H=0.5, inhibition_strength=0.5, cross_atom_inhibition_strength=0.5)):
        np.random.seed(42)
        nmf = TransformInvariantNMF(n_atoms=5, atom_shape=(5, 5), device='cuda')
        nmf.fit(image, n_iterations=10, update_W=False, **fit)
        h.append(nmf._H)
    out['sparsity_inhibition_H'] = bits(*h)
    torch.cuda.synchronize()
    return out


def golden_ms(nmf, *strengths, **flags) -> float:
    """Device time of one MU iteration of a fitted golden model with
    ``strengths`` (CUDA events around 10 iterations, after one)."""
    import torch
    from tnmf_tpu_torch import engine

    def run(n):
        engine.fit_loop(nmf._Vp, nmf._W, nmf._H, n, *strengths, plan=nmf._plan, **flags)
    run(1)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    run(10)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--variants', default=','.join(VARIANTS))
    ap.add_argument('--parent', type=Path, help='a checkout whose package runs as "parent"')
    ap.add_argument('--time', type=Path, help=argparse.SUPPRESS)  # worker: one package
    args = ap.parse_args()
    if args.time:
        print(json.dumps(time_package(args.time)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('kernel_variants: this script needs a CUDA card')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dirs = {name: make_copy(name) for name in args.variants.split(',')}
    if args.parent:
        dirs['parent'] = args.parent.resolve()
    order = list(dirs) + list(dirs)[::-1]
    results = {name: [] for name in dirs}
    for name in order:
        proc = subprocess.run([sys.executable, __file__, '--time', str(dirs[name])],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise SystemExit(f'{name} failed:\n{proc.stdout}{proc.stderr}')
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        results[name].append(r)
        print(f'{name:24s} mu_h {r["mu_h_ms"][0]:.4f}/{r["mu_h_ms"][1]:.4f} ms  FP32 route '
              f'{r["mu_h_fma_ms"][0]:.4f}/{r["mu_h_fma_ms"][1]:.4f} ms  grad_w '
              f'{r["grad_w_ms"][0]:.4f}/{r["grad_w_ms"][1]:.4f} ms  K4 '
              f'{r["inhibited_mu_h_ms"][0]:.4f}/{r["inhibited_mu_h_ms"][1]:.4f} ms, same-atom '
              f'{r["inhibited_mu_h_same_ms"][0]:.4f}/{r["inhibited_mu_h_same_ms"][1]:.4f} ms  K5 '
              + '  '.join(f'{where} {t[0]:.4f}/{t[1]:.4f} ms'
                          for where, t in r['hals_sweep_ms'].items()) + '  '
              f'K3 registers '
              f'{r["mu_h_mma_registers"]}  K2 SASS {r["grad_w_sass"]}  K4 17-tap SASS '
              f'{r["inhibited_mu_h_17_sass"]}  golden 2-D ms/it '
              + '/'.join(f'{t:.4f}' for t in r['bits'].pop('golden_2d_ms'))
              + '  golden 1-D inhibited ms/it '
              + '/'.join(f'{t:.4f}' for t in r['bits'].pop('golden_1d_ms'))
              + f'  bits {r["bits"]}', flush=True)
    if 'parent' in results:
        want = results['parent'][0]['single_sass']
        for name, runs in results.items():
            if name != 'parent':
                got = runs[0]['single_sass']
                differ = sorted(k for k in want if got.get(k) != want[k])
                print(f'{name}: SASS of the single-launch instances of K2-K5 against the '
                      f'parent\'s: {len(want) - len(differ)} of {len(want)} equal; differ: '
                      f'{differ}', flush=True)
    print(json.dumps(results))
    return 0


if __name__ == '__main__':
    sys.exit(main())
