"""Lazy build and load of the hand-written CUDA kernels.

All ``tnmf_tpu_torch/csrc/*.cu`` files compile with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source, all started together, and link into
one shared library with a plain C interface, which is loaded with
:mod:`ctypes`.  The library is named by a hash of the sources
and the flags, so an edited source triggers a rebuild and an unchanged one
loads the cached build.  The build runs at the first kernel launch, never at
import, so the package imports and its CPU tests run without ``nvcc``.

The build directory (``tnmf_tpu_torch/_build/``) is listed in
``.gitignore``.  ``nvcc``'s resource report (``-Xptxas -v``: registers,
shared memory and spills per kernel) and each source's compile time are
kept beside the library as ``<library>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_P, _F, _I, _I64 = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int64

#: C entry points and their argument types; each returns a cudaError_t
SIGNATURES = {
    # arr, neg, pos, reg, regs (per model, or null), per_model, out, n, stream
    'tnmf_mu_ratio': (_P, _P, _P, _F, _P, _I64, _P, _I64, _P),
    # w, neg, pos, reg, out, rows, row_len, stream
    'tnmf_mu_w': (_P, _P, _P, _F, _P, _I64, _I64, _P),
    # x2, h, out, scratch, n, m, c2, tx, ty, ax, ay, geometry (int[15]),
    # group (int[6]), grid_x, grid_y, smem_bytes, models, stream
    'tnmf_grad_w': (_P,) * 4 + (_I,) * 7 + (_P, _P) + (_I,) * 4 + (_P,),
    # vp, rx, w, h, pos_extra, denom_add, out, n, m, c, ex, ey, tx, ty, ax, ay,
    # pitch, seg_c, seg_ax, seg_ay, smem_bytes, denoms (per model, or null),
    # models, vp_model_stride, stream
    'tnmf_mu_h': (_P, _P, _P, _P, _P, _F, _P) + (_I,) * 14 + (_P, _I, _I64, _P),
    # vp, rx, w, h, pos_extra, denom_add, out, n, m, c, tx, ty, ax, ay,
    # geometry (int[11]), grid_x, smem_bytes, denoms, models, vp_model_stride,
    # stream
    'tnmf_mu_h_mma': (_P, _P, _P, _P, _P, _F, _P) + (_I,) * 7 + (_P,) + (_I,) * 2
                     + (_P, _I, _I64, _P),
    # h, neg, pos, taps, out, n, m, x, y, tx, ty, tile_x, tile_y, hp, xtp, npp,
    # inh, cross, reg, use_same, use_cross, two_d, vec, h_vec, h_bufs, compiled,
    # seg_x, seg_y, smem_bytes, strengths (per model, or null), n_per_model,
    # models, hsum (the summed route's atoms' sum, or null), stream
    'tnmf_inhibited_mu_h': (_P,) * 5 + (_I,) * 11 + (_F,) * 3 + (_I,) * 10 + (_P, _I, _I, _P,
                                                                             _P),
    # x, g, p, out, each with its row and column strides; l1, l2, inner, rows,
    # m, rows_per_block, resident, smem_bytes, stream
    'tnmf_hals_sweep': (_P, _I64, _I64) * 4 + (_F, _F, _I, _I64, _I, _I, _I, _I, _P),
    # x, g, p, out, each with its model, row and column strides; l1, l2 (per
    # model), models, inner, rows, m, rows_per_block, resident, smem_bytes,
    # stream
    'tnmf_hals_sweep_models': (_P, _I64, _I64, _I64) * 4 + (_P, _P, _I, _I, _I64, _I, _I, _I,
                                                             _I, _P),
}

#: the largest dynamic shared memory a Hopper block may opt in to (bytes)
MAX_SMEM_BYTES = 232448

_lib = None


def segments(C: int, Ax: int, Ay: int, fits) -> tuple:
    """``(channels, atom rows, atom columns)`` of the segments, or launch
    groups, that a kernel splits ``C`` channels of ``Ax x Ay`` taps into so
    that each ``fits(channels, rows, columns)`` a block: all the taps when
    they fit, else whole channels, else whole atom rows of one channel,
    else a stretch of one atom row, the fewest near-equal pieces that fit
    (``fits`` grows false with each size).  The taps stay in ``(c, ax,
    ay)`` order either way."""
    def size(n, ok):
        lo, hi = 1, n  # the largest size that fits, by bisection
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if ok(mid) else (lo, mid - 1)
        return -(-n // -(-n // lo))  # the same count of near-equal pieces

    sc, sa, sb = C, Ax, Ay
    if not fits(C, Ax, Ay):
        sc = size(C, lambda k: fits(k, Ax, Ay))
        if not fits(1, Ax, Ay):
            sa = size(Ax, lambda k: fits(1, k, Ay))
            if not fits(1, 1, Ay):
                sb = size(Ay, lambda k: fits(1, 1, k))
    return sc, sa, sb


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on
    ``PATH``, else the toolkit's default install location."""
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    candidates = [Path(home) / 'bin' / 'nvcc'] if home else []
    on_path = shutil.which('nvcc')
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path('/usr/local/cuda/bin/nvcc'))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        'nvcc not found (set CUDA_HOME): the CUDA kernels of tnmf_tpu_torch '
        'are built from source at first use')


def library_path() -> Path:
    """Where the build of the current sources lives (whether built or not)."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sorted(SOURCE_DIR.glob('*.cu*')):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f'libtnmf_kernels_{h.hexdigest()[:16]}.so'


def _run(cmd: list) -> tuple:
    """Run ``cmd``: ``(its output, its seconds)``; raise with the output
    when it fails."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f'nvcc failed with exit code {proc.returncode}:\n'
            f'{" ".join(cmd)}\n{proc.stdout}{proc.stderr}')
    return proc.stdout + proc.stderr, time.perf_counter() - t0


def build() -> Path:
    """Compile the sources unless a build of them exists; returns its path.
    Each source compiles to an object in its own ``nvcc`` process, all at
    once, and one more links them."""
    so = library_path()
    if so.exists():
        return so
    compiler = nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f'{so.stem}.{os.getpid()}'
    sources = sorted(SOURCE_DIR.glob('*.cu'))
    objects = [BUILD_DIR / f'{tag}.{src.stem}.o' for src in sources]
    tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
    def compile_one(src: Path, obj: Path) -> tuple:
        return _run([compiler, *NVCC_FLAGS, '-c', '-o', str(obj), str(src)])
    try:
        with ThreadPoolExecutor(len(sources)) as pool:
            compiled = list(pool.map(compile_one, sources, objects))
        report = [f'{src.name}: compiled in {seconds:.1f} s\n{out}'
                  for src, (out, seconds) in zip(sources, compiled)]
        report.append(_run([compiler, '-shared', '-o', str(tmp), *map(str, objects)])[0])
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    so.with_name(so.name + '.log').write_text(''.join(report))
    os.replace(tmp, so)  # atomic: a concurrent loader never sees a partial file
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.tnmf_error_string.argtypes = (ctypes.c_int,)
        lib.tnmf_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_launch(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = library().tnmf_error_string(err).decode()
        raise RuntimeError(f'{name}: CUDA error {err}: {msg}')


def check_inputs(name: str, *tensors: torch.Tensor, contiguous: bool = True) -> None:
    """The kernels take float32 CUDA tensors on one device, contiguous
    unless the kernel reads them through their strides (``contiguous=False``)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != 'cuda':
            raise ValueError(f'{name}: expected CUDA tensors, got one on {t.device}')
        if t.device != dev:
            raise ValueError(f'{name}: tensors on {dev} and {t.device}')
        if t.dtype != torch.float32:
            raise TypeError(
                f'{name}: the CUDA kernel takes float32, got {t.dtype} '
                '(bf16 storage: ROADMAP.md queue 2)')
        if contiguous and not t.is_contiguous():
            raise ValueError(f'{name}: expected contiguous tensors')


def model_value(x, s: int):
    """Model ``s``'s value of a per-model strength: ``x[s]`` of an
    ``(S,)`` tensor, ``x`` itself of a float shared by the models."""
    return x[s] if isinstance(x, torch.Tensor) else x


def model_vector(x, S: int, device: torch.device) -> torch.Tensor:
    """A per-model strength as the contiguous float32 ``(S,)`` vector a
    kernel reads on ``device``: an ``(S,)`` tensor converted (no host
    copy), a float filled in (rounded to float32 as a ``float`` argument
    of the C entry points is)."""
    if not isinstance(x, torch.Tensor):
        return torch.full((S,), float(x), dtype=torch.float32, device=device)
    if tuple(x.shape) != (S,):
        raise ValueError(f'expected one value per model, shape ({S},), got {tuple(x.shape)}')
    return x.to(device=device, dtype=torch.float32).contiguous()


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
