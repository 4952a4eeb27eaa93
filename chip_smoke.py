#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on an NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card, ``nvcc`` and a
CUDA build of PyTorch (no JAX needed).  Phases, each of which raises on
failure (exit code != 0, no result line):

1. device: the card's name and power limit (``nvidia-smi``), torch and nvcc;
2. build: compiles ``tnmf_tpu_torch/csrc/*.cu`` for ``sm_90a`` into
   ``tnmf_tpu_torch/_build/`` (set-up time; one ``nvcc`` per source, all
   started together, each one's time printed), prints ptxas' resource report
   and counts the tensor-core (HMMA) instructions of K2 and of K3's
   tensor-core kernel in the library's SASS (``cuobjdump -sass``); none
   fails the run;
3. kernels: K1 ``mu_ratio`` and its W epilogue ``mu_w``, K2 ``grad_w``, K3
   ``mu_h`` and K4 ``inhibited_mu_h`` against their plain PyTorch versions
   on the card, at the flagship shapes and at small ragged ones (K2 also at
   the edges of its tiling: 3, 17 and 64 atoms, 3 channels with 7 x 7 atoms,
   the 1-D pulse train's 20-tap atoms, a ragged ty, all four modes; K4 also
   at the repository's long 1-D shape, each small one with same-atom,
   cross-atom and both terms, and same-atom only at the flagship, also with
   the runtime tap loop in place of the compiled taps, at 70,000 samples,
   and streamed for stencils no tile holds in one piece (2-D 241 and 401
   taps a side, 1-D 40,001 taps), also against the sums in the streamed
   order; K2 also in groups of channels, of atom rows and of atom columns;
   K3 on each side of its route choice: the golden 2-D fixture's shapes, 17
   atoms, a ragged ty, pos_extra, 1-D, atoms only the FP32 route holds, 16
   channels of 31 x 31 atoms streamed in segments (also against the sums in
   the kernel's own order), and the FP32 route forced at the flagship and at
   70,000 1-D samples), within max|kernel - plain| / max|plain| <= 1e-4; K2
   and K3 at the flagship also against float64 within 1e-5, and two K2
   launches bit-identical; ``mu_w`` within 1e-6 of its plain version (the
   flagship W, a zero atom, 100 atoms of 3 x 15 x 15, 1-D atoms of 1024), a
   zero atom kept zero and two launches bit-identical; then the one-pass
   routes of K2 and K3 (``passes=1``, the TF32 precision levels) against
   their plain versions on TF32-rounded operands within 1e-5 at the
   flagship, at the small ragged shapes above and at K2's and K3's edge
   cases (K3 where it takes the tensor-core route), K2 also in its groups,
   against float64 on the rounded operands, and two launches bit-identical;
   then each kernel's model-axis launch (the sweeps' vmap rules: one launch
   for S models) at S = 1 and S = 3 against its plain version over the
   models, at the flagship and the small ragged shapes above: K1's ratio
   and W epilogue, K2, K3 on its tensor-core route at 3 and 1 passes (the
   data stream shared by the models, or per model with pos_extra) and on
   its FP32 route, K4 with compiled taps; K4 streamed and K2 in channel
   groups (one launch per group) at S = 2; each within the limits above,
   each model's bits against its own single launch printed and required
   equal at S = 1, and a K4 model of strength 0 bit-equal to K1's ratio;
   K5's model-axis launch (per-model ``l1`` and ``l2``) at S = 1 and S = 3
   on the H side's row-major operands (16384 x 256, a ragged 1000 x 37 at
   2 passes) and the W side's transposed views (4096 x 256, and 1000 x 37
   with a G the models share at model stride 0) within 1e-5 of its plain
   version over the models, the output in X's layout, each model's bits
   equal to its own single launch (required at every S);
4. golden: the seeded golden fits of tests/golden_values.json in float32 on
   the card: the 2-D fixture ('2d'/'valid'), the 1-D pulse train with
   inhibition ('1d', four modes) and the regularizer sweep
   ('sparsity_inhibition', seven settings); energy (and L1) within rtol
   1e-4, L0 printed beside its golden;
5. flagship: ``TransformInvariantNMF(16, (9, 9)).fit`` on 64 x 1 x 256 x 256
   for 20 iterations, plain (``mu_w``, K2, K3), with
   ``inhibition_strength=0.1`` and with
   ``cross_atom_inhibition_strength=0.05`` added (``mu_w``, K2, K4), every
   launch counter reset before each fit and read after it; energy finite and
   below the initial one, unit-sum atoms, each kernel of the path launched
   at least once per iteration; then MU ms/iteration (CUDA events) and peak
   device memory;
6. a small 3-D fit, which the rank gate sends to the plain versions of K2,
   K3 and K4 (``mu_w``, which takes any rank, once per iteration), against
   the same fit in float64 on the CPU;
7. large atoms: ``TransformInvariantNMF(16, (31, 31))`` on 4 x 16 x 256 x
   256 for 3 iterations, plain (``mu_w``, K2, K3 on its streamed FP32 route)
   and with ``inhibition_strength=0.1`` (``mu_w``, K2, K4), counts reset
   before each fit and read after it, no plain version called; W and H
   against the same seeded fit in float64, which the gate sends to the plain
   versions on the card, within max|W - W64| / max|W64| <= 1e-4 (and for H),
   the same fit on the plain versions in float32 printed beside it; then
   ms/iteration, K3's and K2's times at these shapes and the cuDNN calls
   beside them, and K2's one-pass route beside cuDNN with TF32 on; then
   the flagship with ``inhibition_range=120`` (241 x 241
   taps, K4 streamed) for 3 iterations, energy falling, and K4's time and
   bound there;
8. float64 on the card: the golden 2-D fit and the 1-D pulse train (four
   modes) in float64, which the gate sends to the plain versions (its reason
   is printed, no kernel launches); energy within rtol 1e-8 of
   tests/golden_values.json;
9. per-kernel times at the flagship shapes: kernel, plain version and the
   nearest single PyTorch call, with each kernel's bound (the one-pass
   routes of K2 and K3 too, beside cuDNN's ``corr_W``/``corr_H`` under
   TF32 and the TF32 peak); K3's two routes in
   turns; K4 also same-atom only, and with its runtime tap loop against the
   compiled taps; ``mu_w`` against the ratio kernel and the normalisation it
   replaces, in turns;
10. encoder: ``transform`` at the flagship with phase 5's fitted dictionary
   on new data (seed + 1), 10 H-only iterations, ``h_init`` random and
   correlate, plain (K3) and with ``inhibition_strength=0.1`` (K4), counts
   reset before each call and read after it: K3 (or K4) launched once per
   iteration, K2 and ``mu_w`` never; H within 1e-4 of the same call on the
   plain versions; each call's wall time; ms per H-only iteration (CUDA
   events); ``transform(batch_size=16)`` within 1e-5 of the whole batch;
   then, on phase 5's data, the cost of ``record_energies`` and of ``tol``
   (one block of 10) against the plain loop, in turns;
11. fit loops on the golden 2-D fixture (float32): ``record_energies``
   (the trace's last entry within 1e-4 of the golden energy, and without
   sparsity a trace that never rises), a ``tol`` fit and an extrapolated
   ``tol`` fit (iterations run and final energy printed), a callback that
   aborts at iteration 4 against a fit of 5 iterations, and a
   ``checkpoint_every`` run resumed from its checkpoint against the
   uninterrupted fit (bits, or within 1e-6, printed);
12. the fft and dot strategies through ``fit``, counts reset before each fit
   and read after it: the fft flagship (phase 5's problem on
   ``backend='jax_fft'``, 20 iterations) plain (``mu_ratio`` and ``mu_w``
   once per iteration, no other kernel) and inhibited (K4 and ``mu_w``),
   each W and H within 1e-4 of the same fit with ``use_pallas=False`` and
   of the float64 fit, peak memory, an iteration under the caller's TF32
   matmul setting bit-equal to one without, ms/iteration in turns with the
   conv flagship and the time of each part; ``'auto'`` on 64 x 1 x 128 x 128
   with 31 x 31 atoms (fft); the long 1-D fft problem (16 x 1 x 16000, 8
   atoms of 64) plain and inhibited; fft fits of 3 and 4 shift axes
   (``mu_ratio`` and ``mu_w``; inhibited rank 4: ``mu_w``, K4 plain under
   the rank gate), each against ``use_pallas=False`` and float64; plain NMF
   at production scale (16384 x 1 x 4096, 256 atoms, the dot strategy)
   against its matmul bound; the golden ``'2d'`` energies through
   ``backend='numpy_fft'`` in float32 (rtol 1e-4) and float64 (1e-8); and
   F5: the golden fit (conv and fft), ``set_dictionary``, ``transform`` and
   ``inverse_transform`` of CUDA tensors, with no host copy of the data
   (``set_dictionary`` copies the dictionary alone to the host, once, as
   the JAX package normalises it in NumPy), bit-equal to the NumPy calls;
13. the minibatch and streaming drivers: ``fit_minibatches`` at the flagship
   in batches of 16 (four per epoch), each of the five algorithms and
   ASG_MU inhibited for 4 epochs on the kernels and with
   ``use_pallas=False``, counts reset before each fit and read after it:
   K3 (K4 inhibited) once per batch, K2 and ``mu_w`` once per batch or once
   per epoch as the algorithm implies, no launch with ``use_pallas=False``;
   W and H within 1e-4 of that fit; device ms per epoch after the first
   (CUDA events recorded by the progress callback); Cyclic_MU against
   ``fit_batch(n_iterations=3)`` within 1e-5; the golden ``minibatch`` and
   ``stream`` energies in float32 on conv and fft (rtol 1e-4); four
   ``partial_fit`` steps of 16 samples (wall ms per step, and the device
   time of a step), the first with ``sag_lambda=1`` bit-equal to
   ``fit_batch(n_iterations=1)``; ``fit_stream`` over a generator of CUDA
   tensors with no host copy of them, bit-equal to the stream of NumPy
   rows;
14. the objectives: the conv flagship (3 iterations, counts reset before
   and read after) under beta = 2, KL (``beta_loss=1``, plain and with
   ``inhibition_strength=0.1``), beta = 0.5, 10 % of the entries missing (a
   seeded Bernoulli mask, plain and inhibited), a weight mask broadcast over
   samples and channels, and ``l2_H=0.1`` with ``ortho_W=0.1``: K3 (K4
   inhibited), K2 and ``mu_w`` once per iteration, W and H within 1e-4 of
   the same fit with ``use_pallas=False``, then ms/iteration (10 after a
   warm-up, CUDA events) and, for KL and the mask, the time of each part of
   an iteration; the fft flagship with KL and with the mask and plain NMF
   on dot (16384 x 1 x 4096, 256 atoms) with KL (``mu_ratio`` and ``mu_w``
   once per iteration); ASG_MU at bs = 16 with KL and the mask (launches
   per epoch); ``transform(batch_size=16)`` of new data with a per-sample
   mask against the KL dictionary (K3 alone); then at the golden 2-D
   fixture every case, Itakura-Saito on ``V + 0.01``, fft, dot, minibatch
   and ``transform`` in float32 on the kernels against float64 on the card
   (1e-4);
15. transform groups and initialisation: the conv flagship with D4
   (``transform_type='shift+rot90+flip'``, 16 atoms x 8 transforms = 128
   maps) from ``init='device'``, plain and inhibited (0.1, cross-atom
   0.05), counts reset before and read after: K3 (K4 inhibited), K2 and
   ``mu_w`` once per iteration, W and H within 1e-4 of ``use_pallas=False``
   over 2 iterations, ms per iteration (5 after a warm-up), peak memory,
   K3's, K2's and K4's geometries (K3 on its tensor-core route) and the
   per-call split; K3, K2 and K4 at 128 maps against their plain versions,
   timed in turns with them, beside the nearest PyTorch call and the
   bound; ``'auto'`` on phase 12's 31 x 31 problem with the C4 rotations
   (fft: ``mu_ratio`` and ``mu_w``); the golden 2-D fixture under each
   group on conv and fft, float32 on the kernels within 1e-5 of float64,
   and a D4 fit of a CUDA tensor bit-equal to the NumPy fit; the wall time
   of a flagship fit's initialisation with ``init='device'`` against the
   host draw, in turns, and of ``partial_fit`` steps of 16 samples with
   each, two device draws of one seed bit-equal; ``w_init='patches'``
   from a CUDA tensor within 1e-6 of the NumPy array's windows, with no
   host copy of the data;
16. HALS (``fit(solver='hals')``): K5 ``hals_sweep`` against its plain
   version (within 1e-5, two launches bit-identical, the output in X's
   layout, timed in turns beside its bound, its earlier time, its geometry
   and the host's time per call; both versions' distance from float64) at
   the H side of plain NMF at production scale (16384 x 256, row-major),
   its W side (4096 x 256, on transposed views as the engine passes them),
   the rows of one phase of the shift-invariant flagship (50176 x 16), a
   ragged 1000 x 37, 3 passes and 2048 x 4096, whose tile of X no block
   holds (the streamed route); plain-NMF HALS
   on 16384 x 1 x 4096 with 256 atoms (``'auto'``: 1 sweep; K5 twice per
   iteration) and shift-invariant HALS on the flagship's data in ``'full'``
   mode with ``sparsity_H=0.1`` (81 phases: K5 81 times, K2 and
   ``mu_ratio`` once per iteration), counts reset before and read after,
   each for 2 iterations against ``use_pallas=False`` (W and H within
   1e-4, no launch there), the regularized objective never rising (1e-6),
   then ms per iteration (CUDA events), the split of an iteration and peak
   memory; then a small plain-NMF fit and the golden 2-D fixture in
   ``'full'`` mode in float32 on the kernels within 1e-4 of float64;
17. the serving artifact (``export_serving`` / ``load_serving``, a
   ``torch.export`` program that calls K3, K4, K1's ratio and K5 as custom
   operators): the conv flagship's artifact (phase 5's dictionary,
   ``sparsity_H=0.1``, symbolic batch) exported, written, loaded, and
   loaded again in a fresh process that imports torch and the port alone;
   requests of batch 1, 8 and 64 at 10 iterations under PyTorch's TF32
   defaults (cuBLAS 'high', cuDNN TF32 on), counts reset before and read
   after (K3 once per iteration, no other kernel, no plain version called),
   H within 1e-6 of ``transform`` on the card (bits printed) and within
   1e-4 of ``transform`` with ``use_pallas=False``; the inhibited flagship
   (K4), the fft flagship (``mu_ratio``), plain-NMF HALS at 16384 x 4096
   with 256 atoms (K5 once per iteration) and shift-invariant HALS in
   ``'full'`` mode on the flagship's data (K5 81 times per iteration) the
   same way, HALS also against float64 within phase 16's margin; ms per
   request and per iteration (CUDA events) of each artifact beside
   ``transform``'s compute, in turns, the host time of a request, export
   time, file size and peak memory; then one request of the conv
   flagship's artifact exported at ``precision='default'`` (its header
   records the level; K3 on its one-pass route), bit-equal to ``transform``
   at 'default';
18. precision: the conv flagship plain and inhibited, ``transform``, the
   fft flagship, plain NMF on dot (16384 x 1 x 4096, 256 atoms) and
   plain-NMF HALS at that size, each fit at every level (None, 'default',
   'high', 'highest'), counts reset before each fit and read after it
   (K2 and K3 on their one-pass routes once per iteration at 'default'
   and 'high', never at None and 'highest'): 'default' bit-equal to
   'high' and 'highest' to None; at 'default' the MU fits' energies within
   1e-3 of the float64 fit after 10 iterations and W and H within 5e-3
   (relative Frobenius norm), HALS's distances printed; ms per iteration
   at None and 'default' in turns (CUDA events); the golden fixtures at
   'default' within 1e-3 of tests/golden_values.json;
19. the MU sweeps (``sweep_fit``): (a) the conv flagship, 8 models (seeds
   0-3 x sparsity 0.05, 0.1); (b) the inhibited flagship, 4 models
   (inhibition 0, 0.05, 0.1, 0.2; 17 x 17 taps); (c) the fft flagship, 2
   models; (d) the golden 2-D fixture, 64 models, also with ``tol`` (each
   model's n_iters printed) and ``record_energies``; (e) plain NMF on dot
   (16384 x 1 x 4096, 256 atoms), 4 models; 10 iterations for (a) and
   (d), 3 for the others, counts reset before and read after each run:
   each kernel of the path launched
   once per iteration over the model axis for all the models; each model
   within 1e-4 of its single fit from the same init on the kernels
   (``engine.fit_loop``) and of the same sweep with ``use_pallas=False``;
   ms per sweep iteration beside the S single fits' per iteration in
   turns (CUDA events), peak memory, the batched reconstruction's ms per
   call; then the HALS sweeps (``solver='hals'``): (f) plain NMF at
   16384 x 1 x 4096 with 256 atoms (``hals_inner='auto'``), 4 models of
   sparsity 0, 0.05, 0.1, 0.2 and ``l2=0.1``, 10 iterations; (g) an alpha
   grid on 1024 x 1 x 256 with 16 atoms, 64 models of sparsity
   ``linspace(0, 0.3)``, 10 iterations, also with ``tol`` (each model's
   n_iters printed) and ``record_energies``; counts reset before and read
   after each: K5 twice per iteration over the model axis (H side, W
   side) for all the models, no other kernel; from the sweep's own inits
   (3 iterations for (f)) each model within 1e-4 of its single fit on the
   kernels (``engine_hals.fit_loop``; the sweep forms each model's Gram
   products alone, C2) and of the same sweep with ``use_pallas=False``,
   or, where K5's rounding against its plain version's moves it farther
   (C1), no farther from the float64 sweep than twice the plain sweep;
   ms per sweep iteration beside the S single fits' in turns, peak
   memory, the seconds these runs took; then each model-axis launch at
   these runs' shapes against its S single launches and its plain version
   over the models, with its bound (K5 at (f)'s two sides, S = 4);
20. the multi-scale model (``MultiScaleTNMF``) at the repository's
   multi-scale configuration (``benchmarks/large_scale.py:97``: 64 x 1 x
   256 x 256, 12 atoms of 9 x 9 and 4 of 5 x 5, 'valid', both scales on
   conv), counts reset before and read after each run: a fit with K3, K2
   and ``mu_w`` twice per iteration (once per scale), every scale's W and H
   within 1e-4 of the fit on the plain versions and of the float64 fit, ms
   per iteration in turns with the plain versions', the four
   reconstructions' share, peak memory; a small conv + fft fit (K3 and
   ``mu_ratio`` in one iteration) held the same way; ``transform`` (K3
   twice per H-only iteration) against the plain versions and its ms per
   H-only iteration; the checkpoint served as a ``torch.export`` artifact,
   a request of 8 samples within 1e-5 of ``transform``, timed in turns with
   it; and a one-scale model bit-equal to ``TransformInvariantNMF``;
21. the tools, counts reset before and read after: ``estimate_fit_memory``
   against the live tensors (persistent entries, bytes) at the conv and fft
   flagships, shift-invariant HALS at the flagship's data, plain NMF on
   dot, plain-NMF HALS and the multi-scale configuration, and against
   ``torch.cuda.max_memory_allocated`` over two iterations at the two
   flagships and shift-invariant HALS (at least the measured peak, at most
   1.5 times it); a fit at ``suggest_batch_size``'s n for the flagship
   geometry with the default budget (0.85 of the card's memory), its peak
   within the budget; ``trace`` around three flagship iterations, K3's,
   K2's and ``mu_w``'s kernels in it by name; ``IterationTimer``'s rate
   within 10 % of CUDA events'; eight ``partial_fit`` steps of 16 flagship
   samples fed by ``prefetch_to_device`` and by the host in turns, W and H
   bit-equal, ms per step; ``python -m tnmf_tpu_torch.cli export`` in a
   subprocess on a flagship checkpoint, its artifact's request of 8
   samples bit-equal to an in-process ``export_serving``'s;
22. the examples and demos as a user runs them: the thirteen examples of
   ``tnmf_tpu_torch.examples`` at their full sizes (``run(smoke=False)``)
   on the kernels, counts reset before and read after each, then with
   ``use_pallas=False`` (no launch there), every figure within 1e-4
   relative and every text and integer equal, then on the kernels again
   (so neither route alone pays a first run's costs), each run's ms (CUDA
   events around ``run``) and its printed lines; the five demos headless
   through the streamlit shim (no matplotlib: the drawing skipped, every
   fit and reconstruction computed) the same way; then ``python -m
   tnmf_tpu_torch.cli example shift_invariant_decomposition`` and ``demo
   --headless`` as subprocesses, each exiting 0; ``mu_ratio``, ``mu_w``,
   K2, K3, K4 and K5 each launched at least once across the examples;
23. data parallelism over the samples (``mesh=``): (a) a world of one on
   NCCL in this process, the conv flagship for 10 iterations with
   ``mesh=make_mesh()`` bit-equal to the mesh-free fit from the same seeded
   init (also inhibited, 5 iterations), ``mu_w``, K2 and K3 (K4) launched
   once per iteration and no plain version called, ms per iteration with
   and without the mesh in turns (CUDA events) beside one all-reduce of the
   W statistics alone; plain-NMF HALS at 16384 x 1 x 4096 with 256 atoms
   (3 iterations, against float64) and shift-invariant HALS on the
   flagship's data (2 iterations) on the same mesh; (b) two worker
   processes sharing the card over gloo (this script with
   ``--mesh-worker``, the kernels built before they start), 32 samples
   each: the plain flagship (10 iterations) and the inhibited one (5),
   each rank's W and rows of H within rtol 2e-5 / atol 1e-7 of (a)'s, each
   rank's launches printed and required (no plain version called); (c)
   the same workers' HALS: plain NMF no farther from the float64 fit than
   twice the world of one's float32 fit (C3's rule), shift-invariant
   within 1e-4 of the world of one; (d) ``python -m tnmf_tpu_torch.cli
   example data_parallel_fit`` and ``example multihost_fit`` with
   ``TNMF_TPU_SMOKE=1`` as subprocesses, each exiting 0.  A worker or a
   child that exits non-zero or outlives its timeout fails the run.

Phases 7, 10, 12, 13, 14, 15, 16, 17, 20 and 22 hold fits on the kernels
against the same fits with ``use_pallas=False`` (the model's kernel/plain
switch).

The line before the last is ``{"kernels": [...]}`` with each kernel's
launches on the main paths (phase 19's over the model axis also apart, K5's
from the HALS sweeps (f) and (g); phases 20's, 21's and 22's also apart:
``examples_launches`` across the examples, ``demos_launches`` across the
demos; phase 23's world of one as ``mesh_launches``, and the world of
two's, summed over its ranks, as ``mesh_world_two_launches``), error,
times and bound; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from tnmf_tpu_torch import (MiniBatchAlgorithm, MultiScaleTNMF, TransformInvariantNMF, engine,
                            engine_hals, engine_hals_conv, load_serving, sweep_fit)
from tnmf_tpu_torch.kernels import _build, gw, hals, inhibit, mu, mu_h
from tnmf_tpu_torch.models import multiscale, sweep
from tnmf_tpu_torch.ops import conv
from tnmf_tpu_torch.ops.inhibition import inhibition_kernels
from tnmf_tpu_torch.ops.modes import ConvPlan
from tnmf_tpu_torch.ops.precision import matmul_pin, round_tf32
from tnmf_tpu_torch.ops.transforms import expand_w, make_group, tie_back
from tnmf_tpu_torch.utils import memory as tools_memory
from tnmf_tpu_torch.utils import pipeline as tools_pipeline
from tnmf_tpu_torch.utils import profiling as tools_profiling
from tnmf_tpu_torch.utils.data_loading import synthetic_face
from tnmf_tpu_torch.utils.signals import generate_pulse_train

ROOT = Path(__file__).resolve().parent
TOL = 1e-4            # max|kernel - plain| / max|plain|, float32 on the card
F64_TOL = 1e-5        # K2 and K3 (3xTF32) against float64 at the flagship
ONE_PASS_TOL = 1e-5   # K2's and K3's one-pass routes against their rounded plain versions,
                      # in float64 (their products are exact)
GOLDEN_RTOL = 1e-4    # float32 fit on the card against the float64 golden
F64_GOLDEN_RTOL = 1e-8  # float64 fit on the card against the float64 golden
N_ITER = 20
SEED = 0
DEVICE = 'cuda'
FLAGSHIP = dict(N=64, C=1, S=(256, 256), M=16, A=(9, 9), mode='valid', sparsity=0.1,
                inhibition=0.1, cross=0.05)
# 16 channels of 31 x 31 atoms: no kernel geometry of the first ports held
# them; the JAX rule still picks the direct-conv path for them
LARGE = dict(N=4, C=16, S=(256, 256), M=16, A=(31, 31), sparsity=0.1, inhibition=0.1,
             n_iter=3)
# published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, FP32 outside
# the tensor cores, and dense TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
# the rate each kernel's operations run at: K2 and K3 (on its tensor-core
# route, the flagship's) do three TF32 products per float32 product
# (3xTF32), one on their one-pass routes, the others FP32 FMAs
OPS_PER_S = dict(mu_ratio=FP32_FLOP_PER_S, mu_w=FP32_FLOP_PER_S,
                 grad_w=TF32_FLOP_PER_S / 3, mu_h=TF32_FLOP_PER_S / 3,
                 grad_w_1pass=TF32_FLOP_PER_S, mu_h_1pass=TF32_FLOP_PER_S,
                 inhibited_mu_h=FP32_FLOP_PER_S, hals_sweep=FP32_FLOP_PER_S)
KERNELS = {
    'mu_ratio': dict(wrapper=mu.mu_ratio, source='tnmf_tpu_torch/csrc/mu_ratio.cu',
                     replaces='tnmf_tpu/experimental/pallas_mu.py:62'),
    # the W epilogue: K1's ratio fused with the JAX package's _normalize_W
    # (tnmf_tpu/engine.py:482), which has no Pallas kernel of its own
    'mu_w': dict(wrapper=mu.mu_w, source='tnmf_tpu_torch/csrc/mu_ratio.cu',
                 replaces='tnmf_tpu/experimental/pallas_mu.py:62'),
    'grad_w': dict(wrapper=gw.grad_w, source='tnmf_tpu_torch/csrc/grad_w.cu',
                   replaces='tnmf_tpu/experimental/pallas_gw.py:163'),
    'mu_h': dict(wrapper=mu_h.mu_h, source='tnmf_tpu_torch/csrc/mu_h.cu',
                 replaces='tnmf_tpu/experimental/pallas_phased.py:169'),
    # the one-pass TF32 routes of K2 and K3 (precision 'default' and
    # 'high'): the same wrappers, each route with a count of its own
    'grad_w_1pass': dict(wrapper=gw.grad_w, count='one_pass_launches',
                         source='tnmf_tpu_torch/csrc/grad_w.cu',
                         replaces='tnmf_tpu/experimental/pallas_gw.py:163'),
    'mu_h_1pass': dict(wrapper=mu_h.mu_h, count='one_pass_launches',
                       source='tnmf_tpu_torch/csrc/mu_h.cu',
                       replaces='tnmf_tpu/experimental/pallas_phased.py:169'),
    'inhibited_mu_h': dict(wrapper=inhibit.inhibited_mu_h,
                           source='tnmf_tpu_torch/csrc/inhibited_mu_h.cu',
                           replaces='tnmf_tpu/experimental/pallas_mu.py:213'),
    # the HALS solvers' Gauss-Seidel sweep, a lax.fori_loop in the JAX
    # package (no Pallas kernel of its own)
    'hals_sweep': dict(wrapper=hals.hals_sweep, source='tnmf_tpu_torch/csrc/hals_sweep.cu',
                       replaces='tnmf_tpu/engine_hals.py:98'),
}
#: the engine's kernel wrappers (``mu_ratio``: the H ratio of the fft and
#: dot strategies)
ENGINE_KERNELS = ('mu_ratio', 'mu_w', 'grad_w', 'mu_h', 'inhibited_mu_h')
COMBOS = [(True, False), (False, True), (True, True)]
# K4 alone: (where, H shape, inhibition range), random H, neg and pos
K4_CASES = [
    ('2-D ragged 3x5x37x29 r(6,2)', (3, 5, 37, 29), (6, 2)),
    ('2-D tall 1x3x300x40 r(4,3)', (1, 3, 300, 40), (4, 3)),
    ('1-D 3x4x40 r(5)', (3, 4, 40), (5,)),
    ('1-D long 16x8x4159 r(63)', (16, 8, 4159), (63,)),
    # taps too wide for two H buffers (one buffer), and for any 8-row tile
    # or two buffers of one row (tiles of one row, one buffer)
    ('2-D wide 1x3x200x200 r(82)', (1, 3, 200, 200), (82, 82)),
    ('2-D rows 1x2x12x4500 r(1,2000)', (1, 2, 12, 4500), (1, 2000)),
    ('1-D one buffer 1x2x20000 r(9700)', (1, 2, 20000), (9700,)),
    # more samples than a grid's y axis holds (65535)
    ('1-D 70000x3x64 r(4)', (70000, 3, 64), (4,)),
]
# K4 on stencils no tile holds in one piece: its streamed route
K4_STREAMED_CASES = [
    ('2-D 1x4x300x300 r(120)', (1, 4, 300, 300), (120, 120)),
    ('2-D 1x4x300x300 r(200)', (1, 4, 300, 300), (200, 200)),
    ('1-D 1x2x60000 r(20000)', (1, 2, 60000), (20000,)),
]
#: the flagship fit with a wide inhibition range (241 x 241 taps)
WIDE_RANGE = 120
#: mu_w against its plain version (max|kernel - plain| / max|plain|)
MU_W_TOL = 1e-6
#: the model counts of phase 3's model-axis launches
MODEL_AXIS_COUNTS = (1, 3)
# K2 at the edges of its tiling: (where, (N, C, S, M, A, mode))
K2_CASES = [
    ('2-D 3 atoms valid', (2, 1, (40, 37), 3, (9, 9), 'valid')),
    ('2-D 17 atoms full', (2, 1, (40, 37), 17, (9, 9), 'full')),
    ('2-D 64 atoms circular', (2, 1, (30, 30), 64, (5, 5), 'circular')),
    ('2-D C=3 7x7 reflect', (2, 3, (38, 51), 10, (7, 7), 'reflect')),
    ('1-D pulse train Ay=20', (1, 1, (100,), 3, (20,), 'valid')),
    ('2-D ragged Ty=92', (3, 2, (29, 97), 5, (4, 6), 'valid')),
    # more work items than warps: blocks stage only their own atoms
    ('2-D 100 atoms valid', (1, 1, (40, 40), 100, (9, 9), 'valid')),
    # chunks only the compact layout holds (one plane, split as it loads)
    ('2-D 100x100 atoms on 200x200', (1, 1, (299, 299), 4, (100, 100), 'full')),
    ('2-D C=3 57x57 atoms', (1, 3, (160, 160), 4, (57, 57), 'full')),
    ('2-D narrow Ty=5 168x168 atoms', (1, 1, (171, 172), 3, (168, 168), 'full')),
    ('2-D narrow Ty=4 169x165 atoms', (1, 1, (172, 168), 3, (169, 165), 'full')),
]
# K2 where no chunk over all of X2 fits a block: (where, problem, launches)
K2_GROUP_CASES = [
    ('2-D C=32 31x31: channel groups', (1, 32, (64, 72), 4, (31, 31), 'valid'), 2),
    ('2-D 300x300 atoms: row groups', (1, 1, (310, 310), 3, (300, 300), 'valid'), 4),
    ('1-D 70000-tap atoms: column groups', (1, 1, (70100,), 3, (70000,), 'valid'), 4),
]
# K3 on each side of its route choice: (where, (N, C, S, M, A, mode),
# with pos_extra, the route it takes)
K3_CASES = [
    ('2-D golden fixture C=3 7x7 M=10', (2, 3, (76, 102), 10, (7, 7), 'valid'), False, 'mma'),
    ('2-D 17 atoms', (2, 1, (40, 37), 17, (9, 9), 'valid'), False, 'mma'),
    ('2-D ragged Ty=93 full', (3, 2, (29, 88), 5, (4, 6), 'full'), False, 'mma'),
    ('2-D with pos_extra', (2, 2, (40, 44), 3, (9, 9), 'valid'), True, 'mma'),
    ('1-D pulse train Ay=20', (1, 1, (100,), 3, (20,), 'valid'), False, 'mma'),
    ('1-D 2x3x301/7 with pos_extra', (2, 3, (301,), 7, (7,), 'valid'), True, 'mma'),
    # the split dictionary (235 k steps) does not fit a block beside the windows
    ('2-D C=3 25x25 atoms', (1, 3, (60, 70), 5, (25, 25), 'valid'), False, 'fma'),
    # neither the split dictionary nor one FP32 segment of all the taps fits
    ('2-D C=16 31x31 atoms, streamed', (2, 16, (64, 72), 16, (31, 31), 'valid'), True, 'fma'),
    # more samples than a grid's y axis holds (65535)
    ('1-D 70000x2x64/4x9', (70000, 2, (64,), 4, (9,), 'valid'), False, 'mma'),
]
# tests/test_sparsity_inhibition.py's settings
SPARSITY_INHIBITION = [
    dict(),
    dict(sparsity_H=0.1),
    dict(sparsity_H=1.0),
    dict(inhibition_strength=0.1),
    dict(inhibition_strength=1.0),
    dict(cross_atom_inhibition_strength=0.5),
    dict(sparsity_H=0.5, inhibition_strength=0.5, cross_atom_inhibition_strength=0.5),
]


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


def bound(n_bytes: float, flops: float, ops_per_s: float) -> tuple:
    """The least time of the work on the card (ms) and what bounds it, with
    the operations at the rate of the unit the kernel uses."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / ops_per_s
    return 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def reset_counts():
    for k in KERNELS.values():
        setattr(k['wrapper'], k.get('count', 'launches'), 0)
        if hasattr(k['wrapper'], 'model_launches'):
            k['wrapper'].model_launches = 0


def counts() -> dict:
    return {name: getattr(k['wrapper'], k.get('count', 'launches'))
            for name, k in KERNELS.items()}


@contextlib.contextmanager
def plain_calls():
    """Inside the block the engine's plain versions of the kernels count
    their calls: yields the counts (a dict), read after the block."""
    calls = dict.fromkeys(ENGINE_KERNELS, 0)
    saved = {name: getattr(engine, name + '_plain') for name in ENGINE_KERNELS}

    def counting(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call
    for name, fn in saved.items():
        setattr(engine, name + '_plain', counting(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(engine, name + '_plain', fn)


@contextlib.contextmanager
def fma_route():
    """Inside the block K3 takes the first port's FP32 route for every
    shape: the comparison of its two designs at the flagship."""
    routes, mu_h._ROUTES = mu_h._ROUTES, ('fma',)
    try:
        yield
    finally:
        mu_h._ROUTES = routes


@contextlib.contextmanager
def runtime_taps():
    """Inside the block K4 runs its runtime tap loop for every tap count (no
    compiled one): the comparison of the two at the flagship."""
    compiled, inhibit._COMPILED_TAPS = inhibit._COMPILED_TAPS, ()
    try:
        yield
    finally:
        inhibit._COMPILED_TAPS = compiled


# ---------------------------------------------------------------- phases

def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this check needs a CUDA card')
    smi = card()
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
        if ('registers' in line or 'spill' in line or 'Compiling entry' in line
                or 'compiled in' in line):
            log('  ' + line.strip())
    hmma = sass_counts(so, 'grad_w_partial', 'HMMA')
    log(f'  K2 SASS: {hmma} HMMA instructions over its grad_w_partial instances')
    if not hmma:
        raise AssertionError('K2 grad_w_partial has no tensor-core (HMMA) instruction')
    hmma = sass_counts(so, 'mu_h_mma_kernel', 'HMMA')
    log(f'  K3 SASS: {hmma} HMMA instructions over its mu_h_mma_kernel instances')
    if not hmma:
        raise AssertionError('K3 mu_h_mma_kernel has no tensor-core (HMMA) instruction')


def sass_counts(so: Path, function: str, opcode: str) -> int:
    """Instructions with ``opcode`` in the SASS of every function whose
    name holds ``function`` (``cuobjdump -sass`` of the built library)."""
    tool = Path(_build.nvcc()).with_name('cuobjdump')
    sass = subprocess.run([str(tool), '-sass', str(so)], capture_output=True, text=True,
                          check=True).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        if 'Function :' in line:
            inside = function in line
        elif inside and opcode in line:
            count += 1
    return count


def _problem(N, C, S, M, A, mode, seed, use_cross=True):
    """Random factors and the inputs each kernel gets from them on the main
    paths (plain operators, float32 on the card).  For each kernel:
    (kernel, plain version, nearest single PyTorch call or None,
    (bytes, flops) of the work)."""
    rng = np.random.default_rng(seed)
    plan = ConvPlan.create(mode, S, A)
    tf32_plan = ConvPlan.create(mode, S, A, precision='default')  # cuDNN with TF32 on
    T = plan.transform_shape
    dev = dict(device=DEVICE, dtype=torch.float32)
    V = torch.tensor(rng.random((N, C) + S), **dev)
    W = rng.random((M, C) + A)
    W = torch.tensor(W / W.sum(axis=tuple(range(2, W.ndim)), keepdims=True), **dev)
    H = torch.tensor(rng.random((N, M) + T), **dev)
    Vp = conv.prepare_data(V, plan)
    Rx = conv.extend_data(conv.reconstruct(W, H, plan), plan)
    X2 = torch.cat([Vp, Rx], dim=1)
    neg, pos = gw.grad_w_plain(X2, H)
    neg, pos = neg.contiguous(), pos.contiguous()
    hneg, hpos = (g.contiguous() for g in conv.grad_H_pair_prepared(Vp, Rx, W))
    VR = torch.cat([Vp, Rx], dim=0)
    ks = tuple(torch.tensor(k, **dev) for k in inhibition_kernels(tuple(a - 1 for a in A)))
    denom = engine.EPS + 0.1
    inh = dict(inhibition=0.1, cross_inhibition=0.05, reg=denom, use_same=True,
               use_cross=use_cross)
    nT, nA, nH = math.prod(T), math.prod(A), H.numel()
    k2_work = (4 * (X2.numel() + nH + 2 * W.numel()), 2 * M * 2 * C * nA * N * nT)
    k3_work = (4 * (Vp.numel() + Rx.numel() + W.numel() + 2 * nH),
               2 * 2 * N * M * C * nT * nA + 3 * nH)
    return {
        # at the size of H: the H ratio of the fft and dot strategies
        'mu_ratio': (lambda: mu.mu_ratio(H, hneg, hpos, denom),
                     lambda: mu.mu_ratio_plain(H, hneg, hpos, denom), None,
                     (4 * 4 * nH, 3 * nH)),
        # the ratio (3 operations), the row sum and the division per element
        'mu_w': (lambda: mu.mu_w(W, neg, pos, engine.EPS, plan.ndim),
                 lambda: mu.mu_w_plain(W, neg, pos, engine.EPS, plan.ndim), None,
                 (4 * 4 * W.numel(), 5 * W.numel())),
        'grad_w': (lambda: gw.grad_w(X2, H), lambda: gw.grad_w_plain(X2, H),
                   lambda: conv.corr_W(X2, H), k2_work),
        'mu_h': (lambda: mu_h.mu_h(Vp, Rx, W, H, denom),
                 lambda: mu_h.mu_h_plain(Vp, Rx, W, H, denom),
                 lambda: conv.corr_H(VR, W), k3_work),
        # one TF32 pass: the plain versions round the operands first, the
        # library calls run cuDNN with TF32 on
        'grad_w_1pass': (lambda: gw.grad_w(X2, H, 1),
                         lambda: gw.grad_w_plain(X2, H, 1),
                         lambda: conv.corr_W(X2, H, tf32_plan), k2_work),
        'mu_h_1pass': (lambda: mu_h.mu_h(Vp, Rx, W, H, denom, None, 1),
                       lambda: mu_h.mu_h_plain(Vp, Rx, W, H, denom, None, 1),
                       lambda: conv.corr_H(VR, W, tf32_plan), k3_work),
        'inhibited_mu_h': (lambda: inhibit.inhibited_mu_h(H, hneg, hpos, ks, **inh),
                           lambda: inhibit.inhibited_mu_h_plain(H, hneg, hpos, ks, **inh),
                           None,
                           (4 * 4 * nH, nH * (2 * sum(k.numel() for k in ks) + 10))),
    }


def _compare(name, kernel, plain, where, tol=TOL) -> float:
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
    log(f'  {name:14s} {where:34s} max_abs_err={abs_err:.3e} rel={rel:.3e}')
    if not rel <= tol:
        raise AssertionError(f'{name} at {where}: kernel disagrees with its plain '
                             f'version (relative error {rel:.3e} > {tol})')
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
        for name, (kernel, plain, _, _) in _problem(*args, seed=i).items():
            err = _compare(name, kernel, plain, where)
            if i == 0:
                errors[name] = err
    for i, (where, args) in enumerate(K2_CASES):
        k2 = _k2_problem(*args, seed=10 + i)
        _compare('grad_w', lambda: gw.grad_w(*k2), lambda: gw.grad_w_plain(*k2), where)
    for i, (where, args, n_groups) in enumerate(K2_GROUP_CASES):
        X2, H = _k2_problem(*args, seed=30 + i)
        gw.grad_w.launches = 0
        _compare('grad_w', lambda: gw.grad_w(X2, H), lambda: gw.grad_w_plain(X2, H),
                 f'{where} ({n_groups})')
        if gw.grad_w.launches != n_groups:
            raise AssertionError(f'grad_w at {where}: {gw.grad_w.launches} launches, '
                                 f'not {n_groups} groups')
        # sums over up to 371 k positions: which of the two is off float64
        f64 = gw.grad_w_plain(X2.double(), H.double())
        scale = max(float(w.abs().max()) for w in f64)
        rel = [max(float((g.double() - w).abs().max()) for g, w in zip(fn(X2, H), f64))
               / scale for fn in (gw.grad_w, gw.grad_w_plain)]
        log(f'  {"grad_w":14s} {where + " against float64":34s} kernel rel={rel[0]:.3e}, '
            f'plain rel={rel[1]:.3e}')
        if not rel[0] <= TOL:
            raise AssertionError(f'grad_w at {where}: {rel[0]:.3e} off float64 > {TOL}')
    _k2_float64_and_determinism()
    _k3_routes_and_float64()
    rng = np.random.default_rng(SEED)
    for where, dims, ranges in K4_CASES:
        H, neg, pos = (torch.tensor(rng.random(dims), device=DEVICE, dtype=torch.float32)
                       for _ in range(3))
        ks = inhibition_kernels(ranges)
        for use_same, use_cross in COMBOS:
            kw = dict(use_same=use_same, use_cross=use_cross)
            args = (H, neg, pos, ks, 0.3, 0.2, engine.EPS + 0.1)
            _compare('inhibited_mu_h', lambda: inhibit.inhibited_mu_h(*args, **kw),
                     lambda: inhibit.inhibited_mu_h_plain(*args, **kw),
                     f'{where} {"s" if use_same else ""}{"c" if use_cross else ""}')
    f = FLAGSHIP
    same = _problem(f['N'], f['C'], f['S'], f['M'], f['A'], f['mode'], seed=0,
                    use_cross=False)['inhibited_mu_h']
    _compare('inhibited_mu_h', same[0], same[1], 'flagship same-atom only')
    with runtime_taps():
        _compare('inhibited_mu_h', same[0], same[1], 'flagship, runtime tap loop')
    _k4_streamed()
    _mu_w_cases()
    _one_pass_cases()
    _model_axis_cases()
    return errors


def _stacked(rng, shape, S):
    """S random non-negative tensors of ``shape``, stacked on axis 0."""
    return torch.tensor(rng.random((S,) + tuple(shape)), device=DEVICE, dtype=torch.float32)


def _model_axis_check(name, models, plain, single, where, S, tol=TOL,
                      require_equal: bool = False) -> None:
    """One model-axis launch (``models()``, counted: one launch) against
    its plain version over the model axis (``plain(s)`` per model) within
    ``tol``, and against each model's own single launch (``single(s)``):
    bit-equal required at S = 1 (at every S with ``require_equal``),
    printed otherwise."""
    wrapper = KERNELS[name]['wrapper']
    before, model_before = wrapper.launches, wrapper.model_launches
    got = models()
    sync()
    if (wrapper.launches - before, wrapper.model_launches - model_before) != (1, 1):
        raise AssertionError(f'{name} at {where}, S={S}: {wrapper.launches - before} launches, '
                             f'{wrapper.model_launches - model_before} over the model axis')
    pair = isinstance(got, tuple)
    want = [plain(s) for s in range(S)]
    want = tuple(map(torch.stack, zip(*want))) if pair else torch.stack(want)
    _compare(name, lambda: got, lambda: want, f'{where} S={S}', tol)
    parts = got if pair else (got,)
    equal = all(torch.equal(p[s], q) for s in range(S)
                for p, q in zip(parts, single(s) if pair else (single(s),)))
    log(f'  {name:14s} {where + f" S={S}":34s} each model bit-equal to its single launch: '
        f'{equal}')
    if (S == 1 or require_equal) and not equal:
        raise AssertionError(f'{name} at {where}: the S = {S} model-axis launch differs from '
                             'the single launches')
    return got


def _model_axis_cases() -> None:
    """Each kernel's model-axis launch (the sweeps' vmap rules) against its
    plain version over the model axis, at S = 1 and S = 3, at the flagship
    and at the small ragged shapes: K1's ratio and W epilogue, K2 (also in
    channel groups), K3 on its tensor-core route at 3 and 1 passes (the
    data stream shared by the models, and per model with pos_extra) and
    on its FP32 route, K4 with its compiled taps and streamed, a model of
    strength 0 bit-equal to K1's ratio (an exact no-op)."""
    f = FLAGSHIP
    cases = [
        ('flagship 64x1x256x256/16x9x9', (f['N'], f['C'], f['S'], f['M'], f['A'], f['mode']),
         True),
        ('2-D 3x2x37x29/5x5x6 circular', (3, 2, (37, 29), 5, (5, 6), 'circular'), False),
        ('1-D 2x3x301/7x7 valid', (2, 3, (301,), 7, (7,), 'valid'), True),
    ]
    for i, (where, (N, C, Ss, M, A, mode), shared) in enumerate(cases):
        plan = ConvPlan.create(mode, Ss, A)
        T = plan.transform_shape
        E = tuple(t + a - 1 for t, a in zip(T, A))
        for S in MODEL_AXIS_COUNTS:
            rng = np.random.default_rng(100 + 10 * i + S)
            W, H = _stacked(rng, (M, C) + A, S), _stacked(rng, (N, M) + T, S)
            Rx, neg, pos = _stacked(rng, (N, C) + E, S), *(_stacked(rng, (M, C) + A, S)
                                                         for _ in range(2))
            hneg, hpos = (_stacked(rng, (N, M) + T, S) for _ in range(2))
            Vp = _stacked(rng, (N, C) + E, 1)[0] if shared else _stacked(rng, (N, C) + E, S)
            extra = None if shared else 0.1 * H

            def vp(s):
                return Vp if shared else Vp[s]

            def pe(s):
                return None if extra is None else extra[s]
            regs = engine.EPS + torch.tensor([0.1, 0.05, 0.2][:S], device=DEVICE)
            r = [float(x) for x in regs]
            nd = plan.ndim
            _model_axis_check('mu_ratio', lambda: mu.mu_ratio(H, hneg, hpos, regs, True),
                              lambda s: mu.mu_ratio_plain(H[s], hneg[s], hpos[s], r[s]),
                              lambda s: mu.mu_ratio(H[s], hneg[s], hpos[s], r[s]), where, S)
            _model_axis_check('mu_w', lambda: mu.mu_w(W, neg, pos, engine.EPS, nd, True),
                              lambda s: mu.mu_w_plain(W[s], neg[s], pos[s], engine.EPS, nd),
                              lambda s: mu.mu_w(W[s], neg[s], pos[s], engine.EPS, nd), where,
                              S, MU_W_TOL)
            X2 = torch.cat([(Vp.expand((S,) + Vp.shape) if shared else Vp), Rx], dim=2)
            _model_axis_check('grad_w', lambda: gw.grad_w_models(X2, H),
                              lambda s: gw.grad_w_plain(X2[s], H[s]),
                              lambda s: gw.grad_w(X2[s], H[s]), where, S)
            for passes in (3, 1):
                name = 'mu_h' if passes == 3 else 'mu_h_1pass'
                _model_axis_check(
                    'mu_h', lambda: mu_h.mu_h_models(Vp, Rx, W, H, regs, extra, passes),
                    lambda s: mu_h.mu_h_plain(vp(s), Rx[s], W[s], H[s], r[s], pe(s), passes),
                    lambda s: mu_h.mu_h(vp(s), Rx[s], W[s], H[s], r[s], pe(s), passes),
                    f'{where} {name}', S)
            with fma_route():
                _model_axis_check(
                    'mu_h', lambda: mu_h.mu_h_models(Vp, Rx, W, H, regs, extra),
                    lambda s: mu_h.mu_h_plain(vp(s), Rx[s], W[s], H[s], r[s], pe(s)),
                    lambda s: mu_h.mu_h(vp(s), Rx[s], W[s], H[s], r[s], pe(s)),
                    f'{where} FP32 route', S)
            ks = tuple(torch.tensor(k, device=DEVICE, dtype=torch.float32)
                       for k in inhibition_kernels(tuple(a - 1 for a in A)))
            _k4_model_axis(H, hneg, hpos, ks, regs, where, S)
    # K4 streamed, K2 in channel groups: two models each
    rng = np.random.default_rng(SEED + 2)
    where, dims, ranges = K4_STREAMED_CASES[0]
    H, hneg, hpos = (_stacked(rng, dims, 2) for _ in range(3))
    regs = engine.EPS + torch.tensor([0.1, 0.2], device=DEVICE)
    _k4_model_axis(H, hneg, hpos, inhibition_kernels(ranges), regs, where, 2)
    where, args, n_groups = K2_GROUP_CASES[0]
    X2, H = _k2_problem(*args, seed=40)
    X2 = torch.stack([X2, X2.flip(0)])
    H = torch.stack([H, 2 * H])
    before = gw.grad_w.launches
    _compare('grad_w', lambda: gw.grad_w_models(X2, H),
             lambda: tuple(torch.stack(p) for p in zip(*(gw.grad_w_plain(X2[s], H[s])
                                                         for s in range(2)))),
             f'{where} S=2')
    if gw.grad_w.launches - before != n_groups:
        raise AssertionError(f'grad_w at {where}, S=2: {gw.grad_w.launches - before} '
                             f'launches, not one per group ({n_groups})')
    _k5_model_axis()


#: K5's model-axis launches in phase 3: (where, rows, components, length of
#: the factor the Gram sums over, passes, layout, whether the models share
#: G); the main paths' two sides and a ragged shape
K5_MODEL_AXIS_CASES = [
    ('H side 16384x256', 16384, 256, 4096, 1, 'rows', False),
    ('W side 4096x256', 4096, 256, 16384, 1, 'views', False),
    ('ragged 1000x37, 2 passes', 1000, 37, 300, 2, 'rows', False),
    ('W side 1000x37, G shared', 1000, 37, 300, 1, 'views', True),
]


def _k5_stack(parts, layout: str) -> torch.Tensor:
    """The S models' operands stacked on a model axis in their layout:
    row-major, or (``'views'``) each a transposed view of a contiguous
    matrix, as the W side of a sweep launches them."""
    if layout == 'views':
        return torch.stack([t.T for t in parts]).transpose(1, 2)
    return torch.stack(parts)


def _k5_model_axis() -> None:
    """K5's model-axis launch (the HALS sweeps' vmap rule) at S = 1 and
    S = 3 against its plain version over the models within ``K5_TOL``, on
    the H side's row-major operands and the W side's transposed views (a G
    the models share at model stride 0 too), with per-model ``l1`` and
    ``l2``; each model bit-equal to its own single launch, required; the
    output in X's layout."""
    for i, (where, rows, m, length, inner, layout, shared) in enumerate(K5_MODEL_AXIS_CASES):
        for S in MODEL_AXIS_COUNTS:
            parts = [_k5_inputs(rows, m, length, SEED + 80 + 10 * i + s, layout)
                     for s in range(S)]
            X, G, P = (_k5_stack([p[k] for p in parts], layout) for k in range(3))
            if shared:
                G = G[0].expand(S, m, m)
            l1 = torch.tensor([0.1, 0.0, 0.3][:S], device=DEVICE) / length
            l2 = torch.tensor([0.0, 0.05, 0.02][:S], device=DEVICE)
            f = [(float(l1[s]), float(l2[s])) for s in range(S)]
            got = _model_axis_check(
                'hals_sweep', lambda: hals.hals_sweep_models(X, G, P, l1, l2, inner),
                lambda s: hals.hals_sweep_plain(X[s], G[s], P[s], *f[s], inner),
                lambda s: hals.hals_sweep(X[s], G[s], P[s], *f[s], inner),
                f'{where} ({layout})', S, K5_TOL, require_equal=True)
            if got.stride() != X.stride():
                raise AssertionError(f'hals_sweep at {where}, S={S}: output strides '
                                     f'{got.stride()}, not X\'s {X.stride()}')
            del X, G, P, parts, got


def _k4_model_axis(H, neg, pos, ks, regs, where, S) -> None:
    """K4's model-axis launch with per-model strengths, same- and
    cross-atom; at S = 3 model 1's strengths are 0, and its update must be
    K1's ratio bit for bit."""
    inh = torch.tensor([0.3, 0.0, 0.1][:S], device=DEVICE)
    cross = torch.tensor([0.2, 0.0, 0.05][:S], device=DEVICE)
    f = [(float(inh[s]), float(cross[s]), float(regs[s])) for s in range(S)]
    kw = dict(use_same=True, use_cross=True)
    got = inhibit.inhibited_mu_h_models(H, neg, pos, ks, inh, cross, regs, **kw)
    _model_axis_check('inhibited_mu_h', lambda: inhibit.inhibited_mu_h_models(
        H, neg, pos, ks, inh, cross, regs, **kw),
        lambda s: inhibit.inhibited_mu_h_plain(H[s], neg[s], pos[s], ks, *f[s], **kw),
        lambda s: inhibit.inhibited_mu_h(H[s], neg[s], pos[s], ks, *f[s], **kw), where, S)
    if S >= 2:
        ratio = mu.mu_ratio(H[1], neg[1], pos[1], f[1][2])
        if not torch.equal(got[1], ratio):
            raise AssertionError(f'inhibited_mu_h at {where}: strength 0 is not an exact '
                                 'no-op (the model differs from K1\'s ratio)')
        log(f'  {"inhibited_mu_h":14s} {where + " strength 0":34s} bit-equal to K1\'s ratio')


def _k4_streamed():
    """K4's streamed route (each case asserts it streams) against the plain
    version and against its sums in the streamed order."""
    rng = np.random.default_rng(SEED + 1)
    for where, dims, ranges in K4_STREAMED_CASES:
        H, neg, pos = (torch.tensor(rng.random(dims), device=DEVICE, dtype=torch.float32)
                       for _ in range(3))
        ks = inhibition_kernels(ranges)
        for use_same, use_cross in COMBOS:
            kw = dict(use_same=use_same, use_cross=use_cross)
            args = (H, neg, pos, ks, 0.3, 0.2, engine.EPS + 0.1)
            g = inhibit.launch_geometry(dims, tuple(k.size for k in ks), use_cross)
            label = (f'{where} {"s" if use_same else ""}{"c" if use_cross else ""}, '
                     f'{g["n_segments"]} seg')
            if g['n_segments'] < 2:
                raise AssertionError(f'inhibited_mu_h at {label}: not streamed: {g}')
            _compare('inhibited_mu_h', lambda: inhibit.inhibited_mu_h(*args, **kw),
                     lambda: inhibit.inhibited_mu_h_plain(*args, **kw), label)
            segment = (g['two_d'], g['seg_x'], g['seg_y'])
            _compare('inhibited_mu_h', lambda: inhibit.inhibited_mu_h(*args, **kw),
                     lambda: inhibit.inhibited_mu_h_segments_plain(*args, segment, **kw),
                     label + ' (order)')


def _mu_w_cases():
    """K1's W epilogue against its plain version within 1e-6, a zero atom
    kept zero, two launches bit-identical."""
    rng = np.random.default_rng(SEED + 2)
    f = FLAGSHIP
    cases = [('flagship W 16x1x9x9', (f['M'], f['C']) + f['A'], None),
             ('zero atom 16x1x9x9', (f['M'], f['C']) + f['A'], 3),
             ('100 atoms 3x15x15', (100, 3, 15, 15), 7),
             ('1-D atoms 8x2x1024', (8, 2, 1024), 0)]
    for where, shape, zero in cases:
        W, neg, pos = (torch.tensor(rng.random(shape), device=DEVICE, dtype=torch.float32)
                       for _ in range(3))
        if zero is not None:
            W[zero] = 0.
        args = (W, neg, pos, engine.EPS, len(shape) - 2)
        got, again, want = mu.mu_w(*args), mu.mu_w(*args), mu.mu_w_plain(*args)
        sync()
        rel = float((got - want).abs().max() / want.abs().max())
        same = torch.equal(got, again)
        zero_ok = zero is None or not bool(got[zero].any())
        log(f'  {"mu_w":14s} {where:34s} rel={rel:.3e}, two launches '
            f'{"bit-identical" if same else "DIFFER"}'
            + ('' if zero is None else f', zero atom {"zero" if zero_ok else "NOT zero"}'))
        if not (rel <= MU_W_TOL and same and zero_ok):
            raise AssertionError(f'mu_w at {where}: rel {rel:.3e} (> {MU_W_TOL}?), '
                                 f'bit-identical {same}, zero atom kept {zero_ok}')



def _one_pass_check(name, kernel, plain, exact, where) -> float:
    """A one-pass route against its plain version on TF32-rounded operands:
    in float32 within 1e-4 (two float32 sum orders, cuDNN's among them) and
    in float64 (``exact``: the products of the rounded operands are exact)
    within 1e-5, the route's own tolerance.  Returns the float64 distance
    (max |kernel - exact| / max |exact|)."""
    _compare(name, kernel, plain, where)
    got, want = kernel(), exact()
    if isinstance(want, torch.Tensor):
        got, want = (got,), (want,)
    scale = max(float(w.abs().max()) for w in want)
    rel = max(float((g.double() - w).abs().max()) for g, w in zip(got, want)) / scale
    log(f'  {name:14s} {where + ", rounded float64":34s} rel={rel:.3e}')
    if not rel <= ONE_PASS_TOL:
        raise AssertionError(f'{name} at {where}: {rel:.3e} off its plain version on the '
                             f'rounded operands in float64 > {ONE_PASS_TOL}')
    return rel


def _one_pass_cases():
    """K2's and K3's one-pass routes (``passes=1``) at phase 3's shapes and
    at their edge cases against their plain versions on TF32-rounded
    operands (:func:`_one_pass_check`; K3 where it takes the tensor-core
    route, the FP32 route printed), K2 in its groups, each launch counted
    on its route, and two K2 launches at the flagship bit-identical."""
    f = FLAGSHIP
    flagship = (f['N'], f['C'], f['S'], f['M'], f['A'], f['mode'])
    shapes = [('flagship', flagship), ('2-D 3x2x37x29/5x5x6 circular',
                                       (3, 2, (37, 29), 5, (5, 6), 'circular')),
              ('1-D 2x3x301/7x7 valid', (2, 3, (301,), 7, (7,), 'valid'))]
    k2 = shapes + K2_CASES + [(w, a) for w, a, _ in K2_GROUP_CASES]
    for i, (where, args) in enumerate(k2):
        X2, H = _k2_problem(*args, seed=40 + i)
        reset_counts()
        _one_pass_check('grad_w_1pass', lambda: gw.grad_w(X2, H, 1),
                        lambda: gw.grad_w_plain(X2, H, 1),
                        lambda: gw.grad_w_plain(round_tf32(X2).double(),
                                                round_tf32(H).double()), where)
        if gw.grad_w.one_pass_launches != gw.grad_w.launches or not gw.grad_w.launches:
            raise AssertionError(f'grad_w_1pass at {where}: {gw.grad_w.launches} launches, '
                                 f'{gw.grad_w.one_pass_launches} on the one-pass route')
        if where == 'flagship':
            got, again = gw.grad_w(X2, H, 1), gw.grad_w(X2, H, 1)
            sync()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError('grad_w_1pass: two launches on the same inputs differ')
            log(f'  {"grad_w_1pass":14s} {"flagship, two launches":34s} bit-identical')
    k3 = [(w, a, False) for w, a in shapes] + [(w, a, e) for w, a, e, _ in K3_CASES]
    for i, (where, args, with_extra) in enumerate(k3):
        p = _k3_problem(*args, seed=60 + i, with_extra=with_extra)
        if mu_h.launch_geometry(*p[:4], passes=1)[2]['route'] != 'mma':
            log(f'  {"mu_h_1pass":14s} {where:34s} takes the FP32 route: float32 at every level')
            continue
        reset_counts()
        Vp, Rx, W, H, denom, extra = p
        _one_pass_check('mu_h_1pass', lambda: mu_h.mu_h(*p, 1), lambda: mu_h.mu_h_plain(*p, 1),
                        lambda: mu_h.mu_h_plain(
                            *(round_tf32(t).double() for t in (Vp, Rx, W)), H.double(), denom,
                            None if extra is None else extra.double()), where)
        if mu_h.mu_h.one_pass_launches != mu_h.mu_h.launches or not mu_h.mu_h.launches:
            raise AssertionError(f'mu_h_1pass at {where}: {mu_h.mu_h.launches} launches, '
                                 f'{mu_h.mu_h.one_pass_launches} on the one-pass route')


def _k2_problem(N, C, S, M, A, mode, seed):
    """Random non-negative X2 and H of one K2 problem."""
    rng = np.random.default_rng(seed)
    plan = ConvPlan.create(mode, S, A)
    T = plan.transform_shape
    E = tuple(t + a - 1 for t, a in zip(T, A))
    dev = dict(device=DEVICE, dtype=torch.float32)
    return (torch.tensor(rng.random((N, 2 * C) + E), **dev),
            torch.tensor(rng.random((N, M) + T), **dev))


def _k2_float64_and_determinism():
    """K2 at the flagship against per-sample float64 ``corr_W`` sums on the
    card, and two launches bit for bit."""
    f = FLAGSHIP
    X2, H = _k2_problem(f['N'], f['C'], f['S'], f['M'], f['A'], f['mode'], seed=0)
    got = gw.grad_w(X2, H)
    want = gw.grad_w_plain(X2.double(), H.double())
    scale = max(float(w.abs().max()) for w in want)
    rel = max(float((g.double() - w).abs().max()) for g, w in zip(got, want)) / scale
    log(f'  {"grad_w":14s} {"flagship against float64":34s} rel={rel:.3e}')
    if not rel <= F64_TOL:
        raise AssertionError(f'grad_w at the flagship: {rel:.3e} off float64 > {F64_TOL}')
    again = gw.grad_w(X2, H)
    sync()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError('grad_w: two launches on the same inputs differ')
    log(f'  {"grad_w":14s} {"flagship, two launches":34s} bit-identical')


def _k3_problem(N, C, S, M, A, mode, seed, with_extra=False):
    """Random non-negative inputs of one K3 problem: Vp, Rx, W, H,
    denom_add and pos_extra (or None)."""
    rng = np.random.default_rng(seed)
    T = ConvPlan.create(mode, S, A).transform_shape
    E = tuple(t + a - 1 for t, a in zip(T, A))

    def t(shape):
        return torch.tensor(rng.random(shape), device=DEVICE, dtype=torch.float32)
    return (t((N, C) + E), t((N, C) + E), t((M, C) + A), t((N, M) + T), engine.EPS + 0.1,
            t((N, M) + T) if with_extra else None)


def _k3_routes_and_float64():
    """K3 on each side of its route choice (each case asserts its route),
    the flagship with the FP32 route forced, and the flagship against
    ``mu_h_plain`` in float64 on the card."""
    def check(where, p, route):
        took = mu_h.launch_geometry(*p[:4])[2]['route']
        if took != route:
            raise AssertionError(f'mu_h at {where}: took the {took} route, not {route}')
        _compare('mu_h', lambda: mu_h.mu_h(*p), lambda: mu_h.mu_h_plain(*p),
                 f'{where} ({route})')

    f = FLAGSHIP
    flagship = (f['N'], f['C'], f['S'], f['M'], f['A'], f['mode'])
    for i, (where, args, with_extra, route) in enumerate(K3_CASES):
        check(where, _k3_problem(*args, seed=20 + i, with_extra=with_extra), route)
    with fma_route():
        check('flagship, FP32 route forced', _k3_problem(*flagship, seed=19), 'fma')
        check('1-D 70000 samples, FP32 route forced',
              _k3_problem(70000, 2, (64,), 4, (9,), 'valid', seed=18), 'fma')
    # the streamed FP32 route against its sums in its own order, and float64
    p = _k3_problem(2, 16, (64, 72), 16, (31, 31), 'valid', seed=17, with_extra=True)
    g = mu_h.launch_geometry(*p[:4])[2]
    segment = (g['seg_c'], g['seg_ax'], g['seg_ay'])
    got = mu_h.mu_h(*p)
    want = mu_h.mu_h_segments_plain(*p[:5], segment, p[5])
    f64 = mu_h.mu_h_plain(*(t.double() for t in p[:4]), p[4], p[5].double())
    rel = float((got - want).abs().max() / want.abs().max())
    rel64 = float((got.double() - f64).abs().max() / f64.abs().max())
    log(f'  {"mu_h":14s} {"C=16 31x31, " + str(g["n_segments"]) + " segments":34s} '
        f'rel={rel:.3e} against its own order, {rel64:.3e} against float64')
    if not (g['n_segments'] > 1 and rel <= TOL and rel64 <= TOL):
        raise AssertionError(f'mu_h streamed over {g["n_segments"]} segments: {rel:.3e} off '
                             f'its own order, {rel64:.3e} off float64 (> {TOL})')
    Vp, Rx, W, H, denom, _ = _k3_problem(*flagship, seed=0)
    if mu_h.launch_geometry(Vp, Rx, W, H)[2]['route'] != 'mma':
        raise AssertionError('mu_h at the flagship: not on the tensor-core route')
    got = mu_h.mu_h(Vp, Rx, W, H, denom).double()
    want = mu_h.mu_h_plain(Vp.double(), Rx.double(), W.double(), H.double(), denom)
    rel = float((got - want).abs().max() / want.abs().max())
    log(f'  {"mu_h":14s} {"flagship against float64":34s} rel={rel:.3e}')
    if not rel <= F64_TOL:
        raise AssertionError(f'mu_h at the flagship: {rel:.3e} off float64 > {F64_TOL}')


def _image_2d() -> np.ndarray:
    """The golden 2-D fixture, built as tests/fixtures.py builds it."""
    img = synthetic_face(gray=False)[::10, ::10]
    return np.repeat(img.transpose((2, 0, 1))[np.newaxis], 2, axis=0)


def _signal_1d() -> np.ndarray:
    """The golden 1-D pulse train, built as tests/fixtures.py builds it
    (it reseeds the global NumPy stream)."""
    np.random.seed(42)
    signal, _ = generate_pulse_train(pulse_length=20, n_pulses=5)
    return signal[np.newaxis]


def _fit_kw(fit: dict) -> tuple:
    """``engine.fit_loop`` arguments of a ``fit`` call's regularizers."""
    inh = fit.get('inhibition_strength', 0.)
    cross = fit.get('cross_atom_inhibition_strength', 0.)
    return ((fit.get('sparsity_H', 0.), inh, cross),
            dict(use_inhibition=inh > 0, use_cross=cross > 0))


def _ms_per_iteration(model, fit: dict, n=10) -> float:
    args, flags = _fit_kw(fit)

    def run():
        model._W, model._H = engine.fit_loop(model._Vp, model._W, model._H, n, *args,
                                             model._kernels, plan=model._plan,
                                             strategy=model._strategy, **flags)
    return time_ms(run, reps=1) / n


def _check_rel(what, got, want):
    rel = abs(got - want) / abs(want)
    log(f'  {what}: {got!r} vs golden {want!r} (rel {rel:.3e})')
    if not rel <= GOLDEN_RTOL:
        raise AssertionError(f'{what} off by {rel:.3e} > {GOLDEN_RTOL}')


def phase_golden() -> dict:
    goldens = json.loads((ROOT / 'tests' / 'golden_values.json').read_text())
    image = _image_2d()
    ms = {}
    log('golden 2-D fixture:')
    np.random.seed(42)
    nmf = TransformInvariantNMF(n_atoms=10, atom_shape=(7, 7), device=DEVICE)
    nmf.fit(image, sparsity_H=0.1, n_iterations=10)
    _check_rel('2d/valid energy', nmf._energy_function(), goldens['2d']['valid'])
    spread = [_ms_per_iteration(nmf, dict(sparsity_H=0.1)) for _ in range(5)]
    ms['2d'] = float(np.median(spread))
    log(f'  2-D fixture: {ms["2d"]:.4f} ms/iteration (median of 5 windows of 10: '
        + '/'.join(f'{t:.4f}' for t in spread) + ')')

    log('golden 1-D pulse train (inhibition_strength=0.1):')
    for mode, golden in goldens['1d'].items():
        np.random.seed(42)
        nmf = TransformInvariantNMF(n_atoms=3, atom_shape=(20,), reconstruction_mode=mode,
                                    device=DEVICE)
        reset_counts()
        nmf.fit(_signal_1d(), n_iterations=10, inhibition_strength=0.1)
        launches = counts()
        _check_rel(f'1d/{mode} energy', nmf._energy_function(), golden)
        if launches['inhibited_mu_h'] < 10:
            raise AssertionError(f'1-D {mode}: K4 launched {launches["inhibited_mu_h"]} '
                                 'times in 10 iterations')
        if mode == 'valid':
            ms['1d'] = _ms_per_iteration(nmf, dict(inhibition_strength=0.1))
            log(f'  1-D pulse train: {ms["1d"]:.4f} ms/iteration; launches {launches}')

    log('golden sparsity_inhibition sweep (2-D fixture, 5 atoms 5x5):')
    for params in SPARSITY_INHIBITION:
        key = ','.join(f'{k}={v}' for k, v in sorted(params.items())) or 'plain'
        golden = goldens['sparsity_inhibition'][key]
        np.random.seed(42)
        nmf = TransformInvariantNMF(n_atoms=5, atom_shape=(5, 5), device=DEVICE)
        nmf.fit(image, n_iterations=10, **params)
        H = nmf.H
        _check_rel(f'{key} energy', nmf._energy_function(), golden['energy'])
        _check_rel(f'{key} L1', float(np.abs(H).sum(dtype=np.float64)), golden['l1'])
        log(f'  {key} L0: {int((H > 1e-4).sum())} vs golden {golden["l0"]}')
    return ms


def phase_flagship() -> tuple:
    """The flagship fit plain and inhibited; returns the launches and the
    iterations of each kernel's paths, ms/iteration per path and the last
    plain model."""
    f = FLAGSHIP
    V = np.random.default_rng(SEED).random((f['N'], f['C']) + f['S'], dtype=np.float32)

    def model():
        return TransformInvariantNMF(n_atoms=f['M'], atom_shape=f['A'],
                                     reconstruction_mode=f['mode'], seed=SEED, device=DEVICE)
    start = model()
    start.fit(V, n_iterations=0)
    e0 = start._energy_function()
    del start

    # the plain path last: its model stays alive for phase 7 and would
    # count in the other paths' peak memory
    paths = [
        ('inhibited', ('mu_w', 'grad_w', 'inhibited_mu_h'),
         dict(sparsity_H=f['sparsity'], inhibition_strength=f['inhibition'])),
        ('inhibited+cross', ('mu_w', 'grad_w', 'inhibited_mu_h'),
         dict(sparsity_H=f['sparsity'], inhibition_strength=f['inhibition'],
              cross_atom_inhibition_strength=f['cross'])),
        ('plain', ('mu_w', 'grad_w', 'mu_h'), dict(sparsity_H=f['sparsity'])),
    ]
    total = dict.fromkeys(KERNELS, 0)
    iterations = dict.fromkeys(KERNELS, 0)
    ms, plain_model = {}, None
    for label, required, fit in paths:
        nmf = model()
        sync()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        nmf.fit(V, n_iterations=N_ITER, **fit)
        sync()
        wall = time.perf_counter() - t0
        launches = counts()
        peak = torch.cuda.max_memory_allocated() / 2**20
        e = nmf._energy_function()
        log(f'flagship {label}: energy {e0!r} -> {e!r} after {N_ITER} iterations '
            f'({wall:.2f} s wall incl. host init); launches {launches}; '
            f'peak device memory {peak:.0f} MiB')
        if not (math.isfinite(e) and e < e0):
            raise AssertionError(f'flagship {label}: energy {e} is not finite and below {e0}')
        sums = nmf._W.sum(dim=(-2, -1))
        if not torch.allclose(sums, torch.ones_like(sums), atol=1e-5):
            raise AssertionError(f'flagship {label}: atoms do not sum to 1: '
                                 f'{sums.flatten().tolist()}')
        for name in required:
            if launches[name] < N_ITER:
                raise AssertionError(f'flagship {label}: {name} launched {launches[name]} '
                                     f'times in {N_ITER} iterations')
            iterations[name] += N_ITER
        for name, n in launches.items():
            total[name] += n
        ms[label] = _ms_per_iteration(nmf, fit)
        log(f'flagship {label}: {ms[label]:.4f} ms/iteration')
        if label == 'plain':
            plain_model = nmf
        del nmf
    return total, iterations, ms, plain_model


def phase_3d():
    """A small 3-D inhibited fit: the rank gate keeps K2, K3 and K4 off it
    and K1's W epilogue, which takes any rank, runs once per iteration; its
    factors match the same seeded fit in float64 on the CPU."""
    V = np.random.default_rng(SEED).random((2, 1, 12, 12, 12))
    fit = dict(n_iterations=5, sparsity_H=0.1, inhibition_strength=0.1,
               cross_atom_inhibition_strength=0.05)
    gpu = TransformInvariantNMF(n_atoms=4, atom_shape=(3, 3, 3), seed=SEED, device=DEVICE)
    reason = engine.plain_reason(ConvPlan.create('valid', V.shape[2:], (3, 3, 3)), torch.float32)
    if reason is None or engine.dtype_reason(torch.float32) is not None:
        raise AssertionError(f'3-D: the kernel gates say {reason!r} and '
                             f'{engine.dtype_reason(torch.float32)!r}')
    reset_counts()
    gpu.fit(V, **fit)
    sync()
    launches = counts()
    cpu = TransformInvariantNMF(n_atoms=4, atom_shape=(3, 3, 3), seed=SEED, device='cpu',
                                dtype=torch.float64)
    cpu.fit(V, **fit)
    rel = max(float(np.abs(gpu.W - cpu.W).max() / np.abs(cpu.W).max()),
              float(np.abs(gpu.H - cpu.H).max() / np.abs(cpu.H).max()))
    log(f'3-D 2x1x12x12x12/4x3x3x3 (K2-K4 plain: {reason}): launches {launches}; W and H '
        f'{rel:.3e} off float64 on the CPU')
    expected = dict.fromkeys(KERNELS, 0)
    expected['mu_w'] = fit['n_iterations']
    if launches != expected:
        raise AssertionError(f'3-D fit launched {launches}, not {expected}')
    if not rel <= TOL:
        raise AssertionError(f'3-D fit off float64 by {rel:.3e} > {TOL}')


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def phase_large():
    """16 channels of 31 x 31 atoms, plain and inhibited, 3 iterations on
    the kernels: no plain version called, each kernel of the path launched
    every iteration, K3 on its streamed FP32 route.  W and H against the
    same seeded fit in float64 (which the gate sends to the plain versions)
    within the float32 tolerance 1e-4, with the same fit on the plain
    versions in float32 beside it: at these 15,376-term sums float32 itself
    is about 2e-5 off float64.  Then ms/iteration per path and K3's and
    K2's times."""
    f = LARGE
    V = np.random.default_rng(SEED).random((f['N'], f['C']) + f['S'], dtype=np.float32)
    paths = [('plain', ('mu_w', 'grad_w', 'mu_h'), dict(sparsity_H=f['sparsity'])),
             ('inhibited', ('mu_w', 'grad_w', 'inhibited_mu_h'),
              dict(sparsity_H=f['sparsity'], inhibition_strength=f['inhibition']))]
    out = {}
    for label, required, fit in paths:
        def fitted(dtype, use_pallas=None):
            model = TransformInvariantNMF(f['M'], f['A'], dtype=dtype, seed=SEED, device=DEVICE,
                                          use_pallas=use_pallas)
            model.fit(V, n_iterations=f['n_iter'], **fit)
            sync()
            return model
        reset_counts()
        ref = fitted(torch.float64)
        if any(counts().values()):
            raise AssertionError(f'large {label}: the float64 fit launched {counts()}')
        plain32 = fitted(torch.float32, use_pallas=False)
        reset_counts()
        with plain_calls() as plain:
            nmf = fitted(torch.float32)
        launches = counts()
        log(f'large {label}: launches {launches}, plain calls {plain}')
        if any(plain.values()):
            raise AssertionError(f'large {label}: the float32 fit called plain versions {plain}')
        for name in required:
            if launches[name] < f['n_iter']:
                raise AssertionError(f'large {label}: {name} launched {launches[name]} times '
                                     f'in {f["n_iter"]} iterations')
        rel = {k: (_rel(m.W, r.W), _rel(m.H, r.H))
               for k, m, r in (('kernels-plain32', nmf, plain32), ('kernels-float64', nmf, ref),
                               ('plain32-float64', plain32, ref))}
        log(f'large {label}: W, H off: ' + ', '.join(f'{k} {w:.3e} {h:.3e}'
                                                     for k, (w, h) in rel.items())
            + f' (float64: {engine.plain_reason(ref._plan, ref.dtype)}); '
            f'energy {nmf._energy_function()!r}')
        if not max(rel['kernels-float64']) <= TOL:
            raise AssertionError(f'large {label}: W, H {rel["kernels-float64"]} off float64 '
                                 f'> {TOL}')
        del ref, plain32
        out[label] = _ms_per_iteration(nmf, fit, n=2)
        log(f'large {label}: {out[label]:.2f} ms/iteration')
        if label == 'plain':
            Vp, W, H = nmf._Vp, nmf._W, nmf._H
            Rx = conv.extend_data(conv.reconstruct(W, H, nmf._plan), nmf._plan)
            g = mu_h.launch_geometry(Vp, Rx, W, H)[2]
            if g['route'] != 'fma' or g['n_segments'] < 2:
                raise AssertionError(f'large: K3 is not on its streamed FP32 route: {g}')
            groups = len(gw._geometry(*gw_dims(nmf._plan, H, 2 * f['C']))['groups'])
            out['mu_h_ms'] = time_ms(lambda: mu_h.mu_h(Vp, Rx, W, H, engine.EPS + 0.1), reps=3)
            X2 = torch.cat([Vp, Rx], dim=1)
            out['grad_w_ms'] = time_ms(lambda: gw.grad_w(X2, H), reps=3)
            # the nearest single PyTorch calls (cuDNN, TF32 off), as in phase 9
            lib_w = time_ms(lambda: conv.corr_W(X2, H), reps=1)
            VR = torch.cat([Vp, Rx], dim=0)
            lib_h = time_ms(lambda: conv.corr_H(VR, W), reps=3)
            log(f'large: library calls: conv.corr_W {lib_w:.2f} ms (grad_w {out["grad_w_ms"]:.2f}), '
                f'conv.corr_H {lib_h:.2f} ms (mu_h {out["mu_h_ms"]:.2f})')
            # at precision 'default': K2 in one TF32 pass (and K3's route
            # there) against cuDNN with TF32 on
            tf32_plan = ConvPlan.create(nmf._plan.mode, nmf._plan.sample_shape, f['A'],
                                        precision='default')
            out['grad_w_1pass_ms'] = time_ms(lambda: gw.grad_w(X2, H, 1), reps=3)
            lib_w1 = time_ms(lambda: conv.corr_W(X2, H, tf32_plan), reps=1)
            lib_h1 = time_ms(lambda: conv.corr_H(VR, W, tf32_plan), reps=3)
            route = mu_h.launch_geometry(Vp, Rx, W, H, passes=1)[2]['route']
            log(f'large at default ({card()}): grad_w one pass {out["grad_w_1pass_ms"]:.2f} ms, '
                f'conv.corr_W with TF32 {lib_w1:.2f} ms; mu_h on its {route} route, '
                f'conv.corr_H with TF32 {lib_h1:.2f} ms')
            out.update(corr_W_tf32_ms=lib_w1, corr_H_tf32_ms=lib_h1)
            del VR
            # each kernel: two correlations of N*M*C*prod(T)*prod(A) multiply-adds
            flops = 4 * H.numel() * f['C'] * math.prod(f['A'])
            rates = dict(mu_h=FP32_FLOP_PER_S, grad_w=OPS_PER_S['grad_w'])  # K3: FP32 route
            bound_ms = {name: bound(0, flops, rate)[0] for name, rate in rates.items()}
            log(f'large: mu_h {out["mu_h_ms"]:.2f} ms (FP32 route, {g["n_segments"]} '
                f'segments of {g["seg_c"]} channels), grad_w {out["grad_w_ms"]:.2f} ms '
                f'({groups} launch{"es" if groups > 1 else ""}); {flops / 1e12:.4f} TFLOP '
                'each: ' + ', '.join(f'{k} {flops / out[k + "_ms"] / 1e9:.2f} TFLOP/s, '
                                     f'{100 * bound_ms[k] / out[k + "_ms"]:.1f} % of its '
                                     f'{bound_ms[k]:.4f} ms operations bound'
                                     for k in ('mu_h', 'grad_w')))
            del Vp, Rx, X2, W, H
        del nmf
    _wide_range()


def _wide_range():
    """The flagship fit with ``inhibition_range=120`` (241 x 241 taps, which
    no K4 tile holds in one piece) for 3 iterations on the kernels: energy
    finite and falling, each kernel of the inhibited path launched every
    iteration, no plain version called; then K4 at that shape against its
    plain version, its time and its bound."""
    f = FLAGSHIP
    V = np.random.default_rng(SEED).random((f['N'], f['C']) + f['S'], dtype=np.float32)
    n_iter = 3
    fit = dict(sparsity_H=f['sparsity'], inhibition_strength=f['inhibition'])
    nmf = TransformInvariantNMF(f['M'], f['A'], inhibition_range=WIDE_RANGE, seed=SEED,
                                device=DEVICE)
    nmf.fit(V, n_iterations=0)
    e0 = nmf._energy_function()
    reset_counts()
    with plain_calls() as plain:
        nmf.fit(V, n_iterations=n_iter, **fit)
        sync()
    launches = counts()
    e = nmf._energy_function()
    Vp, W, H, plan, ks = nmf._Vp, nmf._W, nmf._H, nmf._plan, nmf._kernels
    g = inhibit.launch_geometry(tuple(H.shape), tuple(k.numel() for k in ks))
    log(f'wide range {WIDE_RANGE} ({g["tx"]} x {g["ty"]} taps): energy {e0!r} -> {e!r} after '
        f'{n_iter} iterations; launches {launches}, plain calls {plain}; K4 {g["n_segments"]} '
        f'segments of {g["seg_x"]} x taps, tile {g["tile_x"]} x {g["tile_y"]}')
    if not (math.isfinite(e) and e < e0):
        raise AssertionError(f'wide range: energy {e} is not finite and below {e0}')
    if any(plain.values()) or g['n_segments'] < 2:
        raise AssertionError(f'wide range: plain calls {plain}, K4 geometry {g}')
    for name in ('mu_w', 'grad_w', 'inhibited_mu_h'):
        if launches[name] < n_iter:
            raise AssertionError(f'wide range: {name} launched {launches[name]} times in '
                                 f'{n_iter} iterations')
    Rx = conv.extend_data(conv.reconstruct(W, H, plan), plan)
    neg, pos = (t.contiguous() for t in conv.grad_H_pair_prepared(Vp, Rx, W))
    del Rx
    args = (H, neg, pos, ks, f['inhibition'], 0., engine.EPS + f['sparsity'])
    _compare('inhibited_mu_h', lambda: inhibit.inhibited_mu_h(*args),
             lambda: inhibit.inhibited_mu_h_plain(*args), f'flagship range {WIDE_RANGE}')
    k1, plain_ms, k2 = (time_ms(fn, reps=3) for fn in (
        lambda: inhibit.inhibited_mu_h(*args), lambda: inhibit.inhibited_mu_h_plain(*args),
        lambda: inhibit.inhibited_mu_h(*args)))
    nH = H.numel()
    flops = nH * (2 * (g['tx'] + g['ty']) + 10)
    bound_ms, bound_by = bound(4 * 4 * nH, flops, OPS_PER_S['inhibited_mu_h'])
    per_it = _ms_per_iteration(nmf, fit, n=2)
    log(f'wide range: inhibited_mu_h {k1:.4f}/{k2:.4f} ms, plain {plain_ms:.4f} ms, bound '
        f'{bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP), '
        f'{100 * bound_ms / ((k1 + k2) / 2):.1f} % of bound; {per_it:.4f} ms/iteration')


def gw_dims(plan: ConvPlan, H: torch.Tensor, C2: int) -> tuple:
    """``gw._geometry``'s arguments for a K2 launch on ``H`` (one card)."""
    T, A = plan.transform_shape, plan.atom_shape
    if plan.ndim == 1:
        T, A = (1,) + T, (1,) + A
    n_sm = torch.cuda.get_device_properties(H.device).multi_processor_count
    return (H.shape[0], H.shape[1], C2) + T + A + (n_sm,)


def phase_float64():
    """The golden fits in float64 on the card: the gate sends them to the
    plain versions (no kernel launch); energies within rtol 1e-8."""
    goldens = json.loads((ROOT / 'tests' / 'golden_values.json').read_text())
    # the data as phase_golden makes it: the pulse train reseeds the global
    # NumPy stream, so it is made right before its fit draws W and H
    fits = [('2d/valid', _image_2d, dict(n_atoms=10, atom_shape=(7, 7)),
             dict(sparsity_H=0.1), goldens['2d']['valid'])]
    fits += [(f'1d/{mode}', _signal_1d,
              dict(n_atoms=3, atom_shape=(20,), reconstruction_mode=mode),
              dict(inhibition_strength=0.1), golden) for mode, golden in goldens['1d'].items()]
    for key, data, init, fit, golden in fits:
        np.random.seed(42)
        nmf = TransformInvariantNMF(**init, dtype=torch.float64, device=DEVICE)
        reset_counts()
        nmf.fit(data(), n_iterations=10, **fit)
        sync()
        launches = counts()
        energy = nmf._energy_function()
        rel = abs(energy - golden) / abs(golden)
        log(f'  float64 {key}: energy {energy!r} vs golden {golden!r} (rel {rel:.3e}); '
            f'plain versions: {engine.plain_reason(nmf._plan, nmf.dtype)}; launches {launches}')
        if any(launches.values()):
            raise AssertionError(f'float64 {key}: kernels launched {launches}')
        if not rel <= F64_GOLDEN_RTOL:
            raise AssertionError(f'float64 {key}: energy off by {rel:.3e} > {F64_GOLDEN_RTOL}')


def phase_times(nmf) -> dict:
    """Kernel and plain version at the flagship shapes, in turns
    (plain, kernel, kernel, plain), the nearest single PyTorch call, the
    bound, and the rest of one iteration."""
    f = FLAGSHIP
    fns = _problem(f['N'], f['C'], f['S'], f['M'], f['A'], f['mode'], seed=0)
    times = {}
    for name, (kernel, plain, library, work) in fns.items():
        p1, k1, k2, p2 = (time_ms(fn) for fn in (plain, kernel, kernel, plain))
        lib = None if library is None else time_ms(library)
        bound_ms, bound_by = bound(*work, OPS_PER_S[name])
        ms = (k1 + k2) / 2
        times[name] = dict(ms=ms, plain_ms=(p1 + p2) / 2, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=lib)
        log(f'  {name:14s} kernel {k1:.4f}/{k2:.4f} ms  plain {p1:.4f}/{p2:.4f} ms  '
            f'library {"none" if lib is None else f"{lib:.4f} ms"}  bound {bound_ms:.4f} ms '
            f'({bound_by}; {work[0] / 1e9:.4f} GB, {work[1] / 1e9:.4f} GFLOP), '
            f'{100 * bound_ms / ms:.1f} % of bound')
    # K3's two designs at the flagship, in turns: the FP32 route of the
    # first port (forced) and the tensor-core route the shape takes
    k3 = fns['mu_h'][0]
    with fma_route():
        f1 = time_ms(k3)
    m1, m2 = time_ms(k3), time_ms(k3)
    with fma_route():
        f2 = time_ms(k3)
    log(f'  mu_h tensor-core route {m1:.4f}/{m2:.4f} ms, FP32 route (first port) '
        f'{f1:.4f}/{f2:.4f} ms, in turns')
    same = _problem(f['N'], f['C'], f['S'], f['M'], f['A'], f['mode'], seed=0,
                    use_cross=False)['inhibited_mu_h'][0]
    k1, k2 = time_ms(same), time_ms(same)
    times['inhibited_mu_h']['same_atom_ms'] = (k1 + k2) / 2
    log(f'  inhibited_mu_h same-atom only: kernel {k1:.4f}/{k2:.4f} ms')
    # the 17 compiled taps against the runtime tap loop, in turns
    both = fns['inhibited_mu_h'][0]
    with runtime_taps():
        r = [time_ms(fn) for fn in (both, same, same, both)]
    c = [time_ms(fn) for fn in (both, same, same, both)]
    with runtime_taps():
        r += [time_ms(fn) for fn in (both, same, same, both)]
    times['inhibited_mu_h'].update(runtime_taps_ms=(r[0] + r[3] + r[4] + r[7]) / 4,
                                   runtime_taps_same_atom_ms=(r[1] + r[2] + r[5] + r[6]) / 4,
                                   compiled_taps_ms=(c[0] + c[3]) / 2,
                                   compiled_taps_same_atom_ms=(c[1] + c[2]) / 2)
    log(f'  inhibited_mu_h runtime tap loop: same + cross {r[0]:.4f}/{r[3]:.4f}/{r[4]:.4f}/'
        f'{r[7]:.4f} ms, same-atom {r[1]:.4f}/{r[2]:.4f}/{r[5]:.4f}/{r[6]:.4f} ms; '
        f'17 taps compiled in between: {c[0]:.4f}/{c[3]:.4f}, {c[1]:.4f}/{c[2]:.4f} ms')
    W, H, plan = nmf._W, nmf._H, nmf._plan
    big = [torch.rand_like(H) for _ in range(3)]
    # 13 x 13 taps (atoms of 7 x 7) at the same size, same-atom: centred in
    # zeros for the compiled 17, against the runtime loop at 13
    ks13 = [torch.tensor(k, device=DEVICE, dtype=torch.float32)
            for k in inhibition_kernels((6, 6))]

    def k13():
        return inhibit.inhibited_mu_h(*big, ks13, 0.1, 0.05, engine.EPS + 0.1)
    with runtime_taps():
        r = [time_ms(k13)]
    c = [time_ms(k13), time_ms(k13)]
    with runtime_taps():
        r.append(time_ms(k13))
    log(f'  inhibited_mu_h 13 x 13 taps, same-atom: padded to 17 compiled {c[0]:.4f}/'
        f'{c[1]:.4f} ms, runtime tap loop {r[0]:.4f}/{r[1]:.4f} ms')
    rec = time_ms(lambda: conv.reconstruct(W, H, plan))
    ext = time_ms(lambda: torch.cat([nmf._Vp, conv.extend_data(conv.reconstruct(W, H, plan),
                                                                plan)], dim=1)) - rec
    log(f'  reconstruct (cuDNN, TF32 off) {rec:.4f} ms; extend + stack {ext:.4f} ms')
    pair = time_ms(lambda: conv.grad_H_pair_prepared(nmf._Vp, conv.extend_data(
        conv.reconstruct(W, H, plan), plan), W)) - rec
    log(f'  extend + H gradient pair of the inhibited path (cuDNN, TF32 off, 2N batch) '
        f'{pair:.4f} ms')
    # K1 at the size of H, for its bandwidth (the main path calls it on W)
    k1 = time_ms(lambda: mu.mu_ratio(*big, 0.1))
    log(f'  mu_ratio at H size {tuple(H.shape)}: {k1:.4f} ms '
        f'({4 * 4 * H.numel() / k1 / 1e6:.0f} GB/s)')
    # the W epilogue fused (mu_w) against the pair it replaced (K1's ratio,
    # then the normalisation's sum, compare, ones, where and divide), in turns
    neg, pos = gw.grad_w(torch.cat([nmf._Vp, conv.extend_data(conv.reconstruct(W, H, plan),
                                                              plan)], dim=1), H)

    def pair():
        return engine._normalize_W(mu.mu_ratio(W, neg, pos, engine.EPS), plan.ndim)

    def fused():
        return mu.mu_w(W, neg, pos, engine.EPS, plan.ndim)
    p1, f1, f2, p2 = (time_ms(fn) for fn in (pair, fused, fused, pair))
    times['mu_w']['pair_ms'] = (p1 + p2) / 2
    log(f'  W epilogue: mu_w {f1:.4f}/{f2:.4f} ms (one launch), mu_ratio + normalisation '
        f'{p1:.4f}/{p2:.4f} ms (K1 and five PyTorch operations), in turns')
    return times


#: H-only iterations of each flagship ``transform`` call (phase 10)
ENCODER_ITER = 10
#: chunked against whole-batch ``transform`` (max|a - b| / max|b|)
CHUNK_TOL = 1e-5


def _h_only_ms(model, fit: dict, n=ENCODER_ITER) -> float:
    """ms per H-only iteration (W frozen) on ``model``'s state, CUDA
    events around ``engine.fit_loop(update_W=False)``."""
    args, flags = _fit_kw(fit)

    def run():
        model._H = engine.fit_loop(model._Vp, model._W, model._H, n, *args, model._kernels,
                                   plan=model._plan, strategy=model._strategy,
                                   update_W=False, **flags)[1]
    return time_ms(run, reps=1) / n


def phase_encoder(W: np.ndarray) -> tuple:
    """``transform`` at the flagship against phase 5's dictionary, on the
    kernels and on the plain versions; returns the launches and iterations
    of each kernel and the encoder's times."""
    f = FLAGSHIP
    V = np.random.default_rng(SEED + 1).random((f['N'], f['C']) + f['S'], dtype=np.float32)
    paths = [('plain', 'mu_h', dict(sparsity_H=f['sparsity'])),
             ('inhibited', 'inhibited_mu_h',
              dict(sparsity_H=f['sparsity'], inhibition_strength=f['inhibition']))]
    total = dict.fromkeys(KERNELS, 0)
    iterations = dict.fromkeys(KERNELS, 0)
    out = {}
    for label, kernel, fit in paths:
        for h_init in ('random', 'correlate'):
            def encoder(use_pallas=None):
                return TransformInvariantNMF(f['M'], f['A'], seed=SEED, h_init=h_init,
                                             device=DEVICE,
                                             use_pallas=use_pallas).set_dictionary(W)
            enc = encoder()
            sync()
            reset_counts()
            t0 = time.perf_counter()
            H = enc.transform(V, n_iterations=ENCODER_ITER, **fit)
            wall = time.perf_counter() - t0
            launches = counts()
            want = encoder(use_pallas=False).transform(V, n_iterations=ENCODER_ITER, **fit)
            rel = _rel(H, want)
            log(f'encoder {label}, h_init={h_init}: transform of {ENCODER_ITER} iterations '
                f'{wall:.3f} s wall (H to the host included); launches {launches}; H '
                f'{rel:.3e} off the plain versions; energy {enc._energy_function()!r}')
            expected = dict.fromkeys(KERNELS, 0)
            expected[kernel] = ENCODER_ITER
            if launches != expected:
                raise AssertionError(f'encoder {label}: launches {launches}, not {expected}')
            if not (np.isfinite(H).all() and rel <= TOL):
                raise AssertionError(f'encoder {label}, h_init={h_init}: H off the plain '
                                     f'versions by {rel:.3e} > {TOL}, or not finite')
            total[kernel] += launches[kernel]
            iterations[kernel] += ENCODER_ITER
            out[f'{label}_{h_init}_wall_s'] = wall
            if h_init == 'random':
                out[f'{label}_ms'] = _h_only_ms(enc, fit)
                log(f'encoder {label}: {out[label + "_ms"]:.4f} ms per H-only iteration')
            if (label, h_init) == ('plain', 'random'):
                chunked = encoder().transform(V, n_iterations=ENCODER_ITER, batch_size=16,
                                              **fit)
                rel = _rel(chunked, H)
                log(f'encoder plain: transform(batch_size=16) {rel:.3e} off the whole batch')
                if not rel <= CHUNK_TOL:
                    raise AssertionError(f'transform(batch_size=16): {rel:.3e} off the '
                                         f'whole batch > {CHUNK_TOL}')
            del enc
    out.update(_loop_costs(V))
    return total, iterations, out


def _loop_costs(V: np.ndarray) -> dict:
    """Full MU iterations at the flagship: the plain loop against
    ``record_energies`` (5 iterations) and against ``tol`` with one block of
    10, in turns (plain, variant, variant, plain)."""
    f = FLAGSHIP
    nmf = TransformInvariantNMF(f['M'], f['A'], seed=SEED, device=DEVICE)
    nmf.fit(V, n_iterations=0)
    common = (*_fit_kw(dict(sparsity_H=f['sparsity']))[0], nmf._kernels)

    def loop(n):
        return lambda: engine.fit_loop(nmf._Vp, nmf._W, nmf._H, n, *common, plan=nmf._plan)

    def energies(n):
        return lambda: engine.fit_loop_energies(nmf._Vp, nmf._Vd, nmf._W, nmf._H, *common,
                                                n_iterations=n, plan=nmf._plan)

    def tol(n):
        return lambda: engine.fit_loop_tol(nmf._Vp, nmf._Vd, nmf._W, nmf._H, n, 0., *common,
                                           check_every=10, plan=nmf._plan)
    out = {}
    for name, variant, n in (('record_energies', energies, 5), ('tol', tol, 10)):
        p1, v1, v2, p2 = (time_ms(fn, reps=1) / n
                          for fn in (loop(n), variant(n), variant(n), loop(n)))
        out[f'{name}_ms'], out[f'{name}_plain_ms'] = (v1 + v2) / 2, (p1 + p2) / 2
        log(f'flagship {name}: {v1:.4f}/{v2:.4f} ms per iteration against the plain loop '
            f'{p1:.4f}/{p2:.4f}, in turns ({n} iterations a window)')
    return out


def _same_or_close(what: str, a, b, tol: float = 1e-6) -> str:
    """``'bits'`` when the factors of ``a`` and ``b`` are identical, else
    ``'within <rel>'`` when they agree within ``tol``; raises otherwise."""
    if torch.equal(a._W, b._W) and torch.equal(a._H, b._H):
        return 'bits'
    rel = max(_rel(a.W, b.W), _rel(a.H, b.H))
    if not rel <= tol:
        raise AssertionError(f'{what}: W, H {rel:.3e} apart > {tol}')
    return f'within {rel:.3e}'


def phase_fit_loops():
    """The fit loops and checkpoints on the golden 2-D fixture in float32 on the card."""
    golden = json.loads((ROOT / 'tests' / 'golden_values.json').read_text())['2d']['valid']
    image = _image_2d()

    def model():
        """The golden fit's model: it draws from the global NumPy stream,
        seeded here, so fit it before making the next."""
        np.random.seed(42)
        return TransformInvariantNMF(n_atoms=10, atom_shape=(7, 7), device=DEVICE)
    nmf = model()
    nmf.fit(image, sparsity_H=0.1, n_iterations=10, record_energies=True)
    log(f'  record_energies trace: {nmf.energies_.tolist()}')
    if nmf.energies_.shape != (10,) or not np.isfinite(nmf.energies_).all():
        raise AssertionError(f'record_energies: trace {nmf.energies_}')
    _check_rel('record_energies last entry', float(nmf.energies_[-1]), golden)
    nmf = model()
    nmf.fit(image, n_iterations=10, record_energies=True)
    rises = np.diff(nmf.energies_)
    log(f'  record_energies without sparsity: largest step {rises.max():.4g}')
    if not np.all(rises <= 0):
        raise AssertionError(f'record_energies without sparsity rose: {nmf.energies_}')
    for fit in (dict(), dict(extrapolate=True)):
        nmf = model()
        nmf.fit(image, sparsity_H=0.1, n_iterations=200, tol=1e-3, tol_check_every=10,
                record_energies=True, **fit)
        e = nmf._energy_function()
        log(f'  tol=1e-3{" extrapolated" if fit else ""}: {nmf.n_iterations_} iterations, '
            f'energy {e!r}')
        if not (0 < nmf.n_iterations_ <= 200 and math.isfinite(e)
                and nmf.energies_.shape == (nmf.n_iterations_,)):
            raise AssertionError(f'tol fit {fit}: {nmf.n_iterations_} iterations, energy {e}')
    k = 4
    aborted = model()
    aborted.fit(image, sparsity_H=0.1, n_iterations=10, progress_callback=lambda m, i: i < k)
    plain = model()
    plain.fit(image, sparsity_H=0.1, n_iterations=k + 1)
    if aborted.n_iterations_ != k + 1:
        raise AssertionError(f'callback abort at {k}: {aborted.n_iterations_} iterations')
    log(f'  callback abort at iteration {k} against a fit of {k + 1}: '
        + _same_or_close('callback abort', aborted, plain))
    whole = model()
    whole.fit(image, sparsity_H=0.1, n_iterations=8)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / 'ckpt.npz')
        interrupted = model()
        interrupted.fit(image, sparsity_H=0.1, n_iterations=6, checkpoint_every=3,
                        checkpoint_path=path)
        resumed = TransformInvariantNMF.load(path, device=DEVICE)
    done = resumed.last_checkpoint_iteration_
    resumed.fit(image, sparsity_H=0.1, n_iterations=8 - done, keep_W=True, keep_H=True)
    log(f'  checkpoint_every=3 at {done} iterations, resumed to 8, against 8 uninterrupted: '
        + _same_or_close('checkpoint resume', resumed, whole))


# ------------------------------------------------ phase 12: fft and dot

#: the fft flagship: phase 5's problem on the fft strategy
FFT_ITER = 20
#: 'auto' above the direct-conv threshold (the JAX rule's crossover)
AUTO_FFT = dict(N=64, C=1, S=(128, 128), M=16, A=(31, 31), sparsity=0.1, n_iter=10)
#: the long 1-D fft problem of benchmarks/large_scale.py:205-207
LONG_1D = dict(N=16, C=1, S=(16000,), M=8, A=(64,), sparsity=0.1, inhibition=0.1, n_iter=10)
#: fft fits of 3 and 4 shift axes (rank 4: 'auto' routes it to fft): K1
#: takes every rank, so they run mu_ratio (or K4's plain version under the
#: rank gate) and mu_w; (label, sample shape, atom shape, inhibited, backend)
HIGH_RANK_FFT = [('3-D', (8, 1, 32, 32, 32), (5, 5, 5), False, 'jax_fft'),
                 ('rank-4', (4, 1, 12, 12, 12, 12), (3, 3, 3, 3), False, 'auto'),
                 ('rank-4 inhibited', (4, 1, 12, 12, 12, 12), (3, 3, 3, 3), True, 'auto')]
HIGH_RANK_ITER = 5
#: plain NMF at production scale (benchmarks/plain_nmf.py, BASELINE.md:59):
#: 'full' mode with atoms as large as the samples, the matmul strategy
DOT = dict(N=16384, C=1, S=(4096,), M=256, sparsity=0.1, n_iter=10)
#: storage-sharing tensors whose host copies ``no_host_copy`` refuses
_HOST_COPIES = ('numpy', 'cpu', 'tolist', '__array__')


@contextlib.contextmanager
def no_host_copy(*tensors, counted=()):
    """Inside the block ``numpy()``, ``cpu()``, ``tolist()`` and
    ``__array__`` of any tensor sharing memory with ``tensors`` raise; the
    same calls on a tensor sharing memory with ``counted`` go through and
    are recorded in the list the block receives."""
    ptrs = {t.untyped_storage().data_ptr() for t in tensors}
    counted_ptrs = {t.untyped_storage().data_ptr() for t in counted}
    copies = []
    saved = {name: getattr(torch.Tensor, name) for name in _HOST_COPIES}

    def guard(name, fn):
        def call(self, *args, **kwargs):
            ptr = self.untyped_storage().data_ptr()
            if ptr in ptrs:
                raise AssertionError(f'{name}() of the input data')
            if ptr in counted_ptrs:
                copies.append(name)
            return fn(self, *args, **kwargs)
        return call
    for name, fn in saved.items():
        setattr(torch.Tensor, name, guard(name, fn))
    try:
        yield copies
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def _strategy_fit(label, make, V, fit: dict, n_iter: int, kernels: tuple, strategy: str,
                  refs=('plain', 'float64')) -> tuple:
    """``make(dtype).fit(V, n_iter, **fit)`` on the kernels, counts reset
    before and read after: each of ``kernels`` launched exactly once per
    iteration and no other kernel.  W and H within 1e-4 of the same fit on
    the plain versions (``make(dtype, use_pallas=False)``) and of the float64 fit (the
    gate's plain versions) as ``refs`` ask.  Returns the float32 model, its
    launches, wall time and peak device memory (MiB)."""
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    nmf = make(torch.float32)
    nmf.fit(V, n_iterations=n_iter, **fit)
    sync()
    wall = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    expected = dict.fromkeys(KERNELS, 0)
    expected.update(dict.fromkeys(kernels, n_iter))
    if nmf._strategy != strategy or launches != expected:
        raise AssertionError(f'{label}: strategy {nmf._strategy}, launches {launches}, not '
                             f'{strategy} and {expected}')
    rel = {}
    if 'plain' in refs:
        ref = make(torch.float32, use_pallas=False)
        ref.fit(V, n_iterations=n_iter, **fit)
        rel['plain versions'] = max(_rel(nmf.W, ref.W), _rel(nmf.H, ref.H))
        del ref
    if 'float64' in refs:
        reset_counts()
        ref = make(torch.float64)
        ref.fit(V, n_iterations=n_iter, **fit)
        sync()
        if any(counts().values()):
            raise AssertionError(f'{label}: the float64 fit launched {counts()}')
        rel['float64'] = max(_rel(nmf.W, ref.W), _rel(nmf.H, ref.H))
        del ref
    e = nmf._energy_function()
    log(f'{label}: {n_iter} iterations, {wall:.2f} s wall incl. host init, peak {peak:.0f} MiB; '
        f'launches {launches}; W, H off: '
        + ', '.join(f'{k} {v:.3e}' for k, v in rel.items()) + f'; energy {e!r}')
    if not (math.isfinite(e) and all(v <= TOL for v in rel.values())):
        raise AssertionError(f'{label}: energy {e}, W and H off {rel} (> {TOL}?)')
    return nmf, launches, wall, peak


def _precision_flip(label, nmf, fit: dict):
    """One MU iteration from the model's state under the caller's matmul
    precision 'high' (TF32 allowed) has the bits of the same iteration under
    'highest': the fft and dot products pin full float32."""
    args, flags = _fit_kw(fit)

    def step():
        return engine.update_step(nmf._Vp, nmf._W, nmf._H, *args, nmf._kernels,
                                  plan=nmf._plan, strategy=nmf._strategy, **flags)
    want = step()
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('high')
    try:
        got = step()
    finally:
        torch.set_float32_matmul_precision(saved)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f'{label}: one iteration under set_float32_matmul_precision("high") '
        f'{"has the bits of" if same else "DIFFERS from"} "highest"')
    if not same:
        raise AssertionError(f'{label}: the products follow the caller\'s TF32 setting')


def _fft_parts(nmf) -> dict:
    """Per-call times of an fft flagship iteration's parts (CUDA events):
    the reconstruction, the gradient pairs and their pieces (a transform of
    H, its frequency-major copy, one H-gradient stream's product and
    inverse transform), and K1."""
    from tnmf_tpu_torch.ops import fft
    Vp, W, H, plan = nmf._Vp, nmf._W, nmf._H, nmf._plan
    R = fft.reconstruct(W, H, plan)
    neg, pos = (g.contiguous() for g in fft.grad_H_pair(Vp, R, W, plan))
    Hf = fft._rfftn(H, plan)
    Vfm, Wfm = fft._freq_major(Vp), fft._freq_major(fft._rfftn(W, plan))
    Gf = torch.matmul(Vfm, Wfm.mH)
    parts = {
        'reconstruct': lambda: fft.reconstruct(W, H, plan),
        'grad_H_pair + contiguous': lambda: [g.contiguous() for g in
                                             fft.grad_H_pair(Vp, R, W, plan)],
        'grad_W_pair': lambda: fft.grad_W_pair(Vp, R, H, plan),
        'mu_ratio': lambda: mu.mu_ratio(H, neg, pos, engine.EPS + 0.1),
        'rfftn(H)': lambda: fft._rfftn(H, plan),
        # the layout the forward transforms do not use: the batch innermost
        'rfftn(H), batch innermost': lambda: torch.fft.rfftn(
            H.movedim((0, 1), (-2, -1)), s=plan.fft_shape, dim=tuple(range(plan.ndim))),
        'frequency-major copy of F(H)': lambda: fft._freq_major(Hf),
        'H-gradient product (one stream)': lambda: torch.matmul(Vfm, Wfm.mH),
        'its inverse + crop + contiguous': lambda: fft._inverse(
            Gf, (0,) * plan.ndim, plan.transform_shape, plan).contiguous(),
    }
    with matmul_pin(None, DEVICE):
        out = {name: time_ms(fn, reps=3) for name, fn in parts.items()}
    log('  fft flagship parts (ms per call): '
        + ', '.join(f'{k} {v:.4f}' for k, v in out.items()))
    return out


def _fft_golden() -> None:
    """The golden '2d' energies through the 'numpy_fft' backend, float32 on
    the kernels (rtol 1e-4) and float64 on the plain versions (rtol 1e-8)."""
    goldens = json.loads((ROOT / 'tests' / 'golden_values.json').read_text())['2d']
    image = _image_2d()
    for dtype, rtol in ((torch.float32, GOLDEN_RTOL), (torch.float64, F64_GOLDEN_RTOL)):
        for mode, golden in goldens.items():
            np.random.seed(42)
            nmf = TransformInvariantNMF(10, (7, 7), backend='numpy_fft', reconstruction_mode=mode,
                                        dtype=dtype, device=DEVICE)
            reset_counts()
            nmf.fit(image, sparsity_H=0.1, n_iterations=10)
            launches = counts()
            e = nmf._energy_function()
            rel = abs(e - golden) / abs(golden)
            log(f'  golden 2d/{mode} on fft, {str(dtype)[6:]}: energy {e!r} vs {golden!r} '
                f'(rel {rel:.3e}); launches {launches}')
            want = 0 if dtype == torch.float64 else 10
            if not (nmf._strategy == 'fft' and rel <= rtol and launches['mu_ratio'] == want
                    and launches['mu_w'] == want):
                raise AssertionError(f'golden 2d/{mode} on fft ({dtype}): rel {rel:.3e} > {rtol}'
                                     f' or launches {launches}')


def _f5() -> None:
    """Fault F5 on the card: the golden 2-D fit (conv and fft), a
    ``transform``, ``set_dictionary`` and ``inverse_transform`` take CUDA
    tensors, with no host copy of the data, and give the bits of the same
    calls on NumPy arrays."""
    image = _image_2d()
    for backend in ('auto', 'numpy_fft'):
        def golden(data):
            np.random.seed(42)
            m = TransformInvariantNMF(10, (7, 7), backend=backend, device=DEVICE)
            m.fit(data, sparsity_H=0.1, n_iterations=10)
            return m
        want = golden(image)
        Vt = torch.tensor(image, device=DEVICE)
        with no_host_copy(Vt):
            got = golden(Vt)
        same = torch.equal(got._W, want._W) and torch.equal(got._H, want._H)
        log(f'  F5 golden 2-D fit ({got._strategy}) from a CUDA tensor: '
            f'{"the bits" if same else "DIFFERS from"} of the NumPy fit')
        if not same:
            raise AssertionError(f'F5: the golden fit from a CUDA tensor ({backend}) differs')
    W = want.W
    new = np.random.default_rng(SEED + 3).random(image.shape)
    out = []
    H = None
    for kind in ('array', 'tensor'):
        enc = TransformInvariantNMF(10, (7, 7), seed=SEED, device=DEVICE)
        if kind == 'array':
            enc.set_dictionary(W)
            H = enc.transform(new, n_iterations=10, sparsity_H=0.1)
            out.append((enc.W, H, enc.inverse_transform(H)))
            continue
        # set_dictionary normalises on the host, as the JAX package does:
        # the dictionary alone is copied there, once; the data never
        data, Wt, Ht = (torch.tensor(x, device=DEVICE) for x in (new, W, H))
        with no_host_copy(data, Ht, counted=(Wt,)) as copies:
            enc.set_dictionary(Wt)
            H_t = enc.transform(data, n_iterations=10, sparsity_H=0.1)
            R_t = enc.inverse_transform(Ht)
        out.append((enc.W, H_t, R_t))
    same = all(np.array_equal(a, b) for a, b in zip(*out))
    log(f'  F5 set_dictionary, transform and inverse_transform of CUDA tensors: '
        f'{"the bits" if same else "DIFFER from"} of the NumPy calls; host copies of the '
        f'dictionary {copies}, of the data none')
    if not same:
        raise AssertionError('F5: the encoder on CUDA tensors differs from NumPy input')
    # cpu() copies it from the card; numpy() of a CPU tensor is a view
    if copies.count('cpu') != 1 or not set(copies) <= {'cpu', 'numpy'}:
        raise AssertionError(f'F5: set_dictionary read the dictionary on the host as {copies}')


def phase_strategies() -> tuple:
    """The fft and dot strategies at full width through ``fit``; returns the
    launches and iterations per kernel, and the times."""
    total = dict.fromkeys(KERNELS, 0)
    iterations = dict.fromkeys(KERNELS, 0)
    out = {}

    def tally(launches, kernels, n):
        for name, k in launches.items():
            total[name] += k
        for name in kernels:
            iterations[name] += n

    f = FLAGSHIP
    V = np.random.default_rng(SEED).random((f['N'], f['C']) + f['S'], dtype=np.float32)
    plain_fit = dict(sparsity_H=f['sparsity'])
    inhibited_fit = dict(sparsity_H=f['sparsity'], inhibition_strength=f['inhibition'])

    def fft_model(dtype, **kw):
        return TransformInvariantNMF(f['M'], f['A'], backend='jax_fft', dtype=dtype, seed=SEED,
                                     device=DEVICE, **kw)
    models = {}
    for label, fit, kernels in (('plain', plain_fit, ('mu_ratio', 'mu_w')),
                                ('inhibited', inhibited_fit, ('inhibited_mu_h', 'mu_w'))):
        nmf, launches, wall, peak = _strategy_fit(f'fft flagship {label}', fft_model, V, fit,
                                                  FFT_ITER, kernels, 'fft')
        tally(launches, kernels, FFT_ITER)
        out[f'fft_flagship_{label}_peak_mib'] = peak
        models[label] = nmf
    log(f'  fft flagship plan: fft_shape {models["plain"]._plan.fft_shape}')
    _precision_flip('fft flagship', models['plain'], plain_fit)
    # the conv flagship and the fft flagship in turns (conv, fft, fft, conv)
    conv = TransformInvariantNMF(f['M'], f['A'], seed=SEED, device=DEVICE)
    conv.fit(V, n_iterations=0)
    c1, f1, f2, c2 = (_ms_per_iteration(m, plain_fit)
                      for m in (conv, models['plain'], models['plain'], conv))
    out.update(fft_flagship_ms=(f1 + f2) / 2, conv_flagship_ms=(c1 + c2) / 2)
    log(f'flagship in turns: conv {c1:.4f}/{c2:.4f} ms/iteration, fft {f1:.4f}/{f2:.4f}')
    del conv
    out['fft_flagship_inhibited_ms'] = _ms_per_iteration(models['inhibited'], inhibited_fit)
    log(f'fft flagship inhibited: {out["fft_flagship_inhibited_ms"]:.4f} ms/iteration')
    out['fft_parts'] = _fft_parts(models['plain'])
    del models, V

    a = AUTO_FFT
    V = np.random.default_rng(SEED).random((a['N'], a['C']) + a['S'], dtype=np.float32)
    fit = dict(sparsity_H=a['sparsity'])
    nmf, launches, _, _ = _strategy_fit(
        "auto 64x1x128x128/16x31x31", lambda dtype, **kw: TransformInvariantNMF(
            a['M'], a['A'], dtype=dtype, seed=SEED, device=DEVICE, **kw),
        V, fit, a['n_iter'], ('mu_ratio', 'mu_w'), 'fft', refs=('plain',))
    tally(launches, ('mu_ratio', 'mu_w'), a['n_iter'])
    out['auto_fft_ms'] = _ms_per_iteration(nmf, fit)
    log(f'auto -> fft: {out["auto_fft_ms"]:.4f} ms/iteration')
    del nmf, V

    g = LONG_1D
    V = np.random.default_rng(SEED).random((g['N'], g['C']) + g['S'], dtype=np.float32)
    for label, fit, kernels in (
            ('plain', dict(sparsity_H=g['sparsity']), ('mu_ratio', 'mu_w')),
            ('inhibited', dict(sparsity_H=g['sparsity'], inhibition_strength=g['inhibition']),
             ('inhibited_mu_h', 'mu_w'))):
        nmf, launches, _, _ = _strategy_fit(
            f'long 1-D fft 16x1x16000/8x64 {label}', lambda dtype, **kw: TransformInvariantNMF(
                g['M'], g['A'], backend='jax_fft', dtype=dtype, seed=SEED, device=DEVICE, **kw),
            V, fit, g['n_iter'], kernels, 'fft')
        tally(launches, kernels, g['n_iter'])
        out[f'long_1d_fft_{label}_ms'] = _ms_per_iteration(nmf, fit)
        log(f'long 1-D fft {label}: {out[f"long_1d_fft_{label}_ms"]:.4f} ms/iteration')
        del nmf
    del V

    for label, shape, A, inhibited, backend in HIGH_RANK_FFT:
        V = np.random.default_rng(SEED).random(shape, dtype=np.float32)
        fit = dict(sparsity_H=0.1, inhibition_strength=0.1 if inhibited else 0.)
        kernels = ('mu_w',) if inhibited else ('mu_ratio', 'mu_w')
        _, launches, _, _ = _strategy_fit(
            f'{label} fft {"x".join(map(str, shape))}/4x{"x".join(map(str, A))}',
            lambda dtype, **kw: TransformInvariantNMF(4, A, backend=backend, dtype=dtype,
                                                      seed=SEED, device=DEVICE, **kw),
            V, fit, HIGH_RANK_ITER, kernels, 'fft')
        tally(launches, kernels, HIGH_RANK_ITER)
        del V

    d = DOT
    V = np.random.default_rng(SEED).random((d['N'], d['C']) + d['S'], dtype=np.float32)
    fit = dict(sparsity_H=d['sparsity'])
    nmf, launches, _, _ = _strategy_fit(
        'dot 16384x1x4096/256', lambda dtype, **kw: TransformInvariantNMF(
            d['M'], d['S'], reconstruction_mode='full', dtype=dtype, seed=SEED, device=DEVICE,
            **kw),
        V, fit, d['n_iter'], ('mu_ratio', 'mu_w'), 'dot')
    tally(launches, ('mu_ratio', 'mu_w'), d['n_iter'])
    _precision_flip('dot', nmf, fit)
    out['dot_ms'] = _ms_per_iteration(nmf, fit)
    # per iteration: two reconstructions, the H pair (V and R stacked) and
    # the W pair, each 2*N*M*C*prod(S) multiply-adds or twice that
    flops = 12 * d['N'] * d['M'] * d['C'] * math.prod(d['S'])
    out['dot_bound_ms'] = bound(0, flops, FP32_FLOP_PER_S)[0]
    log(f'dot: {out["dot_ms"]:.4f} ms/iteration; {flops / 1e9:.1f} GFLOP at the FP32 peak '
        f'{out["dot_bound_ms"]:.4f} ms ({100 * out["dot_bound_ms"] / out["dot_ms"]:.1f} %)')
    del nmf, V

    log('golden fits on the fft strategy:')
    _fft_golden()
    log('data already on the card (F5):')
    _f5()
    return total, iterations, out


# ------------------------------------------ phase 13: minibatch and streaming

#: the at-scale minibatch configuration (BASELINE.md:54): the flagship in
#: batches of 16, four per epoch
MB_BATCH = 16
#: epochs of each timed minibatch fit: one warm-up, then the timed ones
MB_EPOCHS = 4
#: Cyclic_MU against fit_batch, and per-batch K2 sums against the whole batch's
MB_CYCLIC_TOL = 1e-5
#: launches per epoch of K3 (K4 when inhibited), K2 and mu_w with ``nb``
#: batches: every algorithm updates H per batch; W statistics and updates
#: per batch, or once per epoch
MB_PER_EPOCH = {
    'Cyclic_MU': lambda nb: dict(h=nb, grad_w=nb, mu_w=1),
    'ASG_MU': lambda nb: dict(h=nb, grad_w=nb, mu_w=nb),
    'GSG_MU': lambda nb: dict(h=nb, grad_w=1, mu_w=1),
    'ASAG_MU': lambda nb: dict(h=nb, grad_w=nb, mu_w=nb),
    'GSAG_MU': lambda nb: dict(h=nb, grad_w=1, mu_w=1),
}


def _patches_2d(n: int = 64, size: int = 32) -> np.ndarray:
    """The golden minibatch patches, cut as tests/fixtures.py cuts them."""
    img = synthetic_face(gray=True)
    rows, cols = img.shape[0] // size, img.shape[1] // size
    blocks = (img[:rows * size, :cols * size].reshape(rows, size, cols, size)
              .transpose(0, 2, 1, 3).reshape(-1, 1, size, size))
    return np.ascontiguousarray(blocks[:n])


def _timed_minibatch_fit(V, algorithm, fit: dict, use_pallas=None, **init) -> tuple:
    """``fit_minibatches`` at the flagship in batches of ``MB_BATCH`` for
    ``MB_EPOCHS`` epochs, counts reset before and read after; a callback
    records a CUDA event after each epoch (no synchronisation).  ``init``
    goes to the constructor.  Returns the model, its launches and the
    device ms per epoch after the first."""
    f = FLAGSHIP
    nmf = TransformInvariantNMF(f['M'], f['A'], seed=SEED, device=DEVICE, use_pallas=use_pallas,
                                **init)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(MB_EPOCHS)]
    sync()
    reset_counts()
    nmf.fit_minibatches(V, algorithm=algorithm, batch_size=MB_BATCH, n_epochs=MB_EPOCHS,
                        progress_callback=lambda m, e: events[e].record() or True, **fit)
    sync()
    launches = counts()
    return nmf, launches, events[0].elapsed_time(events[-1]) / (MB_EPOCHS - 1)


def _minibatch_flagship() -> tuple:
    """The five algorithms (and ASG_MU inhibited) at the flagship on the
    kernels and with ``use_pallas=False``; returns the launches and, per
    algorithm, ms per epoch and the launches per epoch."""
    f = FLAGSHIP
    V = np.random.default_rng(SEED).random((f['N'], f['C']) + f['S'], dtype=np.float32)
    nb = -(-f['N'] // MB_BATCH)
    total = dict.fromkeys(KERNELS, 0)
    out = {}
    cases = [(a.name, a, dict(sparsity_H=f['sparsity']), 'mu_h') for a in MiniBatchAlgorithm]
    cases.append(('ASG_MU inhibited', MiniBatchAlgorithm.ASG_MU,
                  dict(sparsity_H=f['sparsity'], inhibition_strength=f['inhibition']),
                  'inhibited_mu_h'))
    for label, algorithm, fit, h_kernel in cases:
        nmf, launches, ms = _timed_minibatch_fit(V, algorithm, fit)
        plain, plain_launches, plain_ms = _timed_minibatch_fit(V, algorithm, fit,
                                                               use_pallas=False)
        per_epoch = MB_PER_EPOCH[algorithm.name](nb)
        expected = dict.fromkeys(KERNELS, 0)
        expected.update({h_kernel: per_epoch['h'] * MB_EPOCHS,
                         'grad_w': per_epoch['grad_w'] * MB_EPOCHS,
                         'mu_w': per_epoch['mu_w'] * MB_EPOCHS})
        rel = max(_rel(nmf.W, plain.W), _rel(nmf.H, plain.H))
        e = nmf._energy_function()
        log(f'minibatch {label}, bs={MB_BATCH} ({nb} batches): {ms:.4f} ms/epoch on the '
            f'kernels, {plain_ms:.4f} with use_pallas=False; launches per epoch '
            + ', '.join(f'{k} {v / MB_EPOCHS:g}' for k, v in launches.items() if v)
            + f' (expected {per_epoch}); W, H {rel:.3e} off use_pallas=False; energy {e!r}')
        if launches != expected or any(plain_launches.values()):
            raise AssertionError(f'minibatch {label}: launches {launches} (use_pallas=False: '
                                 f'{plain_launches}), not {expected}')
        if not (math.isfinite(e) and rel <= TOL):
            raise AssertionError(f'minibatch {label}: energy {e}, W and H {rel:.3e} off the '
                                 f'plain versions > {TOL}?')
        for name, n in launches.items():
            total[name] += n
        out[label] = dict(ms=ms, plain_ms=plain_ms,
                          launches_per_epoch={k: v / MB_EPOCHS for k, v in launches.items()})
        del nmf, plain
    cyclic = TransformInvariantNMF(f['M'], f['A'], seed=SEED, device=DEVICE)
    cyclic.fit_minibatches(V, algorithm=MiniBatchAlgorithm.Cyclic_MU, batch_size=MB_BATCH,
                           n_epochs=3, sparsity_H=f['sparsity'])
    full = TransformInvariantNMF(f['M'], f['A'], seed=SEED, device=DEVICE)
    full.fit_batch(V, n_iterations=3, sparsity_H=f['sparsity'])
    rel = max(_rel(cyclic.W, full.W), _rel(cyclic.H, full.H))
    log(f'minibatch Cyclic_MU (3 epochs, bs={MB_BATCH}) against fit_batch(n_iterations=3): '
        f'W, H {rel:.3e} apart')
    if not rel <= MB_CYCLIC_TOL:
        raise AssertionError(f'Cyclic_MU off fit_batch by {rel:.3e} > {MB_CYCLIC_TOL}')
    return total, out


def _minibatch_goldens() -> None:
    """The golden ``minibatch`` and ``stream`` energies in float32 on the
    conv and fft strategies (tests/test_minibatch.py, tests/test_stream.py)."""
    goldens = json.loads((ROOT / 'tests' / 'golden_values.json').read_text())
    V = _patches_2d()
    stream = _patches_2d(32)
    for backend in ('jax_conv', 'jax_fft'):
        for key, golden in goldens['minibatch'].items():
            np.random.seed(42)
            nmf = TransformInvariantNMF(10, (7, 7), backend=backend, device=DEVICE)
            if key == 'full_batch':
                nmf.fit_batch(V, sparsity_H=0.1, n_iterations=3)
            else:
                nmf.fit_minibatches(V, sparsity_H=0.1, algorithm=MiniBatchAlgorithm[key],
                                    batch_size=5, n_epochs=3, sag_lambda=0.8)
            _check_rel(f'minibatch/{key} on {nmf._strategy}', nmf._energy_function(), golden)
        for key, golden in goldens['stream'].items():
            np.random.seed(42)
            nmf = TransformInvariantNMF(10, (7, 7), backend=backend, device=DEVICE)
            limited = key == 'limited'
            nmf.fit(stream, sparsity_H=0.1, subsample_size=16, batch_size=3, n_epochs=3,
                    sag_lambda=0.8, algorithm=MiniBatchAlgorithm['Cyclic_MU' if limited
                                                                 else 'ASAG_MU'],
                    **(dict(max_subsamples=1) if limited else {}))
            _check_rel(f'stream/{key} on {nmf._strategy}', nmf._energy_function(), golden)


def _online() -> dict:
    """Four ``partial_fit`` steps of ``MB_BATCH`` flagship samples (the first
    with ``sag_lambda=1`` against ``fit_batch(n_iterations=1)``, bits), and
    ``fit_stream`` over a generator of CUDA tensors with no host copy of
    them, bit-equal to the stream of NumPy rows."""
    f = FLAGSHIP
    V = np.random.default_rng(SEED + 2).random((4 * MB_BATCH, f['C']) + f['S'],
                                               dtype=np.float32)
    steps = [V[i * MB_BATCH:(i + 1) * MB_BATCH] for i in range(4)]
    online = TransformInvariantNMF(f['M'], f['A'], seed=SEED, device=DEVICE)
    sync()
    wall = []
    for i, Vb in enumerate(steps):
        t0 = time.perf_counter()
        online.partial_fit(Vb, sag_lambda=1.0 if i == 0 else 0.2, sparsity_H=f['sparsity'])
        sync()
        wall.append(1e3 * (time.perf_counter() - t0))
        if i == 0:
            once = TransformInvariantNMF(f['M'], f['A'], seed=SEED, device=DEVICE)
            once.fit_batch(Vb, n_iterations=1, sparsity_H=f['sparsity'])
            same = torch.equal(online._W, once._W) and torch.equal(online._H, once._H)
            log(f'  partial_fit step 1 (sag_lambda=1): {"the bits" if same else "DIFFERS from"}'
                ' of fit_batch(n_iterations=1)')
            if not same:
                raise AssertionError('partial_fit(sag_lambda=1) differs from one fit_batch '
                                     'iteration')
            del once
    e = online._energy_function()
    log(f'  partial_fit: {online.n_steps_} steps of {MB_BATCH} samples, wall ms per step '
        + '/'.join(f'{t:.1f}' for t in wall) + f' (host draw of H included); energy {e!r}')
    if online.n_steps_ != 4 or not math.isfinite(e):
        raise AssertionError(f'partial_fit: {online.n_steps_} steps, energy {e}')
    # the device time of one step without its host draw of H: the H update,
    # the W statistics and the averaged W update on the last step's state
    Vb = online._Vp

    def step():
        H = engine.update_H_step(Vb, online._W, online._H, f['sparsity'], plan=online._plan)
        neg, pos = engine.grad_W_stats(Vb, online._W, H, plan=online._plan)
        acc = engine.accumulate_gradient(*online._sag_stat_, neg, pos, 0.2)
        return engine.apply_W_update(online._W, *acc, n_shift_axes=online._plan.ndim)
    device_ms = time_ms(step, reps=5)
    log(f'  partial_fit step on the card (no host draw): {device_ms:.4f} ms')
    del online

    def streamed(data):
        np.random.seed(SEED)
        m = TransformInvariantNMF(f['M'], f['A'], device=DEVICE)
        m.fit(data, subsample_size=2 * MB_BATCH, batch_size=MB_BATCH, n_epochs=1,
              algorithm=MiniBatchAlgorithm.ASG_MU, sparsity_H=f['sparsity'])
        return m
    want = streamed(iter(V))
    Vt = torch.tensor(V, device=DEVICE)
    with no_host_copy(Vt):
        got = streamed(Vt[i] for i in range(Vt.shape[0]))
    same = torch.equal(got._W, want._W) and torch.equal(got._H, want._H)
    log(f'  fit_stream over a generator of CUDA tensors: {"the bits" if same else "DIFFERS from"}'
        ' of the stream of NumPy rows, no host copy of the data')
    if not same:
        raise AssertionError('fit_stream over CUDA tensors differs from the NumPy stream')
    return dict(partial_fit_wall_ms=wall, partial_fit_device_ms=device_ms)


def phase_minibatch() -> tuple:
    """Phase 13: the minibatch and streaming drivers; returns the launches
    and the times."""
    total, out = _minibatch_flagship()
    log('golden minibatch and stream energies in float32:')
    _minibatch_goldens()
    log('online and streaming fits at the flagship:')
    out.update(_online())
    return total, out


# ------------------------------------------------ phase 14: the objectives

#: iterations of each objective fit held against its plain versions, and of
#: its timed window (after a warm-up window as long)
OBJ_ITER = 3
OBJ_TIMED = 10
#: the share of missing entries of the masked cases (a seeded Bernoulli draw)
OBJ_MISSING = 0.1
#: the kernels of one iteration: conv (K4 in place of K3 when inhibited),
#: and fft or dot
OBJ_CONV = ('mu_h', 'grad_w', 'mu_w')
OBJ_CONV_INHIBITED = ('inhibited_mu_h', 'grad_w', 'mu_w')
OBJ_FFT_DOT = ('mu_ratio', 'mu_w')


def _objective_cases(V: np.ndarray, rng) -> list:
    """``(label, constructor keywords, fit keywords)`` of each objective on
    data ``V``: KL plain and inhibited, beta = 0.5, 10 % of the entries
    missing plain and inhibited, a weight mask broadcast over the samples
    and channels, ``l2_H`` with ``ortho_W``; the default objective first."""
    missing = (rng.random(V.shape, dtype=np.float32) >= OBJ_MISSING).astype(np.float32)
    weights = rng.uniform(0.5, 1.5, (1, 1) + V.shape[2:]).astype(np.float32)
    inh = dict(inhibition_strength=FLAGSHIP['inhibition'])
    return [('beta=2 (default)', {}, {}),
            ('KL (beta=1)', dict(beta_loss=1.0), {}),
            ('KL inhibited', dict(beta_loss=1.0), inh),
            ('beta=0.5', dict(beta_loss=0.5), {}),
            ('10% missing', {}, dict(mask=missing)),
            ('10% missing inhibited', {}, dict(mask=missing, **inh)),
            ('broadcast weights', {}, dict(mask=weights)),
            ('l2_H + ortho_W', {}, dict(l2_H=0.1, ortho_W=0.1))]


def _objective_ms(nmf, fit: dict, n: int = OBJ_TIMED) -> float:
    """ms per MU iteration of the model's objective on its state (CUDA
    events around ``engine.fit_loop``, after a warm-up of as many)."""
    inh = fit.get('inhibition_strength', 0.)
    cross = fit.get('cross_atom_inhibition_strength', 0.)
    regs = nmf._regs(fit.get('sparsity_H', 0.), inh, cross)
    flags = dict(nmf._flags(inh, cross),
                 **nmf._objective(fit.get('l2_H', 0.), fit.get('ortho_W', 0.)))

    def run():
        nmf._W, nmf._H = engine.fit_loop(nmf._Vp, nmf._W, nmf._H, n, *regs, **flags)
    return time_ms(run, reps=1) / n


def _objective_parts(nmf) -> dict:
    """Per-call times (CUDA events) of a conv iteration's parts under the
    model's objective: the reconstruction, the two prepared streams (the
    extension, and the factor pass at beta != 2), K3, the stacked ``X2`` and
    K2, and ``mu_w``."""
    Vp, W, H, plan, mask, b = nmf._Vp, nmf._W, nmf._H, nmf._plan, nmf._mask_d, nmf._beta
    R = conv.reconstruct(W, H, plan)
    Xv, Xr = engine._conv_streams(Vp, R, plan, b, mask)
    X2 = torch.cat([Xv, Xr], dim=1)
    neg, pos = gw.grad_w(X2, H)
    parts = {'reconstruct': lambda: conv.reconstruct(W, H, plan),
             'streams': lambda: engine._conv_streams(Vp, R, plan, b, mask),
             'mu_h': lambda: mu_h.mu_h(Xv, Xr, W, H, engine.EPS + FLAGSHIP['sparsity']),
             'cat X2': lambda: torch.cat([Xv, Xr], dim=1),
             'grad_w': lambda: gw.grad_w(X2, H),
             'mu_w': lambda: mu.mu_w(W, neg, pos, engine.EPS, plan.ndim)}
    return {k: time_ms(fn, reps=5) for k, fn in parts.items()}


def _objective_flagship(total: dict) -> dict:
    """Each objective at the conv flagship: ``_strategy_fit`` (launches per
    iteration, W and H against ``use_pallas=False``), then ms/iteration;
    the time of each part of a KL and of a masked iteration."""
    f = FLAGSHIP
    rng = np.random.default_rng(SEED + 14)
    V = rng.random((f['N'], f['C']) + f['S'], dtype=np.float32)
    out = {}
    for label, init, fit in _objective_cases(V, rng):
        fit = dict(sparsity_H=f['sparsity'], **fit)

        def make(dtype, **kw):
            return TransformInvariantNMF(f['M'], f['A'], dtype=dtype, seed=SEED, device=DEVICE,
                                         **init, **kw)
        kernels = OBJ_CONV_INHIBITED if 'inhibition_strength' in fit else OBJ_CONV
        nmf, launches, _, peak = _strategy_fit(f'objective {label}', make, V, fit, OBJ_ITER,
                                               kernels, 'conv', refs=('plain',))
        for name, n in launches.items():
            total[name] += n
        ms = _objective_ms(nmf, fit)
        log(f'objective {label}: {ms:.4f} ms/iteration; launches per iteration '
            + ', '.join(f'{k} {v / OBJ_ITER:g}' for k, v in launches.items() if v)
            + f'; peak {peak:.0f} MiB')
        out[label] = dict(ms=ms, peak_mib=peak)
        if label in ('KL (beta=1)', '10% missing'):
            out[label]['parts'] = _objective_parts(nmf)
            log(f'  {label} parts (ms per call): ' + json.dumps(out[label]['parts']))
        if label == 'KL (beta=1)':
            out['kl_W'] = nmf.W
        del nmf
    return out


def _objective_strategies(total: dict, kl_W: np.ndarray) -> dict:
    """The fft flagship with KL and with 10 % missing; plain NMF on dot
    (KL-NMF); minibatch ASG_MU at bs = 16 with the mask and KL; and
    ``transform(batch_size=16)`` of new data with a per-sample mask against
    the KL dictionary, each against ``use_pallas=False``."""
    f = FLAGSHIP
    rng = np.random.default_rng(SEED + 15)
    V = rng.random((f['N'], f['C']) + f['S'], dtype=np.float32)
    missing = (rng.random(V.shape, dtype=np.float32) >= OBJ_MISSING).astype(np.float32)
    out = {}
    for label, init, fit in (('fft KL', dict(beta_loss=1.0), {}),
                             ('fft 10% missing', {}, dict(mask=missing))):
        fit = dict(sparsity_H=f['sparsity'], **fit)

        def fft_model(dtype, **kw):
            return TransformInvariantNMF(f['M'], f['A'], backend='jax_fft', dtype=dtype,
                                         seed=SEED, device=DEVICE, **init, **kw)
        nmf, launches, _, _ = _strategy_fit(f'objective {label}', fft_model, V, fit, OBJ_ITER,
                                            OBJ_FFT_DOT, 'fft', refs=('plain',))
        for name, n in launches.items():
            total[name] += n
        out[label] = dict(ms=_objective_ms(nmf, fit))
        log(f'objective {label}: {out[label]["ms"]:.4f} ms/iteration')
        del nmf

    d = DOT
    Vd = np.random.default_rng(SEED + 16).random((d['N'], d['C']) + d['S'], dtype=np.float32)

    def dot_model(dtype, **kw):
        return TransformInvariantNMF(d['M'], d['S'], reconstruction_mode='full', dtype=dtype,
                                     seed=SEED, device=DEVICE, beta_loss=1.0, **kw)
    fit = dict(sparsity_H=d['sparsity'])
    nmf, launches, _, _ = _strategy_fit('objective dot KL-NMF', dot_model, Vd, fit, OBJ_ITER,
                                        OBJ_FFT_DOT, 'dot', refs=('plain',))
    for name, n in launches.items():
        total[name] += n
    out['dot KL-NMF'] = dict(ms=_objective_ms(nmf, fit))
    log(f'objective dot KL-NMF: {out["dot KL-NMF"]["ms"]:.4f} ms/iteration')
    del nmf, Vd

    fit = dict(sparsity_H=f['sparsity'], mask=missing)
    nmf, launches, ms = _timed_minibatch_fit(V, MiniBatchAlgorithm.ASG_MU, fit, beta_loss=1.0)
    plain, plain_launches, _ = _timed_minibatch_fit(V, MiniBatchAlgorithm.ASG_MU, fit,
                                                    use_pallas=False, beta_loss=1.0)
    nb = -(-f['N'] // MB_BATCH)
    expected = dict.fromkeys(KERNELS, 0)
    expected.update(dict.fromkeys(OBJ_CONV, nb * MB_EPOCHS))
    rel = max(_rel(nmf.W, plain.W), _rel(nmf.H, plain.H))
    e = nmf._energy_function()
    log(f'objective minibatch ASG_MU KL 10% missing, bs={MB_BATCH}: {ms:.4f} ms/epoch; '
        f'launches {launches}; W, H {rel:.3e} off use_pallas=False; energy {e!r}')
    if launches != expected or any(plain_launches.values()):
        raise AssertionError(f'objective minibatch: launches {launches} (use_pallas=False: '
                             f'{plain_launches}), not {expected}')
    if not (math.isfinite(e) and rel <= TOL):
        raise AssertionError(f'objective minibatch: energy {e}, W and H {rel:.3e} off > {TOL}?')
    for name, n in launches.items():
        total[name] += n
    out['minibatch ASG_MU KL missing'] = dict(ms_per_epoch=ms)
    del nmf, plain

    Vn = np.random.default_rng(SEED + 17).random(V.shape, dtype=np.float32)

    def encode(use_pallas=None):
        enc = TransformInvariantNMF(f['M'], f['A'], beta_loss=1.0, h_init='correlate',
                                    device=DEVICE, use_pallas=use_pallas).set_dictionary(kl_W)
        return enc.transform(Vn, n_iterations=OBJ_ITER, batch_size=MB_BATCH, mask=missing,
                             sparsity_H=f['sparsity'])
    reset_counts()
    H = encode()
    sync()
    launches = counts()
    rel = _rel(H, encode(use_pallas=False))
    expected = dict.fromkeys(KERNELS, 0)
    expected['mu_h'] = nb * OBJ_ITER
    log(f'objective transform KL, per-sample mask, batch_size={MB_BATCH}: launches '
        f'{launches}; H {rel:.3e} off use_pallas=False')
    if launches != expected or not (np.isfinite(H).all() and rel <= TOL):
        raise AssertionError(f'objective transform: launches {launches} (not {expected}) or '
                             f'H {rel:.3e} off > {TOL}')
    for name, n in launches.items():
        total[name] += n
    return out


def _objective_goldens() -> None:
    """At the golden 2-D fixture, every objective on the kernels in float32
    against ``use_pallas=False`` and against float64 on the card (the
    gate's plain versions): the conv cases, Itakura-Saito on ``V + 0.01``,
    fft with KL and with the mask, plain NMF with KL, minibatch ASG_MU
    (bs = 1) and ``transform(batch_size=1)`` with the mask and KL."""
    image = _image_2d().astype(np.float32)
    rng = np.random.default_rng(SEED + 18)
    cases = [(label, init, fit, 'jax_conv') for label, init, fit in _objective_cases(image, rng)]
    missing = cases[4][2]['mask']
    cases += [('Itakura-Saito', dict(beta_loss=0.0), {}, 'jax_conv'),
              ('fft KL', dict(beta_loss=1.0), {}, 'jax_fft'),
              ('fft 10% missing', {}, dict(mask=missing), 'jax_fft')]
    for label, init, fit, backend in cases:
        fit = dict(sparsity_H=0.1, **fit)
        V = image + np.float32(0.01) if init.get('beta_loss') == 0.0 else image

        def make(dtype, **kw):
            return TransformInvariantNMF(10, (7, 7), backend=backend, dtype=dtype, seed=SEED,
                                         device=DEVICE, **init, **kw)
        strategy = backend.removeprefix('jax_')
        kernels = (OBJ_FFT_DOT if strategy == 'fft' else
                   OBJ_CONV_INHIBITED if 'inhibition_strength' in fit else OBJ_CONV)
        _strategy_fit(f'golden objective {label} ({strategy})', make, V, fit, OBJ_ITER,
                      kernels, strategy)

    def dot_model(dtype, **kw):
        return TransformInvariantNMF(10, image.shape[2:], reconstruction_mode='full',
                                     dtype=dtype, seed=SEED, device=DEVICE, beta_loss=1.0, **kw)
    _strategy_fit('golden objective KL-NMF (dot)', dot_model, image, dict(sparsity_H=0.1),
                  OBJ_ITER, OBJ_FFT_DOT, 'dot')

    def pair(run):
        """``run(model)`` in float32 on the kernels and in float64."""
        got, want = (run(TransformInvariantNMF(10, (7, 7), dtype=dtype, seed=SEED, device=DEVICE,
                                               beta_loss=1.0, h_init='correlate'))
                     for dtype in (torch.float32, torch.float64))
        return max(_rel(g, w) for g, w in zip(got, want))

    def minibatch(m):
        m.fit_minibatches(image, batch_size=1, n_epochs=OBJ_ITER, sparsity_H=0.1, mask=missing)
        return m.W, m.H

    W0 = np.random.default_rng(SEED + 19).random((10, 3, 7, 7))

    def encode(m):
        m.set_dictionary(W0)
        return (m.transform(image, n_iterations=OBJ_ITER, batch_size=1, mask=missing,
                            sparsity_H=0.1),)
    for label, run in (('minibatch ASG_MU bs=1', minibatch), ('transform batch_size=1', encode)):
        rel = pair(run)
        log(f'golden objective {label}, KL, 10% missing: {rel:.3e} off float64')
        if not rel <= TOL:
            raise AssertionError(f'golden objective {label}: {rel:.3e} off float64 > {TOL}')


def phase_objectives() -> tuple:
    """Phase 14: the objectives (beta-divergences, masks, ``l2_H``,
    ``ortho_W``) at full width and at the golden fixture; returns the
    launches and the times."""
    total = dict.fromkeys(KERNELS, 0)
    log(f'times on {card()}')
    out = _objective_flagship(total)
    kl_W = out.pop('kl_W')
    out.update(_objective_strategies(total, kl_W))
    log('the objectives at the golden 2-D fixture:')
    _objective_goldens()
    missing = [name for name in ENGINE_KERNELS if not total[name]]
    if missing:
        raise AssertionError(f'phase 14 launched no {missing}')
    return total, out


# ------------------------------------ phase 15: transform groups and initialisation

#: the D4 group at the flagship: 16 atoms x 8 transforms, H of 128 maps
GROUP_TYPE = 'shift+rot90+flip'
#: iterations held against use_pallas=False, and timed after a warm-up
GROUP_ITER = 2
GROUP_TIMED = 5
#: the golden 2-D fixture under each group: float32 on the kernels against
#: float64 on the card (max|a - b| / max|b| of W and H)
GROUP_TYPES = ('shift+flip', 'shift+rot90', 'shift+rot90+flip')
GROUP_GOLDEN_TOL = 1e-5
#: w_init='patches' from a CUDA tensor against the NumPy array's windows
PATCHES_TOL = 1e-6


def _group_parts(nmf, fit: dict) -> dict:
    """Per-call times (CUDA events) of a D4 conv iteration's parts on the
    model's state: the expansion of W, the reconstruction over the 128 maps,
    the streams, K3 on ``W_exp``, the stacked H-gradient pair and K4 of the
    inhibited path, ``X2``, K2, the tie-back and ``mu_w``."""
    Vp, W, H, plan, group = nmf._Vp, nmf._W, nmf._H, nmf._plan, nmf._group
    We = expand_w(W, group)
    R = conv.reconstruct(We, H, plan)
    Xv, Xr = engine._conv_streams(Vp, R, plan, 2.0, None)
    X2 = torch.cat([Xv, Xr], dim=1)
    neg, pos = gw.grad_w(X2, H)
    tneg, tpos = tie_back(neg, group), tie_back(pos, group)
    hneg, hpos = (g.contiguous() for g in conv.grad_H_pair_prepared(Xv, Xr, We))
    reg = engine.EPS + fit['sparsity_H']
    f = FLAGSHIP
    parts = {'expand_w': lambda: expand_w(W, group),
             'reconstruct': lambda: conv.reconstruct(We, H, plan),
             'streams': lambda: engine._conv_streams(Vp, R, plan, 2.0, None),
             'mu_h': lambda: mu_h.mu_h(Xv, Xr, We, H, reg),
             'grad_H_pair (inhibited)': lambda: conv.grad_H_pair_prepared(Xv, Xr, We),
             'inhibited_mu_h': lambda: inhibit.inhibited_mu_h(
                 H, hneg, hpos, nmf._kernels, f['inhibition'], f['cross'], reg),
             'cat X2': lambda: torch.cat([Xv, Xr], dim=1),
             'grad_w': lambda: gw.grad_w(X2, H),
             'tie_back': lambda: (tie_back(neg, group), tie_back(pos, group)),
             'mu_w': lambda: mu.mu_w(W, tneg, tpos, engine.EPS, plan.ndim)}
    _, _, g3 = mu_h.launch_geometry(Xv, Xr, We, H)
    g2 = gw._geometry(*gw_dims(plan, H, X2.shape[1]))
    g4 = inhibit.launch_geometry(tuple(H.shape), tuple(k.numel() for k in nmf._kernels), True)
    log(f'  K3 at {tuple(We.shape)} atoms, H {tuple(H.shape)}: route {g3["route"]}, ' +
        json.dumps(g3))
    log(f'  K2 at H {tuple(H.shape)}: ' + json.dumps(g2))
    log('  K4 (same + cross over the 128 maps): ' + json.dumps(g4))
    if g3['route'] != 'mma':
        raise AssertionError(f'K3 at 128 maps left the tensor-core route: {g3}')
    return {k: time_ms(fn, reps=3) for k, fn in parts.items()}


def _group_kernels() -> dict:
    """K3, K2 and K4 at the D4 flagship's shapes (128 maps, random factors)
    against their plain versions, then timed in turns with them, beside the
    nearest single PyTorch call and the bound."""
    f = FLAGSHIP
    fns = _problem(f['N'], f['C'], f['S'], f['M'] * 8, f['A'], f['mode'], seed=SEED + 15)
    out = {}
    for name in ('mu_h', 'grad_w', 'inhibited_mu_h'):
        kernel, plain, library, work = fns[name]
        err = _compare(name, kernel, plain, 'D4 flagship, 128 maps')
        # the plain K2 sums 64 per-sample convolutions: one timed call
        reps = 1 if name == 'grad_w' else 5
        p1, k1, k2, p2 = (time_ms(fn, reps=r) for fn, r in
                          ((plain, reps), (kernel, 5), (kernel, 5), (plain, reps)))
        lib = None if library is None else time_ms(library, reps=5)
        bound_ms, bound_by = bound(*work, OPS_PER_S[name])
        ms = (k1 + k2) / 2
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=(p1 + p2) / 2, library_ms=lib,
                         bound_ms=bound_ms, bound_by=bound_by)
        log(f'  {name:14s} at 128 maps: kernel {k1:.4f}/{k2:.4f} ms  plain {p1:.4f}/{p2:.4f} ms'
            f'  library {"none" if lib is None else f"{lib:.4f} ms"}  bound {bound_ms:.4f} ms '
            f'({bound_by}), {100 * bound_ms / ms:.1f} % of bound')
    del fns
    return out


def _group_flagship(total: dict) -> dict:
    """(a) The conv flagship with D4 (128 maps), plain and inhibited (same
    and cross-atom), from ``init='device'``: K3 (K4), K2 and ``mu_w`` once
    per iteration, W and H within 1e-4 of ``use_pallas=False`` from the
    same start, ms per iteration, peak memory, the routes and the split."""
    f = FLAGSHIP
    V = np.random.default_rng(SEED + 15).random((f['N'], f['C']) + f['S'], dtype=np.float32)
    group = make_group(GROUP_TYPE, f['A'])
    out = {}
    paths = (('plain', dict(sparsity_H=f['sparsity']), OBJ_CONV),
             ('inhibited', dict(sparsity_H=f['sparsity'], inhibition_strength=f['inhibition'],
                                cross_atom_inhibition_strength=f['cross']), OBJ_CONV_INHIBITED))
    for label, fit, kernels in paths:
        def make(dtype, **kw):
            return TransformInvariantNMF(f['M'], f['A'], dtype=dtype, seed=SEED, device=DEVICE,
                                         init='device', transform_type=GROUP_TYPE, **kw)
        nmf, launches, wall, peak = _strategy_fit(f'D4 flagship {label}', make, V, fit,
                                                  GROUP_ITER, kernels, ('conv', group),
                                                  refs=('plain',))
        for name, n in launches.items():
            total[name] += n
        ms = _objective_ms(nmf, fit, n=GROUP_TIMED)
        log(f'D4 flagship {label}: {ms:.4f} ms/iteration ({GROUP_TIMED} after as many); '
            f'peak {peak:.0f} MiB')
        out[label] = dict(ms=ms, peak_mib=peak, wall_s=wall)
        if label == 'plain':
            out['parts'] = _group_parts(nmf, fit)
            log('  D4 parts (ms per call): ' + json.dumps(out['parts']))
        del nmf
    out['kernels_128_maps'] = _group_kernels()
    return out


def _group_fft(total: dict) -> dict:
    """(b) ``'auto'`` on phase 12's fft problem with the C4 rotations (64
    maps): ``mu_ratio`` and ``mu_w`` once per iteration, against
    ``use_pallas=False``."""
    a = AUTO_FFT
    V = np.random.default_rng(SEED + 16).random((a['N'], a['C']) + a['S'], dtype=np.float32)
    fit = dict(sparsity_H=a['sparsity'])

    def make(dtype, **kw):
        return TransformInvariantNMF(a['M'], a['A'], dtype=dtype, seed=SEED, device=DEVICE,
                                     init='device', transform_type='shift+rot90', **kw)
    nmf, launches, _, peak = _strategy_fit(
        "'auto' -> fft with rotations", make, V, fit, GROUP_ITER, OBJ_FFT_DOT,
        ('fft', make_group('shift+rot90', a['A'])), refs=('plain',))
    for name, n in launches.items():
        total[name] += n
    ms = _objective_ms(nmf, fit, n=GROUP_TIMED)
    log(f"'auto' -> fft with rotations (64 maps): {ms:.4f} ms/iteration; peak {peak:.0f} MiB")
    return dict(ms=ms, peak_mib=peak)


def _group_goldens(total: dict) -> None:
    """(c) The golden 2-D fit under each group on conv and fft, float32 on
    the kernels within 1e-5 of float64 on the card; a D4 fit of a CUDA
    tensor with the bits of the NumPy array's, no host copy of the data."""
    image = _image_2d()
    for ttype in GROUP_TYPES:
        for backend, kernels in (('jax_conv', OBJ_CONV), ('jax_fft', OBJ_FFT_DOT)):
            def golden(dtype, data=image):
                np.random.seed(42)
                m = TransformInvariantNMF(10, (7, 7), backend=backend, transform_type=ttype,
                                          dtype=dtype, device=DEVICE)
                m.fit(data, sparsity_H=0.1, n_iterations=10)
                return m
            reset_counts()
            got = golden(torch.float32)
            launches = counts()
            want = golden(torch.float64)
            rel = max(_rel(got.W, want.W), _rel(got.H, want.H))
            expected = dict.fromkeys(KERNELS, 0)
            expected.update(dict.fromkeys(kernels, 10))
            log(f'  golden 2-D {ttype} on {got._strategy[0]}: W, H off float64 {rel:.3e}; '
                f'launches {launches}')
            if not rel <= GROUP_GOLDEN_TOL or launches != expected:
                raise AssertionError(f'golden 2-D {ttype} {backend}: {rel:.3e} > '
                                     f'{GROUP_GOLDEN_TOL} or launches {launches}')
            for name, n in launches.items():
                total[name] += n
            if ttype == GROUP_TYPE and backend == 'jax_conv':
                Vt = torch.tensor(image, device=DEVICE)
                with no_host_copy(Vt):
                    tensor_fit = golden(torch.float32, Vt)
                same = torch.equal(tensor_fit._W, got._W) and torch.equal(tensor_fit._H,
                                                                          got._H)
                log(f'  D4 golden fit of a CUDA tensor: {"the bits" if same else "DIFFERS from"}'
                    ' of the NumPy fit, no host copy of the data')
                if not same:
                    raise AssertionError('a D4 fit of a CUDA tensor differs from the NumPy fit')


def _device_init() -> dict:
    """(d) ``init='device'`` at the flagship: the wall time of a fit's
    initialisation (``fit(n_iterations=0)``) against the host draw, in turns;
    ``partial_fit`` steps of 16 samples with each; two draws from one seed
    bit-equal.  (e) ``w_init='patches'`` from a CUDA tensor: the windows of
    the NumPy array's fit (the JAX rule), with no host copy of the data."""
    f = FLAGSHIP
    V = np.random.default_rng(SEED + 17).random((f['N'], f['C']) + f['S'], dtype=np.float32)
    out = dict(init_wall_ms={'host': [], 'device': []},
               partial_fit_wall_ms={'host': [], 'device': []})
    models = []
    for init in ('host', 'device', 'device', 'host'):
        m = TransformInvariantNMF(f['M'], f['A'], seed=SEED, device=DEVICE, init=init)
        sync()
        t0 = time.perf_counter()
        m.fit(V, n_iterations=0)
        sync()
        out['init_wall_ms'][init].append(1e3 * (time.perf_counter() - t0))
        if init == 'device':
            models.append(m)
        del m
    a, b = models
    same = torch.equal(a._W, b._W) and torch.equal(a._H, b._H)
    h = a._H
    mean, lo, hi = float(h.mean()), float(h.min()), float(h.max())
    log(f'  init wall ms (fit of 0 iterations, in turns): host '
        + '/'.join(f'{t:.1f}' for t in out['init_wall_ms']['host']) + ', device '
        + '/'.join(f'{t:.1f}' for t in out['init_wall_ms']['device'])
        + f'; two device draws of seed {SEED}: {"the same bits" if same else "DIFFER"}; '
        f'H in [{lo!r}, {hi!r}], mean {mean!r}')
    if not (same and 0 < lo and hi <= 1 and abs(mean - 0.5) < 4 / math.sqrt(12 * h.numel())):
        raise AssertionError('init=device: draws differ or H is off its distribution')
    del models, a, b, h
    for init in ('host', 'device'):
        online = TransformInvariantNMF(f['M'], f['A'], seed=SEED, device=DEVICE, init=init)
        for i in range(4):
            sync()
            t0 = time.perf_counter()
            online.partial_fit(V[i * MB_BATCH:(i + 1) * MB_BATCH], sparsity_H=f['sparsity'])
            sync()
            out['partial_fit_wall_ms'][init].append(1e3 * (time.perf_counter() - t0))
        if not math.isfinite(online._energy_function()):
            raise AssertionError(f'partial_fit with init={init}: energy not finite')
        del online
    log('  partial_fit of 16 samples, wall ms per step: host '
        + '/'.join(f'{t:.1f}' for t in out['partial_fit_wall_ms']['host']) + ', device '
        + '/'.join(f'{t:.1f}' for t in out['partial_fit_wall_ms']['device']))

    def patches(data):
        m = TransformInvariantNMF(f['M'], f['A'], seed=SEED, device=DEVICE, w_init='patches')
        m.fit(data, n_iterations=0)
        return m.W
    want = patches(V)
    Vt = torch.tensor(V, device=DEVICE)
    with no_host_copy(Vt):
        got = patches(Vt)
    rel = _rel(got, want)
    log(f"  w_init='patches' from a CUDA tensor at the flagship: W off the NumPy array's "
        f'windows (the JAX rule) by {rel:.3e}, no host copy of the data')
    if not rel <= PATCHES_TOL:
        raise AssertionError(f"w_init='patches' from a CUDA tensor off by {rel:.3e}")
    out['patches_rel'] = rel
    return out


def phase_transforms() -> tuple:
    """Phase 15: transform groups on K1-K4 and the initialisations; returns
    the launches and the measurements."""
    total = dict.fromkeys(KERNELS, 0)
    log(f'times on {card()}')
    out = _group_flagship(total)
    out['auto_fft_rot90'] = _group_fft(total)
    log('the golden 2-D fixture under each group:')
    _group_goldens(total)
    log("init='device' and w_init='patches' at the flagship:")
    out.update(_device_init())
    missing = [name for name in ENGINE_KERNELS if not total[name]]
    if missing:
        raise AssertionError(f'phase 15 launched no {missing}')
    return total, out


# --------------------------------------------------------------- phase 16: HALS

#: K5 against its plain version (max|kernel - plain| / max|plain|)
K5_TOL = 1e-5
#: HALS fits held against ``use_pallas=False`` (W and H) and float64
HALS_TOL = 1e-4
#: iterations of the HALS fits held against their references, and timed
HALS_ITER = 2
HALS_TIMED = 3
#: plain-NMF HALS at the JAX package's production scale (``'auto'`` -> 1 sweep)
HALS_PLAIN = dict(N=16384, F=4096, M=256)
#: shift-invariant HALS at the flagship's data ('full': H is 64 x 16 x 248 x 248)
HALS_CONV = dict(N=64, C=1, S=(256, 256), M=16, A=(9, 9), sparsity=0.1)
#: K5 alone: (where, rows, components, length of the factor the Gram sums
#: over, passes, options of ``_k5_inputs``); the shapes of the main paths,
#: a ragged one and one whose tile of X no block's shared memory holds (the
#: streamed route).  ``layout='views'``: X, G and P transposed views of
#: contiguous tensors, as the W sweep launches ``W^T``, ``A^T`` and ``B^T``
#: (the others row-major, as the H and phase sweeps launch them).  At 4096
#: components dense atoms make a Gram so near rank one that two float32
#: sum orders of the plain version differ by more than ``K5_TOL``; the
#: streamed case takes atoms of about 64 nonzeros in 8192 (``density``),
#: and every case prints both versions' distance from float64
K5_CASES = [
    ('H side 16384x256', 16384, 256, 4096, 1, {}),
    ('W side 4096x256', 4096, 256, 16384, 1, dict(layout='views')),
    ('phase rows 50176x16', 50176, 16, 81, 1, {}),
    ('ragged 1000x37', 1000, 37, 300, 1, {}),
    ('H side 16384x256 inner 3', 16384, 256, 4096, 3, {}),
    ('streamed 2048x4096', 2048, 4096, 8192, 1, dict(density=1 / 128)),
]
#: K5's times before its redesign, as PERF.md section 6 records them
#: (NVIDIA H100 80GB HBM3, 700.00 W), printed as "earlier"
K5_EARLIER_MS = {'H side 16384x256': 2.3527, 'W side 4096x256': 1.8180,
                 'phase rows 50176x16': 0.0833, 'H side 16384x256 inner 3': 5.8644}


def _k5_inputs(rows: int, m: int, length: int, seed: int, layout: str = 'rows',
               density: float = 1.0) -> tuple:
    """Random non-negative factors as a HALS sweep meets them: ``G = Y Y^T``
    of a sum-normalised factor ``Y (m, length)`` (each entry nonzero with
    probability ``density``), ``P = Z Y^T`` of data ``Z`` near the span of
    ``Y``, and a random start ``X``; float32 on the card, row-major or
    (``'views'``) transposed views of contiguous tensors."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    Y = torch.rand((m, length), generator=g, device=DEVICE)
    if density < 1:
        Y *= torch.rand((m, length), generator=g, device=DEVICE) < density
    Y /= Y.sum(dim=1, keepdim=True)
    Z = (torch.rand((rows, m), generator=g, device=DEVICE) @ Y
         + 0.01 * torch.rand((rows, length), generator=g, device=DEVICE) / length)
    with matmul_pin(None, DEVICE):
        G, P = Y @ Y.T, Z @ Y.T
    X = torch.rand((rows, m), generator=g, device=DEVICE)
    if layout == 'views':
        return tuple(t.T.contiguous().T for t in (X, G, P))
    return X, G.contiguous(), P.contiguous()


def _host_us(fn, reps: int = 10) -> float:
    """Host microseconds per call of ``fn`` (the time to issue it, no
    synchronisation in the window), after a warm-up call."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / reps
    sync()
    return us


def _k5_cases() -> dict:
    """K5 against its plain version at each case, timed in turns (plain,
    kernel, kernel, plain), with its bound, its earlier time, its geometry
    and the host's time to issue a call; returns the measurements."""
    out = {}
    for i, (where, rows, m, length, inner, options) in enumerate(K5_CASES):
        X, G, P = _k5_inputs(rows, m, length, SEED + 40 + i, **options)
        layout = options.get('layout', 'rows')
        args = (X, G, P, 0.1 / length, 0.0, inner)
        got, want = hals.hals_sweep(*args), hals.hals_sweep_plain(*args)
        want64 = hals.hals_sweep_plain(*(t.double() for t in args[:3]), *args[3:])
        sync()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        # both versions' distance from float64 on the same float32 inputs
        f64 = {name: float((t.double() - want64).abs().max() / want64.abs().max())
               for name, t in (('kernel', got), ('plain', want))}
        del want64
        again = hals.hals_sweep(*args)
        same = torch.equal(again, got)
        p1, k1, k2, p2 = (time_ms(lambda fn=fn: fn(*args), reps=3)
                          for fn in (hals.hals_sweep_plain, hals.hals_sweep, hals.hals_sweep,
                                     hals.hals_sweep_plain))
        host_us = _host_us(lambda: hals.hals_sweep(*args))
        # X read and written, P and G read; 2 m^2 operations per row and pass
        work = (4 * (3 * rows * m + m * m), 2.0 * inner * rows * m * m)
        bound_ms, bound_by = bound(*work, FP32_FLOP_PER_S)
        geo = hals.launch_geometry(rows, m, X.device)
        ms = (k1 + k2) / 2
        earlier = K5_EARLIER_MS.get(where)
        host_bound = host_us / 1e3 >= ms
        out[where] = dict(max_abs_err=err, rel=rel, ms=ms, plain_ms=(p1 + p2) / 2,
                          bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                          earlier_ms=earlier, host_us=host_us, host_bound=host_bound,
                          layout=layout, out_strides=list(got.stride()),
                          float64_rel=f64, **geo)
        log(f'  hals_sweep {where} ({layout}): max_abs_err={err:.3e} rel={rel:.3e} (from '
            f'float64: kernel {f64["kernel"]:.3e}, plain {f64["plain"]:.3e}), two '
            f'launches {"bit-equal" if same else "DIFFER"}; kernel {k1:.4f}/{k2:.4f} ms '
            f'(earlier {"not recorded" if earlier is None else f"{earlier:.4f} ms"}), plain '
            f'{p1:.4f}/{p2:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), '
            f'{100 * bound_ms / ms:.1f} % of bound; host {host_us:.1f} us per call'
            f'{" (host-bound window)" if host_bound else ""}; {geo["rows_per_block"]} rows, '
            f'panel {geo["panel"]}, {geo["threads"]} threads, {geo["blocks"]} blocks, '
            f'{geo["smem_bytes"]} B shared, tile {"resident" if geo["resident"] else "streamed"}')
        if not (rel <= K5_TOL and same and torch.isfinite(got).all()
                and got.stride() == X.stride()):
            raise AssertionError(f'hals_sweep at {where}: {rel:.3e} off its plain version '
                                 f'(> {K5_TOL}?), or launches differ, or not finite, or '
                                 f'strides {got.stride()} not X\'s {X.stride()}')
        del X, G, P, got, want, again
    if not any(not v['resident'] for v in out.values()):
        raise AssertionError('no K5 case took the streamed route')
    return out


def _hals_fit(label, make, V, fit: dict, expected: dict) -> tuple:
    """``make().fit(V, solver='hals', **fit)`` for ``HALS_ITER`` iterations
    on the kernels, with ``record_energies`` and a callback that records the
    regularized objective ``energy + sparsity_H * sum(H)`` (what each
    iteration minimizes), counts reset before and read after (exactly
    ``expected`` per iteration); that objective never rises from the start
    on (1e-6 relative).  The same fit with ``use_pallas=False`` (no launch)
    and in float64 (the gate's plain versions): W and H of the kernels'
    fit within ``HALS_TOL`` of float64, or, where the float32 plain
    versions are themselves farther off float64 (the plain-NMF W sweep
    amplifies float32 rounding), within twice their distance.  Returns the
    model, its launches, peak device memory (MiB) and the three distances."""
    l1 = fit.get('sparsity_H', 0.)

    def objective(m):
        return m._energy() + l1 * m._H.sum()
    start = make()
    start.fit(V, n_iterations=0, solver='hals', **fit)
    objs = [objective(start)]
    del start
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    nmf = make()
    nmf.fit(V, n_iterations=HALS_ITER, solver='hals', record_energies=True,
            progress_callback=lambda m, i: objs.append(objective(m)) or True, **fit)
    sync()
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    want = dict.fromkeys(KERNELS, 0)
    want.update({k: v * HALS_ITER for k, v in expected.items()})
    e = np.asarray(torch.stack(objs).tolist())
    refs = {}
    reset_counts()
    for ref_label, kw in (('plain', dict(use_pallas=False)), ('float64', dict(dtype=torch.float64))):
        ref = make(**kw)
        ref.fit(V, n_iterations=HALS_ITER, solver='hals', **fit)
        refs[ref_label] = (ref.W, ref.H)
        del ref
    sync()
    ref_launches = counts()

    def off(a, b):
        return max(_rel(a[0], b[0]), _rel(a[1], b[1]))
    got = (nmf.W, nmf.H)
    rel = dict(kernels_plain=off(got, refs['plain']), kernels_float64=off(got, refs['float64']),
               plain_float64=off(refs['plain'], refs['float64']))
    log(f'{label}: launches {launches}; objective {e.tolist()} (energies '
        f'{nmf.energies_.tolist()}); W, H off: kernels against use_pallas=False '
        f'{rel["kernels_plain"]:.3e}, kernels against float64 {rel["kernels_float64"]:.3e}, '
        f'use_pallas=False against float64 {rel["plain_float64"]:.3e}; peak {peak:.0f} MiB')
    if launches != want or any(ref_launches.values()):
        raise AssertionError(f'{label}: launches {launches} (references: {ref_launches}), '
                             f'not {want}')
    limit = max(HALS_TOL, 2 * rel['plain_float64'])
    if not (np.isfinite(e).all() and np.all(np.diff(e) <= 1e-6 * abs(e[0]))
            and rel['kernels_float64'] <= limit):
        raise AssertionError(f'{label}: objective {e.tolist()} rises or is not finite, or W, '
                             f'H {rel["kernels_float64"]:.3e} off float64 > {limit:.3e}')
    return nmf, launches, peak, rel


def _hals_ms(run) -> float:
    """Device ms per iteration of ``run(n)`` (CUDA events), after a warm-up
    iteration."""
    run(1)
    sync()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    run(HALS_TIMED)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / HALS_TIMED


def _hals_plain_nmf(total: dict) -> dict:
    """Plain-NMF HALS at 16384 x 1 x 4096 with 256 atoms ('full', ``'auto'``
    inner sweeps: 1): K5 twice per iteration, no other kernel."""
    c = HALS_PLAIN
    V = np.random.default_rng(SEED + 50).random((c['N'], 1, c['F']), dtype=np.float32)

    def make(**kw):
        return TransformInvariantNMF(c['M'], (c['F'],), reconstruction_mode='full', seed=SEED,
                                     device=DEVICE, **kw)
    inner = engine_hals.auto_inner(c['M'], c['F'], 'auto', n_samples=c['N'])
    nmf, launches, peak, rel = _hals_fit(f'HALS plain NMF {c["N"]}x1x{c["F"]}/{c["M"]}', make,
                                         V, {}, {'hals_sweep': 2})
    for name, n in launches.items():
        total[name] += n
    Vd, plan = nmf._Vd, nmf._plan

    def run(n):
        nmf._W, nmf._H = engine_hals.fit_loop(Vd, nmf._W, nmf._H, n, 0., 0., 0., 0.,
                                              inner=inner, update_H=True, update_W=True)
    ms = _hals_ms(run)
    V2, W2, H2 = engine_hals._flatten(Vd, nmf._W, nmf._H)
    with matmul_pin(None, DEVICE):
        grams = time_ms(lambda: (engine_hals._dot(W2, W2.T), engine_hals._dot(V2, W2.T),
                                 engine_hals._dot(H2.T, H2), engine_hals._dot(H2.T, V2)),
                        reps=3)
    flops = 4.0 * c['N'] * c['M'] * c['F'] + 2.0 * c['M'] ** 2 * (c['N'] + c['F'])
    gram_bound, _ = bound(4.0 * (c['N'] * c['F'] + 2 * c['N'] * c['M'] + 2 * c['M'] * c['F']),
                          flops, FP32_FLOP_PER_S)
    log(f'HALS plain NMF: inner {inner}, {ms:.4f} ms/iteration (CUDA events); the four Gram '
        f'products {grams:.4f} ms ({flops / 1e9:.1f} GFLOP, bound {gram_bound:.4f} ms), '
        f'peak {peak:.0f} MiB; energy {nmf._energy_function()!r}; plan {plan.transform_shape}')
    return dict(ms_per_iteration=ms, grams_ms=grams, grams_bound_ms=gram_bound,
                peak_mib=peak, inner=inner, rel=rel,
                launches_per_iteration={k: v / HALS_ITER for k, v in launches.items() if v})


def _hals_conv(total: dict) -> dict:
    """Shift-invariant HALS at the flagship's data ('full', 81 phases):
    K5 once per phase, K2 and ``mu_ratio`` once per iteration."""
    c = HALS_CONV
    V = np.random.default_rng(SEED).random((c['N'], c['C']) + c['S'], dtype=np.float32)

    def make(**kw):
        return TransformInvariantNMF(c['M'], c['A'], reconstruction_mode='full', seed=SEED,
                                     device=DEVICE, **kw)
    n_phases = math.prod(c['A'])
    nmf, launches, peak, rel = _hals_fit('HALS shift-invariant flagship', make, V,
                                         dict(sparsity_H=c['sparsity']),
                                         {'hals_sweep': n_phases, 'grad_w': 1, 'mu_ratio': 1})
    for name, n in launches.items():
        total[name] += n
    Vd, plan = nmf._Vd, nmf._plan
    flags = dict(inner=1, update_H=True, update_W=True, plan=plan)

    def run(n):
        nmf._W, nmf._H = engine_hals_conv.fit_loop(Vd, nmf._W, nmf._H, n, c['sparsity'], 0.,
                                                   **flags)
    ms = _hals_ms(run)
    split = _hals_conv_split(Vd, nmf._W, nmf._H, plan, c['sparsity'])
    log(f'HALS shift-invariant flagship: {ms:.4f} ms/iteration (CUDA events); one '
        f'iteration by stage, device ms (host ms to issue it): '
        + ', '.join(f'{k} {v[0]:.4f} ({v[1]:.4f})' for k, v in split.items())
        + f'; peak {peak:.0f} MiB; energy {nmf._energy_function()!r}')
    return dict(ms_per_iteration=ms, split=split, peak_mib=peak, rel=rel,
                launches_per_iteration={k: v / HALS_ITER for k, v in launches.items() if v})


def _hals_conv_split(V, W, H, plan, l1) -> dict:
    """One shift-invariant HALS iteration stage by stage, as
    ``engine_hals_conv._iteration`` runs it after the loop's start (the
    encoding): each stage's device time between CUDA events, and the host
    time to issue it (no synchronisation in between), after a warm-up."""
    ehc = engine_hals_conv
    stages = [
        ('encode (a reconstruction)', lambda st: st.update(zip(('E', 'Hpm'),
                                                                ehc._encode(V, W, H, plan)),
                                                            G=ehc.gram_W(W))),
        ('H phase sweep (81 phases)', lambda st: ehc.h_phase_sweep(
            st['E'], st['Hpm'], W, st['G'], l1, 0., plan=plan, inner=1)),
        ('decode H', lambda st: st.update(H=ehc._decode_h(st['Hpm'], plan))),
        ('W step (K2 + mu_ratio)', lambda st: st.update(
            W=ehc._mu_W_from_residual(V, st['E'], W, st['H'], plan))),
        ('Gram', lambda st: st.update(G=ehc.gram_W(st['W']))),
        ('fresh residual (a reconstruction)', lambda st: st.update(
            E=ehc._residual(V, st['W'], st['H'], plan))),
    ]
    out = {}
    for rep in range(2):  # the first pass warms up
        st = {}
        events = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
        host = []
        sync()
        with matmul_pin(None, DEVICE):
            events[0].record()
            for i, (_, fn) in enumerate(stages):
                t0 = time.perf_counter()
                fn(st)
                events[i + 1].record()
                host.append(1e3 * (time.perf_counter() - t0))
        sync()
        out = {name: (events[i].elapsed_time(events[i + 1]), host[i])
               for i, (name, _) in enumerate(stages)}
        del st
    return out


def _hals_goldens() -> None:
    """Small fixtures' HALS fits in float32 on the kernels within
    ``HALS_TOL`` of float64 on the card (the gate's plain versions): plain
    NMF on 64 x 1 x 100 with 5 atoms, and the golden 2-D fixture in 'full'
    mode with 10 atoms of 7 x 7."""
    rng = np.random.default_rng(SEED + 60)
    cases = [('plain NMF 64x1x100/5',
              (rng.random((64, 5)) @ rng.random((5, 100))).reshape(64, 1, 100), (100,), 5,
              dict(n_iterations=10, sparsity_H=0.01, l2_W=0.1)),
             ("golden 2-D 'full' 10 x 7x7", _image_2d().astype(np.float64), (7, 7), 10,
              dict(n_iterations=5, sparsity_H=0.1))]
    for label, V, atom, m, fit in cases:
        out = []
        for dtype in (torch.float32, torch.float64):
            reset_counts()
            nmf = TransformInvariantNMF(m, atom, reconstruction_mode='full', seed=SEED,
                                        device=DEVICE, dtype=dtype)
            nmf.fit(V.astype(np.float32) if dtype == torch.float32 else V, solver='hals',
                    **fit)
            sync()
            out.append((nmf.W, nmf.H, counts()['hals_sweep']))
        rel = max(_rel(out[0][0], out[1][0]), _rel(out[0][1], out[1][1]))
        log(f'  HALS {label}: float32 on the kernels ({out[0][2]} K5 launches) {rel:.3e} off '
            f'float64 ({out[1][2]} launches)')
        if not (rel <= HALS_TOL and out[0][2] and not out[1][2]):
            raise AssertionError(f'HALS {label}: float32 {rel:.3e} off float64 > {HALS_TOL}, '
                                 f'or launches {out[0][2]} / {out[1][2]}')


def phase_hals() -> tuple:
    """Phase 16: the HALS solvers on K5 (with K2 and ``mu_ratio`` on the
    shift-invariant W step); returns the launches and the measurements."""
    total = dict.fromkeys(KERNELS, 0)
    log(f'times on {card()}')
    out = dict(k5=_k5_cases())
    out['plain_nmf'] = _hals_plain_nmf(total)
    out['shift_invariant'] = _hals_conv(total)
    _hals_goldens()
    missing = [name for name in ('hals_sweep', 'grad_w', 'mu_ratio') if not total[name]]
    if missing:
        raise AssertionError(f'phase 16 launched no {missing}')
    return total, out


#: the serving artifact (phase 17): request batch sizes at the conv
#: flagship, iterations per MU request, per HALS request, and the tolerance
#: of an artifact against ``transform`` on the card (the same kernels)
SERVE_BATCHES = (1, 8, 64)
SERVE_ITER = 10
SERVE_HALS_ITER = 3
SERVE_TOL = 1e-6
#: what a loaded artifact may import besides torch and the port
SERVE_CHILD = r'''
import sys, torch, tnmf_tpu_torch
served = tnmf_tpu_torch.load_serving(sys.argv[1])
shape = [1] + served.header['input_shape'][1:]
H = served.transform(torch.rand(shape, device=sys.argv[2]), n_iterations=2)
others = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'tnmf_tpu'})
print(tuple(H.shape), bool(torch.isfinite(H).all()), others)
'''


@contextlib.contextmanager
def tf32_defaults():
    """Inside the block PyTorch's TF32 switches are on for cuBLAS and cuDNN
    (matmul precision 'high', the cuDNN default): what a serving process
    may have set; the caller's settings come back on exit."""
    saved = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.set_float32_matmul_precision('high')
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved[1:]


@contextlib.contextmanager
def every_plain_call():
    """Inside the block every plain version counts its calls, the engine's
    names and the kernel modules' own (which a wrapper calls on CPU
    tensors): yields the counts, read after the block."""
    sites = [(engine, name + '_plain') for name in ENGINE_KERNELS]
    sites += [(engine_hals, 'hals_sweep_plain'), (mu, 'mu_ratio_plain'), (mu, 'mu_w_plain'),
              (mu_h, 'mu_h_plain'), (inhibit, 'inhibited_mu_h_plain'), (gw, 'grad_w_plain'),
              (hals, 'hals_sweep_plain')]
    calls = {}
    saved = [(module, name, getattr(module, name)) for module, name in sites]

    def counting(key, fn):
        def call(*args, **kwargs):
            calls[key] = calls.get(key, 0) + 1
            return fn(*args, **kwargs)
        return call
    for module, name, fn in saved:
        setattr(module, name, counting(f'{module.__name__}.{name}', fn))
    try:
        yield calls
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def _export(make, sample_shape, label, **export) -> tuple:
    """``make()``'s artifact for ``sample_shape`` (symbolic batch) written to
    a temporary file and loaded from it: ``(served, model, seconds, bytes)``."""
    model = make()
    path = Path(tempfile.mkdtemp()) / f'{label}.tnmfsrt'
    sync()
    t0 = time.perf_counter()
    model.export_serving(path=str(path), sample_shape=sample_shape, **export)
    seconds = time.perf_counter() - t0
    size = path.stat().st_size
    served = load_serving(str(path))
    log(f'serving {label}: export {seconds:.2f} s, {size} bytes, sections '
        f'{served.header["sections"]}')
    return served, model, seconds, size, path


def _serve_check(label, served, model, V, n_iter, kernel, refs, transform_kw,
                 limit=None, also=()) -> tuple:
    """One request of ``V`` (a CUDA tensor) under the TF32 defaults, counts
    reset before and read after, every plain version counting: ``kernel``
    launched as ``n_iter`` times ``per`` (K5: once per phase), and so is
    each count of ``also`` (a route of the same wrapper), no other kernel
    and no plain version.  H against ``transform`` on the card
    (within ``SERVE_TOL``, bits printed) and against each reference
    ``refs[name]() -> H`` (``limit``: the tolerance of each, default 1e-4).
    Returns the H, the launches, the distances and the request's peak
    device memory beyond what was allocated before it (MiB)."""
    kernel, per = kernel
    sync()
    reset_counts()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with every_plain_call() as plain, tf32_defaults():
        H = served.transform(V, n_iterations=n_iter)
        sync()
    peak = (torch.cuda.max_memory_allocated() - before) / 2**20
    launches = counts()
    want = dict.fromkeys(KERNELS, 0)
    want.update(dict.fromkeys((kernel,) + tuple(also), n_iter * per))
    reset_counts()
    H_t = model.transform(V, n_iterations=n_iter, **transform_kw)
    sync()
    got = H.cpu().numpy()
    bits = np.array_equal(got, H_t)
    rel = dict(transform=_rel(got, H_t))
    for name, ref in refs.items():
        rel[name] = _rel(got, ref())
    log(f'serving {label}: batch {V.shape[0]}, {n_iter} iterations, launches '
        f'{ {k: v for k, v in launches.items() if v} }, plain calls {plain}; H '
        + ('bit-equal to' if bits else f'{rel["transform"]:.3e} off') + ' transform, '
        + ', '.join(f'{rel[k]:.3e} off {k}' for k in refs)
        + f'; the request took {peak:.0f} MiB of device memory beyond its input and models')
    if launches != want or plain:
        raise AssertionError(f'serving {label}: launches {launches} (not {want}) or plain '
                             f'calls {plain}')
    limits = dict(transform=SERVE_TOL, **{k: (limit or {}).get(k, TOL) for k in refs})
    bad = {k: v for k, v in rel.items() if not v <= limits[k]}
    if bad or not np.isfinite(got).all():
        raise AssertionError(f'serving {label}: H off {bad} (limits {limits}), or not finite')
    return H, launches, rel, peak


def _request_ms(served, model, V, n_iter, transform_kw, reps=3) -> dict:
    """ms per request of the artifact and of ``transform``'s compute
    (``fit_batch`` with W frozen, H left on the card) on the same CUDA
    tensor, CUDA events, in turns (artifact, transform, transform,
    artifact) after a warm-up of each; and the artifact's host time per
    request (the call, then a synchronisation)."""
    def artifact():
        served.transform(V, n_iterations=n_iter)

    def transform():
        model.fit_batch(V, n_iterations=n_iter, update_W=False, keep_W=True, **transform_kw)
    for fn in (artifact, transform):
        fn()
    times = [time_ms(fn, reps=reps) for fn in (artifact, transform, transform, artifact)]
    host = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        artifact()
        sync()
        host.append(1e3 * (time.perf_counter() - t0))
    ms, t_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
    return dict(ms=ms, ms_per_iteration=ms / n_iter, transform_ms=t_ms,
                transform_ms_per_iteration=t_ms / n_iter, turns_ms=times,
                host_ms=float(np.median(host)))


def _serve_flagship(W: np.ndarray, total: dict) -> dict:
    """The conv flagship's artifact (K3): export, a fresh process that loads
    it, then requests of each batch size against ``transform``, against the
    same call with ``use_pallas=False``, and timed."""
    f = FLAGSHIP
    fit = dict(sparsity_H=f['sparsity'])

    def make(use_pallas=None):
        return TransformInvariantNMF(f['M'], f['A'], h_init='correlate', device=DEVICE,
                                     use_pallas=use_pallas).set_dictionary(W)
    served, model, seconds, size, path = _export(make, f['S'], 'conv flagship',
                                                 n_iterations=SERVE_ITER, **fit)
    child = subprocess.run([sys.executable, '-c', SERVE_CHILD, str(path), DEVICE], cwd=ROOT,
                           capture_output=True, text=True, timeout=300)
    log(f'serving conv flagship: a fresh process loading the file: {child.stdout.strip()} '
        f'(exit {child.returncode}) {child.stderr.strip()[-500:]}')
    if child.returncode != 0 or not child.stdout.strip().endswith('True []'):
        raise AssertionError('the artifact did not serve in a process of torch and '
                             'tnmf_tpu_torch alone')
    V_all = torch.as_tensor(np.random.default_rng(SEED + 1).random(
        (max(SERVE_BATCHES), f['C']) + f['S'], dtype=np.float32), device=DEVICE)
    plain_model = make(use_pallas=False)
    out = dict(export_s=seconds, file_bytes=size, requests={})
    for b in SERVE_BATCHES:
        V = V_all[:b]
        _, launches, rel, peak = _serve_check(
            'conv flagship', served, model, V, SERVE_ITER, ('mu_h', 1),
            dict(use_pallas_false=lambda: plain_model.transform(V, n_iterations=SERVE_ITER,
                                                                **fit)), fit)
        for name, n in launches.items():
            total[name] += n
        out['launches_per_iteration'] = {k: n / SERVE_ITER for k, n in launches.items() if n}
        times = _request_ms(served, model, V, SERVE_ITER, fit)
        times.update(request_mib=peak, rel=rel)
        out['requests'][b] = times
        log(f'serving conv flagship, batch {b} ({card()}): artifact {times["ms"]:.4f} ms per '
            f'request ({times["ms_per_iteration"]:.4f} ms per iteration), transform '
            f'{times["transform_ms"]:.4f} ms ({times["transform_ms_per_iteration"]:.4f}); in '
            f'turns {[round(t, 4) for t in times["turns_ms"]]}; host {times["host_ms"]:.3f} ms '
            f'per request; the request\'s own peak {peak:.0f} MiB')
    path.unlink()
    return out


def _serve_kinds(W: np.ndarray, total: dict) -> dict:
    """The other artifact kinds: the inhibited flagship (K4), the fft
    flagship (K1 ``mu_ratio``), plain-NMF HALS at 16384 x 4096 with 256
    atoms (K5) and shift-invariant HALS in 'full' mode on the flagship's
    data (K5 once per phase), each against ``transform``, ``use_pallas=False``
    and, for HALS, float64 (within phase 16's margin), then timed."""
    f, hp, hc = FLAGSHIP, HALS_PLAIN, HALS_CONV
    rng = np.random.default_rng(SEED + 70)
    W_plain = rng.random((hp['M'], 1, hp['F']))
    W_conv = rng.random((hc['M'], hc['C']) + hc['A'])
    kinds = [
        ('inhibited flagship', lambda **kw: TransformInvariantNMF(
            f['M'], f['A'], h_init='correlate', device=DEVICE, **kw).set_dictionary(W),
         f['S'], 8, SERVE_ITER, ('inhibited_mu_h', 1),
         dict(sparsity_H=f['sparsity'], inhibition_strength=f['inhibition'],
              cross_atom_inhibition_strength=f['cross']), {}),
        ('fft flagship', lambda **kw: TransformInvariantNMF(
            f['M'], f['A'], h_init='correlate', backend='jax_fft', device=DEVICE,
            **kw).set_dictionary(W),
         f['S'], 8, SERVE_ITER, ('mu_ratio', 1), dict(sparsity_H=f['sparsity']), {}),
        ('HALS plain NMF', lambda **kw: TransformInvariantNMF(
            hp['M'], (hp['F'],), reconstruction_mode='full', h_init='correlate',
            device=DEVICE, **kw).set_dictionary(W_plain),
         (hp['F'],), hp['N'], SERVE_HALS_ITER, ('hals_sweep', 1), {},
         dict(solver='hals', hals_inner=1)),
        ('HALS shift-invariant flagship', lambda **kw: TransformInvariantNMF(
            hc['M'], hc['A'], reconstruction_mode='full', h_init='correlate', device=DEVICE,
            **kw).set_dictionary(W_conv),
         hc['S'], 8, SERVE_HALS_ITER, ('hals_sweep', math.prod(hc['A'])),
         dict(sparsity_H=hc['sparsity']), dict(solver='hals')),
    ]
    out = {}
    for label, make, S, b, n_iter, kernel, regs, solver in kinds:
        served, model, seconds, size, path = _export(
            make, S, label, n_iterations=n_iter, **regs,
            **({'solver': 'hals'} if solver else {}))
        V = torch.as_tensor(np.random.default_rng(SEED + 71).random(
            (b, 1) + S, dtype=np.float32), device=DEVICE)
        fit = dict(regs, **solver)
        refs = dict(use_pallas_false=lambda: make(use_pallas=False).transform(
            V, n_iterations=n_iter, **fit))
        limit = None
        if solver:  # HALS: against float64 too, within phase 16's margin
            plain32 = refs['use_pallas_false']()
            H64 = make(dtype=torch.float64).transform(V.double(), n_iterations=n_iter, **fit)
            margin = max(HALS_TOL, 2 * _rel(plain32, H64))
            refs = dict(use_pallas_false=lambda: plain32, float64=lambda: H64)
            limit = dict(use_pallas_false=margin, float64=margin)
        _, launches, rel, peak = _serve_check(label, served, model, V, n_iter, kernel, refs,
                                              fit, limit)
        for name, n in launches.items():
            total[name] += n
        times = _request_ms(served, model, V, n_iter, fit, reps=2)
        times.update(request_mib=peak, export_s=seconds,
                     file_bytes=size, batch=b, rel=rel,
                     launches_per_iteration={k: n / n_iter for k, n in launches.items() if n})
        out[label] = times
        log(f'serving {label}, batch {b} ({card()}): artifact {times["ms"]:.4f} ms per '
            f'request ({times["ms_per_iteration"]:.4f} ms per iteration), transform '
            f'{times["transform_ms"]:.4f} ms ({times["transform_ms_per_iteration"]:.4f}); '
            f'host {times["host_ms"]:.3f} ms; the request\'s own peak {peak:.0f} MiB')
        path.unlink()
        del served, model, V
    return out


def _flagship_dictionary() -> np.ndarray:
    """Phase 5's dictionary, for a phase run alone: the same fit of the
    flagship, plain."""
    f = FLAGSHIP
    nmf = TransformInvariantNMF(f['M'], f['A'], reconstruction_mode=f['mode'], seed=SEED,
                                device=DEVICE)
    nmf.fit(np.random.default_rng(SEED).random((f['N'], f['C']) + f['S'], dtype=np.float32),
            n_iterations=N_ITER, sparsity_H=f['sparsity'])
    return nmf.W


def _serve_default(W: np.ndarray, total: dict) -> dict:
    """One request of the conv flagship's artifact exported at
    ``precision='default'``: the header records the level, K3 runs its
    one-pass route once per iteration, and H is bit-equal to ``transform``
    at 'default'."""
    f = FLAGSHIP
    fit = dict(sparsity_H=f['sparsity'])

    def make(use_pallas=None):
        return TransformInvariantNMF(f['M'], f['A'], h_init='correlate', device=DEVICE,
                                     precision='default',
                                     use_pallas=use_pallas).set_dictionary(W)
    served, model, seconds, size, path = _export(make, f['S'], 'conv flagship at default',
                                                 n_iterations=SERVE_ITER, **fit)
    if served.precision != 'default':
        raise AssertionError(f'the artifact records precision {served.precision!r}')
    V = torch.as_tensor(np.random.default_rng(SEED + 1).random(
        (8, f['C']) + f['S'], dtype=np.float32), device=DEVICE)
    H, launches, rel, peak = _serve_check(
        'conv flagship at default', served, model, V, SERVE_ITER, ('mu_h', 1),
        dict(use_pallas_false=lambda: make(use_pallas=False).transform(
            V, n_iterations=SERVE_ITER, **fit)), fit, dict(use_pallas_false=TF32_FIT_TOL),
        also=('mu_h_1pass',))
    H_t = model.transform(V, n_iterations=SERVE_ITER, **fit)
    if not np.array_equal(H.cpu().numpy(), H_t):
        raise AssertionError('serving at default: H is not bit-equal to transform at default')
    for name, n in launches.items():
        total[name] += n
    path.unlink()
    return dict(export_s=seconds, file_bytes=size, request_mib=peak, rel=rel, bit_equal=True,
                launches_per_iteration={k: n / SERVE_ITER for k, n in launches.items() if n})


def phase_serving(W: np.ndarray = None) -> tuple:
    """Phase 17: the serving artifact on the kernels (K3, K4, K1's ratio and
    K5 as custom operators in a ``torch.export`` program), against phase
    5's dictionary ``W`` (run alone: the same fit of the flagship, plain);
    returns the launches and the measurements."""
    W = _flagship_dictionary() if W is None else W
    total = dict.fromkeys(KERNELS, 0)
    out = {'conv flagship': _serve_flagship(W, total)}
    out.update(_serve_kinds(W, total))
    out['conv flagship at default'] = _serve_default(W, total)
    missing = [name for name in ('mu_h', 'inhibited_mu_h', 'mu_ratio', 'hals_sweep')
               if not total[name]]
    if missing:
        raise AssertionError(f'phase 17 launched no {missing}')
    return total, out


# ------------------------------------------------------ phase 18: precision

#: the values of ``precision``; each path is timed at None and 'default'
LEVELS = (None, 'default', 'high', 'highest')
#: the levels that run TF32 on the card
TF32_LEVELS = ('default', 'high')
#: iterations of each MU fit at each level and of its float64 reference
PRECISION_ITER = 10
#: at 'default': the MU fits' energies (relative) and W and H (relative
#: Frobenius norm) against the float64 fit, and the goldens' energies
PRECISION_ENERGY_TOL = 1e-3
PRECISION_FACTOR_TOL = 5e-3
PRECISION_GOLDEN_RTOL = 1e-3
#: two fits at a TF32 level whose float32 sums differ in order (kernels
#: against ``use_pallas=False``): rounding the operands to 10 bits turns a
#: float32 difference into one of up to 2**-11 of an operand
TF32_FIT_TOL = 1e-3


def _frobenius(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


def _level_fits(label, make, run, expected: dict, one_pass: tuple, total: dict,
                per: int = PRECISION_ITER) -> tuple:
    """``run(make(level))`` at every level, counts reset before and read
    after each: ``expected`` launches at every level, each route of
    ``one_pass`` launched as often as its wrapper at the TF32 levels and
    never at the others; W and H at 'default' bit-equal to 'high', at
    'highest' to None.  Returns the models and the launches per iteration
    at 'default' (over ``per`` iterations)."""
    models = {}
    for level in LEVELS:
        nmf = make(level)
        sync()
        reset_counts()
        run(nmf)
        sync()
        launches = counts()
        want = dict.fromkeys(KERNELS, 0)
        want.update(expected)
        want.update({name: expected[name.removesuffix('_1pass')] if level in TF32_LEVELS else 0
                     for name in one_pass})
        log(f'{label} at {level!r}: launches {({k: v for k, v in launches.items() if v})}; '
            f'energy {nmf._energy_function()!r}')
        if launches != want:
            raise AssertionError(f'{label} at {level!r}: launches {launches}, not {want}')
        for name, n in launches.items():
            total[name] += n
        models[level] = nmf
        if level == 'default':
            at_default = {k: v / per for k, v in launches.items() if v}
    for a, b in (('default', 'high'), ('highest', None)):
        same = all(np.array_equal(x, y) for x, y in ((models[a].W, models[b].W),
                                                      (models[a].H, models[b].H)))
        log(f'{label}: {a!r} {"bit-equal to" if same else "DIFFERS from"} {b!r}')
        if not same:
            raise AssertionError(f'{label}: precision {a!r} is not bit-equal to {b!r}')
    return models, at_default


def _f64_distance(label, models: dict, ref, hold: bool = True) -> dict:
    """The energy (relative) and W and H (relative Frobenius norm) of the
    fits at None and 'default' against the float64 fit ``ref``; at
    'default' held within 1e-3 and 5e-3 when ``hold``."""
    e64 = ref._energy_function()
    out = {}
    for level in (None, 'default'):
        m = models[level]
        out[str(level)] = dict(energy=abs(m._energy_function() - e64) / abs(e64),
                               W=_frobenius(m.W, ref.W), H=_frobenius(m.H, ref.H))
    d = out['default']
    log(f'{label} against float64 after its iterations: at default energy {d["energy"]:.3e}, '
        f'W {d["W"]:.3e}, H {d["H"]:.3e}; at None energy {out["None"]["energy"]:.3e}, W '
        f'{out["None"]["W"]:.3e}, H {out["None"]["H"]:.3e}'
        + ('' if hold else ' (printed, not held)'))
    if hold and not (d['energy'] <= PRECISION_ENERGY_TOL and max(d['W'], d['H'])
                     <= PRECISION_FACTOR_TOL):
        raise AssertionError(f'{label} at default: {d} off float64 (> {PRECISION_ENERGY_TOL} '
                             f'energy, {PRECISION_FACTOR_TOL} W and H?)')
    return out


def _in_turns(label, models: dict, timer) -> dict:
    """``timer(model)`` at None and 'default' in turns (None, default,
    default, None): ms per iteration."""
    t = [timer(models[level]) for level in (None, 'default', 'default', None)]
    out = {'None': (t[0] + t[3]) / 2, 'default': (t[1] + t[2]) / 2}
    log(f'{label} ({card()}): {out["default"]:.4f} ms per iteration at default '
        f'({t[1]:.4f}/{t[2]:.4f}), {out["None"]:.4f} at None ({t[0]:.4f}/{t[3]:.4f}), in turns')
    return out


def _default_split(nmf) -> dict:
    """One conv iteration at 'default' by call (ms, CUDA events): the cuDNN
    reconstruction with TF32 on (and off, for comparison), K3 and K2 on
    their one-pass routes, K1's W epilogue."""
    W, H, plan, Vp = nmf._W, nmf._H, nmf._plan, nmf._Vp
    fp32_plan = ConvPlan.create(plan.mode, plan.sample_shape, plan.atom_shape)
    R = conv.reconstruct(W, H, plan)
    Rx = conv.extend_data(R, plan)
    X2 = torch.cat([Vp, Rx], dim=1)
    neg, pos = gw.grad_w(X2, H, 1)
    parts = {
        'reconstruct (cuDNN, TF32 on)': lambda: conv.reconstruct(W, H, plan),
        'reconstruct (cuDNN, TF32 off)': lambda: conv.reconstruct(W, H, fp32_plan),
        'extend + stack': lambda: torch.cat([Vp, conv.extend_data(R, plan)], dim=1),
        'mu_h one pass': lambda: mu_h.mu_h(Vp, Rx, W, H, engine.EPS + 0.1, None, 1),
        'grad_w one pass': lambda: gw.grad_w(X2, H, 1),
        'mu_w': lambda: mu.mu_w(W, neg.contiguous(), pos.contiguous(), engine.EPS, plan.ndim),
    }
    out = {name: time_ms(fn) for name, fn in parts.items()}
    log(f'  conv flagship at default, by call ({card()}): '
        + ', '.join(f'{k} {v:.4f} ms' for k, v in out.items()))
    return out


def _precision_goldens() -> None:
    """The golden fixtures at 'default' on the kernels: energies (and the
    sweep's L1) within 1e-3 of tests/golden_values.json."""
    goldens = json.loads((ROOT / 'tests' / 'golden_values.json').read_text())
    fits = [('2d/valid', _image_2d, dict(n_atoms=10, atom_shape=(7, 7)),
             dict(sparsity_H=0.1), goldens['2d']['valid'], None)]
    fits += [(f'1d/{mode}', _signal_1d,
              dict(n_atoms=3, atom_shape=(20,), reconstruction_mode=mode),
              dict(inhibition_strength=0.1), golden, None)
             for mode, golden in goldens['1d'].items()]
    for params in SPARSITY_INHIBITION:
        key = ','.join(f'{k}={v}' for k, v in sorted(params.items())) or 'plain'
        golden = goldens['sparsity_inhibition'][key]
        fits.append((f'sparsity_inhibition {key}', _image_2d,
                     dict(n_atoms=5, atom_shape=(5, 5)), params, golden['energy'], golden['l1']))
    for key, data, init, fit, golden, l1 in fits:
        np.random.seed(42)
        nmf = TransformInvariantNMF(**init, precision='default', device=DEVICE)
        reset_counts()
        nmf.fit(data(), n_iterations=10, **fit)
        sync()
        launches = counts()
        got = {'energy': (nmf._energy_function(), golden)}
        if l1 is not None:
            got['L1'] = (float(np.abs(nmf.H).sum(dtype=np.float64)), l1)
        rel = {k: abs(a - b) / abs(b) for k, (a, b) in got.items()}
        log(f'  golden {key} at default: ' + ', '.join(
            f'{k} {a!r} vs {b!r} (rel {rel[k]:.3e})' for k, (a, b) in got.items())
            + f'; one-pass launches K2 {launches["grad_w_1pass"]}, K3 {launches["mu_h_1pass"]}')
        if not (all(v <= PRECISION_GOLDEN_RTOL for v in rel.values())
                and launches['grad_w_1pass'] == 10):
            raise AssertionError(f'golden {key} at default: {rel} (> {PRECISION_GOLDEN_RTOL}?) '
                                 f'or launches {launches}')


def phase_precision(W: np.ndarray = None) -> tuple:
    """Phase 18: every path at every level (``_level_fits``), the MU fits
    at 'default' against float64, times at None and 'default' in turns,
    the split of a conv iteration at 'default' and the goldens at
    'default', with phase 5's dictionary ``W`` for ``transform`` (run
    alone: the same fit); returns the launches and the measurements."""
    W = _flagship_dictionary() if W is None else W
    f, d, hp = FLAGSHIP, DOT, HALS_PLAIN
    total = dict.fromkeys(KERNELS, 0)
    out = {}
    n = PRECISION_ITER
    V = np.random.default_rng(SEED).random((f['N'], f['C']) + f['S'], dtype=np.float32)
    plain = dict(sparsity_H=f['sparsity'])
    inhibited = dict(sparsity_H=f['sparsity'], inhibition_strength=f['inhibition'])

    def flagship(backend='auto', **fit):
        def make(level, dtype=torch.float32):
            return TransformInvariantNMF(f['M'], f['A'], backend=backend, seed=SEED,
                                         precision=level, dtype=dtype, device=DEVICE)
        return make, lambda m: m.fit(V, n_iterations=n, **fit)

    for label, backend, fit, expected, one_pass in (
            ('conv flagship plain', 'auto', plain, dict(mu_h=n, grad_w=n, mu_w=n),
             ('mu_h_1pass', 'grad_w_1pass')),
            ('conv flagship inhibited', 'auto', inhibited,
             dict(inhibited_mu_h=n, grad_w=n, mu_w=n), ('grad_w_1pass',)),
            ('fft flagship', 'jax_fft', plain, dict(mu_ratio=n, mu_w=n), ())):
        make, run = flagship(backend, **fit)
        models, at_default = _level_fits(label, make, run, expected, one_pass, total)
        ref = make(None, torch.float64)
        run(ref)
        out[label] = dict(float64=_f64_distance(label, models, ref),
                          ms=_in_turns(label, models, lambda m: _ms_per_iteration(m, fit)),
                          launches_per_iteration_at_default=at_default)
        if label == 'conv flagship plain':
            out[label]['split_at_default'] = _default_split(models['default'])
        del models, ref

    # transform: H-only iterations against phase 5's dictionary, on new data
    Ve = np.random.default_rng(SEED + 1).random((f['N'], f['C']) + f['S'], dtype=np.float32)

    def encoder(level, dtype=torch.float32):
        return TransformInvariantNMF(f['M'], f['A'], seed=SEED, precision=level, dtype=dtype,
                                     device=DEVICE).set_dictionary(W)

    def encode(m):
        m.transform(Ve, n_iterations=n, **plain)
    models, at_default = _level_fits('transform', encoder, encode, dict(mu_h=n), ('mu_h_1pass',),
                                     total)
    ref = encoder(None, torch.float64)
    encode(ref)
    out['transform'] = dict(float64=_f64_distance('transform', models, ref),
                            ms=_in_turns('transform', models, lambda m: _h_only_ms(m, plain)),
                            launches_per_iteration_at_default=at_default)
    del models, ref, Ve, V

    V = np.random.default_rng(SEED).random((d['N'], d['C']) + d['S'], dtype=np.float32)
    fit = dict(sparsity_H=d['sparsity'])

    def dot(level, dtype=torch.float32):
        return TransformInvariantNMF(d['M'], d['S'], reconstruction_mode='full', seed=SEED,
                                     precision=level, dtype=dtype, device=DEVICE)

    def run_dot(m):
        m.fit(V, n_iterations=n, **fit)
    models, _ = _level_fits('dot 16384x1x4096/256', dot, run_dot, dict(mu_ratio=n, mu_w=n), (),
                            total)
    ref = dot(None, torch.float64)
    run_dot(ref)
    out['dot'] = dict(float64=_f64_distance('dot', models, ref),
                      ms=_in_turns('dot', models, lambda m: _ms_per_iteration(m, fit)))
    del models, ref, V

    V = np.random.default_rng(SEED + 50).random((hp['N'], 1, hp['F']), dtype=np.float32)
    inner = engine_hals.auto_inner(hp['M'], hp['F'], 'auto', n_samples=hp['N'])

    def hals_model(level, dtype=torch.float32):
        return TransformInvariantNMF(hp['M'], (hp['F'],), reconstruction_mode='full',
                                     seed=SEED, precision=level, dtype=dtype, device=DEVICE)

    def run_hals(m):
        m.fit(V, n_iterations=HALS_ITER, solver='hals')

    def hals_ms(m):
        def loop(k):
            m._W, m._H = engine_hals.fit_loop(m._Vd, m._W, m._H, k, 0., 0., 0., 0., inner=inner,
                                              update_H=True, update_W=True, plan=m._plan)
        return _hals_ms(loop)
    label = f'HALS plain NMF {hp["N"]}x1x{hp["F"]}/{hp["M"]}'
    models, _ = _level_fits(label, hals_model, run_hals, dict(hals_sweep=2 * HALS_ITER), (),
                            total, HALS_ITER)
    ref = hals_model(None, torch.float64)
    run_hals(ref)
    # the W sweep amplifies rounding (PERF.md section 6): printed, not held
    out['hals_plain'] = dict(float64=_f64_distance(label, models, ref, hold=False),
                             ms=_in_turns(label, models, hals_ms))
    del models, ref, V

    log('golden fixtures at default:')
    _precision_goldens()
    missing = [name for name in ('grad_w_1pass', 'mu_h_1pass') if not total[name]]
    if missing:
        raise AssertionError(f'phase 18 launched no {missing}')
    return total, out


# ----------------------------------------------------------- phase 19: sweeps

#: iterations of the sweep runs (a) and (d), of (b), (c) and (e) (fewer, to
#: keep the whole script near 10 minutes), and of the timed sweeps (by
#: difference of 2n and n iterations)
SWEEP_ITER = 10
SWEEP_SHORT_ITER = 3
SWEEP_TIMED = 5
#: a sweep's models against their single fits and against the plain sweep
#: (max|a - b| / max|b| of W and H per model, and of the energies)
SWEEP_TOL = 1e-4
#: (d) the golden 2-D fixture: models; the tol run's n_iterations, tol, check
SWEEP_GOLDEN_MODELS = 64
SWEEP_GOLDEN_TOL = dict(n_iterations=60, tol=1e-5, tol_check_every=5)
#: (e) plain NMF on dot
SWEEP_DOT = dict(N=16384, F=4096, M=256, models=4)
#: (f) plain-NMF HALS at the repository's size (BASELINE.md:62), 4 models of
#: an alpha grid; (g) a launch-bound alpha grid of 64 models (also with tol
#: and record_energies)
SWEEP_HALS = dict(N=16384, F=4096, M=256, sparsity=[0.0, 0.05, 0.1, 0.2], l2=0.1)
SWEEP_HALS_GRID = dict(N=1024, F=256, M=16, models=64, sparsity_max=0.3)
SWEEP_HALS_TOL = dict(n_iterations=60, tol=1e-5, tol_check_every=5)


def _rel_t(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def model_counts() -> dict:
    """Each kernel's launches over a model axis (0 for a row that counts
    another route, or a kernel without a model axis)."""
    return {name: 0 if 'count' in k else getattr(k['wrapper'], 'model_launches', 0)
            for name, k in KERNELS.items()}


def _sweep_reference(V, M, A, models: int, seeds, kw: dict):
    """What each model of a sweep starts from and runs on: the S inits
    drawn as ``sweep_fit`` draws them (``seeds``: a vector of per-model
    seeds, or the scalar seed of one generator), and a model of the same
    configuration set up by ``fit(V, n_iterations=0)`` for its plan,
    strategy, prepared data and inhibition taps."""
    backend = {'fft': 'jax_fft', 'conv': 'jax_conv'}.get(kw.get('strategy'), 'auto')
    ref = TransformInvariantNMF(M, A, device=DEVICE, backend=backend, init='device',
                                reconstruction_mode=kw.get('reconstruction_mode', 'valid'),
                                inhibition_range=kw.get('inhibition_range'))
    ref.fit(V, n_iterations=0)
    gens = [torch.Generator(device=DEVICE).manual_seed(int(x)) for x in np.atleast_1d(seeds)]
    W0, H0 = sweep._draw(gens, models, tuple(ref._W.shape), tuple(ref._H.shape),
                         ref._plan.ndim, torch.float32, torch.device(DEVICE))
    return ref, W0, H0


def _sweep_run(label, V, M, A, expected: tuple, seeds, kw: dict, n_iter: int):
    """One sweep of ``n_iter`` iterations through ``sweep_fit`` (counts
    reset before and read after: each of ``expected`` launched once per
    iteration over the model
    axis, no other kernel), its models held within 1e-4 of their single
    fits from the same inits on the kernels (``engine.fit_loop``, float
    strengths) and of the same sweep with ``use_pallas=False``; ms per
    sweep iteration beside the S single fits' in turns (CUDA events), peak
    memory and the reconstruction's ms per call.  Returns the run's
    numbers, the sweep's result and the single fits' model."""
    vec = np.ndim(seeds) > 0
    models = len(seeds) if vec else kw.pop('n_models')
    seed_kw = dict(seed=np.asarray(seeds)) if vec else dict(n_models=models, seed=seeds)
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = sweep_fit(V, M, A, n_iterations=n_iter, device=DEVICE, **seed_kw, **kw)
    sync()
    launches, on_axis = counts(), model_counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    want = dict.fromkeys(KERNELS, 0)
    want.update(dict.fromkeys(expected, n_iter))
    if launches != want or any(on_axis[k] != n_iter for k in expected):
        raise AssertionError(f'{label}: launches {launches} ({on_axis} over the model axis), '
                             f'not {want}: each kernel once per iteration for all {models}')
    E = res.energies
    if tuple(E.shape) != (models,) or not bool(torch.isfinite(E).all()):
        raise AssertionError(f'{label}: energies {E}')
    plain = sweep_fit(V, M, A, n_iterations=n_iter, device=DEVICE, use_pallas=False,
                      **seed_kw, **kw)
    off_plain = max(max(_rel_t(res.W[s], plain.W[s]), _rel_t(res.H[s], plain.H[s]))
                    for s in range(models))
    off_plain_e = _rel_t(E, plain.energies)
    del plain
    ref, W0, H0 = _sweep_reference(V, M, A, models, seeds, kw)
    sp, inh, cross = (np.broadcast_to(np.asarray(kw.get(k, 0.), np.float32), (models,))
                      for k in ('sparsity', 'inhibition', 'cross_inhibition'))
    flags = dict(plan=ref._plan, strategy=ref._strategy, use_inhibition=bool(np.any(inh > 0)),
                 use_cross=bool(np.any(cross > 0)))

    def single(s, n=n_iter):
        return engine.fit_loop(ref._Vp, W0[s], H0[s], n, float(sp[s]), float(inh[s]),
                               float(cross[s]), ref._kernels, **flags)
    off_single, equal = 0., True
    for s in range(models):
        Ws, Hs = single(s)
        Es = engine.energy(ref._Vd, Ws, Hs, plan=ref._plan, strategy=ref._strategy)
        off_single = max(off_single, _rel_t(res.W[s], Ws), _rel_t(res.H[s], Hs),
                         abs(float(E[s]) - float(Es)) / abs(float(Es)))
        equal = equal and torch.equal(res.W[s], Ws) and torch.equal(res.H[s], Hs)
    log(f'{label}: {models} models, {n_iter} iterations, peak {peak:.0f} MiB; launches '
        f'{ {k: v for k, v in launches.items() if v} } (all over the model axis); models off '
        f'their single fits {off_single:.3e} (bit-equal: {equal}), off the plain sweep '
        f'{off_plain:.3e} (energies {off_plain_e:.3e}); energies {E.tolist()}')
    if not max(off_single, off_plain, off_plain_e) <= SWEEP_TOL:
        raise AssertionError(f'{label}: models off their single fits {off_single:.3e}, off '
                             f'the plain sweep {off_plain:.3e} / {off_plain_e:.3e} '
                             f'(> {SWEEP_TOL})')

    def run_sweep(n):
        return sweep._sweep_from_init(V, W0, H0, n_iterations=n, device=DEVICE,
                                      seeds=res.seeds, **kw)

    def sweep_ms():
        return (time_ms(lambda: run_sweep(2 * SWEEP_TIMED), reps=1)
                - time_ms(lambda: run_sweep(SWEEP_TIMED), reps=1)) / SWEEP_TIMED

    def singles_ms():
        return time_ms(lambda: [single(s, SWEEP_TIMED) for s in range(models)],
                       reps=1) / SWEEP_TIMED
    t = [fn() for fn in (sweep_ms, singles_ms, singles_ms, sweep_ms)]
    plan, strategy = ref._plan, ref._strategy
    vrec = torch.func.vmap(lambda W, H: engine.reconstruct(W, H, plan=plan, strategy=strategy))
    rec = time_ms(lambda: vrec(res.W, res.H))
    rec1 = time_ms(lambda: engine.reconstruct(res.W[0], res.H[0], plan=plan, strategy=strategy))
    out = dict(models=models, sweep_ms_per_iteration=(t[0] + t[3]) / 2,
               singles_ms_per_iteration=(t[1] + t[2]) / 2, peak_mib=peak,
               reconstruction_ms=rec, single_reconstruction_ms=rec1,
               off_single_fits=off_single, bit_equal_to_single_fits=equal,
               off_plain_sweep=max(off_plain, off_plain_e),
               iterations=n_iter,
               launches_per_iteration={k: v / n_iter for k, v in launches.items() if v})
    log(f'{label} ({card()}): sweep {t[0]:.4f}/{t[3]:.4f} ms per iteration for all '
        f'{models} models, {models} single fits {t[1]:.4f}/{t[2]:.4f} ms per iteration, in '
        f'turns; reconstruction {rec:.4f} ms per call ({models} models batched), one '
        f'model\'s {rec1:.4f} ms')
    return out, res, ref


def _sweep_golden_loops(V, res, kw: dict) -> dict:
    """The golden fixture's sweep with ``tol`` over a grid of sparsities
    (n_iters per model; each kernel launched once per iteration the sweep
    ran) and with
    ``record_energies`` (traces of every iteration, the last the final
    energy, the state that of the plain sweep run)."""
    models = SWEEP_GOLDEN_MODELS
    reset_counts()
    # a grid of sparsities, so that the models converge at different blocks
    grid = dict(kw, sparsity=np.linspace(0., 1., models, dtype=np.float32))
    tolled = sweep_fit(V, 10, (7, 7), n_models=models, seed=SEED, device=DEVICE, **grid,
                       **SWEEP_GOLDEN_TOL)
    sync()
    n_iters = tolled.n_iters.tolist()
    ran, per = max(n_iters), SWEEP_GOLDEN_TOL['tol_check_every']
    launches = {k: v for k, v in counts().items() if v}
    log(f'golden sweep, tol {SWEEP_GOLDEN_TOL["tol"]}: n_iters per model {n_iters}; the sweep '
        f'ran {ran} iterations; launches {launches}')
    if (any(n % per and n != SWEEP_GOLDEN_TOL['n_iterations'] for n in n_iters)
            or any(v != ran for v in launches.values())
            or not bool(torch.isfinite(tolled.energies).all())):
        raise AssertionError(f'golden sweep with tol: n_iters {n_iters}, launches {launches}')
    reset_counts()
    traced = sweep_fit(V, 10, (7, 7), n_models=models, seed=SEED, n_iterations=SWEEP_ITER,
                       record_energies=True, device=DEVICE, **kw)
    sync()
    tr = traced.energy_traces
    same = torch.equal(traced.W, res.W) and torch.equal(traced.H, res.H)
    launches = {k: v for k, v in counts().items() if v}
    log(f'golden sweep, record_energies: traces {tuple(tr.shape)}, state bit-equal to the '
        f'sweep without traces: {same}; launches {launches}')
    if (tuple(tr.shape) != (models, SWEEP_ITER) or not torch.equal(tr[:, -1], traced.energies)
            or _rel_t(traced.W, res.W) > 1e-6 or _rel_t(traced.energies, res.energies) > 1e-6
            or any(v != SWEEP_ITER for v in launches.values())):
        raise AssertionError('golden sweep with record_energies: traces or state differ')
    return dict(n_iters=n_iters, traced_bit_equal=same)


def _hals_sweep_run(label, V, M: int, kw: dict, n_iter: int, n_check: int) -> tuple:
    """One HALS sweep (``sweep_fit(solver='hals')``, plain NMF in 'full'
    mode) of ``n_iter`` iterations, counts reset before and read after: K5
    twice per iteration over the model axis (the H side, then the W side)
    for all the models, no other kernel.  Then, from the sweep's own inits,
    ``n_check`` iterations of the sweep on the kernels against each
    model's single fit on the kernels (``engine_hals.fit_loop``, float
    strengths): each model within ``SWEEP_TOL`` (the sweep forms each
    model's Gram products alone, so bit-equal is expected and printed);
    against the same sweep with ``use_pallas=False`` and against the sweep
    in float64 (the plain versions): each model within ``SWEEP_TOL``, or,
    where K5's float32 rounding against its plain version's moves a model
    farther (C1: the nearly rank-one W-side Gram of plain NMF), no farther
    from float64 than twice the plain sweep is (phase 16's rule, the plain
    versions' distance taken over the sweep's models as phase 16 takes it
    over a fit); energies within ``SWEEP_TOL``; the Gram products'
    rounding, as the sweep forms them and one model at a time, printed.
    Then ms per sweep iteration beside the S single fits' in turns (CUDA
    events) and peak memory.  Returns the run's numbers and the sweep's
    result."""
    models = kw.pop('n_models')
    fit = dict(reconstruction_mode='full', solver='hals', **kw)
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = sweep_fit(V, M, tuple(V.shape[2:]), n_models=models, seed=SEED, n_iterations=n_iter,
                    device=DEVICE, **fit)
    sync()
    launches, on_axis = counts(), model_counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    want = dict.fromkeys(KERNELS, 0)
    want['hals_sweep'] = 2 * n_iter
    if launches != want or on_axis['hals_sweep'] != 2 * n_iter:
        raise AssertionError(f'{label}: launches {launches} ({on_axis} over the model axis), '
                             f'not {want}: K5 twice per iteration for all {models} models')
    E = res.energies
    if tuple(E.shape) != (models,) or not bool(torch.isfinite(E).all()):
        raise AssertionError(f'{label}: energies {E}')
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    W0, H0 = sweep._draw([gen], models, tuple(res.W.shape[1:]), tuple(res.H.shape[1:]), 1,
                         torch.float32, torch.device(DEVICE))
    strengths = dict(sparsity=kw.get('sparsity', 0.), l2=kw.get('l2', 0.))
    inner = engine_hals.auto_inner(M, math.prod(V.shape[1:]), kw.get('hals_inner', 'auto'),
                                   n_samples=V.shape[0])

    def run(n, V=V, W0=W0, H0=H0, **more):
        return sweep._sweep_from_init_hals(V, W0, H0, n_iterations=n, device=DEVICE,
                                           **strengths, **more)
    again = run(n_iter)
    if not (torch.equal(again.W, res.W) and torch.equal(again.H, res.H)):
        raise AssertionError(f'{label}: the sweep from its own inits differs from sweep_fit')
    del again
    kern, plain = run(n_check), run(n_check, use_pallas=False)
    exact = run(n_check, V=V.double(), W0=W0.double(), H0=H0.double())
    sp, l2 = (np.broadcast_to(np.asarray(strengths[k], np.float32), (models,))
              for k in ('sparsity', 'l2'))

    def single(s, n):
        return engine_hals.fit_loop(V, W0[s], H0[s], n, float(sp[s]), float(l2[s]), 0., 0.,
                                    inner=inner, update_H=True, update_W=True)

    def off(a, b):  # W and H of one model, each (W, H)
        return max(_rel_t(a[0].double(), b[0].double()), _rel_t(a[1].double(), b[1].double()))
    rows, off_e = [], _rel_t(kern.energies, plain.energies)
    for s in range(models):
        one = single(s, n_check)
        k, p_, x = ((r.W[s], r.H[s]) for r in (kern, plain, exact))
        row = dict(off_plain=off(k, p_), off_single=off(k, one), kernels_float64=off(k, x),
                   plain_float64=off(p_, x), single_float64=off(one, x),
                   bit_equal_single=bool(torch.equal(k[0], one[0]) and torch.equal(k[1], one[1])))
        rows.append(row)
        Es = engine_hals._energy(*engine_hals._flatten(V, *one))
        off_e = max(off_e, abs(float(kern.energies[s]) - float(Es)) / abs(float(Es)))
    worst = {k: max(r[k] for r in rows) for k in rows[0] if k != 'bit_equal_single'}
    # the plain versions' own distance from float64, over the sweep (phase
    # 16 takes it over a fit's W and H)
    limit = max(SWEEP_TOL, 2 * worst['plain_float64'])
    c1 = [s for s, r in enumerate(rows) if r['off_plain'] > SWEEP_TOL]
    off_single = [s for s, r in enumerate(rows) if not r['off_single'] <= SWEEP_TOL]
    log(f'{label}: {models} models, {n_iter} iterations, inner {inner}, peak {peak:.0f} MiB; '
        f'launches {launches} ({on_axis["hals_sweep"]} over the model axis); at {n_check} '
        f'iterations, worst over the models: off the plain sweep {worst["off_plain"]:.3e} '
        f'(energies {off_e:.3e}), off their single fits {worst["off_single"]:.3e} '
        f'(bit-equal: {all(r["bit_equal_single"] for r in rows)}); from float64: kernels '
        f'{worst["kernels_float64"]:.3e}, plain {worst["plain_float64"]:.3e}, single fits '
        f'{worst["single_float64"]:.3e}; models past {SWEEP_TOL} (C1 rule, limit '
        f'{limit:.3e} from float64): {c1}; energies {E.tolist()}')
    log(f'{label}: per model, from float64, kernels/plain/single fits: '
        + ', '.join(f'{r["kernels_float64"]:.2e}/{r["plain_float64"]:.2e}/'
                    f'{r["single_float64"]:.2e}' for r in rows))
    gram_errors = _hals_gram_errors(V, W0, H0)
    bad = [s for s in c1 if rows[s]['kernels_float64'] > limit]
    if bad or off_single or not off_e <= SWEEP_TOL:
        raise AssertionError(f'{label}: models {off_single} more than {SWEEP_TOL} off their '
                             f'single fits, models {bad} off the plain sweep and float64 '
                             f'beyond the C1 limit {limit:.3e} '
                             f'({[rows[s] for s in set(bad) | set(off_single)]}), or '
                             f'energies {off_e:.3e} off the plain sweep or the single fits')
    del kern, plain, exact

    def sweep_ms():
        return (time_ms(lambda: run(2 * SWEEP_TIMED), reps=1)
                - time_ms(lambda: run(SWEEP_TIMED), reps=1)) / SWEEP_TIMED

    def singles_ms():
        return time_ms(lambda: [single(s, SWEEP_TIMED) for s in range(models)],
                       reps=1) / SWEEP_TIMED
    t = [fn() for fn in (sweep_ms, singles_ms, singles_ms, sweep_ms)]
    out = dict(models=models, inner=inner, sweep_ms_per_iteration=(t[0] + t[3]) / 2,
               singles_ms_per_iteration=(t[1] + t[2]) / 2, peak_mib=peak,
               check_iterations=n_check, worst=worst, c1_models=c1, c1_limit=limit,
               gram_errors=gram_errors,
               off_plain_energies=off_e, iterations=n_iter,
               launches_per_iteration={k: v / n_iter for k, v in launches.items() if v})
    log(f'{label} ({card()}): sweep {t[0]:.4f}/{t[3]:.4f} ms per iteration for all '
        f'{models} models, {models} single fits {t[1]:.4f}/{t[2]:.4f} ms per iteration, in '
        f'turns')
    return out, res


def _hals_gram_errors(V, W0, H0) -> dict:
    """The four Gram products of a HALS iteration at the sweep's inits,
    as the sweep forms them (under vmap: ``tnmf::matmul``, one product per
    model) and one model at a time as a single fit does, each against
    float64: max|G - G64| / max|G64| over the models."""
    V2 = V.reshape(V.shape[0], -1)
    W2, H2 = W0.reshape(W0.shape[0], W0.shape[1], -1), H0.reshape(H0.shape[:3])

    def grams(V2, W2, H2):
        return (engine_hals._dot(W2, W2.T), engine_hals._dot(V2, W2.T),
                engine_hals._dot(H2.T, H2), engine_hals._dot(H2.T, V2))
    with matmul_pin(None, DEVICE):
        batched = torch.func.vmap(grams, in_dims=(None, 0, 0))(V2, W2, H2)
        single = [torch.stack(t) for t in zip(*(grams(V2, W2[s], H2[s])
                                                for s in range(W2.shape[0])))]
        exact = torch.func.vmap(grams, in_dims=(None, 0, 0))(V2.double(), W2.double(),
                                                             H2.double())
    out = {name: dict(sweep=_rel_t(b.double(), x), single=_rel_t(o.double(), x))
           for name, b, o, x in zip(('W W^T', 'V W^T', 'H^T H', 'H^T V'), batched, single, exact)}
    log('  Gram products at the inits against float64, the sweep\'s / one model at a '
        'time (single fits): ' + ', '.join(f'{k} {v["sweep"]:.2e}/{v["single"]:.2e}'
                                          for k, v in out.items()))
    return out


def _hals_sweep_loops(V, M: int, res, kw: dict) -> dict:
    """(g) with ``tol`` (n_iters per model; K5 twice per iteration the sweep
    ran, over the model axis) and with ``record_energies`` (traces of every
    iteration, the last the final energy, the state that of the sweep
    without traces)."""
    models = kw['n_models']
    fit = dict(kw, reconstruction_mode='full', solver='hals', seed=SEED, device=DEVICE)
    reset_counts()
    tolled = sweep_fit(V, M, tuple(V.shape[2:]), **fit, **SWEEP_HALS_TOL)
    sync()
    n_iters = tolled.n_iters.tolist()
    ran, per = max(n_iters), SWEEP_HALS_TOL['tol_check_every']
    launches = {k: v for k, v in counts().items() if v}
    log(f'(g) HALS alpha grid, tol {SWEEP_HALS_TOL["tol"]}: n_iters per model {n_iters}; the '
        f'sweep ran {ran} iterations; launches {launches} '
        f'({model_counts()["hals_sweep"]} over the model axis)')
    if (any(n % per and n != SWEEP_HALS_TOL['n_iterations'] for n in n_iters)
            or launches != {'hals_sweep': 2 * ran}
            or model_counts()['hals_sweep'] != 2 * ran
            or not bool(torch.isfinite(tolled.energies).all())):
        raise AssertionError(f'(g) with tol: n_iters {n_iters}, launches {launches}')
    reset_counts()
    traced = sweep_fit(V, M, tuple(V.shape[2:]), n_iterations=SWEEP_ITER, record_energies=True,
                       **fit)
    sync()
    tr = traced.energy_traces
    same = torch.equal(traced.W, res.W) and torch.equal(traced.H, res.H)
    launches = {k: v for k, v in counts().items() if v}
    log(f'(g) HALS alpha grid, record_energies: traces {tuple(tr.shape)}, state bit-equal to '
        f'the sweep without traces: {same}; launches {launches}')
    if (tuple(tr.shape) != (models, SWEEP_ITER) or not torch.equal(tr[:, -1], traced.energies)
            or _rel_t(traced.W, res.W) > 1e-6 or _rel_t(traced.energies, res.energies) > 1e-6
            or launches != {'hals_sweep': 2 * SWEEP_ITER}):
        raise AssertionError('(g) with record_energies: traces or state differ')
    return dict(n_iters=n_iters, traced_bit_equal=same)


#: K5's model-axis launch timed at (f)'s two sides: (where, rows,
#: components, length of the factor the Gram sums over, layout)
K5_MODEL_AXIS_TIMED = [('H side 16384x256', 16384, 256, 4096, 'rows'),
                       ('W side 4096x256', 4096, 256, 16384, 'views')]


def _k5_model_axis_times(S: int = 4) -> dict:
    """K5's model-axis launch at the two sides of (f) (16384 x 256
    row-major, 4096 x 256 on transposed views) against its S single
    launches and its plain version over the models, in turns, with its
    bound (S times the single launch's)."""
    out = {}
    for where, rows, m, length, layout in K5_MODEL_AXIS_TIMED:
        parts = [_k5_inputs(rows, m, length, SEED + 90 + s, layout) for s in range(S)]
        X, G, P = (_k5_stack([p[k] for p in parts], layout) for k in range(3))
        l1 = torch.tensor([0.0, 0.05, 0.1, 0.2][:S], device=DEVICE) / length
        f = l1.tolist()
        m1, s1, s2, m2 = (time_ms(fn, reps=3) for fn in (
            lambda: hals.hals_sweep_models(X, G, P, l1, 0.0, 1),
            lambda: [hals.hals_sweep(X[s], G[s], P[s], f[s], 0.0, 1) for s in range(S)],
            lambda: [hals.hals_sweep(X[s], G[s], P[s], f[s], 0.0, 1) for s in range(S)],
            lambda: hals.hals_sweep_models(X, G, P, l1, 0.0, 1)))
        p = time_ms(lambda: [hals.hals_sweep_plain(X[s], G[s], P[s], f[s], 0.0, 1)
                             for s in range(S)], reps=1)
        bound_ms, bound_by = bound(S * 4 * (3 * rows * m + m * m), S * 2.0 * rows * m * m,
                                   FP32_FLOP_PER_S)
        ms = (m1 + m2) / 2
        out[where] = dict(models=S, ms=ms, single_launches_ms=(s1 + s2) / 2, plain_ms=p,
                          bound_ms=bound_ms, bound_by=bound_by, layout=layout)
        log(f'  hals_sweep     {where} S={S} ({layout}): one launch {m1:.4f}/{m2:.4f} ms, {S} '
            f'single launches {s1:.4f}/{s2:.4f} ms, plain over the models {p:.4f} ms, bound '
            f'{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f} % of bound')
        del X, G, P, parts
    return out


def _sweep_kernel_times() -> dict:
    """Each kernel's model-axis launch at phase 19's shapes against its S
    single launches and its plain version over the models, in turns, with
    its bound: K3, K2 and ``mu_w`` at (a), K4 at (b), ``mu_ratio`` at (c)."""
    f = FLAGSHIP
    rng = np.random.default_rng(SEED + 19)
    plan = ConvPlan.create(f['mode'], f['S'], f['A'])
    T, A, N, C, M = plan.transform_shape, f['A'], f['N'], f['C'], f['M']
    E = tuple(t + a - 1 for t, a in zip(T, A))
    out = {}

    def timed(name, S, models, singles, plain, work):
        m1, s1, s2, m2 = (time_ms(fn, reps=3) for fn in (models, singles, singles, models))
        p = time_ms(plain, reps=1)
        bound_ms, bound_by = bound(*work, OPS_PER_S[name])
        ms = (m1 + m2) / 2
        out[name] = dict(models=S, ms=ms, single_launches_ms=(s1 + s2) / 2, plain_ms=p,
                         bound_ms=bound_ms, bound_by=bound_by)
        log(f'  {name:14s} S={S}: one launch {m1:.4f}/{m2:.4f} ms, {S} single launches '
            f'{s1:.4f}/{s2:.4f} ms, plain over the models {p:.4f} ms, bound {bound_ms:.4f} ms '
            f'({bound_by}), {100 * bound_ms / ms:.1f} % of bound')
    S = 8
    W, H = _stacked(rng, (M, C) + A, S), _stacked(rng, (N, M) + T, S)
    Vp, Rx = _stacked(rng, (N, C) + E, 1)[0], _stacked(rng, (N, C) + E, S)
    regs = engine.EPS + torch.tensor([0.05] * 4 + [0.1] * 4, device=DEVICE)
    r = regs.tolist()
    nT, nA, nH = math.prod(T), math.prod(A), H[0].numel()
    g = mu_h.launch_geometry(Vp, Rx[0], W[0], H[0])[2]
    log(f'  mu_h           S={S}: route {g["route"]}, {g.get("grid_x", 0)} persistent blocks per '
        f'model, each staging its model\'s split dictionary once: {S * g.get("grid_x", 0)} '
        'stagings a launch, no restage')
    timed('mu_h', S, lambda: mu_h.mu_h_models(Vp, Rx, W, H, regs),
          lambda: [mu_h.mu_h(Vp, Rx[s], W[s], H[s], r[s]) for s in range(S)],
          lambda: [mu_h.mu_h_plain(Vp, Rx[s], W[s], H[s], r[s]) for s in range(S)],
          (4 * (Vp.numel() + Rx.numel() + W.numel() + 2 * H.numel()),
           S * (2 * 2 * N * M * C * nT * nA + 3 * nH)))
    X2 = torch.cat([Vp.expand((S,) + Vp.shape), Rx], dim=2)
    timed('grad_w', S, lambda: gw.grad_w_models(X2, H),
          lambda: [gw.grad_w(X2[s], H[s]) for s in range(S)],
          lambda: [gw.grad_w_plain(X2[s], H[s]) for s in range(S)],
          (4 * (X2.numel() + H.numel() + 2 * W.numel()), S * 2 * M * 2 * C * nA * N * nT))
    neg, pos = _stacked(rng, (M, C) + A, S), _stacked(rng, (M, C) + A, S)
    timed('mu_w', S, lambda: mu.mu_w(W, neg, pos, engine.EPS, 2, True),
          lambda: [mu.mu_w(W[s], neg[s], pos[s], engine.EPS, 2) for s in range(S)],
          lambda: [mu.mu_w_plain(W[s], neg[s], pos[s], engine.EPS, 2) for s in range(S)],
          (4 * 4 * W.numel(), 5 * W.numel()))
    del W, H, Vp, Rx, X2
    S = 4
    H, hneg, hpos = (_stacked(rng, (N, M) + T, S) for _ in range(3))
    ks = tuple(torch.tensor(k, device=DEVICE, dtype=torch.float32)
               for k in inhibition_kernels((8, 8)))
    inh = torch.tensor([0., 0.05, 0.1, 0.2], device=DEVICE)
    zero, regs = torch.zeros(S, device=DEVICE), torch.full((S,), engine.EPS + 0.1, device=DEVICE)
    i4 = inh.tolist()
    timed('inhibited_mu_h', S,
          lambda: inhibit.inhibited_mu_h_models(H, hneg, hpos, ks, inh, zero, regs),
          lambda: [inhibit.inhibited_mu_h(H[s], hneg[s], hpos[s], ks, i4[s], 0.,
                                          engine.EPS + 0.1) for s in range(S)],
          lambda: [inhibit.inhibited_mu_h_plain(H[s], hneg[s], hpos[s], ks, i4[s], 0.,
                                                engine.EPS + 0.1) for s in range(S)],
          (4 * 4 * H.numel(), H.numel() * (2 * sum(k.numel() for k in ks) + 10)))
    S = 2
    H, hneg, hpos = H[:S], hneg[:S], hpos[:S]
    regs = regs[:S]
    timed('mu_ratio', S, lambda: mu.mu_ratio(H, hneg, hpos, regs, True),
          lambda: [mu.mu_ratio(H[s], hneg[s], hpos[s], engine.EPS + 0.1) for s in range(S)],
          lambda: [mu.mu_ratio_plain(H[s], hneg[s], hpos[s], engine.EPS + 0.1)
                   for s in range(S)],
          (4 * 4 * H.numel(), 3 * H.numel()))
    return out


def phase_sweeps() -> tuple:
    """The MU sweeps (``sweep_fit``): (a) the conv flagship, 8 models
    (seeds 0-3 x sparsity 0.05, 0.1); (b) the inhibited flagship, 4 models
    (inhibition 0, 0.05, 0.1, 0.2, 17 x 17 taps); (c) the fft flagship, 2
    models; (d) the golden 2-D fixture, 64 models, also with ``tol`` and
    ``record_energies``; (e) plain NMF on dot, 4 models; (a) and (d) for
    ``SWEEP_ITER`` iterations, the others for ``SWEEP_SHORT_ITER``.  The
    HALS sweeps: (f) plain NMF at 16384 x 1 x 4096, 4 models; (g) an alpha
    grid of 64 small models, also with ``tol`` and ``record_energies``.
    Returns each kernel's launches over the model axis and the runs'
    numbers."""
    f = FLAGSHIP
    total = dict.fromkeys(KERNELS, 0)
    out = {}
    V = torch.tensor(np.random.default_rng(SEED).random((f['N'], f['C']) + f['S'],
                                                        dtype=np.float32), device=DEVICE)
    runs = [
        ('a', '(a) conv flagship sweep', ('mu_h', 'grad_w', 'mu_w'), np.array([0, 1, 2, 3] * 2),
         dict(sparsity=np.array([0.05] * 4 + [0.1] * 4, np.float32))),
        ('b', '(b) inhibited flagship sweep', ('inhibited_mu_h', 'grad_w', 'mu_w'), SEED,
         dict(n_models=4, sparsity=f['sparsity'], inhibition_range=(8, 8),
              inhibition=np.array([0., 0.05, 0.1, 0.2], np.float32))),
        ('c', '(c) fft flagship sweep', ('mu_ratio', 'mu_w'), SEED,
         dict(n_models=2, sparsity=f['sparsity'], strategy='fft')),
    ]
    for key, label, expected, seeds, kw in runs:
        out[key], res, ref = _sweep_run(label, V, f['M'], f['A'], expected, seeds, kw,
                                        SWEEP_ITER if key == 'a' else SWEEP_SHORT_ITER)
        del res, ref
    del V
    image = torch.tensor(_image_2d(), device=DEVICE, dtype=torch.float32)
    gkw = dict(sparsity=0.1)
    out['d'], res, ref = _sweep_run('(d) golden 2-D fixture sweep', image, 10, (7, 7),
                                    ('mu_h', 'grad_w', 'mu_w'), SEED,
                                    dict(n_models=SWEEP_GOLDEN_MODELS, **gkw), SWEEP_ITER)
    out['d'].update(_sweep_golden_loops(image, res, gkw))
    del res, ref
    d = SWEEP_DOT
    V = torch.tensor(np.random.default_rng(SEED).random((d['N'], 1, d['F']), dtype=np.float32),
                     device=DEVICE)
    out['e'], res, ref = _sweep_run('(e) plain NMF on dot sweep', V, d['M'], (d['F'],),
                                    ('mu_ratio', 'mu_w'), SEED,
                                    dict(n_models=d['models'], sparsity=0.1,
                                         reconstruction_mode='full'), SWEEP_SHORT_ITER)
    del res, ref, V
    hals_seconds = _hals_sweeps(out)
    for run in out.values():
        for name, n in run['launches_per_iteration'].items():
            total[name] += round(n * run['iterations'])
    log(f'model-axis kernels at phase 19\'s shapes ({card()}):')
    out['kernels'] = _sweep_kernel_times()
    t0 = time.perf_counter()
    out['kernels']['hals_sweep'] = _k5_model_axis_times()
    out['hals_seconds'] = hals_seconds + time.perf_counter() - t0
    log(f'phase 19\'s HALS sweeps (f), (g) and K5\'s model-axis times took '
        f'{out["hals_seconds"]:.1f} s')
    return total, out


def _hals_sweeps(out: dict) -> float:
    """Phase 19's HALS sweeps (f) and (g), their numbers into ``out``;
    returns the seconds they took."""
    t0 = time.perf_counter()
    h = SWEEP_HALS
    V = torch.tensor(np.random.default_rng(SEED + 50).random((h['N'], 1, h['F']),
                                                            dtype=np.float32), device=DEVICE)
    out['f'], res = _hals_sweep_run(
        f'(f) plain-NMF HALS sweep {h["N"]}x1x{h["F"]}/{h["M"]}', V, h['M'],
        dict(n_models=len(h['sparsity']), sparsity=np.asarray(h['sparsity'], np.float32),
             l2=h['l2']), SWEEP_ITER, SWEEP_SHORT_ITER)
    del res, V
    g = SWEEP_HALS_GRID
    V = torch.tensor(np.random.default_rng(SEED + 70).random((g['N'], 1, g['F']),
                                                            dtype=np.float32), device=DEVICE)
    gkw = dict(n_models=g['models'],
               sparsity=np.linspace(0., g['sparsity_max'], g['models'], dtype=np.float32))
    out['g'], res = _hals_sweep_run(f'(g) HALS alpha grid {g["N"]}x1x{g["F"]}/{g["M"]}', V,
                                    g['M'], dict(gkw), SWEEP_ITER, SWEEP_ITER)
    out['g'].update(_hals_sweep_loops(V, g['M'], res, gkw))
    del res, V
    return time.perf_counter() - t0


# ---------------------------------------------------- phase 20: multi-scale

#: the repository's multi-scale configuration (benchmarks/large_scale.py:97
#: ``run_multiscale``): 64 x 1 x 256 x 256, 12 atoms of 9 x 9 and 4 of 5 x 5,
#: 'valid', float32, both scales on conv; per-scale sparsity
MULTISCALE = dict(N=64, C=1, S=(256, 256), M=(12, 4), A=((9, 9), (5, 5)), mode='valid',
                  sparsity=(0.1, 0.05))
#: a small fit with one conv and one fft scale ('auto': 31 x 31 atoms on 128 x 128)
MULTISCALE_MIXED = dict(N=8, C=1, S=(128, 128), M=(6, 2), A=((5, 5), (31, 31)),
                        sparsity=(0.1, 0.05))
#: iterations of the checked fits (against the plain versions and float64)
MS_CHECK_ITER = 3
#: timed iterations (CUDA events) after a warm-up; the plain version's window
MS_TIMED = 10
MS_PLAIN_TIMED = 3
#: the serving request's batch and iterations
MS_SERVE_BATCH = 8
MS_SERVE_ITER = 10


def _ms_rel(a: tuple, b: tuple) -> float:
    """The worst max|a - b| / max|b| over the scales."""
    return max(_rel(x, y) for x, y in zip(a, b))


def _ms_fit(label, make, V, fit: dict, n_iter: int, expected: dict) -> tuple:
    """``make(dtype).fit(V, n_iter, **fit)`` on the kernels, counts reset
    before and read after (``expected``: each kernel's launches per
    iteration, none of any other), W and H of every scale within 1e-4 of
    the same fit on the plain versions and of the float64 fit (which
    launches no kernel).  Returns the model, the launches, the distances and
    the peak device memory (MiB)."""
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    model = make(torch.float32).fit(V, n_iterations=n_iter, **fit)
    sync()
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    want = dict.fromkeys(KERNELS, 0)
    want.update({k: v * n_iter for k, v in expected.items()})
    if launches != want:
        raise AssertionError(f'{label}: launches {launches}, not {want}')
    plain = make(torch.float32, use_pallas=False).fit(V, n_iterations=n_iter, **fit)
    rel = dict(plain_versions=max(_ms_rel(model.W, plain.W), _ms_rel(model.H, plain.H)))
    del plain
    reset_counts()
    exact = make(torch.float64).fit(V, n_iterations=n_iter, **fit)
    sync()
    if any(counts().values()):
        raise AssertionError(f'{label}: the float64 fit launched {counts()}')
    rel['float64'] = max(_ms_rel(model.W, exact.W), _ms_rel(model.H, exact.H))
    del exact
    e = model._energy_function()
    log(f'{label}: strategies {model._strategies}, {n_iter} iterations, launches '
        f'{ {k: v for k, v in launches.items() if v} }, peak {peak:.0f} MiB; W, H off the '
        f'plain versions {rel["plain_versions"]:.3e}, off float64 {rel["float64"]:.3e}; '
        f'energy {e!r}')
    if not (math.isfinite(e) and rel['plain_versions'] <= TOL and rel['float64'] <= TOL):
        raise AssertionError(f'{label}: energy {e}, W and H off {rel} (> {TOL}?)')
    return model, launches, rel, peak


def _ms_iteration_ms(model, sp: tuple, n: int, update_W: bool = True) -> float:
    """ms per joint iteration (or per H-only one) on ``model``'s state at
    the per-scale sparsities ``sp``, CUDA events around ``ms_fit_loop``."""
    def run():
        model._Ws, model._Hs = multiscale.ms_fit_loop(
            model._Vd, model._Vps, model._Ws, model._Hs, n, sp, model._mask_d,
            update_W=update_W, **model._statics())
    return time_ms(run, reps=1) / n


def _ms_split(model) -> dict:
    """One joint iteration's reconstructions (two per scale, one per
    half), each scale's timed alone (CUDA events, 10 calls)."""
    out = {}
    for k, (W, H, plan, strat) in enumerate(zip(model._Ws, model._Hs, model._plans,
                                                model._strategies)):
        out[f'reconstruction scale {k} ({model.atom_shapes[k]}, {model.n_atoms[k]} atoms)'] = \
            time_ms(lambda: engine.reconstruct(W, H, plan=plan, strategy=strat))
    return out


def phase_multiscale() -> tuple:
    """Phase 20: ``MultiScaleTNMF`` at the repository's multi-scale
    configuration (``MULTISCALE``), on the kernels: a fit of
    ``MS_CHECK_ITER`` iterations, counts reset before and read after (K3, K2
    and ``mu_w`` twice per iteration, one launch per scale; no other
    kernel), W and H of every scale within 1e-4 of the fit on the plain
    versions and of the float64 fit; ms per iteration (CUDA events,
    ``MS_TIMED`` iterations after a warm-up) in turns with the plain
    versions' (``MS_PLAIN_TIMED``), the four reconstructions' share, peak
    memory; a small conv + fft fit (``mu_ratio`` on the fft scale) held the
    same way; ``transform`` (K3 twice per H-only iteration, against the
    plain versions) and its ms per H-only iteration; the checkpoint loaded
    with ``h_init='correlate'`` as a serving artifact, one request of
    ``MS_SERVE_BATCH`` samples (K3 twice per iteration, no plain version)
    within 1e-5 of ``transform``, timed in turns with it; and a one-scale
    ``MultiScaleTNMF`` bit-equal to ``TransformInvariantNMF`` at the conv
    flagship.  Returns the launches and the numbers."""
    t_phase = time.perf_counter()
    c = MULTISCALE
    total = dict.fromkeys(KERNELS, 0)
    out = {}
    V = np.random.default_rng(SEED + 20).random((c['N'], c['C']) + c['S'], dtype=np.float32)
    fit = dict(sparsity_H=c['sparsity'])

    def make(dtype, use_pallas=None, **kw):
        return MultiScaleTNMF(c['M'], c['A'], reconstruction_mode=c['mode'], seed=SEED,
                              dtype=dtype, device=DEVICE, use_pallas=use_pallas, **kw)
    per_iteration = dict(mu_h=2, grad_w=2, mu_w=2)
    model, launches, rel, peak = _ms_fit('multi-scale flagship', make, V, fit, MS_CHECK_ITER,
                                         per_iteration)
    if model._strategies != ('conv', 'conv'):
        raise AssertionError(f'multi-scale flagship: strategies {model._strategies}')
    for name, n in launches.items():
        total[name] += n
    sp = c['sparsity']
    plain = make(torch.float32, use_pallas=False).fit(V, n_iterations=1, **fit)
    _ms_iteration_ms(model, sp, 2)  # warm-up
    turns = [_ms_iteration_ms(model, sp, MS_TIMED), _ms_iteration_ms(plain, sp, MS_PLAIN_TIMED),
             _ms_iteration_ms(plain, sp, MS_PLAIN_TIMED), _ms_iteration_ms(model, sp, MS_TIMED)]
    del plain
    ms = (turns[0] + turns[3]) / 2
    split = _ms_split(model)
    recon = 2 * sum(split.values())
    out['flagship'] = dict(ms_per_iteration=ms, plain_ms_per_iteration=(turns[1] + turns[2]) / 2,
                           turns_ms=turns, reconstructions_ms=recon,
                           reconstruction_share=recon / ms, split_ms=split, peak_mib=peak,
                           rel=rel, launches_per_iteration=per_iteration)
    log(f'multi-scale flagship ({card()}): {ms:.4f} ms per iteration (CUDA events, '
        f'{MS_TIMED} iterations, in turns with the plain versions\' '
        f'{out["flagship"]["plain_ms_per_iteration"]:.4f}: '
        f'{[round(t, 4) for t in turns]}); the four reconstructions {recon:.4f} ms '
        f'({100 * recon / ms:.1f} %): '
        + ', '.join(f'{k} {v:.4f} ms' for k, v in split.items())
        + f'; peak {peak:.0f} MiB')

    # one conv and one fft scale: K3 and mu_ratio in one iteration
    x = MULTISCALE_MIXED
    Vx = np.random.default_rng(SEED + 21).random((x['N'], x['C']) + x['S'], dtype=np.float32)

    def make_mixed(dtype, use_pallas=None):
        return MultiScaleTNMF(x['M'], x['A'], seed=SEED, dtype=dtype, device=DEVICE,
                              use_pallas=use_pallas)
    mixed, launches, rel, _ = _ms_fit('multi-scale conv + fft', make_mixed, Vx,
                                      dict(sparsity_H=x['sparsity']), MS_CHECK_ITER,
                                      dict(mu_h=1, grad_w=1, mu_ratio=1, mu_w=2))
    if mixed._strategies != ('conv', 'fft'):
        raise AssertionError(f'multi-scale conv + fft: strategies {mixed._strategies}')
    for name, n in launches.items():
        total[name] += n
    out['mixed'] = dict(rel=rel, strategies=list(mixed._strategies))
    del mixed

    # transform of new data against the fitted dictionary, from its checkpoint
    ckpt = Path(tempfile.mkdtemp()) / 'multiscale.npz'
    model.save(str(ckpt))
    del model

    def encoder(use_pallas=None, h_init='random'):
        return MultiScaleTNMF.load(str(ckpt), device=DEVICE, seed=SEED, h_init=h_init,
                                   use_pallas=use_pallas)
    V2 = np.random.default_rng(SEED + 22).random((c['N'], c['C']) + c['S'], dtype=np.float32)
    enc = encoder()
    reset_counts()
    H = enc.transform(V2, n_iterations=MS_SERVE_ITER, **fit)
    sync()
    launches = counts()
    want = dict.fromkeys(KERNELS, 0)
    want['mu_h'] = 2 * MS_SERVE_ITER
    if launches != want:
        raise AssertionError(f'multi-scale transform: launches {launches}, not {want}')
    for name, n in launches.items():
        total[name] += n
    rel_t = _ms_rel(H, encoder(use_pallas=False).transform(V2, n_iterations=MS_SERVE_ITER,
                                                           **fit))
    h_ms = _ms_iteration_ms(enc, sp, MS_TIMED, update_W=False)
    del enc
    out['transform'] = dict(ms_per_h_only_iteration=h_ms, rel_plain_versions=rel_t)
    log(f'multi-scale transform ({card()}): {MS_SERVE_ITER} iterations, launches '
        f'{ {k: v for k, v in launches.items() if v} }, H {rel_t:.3e} off the plain versions; '
        f'{h_ms:.4f} ms per H-only iteration')
    if not rel_t <= TOL:
        raise AssertionError(f'multi-scale transform: H off the plain versions by {rel_t:.3e}')

    # the checkpoint as a serving artifact (correlate init, as the artifact)
    enc = encoder(h_init='correlate')
    Vb = torch.as_tensor(V2[:MS_SERVE_BATCH], device=DEVICE)
    enc.transform(Vb, n_iterations=1, **fit)  # the sample geometry
    t0 = time.perf_counter()
    blob = enc.export_serving(n_iterations=MS_SERVE_ITER, **fit)
    export_s = time.perf_counter() - t0
    served = load_serving(blob)
    reset_counts()
    with every_plain_call() as plain_calls_seen:
        Hs = served.transform(Vb)
        sync()
    launches = counts()
    want = dict.fromkeys(KERNELS, 0)
    want['mu_h'] = 2 * MS_SERVE_ITER
    if launches != want or plain_calls_seen or served.header.get('multiscale') != 2:
        raise AssertionError(f'multi-scale serving: launches {launches} (not {want}), plain '
                             f'calls {plain_calls_seen}, header {served.header}')
    for name, n in launches.items():
        total[name] += n
    Ht = enc.transform(Vb, n_iterations=MS_SERVE_ITER, **fit)
    rel_s = _ms_rel(tuple(h.cpu().numpy() for h in Hs), Ht)
    bits = all(np.array_equal(h.cpu().numpy(), t) for h, t in zip(Hs, Ht))

    def request():
        served.transform(Vb)

    def compute():
        enc.fit(Vb, n_iterations=MS_SERVE_ITER, update_W=False, keep_W=True, **fit)
    request(), compute()
    times = [time_ms(fn, reps=3) for fn in (request, compute, compute, request)]
    out['serving'] = dict(batch=MS_SERVE_BATCH, iterations=MS_SERVE_ITER, export_s=export_s,
                          file_bytes=len(blob), ms=(times[0] + times[3]) / 2,
                          transform_ms=(times[1] + times[2]) / 2, turns_ms=times,
                          rel_transform=rel_s, bit_equal=bits)
    log(f'multi-scale serving ({card()}): export {export_s:.2f} s, {len(blob)} bytes; batch '
        f'{MS_SERVE_BATCH}, {MS_SERVE_ITER} iterations: launches '
        f'{ {k: v for k, v in launches.items() if v} }, H '
        + ('bit-equal to' if bits else f'{rel_s:.3e} off') + ' transform; '
        f'{out["serving"]["ms"]:.4f} ms per request, transform\'s compute '
        f'{out["serving"]["transform_ms"]:.4f} ms, in turns {[round(t, 4) for t in times]}')
    if not rel_s <= SERVE_TOL:
        raise AssertionError(f'multi-scale serving: H {rel_s:.3e} off transform > {SERVE_TOL}')
    ckpt.unlink()
    del enc, served

    # one scale: the single-scale model's draws and updates, bit for bit
    f = FLAGSHIP
    V1 = np.random.default_rng(SEED).random((f['N'], f['C']) + f['S'], dtype=np.float32)
    reset_counts()
    one = MultiScaleTNMF((f['M'],), (f['A'],), seed=SEED, device=DEVICE).fit(
        V1, n_iterations=MS_CHECK_ITER, sparsity_H=f['sparsity'])
    launches = counts()
    single = TransformInvariantNMF(f['M'], f['A'], seed=SEED, device=DEVICE)
    single.fit(V1, n_iterations=MS_CHECK_ITER, sparsity_H=f['sparsity'])
    same = np.array_equal(one.W[0], single.W) and np.array_equal(one.H[0], single.H)
    log(f'one-scale MultiScaleTNMF at the conv flagship, {MS_CHECK_ITER} iterations: launches '
        f'{ {k: v for k, v in launches.items() if v} }; bit-equal to TransformInvariantNMF: '
        f'{same}')
    if not same or launches['mu_h'] != MS_CHECK_ITER:
        raise AssertionError('one-scale MultiScaleTNMF: not bit-equal to '
                             'TransformInvariantNMF, or K3 not launched once per iteration')
    for name, n in launches.items():
        total[name] += n
    out['one_scale_bit_equal'] = same
    out['seconds'] = time.perf_counter() - t_phase
    log(f'phase 20 took {out["seconds"]:.1f} s')
    return total, out


#: phase 21 (the tools): iterations of the memory fits, of the traced fit and
#: of the timed one; the prefetched partial_fit steps; the served batch
TOOLS_ITER = 2
TOOLS_TRACE_ITER = 3
TOOLS_TIMER_ITER = 10
TOOLS_STEPS = 8
TOOLS_SERVE_BATCH = 8
TOOLS_SERVE_ITER = 10
#: the estimate's peak at most this many times the measured one
TOOLS_PEAK_RATIO = 1.5
#: IterationTimer's rate against the CUDA events'
TOOLS_RATE_TOL = 0.10
#: the kernels' names in the trace, and the wrappers that launch them
TOOLS_TRACED = {'mu_h': 'mu_h', 'grad_w': 'grad_w_partial', 'mu_w': 'mu_w_kernel'}
#: the kernels phase 21 must launch (memory fits, trace, pipeline, serving)
TOOLS_KERNELS = ('mu_ratio', 'mu_w', 'grad_w', 'mu_h', 'hals_sweep')


def _live_entries(est, model) -> dict:
    """The estimate's persistent entries against the model's live tensors
    (bytes); raises where one differs."""
    if isinstance(model, MultiScaleTNMF):
        live = {'V (device copy)': model._Vd}
        for k in range(model.n_scales):
            live.update({f'V prepared, scale {k}': model._Vps[k],
                         f'H, scale {k} (loop carrier)': model._Hs[k],
                         f'W, scale {k}': model._Ws[k]})
    elif est.strategy == 'hals':
        live = {'V (device copy, flat view)': model._Vd, 'H (n, m)': model._H,
                'W (m, F)': model._W}
    elif est.strategy == 'hals-conv':
        live = {'V (device copy)': model._Vd, 'V prepared (loop-invariant)': model._Vp,
                "H (canonical, the model's)": model._H, 'W (dictionary)': model._W}
    else:
        live = {'V (device copy)': model._Vd, 'V prepared (loop-invariant)': model._Vp,
                'H (loop carrier)': model._H, 'W (dictionary)': model._W}
    out = {}
    for name, t in live.items():
        b = t.numel() * t.element_size()
        if est.tensors[name][2] != b:
            raise AssertionError(f'memory estimate: {name} {est.tensors[name]} against the live '
                                 f'{tuple(t.shape)} of {b} bytes')
        out[name] = b
    return out


def _memory_fit(label, model, V: np.ndarray, bound: bool, solver='mu', **fit) -> dict:
    """Estimate, then ``TOOLS_ITER`` iterations from NumPy data with the
    allocator's peak reset before: the persistent entries against the live
    tensors; with ``bound``, the measured peak (over the allocations before
    the fit) at most the estimate's and the estimate at most
    ``TOOLS_PEAK_RATIO`` times it."""
    est = tools_memory.estimate_fit_memory(model, V.shape, **(
        {} if isinstance(model, MultiScaleTNMF) else dict(solver=solver)))
    gc.collect()
    torch.cuda.empty_cache()
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    extra = {} if isinstance(model, MultiScaleTNMF) else dict(solver=solver)
    model.fit(V, n_iterations=TOOLS_ITER, **extra, **fit)
    sync()
    peak = torch.cuda.max_memory_allocated() - base
    live = _live_entries(est, model)
    ratio = est.peak_bytes / peak
    log(f'  memory {label}: estimate {est.peak_bytes / 2**20:.2f} MiB (persistent '
        f'{est.persistent_bytes / 2**20:.2f}), measured peak {peak / 2**20:.2f} MiB over '
        f'{TOOLS_ITER} iterations, estimate / measured {ratio:.4f}; persistent entries equal '
        f'the live tensors ({len(live)})')
    if bound and not 1.0 <= ratio <= TOOLS_PEAK_RATIO:
        log(str(est))
        raise AssertionError(f'memory {label}: estimate {est.peak_bytes} B against the measured '
                             f'peak {peak} B (ratio {ratio:.4f}, allowed 1 to '
                             f'{TOOLS_PEAK_RATIO})')
    return dict(estimate_mib=est.peak_bytes / 2**20, measured_mib=peak / 2**20, ratio=ratio)


def _tools_memory() -> dict:
    """The estimate at the conv and fft flagships and shift-invariant HALS
    at the flagship's data (peaks bounded), plain NMF on dot, plain-NMF HALS
    and the multi-scale configuration (persistent entries), then a fit at
    ``suggest_batch_size``'s n for the flagship geometry with the default
    budget (the card's memory)."""
    f, d, c = FLAGSHIP, DOT, MULTISCALE
    rng = np.random.default_rng(SEED + 21)
    V = rng.random((f['N'], f['C']) + f['S'], dtype=np.float32)
    out = {}
    for label, backend in (('conv flagship', 'auto'), ('fft flagship', 'jax_fft')):
        m = TransformInvariantNMF(f['M'], f['A'], reconstruction_mode=f['mode'], seed=SEED,
                                  backend=backend, device=DEVICE)
        out[label] = _memory_fit(label, m, V, True, sparsity_H=f['sparsity'])
        del m
    h = HALS_CONV
    m = TransformInvariantNMF(h['M'], h['A'], reconstruction_mode='full', seed=SEED,
                              device=DEVICE)
    out['hals conv'] = _memory_fit('shift-invariant HALS', m, V, True, solver='hals',
                                   sparsity_H=h['sparsity'])
    del m
    ms = MultiScaleTNMF(c['M'], c['A'], reconstruction_mode=c['mode'], seed=SEED, device=DEVICE)
    out['multiscale'] = _memory_fit('multi-scale', ms, V, False, sparsity_H=c['sparsity'])
    del ms, V
    Vd = rng.random((d['N'], 1) + d['S'], dtype=np.float32)
    for label, solver in (('dot', 'mu'), ('plain-NMF HALS', 'hals')):
        m = TransformInvariantNMF(d['M'], d['S'], reconstruction_mode='full', seed=SEED,
                                  device=DEVICE)
        out[label] = _memory_fit(label, m, Vd, False, solver=solver, sparsity_H=d['sparsity'])
        del m
    del Vd
    gc.collect()
    torch.cuda.empty_cache()
    m = TransformInvariantNMF(f['M'], f['A'], reconstruction_mode=f['mode'], init='device',
                              seed=SEED, device=DEVICE)
    budget = int(tools_memory._default_budget(m) * 0.85)
    n = tools_memory.suggest_batch_size(m, f['S'], n_channels=f['C'])
    V = torch.rand((n, f['C']) + f['S'], device=DEVICE,
                   generator=torch.Generator(DEVICE).manual_seed(SEED))
    est = tools_memory.estimate_fit_memory(m, tuple(V.shape)).peak_bytes
    sync()
    base = torch.cuda.memory_allocated() - V.numel() * V.element_size()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m.fit(V, n_iterations=TOOLS_ITER, sparsity_H=f['sparsity'])
    sync()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    e = m._energy_function()
    log(f'  suggest_batch_size at the flagship geometry: {n} samples for the default budget '
        f'{budget / 2**30:.2f} GiB (0.85 of the card\'s {budget / 0.85 / 2**30:.2f} GiB); '
        f'the fit of {TOOLS_ITER} iterations: measured peak {peak / 2**30:.3f} GiB, estimate '
        f'{est / 2**30:.3f} GiB, {seconds:.2f} s, energy {e!r}')
    if not (peak <= budget and math.isfinite(e)):
        raise AssertionError(f'suggest_batch_size: the fit at {n} samples peaked at {peak} B '
                             f'against the budget {budget} B (energy {e})')
    out['suggested'] = dict(n=n, budget_gib=budget / 2**30, measured_gib=peak / 2**30,
                            estimate_gib=est / 2**30)
    del m, V
    return out


def _tools_profiling() -> dict:
    """``trace`` around ``TOOLS_TRACE_ITER`` conv-flagship iterations (the
    file and its kernel events by name), and ``IterationTimer``'s rate
    against the CUDA events' (``_ms_per_iteration``)."""
    f = FLAGSHIP
    V = np.random.default_rng(SEED + 22).random((f['N'], f['C']) + f['S'], dtype=np.float32)
    m = TransformInvariantNMF(f['M'], f['A'], reconstruction_mode=f['mode'], seed=SEED,
                              device=DEVICE)
    fit = dict(sparsity_H=f['sparsity'])
    m.fit(V, n_iterations=1, **fit)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with tools_profiling.trace(tmp):
            m.fit(V, n_iterations=TOOLS_TRACE_ITER, keep_W=True, **fit)
        seconds = time.perf_counter() - t0
        files = sorted(Path(tmp).rglob('*.json'))
        if not files:
            raise AssertionError('trace wrote no file')
        size = files[0].stat().st_size
        events = json.loads(files[0].read_text())['traceEvents']
    kernels = [e['name'] for e in events if e.get('cat') == 'kernel']
    found = {name: sum(tag in k for k in kernels) for name, tag in TOOLS_TRACED.items()}
    log(f'  trace of {TOOLS_TRACE_ITER} flagship iterations: {files[0].name}, {size} bytes, '
        f'{len(kernels)} kernel events, of them by name {found} ({seconds:.2f} s with the '
        'profiler)')
    if not all(found[name] >= TOOLS_TRACE_ITER for name in found):
        raise AssertionError(f'the trace lacks kernels: {found}')
    timer = tools_profiling.IterationTimer()
    m.fit(V, n_iterations=TOOLS_TIMER_ITER, keep_W=True, progress_callback=timer, **fit)
    timer_rate = timer.iterations_per_second
    event_rate = 1e3 / _ms_per_iteration(m, fit, n=TOOLS_TIMER_ITER)
    off = abs(timer_rate - event_rate) / event_rate
    log(f'  IterationTimer: {timer_rate:.3f} iterations/s against {event_rate:.3f} from CUDA '
        f'events ({100 * off:.2f} % apart)')
    if not off <= TOOLS_RATE_TOL:
        raise AssertionError(f'IterationTimer {timer_rate} against CUDA events {event_rate}')
    return dict(trace_bytes=size, traced_kernels=found, timer_its=timer_rate,
                event_its=event_rate)


def _tools_pipeline() -> dict:
    """``TOOLS_STEPS`` ``partial_fit`` steps on batches of ``MB_BATCH``
    flagship samples, fed by ``prefetch_to_device`` and by the host in turns
    (host, prefetched, prefetched, host): W and H bit-equal, ms per step."""
    f = FLAGSHIP
    rng = np.random.default_rng(SEED + 23)
    batches = [rng.random((MB_BATCH, f['C']) + f['S'], dtype=np.float32)
               for _ in range(TOOLS_STEPS)]

    def run(feed):
        m = TransformInvariantNMF(f['M'], f['A'], reconstruction_mode=f['mode'], seed=SEED,
                                  init='device', device=DEVICE)
        sync()
        t0 = time.perf_counter()
        for b in feed:
            m.partial_fit(b, sparsity_H=f['sparsity'])
        sync()
        return m, 1e3 * (time.perf_counter() - t0) / TOOLS_STEPS

    runs = [run(iter(batches)) if kind == 'host' else
            run(tools_pipeline.prefetch_to_device(iter(batches), device=DEVICE))
            for kind in ('host', 'prefetched', 'prefetched', 'host')]
    ref = runs[0][0]
    same = all(torch.equal(m._W, ref._W) and torch.equal(m._H, ref._H) for m, _ in runs)
    host_ms, pre_ms = [runs[0][1], runs[3][1]], [runs[1][1], runs[2][1]]
    log(f'  partial_fit, {TOOLS_STEPS} steps of {MB_BATCH} samples: ms per step host feed '
        f'{host_ms[0]:.3f}/{host_ms[1]:.3f}, prefetched {pre_ms[0]:.3f}/{pre_ms[1]:.3f} '
        f'(in turns); W and H {"bit-equal" if same else "DIFFER"} across the feeds')
    if not same:
        raise AssertionError('partial_fit from prefetch_to_device differs from the host feed')
    return dict(host_ms_per_step=host_ms, prefetched_ms_per_step=pre_ms)


def phase_tools() -> tuple:
    """Phase 21: the port's tools.  ``estimate_fit_memory`` and
    ``suggest_batch_size`` (``_tools_memory``), ``trace`` and
    ``IterationTimer`` (``_tools_profiling``), ``prefetch_to_device``
    (``_tools_pipeline``) and ``python -m tnmf_tpu_torch.cli export`` in a
    subprocess on a flagship checkpoint, run while the rest goes on, its
    artifact's 8-sample request bit-equal to an in-process
    ``export_serving`` at the same settings.  Counts reset before, read
    after.  Returns the launches and the numbers."""
    t_phase = time.perf_counter()
    f = FLAGSHIP
    tmp = tempfile.TemporaryDirectory()
    src = TransformInvariantNMF(f['M'], f['A'], reconstruction_mode=f['mode'], seed=SEED,
                                device=DEVICE)
    V = np.random.default_rng(SEED + 24).random((TOOLS_SERVE_BATCH, f['C']) + f['S'],
                                                dtype=np.float32)
    src.fit(V, n_iterations=1)
    ckpt, artifact = Path(tmp.name) / 'flagship.npz', Path(tmp.name) / 'flagship.tnmfsrv'
    src.save(str(ckpt), include_H=True)
    export = dict(iterations=TOOLS_SERVE_ITER, sparsity=f['sparsity'])
    child = subprocess.Popen(
        [sys.executable, '-m', 'tnmf_tpu_torch.cli', 'export', str(ckpt), str(artifact)]
        + [a for k, v in export.items() for a in (f'--{k}', str(v))],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    reset_counts()
    try:
        out = dict(memory=_tools_memory(), profiling=_tools_profiling(),
                   pipeline=_tools_pipeline())
        t0 = time.perf_counter()
        stdout, stderr = child.communicate(timeout=600)
        waited = time.perf_counter() - t0
        log(f'  tnmf-tpu-torch export (subprocess, exit {child.returncode}): {stdout.strip()} '
            f'{stderr.strip()[-500:]} (waited {waited:.1f} s for it)')
        if child.returncode != 0:
            raise AssertionError('the export command failed')
        loaded = TransformInvariantNMF.load(str(ckpt), device=DEVICE)
        here = load_serving(loaded.export_serving(n_iterations=TOOLS_SERVE_ITER,
                                                  sparsity_H=f['sparsity']))
        served = load_serving(str(artifact))
        Vt = torch.as_tensor(V, device=DEVICE)
        H_cli, H_here = served.transform(Vt), here.transform(Vt)
        same = torch.equal(H_cli, H_here) and bool(torch.isfinite(H_cli).all())
        log(f'  the exported artifact\'s request of {TOOLS_SERVE_BATCH} samples: '
            f'{"bit-equal to" if same else "DIFFERS from"} the in-process export_serving')
        if not same:
            raise AssertionError('the export command\'s artifact differs from export_serving')
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        tmp.cleanup()
    launches = counts()
    missing = [name for name in TOOLS_KERNELS if launches[name] == 0]
    seconds = time.perf_counter() - t_phase
    log(f'  phase 21 launches {launches}; {seconds:.1f} s')
    if missing:
        raise AssertionError(f'phase 21 launched no {missing}')
    out['seconds'] = seconds
    return launches, out


# ---------------------------------------------------------------- phase 22

#: every figure of an example or a demo on the kernels against the same run
#: with ``use_pallas=False`` (max |a - b| / |b|, the fits' limit of phases 7-20)
EXAMPLE_RTOL = 1e-4
#: the kernels phase 22 must launch across the examples
EXAMPLE_KERNELS = ('mu_ratio', 'mu_w', 'grad_w', 'mu_h', 'inhibited_mu_h', 'hals_sweep')
#: the CLI's runs: (arguments, what its output must show)
EXAMPLE_CLI = ((['example', 'shift_invariant_decomposition'], 'dictionary recovery score'),
               (['demo', '--headless'], ''))


def _figures(tree, skip: tuple, path: str = '') -> dict:
    """The figures of an example's or a demo's result, flat by path: every
    number, string and None below it, except its ``'plot'`` data and the
    names in ``skip``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k != 'plot' and k not in skip:
                out.update(_figures(v, skip, f'{path}/{k}'))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_figures(v, skip, f'{path}[{i}]'))
        return out
    return {path: tree.item() if isinstance(tree, np.generic) else tree}


def _hold_figures(label: str, got: dict, want: dict) -> float:
    """The largest relative difference of two runs' figures; raises past
    ``EXAMPLE_RTOL`` or where the figures' names, texts or integers
    differ."""
    if got.keys() != want.keys():
        raise AssertionError(f'{label}: figures {sorted(got)} against {sorted(want)}')
    worst = 0.0
    for key, b in want.items():
        a = got[key]
        if isinstance(b, float) or isinstance(a, float):
            rel = abs(a - b) / abs(b) if b else abs(a - b)
            worst = max(worst, rel)
            if not (math.isfinite(a) and rel <= EXAMPLE_RTOL):
                raise AssertionError(f'{label}: {key} {a!r} on the kernels against {b!r} on '
                                     f'the plain versions (relative {rel:.3e}, limit '
                                     f'{EXAMPLE_RTOL})')
        elif a != b:
            raise AssertionError(f'{label}: {key} {a!r} on the kernels against {b!r}')
    return worst


def _event_ms(fn) -> tuple:
    """``fn()`` between two CUDA events: its result and the milliseconds
    between them."""
    sync()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _run_plain(label: str, fn) -> tuple:
    """``fn()`` (a run with ``use_pallas=False``), timed, with no kernel
    launched in it."""
    reset_counts()
    out, ms = _event_ms(fn)
    launched = {k: n for k, n in counts().items() if n}
    if launched:
        raise AssertionError(f'{label} with use_pallas=False launched {launched}')
    return out, ms


def _kernels_plain_kernels(label: str, fn, total: dict) -> tuple:
    """``fn(use_pallas)`` on the kernels (counts reset before and read
    after, added to ``total``), with ``use_pallas=False``, then on the
    kernels again, each between CUDA events: the first run's result, the
    plain one's, the launches and the three ms (kernels, plain, kernels
    after plain)."""
    reset_counts()
    result, ms = _event_ms(lambda: fn(None))
    launches = counts()
    for k, n in launches.items():
        total[k] += n
    plain, plain_ms = _run_plain(label, lambda: fn(False))
    _, ms_after = _event_ms(lambda: fn(None))
    return result, plain, {k: n for k, n in launches.items() if n}, (ms, plain_ms, ms_after)


def _examples(total: dict) -> dict:
    """Each ported example of one process at full size in turns
    (:func:`_kernels_plain_kernels`), every figure held within
    ``EXAMPLE_RTOL`` of the plain run (the data-parallel ones: phase 23)."""
    from tnmf_tpu_torch.examples import SINGLE_PROCESS_EXAMPLES
    out = {}
    for name in SINGLE_PROCESS_EXAMPLES:
        module = importlib.import_module(f'tnmf_tpu_torch.examples.{name}')
        result, plain, launches, (ms, plain_ms, ms_after) = _kernels_plain_kernels(
            name, lambda use_pallas: module.run(device=DEVICE, use_pallas=use_pallas), total)
        got, want = (_figures(r, module.NOT_COMPARED) for r in (result, plain))
        worst = _hold_figures(name, got, want)
        out[name] = dict(ms=ms, plain_ms=plain_ms, ms_after_plain=ms_after, figures=len(got),
                         max_rel_diff=worst, launches=launches)
        log(f'  example {name}: {ms:.1f} ms on the kernels, {plain_ms:.1f} ms plain, '
            f'{ms_after:.1f} ms on the kernels after it; {len(got)} figures, worst '
            f'{worst:.3e} apart; launches {launches}')
        for line in module.lines(result):
            log('    ' + line.replace('\n', '\n    '))
    return out


def _demos(total: dict) -> dict:
    """The five demos headless through the streamlit shim on the card (no
    matplotlib: nothing drawn), counts added to ``total``, each demo's
    figures against ``use_pallas=False``."""
    from tnmf_tpu_torch.demos import demo_selector
    from tnmf_tpu_torch.utils import demo as demo_utils
    out = {}
    for name in demo_selector.DEMO_NAME_DICT:
        def run(use_pallas):
            # every run fits: the demos' fit cache would serve the rerun
            demo_utils._FIT_CACHE.clear()
            return demo_selector.main(name, device=DEVICE, use_pallas=use_pallas)
        result, plain, launches, (ms, plain_ms, ms_after) = _kernels_plain_kernels(
            name, run, total)
        got, want = (_figures(r, ()) for r in (result, plain))
        worst = _hold_figures(name, got, want)
        out[name] = dict(ms=ms, plain_ms=plain_ms, ms_after_plain=ms_after, figures=len(got),
                         max_rel_diff=worst, launches=launches)
        log(f'  demo {name!r}: {ms:.1f} ms on the kernels, {plain_ms:.1f} ms plain, '
            f'{ms_after:.1f} ms on the kernels after it; figures {got} (worst {worst:.3e} '
            f'apart from plain); launches {launches}')
    return out


def phase_examples() -> tuple:
    """Phase 22: the port's examples and demos as a user runs them, on the
    card.  The thirteen examples (``_examples``), the five demos
    (``_demos``), then ``python -m tnmf_tpu_torch.cli example
    shift_invariant_decomposition`` and ``demo --headless`` as subprocesses
    (both at once, after the timed runs), each exiting 0.  Fails where a
    kernel of ``EXAMPLE_KERNELS`` launched no time across the examples.
    Returns the examples' launches and the numbers."""
    t_phase = time.perf_counter()
    reset_counts()
    plan3d = ConvPlan.create('valid', (16, 16, 16), (5, 5, 5))
    log(f'  the 3-D example runs the plain versions of K2, K3 and K4: '
        f'{engine.plain_reason(plan3d, torch.float32)}')
    total = dict.fromkeys(KERNELS, 0)
    examples = _examples(total)
    demo_total = dict.fromkeys(KERNELS, 0)
    demos = _demos(demo_total)
    missing = [name for name in EXAMPLE_KERNELS if total[name] == 0]
    children = [(args, expect, subprocess.Popen(
        [sys.executable, '-m', 'tnmf_tpu_torch.cli', *args], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for args, expect in EXAMPLE_CLI]
    cli = {}
    try:
        t0 = time.perf_counter()
        for args, expect, child in children:
            stdout, stderr = child.communicate(timeout=600)
            cli[' '.join(args)] = child.returncode
            log(f'  tnmf-tpu-torch {" ".join(args)} (subprocess): exit {child.returncode}; '
                f'{stdout.strip()[-300:]!r} {stderr.strip()[-300:]!r}')
            if child.returncode != 0 or expect not in stdout:
                raise AssertionError(f'tnmf-tpu-torch {" ".join(args)} failed')
        log(f'  the CLI runs took {time.perf_counter() - t0:.1f} s after the timed runs')
    finally:
        for _, _, child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
    seconds = time.perf_counter() - t_phase
    log(f'  phase 22 launches across the examples {total}, across the demos {demo_total}; '
        f'{seconds:.1f} s')
    if missing:
        raise AssertionError(f'phase 22: the examples launched no {missing}')
    return total, dict(examples=examples, demos=demos, demo_launches=demo_total, cli=cli,
                       seconds=seconds)


# ---------------------------------------------------------------- phase 23

#: iterations of the flagship fits on a mesh: plain, inhibited
MESH_ITER = 10
MESH_INHIBITED_ITER = 5
#: a world of two against a world of one, |a - b| <= atol + rtol |b| (the
#: JAX package's bound of sharded against single-device steps,
#: __graft_entry__.py:123-129)
MESH_RTOL, MESH_ATOL = 2e-5, 1e-7
#: HALS on a mesh: plain NMF at phase 16's size, shift-invariant on the
#: flagship's data, and the latter's limit against the world of one
MESH_HALS_ITER = 3
MESH_HALS_CONV_ITER = 2
MESH_HALS_CONV_TOL = 1e-4
#: seconds each process phase 23 starts may take
MESH_TIMEOUT = 600
#: the CLI's data-parallel examples: (arguments, what the output must show)
MESH_CLI = ((['example', 'data_parallel_fit'], 'final energy (mesh=1)'),
            (['example', 'multihost_fit'], 'multi-host fit finished on both ranks.'))


def _mesh_config() -> dict:
    """What the world of one and the workers fit: the device, the sizes and
    the iterations (handed to the workers on their command line)."""
    return dict(device=DEVICE, flagship=FLAGSHIP, hals_plain=HALS_PLAIN, hals_conv=HALS_CONV,
                iterations=dict(plain=MESH_ITER, inhibited=MESH_INHIBITED_ITER,
                                hals_plain=MESH_HALS_ITER, hals_conv=MESH_HALS_CONV_ITER))


def _mesh_fits(cfg: dict) -> list:
    """``(label, make(mesh, **kw), data, fit keywords, iterations, launches
    per iteration)`` of each fit phase 23 runs on a mesh."""
    f, hp, hc, it = cfg['flagship'], cfg['hals_plain'], cfg['hals_conv'], cfg['iterations']
    device = cfg['device']
    V = np.random.default_rng(SEED).random((f['N'], f['C']) + tuple(f['S']), dtype=np.float32)
    V2 = np.random.default_rng(SEED + 50).random((hp['N'], 1, hp['F']), dtype=np.float32)
    Vc = np.random.default_rng(SEED).random((hc['N'], hc['C']) + tuple(hc['S']),
                                            dtype=np.float32)

    def flagship(mesh=None, **kw):
        return TransformInvariantNMF(f['M'], tuple(f['A']), reconstruction_mode=f['mode'],
                                     seed=SEED, device=device, mesh=mesh, **kw)

    def hals_plain(mesh=None, **kw):
        return TransformInvariantNMF(hp['M'], (hp['F'],), reconstruction_mode='full', seed=SEED,
                                     device=device, mesh=mesh, **kw)

    def hals_conv(mesh=None, **kw):
        return TransformInvariantNMF(hc['M'], tuple(hc['A']), reconstruction_mode='full',
                                     seed=SEED, device=device, mesh=mesh, **kw)
    return [
        ('plain', flagship, V, dict(sparsity_H=f['sparsity']), it['plain'],
         dict(mu_w=1, grad_w=1, mu_h=1)),
        ('inhibited', flagship, V, dict(sparsity_H=f['sparsity'],
                                        inhibition_strength=f['inhibition']),
         it['inhibited'], dict(mu_w=1, grad_w=1, inhibited_mu_h=1)),
        ('hals_plain', hals_plain, V2, dict(solver='hals'), it['hals_plain'],
         dict(hals_sweep=2)),
        ('hals_conv', hals_conv, Vc, dict(solver='hals', sparsity_H=hc['sparsity']),
         it['hals_conv'], dict(hals_sweep=math.prod(hc['A']), grad_w=1, mu_ratio=1)),
    ]


def _mesh_fit(label: str, nmf, V, fit: dict, n: int, per_iteration: dict) -> dict:
    """``nmf.fit(V, n_iterations=n, **fit)``, counts reset before and read
    after: each kernel of ``per_iteration`` launched that many times per
    iteration, no other, and no plain version called."""
    reset_counts()
    with plain_calls() as plain:
        nmf.fit(V, n_iterations=n, **fit)
    if DEVICE == 'cuda':
        sync()
    launches = counts()
    want = dict.fromkeys(KERNELS, 0)
    want.update({k: v * n for k, v in per_iteration.items()})
    if launches != want or any(plain.values()):
        raise AssertionError(f'{label} on a mesh: launches {launches} (plain versions '
                             f'{plain}), not {want}')
    return launches


def _mesh_ms(model, fit: dict, n: int) -> float:
    """Device ms per MU iteration of ``model`` on its mesh (CUDA events), the
    W statistics all-reduced over the model's process group."""
    args, flags = _fit_kw(fit)

    def run():
        model._W, model._H = engine.fit_loop(model._Vp, model._W, model._H, n, *args,
                                             model._kernels, plan=model._plan,
                                             strategy=model._strategy,
                                             process_group=model._pg, **flags)
    return time_ms(run, reps=1) / n


def mesh_worker(store: str, rank: int, out: str, cfg: dict) -> None:
    """One rank of phase 23's world of two (``python3 chip_smoke.py
    --mesh-worker STORE RANK OUT CONFIG``): every fit of :func:`_mesh_fits`
    on ``make_mesh()`` over gloo (the two ranks share the card), its
    launches required; W, this rank's rows of H, the launches and ms per
    iteration of the plain flagship into ``OUT/rank<rank>.npz``."""
    from tnmf_tpu_torch.parallel import distributed, make_mesh
    distributed.initialize(store, num_processes=2, process_id=rank, backend='gloo',
                           timeout=MESH_TIMEOUT)
    try:
        mesh = make_mesh(devices=cfg['device'])
        res, launches = {}, {}
        for label, make, V, fit, n, per_iteration in _mesh_fits(cfg):
            nmf = make(mesh)
            launches[label] = _mesh_fit(f'rank {rank} {label}', nmf, V, fit, n, per_iteration)
            res[f'{label}/W'], res[f'{label}/H'] = nmf.W, nmf._local_H()
            if label == 'plain' and cfg['device'] == 'cuda':
                res['plain/ms'] = np.float64(_mesh_ms(nmf, fit, n))
            del nmf
        res['launches'] = np.array(json.dumps(launches))
        np.savez(Path(out) / f'rank{rank}.npz', **res)
        log(f'rank {rank}: launches {json.dumps(launches)}')
    finally:
        torch.distributed.destroy_process_group()


def _world_one(cfg: dict) -> tuple:
    """Phase 23 (a): a world of one in this process (NCCL on the card); each
    fit on ``make_mesh()`` and the flagship's also without a mesh (the
    all-reduce of one rank is the identity: bit-equal required), the
    plain-NMF HALS fit also in float64 (C3's reference).  Returns the
    launches, the references and the numbers."""
    from tnmf_tpu_torch.parallel import distributed, make_mesh
    distributed.initialize(num_processes=1)
    backend = torch.distributed.get_backend()
    total, refs, out = dict.fromkeys(KERNELS, 0), {}, dict(backend=backend)
    try:
        mesh = make_mesh(devices=DEVICE)
        for label, make, V, fit, n, per_iteration in _mesh_fits(cfg):
            meshed = make(mesh)
            for name, k in _mesh_fit(label, meshed, V, fit, n, per_iteration).items():
                total[name] += k
            refs[label] = (meshed.W, meshed._local_H())
            if label.startswith('hals'):
                if label == 'hals_plain':
                    ref64 = make(dtype=torch.float64)
                    ref64.fit(V, n_iterations=n, **fit)
                    refs['hals_plain_float64'] = (ref64.W, ref64.H)
                    del ref64
                del meshed
                continue
            free = make()
            _mesh_fit(f'{label} without a mesh', free, V, fit, n, per_iteration)
            same = torch.equal(meshed._W, free._W) and torch.equal(meshed._H, free._H)
            log(f'  (a) {label}: world of one on {backend} against no mesh: '
                f'{"bit-equal" if same else "DIFFERENT"}; energy {meshed._energy_function()!r}')
            if not same:
                raise AssertionError(f'phase 23 (a) {label}: the world of one is not bit-equal '
                                     'to the mesh-free fit')
            if label == 'plain' and DEVICE == 'cuda':
                ms = dict(no_mesh=[], mesh=[])
                for key, model in (('no_mesh', free), ('mesh', meshed), ('mesh', meshed),
                                   ('no_mesh', free)):
                    ms[key].append(_mesh_ms(model, fit, n))
                # the W statistics' all-reduce alone, and with the stacking of
                # the pair into one buffer (engine.all_reduce_sum), in turns
                W, group = meshed._W, mesh.get_group()
                stats = torch.zeros(2 * W.numel(), dtype=W.dtype, device=W.device)
                calls = dict(all_reduce=lambda: torch.distributed.all_reduce(stats, group=group),
                             all_reduce_sum=lambda: engine.all_reduce_sum(
                                 W, W, process_group=group))
                reduce = dict(all_reduce=[], all_reduce_sum=[])
                for key in ('all_reduce', 'all_reduce_sum', 'all_reduce_sum', 'all_reduce'):
                    reduce[key].append(time_ms(calls[key], reps=100))
                pair_ms = float(np.mean(reduce['all_reduce_sum']))
                out.update(ms_per_iteration=ms, all_reduce_ms=reduce,
                           all_reduce_share=pair_ms / float(np.mean(ms['mesh'])))
                log(f'  (a) flagship ms/iteration in turns (no mesh, mesh, mesh, no mesh): '
                    f'{ms["no_mesh"][0]:.4f}, {ms["mesh"][0]:.4f}, {ms["mesh"][1]:.4f}, '
                    f'{ms["no_mesh"][1]:.4f}; the {stats.numel()} statistics\' all_reduce '
                    f'alone {reduce["all_reduce"][0]:.4f}/{reduce["all_reduce"][1]:.4f} ms, '
                    f'with the stacking (engine.all_reduce_sum) '
                    f'{reduce["all_reduce_sum"][0]:.4f}/{reduce["all_reduce_sum"][1]:.4f} ms '
                    f'(in turns, 100 calls a window), {100 * out["all_reduce_share"]:.2f} % of '
                    'an iteration on the mesh')
            del meshed, free
    finally:
        torch.distributed.destroy_process_group()
    return total, refs, out


def _close(a: np.ndarray, b: np.ndarray) -> float:
    """The largest ``|a - b| / (atol + rtol |b|)``: at most 1 within
    ``MESH_RTOL`` and ``MESH_ATOL``."""
    return float(np.max(np.abs(a - b) / (MESH_ATOL + MESH_RTOL * np.abs(b))))


def _world_two(cfg: dict, refs: dict) -> dict:
    """Phase 23 (b) and (c): two workers sharing the card over gloo, held
    against the world of one's fits."""
    with tempfile.TemporaryDirectory() as tmp:
        store = 'file://' + str(Path(tmp) / 'store')
        children = [subprocess.Popen(
            [sys.executable, str(ROOT / 'chip_smoke.py'), '--mesh-worker', store, str(rank), tmp,
             json.dumps(cfg)], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for rank in range(2)]
        outputs = []
        try:
            for child in children:
                outputs.append(child.communicate(timeout=MESH_TIMEOUT))
        finally:
            for child in children:
                if child.poll() is None:
                    child.kill()
                    child.wait()
        for rank, ((stdout, stderr), child) in enumerate(zip(outputs, children)):
            log(f'  (b) worker {rank}: exit {child.returncode}; {stdout.strip()[-600:]!r} '
                f'{stderr.strip()[-600:]!r}')
        if any(child.returncode != 0 for child in children):
            raise AssertionError('phase 23: a worker of the world of two failed')
        ranks = [dict(np.load(Path(tmp) / f'rank{r}.npz')) for r in range(2)]
    out = dict(launches=[json.loads(str(r['launches'])) for r in ranks])
    if 'plain/ms' in ranks[0]:
        out['ms_per_iteration_per_rank'] = [float(r['plain/ms']) for r in ranks]
        log('  (b) flagship ms/iteration on each rank (32 samples, the card shared with the '
            'other rank, timed at once): '
            + ', '.join(f'{t:.4f}' for t in out['ms_per_iteration_per_rank']))
    for label in ('plain', 'inhibited'):
        W1, H1 = refs[label]
        n = H1.shape[0] // 2
        worst = max(max(_close(r[f'{label}/W'], W1),
                        _close(r[f'{label}/H'], H1[i * n:(i + 1) * n]))
                    for i, r in enumerate(ranks))
        out[label] = worst
        log(f'  (b) {label}: world of two against world of one, largest |a - b| / '
            f'({MESH_ATOL} + {MESH_RTOL} |b|) = {worst:.3e} (at most 1)')
        if not worst <= 1:
            raise AssertionError(f'phase 23 (b) {label}: {worst:.3e} past the bound')
    W64, H64 = refs['hals_plain_float64']
    W1, H1 = refs['hals_plain']
    W2 = ranks[0]['hals_plain/W']
    H2 = np.concatenate([r['hals_plain/H'] for r in ranks])
    one = max(_rel(W1, W64), _rel(H1, H64))
    two = max(_rel(W2, W64), _rel(H2, H64))
    out['hals_plain'] = dict(world_one_float64=one, world_two_float64=two)
    log(f'  (c) HALS plain NMF: max|x - x64| / max|x64| of W and H: world of one {one:.3e}, '
        f'world of two {two:.3e} (at most twice the first)')
    if not two <= 2 * one:
        raise AssertionError(f'phase 23 (c) plain-NMF HALS: {two:.3e} > 2 x {one:.3e}')
    W1, H1 = refs['hals_conv']
    H2 = np.concatenate([r['hals_conv/H'] for r in ranks])
    conv = max(_rel(ranks[0]['hals_conv/W'], W1), _rel(ranks[1]['hals_conv/W'], W1),
               _rel(H2, H1))
    out['hals_conv'] = conv
    log(f'  (c) HALS shift-invariant: world of two against world of one {conv:.3e} '
        f'(at most {MESH_HALS_CONV_TOL})')
    if not conv <= MESH_HALS_CONV_TOL:
        raise AssertionError(f'phase 23 (c) shift-invariant HALS: {conv:.3e} off')
    return out


def _mesh_cli() -> dict:
    """Phase 23 (d): the CLI's data-parallel examples as subprocesses, both
    at once, with ``TNMF_TPU_SMOKE=1``."""
    env = dict(os.environ, TNMF_TPU_SMOKE='1')
    children = [(args, expect, subprocess.Popen(
        [sys.executable, '-m', 'tnmf_tpu_torch.cli', *args], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)) for args, expect in MESH_CLI]
    out = {}
    try:
        t0 = time.perf_counter()
        for args, expect, child in children:
            stdout, stderr = child.communicate(timeout=MESH_TIMEOUT)
            out[' '.join(args)] = child.returncode
            log(f'  (d) tnmf-tpu-torch {" ".join(args)}: exit {child.returncode}; '
                f'{stdout.strip()[-400:]!r} {stderr.strip()[-300:]!r}')
            if child.returncode != 0 or expect not in stdout:
                raise AssertionError(f'phase 23 (d): tnmf-tpu-torch {" ".join(args)} failed')
        out['seconds'] = time.perf_counter() - t0
    finally:
        for _, _, child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
    return out


def phase_mesh() -> tuple:
    """Phase 23: data parallelism over the samples, (a) to (d) in the
    module docstring.  Returns the world of one's launches and the
    numbers."""
    t_phase = time.perf_counter()
    cfg = _mesh_config()
    total, refs, world_one = _world_one(cfg)
    world_two = _world_two(cfg, refs)
    cli = _mesh_cli()
    seconds = time.perf_counter() - t_phase
    two = dict.fromkeys(KERNELS, 0)
    for rank in world_two['launches']:
        for fit in rank.values():
            for name, n in fit.items():
                two[name] += n
    log(f'  phase 23: world of one launches {total}, world of two {two}; {seconds:.1f} s')
    return total, dict(world_one=world_one, world_two=world_two, world_two_launches=two,
                       cli=cli, seconds=seconds)


def main() -> int:
    device = phase_device()
    phase_build()
    log('kernels against their plain versions:')
    errors = phase_kernels()
    phase_golden()
    launches, iterations, _, nmf = phase_flagship()
    phase_3d()
    log('large atoms (16 channels, 31 x 31):')
    phase_large()
    log('float64 goldens on the card:')
    phase_float64()
    log('per-kernel times at the flagship shapes:')
    times = phase_times(nmf)
    W = nmf.W
    del nmf
    log('encoder at the flagship (phase 5\'s dictionary, new data):')
    enc_launches, enc_iterations, enc = phase_encoder(W)
    log('encoder times: ' + json.dumps(enc))
    log('fit loops on the golden 2-D fixture:')
    phase_fit_loops()
    log('the fft and dot strategies:')
    st_launches, st_iterations, st = phase_strategies()
    log('strategy times: ' + json.dumps(st))
    log('minibatch and streaming (phase 13):')
    mb_launches, mb = phase_minibatch()
    log('minibatch times: ' + json.dumps(mb))
    log('the objectives (phase 14):')
    obj_launches, obj = phase_objectives()
    log(f'objective times ({card()}): ' + json.dumps(obj))
    log('transform groups and initialisation (phase 15):')
    grp_launches, grp = phase_transforms()
    log(f'transform group times ({card()}): ' + json.dumps(grp))
    log('HALS (phase 16):')
    hals_launches, hals_out = phase_hals()
    log(f'HALS times ({card()}): ' + json.dumps(hals_out))
    log('the serving artifact (phase 17):')
    srv_launches, srv = phase_serving(W)
    log(f'serving times ({card()}): ' + json.dumps(srv))
    log('precision (phase 18):')
    prec_launches, prec = phase_precision(W)
    log(f'precision times ({card()}): ' + json.dumps(prec))
    log('the sweeps (phase 19):')
    sw_launches, sw = phase_sweeps()
    log(f'sweep times ({card()}): ' + json.dumps(sw))
    log('the multi-scale model (phase 20):')
    ms_launches, ms_out = phase_multiscale()
    log(f'multi-scale times ({card()}): ' + json.dumps(ms_out))
    log('the tools (phase 21):')
    tl_launches, tl_out = phase_tools()
    log(f'tool numbers ({card()}): ' + json.dumps(tl_out))
    log('the examples and demos (phase 22):')
    ex_launches, ex_out = phase_examples()
    log(f'example and demo times ({card()}): ' + json.dumps(ex_out))
    log('data parallelism over the samples (phase 23):')
    mesh_launches, mesh_out = phase_mesh()
    log(f'mesh numbers ({card()}): ' + json.dumps(mesh_out))
    srv_per_iteration = {kind: d['launches_per_iteration'] for kind, d in srv.items()}
    k5 = hals_out['k5']
    errors['hals_sweep'] = k5[K5_CASES[0][0]]['max_abs_err']
    times['hals_sweep'] = dict(
        {k: k5[K5_CASES[0][0]][k] for k in ('ms', 'plain_ms', 'bound_ms', 'bound_by',
                                            'library_ms')},
        cases_ms={where: k5[where]['ms'] for where, *_ in K5_CASES})
    per_iteration = {cfg: hals_out[cfg]['launches_per_iteration']
                     for cfg in ('plain_nmf', 'shift_invariant')}
    asg = mb['ASG_MU']['launches_per_epoch']
    at_128 = grp['kernels_128_maps']
    rows = [dict(name=name, route='cuda', source=k['source'], replaces=k['replaces'],
                 launches=(launches[name] + enc_launches[name] + st_launches[name]
                           + mb_launches[name] + obj_launches[name] + grp_launches[name]
                           + hals_launches[name] + srv_launches[name]
                           + prec_launches[name] + sw_launches[name] + ms_launches[name]
                           + tl_launches[name] + ex_launches[name]
                           + ex_out['demo_launches'][name] + mesh_launches[name]),
                 launches_per_iteration=launches[name] / max(iterations[name], 1),
                 encoder_launches_per_iteration=(enc_launches[name]
                                                 / max(enc_iterations[name], 1)),
                 fft_dot_launches_per_iteration=(st_launches[name]
                                                 / max(st_iterations[name], 1)),
                 asg_mu_bs16_launches_per_epoch=asg[name],
                 d4_flagship_128_maps=at_128.get(name),
                 hals_launches_per_iteration={cfg: n.get(name, 0)
                                              for cfg, n in per_iteration.items()},
                 serving_launches=srv_launches[name],
                 serving_launches_per_iteration={kind: n.get(name, 0)
                                                 for kind, n in srv_per_iteration.items()},
                 precision_launches=prec_launches[name],
                 default_launches_per_iteration={
                     path: prec[path]['launches_per_iteration_at_default'].get(name, 0)
                     for path in ('conv flagship plain', 'conv flagship inhibited',
                                  'transform')},
                 model_launches=sw_launches[name],
                 sweep_launches_per_iteration={
                     run: sw[run]['launches_per_iteration'].get(name, 0) for run in 'abcdefg'},
                 model_axis=sw['kernels'].get(name),
                 multiscale_launches=ms_launches[name],
                 multiscale_launches_per_iteration=(
                     ms_out['flagship']['launches_per_iteration'].get(name, 0)),
                 tools_launches=tl_launches[name],
                 examples_launches=ex_launches[name],
                 demos_launches=ex_out['demo_launches'][name],
                 mesh_launches=mesh_launches[name],
                 mesh_world_two_launches=mesh_out['world_two_launches'][name],
                 max_abs_err=errors[name], **times[name])
            for name, k in KERNELS.items()]
    log(device['smi'])  # again here: the build's report may push the first one out of a tail
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': dict(platform=device['platform'],
                                                 kind=device['kind'], count=device['count'])}),
          flush=True)
    return 0


if __name__ == '__main__':
    if len(sys.argv) == 6 and sys.argv[1] == '--mesh-worker':
        mesh_worker(sys.argv[2], int(sys.argv[3]), sys.argv[4], json.loads(sys.argv[5]))
        sys.exit(0)
    sys.exit(main())
