"""Execution engine of the multiplicative-update (MU) algorithm, in PyTorch.

Port of the full-batch MU path of :mod:`tnmf_tpu.engine`: the same functions
with the same ``(W, H)`` result contract, run eagerly.  The fit loop is a
Python loop; each iteration updates H, then W (reference ``fit_batch`` loop
body, ``TransformInvariantNMF.py:334-340``).

Three strategies of the JAX package are ported: direct convolution
(:mod:`tnmf_tpu_torch.ops.conv`), FFT (:mod:`tnmf_tpu_torch.ops.fft`) and
the plain-NMF matmuls (:mod:`tnmf_tpu_torch.ops.dot`).  The functions here
take the JAX engine's ``strategy`` keyword (default ``'conv'``) and look its
operators up with :func:`get_ops`; the TPU-only ``'phased'`` lowering is
refused by :func:`require_ported`.  On CUDA tensors the hot operators run
through the hand-written kernels.  On the conv strategy: the H update
through K3 (:func:`~tnmf_tpu_torch.kernels.mu_h.mu_h`), the W statistics
through K2 (:func:`~tnmf_tpu_torch.kernels.gw.grad_w`).  On fft and dot the
strategy's own operators form the gradient pairs (cuFFT and cuBLAS) and K1
(:func:`~tnmf_tpu_torch.kernels.mu.mu_ratio`) forms the H ratio, where the
JAX engine forms ``H * neg / (pos + EPS + sparsity)`` in ``jnp``
(``tnmf_tpu/engine.py:479``; ``pallas_mu.mu_ratio`` is the TPU kernel with
that body, which nothing there calls).  K2 and K3 stay conv-only, as
``pallas_gw`` and ``pallas_phased`` do.  On every strategy the W ratio with
the atom normalisation runs through K1's W epilogue
(:func:`~tnmf_tpu_torch.kernels.mu.mu_w`) and the inhibited H update
(lateral inhibition on) through K4
(:func:`~tnmf_tpu_torch.kernels.inhibit.inhibited_mu_h`).  On CPU tensors
the same wrappers run their plain versions.  The conv reconstruction stays a
convolution (cuDNN), as the JAX package left it to XLA.

Kernel gates, asked before any launch: K2, K3 and K4 serve float32
problems with 1-D and 2-D shifts, the scope of the JAX package's own
kernels (their ``supported`` gates take float32 and 1-2 shift axes), and
:func:`plain_reason` sends a 3-D or rank-4 problem, or float64 (the port's
reference precision, not its throughput path), to their plain versions on
every device.  K1 is elementwise with a row sum and takes any shape:
:func:`dtype_reason` gates it on the dtype alone, so a 3-D or rank-4
float32 fit still runs ``mu_ratio`` and ``mu_w``.

Precision: ``plan.precision`` (the JAX package's ``precision``) sets every
contraction's, by :func:`~tnmf_tpu_torch.ops.precision.settings`: on
float32 CUDA tensors 'default' and 'high' run TF32, None and 'highest'
full float32; on the CPU every level runs full float32.  The fft and dot
products (cuBLAS) obey the process-global
``torch.set_float32_matmul_precision``: the functions here that run them
pin the level's setting (:func:`~tnmf_tpu_torch.ops.precision.matmul_pin`)
once, at the outermost call, so a fit loop sets it before its first
iteration and gives the caller's setting back after its last.  The conv
strategy's convolutions pin cuDNN at the plan's level each
(:mod:`tnmf_tpu_torch.ops.conv`), and K3 and K2 run their tensor-core
routes in one TF32 pass at a TF32 level, three (3xTF32) otherwise.

The fit-loop variants (:func:`fit_loop_energies`, :func:`fit_loop_tol`,
:func:`fit_loop_extrapolated`), the single steps (:func:`update_H_step`,
:func:`update_W_step`) and the encoder's start (:func:`correlate_init_H`)
reach the kernels through :func:`_mu_H` and :func:`_mu_W`, which look the
wrappers up by this module's names at every call; :func:`_mu_H` is the
reconstruction followed by :func:`_mu_H_of`, the H step against a given
reconstruction, which the multi-scale model
(:mod:`tnmf_tpu_torch.models.multiscale`) calls with the total one.  :func:`_mu_W` is
:func:`grad_W_stats` followed by :func:`apply_W_update`; the minibatch
epochs (:mod:`tnmf_tpu_torch.engine_minibatch`) call the two apart, with
:func:`accumulate_gradient` between them.  The JAX package runs its
adaptive loops as one on-device ``lax.while_loop``; here their stopping
tests run on the host, one synchronisation per block.

Each of these functions takes the model's kernel/plain switch as
``use_pallas`` (default True): False runs the plain versions of K1-K4 on
any device, as one more reason of :func:`plain_reason` and
:func:`dtype_reason`.

Data parallelism over the samples (:mod:`tnmf_tpu_torch.parallel`): the
functions that sum over the samples take a ``process_group`` (default
None).  Each rank then holds its own rows of the data and of H and a
replica of W, and every sum over the samples is one ``all_reduce`` over
that group (:func:`all_reduce_sum`): the W statistics before
:func:`apply_W_update` (so ``ortho_W``'s term, formed from the replicated
W after it, is counted once), the energy, and the sums of
:func:`correlate_init_H`.  The loops read their stopping tests off the
reduced energy, so every rank stops at the same iteration.  With
``process_group=None`` no collective is issued and no tensor copied.

The objective is the JAX engine's: the beta-divergence of ``beta``
(default 2, the Euclidean energy), weighted by a ``mask``, with the ridge
penalty ``l2_H`` on H and the orthogonality penalty ``ortho_W`` on W
(None where absent, so the default path is the Euclidean one as it was).
The same kernels carry every objective, decided by no gate of their own:
K3 and K2 correlate whatever two prepared streams they are given, the
data and the reconstruction at beta = 2 (each masked with a mask), the
factor streams ``V * R**(beta-2)`` and ``R**(beta-1)`` otherwise
(:func:`_beta_factors`, :func:`_conv_streams`); ``l2_H * H`` joins K3's
``pos_extra`` on conv and the positive part before K1's ratio or K4
elsewhere, and the orthogonality gradient joins ``pos`` before K1's W
epilogue (:func:`apply_W_update`).

Transform groups (the JAX engine's ``(base, TransformGroup)`` strategy
tuple, :mod:`tnmf_tpu_torch.ops.transforms`): every function here takes
the tuple as its ``strategy`` and runs the base strategy on the expanded
dictionary ``W_exp`` of ``M*G`` atoms, H holding one map per (atom,
transform).  :func:`_mu_H` expands W once per H step and hands the same
``W_exp`` to the reconstruction and to K3 (or to the pair before K4);
:func:`grad_W_stats` ties K2's (or the strategy's) ``(M*G, C, *A)``
statistics back before :func:`apply_W_update`, so ``mu_w`` and
``ortho_W`` act on the canonical W only.

Strengths (``sparsity``, ``inhibition``, ``cross_inhibition``, ``l2``,
``ortho``) are Python floats in a single fit, or 0-d tensors: a sweep
(:mod:`tnmf_tpu_torch.models.sweep`) runs these functions under
:func:`torch.func.vmap` with per-model strengths, which ride in the
storage dtype as in the JAX package.  A float strength keeps the single
fit's arithmetic (and bits); a tensor reaches the kernels through the
operators' ``.t`` overloads, whose vmap rules launch each kernel once for
all the models (:mod:`tnmf_tpu_torch.kernels.ops`).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple, Union

import torch

from .kernels.gw import grad_w_plain
from .kernels.inhibit import inhibited_mu_h_plain
from .kernels.mu import mu_ratio_plain, mu_w_plain
from .kernels.mu_h import mu_h_plain
from .kernels.ops import grad_w, inhibited_mu_h, mu_h, mu_ratio, mu_w
from .ops import beta as beta_ops
from .ops import conv as conv_ops
from .ops import dot as dot_ops
from .ops import fft as fft_ops
from .ops.modes import ConvPlan
from .ops.precision import exporting, matmul_pin, settings
from .ops.transforms import GroupOps, TransformGroup, expand_w, split_strategy, tie_back

EPS = 1.0e-9  # reference: TransformInvariantNMF.py:166

#: shift ranks whose MU step runs through K2, K3 and K4
KERNEL_RANKS = (1, 2)

#: the operator module of each ported strategy
_OPS = {'conv': conv_ops, 'fft': fft_ops, 'dot': dot_ops}

#: an engine ``strategy``: a base strategy name, or ``(base, TransformGroup)``
#: for a transform-group fit (the JAX engine's tuple)
Strategy = Union[str, Tuple[str, TransformGroup]]


def require_ported(strategy) -> None:
    """Raise ``NotImplementedError`` for the TPU-only 'phased' lowering,
    ``ValueError`` for an unknown strategy (of a group's base strategy)."""
    strategy = split_strategy(strategy)[0]
    if strategy in _OPS:
        return
    if strategy == 'phased':
        raise NotImplementedError(
            "strategy 'phased' is not ported to tnmf_tpu_torch; see ROADMAP.md "
            'queue 1, item 15 (not ported: TPU-only lowering)')
    raise ValueError(
        f'unknown strategy {strategy!r}; choose "fft", "conv", "phased" or "dot"')


def get_ops(strategy):
    """The operator module of ``strategy`` ('conv', 'fft' or 'dot'):
    ``prepare_data`` / ``reconstruct`` / ``grad_H_pair`` / ``grad_W_pair``.
    A tuple ``(base, TransformGroup)`` gives the group adapter
    (:class:`~tnmf_tpu_torch.ops.transforms.GroupOps`) around the base's."""
    require_ported(strategy)
    base, group = split_strategy(strategy)
    return _OPS[base] if group is None else GroupOps(_OPS[base], group)


def _pinned(fn):
    """Run ``fn`` with its products at the level of its ``plan`` keyword
    (:func:`~tnmf_tpu_torch.ops.precision.matmul_pin`, for the device and
    dtype of its first tensor) when its ``strategy`` keyword (or a group's
    base strategy) is fft or dot; conv runs no matrix product and is left
    as it was.  Nested calls find the pin set and leave it.  While a
    program is exported the pin stands aside
    (:func:`~tnmf_tpu_torch.ops.precision.exporting`)."""
    @functools.wraps(fn)
    def call(*args, strategy: Strategy = 'conv', **kwargs):
        if split_strategy(strategy)[0] == 'conv' or exporting():
            return fn(*args, strategy=strategy, **kwargs)
        with matmul_pin(kwargs['plan'].precision, args[0].device, args[0].dtype):
            return fn(*args, strategy=strategy, **kwargs)
    return call


def _passes(plan: ConvPlan, t: torch.Tensor) -> int:
    """K2's and K3's TF32 passes for ``plan``'s precision on tensors like
    ``t`` (:func:`~tnmf_tpu_torch.ops.precision.settings`)."""
    return settings(plan.precision, t.device, t.dtype).passes


def resolve_strategy(strategy: str, plan: ConvPlan, allow_dot: bool = True) -> str:
    """The lowering a strategy request runs on: the degenerate
    single-transform problem (plain NMF) goes to 'dot' unless
    ``allow_dot`` is False (the multi-scale model keeps 'conv' there, as
    the JAX package's does).  The TPU-only 'phased' upgrade of the JAX
    package never applies here."""
    if strategy == 'conv' and allow_dot and math.prod(plan.transform_shape) == 1:
        return 'dot'
    return strategy


def choose_strategy(plan: ConvPlan) -> str:
    """Heuristic strategy for ``backend='auto'``, the JAX package's rule:
    direct convolution for small atoms, fft once the per-point direct cost
    (~prod(atom)) passes ``max(512, prod(sample)/64)``."""
    if math.prod(plan.transform_shape) == 1:
        return 'conv'
    if plan.ndim > 3:
        return 'fft'
    threshold = max(512, math.prod(plan.sample_shape) // 64)
    return 'conv' if math.prod(plan.atom_shape) <= threshold else 'fft'


def prepare_data(V: torch.Tensor, *, plan: ConvPlan, strategy: Strategy = 'conv') -> torch.Tensor:
    """Loop-invariant preprocessing of the data tensor (mode extension; its
    transform on fft)."""
    return get_ops(strategy).prepare_data(V, plan)


@_pinned
def reconstruct(W: torch.Tensor, H: torch.Tensor, *, plan: ConvPlan,
                strategy: Strategy = 'conv') -> torch.Tensor:
    """The model reconstruction ``R`` (canonical data layout); under a
    transform group from the expanded dictionary and H's ``M*G`` maps."""
    return get_ops(strategy).reconstruct(W, H, plan)


@_pinned
def partial_reconstruct(W: torch.Tensor, H: torch.Tensor, *, plan: ConvPlan,
                        i_atom: int, strategy: Strategy = 'conv') -> torch.Tensor:
    """Reconstruction restricted to one atom (reference ``_Backend.py:124``):
    under a transform group the atom with all its tied copies, H's maps
    ``i_atom*G .. (i_atom+1)*G - 1`` (m-major)."""
    group = split_strategy(strategy)[1]
    g = 1 if group is None else group.size
    return get_ops(strategy).reconstruct(W[i_atom:i_atom + 1],
                                         H[:, i_atom * g:(i_atom + 1) * g], plan)


@_pinned
def energy(V: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
           mask: Optional[torch.Tensor] = None, *, plan: ConvPlan, strategy: Strategy = 'conv',
           beta: float = 2.0, process_group=None) -> torch.Tensor:
    """Reconstruction objective ``D_beta(V || R)`` (``0.5 * sum((V - R)^2)``
    at the default beta = 2; :func:`tnmf_tpu_torch.ops.beta.divergence`),
    with ``mask`` the per-entry weighted one, as a 0-d tensor accumulated in
    ``promote_types(V.dtype, float32)``; summed over the ranks of
    ``process_group``."""
    e = beta_ops.divergence(V, reconstruct(W, H, plan=plan, strategy=strategy), beta, mask)
    return all_reduce_sum(e, process_group=process_group)[0]


def all_reduce_sum(*tensors: torch.Tensor, process_group=None) -> Tuple[torch.Tensor, ...]:
    """The sums of ``tensors`` (one dtype) over the ranks of
    ``process_group``, in one ``all_reduce``: flattened into one buffer,
    reduced, and handed back as contiguous views of it in their shapes.
    ``process_group=None`` returns them as they are."""
    if process_group is None:
        return tensors
    buf = torch.cat([t.reshape(-1) for t in tensors])
    torch.distributed.all_reduce(buf, group=process_group)
    return tuple(part.view(t.shape) for part, t in
                 zip(buf.split([t.numel() for t in tensors]), tensors))


def dtype_reason(dtype: torch.dtype, use_pallas: bool = True) -> Optional[str]:
    """Why K1 (``mu_ratio``, ``mu_w``) runs its plain version on ``dtype``
    tensors, or ``None`` when it runs the kernel (float32, any shape).
    ``use_pallas=False`` (the model's switch) is a reason of its own."""
    if not use_pallas:
        return 'use_pallas=False'
    if dtype != torch.float32:
        return f'{str(dtype).removeprefix("torch.")} tensors (the kernels take float32)'
    return None


def plain_reason(plan: ConvPlan, dtype: torch.dtype, use_pallas: bool = True) -> Optional[str]:
    """Why the MU step of ``plan`` on ``dtype`` tensors runs the plain
    versions of K2, K3 and K4, or ``None`` when it runs those kernels
    (float32, 1-D and 2-D shifts, ``use_pallas`` not False).  Decided from
    the plan, the dtype and the switch before any launch, never from a
    failed one."""
    if not use_pallas:
        return 'use_pallas=False'
    if plan.ndim not in KERNEL_RANKS:
        return f'{plan.ndim}-D shifts (K2, K3 and K4 take 1-D and 2-D)'
    return dtype_reason(dtype)


@functools.lru_cache(maxsize=8)
def _extension_pattern(plan: ConvPlan, strategy: str, n_channels: int, n: int,
                       dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``prepare_data`` of an all-ones ``(1, n_channels, *sample)`` tensor,
    the mode's boundary-extension pattern (1 over the extended data domain,
    0 in ``'valid'`` zero padding), repeated over ``n`` samples into one
    contiguous tensor (the JAX engine's ``_ones_prepared``, there a jit
    constant).  Built once per geometry: at beta = 1 it is the whole
    denominator stream ``B``, which K2 and K3 read at the batch's size."""
    ones = torch.ones((1, n_channels) + plan.sample_shape, dtype=dtype, device=device)
    P = get_ops(strategy).prepare_data(ones, plan)
    return P if n == 1 else P.expand((n,) + tuple(P.shape[1:])).contiguous()


def _beta_factors(ops, strategy: str, Vp: torch.Tensor, R: torch.Tensor, plan: ConvPlan,
                  beta: float, mask: Optional[torch.Tensor]):
    """``(A_prep, B_prep)``: the beta-divergence MU streams ``A = V *
    R**(beta-2)``, ``B = R**(beta-1)`` in the strategy's prepared domain
    (the JAX engine's ``_beta_factors`` and, with a mask, its
    ``_beta_grad_pair``).  ``B_prep`` is None at beta = 1 without a mask:
    ``B = 1``, the extension pattern (:func:`_extension_pattern`).

    Unmasked on conv and dot (``FACTORS_IN_PREPARED``) ``Vp`` is the
    loop-invariant ``prepare_data(V)`` and the factors are formed on
    prepared tensors; ``B``'s ``'valid'`` padding, where the floored R
    raised to ``beta - 1`` is not 0, is zeroed by the pattern.  On fft, and
    with a mask on every strategy, ``Vp`` is the canonical data: the
    factors are formed canonically, weighted by the mask, and prepared each
    iteration."""
    if mask is None and ops.FACTORS_IN_PREPARED:
        Rp = ops.prepare_data(R, plan)
        acc = torch.promote_types(Rp.dtype, torch.float32)
        Rs = torch.clamp(Rp.to(acc), min=beta_ops.EPS_R)
        Vc = Vp.to(acc)
        if beta == 1.0:
            return (Vc / Rs).to(R.dtype), None
        ones = _extension_pattern(plan, strategy, R.shape[1], 1, R.dtype, R.device).to(acc)
        if beta == 0.0:
            A, B = Vc / (Rs * Rs), ones / Rs
        else:
            A, B = Vc * Rs ** (beta - 2.0), ones * Rs ** (beta - 1.0)
        return A.to(R.dtype), B.to(R.dtype)
    A, B = beta_ops.factors(Vp, R, beta)
    if mask is None:
        return ops.prepare_data(A, plan), (None if beta == 1.0 else ops.prepare_data(B, plan))
    m = mask.to(A.dtype)
    return ops.prepare_data(A * m, plan), ops.prepare_data(B * m, plan)


def _conv_streams(Vp: torch.Tensor, R: torch.Tensor, plan: ConvPlan, beta: float,
                  mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two prepared streams whose correlations K3 and K2 take on the
    conv strategy: ``(Vp, ext(R))`` for the Euclidean objective (with a
    mask ``Vp`` is ``ext(mask * V)`` and R is masked here), the factor
    pair otherwise, with the extension pattern at the batch's size as ``B``
    at beta = 1."""
    if beta == 2.0:
        return Vp, conv_ops.extend_data(R if mask is None else R * mask.to(R.dtype), plan)
    A, B = _beta_factors(conv_ops, 'conv', Vp, R, plan, beta, mask)
    if B is None:
        if exporting():  # a symbolic batch: built in the program, not cached
            P = _extension_pattern.__wrapped__(plan, 'conv', R.shape[1], 1, A.dtype, A.device)
            B = P.expand(A.shape).contiguous()
        else:
            B = _extension_pattern(plan, 'conv', R.shape[1], A.shape[0], A.dtype, A.device)
    return A, B


def _grad_H_pair(ops, strategy: str, Vp: torch.Tensor, R: torch.Tensor, W: torch.Tensor,
                 plan: ConvPlan, beta: float,
                 mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(neg, pos)`` of the H gradient on fft and dot (the JAX engine's
    ``grad_H_pair`` / ``_beta_grad_H``), contiguous, as K1 and K4 take
    them.  At beta = 1 without a mask the denominator is the correlation
    of the extension pattern, run at batch 1 and broadcast."""
    if beta == 2.0:
        pair = ops.grad_H_pair(Vp, R if mask is None else R * mask.to(R.dtype), W, plan)
    else:
        A, B = _beta_factors(ops, strategy, Vp, R, plan, beta, mask)
        if B is None:
            neg = ops.corr_H(A, W, plan)
            ones = _extension_pattern(plan, strategy, W.shape[1], 1, R.dtype, R.device)
            pair = neg, ops.corr_H(ones, W, plan).expand(neg.shape)
        else:
            pair = ops.grad_H_pair_prepared(A, B, W, plan)
    # the kernels take contiguous tensors; fft's are crops of its transforms
    return tuple(g.contiguous() for g in pair)


@_pinned
def _mu_H(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor, sparsity: float,
          inhibition: float = 0., cross_inhibition: float = 0., kernels: Sequence = (),
          *, plan: ConvPlan, use_inhibition: bool = False,
          use_cross: bool = False, strategy: Strategy = 'conv',
          use_pallas: bool = True, beta: float = 2.0, mask: Optional[torch.Tensor] = None,
          l2: Optional[float] = None) -> torch.Tensor:
    """One multiplicative H update (reference ``_update_H``,
    ``TransformInvariantNMF.py:246-271``):
    ``H * corr(Xv, W) / (corr(Xr, W) + EPS + sparsity)``, fused in K3 on the
    conv strategy; on fft and dot the strategy's gradient pair, then K1's
    ratio.  With lateral inhibition (``use_inhibition`` same-atom,
    ``use_cross`` cross-atom) the gradient pair is computed alone (one
    stacked convolution on conv) and K4 adds the inhibition term and forms
    the ratio.  ``use_pallas=False`` runs the plain versions.

    The objective (the JAX engine's ``_mu_H`` keywords): ``Xv, Xr`` are
    ``V, R`` at the default ``beta`` = 2, the factor streams ``A, B`` of
    :func:`_beta_factors` otherwise.  With ``mask`` both are weighted by it:
    at beta = 2 ``Vp`` arrives as ``prepare(mask * V)`` (loop-invariant)
    and R is masked here, at other betas ``Vp`` is the canonical V and the
    factors are masked.  ``l2`` (None: absent) is the ridge weight on H:
    ``l2 * H`` joins the positive part, as K3's ``pos_extra`` on conv,
    added to ``pos`` before K1 or K4 elsewhere.  K3's tensor-core route
    runs the plan's TF32 passes (:func:`~tnmf_tpu_torch.ops.precision.settings`).

    Under a transform group (``strategy = (base, group)``) W is expanded
    once, and the reconstruction and K3 (or the stacked pair before K4)
    take the same ``W_exp`` of ``M*G`` atoms; H holds ``M*G`` maps, and
    cross-atom inhibition spans them all."""
    strategy, group = split_strategy(strategy)
    if group is not None:
        W = expand_w(W, group)
    return _mu_H_of(Vp, get_ops(strategy).reconstruct(W, H, plan), W, H, sparsity, inhibition,
                    cross_inhibition, kernels, plan=plan, use_inhibition=use_inhibition,
                    use_cross=use_cross, strategy=strategy, use_pallas=use_pallas, beta=beta,
                    mask=mask, l2=l2)


@_pinned
def _mu_H_of(Vp: torch.Tensor, R: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
             sparsity: float, inhibition: float = 0., cross_inhibition: float = 0.,
             kernels: Sequence = (), *, plan: ConvPlan, use_inhibition: bool = False,
             use_cross: bool = False, strategy: str = 'conv', use_pallas: bool = True,
             beta: float = 2.0, mask: Optional[torch.Tensor] = None,
             l2: Optional[float] = None) -> torch.Tensor:
    """:func:`_mu_H` against a given reconstruction ``R`` (canonical data
    layout) on a base ``strategy``, ``W`` the dictionary H's maps take (the
    expanded one under a group): on conv the streams of
    :func:`_conv_streams` from ``R``, then K3 (or the pair, then K4); on
    fft and dot the strategy's gradient pair against ``R``, then K1's
    ratio (or K4).  The multi-scale model passes the total reconstruction
    of all its scales (:mod:`tnmf_tpu_torch.models.multiscale`)."""
    reg = EPS + _strength(sparsity)
    kernels_on = plain_reason(plan, H.dtype, use_pallas) is None
    inhibited = use_inhibition or use_cross
    extra = None if l2 is None else _strength(l2) * H
    if strategy == 'conv':
        Xv, Xr = _conv_streams(Vp, R, plan, beta, mask)
        if not inhibited:
            return (mu_h if kernels_on else mu_h_plain)(Xv, Xr, W, H, reg, extra,
                                                        _passes(plan, H))
        neg, pos = conv_ops.grad_H_pair_prepared(Xv, Xr, W, plan)
    else:
        neg, pos = _grad_H_pair(get_ops(strategy), strategy, Vp, R, W, plan, beta, mask)
    if extra is not None:
        pos = pos + extra
    if not inhibited:  # fft and dot: K1's ratio
        ratio = mu_ratio if dtype_reason(H.dtype, use_pallas) is None else mu_ratio_plain
        return ratio(H, neg, pos, reg)
    update = inhibited_mu_h if kernels_on else inhibited_mu_h_plain
    return update(H, neg, pos, kernels, _strength(inhibition), _strength(cross_inhibition),
                  reg, use_same=use_inhibition, use_cross=use_cross)


def _strength(x):
    """A strength as the engine computes with it: a tensor (a sweep's, in
    the storage dtype) as it is, anything else as a Python float."""
    return x if isinstance(x, torch.Tensor) else float(x)


def _normalize_W(W: torch.Tensor, n_shift_axes: int) -> torch.Tensor:
    """Sum-normalize atoms; zero atoms stay zero instead of turning NaN."""
    s = W.sum(dim=tuple(range(-n_shift_axes, 0)), keepdim=True)
    return W / torch.where(s == 0, torch.ones_like(s), s)


@_pinned
def grad_W_stats(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, *, plan: ConvPlan,
                 strategy: Strategy = 'conv', use_pallas: bool = True,
                 beta: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``(neg, pos)`` statistics of the W gradient (the JAX engine's
    ``grad_W_stats``; reference ``_accumulate_gradient_W``,
    ``TransformInvariantNMF.py:444-455``): K2 on the stacked streams of
    :func:`_conv_streams` on the conv strategy, the strategy's gradient
    pair on fft and dot.  ``beta`` and ``mask`` select the objective as in
    :func:`_mu_H`; at beta = 1 without a mask the fft and dot denominator
    correlates the extension pattern with the batch-summed H, broadcast
    over the channels.  Sums over the samples of ``H``, so a minibatch's
    statistics add up.

    Under a transform group the statistics of the expanded dictionary
    (K2's ``(M*G, C, *A)`` on conv) are tied back to the canonical W's
    shape (:func:`~tnmf_tpu_torch.ops.transforms.tie_back`)."""
    strategy, group = split_strategy(strategy)
    if group is None:
        return _grad_W_pair(Vp, W, H, mask, plan, strategy, use_pallas, beta)
    neg, pos = _grad_W_pair(Vp, expand_w(W, group), H, mask, plan, strategy, use_pallas, beta)
    return tie_back(neg, group), tie_back(pos, group)


def _grad_W_pair(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                 mask: Optional[torch.Tensor], plan: ConvPlan, strategy: str,
                 use_pallas: bool, beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`grad_W_stats` on a base strategy, for the dictionary ``W``
    whose atoms are H's maps."""
    R = get_ops(strategy).reconstruct(W, H, plan)
    return grad_W_pair_of(Vp, R, H, mask, plan, strategy, use_pallas, beta)


def grad_W_pair_of(Vp: torch.Tensor, R: torch.Tensor, H: torch.Tensor,
                   mask: Optional[torch.Tensor], plan: ConvPlan, strategy: str,
                   use_pallas: bool, beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_grad_W_pair` from a given reconstruction ``R`` (the
    shift-invariant HALS solver passes ``V - E`` from its maintained
    residual): K2 on the stacked streams on conv (at the plan's TF32
    passes)."""
    ops = get_ops(strategy)
    if strategy == 'conv':
        grad = grad_w if plain_reason(plan, H.dtype, use_pallas) is None else grad_w_plain
        return grad(torch.cat(_conv_streams(Vp, R, plan, beta, mask), dim=1), H,
                    _passes(plan, H))
    if beta == 2.0:
        return ops.grad_W_pair(Vp, R if mask is None else R * mask.to(R.dtype), H, plan)
    A, B = _beta_factors(ops, strategy, Vp, R, plan, beta, mask)
    if B is not None:
        return ops.grad_W_pair_prepared(A, B, H, plan)
    neg = ops.corr_W(A, H, plan)
    ones = _extension_pattern(plan, strategy, 1, 1, R.dtype, R.device)
    return neg, ops.corr_W(ones, H.sum(dim=0, keepdim=True), plan).expand(neg.shape)


def _ortho_positive_term(W: torch.Tensor, ortho: float) -> torch.Tensor:
    """Gradient of the cross-atom orthogonality penalty ``(ortho/2) *
    sum_{m != m'} <W_m, W_m'>``: ``ortho * sum_{m' != m} W_m'``, nonnegative,
    so it joins the positive part (the JAX engine's ``_ortho_positive_term``)."""
    return _strength(ortho) * (W.sum(dim=0, keepdim=True) - W)


def apply_W_update(W: torch.Tensor, neg: torch.Tensor, pos: torch.Tensor,
                   ortho_W: Optional[float] = None, *, n_shift_axes: int,
                   use_pallas: bool = True) -> torch.Tensor:
    """``normalize(W * neg / (pos + EPS))`` from given statistics (the JAX
    engine's ``apply_W_update``) in one launch of K1's W epilogue (any
    rank).  ``ortho_W`` (None: absent) adds the orthogonality gradient of
    the *current* W to ``pos`` before the launch, never to the statistics,
    which the minibatch algorithms average over earlier dictionaries.  The
    kernel takes contiguous tensors: fft's pair and plain K2's (3-D fits)
    are views; K2's own, and summed or averaged statistics, are contiguous
    already, so no copy there."""
    if ortho_W is not None:
        pos = pos + _ortho_positive_term(W, ortho_W)
    epilogue = mu_w if dtype_reason(W.dtype, use_pallas) is None else mu_w_plain
    return epilogue(W, neg.contiguous(), pos.contiguous(), EPS, n_shift_axes)


def accumulate_gradient(acc_neg: torch.Tensor, acc_pos: torch.Tensor, neg: torch.Tensor,
                        pos: torch.Tensor,
                        sag_lambda: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The running W statistics of the minibatch algorithms (the JAX
    engine's ``accumulate_gradient``): ``sag_lambda == 1`` sums (the
    reference's within-epoch accumulation), any other value averages
    exponentially, ``(1 - sag_lambda) * acc + sag_lambda * new``."""
    if sag_lambda == 1.0:
        return acc_neg + neg, acc_pos + pos
    keep = 1.0 - sag_lambda
    return keep * acc_neg + sag_lambda * neg, keep * acc_pos + sag_lambda * pos


@_pinned
def _mu_W(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor, *,
          plan: ConvPlan, strategy: Strategy = 'conv', use_pallas: bool = True,
          beta: float = 2.0, mask: Optional[torch.Tensor] = None,
          ortho: Optional[float] = None, process_group=None) -> torch.Tensor:
    """One multiplicative W update with atom-wise sum normalization
    (reference ``_update_W`` + ``normalize``, ``TransformInvariantNMF.py:240-244``):
    :func:`grad_W_stats`, summed over the ranks of ``process_group`` in one
    ``all_reduce``, then :func:`apply_W_update` (``ortho``: the
    orthogonality weight, None when absent)."""
    neg, pos = grad_W_stats(Vp, W, H, mask, plan=plan, strategy=strategy,
                            use_pallas=use_pallas, beta=beta)
    neg, pos = all_reduce_sum(neg, pos, process_group=process_group)
    return apply_W_update(W, neg, pos, ortho, n_shift_axes=plan.ndim, use_pallas=use_pallas)


@_pinned
def update_step(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                sparsity: float, inhibition: float = 0., cross_inhibition: float = 0.,
                kernels: Sequence = (), *, plan: ConvPlan, update_H: bool = True,
                update_W: bool = True, use_inhibition: bool = False,
                use_cross: bool = False, strategy: Strategy = 'conv',
                use_pallas: bool = True, beta: float = 2.0,
                mask: Optional[torch.Tensor] = None, l2_H: Optional[float] = None,
                ortho_W: Optional[float] = None,
                process_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One full MU iteration: H update, then W update.  Returns ``(W, H)``.
    ``use_pallas=False`` runs the plain versions of the kernels; ``beta``,
    ``mask``, ``l2_H`` and ``ortho_W`` (None: absent) are the objective's,
    the JAX engine's keywords; ``process_group`` the ranks whose W
    statistics add up."""
    if update_H:
        H = _mu_H(Vp, W, H, sparsity, inhibition, cross_inhibition, kernels, plan=plan,
                  use_inhibition=use_inhibition, use_cross=use_cross, strategy=strategy,
                  use_pallas=use_pallas, beta=beta, mask=mask, l2=l2_H)
    if update_W:
        W = _mu_W(Vp, W, H, plan=plan, strategy=strategy, use_pallas=use_pallas, beta=beta,
                  mask=mask, ortho=ortho_W, process_group=process_group)
    return W, H


@_pinned
def fit_loop(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
             n_iterations: int, sparsity: float, inhibition: float = 0.,
             cross_inhibition: float = 0., kernels: Sequence = (), *, plan: ConvPlan,
             strategy: Strategy = 'conv', **step) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_iterations`` MU iterations.  Returns ``(W, H)``.  ``kernels`` are
    the per-axis inhibition kernels, read when ``use_inhibition`` or
    ``use_cross`` is set; ``step`` holds :func:`update_step`'s other
    keywords."""
    for _ in range(int(n_iterations)):
        W, H = update_step(Vp, W, H, sparsity, inhibition, cross_inhibition, kernels,
                           plan=plan, strategy=strategy, **step)
    return W, H


def energy_trace(V: torch.Tensor, n: int) -> torch.Tensor:
    """An energy trace of ``n`` entries, NaN until written, on ``V``'s
    device in the accumulation dtype of :func:`energy`."""
    acc = torch.promote_types(V.dtype, torch.float32)
    return torch.full((n,), math.nan, dtype=acc, device=V.device)


@_pinned
def fit_loop_energies(Vp: torch.Tensor, V: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                      sparsity: float, inhibition: float = 0., cross_inhibition: float = 0.,
                      kernels: Sequence = (), *, n_iterations: int, plan: ConvPlan,
                      strategy: Strategy = 'conv', beta: float = 2.0,
                      mask: Optional[torch.Tensor] = None, process_group=None,
                      **step) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n_iterations`` MU iterations that also record the energy (of
    ``beta`` and ``mask``) after each one (one more reconstruction per
    iteration; reference ``TransformInvariantNMF.py:346``).  The trace
    stays on the device: the caller synchronises once when it reads it.
    ``step`` holds :func:`update_step`'s other keywords.  Returns ``(W, H,
    energies)``."""
    energies = energy_trace(V, int(n_iterations))
    for i in range(int(n_iterations)):
        W, H = update_step(Vp, W, H, sparsity, inhibition, cross_inhibition, kernels,
                           plan=plan, strategy=strategy, beta=beta, mask=mask,
                           process_group=process_group, **step)
        energies[i] = energy(V, W, H, mask, plan=plan, strategy=strategy, beta=beta,
                             process_group=process_group)
    return W, H, energies


def _block_change(e_prev: torch.Tensor, e: torch.Tensor,
                  scale: torch.Tensor) -> Tuple[float, float]:
    """``(e_prev - e, (e_prev - e) / scale)`` in the accumulation dtype,
    read to the host in one synchronisation."""
    d = e_prev - e
    diff, rel = torch.stack([d, d / scale]).tolist()
    return diff, rel


def _tol_start(e0: torch.Tensor, tol: float) -> Tuple[torch.Tensor, float]:
    """The scale ``max(e0, tiny)`` of the relative improvement from the
    initial energy ``e0``, and ``tol`` rounded to the accumulation dtype
    (the JAX package compares in that dtype)."""
    scale = torch.clamp(e0, min=torch.finfo(e0.dtype).tiny)
    return scale, float(torch.tensor(tol, dtype=e0.dtype))


def tol_loop(carry, step, energy_of, n_max: int, tol: float, check_every: int, n_buf: int,
             like: torch.Tensor):
    """The ``(e_prev - e) / e_init < tol`` protocol of the JAX package's
    ``fit_loop_tol`` loops, for any loop state ``carry``: ``step(carry)``
    runs one iteration, ``energy_of(carry)`` is the objective (a 0-d
    tensor).  Iterations run in blocks of ``min(check_every, n_max - i)``;
    after each block the relative improvement is read on the host (one
    synchronisation), and the loop stops at ``n_max`` or once it drops
    below ``tol``.  ``n_buf > 0`` records every iteration's energy into a
    trace of ``n_buf`` entries on ``like``'s device (NaN past the
    iterations run), whose block-end entry then serves as the block's
    energy.  Returns ``(carry, n_done, e_final, trace_or_None)``."""
    trace = energy_trace(like, n_buf) if n_buf > 0 else None
    e = energy_of(carry)
    scale, tol = _tol_start(e, tol)
    i, rel = 0, math.inf
    while i < n_max and rel >= tol:
        k = min(check_every, n_max - i)
        for j in range(k):
            carry = step(carry)
            if trace is not None:
                trace[i + j] = energy_of(carry)
        e_prev, e = e, (trace[i + k - 1] if trace is not None else energy_of(carry))
        rel = _block_change(e_prev, e, scale)[1]
        i += k
    return carry, i, e, trace


@_pinned
def fit_loop_tol(Vp: torch.Tensor, V: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                 n_max: int, tol: float, sparsity: float, inhibition: float = 0.,
                 cross_inhibition: float = 0., kernels: Sequence = (), *, check_every: int,
                 n_buf: int = 0, plan: ConvPlan, strategy: Strategy = 'conv', beta: float = 2.0,
                 mask: Optional[torch.Tensor] = None, process_group=None, **step):
    """Adaptive fit (port of the JAX package's ``fit_loop_tol``): MU
    iterations in blocks of ``min(check_every, n_max - i)``; after each
    block the relative improvement ``(e_prev - e) / max(e0, tiny)`` of the
    energy (of ``beta`` and ``mask``) is read, and the fit stops at
    ``n_max`` iterations or once it drops below ``tol``.

    The JAX package runs the whole loop as one on-device ``while_loop``.
    Here the stopping test runs on the host: one synchronisation per block,
    between blocks; the iterates, the count and the trace are the same.

    ``n_buf > 0`` (at least ``n_max``) also records the energy after every
    iteration into a trace of ``n_buf`` entries, NaN past the iterations
    run; a block's last entry then serves as its energy, with no second
    reconstruction.  ``step`` holds :func:`update_step`'s other keywords.

    Returns ``(W, H, n_done, e_final, trace_or_None)``.
    """
    def energy_of(WH):
        return energy(V, *WH, mask, plan=plan, strategy=strategy, beta=beta,
                      process_group=process_group)

    def iteration(WH):
        return update_step(Vp, *WH, sparsity, inhibition, cross_inhibition, kernels,
                           plan=plan, strategy=strategy, beta=beta, mask=mask,
                           process_group=process_group, **step)

    (W, H), n_done, e, trace = tol_loop((W, H), iteration, energy_of, int(n_max), tol,
                                        int(check_every), n_buf, V)
    return W, H, n_done, e, trace


# extrapolation safeguard of the JAX package (Ang & Gillis 2019-style): the
# momentum weight grows while the energy falls, halves on a rise
_XTR_GROW, _XTR_SHRINK, _XTR_MAX = 1.05, 0.5, 0.95


def _extrapolate(Xn: torch.Tensor, Xold: torch.Tensor, bk: torch.Tensor) -> torch.Tensor:
    """Multiplicative extrapolation ``Xn * clip((Xn+EPS)/(Xold+EPS), 1/8, 8)**bk``:
    positive, with zeros kept fixed as under plain MU."""
    r = torch.clamp((Xn + EPS) / (Xold + EPS), 0.125, 8.0)
    return (Xn * r ** bk.to(Xn.dtype)).to(Xn.dtype)


@_pinned
def fit_loop_extrapolated(Vp: torch.Tensor, V: torch.Tensor, W: torch.Tensor,
                          H: torch.Tensor, n_max: int, tol: float, beta0: float,
                          sparsity: float, inhibition: float = 0.,
                          cross_inhibition: float = 0., kernels: Sequence = (), *,
                          check_every: int, n_buf: int = 0, plan: ConvPlan,
                          update_H: bool = True, update_W: bool = True,
                          use_inhibition: bool = False, use_cross: bool = False,
                          strategy: Strategy = 'conv', use_pallas: bool = True,
                          beta: float = 2.0, mask: Optional[torch.Tensor] = None,
                          l2_H: Optional[float] = None, ortho_W: Optional[float] = None,
                          process_group=None):
    """Extrapolated MU with restarts (port of the JAX package's
    ``fit_loop_extrapolated``): each update is taken at the extrapolated
    point ``Y = X_new * clip(X_new / X_old)**beta_k`` (W's re-normalised).
    After each block of ``check_every`` iterations the energy of the
    accepted iterates is read: on a rise ``Y`` restarts from them and
    ``beta_k`` halves; else it grows by 5 % up to 0.95.  Stopping as in
    :func:`fit_loop_tol` (a restarted block never stops the fit), with the
    same host-side test, one synchronisation per block; ``n_buf > 0``
    records the accepted iterates' energies.  The objective's keywords
    (``beta``, ``mask``, ``l2_H``, ``ortho_W``) are :func:`update_step`'s;
    ``ortho_W`` is formed from the extrapolated W the update is taken at.

    Returns ``(W, H, n_done, e_final, trace_or_None)``.
    """
    def energy_of(W, H):
        return energy(V, W, H, mask, plan=plan, strategy=strategy, beta=beta,
                      process_group=process_group)

    h_flags = dict(plan=plan, use_inhibition=use_inhibition, use_cross=use_cross,
                   strategy=strategy, use_pallas=use_pallas, beta=beta, mask=mask, l2=l2_H)
    w_flags = dict(plan=plan, strategy=strategy, use_pallas=use_pallas, beta=beta, mask=mask,
                   ortho=ortho_W, process_group=process_group)
    n_max, check_every = int(n_max), int(check_every)
    trace = energy_trace(V, n_buf) if n_buf > 0 else None
    e = energy_of(W, H)
    scale, tol = _tol_start(e, tol)
    bk = torch.tensor(beta0, dtype=e.dtype, device=e.device)
    Wy, Hy = W, H
    i, rel = 0, math.inf
    while i < n_max and rel >= tol:
        k = min(check_every, n_max - i)
        for j in range(k):
            if update_H:
                Hn = _mu_H(Vp, Wy, Hy, sparsity, inhibition, cross_inhibition, kernels,
                           **h_flags)
                Hy, H = _extrapolate(Hn, H, bk), Hn
            if update_W:
                Wn = _mu_W(Vp, Wy, Hy, **w_flags)
                Wy, W = _normalize_W(_extrapolate(Wn, W, bk), plan.ndim).to(Wn.dtype), Wn
            if trace is not None:
                trace[i + j] = energy_of(W, H)
        e_prev, e = e, (trace[i + k - 1] if trace is not None else energy_of(W, H))
        diff, rel = _block_change(e_prev, e, scale)
        if diff < 0:  # the energy rose: drop the momentum
            bk = bk * _XTR_SHRINK
            Wy, Hy, rel = W, H, math.inf
        else:
            bk = torch.clamp(bk * _XTR_GROW, max=_XTR_MAX)
        i += k
    return W, H, i, e, trace


@_pinned
def update_H_step(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor, sparsity: float,
                  inhibition: float = 0., cross_inhibition: float = 0., kernels: Sequence = (),
                  *, plan: ConvPlan, use_inhibition: bool = False,
                  use_cross: bool = False, strategy: Strategy = 'conv',
                  use_pallas: bool = True, beta: float = 2.0,
                  mask: Optional[torch.Tensor] = None,
                  l2_H: Optional[float] = None) -> torch.Tensor:
    """One H-only MU update (W frozen)."""
    return _mu_H(Vp, W, H, sparsity, inhibition, cross_inhibition, kernels, plan=plan,
                 use_inhibition=use_inhibition, use_cross=use_cross, strategy=strategy,
                 use_pallas=use_pallas, beta=beta, mask=mask, l2=l2_H)


@_pinned
def update_W_step(Vp: torch.Tensor, W: torch.Tensor, H: torch.Tensor, *,
                  plan: ConvPlan, strategy: Strategy = 'conv', use_pallas: bool = True,
                  beta: float = 2.0, mask: Optional[torch.Tensor] = None,
                  ortho_W: Optional[float] = None, process_group=None) -> torch.Tensor:
    """One W-only MU update (H frozen), atoms sum-normalised."""
    return _mu_W(Vp, W, H, plan=plan, strategy=strategy, use_pallas=use_pallas, beta=beta,
                 mask=mask, ortho=ortho_W, process_group=process_group)


@_pinned
def correlate_init_H(Vp: torch.Tensor, Vd: torch.Tensor, W: torch.Tensor, *,
                     plan: ConvPlan, strategy: Strategy = 'conv',
                     process_group=None) -> torch.Tensor:
    """Matched-filter activations ``H0 = c * corr(Vp, W)`` with the
    least-squares scale ``c = <V, R0> / <R0, R0>``, ``R0 = reconstruct(W,
    corr(Vp, W))``, accumulated in ``promote_types(V.dtype, float32)``; a
    floor of 1 % of the mean keeps every entry positive (zero is absorbing
    under MU).  Deterministic and on the device: no host draw of H.  The
    JAX package takes the correlation as the ``neg`` half of
    ``grad_H_pair(Vp, 0, W)``; here it is that half alone (one cuDNN
    correlation on the conv strategy).  Under a transform group both run
    on the expanded dictionary, so H0 has ``M*G`` maps.  Under a
    ``process_group`` the scale and the mean are the whole batch's: its sums are reduced over
    the ranks (equal row counts)."""
    strategy, group = split_strategy(strategy)
    if group is not None:
        W = expand_w(W, group)
    neg = get_ops(strategy).corr_H(Vp, W, plan)
    R0 = reconstruct(W, neg.to(W.dtype), plan=plan, strategy=strategy)
    acc = torch.promote_types(Vd.dtype, torch.float32)
    num, den = all_reduce_sum(torch.sum(Vd.to(acc) * R0.to(acc)), torch.sum(R0.to(acc) ** 2),
                              process_group=process_group)
    H0 = (num / torch.clamp(den, min=torch.finfo(acc).tiny)).to(neg.dtype) * neg
    if process_group is None:
        mean = torch.mean(H0)
    else:
        mean = all_reduce_sum(torch.sum(H0), process_group=process_group)[0] / (
            H0.numel() * torch.distributed.get_world_size(process_group))
    return torch.maximum(H0, 0.01 * mean).to(W.dtype)
