"""The JAX package's sweeps run from given PRNG keys, for the port's sweep
tests: the preparation of ``tnmf_tpu.models.sweep.sweep_fit``'s MU branch
(strategy, per-model strengths, inhibition taps, mask, prepared data) and
of its HALS branch (per-model ``l1``/``l2`` in the accumulation dtype, the
inner-sweep count) without its float32 cast, so that float64 data runs in
float64, and the inits ``jax.vmap(init_one)(keys)`` that ``_sweep_impl``
and ``_sweep_impl_hals`` draw, which the port's ``_sweep_from_init`` and
``_sweep_from_init_hals`` then start from."""

import jax
import jax.numpy as jnp
import numpy as np

from tnmf_tpu import engine, engine_hals
from tnmf_tpu.models import sweep
from tnmf_tpu.ops.inhibition import inhibition_kernels, resolve_inhibition_range
from tnmf_tpu.ops.modes import ConvPlan
from tnmf_tpu.ops.transforms import make_group


def keys_of(seed: int, n_models: int):
    """``sweep_fit``'s keys for ``n_models`` and a scalar seed."""
    return jax.random.split(jax.random.PRNGKey(seed), n_models)


def inits(V, keys, n_atoms, atom_shape, *, mode='valid', transform_type='shift', **_):
    """``(W0, H0)``: ``jax.vmap(init_one)(keys)`` as ``_sweep_impl`` draws
    them, in V's dtype, as NumPy arrays (no sweep is compiled)."""
    V = jnp.asarray(V)
    atom_shape = tuple(atom_shape)
    group = make_group(transform_type, atom_shape)
    n_maps = n_atoms * (group.size if group is not None else 1)
    plan = ConvPlan.create(mode, tuple(V.shape[2:]), atom_shape)
    w_shape = (n_atoms, V.shape[1]) + atom_shape
    h_shape = (V.shape[0], n_maps) + plan.transform_shape
    W0, H0 = jax.vmap(lambda k: engine.init_matrices(
        k, w_shape=w_shape, h_shape=h_shape, n_shift_axes=plan.ndim, dtype=V.dtype))(keys)
    return np.asarray(W0), np.asarray(H0)


def run(V, keys, n_atoms, atom_shape, *, impl='plain', n_iterations=5, sparsity=0.0,
        inhibition=0.0, cross_inhibition=0.0, l2=0.0, ortho=0.0, mode='valid',
        strategy='conv', beta=2.0, transform_type='shift', mask=None, tol=None,
        check_every=10):
    """``(W0, H0, out)``: the inits and the output of ``_sweep_impl``
    (``impl='plain'``: W, H, energies), ``_sweep_impl_traced`` ('traced':
    W, H, traces) or ``_sweep_impl_tol`` ('tol': W, H, energies, n_iters),
    as NumPy arrays."""
    V = jnp.asarray(V)
    atom_shape = tuple(atom_shape)
    group = make_group(transform_type, atom_shape)
    n_maps = n_atoms * (group.size if group is not None else 1)
    plan = ConvPlan.create(mode, tuple(V.shape[2:]), atom_shape)
    strategy = engine.resolve_strategy(strategy, plan, n_maps, V.shape[1])
    if group is not None:
        strategy = (strategy, group)
    sdt, S = V.dtype, keys.shape[0]
    sp, inh, cross = (sweep._per_model(x, S, name, sdt) for x, name in (
        (sparsity, 'sparsity'), (inhibition, 'inhibition'),
        (cross_inhibition, 'cross_inhibition')))
    if np.any(np.asarray(l2) > 0) or np.any(np.asarray(ortho) > 0):
        l2v, orv = sweep._per_model(l2, S, 'l2', sdt), sweep._per_model(ortho, S, 'ortho', sdt)
    else:
        l2v = orv = None
    kernels = tuple(jnp.asarray(k, dtype=sdt) for k in inhibition_kernels(
        resolve_inhibition_range(None, atom_shape)))
    if mask is not None:
        mask = jnp.broadcast_to(jnp.asarray(mask), V.shape).astype(sdt)
    Vc = V if mask is None or beta != 2.0 else V * mask
    if beta == 2.0 or (mask is None and engine.beta_prepares_data(strategy)):
        Vp = engine.prepare_data(Vc, plan=plan, strategy=strategy)
    else:
        Vp = Vc
    statics = dict(n_atoms=n_atoms, n_maps=n_maps, plan=plan, strategy=strategy,
                   update_H=True, update_W=True,
                   use_inhibition=bool(np.any(np.asarray(inh) > 0)),
                   use_cross=bool(np.any(np.asarray(cross) > 0)),
                   use_pallas=False, use_pallas_gw=False, beta=float(beta))
    if impl == 'tol':
        acc = jnp.promote_types(sdt, jnp.float32)
        out = sweep._sweep_impl_tol(Vp, V, keys, sp, inh, cross, kernels, mask,
                                    jnp.asarray(n_iterations, jnp.int32), jnp.asarray(tol, acc),
                                    l2v, orv, check_every=check_every, **statics)
    else:
        fn = sweep._sweep_impl_traced if impl == 'traced' else sweep._sweep_impl
        out = fn(Vp, V, keys, sp, inh, cross, kernels, mask, l2v, orv,
                 n_iterations=n_iterations, **statics)
    W0, H0 = inits(V, keys, n_atoms, atom_shape, mode=mode, transform_type=transform_type)
    return W0, H0, tuple(np.asarray(x) for x in out)


def run_hals(V, keys, n_atoms, *, impl='plain', n_iterations=5, sparsity=0.0, l2=0.0,
             hals_inner='auto', tol=None, check_every=10):
    """``(W0, H0, out)`` of the HALS sweep on plain-NMF data ``V (n, C,
    *sample)`` (atoms as large as the samples, mode ``'full'``): the inits
    and the output of ``_sweep_impl_hals`` (``impl='plain'``: W, H,
    energies; ``'traced'``: W, H, traces) or ``_sweep_impl_hals_tol``
    (``'tol'``: W, H, energies, n_iters), as NumPy arrays."""
    V = jnp.asarray(V)
    atom_shape = tuple(V.shape[2:])
    plan = ConvPlan.create('full', atom_shape, atom_shape)
    S = keys.shape[0]
    acc = jnp.promote_types(V.dtype, jnp.float32)
    l1v = sweep._per_model(sparsity, S, 'sparsity', acc)
    l2v = sweep._per_model(l2, S, 'l2', acc)
    inner = engine_hals.auto_inner(n_atoms, int(V.shape[1] * np.prod(atom_shape)), hals_inner,
                                   n_samples=int(V.shape[0]))
    statics = dict(n_atoms=n_atoms, inner=inner, plan=plan)
    if impl == 'tol':
        out = sweep._sweep_impl_hals_tol(V, keys, l1v, l2v, jnp.asarray(n_iterations, jnp.int32),
                                         jnp.asarray(tol, acc), check_every=check_every,
                                         **statics)
    else:
        out = sweep._sweep_impl_hals(V, keys, l1v, l2v, n_iterations=n_iterations,
                                     trace=impl == 'traced', **statics)
    W0, H0 = inits(V, keys, n_atoms, atom_shape, mode='full')
    return W0, H0, tuple(np.asarray(x) for x in out)
