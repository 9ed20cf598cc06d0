"""Carry component parameters and stream state between the JAX package and
the port.

Every op of the port uses the JAX op's parameter names (``taps``, ``hp``,
``sos``/``sos_lo``, ``matrix``, ``gain``, ``ir_spec``, ``gains``, ...) and
state names, shapes and dtypes (``tail``; ``hist``/``off``;
``x_tail``/``s``/``s_lo``; OLS ``prev``/``fdl``/``pos``; Delay
``ring``/``pos`` or ``hist``; the envelope's ``env``/``env_lo``; spectral
``hist``/``nres``/``tail``; channelizer ``hist``/``pend``/``pcnt``; the
oscillator's ``n``; the FM discriminator's ``prev``), so a JAX component's
``params`` or ``state`` tree, after ``np.asarray`` on each leaf, maps onto
the port's tree key for key. A JAX state taken mid-stream can then be
continued by the port, and back.

The one change of representation: a 0-d integer leaf (a stream counter
such as the resampler's phase offset ``off`` or the OLS ring head ``pos``)
is kept by the port on the host as a Python ``int``.

A sharded chain's state crosses as GLOBAL host arrays: the JAX chain's
``carries`` and ``params()`` after ``np.asarray`` on each leaf. Each rank of
the port keeps its block of them by the stage's ``carry_spec`` /
``param_spec`` (:func:`chain_carries_from_numpy`,
:func:`chain_params_from_numpy`) and assembles them again
(:func:`chain_carries_to_numpy`), so a stream begun in one package's
``ShardedChain`` continues in the other's. That holds for every stage's
carries (``tail``, ``hist``, ``x_tail``/``s``/``s_lo``, the bin-sharded
``zfdl``, ``env``/``env_lo``, the time-sharded ``ring``, ``prev``, and the
oscillator's ``n``, an int32 scalar there and a host int on the rank) and
parameters (``ir_f``, ``gains`` and the scalar tunables included): names,
shapes and integer-ness are checked on the way in.

A mesh ``Pipe``'s components cross the same way
(:func:`pipe_trees_to_numpy`, :func:`pipe_trees_from_numpy`): per route and
component the ``state`` and ``params`` trees as global host arrays, which is
what a JAX mesh pipe's components hold after ``np.asarray``. A component
that declares ``state_spec``/``param_spec`` keeps its block of them on each
rank; the others hold whole values.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from pipe_tpu_torch.tree import tree_flatten, tree_map, tree_unflatten


def tree_from_numpy(tree: Any, device=None) -> Any:
    """numpy leaves -> tensors on ``device`` (copied); 0-d integer leaves ->
    Python ints."""

    def leaf(x):
        a = np.asarray(x)
        if a.ndim == 0 and np.issubdtype(a.dtype, np.integer):
            return int(a)
        return torch.tensor(a, device=device)

    return tree_map(leaf, tree)


def tree_to_numpy(tree: Any) -> Any:
    """Tensor leaves -> numpy arrays on the host; int leaves -> 0-d int32
    arrays (the JAX package's dtype for counters)."""

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        if isinstance(x, (int, np.integer)):
            return np.asarray(x, np.int32)
        return np.asarray(x)

    return tree_map(leaf, tree)


def chain_carries_from_numpy(chain, carries) -> None:
    """Continue the port's ``ShardedChain`` from a JAX chain's stream state:
    ``carries`` is ``jax.tree.map(np.asarray, jax_chain.carries)``, global
    arrays stage by stage, of which each rank keeps its block. Both chains
    are built from the same stages on meshes with the same channel axis."""
    chain.load_global_carries(carries)


def chain_carries_to_numpy(chain):
    """The port's stream state as the global arrays a JAX chain's ``carries``
    hold (a collective: every rank of the mesh calls it)."""
    return chain.global_carries()


def chain_params_from_numpy(chain, params) -> None:
    """Give every stage of the port's chain the parameters of a JAX chain:
    ``params`` is ``jax.tree.map(np.asarray, jax_chain.params())``. They are
    global arrays, which is what ``stage.params`` holds in the port too, so
    this is a live retune of every leaf."""
    if len(params) != len(chain.stages):
        raise ValueError(
            f"{len(params)} parameter trees for {len(chain.stages)} stages")
    for st, p in zip(chain.stages, params):
        if set(p) != set(st.params):
            raise ValueError(
                f"{type(st).__name__}: parameters {sorted(p)} where the stage "
                f"has {sorted(st.params)}")
        st.params = {k: np.asarray(v, np.float32) for k, v in p.items()}


# -- a mesh Pipe's components ---------------------------------------------------

_SPEC_OF = {"state": "state_spec", "params": "param_spec"}


def _is_int(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not (x.is_floating_point() or x.dtype == torch.bool)
    return (np.issubdtype(np.asarray(x).dtype, np.integer)
            and not isinstance(x, bool))


def _sharding(pipe, comp, spec_name):
    """The layout tree of a component's ``state``/``params`` where the
    pipe's mesh really splits it, else None (whole values on this rank)."""
    mesh = getattr(pipe, "mesh", None)
    if mesh is None or mesh.size == 1:
        return None
    return getattr(comp, spec_name, None)


def _global_shape(mesh, leaf, spec) -> tuple:
    """The global shape of this rank's block ``leaf`` laid out by ``spec``."""
    shape = list(np.shape(leaf))
    for dim, axis in enumerate(spec.axes):
        if axis is not None:
            shape[dim] *= mesh.shape[axis]
    return tuple(shape)


def component_tree_to_numpy(pipe, route, comp, kind: str):
    """One component's ``state`` or ``params`` tree as global host arrays
    (int leaves as int32 scalars). On a mesh larger than 1x1 a component
    with a declared layout is gathered: a collective, called by every rank
    at the same point."""
    from pipe_tpu_torch.parallel.chain import globalize

    spec = _sharding(pipe, comp, _SPEC_OF[kind])
    tree = getattr(comp, kind)
    if spec is None:
        return tree_to_numpy(tree)
    return globalize(pipe.mesh, route.device, tree, spec)


def component_tree_from_numpy(pipe, route, comp, kind: str, tree,
                              what: str = ""):
    """The tree a component holds for global host arrays ``tree``: names,
    shapes and integer-ness are checked against what it holds now (as
    ``ShardedChain.load_global_carries`` does), then each rank keeps its
    block, in the dtype and on the device of the leaf it replaces. Returns
    the new tree; nothing is assigned."""
    spec = _sharding(pipe, comp, _SPEC_OF[kind])
    have, havedef = tree_flatten(getattr(comp, kind))
    got, gotdef = tree_flatten(tree)
    what = what or f"{type(comp).__name__} {kind}"
    if gotdef != havedef:
        raise ValueError(f"{what}: tree {gotdef} where the pipe holds {havedef}")
    specs = [None] * len(have) if spec is None else tree_flatten(spec)[0]
    if len(specs) != len(have):
        raise ValueError(f"{what}: {len(specs)} layouts for {len(have)} leaves")
    new = []
    for h, g, s in zip(have, got, specs):
        g = np.asarray(g)
        want = (tuple(np.shape(h)) if s is None
                else _global_shape(pipe.mesh, h, s))
        if tuple(g.shape) != want:
            raise ValueError(
                f"{what}: shape {tuple(g.shape)} where the pipe holds {want}")
        if _is_int(g) != _is_int(h):
            raise ValueError(
                f"{what}: dtype {g.dtype} where the pipe holds "
                f"{h.dtype if hasattr(h, 'dtype') else type(h).__name__}")
        if s is not None:
            g = pipe.mesh.local_block(g, s)
        if isinstance(h, torch.Tensor):
            new.append(torch.tensor(np.array(g), dtype=h.dtype, device=h.device))
        elif _is_int(h):
            new.append(int(g))
        else:
            new.append(type(h)(g) if g.ndim == 0 else np.array(g))
    return tree_unflatten(havedef, new)


def pipe_trees_to_numpy(pipe):
    """Every component's stream state and parameters as global host arrays:
    ``[[{"state": tree, "params": tree} per component] per route]``, the
    form of ``jax.tree.map(np.asarray, comp.state)`` of a JAX mesh pipe
    built from the same lines. The pipe is not running. A collective on a
    mesh larger than 1x1."""
    return [[{kind: component_tree_to_numpy(pipe, route, comp, kind)
              for kind in _SPEC_OF} for comp in route.components()]
            for route in pipe.routes]


def pipe_trees_from_numpy(pipe, trees) -> None:
    """Continue the port's pipe from the components of another pipe built
    from the same lines (a JAX mesh pipe's, or :func:`pipe_trees_to_numpy`
    taken on any mesh with the same global shapes). All or nothing."""
    if len(trees) != len(pipe.routes):
        raise ValueError(f"{len(trees)} routes for {len(pipe.routes)}")
    plan = []
    for r, (route, rtrees) in enumerate(zip(pipe.routes, trees)):
        comps = route.components()
        if len(rtrees) != len(comps):
            raise ValueError(
                f"route {r}: {len(rtrees)} components for {len(comps)}")
        for c, (comp, t) in enumerate(zip(comps, rtrees)):
            for kind in _SPEC_OF:
                plan.append((comp, kind, component_tree_from_numpy(
                    pipe, route, comp, kind, t[kind],
                    f"route {r} component {c} {kind}")))
    for comp, kind, tree in plan:
        setattr(comp, kind, tree)
