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
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from pipe_tpu_torch.tree import tree_map


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
