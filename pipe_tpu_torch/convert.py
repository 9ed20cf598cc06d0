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
