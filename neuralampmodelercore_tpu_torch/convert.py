"""Parameters of the JAX package -> parameters of the port.

``params_from_jax`` takes the JAX package's parameter pytree with its leaves
as numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``) and returns
the port's tree: the same nesting and the same storage conventions (conv1x1
``w`` as (in, out), conv1d ``w`` as (K, in, out), depthwise ``dw``), every
leaf a float32 tensor on ``device``. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_jax(params_np: Any, device) -> Any:
    if isinstance(params_np, dict):
        return {k: params_from_jax(v, device) for k, v in params_np.items()}
    if isinstance(params_np, (list, tuple)):
        return [params_from_jax(v, device) for v in params_np]
    return torch.tensor(np.asarray(params_np, dtype=np.float32), device=device)
