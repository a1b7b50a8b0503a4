"""Functional MLP matching the reference DLRM MLP construction.

Reference: ``DLRM_Net.create_mlp`` (/root/reference/model_no_ddp.py:244-270):
Linear layers with weights ~ N(0, sqrt(2/(fan_in+fan_out))) and biases
~ N(0, sqrt(1/fan_out)); ReLU after every layer except a sigmoid at
``sigmoid_layer``. We store weights as ``[in, out]`` (x @ W + b) — no transpose
in the matmul — rather than torch's ``[out, in]``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

MLPParams = List[Tuple[jax.Array, jax.Array]]


def init_mlp(
    rng: np.random.Generator, layer_sizes: Sequence[int], dtype=jnp.float32
) -> MLPParams:
    """Initialize an MLP for sizes [d0, d1, ..., dk] (k linear layers)."""
    params: MLPParams = []
    for n, m in zip(layer_sizes[:-1], layer_sizes[1:]):
        std_w = np.sqrt(2.0 / (m + n))
        std_b = np.sqrt(1.0 / m)
        w = rng.normal(0.0, std_w, size=(int(n), int(m))).astype(np.float32)
        b = rng.normal(0.0, std_b, size=(int(m),)).astype(np.float32)
        params.append((jnp.asarray(w, dtype=dtype), jnp.asarray(b, dtype=dtype)))
    return params


def apply_mlp(
    params: MLPParams,
    x: jax.Array,
    sigmoid_layer: int = -1,
    compute_dtype=None,
) -> jax.Array:
    """Forward through the MLP. ``sigmoid_layer`` is the index of the linear
    layer followed by a sigmoid (reference: ``sigmoid_top = ln_top.size - 2``,
    /root/reference/main_no_ddp.py:358); all other layers use ReLU."""
    for i, (w, b) in enumerate(params):
        if compute_dtype is not None:
            x = jnp.dot(
                x.astype(compute_dtype),
                w.astype(compute_dtype),
                preferred_element_type=jnp.float32,
            ) + b.astype(jnp.float32)
        else:
            x = jnp.dot(x, w, preferred_element_type=jnp.float32) + b
        if i == sigmoid_layer:
            x = jax.nn.sigmoid(x)
        else:
            x = jax.nn.relu(x)
    return x
