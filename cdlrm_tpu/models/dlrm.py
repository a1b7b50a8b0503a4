"""Dense DLRM stack: bottom MLP -> feature interaction -> top MLP + losses.

Reference behavior (re-designed, not translated):
- ``DLRM_Net.interact_features`` (/root/reference/model_no_ddp.py:272-304):
  'dot' = pairwise dot products of [dense || embeddings] with the strict
  lower triangle extracted (diagonal included iff ``interaction_itself``);
  'cat' = plain concatenation.
- ``DLRM_Net.forward`` (/root/reference/model_no_ddp.py:306-316): sigmoid is
  the activation of the last top-MLP layer; output clamped to
  [loss_threshold, 1 - loss_threshold] when 0 < loss_threshold < 1.
- Losses (/root/reference/main_no_ddp.py:212-221,364-372): mse | bce | wbce
  (per-class weighted BCE), all computed on the sigmoid *probability* output.

The interaction is expressed as one batched matmul + a static lower-triangle
gather so XLA maps it onto one matmul with a fused epilogue; no data-dependent
shapes anywhere.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from cdlrm_tpu.models.mlp import MLPParams, apply_mlp, init_mlp

DLRMParams = Dict[str, MLPParams]


def derive_top_mlp_input_dim(
    num_sparse: int, bot_out: int, interaction_op: str, interaction_itself: bool
) -> int:
    """First dim of the top MLP (reference: /root/reference/main_no_ddp.py:550-569)."""
    num_fea = num_sparse + 1
    if interaction_op == "dot":
        if interaction_itself:
            return (num_fea * (num_fea + 1)) // 2 + bot_out
        return (num_fea * (num_fea - 1)) // 2 + bot_out
    if interaction_op == "cat":
        return num_fea * bot_out
    raise ValueError(f"unsupported interaction op: {interaction_op}")


def init_dlrm(
    rng: np.random.Generator,
    ln_bot: Sequence[int],
    ln_top: Sequence[int],
) -> DLRMParams:
    return {"bot": init_mlp(rng, ln_bot), "top": init_mlp(rng, ln_top)}


def interact_features(
    x: jax.Array,
    ly: jax.Array,
    interaction_op: str = "dot",
    interaction_itself: bool = False,
    compute_dtype=None,
) -> jax.Array:
    """x: [B, D] dense feature; ly: [T, B, D] embedding lookups."""
    b, d = x.shape
    t = ly.shape[0]
    if interaction_op == "cat":
        return jnp.concatenate([x, ly.transpose(1, 0, 2).reshape(b, t * d)], axis=1)
    if interaction_op != "dot":
        raise ValueError(f"unsupported interaction op: {interaction_op}")
    feats = jnp.concatenate([x[None], ly], axis=0).transpose(1, 0, 2)  # [B, F, D]
    if compute_dtype is not None:
        z = jnp.einsum(
            "bfd,bgd->bfg",
            feats.astype(compute_dtype),
            feats.astype(compute_dtype),
            preferred_element_type=jnp.float32,
        )
    else:
        z = jnp.einsum("bfd,bgd->bfg", feats, feats, preferred_element_type=jnp.float32)
    nf = t + 1
    li, lj = np.tril_indices(nf, k=0 if interaction_itself else -1)
    zflat = z[:, li, lj]  # [B, nf*(nf±1)/2]
    return jnp.concatenate([x, zflat], axis=1)


def dlrm_forward(
    params: DLRMParams,
    dense_x: jax.Array,
    ly: jax.Array,
    interaction_op: str = "dot",
    interaction_itself: bool = False,
    loss_threshold: float = 0.0,
    compute_dtype=None,
) -> jax.Array:
    """Full dense stack. ``ly`` is [T, B, D] pooled embedding outputs.

    Returns probabilities [B, 1] (sigmoid applied at the last top layer,
    reference sigmoid_top = len(ln_top) - 2)."""
    x = apply_mlp(params["bot"], dense_x, sigmoid_layer=-1, compute_dtype=compute_dtype)
    r = interact_features(x, ly, interaction_op, interaction_itself, compute_dtype)
    p = apply_mlp(
        params["top"], r, sigmoid_layer=len(params["top"]) - 1, compute_dtype=compute_dtype
    )
    if 0.0 < loss_threshold < 1.0:
        p = jnp.clip(p, loss_threshold, 1.0 - loss_threshold)
    return p


_EPS = 1e-7  # numeric guard for log() on unclamped sigmoid outputs


def compute_loss(
    z: jax.Array,
    t: jax.Array,
    loss_function: str = "mse",
    loss_weights: Optional[Sequence[float]] = None,
) -> jax.Array:
    """Mean loss over the batch (reference loss_fn_wrap,
    /root/reference/main_no_ddp.py:212-221)."""
    t = t.astype(z.dtype)
    if loss_function == "mse":
        return jnp.mean((z - t) ** 2)
    zc = jnp.clip(z, _EPS, 1.0 - _EPS)
    bce = -(t * jnp.log(zc) + (1.0 - t) * jnp.log(1.0 - zc))
    if loss_function == "bce":
        return jnp.mean(bce)
    if loss_function == "wbce":
        w = jnp.asarray(loss_weights, dtype=z.dtype)
        per_example_w = w[t.astype(jnp.int32).reshape(-1)].reshape(t.shape)
        return jnp.mean(per_example_w * bce)
    raise ValueError(f"unsupported loss function: {loss_function}")
