"""Full-table embedding group (the uncached path).

This is the JAX equivalent of the reference's ``Embedding_Table_Group``
(/root/reference/model_no_ddp.py:21-98): per-table weight matrices initialized
uniform(-sqrt(1/n), sqrt(1/n)), summed "bag" pooling. It serves three roles:

1. the device-resident model for configs whose tables fit in HBM
   (small/synthetic configs, tests);
2. the lockstep oracle against which the cached path is verified;
3. the host master tables reuse its init convention (cache/master.py).

Lookups come in two layouts:
- single-index ([T, B] int32, one lookup per example — the Criteo layout,
  /root/reference/data_loader_terabyte.py:85-87): pooling is the identity;
- padded multi-hot ([T, B, P] indices + [T, B, P] bool mask — the synthetic
  generator's variable-length bags, padded to a static P): pooling is a masked
  sum, matching EmbeddingBag(mode="sum").

QR / mixed-dimension compressed tables (models/tricks.py) slot in per table.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from cdlrm_tpu.models import tricks


def init_embedding_table(rng: np.random.Generator, n: int, d: int) -> jax.Array:
    """uniform(-sqrt(1/n), sqrt(1/n)) init (reference model_no_ddp.py:70-73)."""
    bound = np.sqrt(1.0 / n)
    w = rng.uniform(-bound, bound, size=(int(n), int(d))).astype(np.float32)
    return jnp.asarray(w)


def init_embedding_tables(
    rng: np.random.Generator,
    ln_emb: Sequence[int],
    m_spa: Union[int, Sequence[int]],
    qr_flag: bool = False,
    qr_collisions: int = 4,
    qr_threshold: int = 200,
    qr_operation: str = "mult",
    md_flag: bool = False,
    md_threshold: int = 200,
) -> List:
    """Build the per-table parameter list. Entries are either a plain
    [n, d] array, a tricks.QRParams, or a tricks.MDParams.

    Reference table construction: model_no_ddp.py:48-78. When ``md_flag`` is
    set, ``m_spa`` is the per-table dim vector from ``md_solver`` and the base
    dim is ``max(m_spa)`` (model_no_ddp.py:56-64).
    """
    tables: List = []
    per_table_dims = (
        list(m_spa) if not isinstance(m_spa, (int, np.integer)) else [int(m_spa)] * len(ln_emb)
    )
    base_dim = max(per_table_dims)
    for i, n in enumerate(ln_emb):
        n = int(n)
        d = int(per_table_dims[i])
        if qr_flag and n > qr_threshold:
            tables.append(
                tricks.init_qr_embedding(rng, n, d, qr_collisions, operation=qr_operation)
            )
        elif md_flag and n > md_threshold:
            tables.append(tricks.init_md_embedding(rng, n, d, base_dim))
        else:
            tables.append(init_embedding_table(rng, n, base_dim if md_flag else d))
    return tables


def _lookup_one(table, idx: jax.Array) -> jax.Array:
    """Gather rows for one table; idx is any int array, result [*idx.shape, D]."""
    if isinstance(table, tricks.QRParams):
        return tricks.qr_lookup(table, idx)
    if isinstance(table, tricks.MDParams):
        return tricks.md_lookup(table, idx)
    return jnp.take(table, idx, axis=0)


def embedding_forward(
    tables: List,
    ls_i: jax.Array,
    ls_mask: Optional[jax.Array] = None,
) -> jax.Array:
    """Pooled lookups.

    ls_i: [T, B] (single-index) or [T, B, P] (padded multi-hot with ls_mask).
    Returns ly [T, B, D].
    """
    outs = []
    for t, table in enumerate(tables):
        idx = ls_i[t]
        rows = _lookup_one(table, idx)
        if idx.ndim == 2:  # [B, P, D] -> masked sum over P
            mask = ls_mask[t][..., None].astype(rows.dtype)
            rows = jnp.sum(rows * mask, axis=1)
        outs.append(rows)
    return jnp.stack(outs, axis=0)
