"""Jitted device steps: cached train/eval, refill, aggregation, full-table.

This is the XLA re-architecture of the reference's per-rank hot loop
(/root/reference/main_no_ddp.py:386-502). Everything is static-shape and runs
inside one ``shard_map`` over the 1-D 'dp' mesh axis:

- train: scatter aux miss rows -> one gather from the concatenated cache ->
  dense fwd/bwd -> manual-vjp sparse SGD on the gathered rows (DESIGN.md D3)
  -> pmean dense grads (reference aggregate_gradients, main_no_ddp.py:234-247)
  -> psum metrics (replaces the reference's O(W^2) broadcast handshake,
  main_no_ddp.py:433-502).
- refill: gather evicted rows / scatter inserted rows / broadcast replica 0
  (reference load_caches_and_broadcast, main_no_ddp.py:309-321).
- aggregate: union-touched-row psum/pmax with sum|mean|max
  (reference broadcast_and_aggregate, main_no_ddp.py:250-292).

Per-replica divergent state (cache, touched mask) is stored FLAT: the cache
is one global [ndev*R, D] array sharded P('dp') whose per-device block is
that replica's full cache copy (slot ids are block-local). The flat layout
matters: a leading [ndev, R, D] axis forces the body's cache[0]/[None]
squeeze/unsqueeze, which defeats XLA's donation aliasing and inserts a
full-cache HBM copy every step (measured 2x step time at Terabyte-class
geometry). Dense params keep a leading [ndev] axis (they're small) and stay
bit-identical across replicas because their gradients are pmean'd (unless
``strict_bias_divergence`` reproduces the reference's bias non-sync bug).
"""

from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cdlrm_tpu.cache.geometry import CacheGeometry
from cdlrm_tpu.models.dlrm import compute_loss, dlrm_forward
from cdlrm_tpu.parallel.mesh import DP_AXIS

Params = dict


class StepConfig(NamedTuple):
    """Static configuration baked into the compiled steps."""

    interaction_op: str = "dot"
    interaction_itself: bool = False
    loss_function: str = "mse"
    loss_weights: Tuple[float, ...] = (1.0, 1.0)
    loss_threshold: float = 0.0
    table_agg_op: str = "mean"
    strict_bias_divergence: bool = False
    # 'strict' | 'delta' | 'off' (bools accepted: True='strict', False='off').
    # strict = faithful rank-0 whole-cache psum broadcast at refill
    # (reference main_no_ddp.py:317-321, ~2*R*D*4 bytes of collective
    # traffic per refill);
    # delta = broadcast only the evicted rows and let the (replica-identical)
    # insert buffer carry the new values — trajectory-equal to strict when
    # table_agg_freq divides lookahead (every refill is then immediately
    # preceded by an aggregation, so replicas are already identical);
    # off = no collective (single-device).
    refill_broadcast: object = "strict"
    compute_dtype: Optional[str] = None  # None/'float32' | 'bfloat16'
    # wire packing: slots arrive as a [T, BYTES] uint8 bitstream of
    # wire_bits-wide table-LOCAL ids (unpacked + offset on device). Cuts
    # per-step host->device bytes 25-45% on low-bandwidth host links;
    # lossless.
    wire_pack: bool = False
    wire_bits: int = 24  # == WIRE_MAX_BITS (defined below the class)
    # False = single-replica (or agg-free) runs: aggregation is a semantic
    # no-op over one replica, so the train step skips the per-step touched
    # scatter entirely
    track_touched: bool = True
    # duplicate-slot coalescing (host_cache.py probe_dedup): lookups arrive
    # as bit-packed first-seen ranks into a per-step unique-slot list; the
    # step gathers unique rows once, expands by rank (fast gather), and the
    # sparse update segment-sums duplicates before scattering only U unique
    # rows. The take-VJP segment sum is itself an N-update scatter, but
    # into the small [Ub, D] operand; the cache scatter shrinks from N to
    # U rows, so the win scales with duplication. Costs ~+30KB per-step
    # H2D (inverse + unique wire vs slot wire).
    dedup: bool = False
    inv_bits: int = 13  # rank wire width: >= wire_width(lookups_per_table-1)
    uniq_bits: int = 24  # unique-list wire width (== wire_bits)
    # sorted unpacked dedup wire (Config.sorted_dedup_wire): the host emits
    # unique slots in ascending order (one stable argsort — table blocks
    # are disjoint ascending, so global sort == per-table sort) and the
    # unique gather/scatter carry indices_are_sorted=True. Exact (segments
    # keep their contents; only bucket positions permute). Unpacked wires
    # only.
    sorted_wire: bool = False
    # Optimizer (beyond-parity; the reference trains SGD only,
    # main_no_ddp.py:374-376): "sgd" | "adagrad". AdaGrad = torch-semantics
    # element-wise on the dense MLPs + row-wise (torchrec semantics) on the
    # cached embedding rows, with CACHE-RESIDENT per-row state
    # ([ndev*R] f32, donated like touched): refill insert resets an
    # inserted slot's state to zero (fresh id), eviction drops it — the
    # documented approximation for cached training (state never round-trips
    # to the masters). Requires the dedup wire (duplicate-slot lookups must
    # be coalesced before the row-wise state update); enforced in
    # Config.finalize.
    optimizer: str = "sgd"
    adagrad_eps: float = 1e-10  # torch.optim.Adagrad default
    # Config.adagrad_master_state: the row-wise accumulator ROUND-TRIPS
    # through host-resident per-table stores instead of the default
    # drop-at-evict / reset-at-insert approximation: the refill step
    # additionally gathers evicted slots' accumulator values (written back
    # with the rows) and scatters host-gathered values for inserted ids.
    adagrad_master_state: bool = False
    # ship refill insert rows / per-step miss rows / evicted rows as bf16
    # (halves the dominant refill H2D+D2H traffic). LOSSY: freshly staged
    # rows are bf16-rounded once (trained deltas stay f32 in the cache).
    wire_rows_bf16: bool = False
    # Hot-tier sparse update (hot_rows = H > 0): the step takes an extra
    # per-window input hot_slots [H] — the window's hottest resident cache
    # rows, sorted, last position reserved for the trash row. Lookup
    # gradients split on device (searchsorted membership, no extra wire
    # bytes): HOT lookups coalesce via a segment-sum into an [H, D]
    # accumulator and land in ONE H-row scatter; COLD
    # lookups compact to a per-window negotiated static bucket
    # (cold_bucket = K) and scatter-add individually. Scatter rows per step
    # drop from N to H + K, and the chain-forming hot rows never hit the
    # cache scatter at all. Exact semantics (same sums, different float
    # order).
    # The host guarantees K bounds every batch's cold count (shadow window
    # stats); masked/padded lookups resolve to the trash row, which is
    # always in the hot list, so they never consume cold capacity.
    hot_rows: int = 0
    cold_bucket: int = 0
    # Cached mixed-dimension path (beyond-parity — the reference's cached
    # path CRASHES with MD, model_no_ddp.py:80-87): cache rows hold
    # zero-padded [*, D] base-dim MD rows; params carry "md_proj" [T, D, D]
    # per-table projections (true [d_t, D] blocks zero-padded — pad rows
    # receive exactly-zero gradients because the pad input columns are 0 —
    # and FROZEN identity for full-dim tables via md_train_mask). The
    # projection applies right after pooling, matching the reference
    # PrEmbeddingBag order (EmbeddingBag -> Linear).
    md_proj: bool = False
    md_train_mask: Tuple[float, ...] = ()  # [T] 1.0 = trainable projection
    # Block-coalesced sparse update (Config.block_coalesced_update; scan
    # blocks with the unpacked dedup wire + SGD only): instead of one
    # U-row scatter into the full cache per
    # step, per-lookup gradients scatter into a small pending buffer
    # in block-union row space (one duplicate-row scatter per step — no
    # segment-sum, no per-step cache scatter) and the cache pays ONE
    # U_block-row scatter per scan block. The forward reads the effective
    # weight w_eff = cache[slot] - lr * pending[blk_rank], so semantics
    # are SGD-exact up to float reassociation (c0 - lr*(g1+g2) vs
    # ((c0 - lr*g1) - lr*g2); single-touch rows are bit-exact). Extra
    # wire: per-step uniq_blk [ub] block ranks
    # (pad/aux/trash -> pending trash row = last) + per-block blk_slots
    # [p_bucket] (the sorted union, trash-padded) + blk_counts [1].
    # Aux-region lanes are EXCLUDED (rank == pending trash => delta
    # zeroed): a per-step-staged aux slot is reused across the block, so
    # pending at that slot would merge gradients of DIFFERENT master rows;
    # today's per-step path applies those updates to rows that are
    # overwritten before ever being read, so dropping them is
    # output-identical (DESIGN.md D1 miss semantics).
    block_coalesce: bool = False

    @property
    def cdtype(self):
        return jnp.bfloat16 if self.compute_dtype == "bfloat16" else None


# Wire format: per table, an LSB-first bitstream of WIRE_BITS-wide table-
# LOCAL slot ids (all-ones = sentinel for trash-row positions). The bit
# width is the smallest that addresses every table's cache block + sentinel
# (<= 24); 24 bits reproduces the original byte-aligned 3-byte layout.
WIRE_MAX_BITS = 24
WIRE_SENTINEL = (1 << WIRE_MAX_BITS) - 1  # sentinel at the max width


def wire_width(max_local_slot: int) -> int:
    """Smallest bit width whose all-ones sentinel exceeds every local slot
    (>= 9 so bit positions of one lane never collide within a numpy pack
    pass; <= WIRE_MAX_BITS or packing is disabled by the caller)."""
    return max(9, int(max_local_slot + 1).bit_length())


def wire_bytes(n: int, bits: int) -> int:
    """Bytes per table for an n-lookup bitstream (+4 so the device's 4-byte
    windows never read out of bounds)."""
    return (n * bits + 7) // 8 + 4


def pack_slots(
    slots: np.ndarray, table_offsets: np.ndarray, trash_row: int,
    bits: int = WIRE_MAX_BITS,
) -> np.ndarray:
    """Host side (numpy fallback; the native probe emits this directly):
    global int32 slot ids [T, N] -> bitstream [T, wire_bytes(N, bits)]."""
    t_count, n = slots.shape
    sent = (1 << bits) - 1
    local = slots.astype(np.int64) - table_offsets[:, None]
    local = np.where(slots == trash_row, sent, local).astype(np.uint32)
    out = np.zeros((t_count, wire_bytes(n, bits)), np.uint8)
    pos = np.arange(n, dtype=np.int64) * bits
    for k in range(bits):
        p = pos + k
        byte, sh = p >> 3, (p & 7).astype(np.uint8)
        # bits >= 9 => within one k the byte indices are strictly increasing
        bit = ((local >> k) & 1).astype(np.uint8)
        out[:, byte] |= bit << sh
    return out


def _unpack_raw(wire: jax.Array, bits: int, n: int) -> jax.Array:
    """Device side: bitstream [T, BYTES] uint8 -> raw int32 values [T, n].
    Each value reads a 4-byte little-endian window (bits <= 24 + shift <= 7
    fits 31 bits) — pure elementwise vector ops. The all-ones value at
    ``bits`` is the caller's sentinel."""
    bitpos = jnp.arange(n, dtype=jnp.int32) * bits
    byte = bitpos >> 3
    sh = (bitpos & 7).astype(jnp.uint32)
    w = wire.astype(jnp.uint32)
    window = (
        w[:, byte]
        | (w[:, byte + 1] << 8)
        | (w[:, byte + 2] << 16)
        | (w[:, byte + 3] << 24)
    )
    return ((window >> sh) & jnp.uint32((1 << bits) - 1)).astype(jnp.int32)


def _unpack_slots(
    wire: jax.Array, table_offsets: np.ndarray, trash_row: int, bits: int,
    n: int,
) -> jax.Array:
    """Bitstream [T, BYTES] -> global int32 slots [T, n] (sentinel -> trash)."""
    local = _unpack_raw(wire, bits, n)
    offs = jnp.asarray(table_offsets, jnp.int32)[:, None]
    return jnp.where(local == (1 << bits) - 1, trash_row, local + offs)


def _decode_dedup(
    inv_wire: jax.Array,
    uniq_wire: jax.Array,
    uniq_counts: jax.Array,
    geo: CacheGeometry,
    inv_bits: int,
    uniq_bits: int,
    n: int,
) -> Tuple[jax.Array, jax.Array]:
    """Decode the dedup wire format (host_cache.py probe_dedup) on device.

    inv_wire [T, IB]: table-local first-seen ranks (sentinel = masked).
    uniq_wire [UB_BYTES] (flat): position 0 is the reserved trash rank
    (sentinel-coded), then each table's local unique slot ids tightly
    concatenated, then sentinel padding to the bucket.
    Returns (uniq_slots [Ub] int32 global rows, ginv [T*n] int32 ranks into
    uniq_slots — masked positions -> 0, the trash rank)."""
    t_count = inv_wire.shape[0]
    ub = ((uniq_wire.shape[0] - 4) * 8) // uniq_bits  # exact: bits >= 9
    cum = jnp.cumsum(uniq_counts.astype(jnp.int32))
    # unique list: element j>=1 holds data position j-1; its table is the
    # first t with cum[t] > j-1
    vals = _unpack_raw(uniq_wire[None, :], uniq_bits, ub)[0]
    pos = jnp.arange(ub, dtype=jnp.int32) - 1
    # method='sort': the default 'scan' binary search lowers to log-many
    # serial dependent gathers; the sort-based form is one sort
    tbl = jnp.clip(
        jnp.searchsorted(cum, pos, side="right", method="sort"),
        0, t_count - 1,
    )
    offs = jnp.asarray(geo.table_offsets, jnp.int32)
    uniq_slots = jnp.where(
        vals == (1 << uniq_bits) - 1, geo.trash_row, vals + offs[tbl]
    )
    # inverse: local rank -> 1 + rank_offset[t] (+1 for the trash rank)
    inv = _unpack_raw(inv_wire, inv_bits, n)
    base = jnp.concatenate([jnp.zeros(1, jnp.int32), cum[:-1]])[:, None]
    ginv = jnp.where(inv == (1 << inv_bits) - 1, 0, inv + 1 + base)
    return uniq_slots, ginv.reshape(-1)


def _decode_dedup_raw(
    inv: jax.Array, uniq_slots: jax.Array, uniq_counts: jax.Array,
    sorted_wire: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """UNPACKED dedup wire (host_cache.probe_dedup_raw; selected when
    wire_pack is off): ``inv`` is int32 [T, n] table-local ranks (-1 =
    masked), ``uniq_slots`` int32 [Ub] GLOBAL cache rows. No bit unpacking,
    no table searchsorted — the packed decode is pure overhead on hosts
    where wire bytes are free.

    Default layout: position 0 reserved for the trash rank, trash-row
    padding at the tail. ``sorted_wire`` (StepConfig.sorted_wire): no
    reserved head — ascending unique slots from position 0, trash padding
    at the tail (still globally sorted: trash is the max row); masked
    lanes rank to the LAST position, which the bucket guard keeps as
    trash."""
    cum = jnp.cumsum(uniq_counts.astype(jnp.int32))
    base = jnp.concatenate([jnp.zeros(1, jnp.int32), cum[:-1]])[:, None]
    if sorted_wire:
        trash_rank = uniq_slots.shape[0] - 1
        ginv = jnp.where(inv < 0, trash_rank, inv + base)
    else:
        ginv = jnp.where(inv < 0, 0, inv + 1 + base)
    return uniq_slots, ginv.reshape(-1)


def _upcast_x(x, cdtype):
    """Dense features shipped as fp8 (Config.wire_x_fp8) are upcast once at
    step entry; compute always runs at cdtype (or f32)."""
    if x.dtype == jnp.float8_e4m3fn:
        return x.astype(cdtype if cdtype is not None else jnp.float32)
    return x


def _sgd(tree, grads, lr):
    return jax.tree_util.tree_map(lambda w, g: w - lr * g, tree, grads)


def _dense_adagrad(tree, grads, lr, accum, eps):
    """Element-wise AdaGrad with torch.optim.Adagrad semantics
    (std = sqrt(state_sum) + eps; p -= lr * g / std — eps OUTSIDE the
    sqrt), so dense behavior can be lockstep-pinned against torch. The
    reference trains SGD only (main_no_ddp.py:374-376); the optimizer
    surface is a beyond-parity addition. Returns (tree, accum)."""
    accum = jax.tree_util.tree_map(lambda a, g: a + g * g, accum, grads)
    tree = jax.tree_util.tree_map(
        lambda w, g, a: w - lr * g / (jnp.sqrt(a) + eps), tree, grads, accum
    )
    return tree, accum


def _rowwise_adagrad_scale(d_rows, acc_rows, lr_embeds, eps):
    """Row-wise AdaGrad on embedding rows (torchrec rowwise_adagrad
    semantics: per-row state += mean(g^2); update = -lr*g/(sqrt(state)+eps)).
    ``d_rows`` [U, D] per-row grads, ``acc_rows`` [U] gathered state.
    Returns (delta_rows [U, D], new_acc_rows [U]). Padding/trash rows carry
    exactly-zero grads, so their state and delta are unchanged/zero."""
    ms = jnp.mean(d_rows * d_rows, axis=1)
    acc_rows = acc_rows + ms
    delta = (-lr_embeds / (jnp.sqrt(acc_rows) + eps))[:, None] * d_rows
    return delta, acc_rows


def _hot_cold_update(
    cache: jax.Array,
    touched: Optional[jax.Array],
    flat_slots: jax.Array,
    drows: jax.Array,
    hot_slots: jax.Array,
    lr_embeds,
    cfg: "StepConfig",
    trash_row: int,
):
    """Hot-tier sparse SGD (StepConfig.hot_rows doc): identical sums to
    ``cache.at[flat_slots].add(-lr*drows)`` with H + K scatter rows instead
    of N. Returns (cache, touched)."""
    h = cfg.hot_rows
    n = flat_slots.shape[0]
    k = min(cfg.cold_bucket, n)  # pow2 bucket may round past N; cold <= N
    r_cache = cache.shape[0]
    # method='sort', NOT the default 'scan' (log-many serial dependent
    # gathers)
    pos = jnp.searchsorted(hot_slots, flat_slots, method="sort")
    pos_c = jnp.minimum(pos, h - 1).astype(jnp.int32)
    is_hot = hot_slots[pos_c] == flat_slots
    # trash-targeted lanes (masked/padded lookups; the trash row is always
    # the last hot entry) carry zero gradient and are semantically
    # discardable — REDIRECT them to spread indices instead of letting every
    # one of them chain onto one row (same-index scatter-add chains
    # serialize; adding -0.0 to a spread row is the float identity, so
    # spreading is exact)
    use_hot = is_hot & (flat_slots != trash_row)

    # hot: segment-sum via an N-row scatter-add into the small [H, D]
    # accumulator, then ONE H-row scatter applies it to the cache
    spread_h = jnp.arange(n, dtype=jnp.int32) % h
    d_hot = jnp.zeros((h, cache.shape[1]), jnp.float32).at[
        jnp.where(use_hot, pos_c, spread_h)
    ].add(jnp.where(use_hot[:, None], drows, 0).astype(jnp.float32))
    cache = cache.at[hot_slots].add(-lr_embeds * d_hot)

    # cold: static-size compaction to the host-guaranteed bucket via a
    # stable argsort (cold lanes first; unlike nonzero, an argsort
    # involves no index scatter). Overflow cannot
    # happen by construction (the shadow stats pass counts every batch's
    # exact cold lookups); padding spreads across rows with -0.0.
    cold_idx = jnp.argsort(is_hot)[:k]
    cold_ok = ~is_hot[cold_idx]
    spread_k = jnp.arange(k, dtype=jnp.int32) % r_cache
    cold_slots = jnp.where(cold_ok, flat_slots[cold_idx], spread_k)
    cold_g = jnp.where(cold_ok[:, None], drows[cold_idx], 0).astype(
        jnp.float32
    )
    cache = cache.at[cold_slots].add(-lr_embeds * cold_g)

    if touched is not None:
        hot_used = (
            jnp.zeros(h, jnp.int32)
            .at[jnp.where(use_hot, pos_c, spread_h)]
            .add(use_hot.astype(jnp.int32))
            > 0
        )
        touched = touched.at[hot_slots].max(hot_used)
        # .max(False) is a no-op, so padding lanes never mark their spread
        # rows as touched
        touched = touched.at[cold_slots].max(cold_ok)
        touched = touched.at[trash_row].set(False)
    return cache, touched


def _apply_md_proj(ly, params, cfg):
    """Per-table MD projection after pooling (StepConfig.md_proj): one
    batched [T, B, D] x [T, D, D] einsum (~1.7 GFLOP at bench shape —
    noise next to the MLPs). Pad rows of each projection are zero,
    so padded input columns contribute nothing and their gradients vanish
    exactly — the zero-padded cache layout is self-consistent under SGD."""
    proj = params["md_proj"]
    cdtype = cfg.cdtype
    if cdtype is not None:
        ly = ly.astype(cdtype)
        proj = proj.astype(cdtype)
    out = jnp.einsum(
        "tbd,tde->tbe", ly, proj, preferred_element_type=jnp.float32
    )
    return out if cdtype is None else out.astype(cdtype)


def _sync_dense_grads(
    grads: Params, strict_bias_divergence: bool, md_mask=None
) -> Params:
    """pmean over dp. The reference all-reduces Linear WEIGHTS only, silently
    letting biases diverge (main_no_ddp.py:237-245); we sync both unless
    strict parity with that bug is requested (SURVEY.md §7 quirk list).
    ``md_mask`` [T]: freezes the identity projections of full-dim MD tables
    (StepConfig.md_train_mask)."""

    def sync_mlp(layers):
        out = []
        for w, b in layers:
            w = jax.lax.pmean(w, DP_AXIS)
            if not strict_bias_divergence:
                b = jax.lax.pmean(b, DP_AXIS)
            out.append((w, b))
        return out

    out = {}
    for k, v in grads.items():
        if k == "md_proj":
            g = jax.lax.pmean(v, DP_AXIS)
            if md_mask is not None:
                g = g * md_mask[:, None, None]
            out[k] = g
        else:
            out[k] = sync_mlp(v)
    return out


def replicate_for_mesh(tree, mesh: Mesh):
    """Add a leading device axis to every leaf and shard it over dp
    (multihost-safe: each process materializes only its local shards)."""
    from cdlrm_tpu.parallel.mesh import local_replica_ids, put_global

    n = mesh.devices.size
    n_local = len(local_replica_ids(mesh))

    def put(x):
        x = np.asarray(x)
        sharding = NamedSharding(mesh, P(*([DP_AXIS] + [None] * x.ndim)))
        local = np.broadcast_to(x[None], (n_local,) + x.shape)
        return put_global(np.ascontiguousarray(local), sharding, (n,) + x.shape)

    return jax.tree_util.tree_map(put, tree)


def unreplicate(tree):
    """Take one replica of a leading-device-axis pytree (host-side;
    multihost-safe — reads this process's first addressable shard)."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x.addressable_shards[0].data)[0], tree
    )


def _spec_leading():
    return P(DP_AXIS)


# --------------------------------------------------------------------------
# cached-path steps
# --------------------------------------------------------------------------


def make_cached_train_step(
    mesh: Mesh, geo: CacheGeometry, cfg: StepConfig, pooled_width: int = 0,
    block: int = 1,
) -> Callable:
    """Build the jitted DP train step.

    ``block`` > 1 compiles a SCAN-BLOCK variant: one dispatch runs ``block``
    consecutive train steps via lax.scan over per-batch inputs passed flat
    (batch-major groups of 6) and stacked inside the program. Per-step
    outputs (loss_sum, correct) come back stacked [block]. Semantically
    step-for-step identical to ``block`` single calls (pinned in
    tests/test_trainer_e2e.py); the point is dispatch amortization: one
    large program per block instead of one small program per step.

    ``pooled_width`` > 0 enables multi-hot bags: slots come flattened
    [T, B*P], ls_mask [T, B, P] marks real positions, and pooling is a masked
    sum over P — the static-shape form of EmbeddingBag(mode='sum', offsets)
    (reference model_no_ddp.py:200-202). Masked positions resolve to the
    trash row (zero gradient via the mask).

    Inputs (shapes; B = global batch, Bl = B/ndev, T = tables, K = packed
    miss-bucket size, R = per-replica cache rows):
      params: pytree with leading [ndev] axis
      cache:   [ndev*R, D] flat, sharded P('dp')   touched: [ndev*R] bool
      x:       [B, dense_dim] sharded on batch
      slots:   [T, B] int32 sharded on batch axis (block-local row ids)
      aux_slots: [ndev*K] int32 (padding -> trash row)
      aux_rows:  [ndev*K, D] packed miss rows
      targets: [B, 1]
      lr, lr_embeds: scalars
    Returns (params, cache, touched, loss_sum, correct) — metrics are global
    (psum'd) scalars. With ``cfg.optimizer == 'adagrad'`` two optimizer
    state args ride after the per-batch inputs (dense_acc: pytree like
    params; embed_acc: [ndev*R] f32 flat like touched) and are returned
    updated: (params, cache, touched, dense_acc, embed_acc, loss, correct).
    """
    cdtype = cfg.cdtype
    adagrad = cfg.optimizer == "adagrad"
    if adagrad and not cfg.dedup:
        raise ValueError(
            "optimizer='adagrad' requires the dedup wire (duplicate-slot "
            "lookups must be coalesced before the row-wise state update); "
            "set dedup_lookups='on'"
        )
    if adagrad and cfg.hot_rows > 0:
        raise ValueError("optimizer='adagrad' is incompatible with the hot tier")
    if cfg.block_coalesce:
        # pending-sum exactness needs plain SGD (AdaGrad's accumulator is
        # per-step), per-step unique lists in raw form (the block ranks are
        # host-computed against the same layout), and a scan block to
        # amortize the flush over
        if block <= 1:
            raise ValueError("block_coalesce requires a scan block (block > 1)")
        if not cfg.dedup or cfg.wire_pack:
            raise ValueError(
                "block_coalesce requires the UNPACKED dedup wire"
            )
        if adagrad:
            raise ValueError("block_coalesce requires optimizer='sgd'")
        if cfg.hot_rows > 0:
            raise ValueError("block_coalesce is incompatible with the hot tier")

    def make_loss_fn(x, ls_mask, targets, t_count, b_loc, d):
        def loss_fn(params, rows):
            if pooled_width > 0:
                r = rows.reshape(t_count, b_loc, pooled_width, d)
                ly = jnp.sum(r * ls_mask[..., None].astype(r.dtype), axis=2)
            else:
                ly = rows.reshape(t_count, b_loc, d)
            if cfg.md_proj:
                ly = _apply_md_proj(ly, params, cfg)
            p = dlrm_forward(
                params,
                x,
                ly,
                cfg.interaction_op,
                cfg.interaction_itself,
                cfg.loss_threshold,
                cdtype,
            )
            loss = compute_loss(p, targets, cfg.loss_function, cfg.loss_weights)
            return loss, p

        return loss_fn

    md_mask = (
        jnp.asarray(cfg.md_train_mask, jnp.float32) if cfg.md_proj else None
    )

    def finish(params, dparams, p, loss, targets, lr, b_loc,
               dense_acc=None):
        dparams = _sync_dense_grads(
            dparams, cfg.strict_bias_divergence, md_mask
        )
        if adagrad:
            params, dense_acc = _dense_adagrad(
                params, dparams, lr, dense_acc, cfg.adagrad_eps
            )
            dense_acc = jax.tree_util.tree_map(lambda v: v[None], dense_acc)
        else:
            params = _sgd(params, dparams, lr)
        correct = jnp.sum((jnp.round(p) == targets).astype(jnp.float32))
        loss_sum, correct = jax.lax.psum((loss * b_loc, correct), DP_AXIS)
        params = jax.tree_util.tree_map(lambda v: v[None], params)
        return params, loss_sum, correct, dense_acc

    hot = cfg.hot_rows > 0

    def body(params, cache, touched, x, slots, ls_mask, aux_slots, aux_rows,
             targets, *tail):
        if hot:
            hot_slots, lr, lr_embeds = tail
        else:
            (lr, lr_embeds), hot_slots = tail, None
        params = jax.tree_util.tree_map(lambda v: v[0], params)
        x = _upcast_x(x, cdtype)
        b_loc = targets.shape[0]
        if cfg.wire_pack:
            n_lk = b_loc * max(1, pooled_width)
            slots = _unpack_slots(
                slots, geo.table_offsets, geo.trash_row, cfg.wire_bits, n_lk
            )
        targets = targets.astype(jnp.float32)
        t_count = slots.shape[0]
        d = cache.shape[-1]

        # stage packed miss rows into the aux regions (padding hits the
        # trash row; slots are distinct by construction)
        cache = cache.at[aux_slots].set(aux_rows.astype(jnp.float32))

        flat_slots = slots.reshape(-1)
        rows = jnp.take(cache, flat_slots, axis=0)  # [T*Bl(*P), D]

        loss_fn = make_loss_fn(x, ls_mask, targets, t_count, b_loc, d)
        (loss, p), (dparams, drows) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True
        )(params, rows)

        if hot:
            cache, touched2 = _hot_cold_update(
                cache, touched if cfg.track_touched else None, flat_slots,
                drows, hot_slots, lr_embeds, cfg, geo.trash_row,
            )
            if cfg.track_touched:
                touched = touched2
        else:
            # sparse SGD: scatter-add coalesces duplicate slots like torch's
            # sparse optimizer (DESIGN.md D3). Masked multi-hot lanes all
            # carry slot=trash with EXACTLY zero gradient — spread them
            # across rows (-0.0 is the float identity) instead of forming
            # one same-index scatter chain.
            upd_slots = flat_slots
            if pooled_width > 0:
                spread = (
                    jnp.arange(flat_slots.shape[0], dtype=jnp.int32)
                    % cache.shape[0]
                )
                upd_slots = jnp.where(
                    flat_slots == geo.trash_row, spread, flat_slots
                )
            cache = cache.at[upd_slots].add(-lr_embeds * drows)
            if cfg.track_touched:
                touched = touched.at[flat_slots].set(True)
                touched = touched.at[geo.trash_row].set(False)

        params, loss_sum, correct, _ = finish(
            params, dparams, p, loss, targets, lr, b_loc
        )
        return params, cache, touched, loss_sum, correct

    def body_dedup(params, cache, touched, x, inv_wire, ls_mask, uniq_wire,
                   uniq_counts, aux_slots, aux_rows, targets, *tail):
        dense_acc = embed_acc = None
        if hot:
            hot_slots, lr, lr_embeds = tail
        elif adagrad:
            dense_acc, embed_acc, lr, lr_embeds = tail
            hot_slots = None
            dense_acc = jax.tree_util.tree_map(lambda v: v[0], dense_acc)
        else:
            (lr, lr_embeds), hot_slots = tail, None
        params = jax.tree_util.tree_map(lambda v: v[0], params)
        x = _upcast_x(x, cdtype)
        b_loc = targets.shape[0]
        n_lk = b_loc * max(1, pooled_width)
        targets = targets.astype(jnp.float32)
        t_count = inv_wire.shape[0]
        d = cache.shape[-1]

        # aux slots are per-table-base + arange concatenated with trash
        # padding — globally sorted by construction (_pack_aux); distinct
        # except the trash padding
        cache = cache.at[aux_slots].set(
            aux_rows.astype(jnp.float32),
            indices_are_sorted=cfg.sorted_wire,
        )
        if cfg.wire_pack:
            uniq_slots, ginv = _decode_dedup(
                inv_wire, uniq_wire, uniq_counts, geo, cfg.inv_bits,
                cfg.uniq_bits, n_lk,
            )
        else:
            uniq_slots, ginv = _decode_dedup_raw(
                inv_wire, uniq_wire, uniq_counts, cfg.sorted_wire
            )
        rows_u = jnp.take(
            cache, uniq_slots, axis=0, indices_are_sorted=cfg.sorted_wire
        )  # [Ub, D]

        loss_fn_rows = make_loss_fn(x, ls_mask, targets, t_count, b_loc, d)

        if hot:
            # hot tier: differentiate w.r.t. the EXPANDED rows (per-lookup
            # gradients, no intermediate [Ub, D] scatter), then split
            # hot/cold by each lookup's resolved slot
            rows_exp = jnp.take(rows_u, ginv, axis=0)
            (loss, p), (dparams, drows) = jax.value_and_grad(
                loss_fn_rows, argnums=(0, 1), has_aux=True
            )(params, rows_exp)
            flat_slots = jnp.take(uniq_slots, ginv)
            cache, touched2 = _hot_cold_update(
                cache, touched if cfg.track_touched else None, flat_slots,
                drows, hot_slots, lr_embeds, cfg, geo.trash_row,
            )
            if cfg.track_touched:
                touched = touched2
        else:

            def loss_fn(params, rows_u):
                # the take's transpose segment-sums duplicate-lookup
                # gradients into [Ub, D] — the small-operand scatter that
                # replaces the full-width one
                return loss_fn_rows(params, jnp.take(rows_u, ginv, axis=0))

            (loss, p), (dparams, d_rows_u) = jax.value_and_grad(
                loss_fn, argnums=(0, 1), has_aux=True
            )(params, rows_u)

            if adagrad:
                # row-wise state ride-along: gather/scatter the [Ub] f32
                # accumulators at the SAME unique slots (tiny next to the
                # row traffic). Trash/padding positions carry exactly-zero
                # grads — their state writes are value-identical no-ops.
                acc_rows = jnp.take(
                    embed_acc, uniq_slots,
                    indices_are_sorted=cfg.sorted_wire,
                )
                delta_rows, acc_rows = _rowwise_adagrad_scale(
                    d_rows_u, acc_rows, lr_embeds, cfg.adagrad_eps
                )
                embed_acc = embed_acc.at[uniq_slots].set(
                    acc_rows, indices_are_sorted=cfg.sorted_wire
                )
            else:
                delta_rows = -lr_embeds * d_rows_u

            cache = cache.at[uniq_slots].add(
                delta_rows, indices_are_sorted=cfg.sorted_wire
            )
            if cfg.track_touched:
                touched = touched.at[uniq_slots].set(
                    True, indices_are_sorted=cfg.sorted_wire
                )
                touched = touched.at[geo.trash_row].set(False)

        params, loss_sum, correct, dense_acc = finish(
            params, dparams, p, loss, targets, lr, b_loc, dense_acc
        )
        if adagrad:
            return (params, cache, touched, dense_acc, embed_acc,
                    loss_sum, correct)
        return params, cache, touched, loss_sum, correct

    def body_coalesce(params, cache, touched, pend, x, inv_wire, ls_mask,
                      uniq_wire, uniq_counts, uniq_blk, aux_slots, aux_rows,
                      targets, lr, lr_embeds):
        """One scan-block step of the block-coalesced update (StepConfig
        docstring): reads w_eff = cache - lr * pending, routes per-lookup
        gradients into the small pending buffer with ONE duplicate-row
        scatter, and leaves the cache untouched except aux staging — the
        block-union flush happens once, after the scan."""
        params = jax.tree_util.tree_map(lambda v: v[0], params)
        x = _upcast_x(x, cdtype)
        b_loc = targets.shape[0]
        targets = targets.astype(jnp.float32)
        t_count = inv_wire.shape[0]
        d = cache.shape[-1]
        p_trash = pend.shape[0] - 1  # host contract: last pending row

        cache = cache.at[aux_slots].set(
            aux_rows.astype(jnp.float32),
            indices_are_sorted=cfg.sorted_wire,
        )
        uniq_slots, ginv = _decode_dedup_raw(
            inv_wire, uniq_wire, uniq_counts, cfg.sorted_wire
        )
        rows_u = jnp.take(
            cache, uniq_slots, axis=0, indices_are_sorted=cfg.sorted_wire
        )  # [Ub, D]
        # effective weight: the block's not-yet-flushed updates live in
        # pending (pad/aux/trash ranks read the pending trash row, which
        # stays exactly zero — see the gradient mask below)
        w_eff = rows_u - lr_embeds * jnp.take(pend, uniq_blk, axis=0)
        # differentiate w.r.t. the EXPANDED rows: no take-transpose
        # segment-sum, no per-step [Ub, D] intermediate — the per-lookup
        # gradient goes straight into pending
        rows_exp = jnp.take(w_eff, ginv, axis=0)
        loss_fn_rows = make_loss_fn(x, ls_mask, targets, t_count, b_loc, d)
        (loss, p), (dparams, drows) = jax.value_and_grad(
            loss_fn_rows, argnums=(0, 1), has_aux=True
        )(params, rows_exp)

        blk_rank = jnp.take(uniq_blk, ginv)  # [N] per-lookup block ranks
        # aux/trash/masked lanes carry rank p_trash: zero their deltas so
        # the pending trash row stays exactly +0.0 and the flush's padded
        # positions are -0.0 identity adds
        d_eff = drows * (blk_rank != p_trash)[:, None].astype(drows.dtype)
        pend = pend.at[blk_rank].add(d_eff)

        if cfg.track_touched:
            touched = touched.at[uniq_slots].set(
                True, indices_are_sorted=cfg.sorted_wire
            )
            touched = touched.at[geo.trash_row].set(False)

        params, loss_sum, correct, _ = finish(
            params, dparams, p, loss, targets, lr, b_loc
        )
        return params, cache, touched, pend, loss_sum, correct

    lead = _spec_leading()
    # hot tier adds one per-window replicated input (hot_slots) before lr
    hot_specs = (P(),) if hot else ()
    if cfg.block_coalesce:
        # per-batch inputs (9): the dedup wire + uniq_blk; per-block inputs:
        # blk_slots (sorted block union, trash-padded) + blk_counts
        batch_specs = (
            P(DP_AXIS),  # x
            P(None, DP_AXIS),  # inv_wire
            P(None, DP_AXIS),  # ls_mask
            lead,  # uniq_wire
            lead,  # uniq_counts
            lead,  # uniq_blk
            lead,  # aux_slots
            lead,  # aux_rows
            P(DP_AXIS),  # targets
        )
        n_in = len(batch_specs)

        def scanned_coalesce(params, cache, touched, *rest):
            lr, lr_embeds = rest[-2], rest[-1]
            blk_slots = rest[-4]  # rest[-3] = blk_counts (host-side only)
            flat = rest[:-4]
            stacked = tuple(
                jnp.stack([flat[j * n_in + i] for j in range(block)])
                for i in range(n_in)
            )
            p_local = blk_slots.shape[0]
            pend0 = jnp.zeros((p_local, cache.shape[-1]), jnp.float32)

            def f(carry, xs):
                p, c, t, pe = carry
                p, c, t, pe, ls, corr = body_coalesce(
                    p, c, t, pe, *xs, lr, lr_embeds
                )
                return (p, c, t, pe), (ls, corr)

            (params, cache, touched, pend), (loss, corr) = jax.lax.scan(
                f, (params, cache, touched, pend0), stacked
            )
            # block flush: ONE U_block-row scatter into the cache. Padded
            # positions hold exactly +0.0 pending rows (the gradient mask
            # keeps even the pending trash row clean), so after the -lr
            # scale they add -0.0 — the float identity — and are SPREAD
            # across distinct rows instead of forming one trash-row
            # same-index chain.
            spread = jnp.arange(p_local, dtype=jnp.int32) % cache.shape[0]
            slots_eff = jnp.where(
                blk_slots == geo.trash_row, spread, blk_slots
            )
            cache = cache.at[slots_eff].add(-lr_embeds * pend)
            return params, cache, touched, loss, corr

        shardmapped = jax.shard_map(
            scanned_coalesce,
            mesh=mesh,
            in_specs=(lead, lead, lead) + batch_specs * block
            + (lead, lead) + (P(), P()),
            out_specs=(lead, lead, lead) + (P(), P()),
            check_vma=False,
        )
        return jax.jit(shardmapped, donate_argnums=(1, 2))
    if block > 1:
        if cfg.dedup:
            # dedup wire: 8 per-batch inputs; shapes are block-stable
            # because the trainer fixes the aux AND unique buckets per
            # window (trainer._apply_window_stats)
            body_fn = body_dedup
            batch_specs = (
                P(DP_AXIS),  # x
                P(None, DP_AXIS),  # inv_wire
                P(None, DP_AXIS),  # ls_mask
                lead,  # uniq_wire
                lead,  # uniq_counts
                lead,  # aux_slots
                lead,  # aux_rows
                P(DP_AXIS),  # targets
            )
        else:
            body_fn = body
            batch_specs = (
                P(DP_AXIS),  # x
                P(None, DP_AXIS),  # slots
                P(None, DP_AXIS),  # ls_mask
                lead,  # aux_slots
                lead,  # aux_rows
                P(DP_AXIS),  # targets
            )
        n_in = len(batch_specs)

        def scanned(params, cache, touched, *rest):
            # rest = block * n_in per-batch inputs + (hot_slots?,
            # dense_acc?, embed_acc?, lr, lr_embeds). Stacking happens
            # INSIDE the compiled program, so staging stays one (pipelined)
            # put per batch and dispatch cost is paid once per BLOCK: on
            # busy hosts the per-step overhead divides by the block size.
            lr, lr_embeds = rest[-2], rest[-1]
            n_state = 2 if adagrad else 0
            extra = (rest[-3 - n_state],) if hot else ()  # per-window hot
            state = tuple(rest[-2 - n_state: -2]) if adagrad else ()
            flat = rest[: -2 - n_state - len(extra)]  # batch-major groups
            stacked = tuple(
                jnp.stack([flat[j * n_in + i] for j in range(block)])
                for i in range(n_in)
            )

            def f(carry, xs):
                if adagrad:
                    p, c, t, da, ea = carry
                    p, c, t, da, ea, ls, corr = body_fn(
                        p, c, t, *xs, da, ea, lr, lr_embeds
                    )
                    return (p, c, t, da, ea), (ls, corr)
                p, c, t = carry
                p, c, t, ls, corr = body_fn(p, c, t, *xs, *extra, lr, lr_embeds)
                return (p, c, t), (ls, corr)

            carry0 = (params, cache, touched) + state
            carry, (loss, corr) = jax.lax.scan(f, carry0, stacked)
            if adagrad:
                params, cache, touched, da, ea = carry
                return params, cache, touched, da, ea, loss, corr
            params, cache, touched = carry
            return params, cache, touched, loss, corr

        state_specs = (lead, lead) if adagrad else ()
        n_args = 3 + block * n_in + len(hot_specs) + len(state_specs) + 2
        shardmapped = jax.shard_map(
            scanned,
            mesh=mesh,
            in_specs=(lead, lead, lead) + batch_specs * block + hot_specs
            + state_specs + (P(), P()),
            out_specs=(lead, lead, lead) + state_specs + (P(), P()),
            check_vma=False,
        )
        donate = (1, 2) + (
            (n_args - 4, n_args - 3) if adagrad else ()
        )
        return jax.jit(shardmapped, donate_argnums=donate)
    if cfg.dedup:
        state_specs = (lead, lead) if adagrad else ()
        shardmapped = jax.shard_map(
            body_dedup,
            mesh=mesh,
            in_specs=(
                lead,  # params
                lead,  # cache (flat rows)
                lead,  # touched (flat rows)
                P(DP_AXIS),  # x
                P(None, DP_AXIS),  # inv_wire [T, ndev*IB]
                P(None, DP_AXIS),  # ls_mask ([T,B,P] or dummy [T,B])
                lead,  # uniq_wire (flat bytes)
                lead,  # uniq_counts (flat [ndev*T])
                lead,  # aux_slots (flat)
                lead,  # aux_rows (flat)
                P(DP_AXIS),  # targets
            ) + hot_specs + state_specs + (
                P(),  # lr
                P(),  # lr_embeds
            ),
            out_specs=(lead, lead, lead) + state_specs + (P(), P()),
            check_vma=False,
        )
        donate = (1, 2) + ((11, 12) if adagrad else ())
        return jax.jit(shardmapped, donate_argnums=donate)
    shardmapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            lead,  # params
            lead,  # cache (flat rows)
            lead,  # touched (flat rows)
            P(DP_AXIS),  # x
            P(None, DP_AXIS),  # slots
            P(None, DP_AXIS),  # ls_mask ([T,B,P] or dummy [T,B])
            lead,  # aux_slots (flat)
            lead,  # aux_rows (flat)
            P(DP_AXIS),  # targets
        ) + hot_specs + (
            P(),  # lr
            P(),  # lr_embeds
        ),
        out_specs=(lead, lead, lead, P(), P()),
        check_vma=False,
    )
    return jax.jit(shardmapped, donate_argnums=(1, 2))


def make_cached_eval_step(
    mesh: Mesh, geo: CacheGeometry, cfg: StepConfig, pooled_width: int = 0
) -> Callable:
    """Forward-only cached step returning (cache, scores [B, 1]).

    The reference evaluates on rank 0 only with the full test batch
    (main_no_ddp.py:479-494); we shard eval across replicas — each uses its
    own cache copy, which is identical right after a refill broadcast and
    near-identical otherwise (documented deviation). The cache is donated
    and returned: the only mutation is the aux-region staging, which every
    step overwrites anyway — persisting it avoids a defensive full-cache
    copy per eval batch."""
    cdtype = cfg.cdtype

    def body(params, cache, x, slots, ls_mask, aux_slots, aux_rows):
        params = jax.tree_util.tree_map(lambda v: v[0], params)
        x = _upcast_x(x, cdtype)
        b_loc = x.shape[0]
        if cfg.wire_pack:
            n_lk = b_loc * max(1, pooled_width)
            slots = _unpack_slots(
                slots, geo.table_offsets, geo.trash_row, cfg.wire_bits, n_lk
            )
        t_count = slots.shape[0]
        d = cache.shape[-1]
        cache = cache.at[aux_slots].set(aux_rows.astype(jnp.float32))
        rows = jnp.take(cache, slots.reshape(-1), axis=0)
        if pooled_width > 0:
            r = rows.reshape(t_count, b_loc, pooled_width, d)
            ly = jnp.sum(r * ls_mask[..., None].astype(r.dtype), axis=2)
        else:
            ly = rows.reshape(t_count, b_loc, d)
        if cfg.md_proj:
            ly = _apply_md_proj(ly, params, cfg)
        p = dlrm_forward(
            params, x, ly, cfg.interaction_op, cfg.interaction_itself,
            cfg.loss_threshold, cdtype,
        )
        return cache, p

    lead = _spec_leading()
    shardmapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(lead, lead, P(DP_AXIS), P(None, DP_AXIS), P(None, DP_AXIS),
                  lead, lead),
        out_specs=(lead, P(DP_AXIS)),
        check_vma=False,
    )
    return jax.jit(shardmapped, donate_argnums=(1,))


def make_refill_step(mesh: Mesh, cfg: StepConfig) -> Callable:
    """Jitted refill: gather evicted rows (pre-insert values), scatter insert
    rows, then broadcast replica 0's cache to all replicas (the reference's
    rank-0 CacheEmbeddings + whole-cache NCCL broadcast,
    main_no_ddp.py:309-321). Insert/evict slot buffers are host-bucketed to
    powers of two (DESIGN.md D6); padding targets the trash row.

    Returns (cache, evicted[ndev*E, D] flat). Evicted rows are broadcast
    from global replica 0 (the reference gathers them on rank 0,
    main_no_ddp.py:196-199), so every host's local shard holds identical
    values — multi-host writeback needs no extra exchange
    (parallel/multihost.py).

    refill_broadcast='delta' (StepConfig doc) skips the O(R*D) whole-cache
    psum: the insert buffer is already replica-identical (staged replicated,
    P() spec), so the broadcast's purpose — propagating inserted rows — is
    served by the scatter itself. The evicted-row broadcast stays (it is
    O(E*D), and writeback correctness needs replica-identical values)."""
    mode = cfg.refill_broadcast
    if mode is True:
        mode = "strict"
    elif mode is False:
        mode = "off"
    if mode not in ("strict", "delta", "off"):
        raise ValueError(f"unsupported refill_broadcast mode: {mode!r}")
    adagrad = cfg.optimizer == "adagrad"
    master_state = adagrad and cfg.adagrad_master_state

    def body(cache, insert_slots, insert_rows, evict_slots, accum=None,
             insert_acc=None):
        evicted = jnp.take(cache, evict_slots, axis=0)
        ev_acc = None
        if master_state:
            # evicted slots' accumulator values leave WITH the rows (same
            # pre-insert gather point, same replica-0 broadcast) so the
            # host store stays a consistent (value, state) pair per id
            ev_acc = jnp.take(accum, evict_slots)
        if mode in ("strict", "delta"):
            idx = jax.lax.axis_index(DP_AXIS)
            evicted = jax.lax.psum(
                jnp.where(idx == 0, evicted, jnp.zeros_like(evicted)), DP_AXIS
            )
            if master_state:
                ev_acc = jax.lax.psum(
                    jnp.where(idx == 0, ev_acc, jnp.zeros_like(ev_acc)),
                    DP_AXIS,
                )
        if cfg.wire_rows_bf16:
            evicted = evicted.astype(jnp.bfloat16)  # halve the D2H writeback
        cache = cache.at[insert_slots].set(insert_rows.astype(jnp.float32))
        if master_state:
            # the inserted id's accumulator RESUMES from the host store
            # (gathered alongside the row values) instead of restarting
            accum = accum.at[insert_slots].set(insert_acc)
        elif adagrad:
            # an inserted slot holds a FRESH id: its row-wise AdaGrad state
            # restarts (the evicted id's state is dropped — documented
            # cache-resident-state semantic, StepConfig.optimizer)
            accum = accum.at[insert_slots].set(0.0)
        if mode == "strict":
            idx = jax.lax.axis_index(DP_AXIS)
            contrib = jnp.where(idx == 0, cache, jnp.zeros_like(cache))
            cache = jax.lax.psum(contrib, DP_AXIS)
            if adagrad:
                accum = jax.lax.psum(
                    jnp.where(idx == 0, accum, jnp.zeros_like(accum)),
                    DP_AXIS,
                )
        if master_state:
            return cache, accum, evicted, ev_acc
        if adagrad:
            return cache, accum, evicted
        return cache, evicted

    lead = _spec_leading()
    if master_state:
        shardmapped = jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(lead, P(), P(), P(), lead, P()),
            out_specs=(lead, lead, lead, lead),
            check_vma=False,
        )
        return jax.jit(shardmapped, donate_argnums=(0, 4))
    if adagrad:
        shardmapped = jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(lead, P(), P(), P(), lead),
            out_specs=(lead, lead, lead),
            check_vma=False,
        )
        return jax.jit(shardmapped, donate_argnums=(0, 4))
    shardmapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(lead, P(), P(), P()),
        out_specs=(lead, lead),
        check_vma=False,
    )
    return jax.jit(shardmapped, donate_argnums=(0,))


def make_aggregate_step(
    mesh: Mesh, cfg: StepConfig, union_bucket: Optional[int] = None,
    trash_row: int = 0,
) -> Callable:
    """Periodic touched-row aggregation (reference broadcast_and_aggregate,
    main_no_ddp.py:250-292): union of rows touched by ANY replica since the
    last aggregation; every replica contributes its current value; combine
    with sum | mean (/world) | max; untouched rows keep their local values.

    ``union_bucket`` selects the sparse exchange (the reference ships only
    touched slices, main_no_ddp.py:250-292; round 1's dense masked allreduce
    moved O(R*D) bytes per call): the touched masks are pmax'd over dp (O(R)
    bytes), compacted to a static-size slot list (``jnp.nonzero(size=K)``,
    padding -> the trash row), and only those K rows ride the collective.
    The caller guarantees the union NEVER exceeds the bucket: each train step
    touches at most (global lookups per step) distinct slots, so
    ``table_agg_freq * B_glob * T * max(1, P)`` bounds it exactly (trainer
    picks the bucket; falls back to ``union_bucket=None`` = dense when the
    bound approaches R and the dense path is cheaper).

    Union-mean subtlety (SURVEY.md §7): rows touched by NO replica are not in
    the union and keep local values; union rows are contributed by EVERY
    replica (touched or not) and divided by world size — exactly the
    reference's all_reduce-of-selected-slices semantics."""
    op = cfg.table_agg_op
    adagrad = cfg.optimizer == "adagrad"

    def combine(rows):
        if op == "sum":
            return jax.lax.psum(rows, DP_AXIS)
        if op == "mean":
            return jax.lax.psum(rows, DP_AXIS) / jax.lax.axis_size(DP_AXIS)
        if op == "max":
            return jax.lax.pmax(rows, DP_AXIS)
        raise ValueError(f"unsupported table_agg_op: {op}")

    if union_bucket is not None:
        k = int(union_bucket)

        def body(cache, touched, accum=None):
            # bf16 is exact for {0,1} and halves the mask collective
            union = jax.lax.pmax(touched.astype(jnp.bfloat16), DP_AXIS) > 0
            # static-size compaction; padding targets the trash row, whose
            # (meaningless) value is aggregated alongside — harmless: every
            # step overwrites/ignores it (geometry.py trash-row contract)
            # nonzero emits ascending indices; the trash-row tail fill is
            # the per-shard maximum row, so idx is globally non-decreasing
            (idx,) = jnp.nonzero(union, size=k, fill_value=trash_row)
            rows = jnp.take(cache, idx, axis=0, indices_are_sorted=True)
            agg_rows = combine(rows)
            cache = cache.at[idx].set(agg_rows, indices_are_sorted=True)
            if adagrad:
                # the row-wise state syncs with its rows (same combine op)
                # so the per-row update scale stays replica-consistent
                acc_rows = combine(
                    jnp.take(accum, idx, indices_are_sorted=True)
                )
                accum = accum.at[idx].set(
                    acc_rows, indices_are_sorted=True
                )
                return cache, jnp.zeros_like(touched), accum
            return cache, jnp.zeros_like(touched)

    else:

        def body(cache, touched, accum=None):
            union = jax.lax.pmax(touched.astype(jnp.bfloat16), DP_AXIS) > 0
            mask = union[:, None]
            if op == "max":
                agg = jax.lax.pmax(jnp.where(mask, cache, -jnp.inf), DP_AXIS)
            else:
                agg = combine(jnp.where(mask, cache, 0.0))
            cache = jnp.where(mask, agg, cache)
            if adagrad:
                if op == "max":
                    acc_agg = jax.lax.pmax(
                        jnp.where(union, accum, -jnp.inf), DP_AXIS
                    )
                else:
                    acc_agg = combine(jnp.where(union, accum, 0.0))
                accum = jnp.where(union, acc_agg, accum)
                return cache, jnp.zeros_like(touched), accum
            return cache, jnp.zeros_like(touched)

    lead = _spec_leading()
    if adagrad:
        shardmapped = jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(lead, lead, lead),
            out_specs=(lead, lead, lead),
            check_vma=False,
        )
        return jax.jit(shardmapped, donate_argnums=(0, 1, 2))
    shardmapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(lead, lead),
        out_specs=(lead, lead),
        check_vma=False,
    )
    return jax.jit(shardmapped, donate_argnums=(0, 1))


# --------------------------------------------------------------------------
# full-table (uncached) steps — small configs, tests, and the oracle
# --------------------------------------------------------------------------


def make_fulltable_train_step(mesh: Mesh, cfg: StepConfig, pooled: bool = False) -> Callable:
    """DP train step with device-resident full embedding tables
    (params['emb'] is the table list from models/embedding.py — plain, QR, or
    MD entries). Dense and embedding grads both flow through value_and_grad;
    embedding grads are NOT pmean'd — each replica applies its own sparse
    update, then... unlike the cached path the reference has no uncached DP
    mode, so we choose the standard DP semantic: embedding grads are pmean'd
    too (fully synchronous DP). Used for small configs and as the
    training-dynamics oracle."""
    from cdlrm_tpu.models.embedding import embedding_forward

    cdtype = cfg.cdtype
    adagrad = cfg.optimizer == "adagrad"

    def body(params, x, ls_i, ls_mask, targets, lr, lr_embeds, *opt):
        params = jax.tree_util.tree_map(lambda v: v[0], params)
        if adagrad:
            (accum,) = opt
            accum = jax.tree_util.tree_map(lambda v: v[0], accum)

        def loss_fn(params):
            ly = embedding_forward(params["emb"], ls_i, ls_mask if pooled else None)
            p = dlrm_forward(
                {"bot": params["bot"], "top": params["top"]},
                x,
                ly,
                cfg.interaction_op,
                cfg.interaction_itself,
                cfg.loss_threshold,
                cdtype,
            )
            loss = compute_loss(p, targets, cfg.loss_function, cfg.loss_weights)
            return loss, p

        (loss, p), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        grads = jax.tree_util.tree_map(lambda g: jax.lax.pmean(g, DP_AXIS), grads)
        dense = {"bot": params["bot"], "top": params["top"]}
        dense_g = {"bot": grads["bot"], "top": grads["top"]}
        if adagrad:
            dense, dense_acc = _dense_adagrad(
                dense, dense_g,
                lr, {"bot": accum["bot"], "top": accum["top"]},
                cfg.adagrad_eps,
            )
            # row-wise AdaGrad on each FULL table (untouched rows have
            # exactly-zero dense grads -> state and value unchanged); this
            # is the oracle the cached adagrad path must match exactly when
            # fully resident (tests/test_trainer_e2e.py)
            emb, emb_acc = [], []
            for w, g, a in zip(params["emb"], grads["emb"], accum["emb"]):
                delta, a = _rowwise_adagrad_scale(
                    g, a, lr_embeds, cfg.adagrad_eps
                )
                emb.append(w + delta)
                emb_acc.append(a)
            accum = {"bot": dense_acc["bot"], "top": dense_acc["top"],
                     "emb": emb_acc}
        else:
            dense = _sgd(dense, dense_g, lr)
            emb = _sgd(params["emb"], grads["emb"], lr_embeds)
        new_params = {"bot": dense["bot"], "top": dense["top"], "emb": emb}

        b_loc = targets.shape[0]
        correct = jnp.sum((jnp.round(p) == targets).astype(jnp.float32))
        loss_sum, correct = jax.lax.psum((loss * b_loc, correct), DP_AXIS)
        new_params = jax.tree_util.tree_map(lambda v: v[None], new_params)
        if adagrad:
            accum = jax.tree_util.tree_map(lambda v: v[None], accum)
            return new_params, accum, loss_sum, correct
        return new_params, loss_sum, correct

    lead = _spec_leading()
    mask_spec = P(None, DP_AXIS)
    opt_specs = (lead,) if adagrad else ()
    shardmapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(lead, P(DP_AXIS), P(None, DP_AXIS), mask_spec,
                  P(DP_AXIS), P(), P()) + opt_specs,
        out_specs=(lead,) + opt_specs + (P(), P()),
        check_vma=False,
    )
    return jax.jit(
        shardmapped, donate_argnums=(0, 7) if adagrad else (0,)
    )


def make_fulltable_eval_step(mesh: Mesh, cfg: StepConfig, pooled: bool = False) -> Callable:
    from cdlrm_tpu.models.embedding import embedding_forward

    cdtype = cfg.cdtype

    def body(params, x, ls_i, ls_mask):
        params = jax.tree_util.tree_map(lambda v: v[0], params)
        ly = embedding_forward(params["emb"], ls_i, ls_mask if pooled else None)
        return dlrm_forward(
            {"bot": params["bot"], "top": params["top"]},
            x,
            ly,
            cfg.interaction_op,
            cfg.interaction_itself,
            cfg.loss_threshold,
            cdtype,
        )

    lead = _spec_leading()
    shardmapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(lead, P(DP_AXIS), P(None, DP_AXIS), P(None, DP_AXIS)),
        out_specs=P(DP_AXIS),
        check_vma=False,
    )
    return jax.jit(shardmapped)
