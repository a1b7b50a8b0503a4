"""ctypes bindings for the native host-ops library (csrc/host_ops.cpp).

The library is compiled on first use with g++ (cached by source hash next to
the source tree); every caller degrades gracefully to its numpy path when the
toolchain is missing or ``CDLRM_NO_NATIVE=1``. See csrc/host_ops.cpp for what
each kernel replaces in the reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "csrc", "host_ops.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "csrc", "build")

_I64 = ctypes.c_int64
_PI64 = ctypes.POINTER(ctypes.c_int64)
_PI32 = ctypes.POINTER(ctypes.c_int32)
_PF32 = ctypes.POINTER(ctypes.c_float)
_PU8 = ctypes.POINTER(ctypes.c_uint8)
_PU64 = ctypes.POINTER(ctypes.c_uint64)
_PPI32 = ctypes.POINTER(_PI32)


def _host_isa_tag() -> str:
    """Digest of the machine's ISA surface: the .so is built -march=native,
    so a build dir shared across heterogeneous hosts (multi-host mode on a
    network filesystem) must not load another host's artifact — a missing
    ISA extension would SIGILL. Keyed on arch + CPU flags."""
    import platform

    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    return hashlib.sha256(
        (platform.machine() + "|" + flags).encode()
    ).hexdigest()[:8]


def _build() -> Optional[str]:
    if not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(_BUILD_DIR, f"libcdlrm_host_{tag}_{_host_isa_tag()}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # per-pid tmp: concurrent processes (multi-host tests, parallel CI) race
    # on a shared name — one's os.replace would tear another's in-flight write
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-funroll-loops", "-std=c++17",
        "-shared", "-fPIC", "-fopenmp", _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        # retry without native/openmp flags (portability)
        try:
            subprocess.run(
                ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC,
                 "-o", tmp],
                check=True, capture_output=True, timeout=120,
            )
        except (subprocess.SubprocessError, FileNotFoundError):
            return None
    try:
        os.replace(tmp, so)
    except OSError:
        return so if os.path.exists(so) else None
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("CDLRM_NO_NATIVE"):
            return None
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.cdlrm_probe_table.restype = _I64
        lib.cdlrm_probe_table.argtypes = [
            _PI32, _I64, _I64, _PI64, _I64, _PU8, _I64, _I64, _I64, _PI32, _PI32,
        ]
        lib.cdlrm_probe_batch.restype = None
        lib.cdlrm_probe_batch.argtypes = [
            _PPI32, _PI64, _I64, _I64, _PI64, _I64, _PU8, _PI64, _PI64, _I64,
            _PI32, _PI32, _PI64,
        ]
        lib.cdlrm_probe_batch_wire.restype = None
        lib.cdlrm_probe_batch_wire.argtypes = [
            _PPI32, _PI64, _I64, _I64, _PI64, _I64, _PU8, _PI64, _PU8,
            _PI32, _PI64,
        ]
        lib.cdlrm_probe_batch_wirebits.restype = None
        lib.cdlrm_probe_batch_wirebits.argtypes = [
            _PPI32, _PI64, _I64, _I64, _PI64, _I64, _PU8, _PI64, _I64, _I64,
            _PU8, _PI32, _PI64,
        ]
        lib.cdlrm_map_probe_batch_wire.restype = None
        lib.cdlrm_map_probe_batch_wire.argtypes = [
            _PI32, _PI64, _I64, _PI64, _I64, _PU8, _PI64, _PI64, _I64, _I64,
            _PU8, _PI32, _PI64,
        ]
        lib.cdlrm_pack_bits.restype = None
        lib.cdlrm_pack_bits.argtypes = [_PI64, _I64, _I64, _PU8]
        lib.cdlrm_probe_batch_dedup.restype = None
        lib.cdlrm_probe_batch_dedup.argtypes = [
            _PPI32, _PI64, _I64, _I64, _PI64, _I64, _PU8, _PI64, _I64, _PI64,
            _I64, _I64, _PPI32, _PU8, _PI32, _PI64, _PI32, _PI64,
        ]
        lib.cdlrm_map_probe_batch_dedup.restype = None
        lib.cdlrm_map_probe_batch_dedup.argtypes = [
            _PI32, _PI64, _I64, _PI64, _I64, _PU8, _PI64, _PI64, _I64, _I64,
            _I64, _PPI32, _PU8, _PI32, _PI64, _PI32, _PI64,
        ]
        lib.cdlrm_sort_dedup_wire.restype = None
        lib.cdlrm_sort_dedup_wire.argtypes = [_PI32, _PI32, _PI64, _I64, _I64]
        lib.cdlrm_unique_i64.restype = _I64
        lib.cdlrm_unique_i64.argtypes = [_PI64, _I64, _I64, _PI64]
        lib.cdlrm_gather_f32.restype = None
        lib.cdlrm_gather_f32.argtypes = [_PF32, _I64, _PI64, _I64, _PF32]
        lib.cdlrm_writeback_f32.restype = None
        lib.cdlrm_writeback_f32.argtypes = [_PF32, _I64, _PI64, _I64, _PF32,
                                            ctypes.c_int]
        lib.cdlrm_unique_gather_f32.restype = _I64
        lib.cdlrm_unique_gather_f32.argtypes = [
            _PI64, _I64, _I64, _PF32, _I64, _PI64, _PF32,
        ]
        lib.cdlrm_mask_bits.restype = None
        lib.cdlrm_mask_bits.argtypes = [_PU8, _I64, _PU64]
        lib.cdlrm_block_union.restype = _I64
        lib.cdlrm_block_union.argtypes = [
            _PI32, _I64, _PU64, _I64, _PI32, _PI32,
        ]
        lib.cdlrm_block_ranks.restype = _I64
        lib.cdlrm_block_ranks.argtypes = [
            _PI32, _PI64, _I64, _PI32, _I64, ctypes.c_int32, _I64, _I64,
            _I64, _PI32,
        ]
        lib.cdlrm_block_union_reset.restype = None
        lib.cdlrm_block_union_reset.argtypes = [_PI32, _I64, _PI32]
        lib.cdlrm_num_threads.restype = ctypes.c_int
        lib.cdlrm_set_num_threads.argtypes = [ctypes.c_int]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def library_path() -> Optional[str]:
    """Path of the loaded native library; None when the numpy fallbacks
    run (no g++, a failed build, or CDLRM_NO_NATIVE set)."""
    lib = _load()
    return None if lib is None else lib._name


def set_num_threads(n: int) -> None:
    lib = _load()
    if lib is not None:
        lib.cdlrm_set_num_threads(int(n))


def num_threads() -> int:
    lib = _load()
    return int(lib.cdlrm_num_threads()) if lib is not None else 1


def _p(arr: np.ndarray, ptype):
    return arr.ctypes.data_as(ptype)


def _check_id_range(ls_i: np.ndarray, valid: Optional[np.ndarray] = None) -> None:
    """The C probe truncates ids to int32; ids outside [0, 2^31) would wrap
    negative and index the occupancy out of bounds (numpy's % degrades
    safely; raw pointers do not). MASKED lanes are exempt: every kernel
    skips them before touching the id (csrc `if (valid && !valid[i])`), and
    the numpy fallbacks accept arbitrary garbage there — error behavior is
    part of the native==fallback invariant (round-3 advisor finding)."""
    if ls_i.size == 0:
        return
    ids = ls_i if valid is None else np.where(valid.astype(bool), ls_i, 0)
    mn, mx = ids.min(), ids.max()
    if mn < 0 or mx >= 2**31:
        raise IndexError(f"lookup ids [{mn}, {mx}] outside int32 range")


def probe_batch(
    occupancy: List[np.ndarray],
    ls_i: np.ndarray,
    table_offsets: np.ndarray,
    aux_bases: np.ndarray,
    ways: int,
    trash_row: int,
    valid: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All-tables probe. ls_i [T, N] int64 C-contiguous; valid [T, N] bool or
    None. Returns (slots [T, N] int32, miss_pos [T, N] int32, miss_counts
    [T] int64): the first miss_counts[t] entries of miss_pos[t] are the valid
    miss positions in batch order."""
    lib = _load()
    assert lib is not None
    t_count, n = ls_i.shape
    ls_i = np.ascontiguousarray(ls_i, dtype=np.int64)
    _check_id_range(ls_i, valid)
    sets = np.ascontiguousarray(
        np.array([o.shape[0] for o in occupancy], dtype=np.int64)
    )
    occ_ptrs = (_PI32 * t_count)(*[_p(o, _PI32) for o in occupancy])
    offs = np.ascontiguousarray(table_offsets, dtype=np.int64)
    auxb = np.ascontiguousarray(aux_bases, dtype=np.int64)
    slots = np.empty((t_count, n), dtype=np.int32)
    miss_pos = np.empty((t_count, n), dtype=np.int32)
    miss_counts = np.empty(t_count, dtype=np.int64)
    vptr = None
    if valid is not None:
        valid = np.ascontiguousarray(valid, dtype=np.uint8)
        vptr = _p(valid, _PU8)
    lib.cdlrm_probe_batch(
        occ_ptrs, _p(sets, _PI64), ways, t_count, _p(ls_i, _PI64), n, vptr,
        _p(offs, _PI64), _p(auxb, _PI64), trash_row,
        _p(slots, _PI32), _p(miss_pos, _PI32), _p(miss_counts, _PI64),
    )
    return slots, miss_pos, miss_counts


def _check_bounds(idx: np.ndarray, n_rows: int) -> None:
    """The C kernels do raw pointer arithmetic; reject out-of-range ids with
    the same IndexError numpy fancy indexing raises (tests rely on it to
    surface malformed streams, tests/test_prefetcher.py)."""
    if idx.size == 0:
        return
    mn, mx = idx.min(), idx.max()
    if mn < 0 or (n_rows > 0 and mx >= n_rows):
        raise IndexError(
            f"index range [{mn}, {mx}] out of bounds for {n_rows} rows"
        )


def probe_batch_wire(
    occupancy: List[np.ndarray],
    ls_i: np.ndarray,
    aux_bases_local: np.ndarray,
    ways: int,
    bits: int,
    wire_bytes_per_table: int,
    valid: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All-tables probe emitting the variable-width bitstream wire format
    directly (train/step.py pack_slots layout). Returns
    (wire [T, wire_bytes_per_table] uint8, miss_pos [T, N] int32,
    miss_counts [T] int64)."""
    lib = _load()
    assert lib is not None
    t_count, n = ls_i.shape
    ls_i = np.ascontiguousarray(ls_i, dtype=np.int64)
    _check_id_range(ls_i, valid)
    sets = np.ascontiguousarray(
        np.array([o.shape[0] for o in occupancy], dtype=np.int64)
    )
    occ_ptrs = (_PI32 * t_count)(*[_p(o, _PI32) for o in occupancy])
    auxb = np.ascontiguousarray(aux_bases_local, dtype=np.int64)
    wire = np.zeros((t_count, wire_bytes_per_table), dtype=np.uint8)
    miss_pos = np.empty((t_count, n), dtype=np.int32)
    miss_counts = np.empty(t_count, dtype=np.int64)
    vptr = None
    if valid is not None:
        valid = np.ascontiguousarray(valid, dtype=np.uint8)
        vptr = _p(valid, _PU8)
    lib.cdlrm_probe_batch_wirebits(
        occ_ptrs, _p(sets, _PI64), ways, t_count, _p(ls_i, _PI64), n, vptr,
        _p(auxb, _PI64), bits, wire_bytes_per_table,
        _p(wire, _PU8), _p(miss_pos, _PI32), _p(miss_counts, _PI64),
    )
    return wire, miss_pos, miss_counts


def probe_batch_dedup(
    occupancy: List[np.ndarray],
    ls_i: np.ndarray,
    aux_bases_local: np.ndarray,
    aux_capacity: int,
    table_offsets: np.ndarray,
    ways: int,
    inv_bits: int,
    inv_bytes_per_table: int,
    rank_scratch: List[np.ndarray],
    valid: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Fused probe + duplicate-slot dedup (csrc cdlrm_probe_batch_dedup).
    Returns (inv_wire [T, inv_bytes] uint8, uniq [T, N] int32 global slots —
    first uniq_counts[t] valid per table, first-seen order —, uniq_counts [T]
    int64, miss_pos [T, N] int32, miss_counts [T] int64).
    rank_scratch: per-table int32 arrays (rows-per-table sized, all -1),
    owned/reused by the caller; the kernel self-cleans them."""
    lib = _load()
    assert lib is not None
    t_count, n = ls_i.shape
    ls_i = np.ascontiguousarray(ls_i, dtype=np.int64)
    _check_id_range(ls_i, valid)
    sets = np.ascontiguousarray(
        np.array([o.shape[0] for o in occupancy], dtype=np.int64)
    )
    occ_ptrs = (_PI32 * t_count)(*[_p(o, _PI32) for o in occupancy])
    scratch_ptrs = (_PI32 * t_count)(*[_p(s, _PI32) for s in rank_scratch])
    auxb = np.ascontiguousarray(aux_bases_local, dtype=np.int64)
    offs = np.ascontiguousarray(table_offsets, dtype=np.int64)
    inv_wire = np.zeros((t_count, inv_bytes_per_table), dtype=np.uint8)
    uniq = np.empty((t_count, n), dtype=np.int32)
    uniq_counts = np.empty(t_count, dtype=np.int64)
    miss_pos = np.empty((t_count, n), dtype=np.int32)
    miss_counts = np.empty(t_count, dtype=np.int64)
    vptr = None
    if valid is not None:
        valid = np.ascontiguousarray(valid, dtype=np.uint8)
        vptr = _p(valid, _PU8)
    lib.cdlrm_probe_batch_dedup(
        occ_ptrs, _p(sets, _PI64), ways, t_count, _p(ls_i, _PI64), n, vptr,
        _p(auxb, _PI64), int(aux_capacity), _p(offs, _PI64), inv_bits,
        inv_bytes_per_table, scratch_ptrs, _p(inv_wire, _PU8), _p(uniq, _PI32),
        _p(uniq_counts, _PI64), _p(miss_pos, _PI32), _p(miss_counts, _PI64),
    )
    return inv_wire, uniq, uniq_counts, miss_pos, miss_counts


def map_probe_batch_dedup(
    map_flat: np.ndarray,
    id_bases: np.ndarray,
    ls_i: np.ndarray,
    table_offsets: np.ndarray,
    aux_bases_local: np.ndarray,
    aux_capacity: int,
    inv_bits: int,
    inv_bytes_per_table: int,
    rank_scratch: List[np.ndarray],
    valid: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Fused direct-map probe + dedup + bit-pack (csrc
    cdlrm_map_probe_batch_dedup): the O(1)-map analogue of
    probe_batch_dedup, bit-identical outputs."""
    lib = _load()
    assert lib is not None
    t_count, n = ls_i.shape
    ls_i = np.ascontiguousarray(ls_i, dtype=np.int64)
    bases = np.ascontiguousarray(id_bases, dtype=np.int64)
    # per-table segment guard, masked lanes exempt (the kernel skips them) —
    # same contract as map_probe_batch_wire. The int32-range check is also
    # masked-exempt: the numpy fallback accepts arbitrary ids in masked
    # padding lanes, and the native==fallback invariant covers error
    # behavior too (round-3 advisor finding).
    ends = np.append(bases[1:], map_flat.shape[0])
    ids_chk = ls_i if valid is None else np.where(valid.astype(bool), ls_i, 0)
    _check_id_range(ids_chk)
    seg_max = ids_chk.max(axis=1) + bases
    if (seg_max >= ends).any():
        t = int(np.argmax(seg_max >= ends))
        raise ValueError(
            f"table {t}: lookup id {int(ids_chk[t].max())} out of range for "
            f"its slot-map segment (size {int(ends[t] - bases[t])})"
        )
    scratch_ptrs = (_PI32 * t_count)(*[_p(s, _PI32) for s in rank_scratch])
    offs = np.ascontiguousarray(table_offsets, dtype=np.int64)
    auxb = np.ascontiguousarray(aux_bases_local, dtype=np.int64)
    inv_wire = np.zeros((t_count, inv_bytes_per_table), dtype=np.uint8)
    uniq = np.empty((t_count, n), dtype=np.int32)
    uniq_counts = np.empty(t_count, dtype=np.int64)
    miss_pos = np.empty((t_count, n), dtype=np.int32)
    miss_counts = np.empty(t_count, dtype=np.int64)
    vptr = None
    if valid is not None:
        valid = np.ascontiguousarray(valid, dtype=np.uint8)
        vptr = _p(valid, _PU8)
    lib.cdlrm_map_probe_batch_dedup(
        _p(map_flat, _PI32), _p(bases, _PI64), t_count, _p(ls_i, _PI64), n,
        vptr, _p(offs, _PI64), _p(auxb, _PI64), int(aux_capacity), inv_bits,
        inv_bytes_per_table, scratch_ptrs, _p(inv_wire, _PU8),
        _p(uniq, _PI32), _p(uniq_counts, _PI64), _p(miss_pos, _PI32),
        _p(miss_counts, _PI64),
    )
    return inv_wire, uniq, uniq_counts, miss_pos, miss_counts


def sort_dedup_wire(
    ranks: np.ndarray, uniq_cat: np.ndarray, uniq_counts: np.ndarray
) -> None:
    """IN-PLACE sorted-wire post-pass (csrc cdlrm_sort_dedup_wire): permute
    each table's first-seen-order unique segment ascending and remap the
    table-local ranks (-1 masked lanes unchanged). Bit-identical to the
    numpy stable-argsort path in host_cache.probe_dedup_raw (slots are
    distinct per table, so the sorted order is unique)."""
    lib = _load()
    assert lib is not None
    t_count, n = ranks.shape
    assert ranks.dtype == np.int32 and ranks.flags.c_contiguous
    assert uniq_cat.dtype == np.int32 and uniq_cat.flags.c_contiguous
    counts = np.ascontiguousarray(uniq_counts, dtype=np.int64)
    lib.cdlrm_sort_dedup_wire(
        _p(ranks, _PI32), _p(uniq_cat, _PI32), _p(counts, _PI64), t_count, n
    )


def map_probe_batch_wire(
    map_flat: np.ndarray,
    id_bases: np.ndarray,
    ls_i: np.ndarray,
    table_offsets: np.ndarray,
    aux_bases_local: np.ndarray,
    bits: int,
    bytes_per_table: int,
    valid: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fused direct-map probe + bit-pack (csrc cdlrm_map_probe_batch_wire).
    Returns (wire [T, bytes] uint8, miss_pos [T, N] int32, miss_counts [T])."""
    lib = _load()
    assert lib is not None
    t_count, n = ls_i.shape
    ls_i = np.ascontiguousarray(ls_i, dtype=np.int64)
    bases = np.ascontiguousarray(id_bases, dtype=np.int64)
    # OOB guard: the C kernel indexes map_flat[base + id] unchecked (the
    # occupancy kernels are intrinsically safe via mod-sets; the map is not).
    # Per-table: each table's ids must stay inside its own map segment.
    # Masked padding lanes are exempt — the kernel skips them without
    # gathering (csrc cdlrm_map_probe_table_wirebits), so they carry no input
    # contract; checking them would reject streams the numpy path accepts.
    # The int32-range check is masked-exempt for the same reason.
    ends = np.append(bases[1:], map_flat.shape[0])
    ids_chk = ls_i if valid is None else np.where(valid.astype(bool), ls_i, 0)
    _check_id_range(ids_chk)
    seg_max = ids_chk.max(axis=1) + bases
    if (seg_max >= ends).any():
        t = int(np.argmax(seg_max >= ends))
        raise ValueError(
            f"table {t}: lookup id {int(ids_chk[t].max())} out of range for "
            f"its slot-map segment (size {int(ends[t] - bases[t])})"
        )
    offs = np.ascontiguousarray(table_offsets, dtype=np.int64)
    auxb = np.ascontiguousarray(aux_bases_local, dtype=np.int64)
    wire = np.zeros((t_count, bytes_per_table), dtype=np.uint8)
    miss_pos = np.empty((t_count, n), dtype=np.int32)
    miss_counts = np.empty(t_count, dtype=np.int64)
    vptr = None
    if valid is not None:
        valid = np.ascontiguousarray(valid, dtype=np.uint8)
        vptr = _p(valid, _PU8)
    lib.cdlrm_map_probe_batch_wire(
        _p(map_flat, _PI32), _p(bases, _PI64), t_count, _p(ls_i, _PI64), n,
        vptr, _p(offs, _PI64), _p(auxb, _PI64), bits, bytes_per_table,
        _p(wire, _PU8), _p(miss_pos, _PI32), _p(miss_counts, _PI64),
    )
    return wire, miss_pos, miss_counts


def pack_bits(vals: np.ndarray, bits: int, out_bytes: int) -> np.ndarray:
    """LSB-first bitstream of ``bits``-wide values; negatives -> sentinel
    (train/step.py pack_slots byte layout, 1-D)."""
    lib = _load()
    assert lib is not None
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    out = np.zeros(out_bytes, dtype=np.uint8)
    lib.cdlrm_pack_bits(_p(vals, _PI64), vals.size, bits, _p(out, _PU8))
    return out


def unique_i64(idx: np.ndarray, n_rows: int = 0) -> np.ndarray:
    """Sorted unique (np.unique drop-in for non-negative int64)."""
    lib = _load()
    assert lib is not None
    idx = np.ascontiguousarray(idx.reshape(-1), dtype=np.int64)
    _check_bounds(idx, n_rows)
    out = np.empty(idx.size, dtype=np.int64)
    m = lib.cdlrm_unique_i64(_p(idx, _PI64), idx.size, int(n_rows), _p(out, _PI64))
    return out[:m].copy()


def gather_f32(table: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Row-parallel table[idx] for float32 C-contiguous 2-D tables."""
    lib = _load()
    assert lib is not None
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    _check_bounds(idx, table.shape[0])
    out = np.empty((idx.size, table.shape[1]), dtype=np.float32)
    lib.cdlrm_gather_f32(
        _p(table, _PF32), table.shape[1], _p(idx, _PI64), idx.size, _p(out, _PF32)
    )
    return out


def writeback_f32(
    table: np.ndarray, idx: np.ndarray, rows: np.ndarray, average: bool
) -> None:
    lib = _load()
    assert lib is not None
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    _check_bounds(idx, table.shape[0])
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    lib.cdlrm_writeback_f32(
        _p(table, _PF32), table.shape[1], _p(idx, _PI64), idx.size,
        _p(rows, _PF32), int(average),
    )


def unique_gather_f32(
    idx: np.ndarray, table: np.ndarray, n_rows: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Fused sorted-unique + row gather (one prefetcher window/table)."""
    lib = _load()
    assert lib is not None
    idx = np.ascontiguousarray(idx.reshape(-1), dtype=np.int64)
    _check_bounds(idx, table.shape[0])
    d = table.shape[1]
    out_idx = np.empty(idx.size, dtype=np.int64)
    out_rows = np.empty((idx.size, d), dtype=np.float32)
    m = lib.cdlrm_unique_gather_f32(
        _p(idx, _PI64), idx.size, int(n_rows or table.shape[0]),
        _p(table, _PF32), d, _p(out_idx, _PI64), _p(out_rows, _PF32),
    )
    return out_idx[:m].copy(), out_rows[:m].copy()


def mask_bits(mask: np.ndarray) -> np.ndarray:
    """Byte mask -> LSB-first uint64 bitmap (csrc cdlrm_mask_bits). Built
    ONCE per run for the static real-row mask; :func:`block_union` then
    ANDs whole words instead of paying a random byte read per marked
    slot."""
    lib = _load()
    assert lib is not None
    mask = np.ascontiguousarray(mask.reshape(-1), dtype=np.uint8)
    bits = np.empty((mask.size + 63) >> 6, dtype=np.uint64)
    lib.cdlrm_mask_bits(_p(mask, _PU8), mask.size, _p(bits, _PU64))
    return bits


def block_union(
    uniq_cat: np.ndarray, real_bits: np.ndarray, n_rows: int,
    rank_map: np.ndarray,
) -> np.ndarray:
    """Block-coalesce phase 1 (trainer._build_block_union): sorted union
    of the block's unique slot lists, real-row-masked (aux/trash excluded;
    ``real_bits`` from :func:`mask_bits` over [n_rows]), with
    ``rank_map[slot] = rank`` set for every union slot. ``rank_map`` must
    be all -1 on entry (int32 [n_rows]); call :func:`block_union_reset`
    with the returned union to restore it. Takes the int32 wire dtype
    directly (no widening copy) with bounds checked in-kernel.
    Bit-identical to the numpy bitmap form (present-mark + AND +
    flatnonzero) — pinned in tests/test_native.py."""
    lib = _load()
    assert lib is not None
    if uniq_cat.dtype != np.int32:
        # a wider dtype must be range-checked BEFORE the narrowing cast:
        # casting e.g. 2**32+5 first would wrap to an in-range 5 and pass
        # the kernel's uint32 bound check silently (the trainer's wire is
        # int32; this guards any future caller)
        _check_bounds(uniq_cat.reshape(-1), n_rows)
    uniq_cat = np.ascontiguousarray(uniq_cat.reshape(-1), dtype=np.int32)
    assert real_bits.dtype == np.uint64 and real_bits.size >= (n_rows + 63) >> 6
    assert rank_map.dtype == np.int32 and rank_map.size == n_rows
    out = np.empty(uniq_cat.size, dtype=np.int32)
    m = lib.cdlrm_block_union(
        _p(uniq_cat, _PI32), uniq_cat.size, _p(real_bits, _PU64), n_rows,
        _p(rank_map, _PI32), _p(out, _PI32),
    )
    if m == -1:  # allocation failure: caller falls back to numpy
        raise MemoryError("cdlrm_block_union bitmap allocation failed")
    if m == -2:
        raise ValueError("block_union: slot out of [0, n_rows)")
    return out[:m]


def block_ranks(
    uniq_cat: np.ndarray, step_off: np.ndarray, rank_map: np.ndarray,
    p_trash: int, ub: int, base: int, out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Block-coalesce phase 2: per-step rank rows [n_steps, ub] aligned
    with the staged uniq wire (position base+j of step s = the block rank
    of that step's j-th unique slot; aux/trash and padding = p_trash).
    ``out`` (optional) is written IN PLACE: any int32 [n_steps, ub] view
    whose inner dim is contiguous — the trainer hands a [:, k, :] slice of
    its [n_steps, n_local, ub] staging array, skipping the copy the
    fresh-array form pays."""
    lib = _load()
    assert lib is not None
    if uniq_cat.dtype != np.int32:
        # see block_union: range-check wider dtypes before narrowing
        _check_bounds(uniq_cat.reshape(-1), rank_map.size)
    uniq_cat = np.ascontiguousarray(uniq_cat.reshape(-1), dtype=np.int32)
    step_off = np.ascontiguousarray(step_off, dtype=np.int64)
    n_steps = step_off.size - 1
    if out is None:
        out = np.empty((n_steps, ub), dtype=np.int32)
    assert out.dtype == np.int32 and out.shape == (n_steps, ub)
    assert out.strides[1] == 4, "inner dim must be contiguous"
    rc = lib.cdlrm_block_ranks(
        _p(uniq_cat, _PI32), _p(step_off, _PI64), n_steps,
        _p(rank_map, _PI32), rank_map.size, int(p_trash), int(ub),
        int(base), out.strides[0] // 4,
        ctypes.cast(out.ctypes.data, _PI32),
    )
    if rc == -1:
        # same failure class as the numpy fallback's shape-mismatch
        # assignment — never write out of the row (heap) bounds silently
        raise ValueError(
            f"block_ranks: a step's unique list exceeds ub-base "
            f"({ub}-{base})"
        )
    if rc == -2:
        raise ValueError("block_ranks: slot out of [0, n_rows)")
    return out


def block_union_reset(union_slots: np.ndarray, rank_map: np.ndarray) -> None:
    """Restore ``rank_map`` to all -1 (touches only the union's entries)."""
    lib = _load()
    assert lib is not None
    union_slots = np.ascontiguousarray(union_slots, dtype=np.int32)
    lib.cdlrm_block_union_reset(
        _p(union_slots, _PI32), union_slots.size, _p(rank_map, _PI32)
    )
