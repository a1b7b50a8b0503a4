"""Static-shape padding helpers (DESIGN.md D6).

Variable-size host buffers (insert/evict plans) are bucketed to powers of two
before entering jit so the number of distinct compiled shapes stays
logarithmic in the maximum size.
"""

from __future__ import annotations

import numpy as np


def pow2_bucket(n: int, min_size: int = 8, factor: int = 2) -> int:
    """Next power-of-``factor`` bucket >= n. factor=2 bounds padding waste
    at 2x (the padded refill rows are the dominant refill H2D bytes) while
    keeping the number of distinct compiled shapes logarithmic — each new
    shape is a full XLA compile."""
    if n <= min_size:
        return min_size
    b = min_size
    while b < n:
        b *= factor
    return b


def pad_to_bucket(a: np.ndarray, fill, min_size: int = 8) -> np.ndarray:
    """Pad axis 0 up to the next power-of-two bucket with ``fill``."""
    n = pow2_bucket(a.shape[0], min_size)
    pad = n - a.shape[0]
    if pad == 0:
        return a
    if a.ndim == 1:
        return np.concatenate([a, np.full(pad, fill, a.dtype)])
    pad_block = np.full((pad,) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad_block])
