"""Compact host-to-device transport dtype for dense count blocks.

Counterpart of ``memento_tpu/ops/transport.py``.  A dense block of UMI
counts travels as the smallest integer dtype that holds every value exactly;
the device casts it back to float32, so the result equals shipping floats
while 2-4x fewer bytes cross the bus.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sparse

# float32 holds integers exactly only up to 2**24
_F32_EXACT_MAX = float(1 << 24)


def compact_transport_dtype(X) -> Optional[np.dtype]:
    """Smallest exact transport dtype for the dense blocks of sparse ``X``
    (int8, int16 or float32), or None where compact transport is unsafe:
    negative or non-integral values, values above 2**24, or a dense input
    (probing it would materialize full-size temporaries; dense callers ship
    their own dtype)."""
    if not sparse.issparse(X):
        return None
    vals = X.data
    if vals.size == 0:
        return np.dtype(np.int8)
    vmin = float(vals.min())
    vmax = float(vals.max())
    if vmin < 0 or vmax > _F32_EXACT_MAX:
        return None
    if not bool(np.all(np.mod(vals, 1) == 0)):
        return None
    if vmax <= 127:
        return np.dtype(np.int8)
    if vmax <= 32767:
        return np.dtype(np.int16)
    return np.dtype(np.float32)


__all__ = ["compact_transport_dtype"]
