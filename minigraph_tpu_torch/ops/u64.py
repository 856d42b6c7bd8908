"""Unsigned 64-bit records in int64 tensors.

The v1 map step (ops/sketch_v2.py, ops/pipeline.py DeviceIndex and
collect_anchors_device) keeps the JAX package's u64 records whole:
minimizers hash<<8|span, which reach bit 63 at k = 28, anchors
occ<<56|..., and U64MAX as padding.  torch has no uint64 arithmetic, so
a record is held as its bit pattern in an int64 tensor (numpy's
`.view(np.int64)`), and three habits keep it exact:

* order: a sort, a min or a search runs on `skey(x) = x ^ (1 << 63)`,
  which maps the unsigned order onto the signed one (U64MAX, -1 as an
  int64, becomes the largest key and sorts last, as in the JAX sorts);
* right shifts are logical: `srl` masks off the copied sign bits;
* left shifts and ors wrap as the JAX uint64 ones do (two's complement).
"""
from __future__ import annotations

import numpy as np
import torch

SIGN = -(1 << 63)
U64MAX = -1          # 0xFFFFFFFFFFFFFFFF as an int64
INT64_MAX = (1 << 63) - 1


def from_numpy(a, device) -> torch.Tensor:
    """numpy uint64 array -> int64 tensor of the same bits on device."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint64))
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 array of the same bits."""
    return t.detach().cpu().numpy().astype(np.int64).view(np.uint64)


def srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of u64 bit patterns by 0 < n < 64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def skey(x: torch.Tensor) -> torch.Tensor:
    """Sort key: signed order of skey(x) == unsigned order of x."""
    return x ^ SIGN
