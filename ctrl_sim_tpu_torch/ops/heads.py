"""Head widths of the attention kernels: every kernel is instantiated for a
few head widths d = H / heads, and a head of another width goes through the
next wider instance, zero-padded.

Zero columns add nothing to q.k, so the scores, the softmax and the lse are
those of the true width; the padded output and gradient columns are zero
and are sliced off. The softmax scale stays that of the true width: the
decode wrappers pre-scale q before padding, and the flash kernels take the
true width as an argument. The JAX kernels take any d that divides H.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

KERNEL_HEAD_DIMS = (16, 32, 64)  # head widths the CUDA kernels are instantiated for


def head_dim(width: int, num_heads: int) -> int:
    """d = width / num_heads; raises unless num_heads divides width."""
    if num_heads <= 0 or width % num_heads:
        raise ValueError(f"{num_heads} heads do not divide the width {width}")
    return width // num_heads


def kernel_head_dim(d: int) -> int:
    """The narrowest instantiated head width that holds a head of width d;
    raises above the widest."""
    for w in KERNEL_HEAD_DIMS:
        if d <= w:
            return w
    raise ValueError(f"head width {d} is above the widest kernel instance, {KERNEL_HEAD_DIMS[-1]}")


def pad_heads(x: Tensor, num_heads: int, width: int) -> Tensor:
    """[..., heads * d] -> [..., heads * width], each head zero-padded to
    ``width``; x itself (no copy) when d == width."""
    d = x.shape[-1] // num_heads
    if d == width:
        return x
    lead = x.shape[:-1]
    return F.pad(x.reshape(*lead, num_heads, d), (0, width - d)).reshape(*lead, num_heads * width)


def unpad_heads(x: Tensor, num_heads: int, d: int) -> Tensor:
    """The inverse of ``pad_heads``: the first d columns of every head."""
    width = x.shape[-1] // num_heads
    if d == width:
        return x
    lead = x.shape[:-1]
    return x.reshape(*lead, num_heads, width)[..., :d].reshape(*lead, num_heads * d)
