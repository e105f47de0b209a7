"""Training flash attention under the multi-agent causal mask (kernels K3
and K4).

Port of ``ctrl_sim_tpu/ops/flash_attention.py``, whose TPU kernels are
``_fwd_call`` -> ``pl.pallas_call(_fwd_kernel)`` (K3) and ``_bwd_call`` ->
``pl.pallas_call(_bwd_kernel)`` (K4): multi-head attention of the full
training sequence (T = steps x agents x token types) with the visibility
predicate of ``ops/masks.py`` evaluated from token indices, never stored,
and attention dropout keyed by position through a murmur3 hash, so any
tiling gives the same keep mask. On a CUDA tensor
the wrappers launch the hand-written Hopper kernels of
``csrc/flash_attention.cu`` (built by nvcc, bound with ctypes) or raise:
``flash_mha_fwd`` the forward K3, ``flash_mha_bwd`` the backward K4 (two
kernels, no atomics), and ``flash_mha`` joins them in a
``torch.autograd.Function``. On a CPU tensor they run the plain PyTorch
version ``flash_mha_reference``, which the CPU tests hold against the JAX
kernel and ``chip_smoke.py`` holds the CUDA kernels against on the card.

bf16 runs on Hopper's tensor cores (``wgmma`` m64nNk16, fp32 accumulators),
fed by TMA loads of 64-row tiles through a 3-stage ring, with a producer
and a consumer warpgroup a block (in the forward the producers also hash
the keep bits and build the partial tiles' mask words); f32 keeps CUDA-core
kernels, which hold the 1e-4 agreement that TF32 could not. The bf16
kernels walk the schedule of ``tile_table``: for each 64-row tile, the
tiles of the other side with a visible pair, of which the fully visible
run skips the mask predicate; heaviest tiles first. What bounds them on an
H100 is not the tensor-core rate (0.044 ms forward, 0.109 ms backward at
the train step's shape) but per-element work on the CUDA cores: an exp per
admitted element and pass (K3 one pass, K4 two), and with dropout the
murmur3 keep bit, which only the forward hashes: with dropout on and a
gradient wanted it writes the bits packed (``pack_keep_bits``'s layout)
and the backward reads them; ``csrc/flash_attention.cu`` has the numbers.

Semantics kept from the TPU kernels: scores s * q.k in fp32 with s =
1/sqrt(d), -1e30 on masked scores (keys past T take no weight),
``lse = m + log(l)`` per row from the softmax before dropout, dropout after
normalization (``keep ? p / (1 - p_drop) : 0``), dq in q's type and dk/dv
accumulated in fp32 and returned in k's type. The keep bit is
bit-identical to the JAX ``_dropout_keep``. Like the JAX kernels, these
take any head width d that divides D: on the card a head narrower than an
instantiated width (``ops/heads.py``) is zero-padded to it, the kernels
scale by the true d, and the padded output and gradient columns are
dropped; a head wider than 64 raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ctrl_sim_tpu_torch.ops import build
from ctrl_sim_tpu_torch.ops.heads import head_dim, kernel_head_dim, pad_heads, unpad_heads
from ctrl_sim_tpu_torch.ops.masks import token_coords, visible

Tensor = torch.Tensor

_NEG = -1e30  # large-negative instead of -inf: keeps padded rows NaN-free
_U32 = 0xFFFFFFFF
TILE = 64  # query and key rows per tile of the bf16 tensor-core kernels


class MaskSpec(NamedTuple):
    """The multi-agent causal mask, described by its layout. Token index
    j = t*(A*K) + a*K + k."""

    num_agents: int
    num_types: int
    state_index: int
    attend_own_return_action: bool
    window: int | None


def block_mask(rows: Tensor, cols: Tensor, seq_len: int, spec: MaskSpec) -> Tensor:
    """Visibility of key indices ``cols`` from query indices ``rows``
    (broadcast), plus bounds masking of rows and cols past ``seq_len``."""
    ti, ai, _ = token_coords(rows, spec.num_agents, spec.num_types)
    tj, aj, kj = token_coords(cols, spec.num_agents, spec.num_types)
    vis = visible(
        ti=ti, ai=ai, ii=rows, tj=tj, aj=aj, kj=kj, jj=cols,
        state_index=spec.state_index,
        attend_own_return_action=spec.attend_own_return_action,
        window=spec.window,
    )
    return vis & (rows < seq_len) & (cols < seq_len)


def _tile_ranges(any_: Tensor, all_: Tensor) -> list[tuple[int, int, int, int, int]]:
    """Per tile of rows: (tile, begin, full_begin, full_end, end) over the
    tiles of columns. [begin, end) covers every column tile with a visible
    pair; [full_begin, full_end) is the first run of fully visible tiles in
    it (empty if there is none); the rest of [begin, end) is partial."""
    out = []
    for r in range(any_.shape[0]):
        hit = torch.nonzero(any_[r]).flatten().tolist()
        begin, end = (hit[0], hit[-1] + 1) if hit else (0, 0)
        full_begin = full_end = next((c for c in range(begin, end) if all_[r, c]), begin)
        while full_end < end and all_[r, full_end]:
            full_end += 1
        out.append((r, begin, full_begin, full_end, end))
    return out


def tile_table(spec: MaskSpec, seq_len: int, tile: int = TILE) -> Tensor:
    """The tile schedule of the bf16 tensor-core kernels, int32 [2, n, 5]
    with n = ceil(seq_len / tile): row 0 walks the key tiles of each query
    tile (the forward and the dq kernel), row 1 the query tiles of each key
    tile (the dk/dv kernel). Each entry is (tile, begin, full_begin,
    full_end, end) as ``_tile_ranges`` gives it, and the entries run
    heaviest first (most tiles to walk), so the longest blocks start first.
    Computed from ``block_mask`` on the CPU; only partial tiles evaluate
    the mask in the kernels."""
    n = -(-seq_len // tile)
    idx = torch.arange(n * tile)
    blocks = block_mask(idx[:, None], idx[None, :], seq_len, spec).reshape(n, tile, n, tile)
    any_, all_ = blocks.any(dim=3).any(dim=1), blocks.all(dim=3).all(dim=1)
    sides = [sorted(_tile_ranges(a, f), key=lambda e: e[1] - e[4])  # stable: heaviest first
             for a, f in ((any_, all_), (any_.T, all_.T))]
    return torch.tensor(sides, dtype=torch.int32)


def walked_keep_words(spec: MaskSpec, seq_len: int, tile: int = TILE) -> Tensor:
    """Boolean [T, ceil(T / 32)]: the packed keep words that the bf16
    forward kernel writes and both backward kernels read, those of the
    (query tile, key tile) pairs that ``tile_table`` walks; every visible
    pair's bit lies in one of them."""
    words, per = -(-seq_len // 32), tile // 32
    out = torch.zeros((seq_len, words), dtype=torch.bool)
    for t, begin, _, _, end in tile_table(spec, seq_len, tile)[0].tolist():
        out[t * tile:(t + 1) * tile, begin * per:min(end * per, words)] = True
    return out


@functools.lru_cache(maxsize=64)
def _device_tile_table(spec: MaskSpec, seq_len: int, device: torch.device) -> Tensor:
    return tile_table(spec, seq_len).to(device)


def keep_threshold(keep_prob: float) -> int:
    """The uint32 threshold under which a hash keeps its position."""
    return min(int(keep_prob * 2**32), 2**32 - 1)


def _mul32(x: Tensor, c: int) -> Tensor:
    """The low 32 bits of x * c for 0 <= x < 2^32, in int64 without
    overflow: the 16-bit halves of c each give a product below 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def pack_keep_bits(keep: Tensor) -> Tensor:
    """Boolean keep masks [..., T] (the last axis the keys) packed into
    uint32 words [..., ceil(T / 32)]: bit j % 32 of word j / 32 is key j,
    the layout in which the bf16 forward kernel saves its keep bits."""
    T = keep.shape[-1]
    words = -(-T // 32)
    bits = torch.nn.functional.pad(keep.to(torch.int64), (0, 32 * words - T))
    bits = bits.reshape(*keep.shape[:-1], words, 32) << torch.arange(32, device=keep.device)
    return bits.sum(dim=-1).to(torch.uint32)


def unpack_keep_bits(words: Tensor, seq_len: int) -> Tensor:
    """The inverse of ``pack_keep_bits``: boolean [..., seq_len]."""
    bits = (words.to(torch.int64)[..., None] >> torch.arange(32, device=words.device)) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :seq_len].bool()


def dropout_keep_reference(seed, b, h, rows: Tensor, cols: Tensor, keep_prob: float) -> Tensor:
    """The keep mask of the TPU kernels' ``_dropout_keep``: the murmur3
    finalizer over (seed, batch, head, row, col) in uint32 arithmetic,
    emulated in int64 with every product and xor cut to its low 32 bits.
    ``seed``, ``b`` and ``h`` are ints or int64 tensors that broadcast with
    ``rows`` and ``cols``; returns the boolean keep mask."""
    dev = rows.device
    as64 = lambda x: torch.as_tensor(x, dtype=torch.int64, device=dev) & _U32  # noqa: E731
    x = _mul32(as64(rows), 0x9E3779B1) ^ _mul32(as64(cols), 0x85EBCA77)
    x = x ^ _mul32(as64(b), 0xC2B2AE3D) ^ _mul32(as64(h), 0x27D4EB2F) ^ as64(seed)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x < keep_threshold(keep_prob)


def flash_mha_reference(
    q: Tensor,  # [B, T, D] post-projection, heads packed in D
    k: Tensor,
    v: Tensor,
    spec: MaskSpec,
    num_heads: int,
    dropout_p: float = 0.0,
    seed=None,  # int or int64 tensor [1]; only read when dropout_p > 0
    batch_offset: int = 0,  # added to the batch index in the dropout hash
    keep: Tensor | None = None,  # packed keep bits [B, heads, T, ceil(T / 32)] to use instead of the hash
) -> tuple[Tensor, Tensor]:
    """The plain PyTorch version of kernels K3/K4: dense masked attention in
    fp32 einsums. Returns (out [B, T, D] in q's dtype, lse [B, heads, T]
    fp32); differentiable by autograd, which gives K4's gradients. Row b's
    dropout mask is that of batch index ``batch_offset + b``: a rank
    holding rows [o, o + B) of a global batch passes o, and its masks are
    those of the single-process launch. With ``keep`` (the forward's saved
    bits, ``dropout_keep_bits``) the mask is read from it and not hashed."""
    B, T, D = q.shape
    d = D // num_heads
    idx = torch.arange(T, device=q.device)
    mask = block_mask(idx[:, None], idx[None, :], T, spec)  # [T, T]
    qh, kh, vh = (x.float().reshape(B, T, num_heads, d) for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * (1.0 / math.sqrt(d))
    s = torch.where(mask, s, _NEG)
    m = s.detach().amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(l))[..., 0]
    p = e / l
    if dropout_p > 0.0:
        if keep is None:
            kept = dropout_keep_mask(seed, batch_offset, B, num_heads, T, 1.0 - dropout_p, q.device)
        else:
            kept = unpack_keep_bits(keep, T)
        p = torch.where(kept, p / (1.0 - dropout_p), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vh)
    return out.reshape(B, T, D).to(q.dtype), lse


def dropout_keep_mask(seed, batch_offset: int, B: int, num_heads: int, T: int, keep_prob: float,
                      device) -> Tensor:
    """The boolean keep mask [B, heads, T, T] of a launch of B rows whose
    first row is ``batch_offset`` of the global batch (the hash's batch
    index)."""
    seed = 0 if seed is None else seed
    idx = torch.arange(T, device=device)
    heads = torch.arange(num_heads, device=device)[:, None, None]
    return torch.stack([dropout_keep_reference(seed, batch_offset + b, heads, idx[:, None], idx[None, :], keep_prob)
                        for b in range(B)])


def dropout_keep_bits(seed, batch_offset: int, B: int, num_heads: int, T: int, keep_prob: float,
                      device) -> Tensor:
    """``dropout_keep_mask`` packed as the forward saves it: uint32
    [B, heads, T, ceil(T / 32)], one row at a time."""
    return torch.stack([pack_keep_bits(dropout_keep_mask(seed, batch_offset + b, 1, num_heads, T, keep_prob,
                                                         device)[0]) for b in range(B)])


def _check(q: Tensor, k: Tensor, v: Tensor, num_heads: int) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"expected q, k, v [B, T, D] of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    head_dim(q.shape[-1], num_heads)
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"q, k and v lie on different devices: {devices}")


def _seed_tensor(seed, device: torch.device) -> Tensor:
    """The dropout seed as one int64 on ``device`` (low 32 bits used)."""
    if seed is None:
        return torch.zeros(1, dtype=torch.int64, device=device)
    t = torch.as_tensor(seed, dtype=torch.int64, device=device).reshape(-1)
    if t.numel() != 1:
        raise ValueError("seed must hold one value")
    return t


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = build.load("flash_attention.cu")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # B, T, H, heads, head_dim, A, K, state_index, own, has_window, window, batch offset
    shape = [i32] * 12
    # dropout_p, threshold, is_bf16, stream
    tail = [ctypes.c_float, ctypes.c_uint, i32, ptr]
    fwd = lib.ctrl_sim_flash_fwd
    fwd.restype = i32
    fwd.argtypes = [ptr] * 8 + shape + tail  # q, k, v, seed, table, out, lse, keep
    bwd = lib.ctrl_sim_flash_bwd
    bwd.restype = i32
    bwd.argtypes = [ptr] * 13 + shape + tail  # q, k, v, o, do, lse, seed, table, keep, dq, dk, dv, delta
    return fwd, bwd


def _launch_args(q: Tensor, spec: MaskSpec, num_heads: int, d: int, dropout_p: float, batch_offset: int) -> list:
    """The kernels' scalar arguments for the head-padded q [B, T, D] whose
    heads hold d true columns each."""
    B, T, D = q.shape
    window = spec.window
    return [
        B, T, D, num_heads, d, spec.num_agents, spec.num_types, spec.state_index,
        int(spec.attend_own_return_action), int(window is not None), int(window or 0), int(batch_offset),
        float(dropout_p), keep_threshold(1.0 - dropout_p), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    ]


def _table_ptr(q: Tensor, spec: MaskSpec):
    """The tile schedule of the bf16 kernels on q's card (None for f32,
    whose kernels find their ranges themselves)."""
    if q.dtype != torch.bfloat16:
        return None
    return _device_tile_table(spec, q.shape[1], q.device).data_ptr()


def _require_cuda(*tensors: Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"no flash attention kernel for device {t.device}")
        if not t.is_contiguous():
            raise ValueError("flash attention kernels take contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("flash attention kernels load 16 bytes at a time: align tensors to 16 bytes")


def flash_mha_fwd(
    q: Tensor, k: Tensor, v: Tensor, spec: MaskSpec, num_heads: int,
    dropout_p: float = 0.0, seed=None, batch_offset: int = 0, keep_bits: bool = False,
) -> tuple[Tensor, Tensor, Tensor | None]:
    """Kernel K3: (out [B, T, D], lse [B, heads, T] fp32, keep). CUDA
    tensors go through the hand-written kernel (every launch adds one to
    ``flash_mha_fwd.launches``); CPU tensors through the plain version.
    ``batch_offset`` is added to the batch index in the dropout hash. With
    ``keep_bits`` and dropout on, ``keep`` holds the keep bits packed as
    ``pack_keep_bits`` lays them out, uint32 [B, heads, T, ceil(T / 32)],
    for ``flash_mha_bwd``: the bf16 kernel writes the words of the tile
    pairs it walks (the others are left unwritten, and no backward reads
    them), the plain version every word. Else, and for the f32 kernel,
    whose backward hashes again, ``keep`` is None."""
    _check(q, k, v, num_heads)
    save = keep_bits and dropout_p > 0.0
    if q.device.type == "cpu":
        out, lse = flash_mha_reference(q, k, v, spec, num_heads, dropout_p, seed, batch_offset)
        B, T, _ = q.shape
        keep = dropout_keep_bits(seed, batch_offset, B, num_heads, T, 1.0 - dropout_p, q.device) if save else None
        return out, lse, keep
    _require_cuda(q, k, v)
    seed_t = _seed_tensor(seed, q.device)
    B, T, D = q.shape
    d = D // num_heads
    width = kernel_head_dim(d)
    q, k, v = (pad_heads(x, num_heads, width) for x in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((B, num_heads, T), dtype=torch.float32, device=q.device)
    keep = None
    if save and q.dtype == torch.bfloat16:
        keep = torch.empty((B, num_heads, T, -(-T // 32)), dtype=torch.uint32, device=q.device)
    fwd, _ = _kernels()
    with torch.cuda.device(q.device):
        err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), seed_t.data_ptr(), _table_ptr(q, spec),
                  out.data_ptr(), lse.data_ptr(), None if keep is None else keep.data_ptr(),
                  *_launch_args(q, spec, num_heads, d, dropout_p, batch_offset))
    if err != 0:
        raise RuntimeError(f"flash attention forward kernel launch failed: cudaError_t {err}")
    flash_mha_fwd.launches += 1
    return unpad_heads(out, num_heads, d), lse, keep


flash_mha_fwd.launches = 0


def _check_keep(keep: Tensor | None, q: Tensor, num_heads: int, dropout_p: float) -> None:
    """The bf16 backward kernels read the forward's keep bits when dropout
    is on; the f32 ones hash and take none."""
    if dropout_p <= 0.0:
        return
    if q.dtype != torch.bfloat16:
        if keep is not None:
            raise ValueError("the f32 backward kernels hash the keep bits themselves: pass keep=None")
        return
    B, T, _ = q.shape
    shape = (B, num_heads, T, -(-T // 32))
    if keep is None:
        raise ValueError("the bf16 backward kernels read the forward's keep bits: pass the keep that "
                         "flash_mha_fwd(..., keep_bits=True) returned")
    if keep.dtype != torch.uint32 or tuple(keep.shape) != shape or keep.device != q.device:
        raise ValueError(f"keep must be uint32 {shape} on {q.device}, got {keep.dtype} {tuple(keep.shape)} "
                         f"on {keep.device}")
    _require_cuda(keep)


def flash_mha_bwd(
    q: Tensor, k: Tensor, v: Tensor, out: Tensor, dout: Tensor, lse: Tensor,
    spec: MaskSpec, num_heads: int, dropout_p: float = 0.0, seed=None, batch_offset: int = 0,
    keep: Tensor | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """Kernel K4: (dq, dk, dv) of ``out = flash_mha(q, k, v)`` for the
    output gradient ``dout``, recomputing the weights from ``lse``. CUDA
    tensors go through the hand-written kernels (every launch of the pair
    adds one to ``flash_mha_bwd.launches``); in bf16 with dropout on they
    read the keep bits ``keep`` that ``flash_mha_fwd(..., keep_bits=True)``
    saved and hash nothing. CPU tensors go through autograd of the plain
    version, which reads ``keep`` if given and hashes otherwise."""
    _check(q, k, v, num_heads)
    if q.device.type == "cpu":
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            o, _ = flash_mha_reference(*leaves, spec, num_heads, dropout_p, seed, batch_offset, keep)
            return torch.autograd.grad(o, leaves, dout.to(o.dtype))
    _require_cuda(q, k, v, out, dout, lse)
    if dout.dtype != q.dtype or out.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError("out and dout must have q's dtype, lse float32")
    _check_keep(keep, q, num_heads, dropout_p)
    seed_t = _seed_tensor(seed, q.device)
    B, T, D = q.shape
    d = D // num_heads
    width = kernel_head_dim(d)
    q, k, v, out, dout = (pad_heads(x, num_heads, width) for x in (q, k, v, out, dout))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, num_heads, T), dtype=torch.float32, device=q.device)
    keep_ptr = keep.data_ptr() if keep is not None and dropout_p > 0.0 else None
    _, bwd = _kernels()
    with torch.cuda.device(q.device):
        err = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                  lse.data_ptr(), seed_t.data_ptr(), _table_ptr(q, spec), keep_ptr, dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), delta.data_ptr(), *_launch_args(q, spec, num_heads, d, dropout_p, batch_offset))
    if err != 0:
        raise RuntimeError(f"flash attention backward kernel launch failed: cudaError_t {err}")
    flash_mha_bwd.launches += 1
    return tuple(unpad_heads(x, num_heads, d) for x in (dq, dk, dv))


flash_mha_bwd.launches = 0


class _FlashMHA(torch.autograd.Function):
    """K3 forward, K4 backward (the JAX custom VJP). With dropout on, the
    forward saves its keep bits for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, seed, spec, num_heads, dropout_p, batch_offset, keep_bits):
        out, lse, keep = flash_mha_fwd(q, k, v, spec, num_heads, dropout_p, seed, batch_offset, keep_bits)
        ctx.save_for_backward(q, k, v, out, lse, seed, keep)
        ctx.args = (spec, num_heads, dropout_p, batch_offset)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse, seed, keep = ctx.saved_tensors
        spec, num_heads, dropout_p, batch_offset = ctx.args
        grad = grad.to(q.dtype).contiguous()
        if grad.data_ptr() % 16:  # a view at an odd offset: the kernels load 16 bytes at a time
            grad = grad.clone()
        dq, dk, dv = flash_mha_bwd(q, k, v, out, grad, lse, spec, num_heads, dropout_p, seed, batch_offset, keep)
        return dq, dk, dv, None, None, None, None, None, None


def flash_mha(
    q: Tensor,  # [B, T, D] post-projection, heads packed in D
    k: Tensor,
    v: Tensor,
    spec: MaskSpec,
    num_heads: int,
    dropout_p: float = 0.0,
    seed=None,  # int or int64 tensor [1]; the same seed gives the same keep mask
    batch_offset: int = 0,  # added to the batch index in the dropout hash
) -> Tensor:
    """Multi-head attention under the multi-agent causal mask, O(T) memory
    on the card, plus in bf16 with dropout on and a gradient wanted the
    saved keep bits (T^2 / 8 bytes a row and head). Differentiable: the
    forward is K3 and the backward K4 on CUDA tensors; on CPU tensors both
    are the plain version."""
    _check(q, k, v, num_heads)
    if q.device.type == "cpu":
        return flash_mha_reference(q, k, v, spec, num_heads, dropout_p, seed, batch_offset)[0]
    # the keep bits are written and kept only for a backward to come
    keep_bits = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    return _FlashMHA.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), _seed_tensor(seed, q.device), spec, num_heads,
        float(dropout_p), int(batch_offset), keep_bits,
    )
