"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: they skip without a CUDA device (here, and in any CPU run),
and run on the card with

    python -m pytest tests/test_torch_kernels.py -m cuda -q

This file imports nothing of JAX, so it also runs where JAX is absent.
"""

import pytest
import torch

from ctrl_sim_tpu_torch.ops import attention
from ctrl_sim_tpu_torch.ops.masks import stream_step_masks

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize(
    "B,Q,N,H,heads",
    [(8, 32, 1536, 256, 8), (8, 16, 1536, 256, 8), (4, 12, 384, 64, 4), (3, 40, 100, 128, 2), (2, 5, 33, 64, 4)],
)
def test_decode_attention_kernel_matches_plain(cuda, dtype, atol, B, Q, N, H, heads):
    gen = torch.Generator(device=cuda).manual_seed(B * Q + N)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(dtype) for s in ((B, Q, H), (B, N, H), (B, N, H)))
    mask = torch.rand((Q, N), generator=gen, device=cuda) > 0.4
    mask[:, 0] = True
    mask[: min(3, Q) - 1] = False  # fully masked rows stay finite
    before = attention.cached_decode_attention.launches
    got = attention.cached_decode_attention(q, k, v, mask, heads)
    assert attention.cached_decode_attention.launches == before + 1
    want = attention.cached_decode_attention_reference(q, k, v, mask, heads)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    rows = mask.any(dim=1)
    torch.testing.assert_close(got.float()[:, rows], want.float()[:, rows], atol=atol, rtol=0)


def test_decode_attention_kernel_on_rollout_masks(cuda):
    m1, m2 = stream_step_masks(40, 32, 16, 3, 0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    k, v = (torch.randn((4, 1536, 256), generator=gen, device=cuda).bfloat16() for _ in range(2))
    for t in (0, 1, 31, 32, 39):
        for mask in (m1[t], m2[t]):
            q = torch.randn((4, mask.shape[0], 256), generator=gen, device=cuda).bfloat16()
            got = attention.cached_decode_attention(q, k, v, mask, 8).float()
            want = attention.cached_decode_attention_reference(q, k, v, mask, 8).float()
            rows = (mask != 0).any(dim=1)
            assert torch.isfinite(got).all()
            torch.testing.assert_close(got[:, rows], want[:, rows], atol=2e-2, rtol=0)


def test_decode_attention_kernel_rejects_non_contiguous_or_misaligned(cuda):
    q = torch.randn((2, 8, 64), device=cuda)
    k = torch.randn((2, 64, 48), device=cuda).transpose(1, 2)
    mask = torch.ones((8, 48), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        attention.cached_decode_attention(q, k, k, mask, 4)
    flat = torch.randn(2 * 48 * 64 + 1, device=cuda)
    k = flat[1:].view(2, 48, 64)  # contiguous, 4 bytes off alignment
    with pytest.raises(ValueError):
        attention.cached_decode_attention(q, k, k, mask, 4)
