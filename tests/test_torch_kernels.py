"""The port's CUDA kernels against their plain PyTorch versions on the card:
K1 (decode attention), K2 (decode attention over the int8 cache) and K3/K4
(training flash attention), each in bf16 (tensor cores) and f32 (CUDA
cores), at the shapes and under the masks of every model family's decode
passes and training layout; and the env step with contacts on, which must
never wait on a value from the card.

Marked ``cuda``: they skip without a CUDA device (here, and in any CPU run),
and run on the card with

    python -m pytest tests/test_torch_kernels.py -m cuda -q

This file imports nothing of JAX, so it also runs where JAX is absent.
"""

import pytest
import torch

from ctrl_sim_tpu_torch.config import load_config, preset
from ctrl_sim_tpu_torch.data import stack_scenarios, synthetic_scenario, to_torch
from ctrl_sim_tpu_torch.env.env import WaymoEnv
from ctrl_sim_tpu_torch.ops import attention, flash_attention
from ctrl_sim_tpu_torch.ops.masks import stream_step_masks
from ctrl_sim_tpu_torch.rollout.setup import decode_masks

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
    [(8, 32, 1536, 256, 8), (8, 16, 1536, 256, 8), (4, 12, 384, 64, 4), (3, 40, 100, 128, 2), (2, 5, 33, 64, 4),
     # three m16 row tiles; N dividing neither the 32-key chunk nor the 4-warp split; an odd N
     (3, 48, 1536, 256, 8), (2, 20, 1000, 128, 4), (2, 33, 1000, 256, 4), (2, 7, 999, 64, 2),
     # the families' caches: IL (N = 1024) and trajeglish (N = 512); DT's 48 rows over 1536 keys
     (4, 32, 1024, 256, 8), (4, 32, 512, 256, 8), (4, 48, 1536, 256, 8),
     # head widths 8 and 48, with no kernel instance: each head zero-padded to 16 and 64
     (4, 12, 384, 32, 4), (4, 32, 384, 192, 4),
     # 64 rows in one tile, and 65 (a second tile of one row); fewer keys than a 64-key chunk
     (3, 64, 1536, 256, 8), (2, 65, 700, 256, 8), (3, 48, 40, 256, 8), (2, 20, 17, 64, 4)],
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


def _q8_inputs(gen, cuda, B, Q, N, H, dtype):
    """q and an int8 cache quantized from unit normals, K1's inputs: the
    outputs stay below 4 in magnitude, where one bf16 step (1/64 below 4)
    fits the 2e-2 tolerance; the bf16 kernel rounds its weights against a
    running max and the plain version against the row's max, so the two
    may round the output to neighbouring bf16 values."""
    q = torch.randn((B, Q, H), generator=gen, device=cuda).to(dtype)
    k, k_scale = attention.quantize_rows(torch.randn((B, N, H), generator=gen, device=cuda))
    v, v_scale = attention.quantize_rows(torch.randn((B, N, H), generator=gen, device=cuda))
    return q, k, v, k_scale, v_scale


@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize(
    "B,Q,N,H,heads",
    [(8, 32, 1536, 256, 8), (8, 16, 1536, 256, 8), (4, 12, 384, 64, 4), (3, 40, 100, 128, 2), (2, 5, 33, 64, 4),
     # three m16 row tiles; N dividing neither the 32-key chunk nor the 4-warp split; an odd N
     (3, 48, 1536, 256, 8), (2, 20, 1000, 128, 4), (2, 33, 1000, 256, 4), (2, 7, 999, 64, 2),
     # the families' caches: IL (N = 1024) and trajeglish (N = 512); DT's 48 rows over 1536 keys
     (4, 32, 1024, 256, 8), (4, 32, 512, 256, 8), (4, 48, 1536, 256, 8),
     # head widths 8 and 48, with no kernel instance: each head zero-padded to 16 and 64
     (4, 12, 384, 32, 4), (4, 32, 384, 192, 4),
     # 64 rows in one tile, and 65 (a second tile of one row); fewer keys than a 64-key chunk
     (3, 64, 1536, 256, 8), (2, 65, 700, 256, 8), (3, 48, 40, 256, 8), (2, 20, 17, 64, 4),
     # the keys design (Q <= 32) at one head a block (3 heads), and at d = 64 over 16 rows
     (2, 16, 130, 96, 3), (2, 30, 77, 96, 3), (2, 9, 200, 128, 2)],
)
def test_decode_attention_q8_kernel_matches_plain(cuda, dtype, atol, B, Q, N, H, heads):
    gen = torch.Generator(device=cuda).manual_seed(B * Q + N + 1)
    q, k, v, k_scale, v_scale = _q8_inputs(gen, cuda, B, Q, N, H, dtype)
    mask = torch.rand((Q, N), generator=gen, device=cuda) > 0.4
    mask[:, 0] = True
    mask[: min(3, Q) - 1] = False  # fully masked rows stay finite
    before = attention.cached_decode_attention_q8.launches
    got = attention.cached_decode_attention_q8(q, k, v, k_scale, v_scale, mask, heads)
    assert attention.cached_decode_attention_q8.launches == before + 1
    want = attention.cached_decode_attention_q8_reference(q, k, v, k_scale, v_scale, mask, heads)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    rows = mask.any(dim=1)
    torch.testing.assert_close(got.float()[:, rows], want.float()[:, rows], atol=atol, rtol=0)


def test_decode_attention_q8_kernel_on_rollout_masks(cuda):
    m1, m2 = stream_step_masks(40, 32, 16, 3, 0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    _, k, v, k_scale, v_scale = _q8_inputs(gen, cuda, 4, 1, 1536, 256, torch.bfloat16)
    for t in (0, 1, 31, 32, 39):
        for mask in (m1[t], m2[t]):
            q = torch.randn((4, mask.shape[0], 256), generator=gen, device=cuda).bfloat16()
            got = attention.cached_decode_attention_q8(q, k, v, k_scale, v_scale, mask, 8).float()
            want = attention.cached_decode_attention_q8_reference(q, k, v, k_scale, v_scale, mask, 8).float()
            rows = (mask != 0).any(dim=1)
            assert torch.isfinite(got).all()
            torch.testing.assert_close(got[:, rows], want[:, rows], atol=2e-2, rtol=0)


def test_decode_attention_q8_kernel_rejects_non_contiguous_or_misaligned(cuda):
    q = torch.randn((2, 8, 64), device=cuda)
    scale = torch.ones((2, 48), device=cuda)
    mask = torch.ones((8, 48), dtype=torch.bool, device=cuda)
    k = torch.ones((2, 64, 48), dtype=torch.int8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        attention.cached_decode_attention_q8(q, k, k, scale, scale, mask, 4)
    flat = torch.ones(2 * 48 * 64 + 1, dtype=torch.int8, device=cuda)
    k = flat[1:].view(2, 48, 64)  # contiguous, 1 byte off alignment
    with pytest.raises(ValueError):
        attention.cached_decode_attention_q8(q, k, k, scale, scale, mask, 4)
    k = torch.ones((2, 48, 64), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        attention.cached_decode_attention_q8(q, k, k, torch.ones((48, 2), device=cuda).t(), scale, mask, 4)


@pytest.mark.parametrize("int8", [False, True])
def test_decode_kernels_on_early_rollout_masks(cuda, int8):
    """K1 and K2 at the rollout's shapes under the masks of steps 0-31, whose
    unwritten ring slots leave whole 32-key chunks, and whole warp ranges,
    with no visible key."""
    m1, m2 = stream_step_masks(32, 32, 16, 3, 0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(int(int8))
    _, k8, v8, ks, vs = _q8_inputs(gen, cuda, 4, 1, 1536, 256, torch.bfloat16)
    k, v = (torch.randn((4, 1536, 256), generator=gen, device=cuda).bfloat16() for _ in range(2))
    for t in range(32):
        for mask in (m1[t], m2[t]):
            q = torch.randn((4, mask.shape[0], 256), generator=gen, device=cuda).bfloat16()
            if int8:
                got = attention.cached_decode_attention_q8(q, k8, v8, ks, vs, mask, 8).float()
                want = attention.cached_decode_attention_q8_reference(q, k8, v8, ks, vs, mask, 8).float()
            else:
                got = attention.cached_decode_attention(q, k, v, mask, 8).float()
                want = attention.cached_decode_attention_reference(q, k, v, mask, 8).float()
            rows = (mask != 0).any(dim=1)
            assert torch.isfinite(got).all(), t
            torch.testing.assert_close(got[:, rows], want[:, rows], atol=2e-2, rtol=0)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("case", ["3-pass", "dt", "il", "trajeglish"])
def test_decode_kernels_on_family_masks(cuda, case, int8):
    """K1 and K2 under the masks that each family's full-width rollout
    (and the 3-pass decode's) gives its decode passes (DT 48 rows over 1536
    keys, IL 32 over 1024, trajeglish 32 over 512, the 3-pass decode 16
    over 1536) at steps 0, 1, 31, 32 and 45; at t = 0 the t = -1 action
    rows see no key, and a pass with no row that sees one is compared on
    every row (both versions give such a row the uniform average of V)."""
    gen = torch.Generator(device=cuda).manual_seed(len(case) + int8)
    masks = decode_masks(case, 46, cuda)
    for t in (0, 1, 31, 32, 45):
        for mask in masks[t]:
            Q, N = mask.shape
            q = torch.randn((4, Q, 256), generator=gen, device=cuda).bfloat16()
            if int8:
                _, k, v, ks, vs = _q8_inputs(gen, cuda, 4, 1, N, 256, torch.bfloat16)
                got = attention.cached_decode_attention_q8(q, k, v, ks, vs, mask, 8).float()
                want = attention.cached_decode_attention_q8_reference(q, k, v, ks, vs, mask, 8).float()
            else:
                k, v = (torch.randn((4, N, 256), generator=gen, device=cuda).bfloat16() for _ in range(2))
                got = attention.cached_decode_attention(q, k, v, mask, 8).float()
                want = attention.cached_decode_attention_reference(q, k, v, mask, 8).float()
            rows = (mask != 0).any(dim=1)
            rows = rows if rows.any() else ~rows
            assert torch.isfinite(got).all(), (case, t)
            torch.testing.assert_close(got[:, rows], want[:, rows], atol=2e-2, rtol=0)


def _decode_args(cuda, int8, gen, B, Q, N, H=256, heads=8):
    """A decode kernel's wrapper, its plain version, and its arguments from
    ``gen`` (K1 over a bf16 cache, or K2 over an int8 one) for the lanes
    ``lanes``, the first ``rows`` query rows and a [rows, N] mask."""
    q = torch.randn((B, Q, H), generator=gen, device=cuda).bfloat16()
    if int8:
        _, k, v, ks, vs = _q8_inputs(gen, cuda, B, 1, N, H, torch.bfloat16)
        cache = (k, v, ks, vs)
        fns = (attention.cached_decode_attention_q8, attention.cached_decode_attention_q8_reference)
    else:
        cache = tuple(torch.randn((B, N, H), generator=gen, device=cuda).bfloat16() for _ in range(2))
        fns = (attention.cached_decode_attention, attention.cached_decode_attention_reference)
    return (*fns, lambda lanes, mask: (q[lanes, :mask.shape[0]].contiguous(), *(x[lanes] for x in cache), mask, heads))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("Q,N", [(48, 1536), (16, 1000), (64, 999), (65, 300)])
def test_decode_kernels_rows_that_see_no_key_in_some_chunks(cuda, int8, Q, N):
    """Rows that see no key at all, rows that see the keys of one 64-key
    chunk only (a different chunk each), rows that see every 7th key, rows
    that see only the last (partial) chunk's keys, and rows that see every
    key, in one launch: every row within 2e-2 of the plain version (a row
    that sees no key is the uniform average of V in both)."""
    gen = torch.Generator(device=cuda).manual_seed(Q + N + int8)
    chunks = (N + 63) // 64
    mask = torch.zeros((Q, N), dtype=torch.bool, device=cuda)
    for i in range(2, Q):
        kind = i % 4
        if kind == 0:
            mask[i] = True
        elif kind == 1:
            mask[i, 64 * (i % chunks):64 * (i % chunks) + 64] = True
        elif kind == 2:
            mask[i, i % 7::7] = True
        else:
            mask[i, 64 * (chunks - 1):] = True
    kernel, plain, args = _decode_args(cuda, int8, gen, 3, Q, N)
    got, want = kernel(*args(slice(None), mask)).float(), plain(*args(slice(None), mask)).float()
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("int8", [False, True])
def test_decode_kernels_lanes_independent_of_batch_and_repeatable(cuda, int8):
    """At the rollout's two shapes and DT's 48 rows: lanes 128-255 of a
    256-lane launch equal a 128-lane launch of the same inputs, and two
    launches equal each other, bit for bit (no atomics; a lane's result
    does not depend on which block of the persistent grid takes it)."""
    m1, m2 = stream_step_masks(46, 32, 16, 3, 0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(7 + int8)
    kernel, _, args = _decode_args(cuda, int8, gen, 256, 48, 1536)
    for mask in (m1[45], m2[45], torch.cat([m1[45], m2[45]])):
        whole, again = kernel(*args(slice(None), mask)), kernel(*args(slice(None), mask))
        half = kernel(*args(slice(128, 256), mask))
        torch.cuda.synchronize()
        assert torch.equal(whole, again)
        assert torch.equal(whole[128:], half)


def _device_kernel_names(fn) -> str:
    """The names of the device kernels that ``fn`` launches, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return " ".join(e.key for e in prof.key_averages())


@pytest.mark.parametrize("int8", [False, True])
def test_decode_attention_dispatches_by_dtype(cuda, int8):
    """bf16 runs the tensor-core kernel (over the int8 cache at Q = 32 the
    keys design's) and f32 the CUDA-core one: both launch through the same
    wrapper, and agree within bf16 rounding."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k8, v8, ks, vs = _q8_inputs(gen, cuda, 4, 32, 1536, 256, torch.float32)
    k, v = (torch.randn((4, 1536, 256), generator=gen, device=cuda) for _ in range(2))
    mask = torch.rand((32, 1536), generator=gen, device=cuda) > 0.3
    fn = attention.cached_decode_attention_q8 if int8 else attention.cached_decode_attention
    name = "decode_attention_q8" if int8 else "decode_attention"
    tensor_core = f"{name}_keys_kernel<" if int8 else f"{name}_wgmma_kernel<"
    outs = {}
    for dtype, kernel in ((torch.float32, f"{name}_kernel<"), (torch.bfloat16, tensor_core)):
        args = (q.to(dtype), k8, v8, ks, vs, mask, 8) if int8 else (q.to(dtype), k.to(dtype), v.to(dtype), mask, 8)
        before = fn.launches
        names = _device_kernel_names(lambda: outs.__setitem__(dtype, fn(*args)))
        assert fn.launches == before + 1
        assert kernel in names, names
        other = tensor_core if dtype == torch.float32 else f"{name}_kernel<"
        assert other not in names, names
        assert outs[dtype].dtype == dtype
    a, b = outs[torch.float32], outs[torch.bfloat16].float()
    assert torch.isfinite(b).all()
    assert (a - b).abs().max().item() <= 5e-2 * max(1.0, a.abs().max().item())


@pytest.mark.parametrize("Q,design", [(1, "keys"), (16, "keys"), (17, "keys"), (32, "keys"), (33, "wgmma"),
                                      (64, "wgmma")])
def test_decode_attention_q8_design_by_rows(cuda, Q, design):
    """Over the int8 cache in bf16, Q <= 32 query rows run the keys design
    (S^T = K Q^T, 16- or 32-row items) and more rows the rows design (64-row
    items): one launch of the one kernel, within 2e-2 of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(Q + 11)
    q, k, v, ks, vs = _q8_inputs(gen, cuda, 4, Q, 1536, 256, torch.bfloat16)
    mask = torch.rand((Q, 1536), generator=gen, device=cuda) > 0.5
    mask[:, 0] = True
    out = {}
    names = _device_kernel_names(lambda: out.__setitem__(
        "got", attention.cached_decode_attention_q8(q, k, v, ks, vs, mask, 8)))
    assert f"decode_attention_q8_{design}_kernel<" in names, names
    other = "wgmma" if design == "keys" else "keys"
    assert f"decode_attention_q8_{other}_kernel<" not in names, names
    want = attention.cached_decode_attention_q8_reference(q, k, v, ks, vs, mask, 8)
    torch.testing.assert_close(out["got"].float(), want.float(), atol=2e-2, rtol=0)


def _flash_inputs(cuda, B, steps, A, K, heads, d, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    T, D = steps * A * K, heads * d
    return [torch.randn((B, T, D), generator=gen, device=cuda).to(dtype) for _ in range(4)]


@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
@pytest.mark.parametrize("dtype,atol,gtol", [(torch.bfloat16, 2e-2, 5e-2), (torch.float32, 1e-4, 1e-4)])
@pytest.mark.parametrize(
    "B,steps,A,K,heads,d,own,window",
    [
        (2, 8, 24, 3, 8, 32, False, None),  # the training layout, 8 steps
        (2, 5, 23, 3, 8, 32, False, None),  # T = 345: ragged last tile
        (2, 6, 4, 3, 4, 64, True, None),  # d = 64, strict mode
        (3, 7, 3, 3, 2, 16, False, 3),  # d = 16, sliding window
        (2, 6, 4, 2, 4, 16, False, None),  # 2-token layout
        (2, 8, 24, 3, 4, 8, False, None),  # d = 8: each head zero-padded to 16
        (2, 5, 23, 3, 4, 48, True, None),  # d = 48, padded to 64, ragged, strict mode
    ],
)
def test_flash_attention_kernels_match_plain(cuda, dropout_p, dtype, atol, gtol, B, steps, A, K, heads, d, own, window):
    _check_flash(cuda, B, steps, A, K, heads, d, own, window, dtype, dropout_p, atol, gtol)


def test_head_width_above_the_widest_instance_is_refused(cuda):
    """d = 128 has no instance to pad to: every wrapper raises before a
    launch, and no width is handed to a plain version."""
    x = torch.zeros((2, 36, 256), device=cuda)
    mask = torch.ones((36, 36), dtype=torch.bool, device=cuda)
    before = (attention.cached_decode_attention.launches, flash_attention.flash_mha_fwd.launches)
    with pytest.raises(ValueError, match="widest kernel instance, 64"):
        attention.cached_decode_attention(x, x, x, mask, 2)
    with pytest.raises(ValueError, match="widest kernel instance, 64"):
        flash_attention.flash_mha_fwd(x, x, x, flash_attention.MaskSpec(3, 3, 0, False, None), 2)
    assert (attention.cached_decode_attention.launches, flash_attention.flash_mha_fwd.launches) == before


@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
@pytest.mark.parametrize("dtype,atol,gtol", [(torch.bfloat16, 2e-2, 5e-2), (torch.float32, 1e-4, 1e-4)])
@pytest.mark.parametrize(
    "B,steps,A,K,state_index,heads,d,own,window",
    [
        (2, 8, 24, 3, 1, 8, 32, False, None),  # DT's layout: the state token second
        (2, 5, 23, 3, 1, 8, 32, True, None),  # DT, ragged last tile, strict mode
        (2, 6, 4, 2, 1, 4, 16, False, 3),  # 2-token layout, state token second, window
        (2, 8, 24, 1, 0, 8, 32, False, None),  # trajeglish: one token type
        (2, 16, 24, 2, 0, 8, 32, False, None),  # IL
    ],
)
def test_flash_attention_kernels_family_layouts(cuda, dropout_p, dtype, atol, gtol, B, steps, A, K, state_index,
                                               heads, d, own, window):
    _check_flash(cuda, B, steps, A, K, heads, d, own, window, dtype, dropout_p, atol, gtol, state_index)


@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
def test_flash_attention_bf16_at_train_length(cuda, dropout_p):
    """The bf16 tensor-core kernels at the train step's T = 32 x 24 x 3 =
    2304 (36 tiles of 64, partial tiles on every query tile's diagonal)."""
    _check_flash(cuda, 2, 32, 24, 3, 8, 32, False, None, torch.bfloat16, dropout_p, 2e-2, 5e-2)


@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
@pytest.mark.parametrize("family", ["dt", "il", "trajeglish"])
def test_flash_attention_bf16_at_family_train_lengths(cuda, family, dropout_p):
    """The bf16 tensor-core kernels at each family's train-step length:
    T = 32 x 24 x K = 2304 (DT, state index 1), 1536 (IL), 768 (trajeglish)."""
    mc = preset(family).model
    _check_flash(cuda, 2, 32, 24, mc.num_token_types, 8, 32, False, None, torch.bfloat16, dropout_p, 2e-2, 5e-2,
                 mc.state_token_index)


def test_flash_attention_dispatches_by_dtype(cuda):
    """f32 runs the CUDA-core kernels and bf16 the tensor-core ones: both
    launch through the same wrappers, and agree within bf16 rounding."""
    spec = flash_attention.MaskSpec(24, 3, 0, False, None)
    q, k, v, do = _flash_inputs(cuda, 2, 4, 24, 3, 8, 32, torch.float32, 11)
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = [t.to(dtype) for t in (q, k, v, do)]
        f0, b0 = flash_attention.flash_mha_fwd.launches, flash_attention.flash_mha_bwd.launches
        out, lse, keep = flash_attention.flash_mha_fwd(*x[:3], spec, 8, 0.1, torch.tensor([3], device=cuda),
                                                       keep_bits=True)
        assert (keep is None) == (dtype == torch.float32)  # the f32 backward hashes again
        grads = flash_attention.flash_mha_bwd(*x[:3], out, x[3], lse, spec, 8, 0.1, torch.tensor([3], device=cuda),
                                              keep=keep)
        assert (flash_attention.flash_mha_fwd.launches, flash_attention.flash_mha_bwd.launches) == (f0 + 1, b0 + 1)
        assert out.dtype == dtype and all(g.dtype == dtype for g in grads)
        outs[dtype] = (out.float(), lse, *(g.float() for g in grads))
    torch.cuda.synchronize()
    for a, b in zip(outs[torch.float32], outs[torch.bfloat16]):
        assert torch.isfinite(b).all()
        assert (a - b).abs().max().item() <= 5e-2 * max(1.0, a.abs().max().item())


def _check_flash(cuda, B, steps, A, K, heads, d, own, window, dtype, dropout_p, atol, gtol, state_index=0):
    spec = flash_attention.MaskSpec(A, K, state_index, own, window)
    q, k, v, do = _flash_inputs(cuda, B, steps, A, K, heads, d, dtype, steps * A + d)
    seed = torch.tensor([1234567], device=cuda)
    f0, b0 = flash_attention.flash_mha_fwd.launches, flash_attention.flash_mha_bwd.launches
    out, lse, keep = flash_attention.flash_mha_fwd(q, k, v, spec, heads, dropout_p, seed, keep_bits=True)
    dq, dk, dv = flash_attention.flash_mha_bwd(q, k, v, out, do, lse, spec, heads, dropout_p, seed, keep=keep)
    assert (flash_attention.flash_mha_fwd.launches, flash_attention.flash_mha_bwd.launches) == (f0 + 1, b0 + 1)
    if keep is not None:  # bf16 with dropout: the saved bits are the hash's on every word the kernels walk
        T = q.shape[1]
        walked = flash_attention.walked_keep_words(spec, T).to(cuda)
        want = flash_attention.dropout_keep_bits(seed, 0, B, heads, T, 1.0 - dropout_p, cuda)
        assert torch.equal(keep.view(torch.int32)[:, :, walked], want.view(torch.int32)[:, :, walked])
    leaves = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
    want, want_lse = flash_attention.flash_mha_reference(*leaves, spec, heads, dropout_p, seed)
    grads = torch.autograd.grad(want, leaves, do.float())
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want, atol=atol, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=atol, rtol=0)
    for got, ref in zip((dq, dk, dv), grads):
        assert got.dtype == dtype
        scale = ref.abs().max().item()
        assert (got.float() - ref).abs().max().item() <= gtol * scale


def test_flash_attention_autograd_uses_both_kernels(cuda):
    spec = flash_attention.MaskSpec(6, 3, 0, False, None)
    q, k, v, do = (x.requires_grad_(True) if i < 3 else x
                   for i, x in enumerate(_flash_inputs(cuda, 2, 4, 6, 3, 4, 16, torch.float32, 0)))
    f0, b0 = flash_attention.flash_mha_fwd.launches, flash_attention.flash_mha_bwd.launches
    out = flash_attention.flash_mha(q, k, v, spec, 4, 0.1, torch.tensor([9], device=cuda))
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert (flash_attention.flash_mha_fwd.launches, flash_attention.flash_mha_bwd.launches) == (f0 + 1, b0 + 1)
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_keeps_bits_only_for_a_backward(cuda, dtype):
    """Through ``flash_mha`` with dropout: a launch that a backward will
    follow saves the keep bits in bf16 (the f32 kernels hash again) and its
    gradients match the plain version's; a launch under no_grad keeps
    nothing, and the bf16 backward refuses to run without the bits."""
    spec = flash_attention.MaskSpec(24, 3, 0, False, None)
    q, k, v, do = _flash_inputs(cuda, 2, 4, 24, 3, 8, 32, dtype, 5)
    seed = torch.tensor([77], device=cuda)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = flash_attention.flash_mha(*leaves, spec, 8, 0.1, seed)
    grads = torch.autograd.grad(out, leaves, do)
    ref_leaves = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
    want = flash_attention.flash_mha_reference(*ref_leaves, spec, 8, 0.1, seed)[0]
    for got, ref in zip(grads, torch.autograd.grad(want, ref_leaves, do.float())):
        assert (got.float() - ref).abs().max().item() <= 5e-2 * ref.abs().max().item()
    with torch.no_grad():
        before = torch.cuda.memory_allocated()
        kept = flash_attention.flash_mha(*leaves, spec, 8, 0.1, seed)
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() - before == kept.numel() * kept.element_size()
    if dtype == torch.bfloat16:
        out, lse, keep = flash_attention.flash_mha_fwd(q, k, v, spec, 8, 0.1, seed)
        assert keep is None
        with pytest.raises(ValueError, match="keep bits"):
            flash_attention.flash_mha_bwd(q, k, v, out, do, lse, spec, 8, 0.1, seed)


def test_flash_attention_kernels_reject_non_contiguous_or_misaligned(cuda):
    spec = flash_attention.MaskSpec(3, 3, 0, False, None)
    q = torch.randn((2, 36, 32), device=cuda)
    with pytest.raises(ValueError):
        flash_attention.flash_mha_fwd(q, q.transpose(0, 1).contiguous().transpose(0, 1), q, spec, 2)
    flat = torch.randn(2 * 36 * 32 + 1, device=cuda)
    k = flat[1:].view(2, 36, 32)  # contiguous, 4 bytes off alignment
    with pytest.raises(ValueError):
        flash_attention.flash_mha_fwd(q, k, q, spec, 2)


def test_env_step_with_contacts_does_not_sync(cuda):
    """The contact solver selects its per-scene branches on the card: an env
    step with touching vehicles raises under the sync debug mode if any op
    copies a value back to the host."""
    cfg = load_config({"sim.resolve_contacts": True})
    sc = to_torch(stack_scenarios(
        [synthetic_scenario(cfg, seed=s, num_agents=12, arena_half=25.0, num_lanes=2, conflict_pairs=2)
         for s in range(8)], cfg), cuda)
    env = WaymoEnv(cfg)
    state = env.reset(sc)
    zero = torch.zeros_like(sc.length)
    expert = torch.zeros_like(sc.agent_valid)
    alive = state.alive.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            state = env.step(sc, state, zero, zero, expert, alive)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.isfinite(state.bodies.position).all()
