"""The plain version of kernels K3/K4 (``ctrl_sim_tpu_torch/ops/flash_attention.py``)
held against the JAX ``flash_mha`` run in Pallas interpret mode: the
dropout keep bits and the multi-agent causal mask bit for bit, the forward
(output, lse) within 2e-5 and dq/dk/dv within 5e-5 over the five layouts of
``tests/test_flash_attention.py``, at dropout 0 and at dropout 0.1 with one
seed (the keep masks are identical, so the same bounds hold). The
``*_family_layouts`` tests take the same checks to the other families'
layouts: the state token second (DT, ``state_index`` 1) and one token type
(trajeglish, K = 1). All fp32 on the CPU; the CUDA kernels are held
against this plain version on the card by ``tests/test_torch_kernels.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrl_sim_tpu.ops import flash_attention as jfa
from ctrl_sim_tpu.ops import masks as jmasks
from ctrl_sim_tpu_torch.ops import flash_attention as tfa
from ctrl_sim_tpu_torch.ops import masks as tmasks

torch.set_num_threads(2)

FWD_ATOL, GRAD_ATOL = 2e-5, 5e-5
LAYOUTS = [  # (A, K, steps, heads, head_dim, strict, window, JAX block_q)
    (3, 3, 4, 2, 4, False, None, 8),  # CtRL-Sim layout
    (3, 3, 4, 2, 4, True, 2, 8),  # strict + sliding window
    (2, 2, 5, 4, 8, False, None, 16),  # IL-style 2-token layout
    (4, 1, 6, 2, 4, False, 3, 8),  # trajeglish action-only
    (3, 3, 4, 2, 4, False, None, 7),  # block_q doesn't divide T: padded block
]


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 + 7, 2**32 - 1])
def test_dropout_keep_bit_identical(seed):
    rows = np.arange(300, dtype=np.int32)[:, None]
    cols = np.arange(2304 - 257, 2304, dtype=np.int32)[None, :]
    for b in (0, 3, 15):
        for h in (0, 7):
            for keep_prob in (0.9, 0.5):
                want = np.asarray(jfa._dropout_keep(
                    jnp.uint32(seed), jnp.int32(b), h, jnp.asarray(rows), jnp.asarray(cols), keep_prob))
                got = tfa.dropout_keep_reference(
                    seed, b, h, torch.as_tensor(rows), torch.as_tensor(cols), keep_prob).numpy()
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "steps,agents,types,own,window",
    [(4, 3, 3, False, None), (4, 3, 3, True, None), (5, 2, 2, False, 2), (6, 4, 1, True, 3), (32, 24, 3, False, None)],
)
def test_multi_agent_causal_mask_bit_equal(steps, agents, types, own, window):
    _check_mask(steps, agents, types, 0, own, window)


# (steps, agents, types, state_index, own, window): DT's layout (the state
# token second) in every mode and at the train step's size, the same index
# in a 2-token layout, and trajeglish's single token type
FAMILY_MASKS = [
    (4, 3, 3, 1, False, None), (4, 3, 3, 1, True, None), (6, 4, 3, 1, False, 3), (32, 24, 3, 1, False, None),
    (5, 2, 2, 1, False, 2), (6, 4, 1, 0, False, None), (32, 24, 1, 0, False, None),
]


@pytest.mark.parametrize("steps,agents,types,state_index,own,window", FAMILY_MASKS)
def test_multi_agent_causal_mask_bit_equal_family_layouts(steps, agents, types, state_index, own, window):
    _check_mask(steps, agents, types, state_index, own, window)


def _check_mask(steps, agents, types, state_index, own, window):
    want = np.asarray(jmasks.multi_agent_causal_mask(steps, agents, types, state_index, own, window))
    got = tmasks.multi_agent_causal_mask(steps, agents, types, state_index, own, window, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    # the kernels' predicate on token indices is the same mask
    n = steps * agents * types
    idx = torch.arange(n)
    spec = tfa.MaskSpec(agents, types, state_index, own, window)
    np.testing.assert_array_equal(tfa.block_mask(idx[:, None], idx[None, :], n, spec).numpy(), want)


def _inputs(T, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, T, D)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
@pytest.mark.parametrize("A,K,steps,nh,hd,strict,window,bq", LAYOUTS)
def test_reference_matches_jax_flash(dropout_p, A, K, steps, nh, hd, strict, window, bq):
    _check_reference(dropout_p, A, K, 0, steps, nh, hd, strict, window, bq)


FAMILY_LAYOUTS = [  # (A, K, state_index, steps, heads, head_dim, strict, window, JAX block_q)
    (3, 3, 1, 4, 2, 4, False, None, 8),  # DT layout
    (3, 3, 1, 4, 2, 4, True, 2, 8),  # DT, strict + sliding window
    (2, 2, 1, 5, 4, 8, False, None, 16),  # 2-token layout, state token second
    (4, 1, 0, 6, 2, 4, False, None, 8),  # trajeglish, no window
]


@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
@pytest.mark.parametrize("A,K,state_index,steps,nh,hd,strict,window,bq", FAMILY_LAYOUTS)
def test_reference_matches_jax_flash_family_layouts(dropout_p, A, K, state_index, steps, nh, hd, strict, window, bq):
    _check_reference(dropout_p, A, K, state_index, steps, nh, hd, strict, window, bq)


def _check_reference(dropout_p, A, K, state_index, steps, nh, hd, strict, window, bq):
    T, D = A * K * steps, nh * hd
    q, k, v, g = _inputs(T, D, seed=T + D)
    jspec = jfa.MaskSpec(A, K, state_index, strict, window)
    seed = jnp.asarray([987654321], jnp.uint32)

    def f(q, k, v):
        return jfa.flash_mha(q, k, v, jspec, nh, dropout_p=dropout_p, seed=seed, block_q=bq, interpret=True)

    jout, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    _, jlse = jfa._fwd_call(jspec, nh, dropout_p, bq, True, *(jnp.asarray(x) for x in (q, k, v)), seed)

    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out, lse = tfa.flash_mha_reference(*leaves, tfa.MaskSpec(A, K, state_index, strict, window), nh, dropout_p,
                                       987654321)
    grads = torch.autograd.grad(out, leaves, torch.tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse), atol=FWD_ATOL, rtol=0)
    for name, a, b in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL, rtol=0, err_msg=f"d{name}")


def test_wrappers_on_cpu_use_plain_version():
    spec = tfa.MaskSpec(3, 3, 0, False, None)
    q, k, v, g = (torch.tensor(x) for x in _inputs(36, 32))
    launches = (tfa.flash_mha_fwd.launches, tfa.flash_mha_bwd.launches)
    out, lse = tfa.flash_mha_fwd(q, k, v, spec, 2, 0.1, 5)
    want, want_lse = tfa.flash_mha_reference(q, k, v, spec, 2, 0.1, 5)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    dq, dk, dv = tfa.flash_mha_bwd(q, k, v, out, g, lse, spec, 2, 0.1, 5)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = tfa.flash_mha(*leaves, spec, 2, 0.1, 5)
    for a, b in zip((dq, dk, dv), torch.autograd.grad(o, leaves, g)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert (tfa.flash_mha_fwd.launches, tfa.flash_mha_bwd.launches) == launches


@pytest.mark.parametrize(
    "shape,heads,dtype,error",
    [((2, 36, 12), 2, torch.float32, ValueError),  # head width 6
     ((2, 36, 256), 2, torch.float32, ValueError),  # head width 128
     ((2, 36, 32), 2, torch.float16, TypeError)],
)
def test_wrapper_rejects(shape, heads, dtype, error):
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(error):
        tfa.flash_mha(x, x, x, tfa.MaskSpec(3, 3, 0, False, None), heads)


@pytest.mark.parametrize("tile", [tfa.TILE, 16])
@pytest.mark.parametrize(
    "steps,agents,types,own,window",
    [  # the layouts of tests/test_torch_kernels.py's kernel cases, and the train step's
        (8, 24, 3, False, None),
        (5, 23, 3, False, None),
        (6, 4, 3, True, None),
        (7, 3, 3, False, 3),
        (6, 4, 2, False, None),
        (32, 24, 3, False, None),
    ],
)
def test_tile_table_matches_block_mask(tile, steps, agents, types, own, window):
    """The bf16 kernels' tile schedule against the mask: every tile with a
    visible pair is walked, no other, and every tile it marks fully visible
    is fully visible (the kernels skip the predicate there), on both sides:
    the key tiles of each query tile and the query tiles of each key tile."""
    _check_tile_table(tile, steps, agents, types, 0, own, window)


@pytest.mark.parametrize("tile", [tfa.TILE, 16])
@pytest.mark.parametrize(
    "steps,agents,types,state_index,own,window",
    [  # the families' layouts of tests/test_torch_kernels.py and their train steps' (T = 2304, 768, 1536)
        (8, 24, 3, 1, False, None),
        (5, 23, 3, 1, True, None),
        (6, 4, 2, 1, False, 3),
        (8, 24, 1, 0, False, None),
        (32, 24, 3, 1, False, None),
        (32, 24, 1, 0, False, None),
        (32, 24, 2, 0, False, None),
    ],
)
def test_tile_table_matches_block_mask_family_layouts(tile, steps, agents, types, state_index, own, window):
    _check_tile_table(tile, steps, agents, types, state_index, own, window)


def _check_tile_table(tile, steps, agents, types, state_index, own, window):
    T = steps * agents * types
    spec = tfa.MaskSpec(agents, types, state_index, own, window)
    table = tfa.tile_table(spec, T, tile)
    n = -(-T // tile)
    assert table.shape == (2, n, 5) and table.dtype == torch.int32
    idx = torch.arange(n * tile)
    blocks = tfa.block_mask(idx[:, None], idx[None, :], T, spec).reshape(n, tile, n, tile)
    seen, full = blocks.any(dim=3).any(dim=1), blocks.all(dim=3).all(dim=1)
    for side, (s, f) in enumerate(((seen, full), (seen.T, full.T))):
        entries = table[side].tolist()
        assert sorted(e[0] for e in entries) == list(range(n))
        work = [e[4] - e[1] for e in entries]
        assert work == sorted(work, reverse=True)  # heaviest first
        for own_tile, begin, full_begin, full_end, end in entries:
            walked = set(range(begin, end))
            assert walked == set(torch.nonzero(s[own_tile]).flatten().tolist())
            assert begin <= full_begin <= full_end <= end
            assert all(f[own_tile, c] for c in range(full_begin, full_end))
    if window is None and not own and T >= tile:  # the default mask: earlier timesteps are fully visible
        q_tile = T // tile - 1  # the last query tile with no row past T
        step = agents * types
        first_own_step = (q_tile * tile) // step * step
        if types == 1:  # every token is a state token: the first row's own step is fully visible too
            first_own_step += step
        _, begin, full_begin, full_end, _ = next(e for e in table[0].tolist() if e[0] == q_tile)
        assert begin == full_begin == 0 and full_end == first_own_step // tile
