"""The port's streaming rollout held against the JAX ``run_streaming``.

``RolloutOutput`` holds continuous values only, so the JAX rollout's
sampled RTG bins and action ids are recovered from its ``rtgs``,
``acceleration`` and ``steering`` with the port's ``discretize_*`` and
replayed through the port's sampler argument; positions, headings,
reward8 and nearest distances then agree over every step. The samplers
themselves are checked in distribution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from ctrl_sim_tpu.rollout import policy as jpolicy
from ctrl_sim_tpu.env.env import WaymoEnv as JaxEnv
from ctrl_sim_tpu.rollout.rollout import default_groups as jax_default_groups
from ctrl_sim_tpu.rollout.rollout import dt_dense_reward3 as jax_dt_dense_reward3
from ctrl_sim_tpu.rollout.streaming import run_streaming as jax_run_streaming
from ctrl_sim_tpu_torch.data import transforms as ttf
from ctrl_sim_tpu_torch.rollout import policy as tpolicy
from ctrl_sim_tpu_torch.rollout.groups import gather_members, scatter_by_rank
from ctrl_sim_tpu_torch.env.env import WaymoEnv as TorchEnv
from ctrl_sim_tpu_torch.rollout.rollout import default_groups, dt_dense_reward3
from ctrl_sim_tpu_torch.rollout.streaming import run_streaming
from torch_port_common import configs, jax_scenario, models, scenes, t2n, torch_scenario

torch.set_num_threads(2)


class ReplaySampler:
    """Hands out given RTG bins [T, E, A, 3] and action ids [T, E, A]."""

    def __init__(self, rtg_bins, action_ids):
        self.rtg_bins, self.action_ids = rtg_bins, action_ids

    def rtgs(self, t, logits, tilt):
        assert logits.shape[-2:] == (350, 3) and torch.isfinite(logits).all()
        return self.rtg_bins[t]

    def actions(self, t, logits):
        assert logits.shape[-1] == 1000 and torch.isfinite(logits).all()
        return self.action_ids[t]


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    sb = scenes(jcfg, num_scenes=6, num_agents=8)
    jm, params, tm = models(jcfg, tcfg)
    controlled = sb.moving & sb.agent_valid
    tilt = jnp.asarray(np.random.default_rng(0).normal(size=(350, 3)).astype(np.float32))
    ro = jax.jit(lambda s, p, c, r, tl: jax_run_streaming(jcfg, jm, p, s, c, r, tl))(
        jax_scenario(sb), params, jnp.asarray(controlled), jax.random.PRNGKey(1), tilt
    )
    return jcfg, tcfg, sb, tm, controlled, np.array(tilt), jax.tree.map(np.array, ro)


@pytest.mark.parametrize("crop_size", [8, None])
def test_groups_match_jax(setup, crop_size):
    """Packed slots (8 of 12) and the identity crop (12 = max_num_agents)."""
    jcfg, tcfg, sb, *_ = setup
    controlled = sb.moving & sb.agent_valid
    jg = jax_default_groups(jcfg, jax_scenario(sb), jnp.asarray(controlled), crop_size=crop_size)
    tg = default_groups(tcfg, torch_scenario(sb), torch.as_tensor(controlled), crop_size=crop_size)
    for name in jg._fields:
        np.testing.assert_array_equal(t2n(getattr(tg, name)), np.asarray(getattr(jg, name)), err_msg=name)
    x = torch.arange(6 * 12 * 2, dtype=torch.float32).reshape(6, 12, 2)
    g = gather_members(x, tg.members)
    table, covered = scatter_by_rank(g, tg.members, tg.member_valid, 12)
    for e in range(6):
        for s in range(tg.crop_size):
            if tg.member_valid[e, 0, s]:
                a = int(tg.members[e, 0, s])
                assert covered[e, a] and torch.equal(table[e, a], x[e, a])
    assert int(covered.sum()) == int(tg.member_valid.sum())


def test_rollout_replay_matches_jax(setup):
    jcfg, tcfg, sb, tm, controlled, tilt, ro = setup
    wc = tcfg.waymo
    rtg_bins = ttf.discretize_rtgs(ttf.normalize_rtgs(torch.as_tensor(ro.rtgs), wc), wc).long()
    action_ids = ttf.discretize_actions(
        torch.stack([torch.as_tensor(ro.acceleration), torch.as_tensor(ro.steering)], -1), wc
    ).long()
    out = run_streaming(
        tcfg, tm, torch_scenario(sb), torch.as_tensor(controlled), torch.Generator(),
        torch.as_tensor(tilt), sampler=ReplaySampler(rtg_bins, action_ids),
    )
    # the policy acted: some controlled agents left GT replay
    assert (ro.acceleration[tcfg.sim.history_steps:][:, controlled] != 0).any()
    for name in ("position", "heading", "reward8", "nearest_dist", "existence", "rtgs",
                 "acceleration", "steering"):
        np.testing.assert_allclose(t2n(getattr(out, name)), getattr(ro, name), atol=1e-3, rtol=0, err_msg=name)


def test_dt_dense_reward3_matches_jax(setup):
    jcfg, tcfg, sb, *_ = setup
    ts = torch_scenario(sb)
    jenv, tenv = JaxEnv(jcfg), TorchEnv(tcfg)

    @jax.jit
    def jax_side(js):
        jr, jst = jenv.reward(js, jenv.reset(js))
        return jax_dt_dense_reward3(jcfg, js, jst, jr)

    want = np.asarray(jax_side(jax_scenario(sb)))
    tr, tst = tenv.reward(ts, tenv.reset(ts))
    got = t2n(dt_dense_reward3(tcfg, ts, tst, tr))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(want).sum() > 0


def test_rollout_own_sampler_is_finite_and_seeded(setup):
    _, tcfg, sb, tm, controlled, tilt, _ = setup
    ts, ctrl = torch_scenario(sb), torch.as_tensor(controlled)
    a = run_streaming(tcfg, tm, ts, ctrl, torch.Generator().manual_seed(5), torch.as_tensor(tilt))
    b = run_streaming(tcfg, tm, ts, ctrl, torch.Generator().manual_seed(5), torch.as_tensor(tilt))
    for name, x in a._asdict().items():
        assert torch.isfinite(x.float()).all(), name
        assert torch.equal(x, getattr(b, name)), name
    steps, E, A = a.acceleration.shape
    assert a.position.shape == (steps + 1, E, A, 2) and steps == tcfg.sim.steps


@pytest.mark.parametrize(
    "over",
    [{"model.il": True}, {"eval.streaming_passes": 3}, {"sim.resolve_contacts": True}],
)
def test_rollout_refuses_unported_paths(setup, over):
    _, tcfg0, sb, tm, controlled, *_ = setup
    _, tcfg = configs(**over)
    with pytest.raises(NotImplementedError):
        run_streaming(tcfg, tm, torch_scenario(sb), torch.as_tensor(controlled), torch.Generator())


def _chi2_ok(draws, probs, n_cat):
    counts = np.bincount(draws, minlength=n_cat)
    expected = probs * len(draws)
    keep = expected > 5
    chi2 = ((counts[keep] - expected[keep]) ** 2 / expected[keep]).sum()
    return chi2 < stats.chi2.ppf(0.999, keep.sum() - 1), (chi2, counts, expected)


def test_tilted_rtg_sampler_distribution():
    rng = np.random.default_rng(0)
    bins = 12
    logits = rng.normal(size=(bins, 3)).astype(np.float32)
    tilt = np.stack([np.linspace(0, 1, bins) * s for s in (2.0, -1.0, 0.0)], -1).astype(np.float32)
    n = 30_000
    draws = t2n(tpolicy.sample_tilted_rtgs(
        torch.Generator().manual_seed(0),
        torch.as_tensor(logits).expand(n, bins, 3), torch.as_tensor(tilt)))
    assert draws.shape == (n, 3)
    # the JAX sampler's distribution, estimated the same way
    jdraws = np.asarray(jpolicy.sample_tilted_rtgs(
        jax.random.PRNGKey(0), jnp.broadcast_to(logits, (n, bins, 3)), tilt))
    for c in range(3):
        p = np.exp(logits[:, c] + tilt[:, c])
        p /= p.sum()
        ok, info = _chi2_ok(draws[:, c], p, bins)
        assert ok, info
        ok, info = _chi2_ok(jdraws[:, c], p, bins)
        assert ok, info


@pytest.mark.parametrize("temperature,nucleus", [(1.0, False), (0.7, False), (1.0, True)])
def test_action_sampler_distribution(temperature, nucleus):
    rng = np.random.default_rng(1)
    k = 20
    logits = rng.normal(size=k).astype(np.float32) * 1.5
    n = 25_000
    draws = t2n(tpolicy.sample_actions(
        torch.Generator().manual_seed(1), torch.as_tensor(logits).expand(n, k),
        temperature, nucleus, 0.8))
    scaled = logits / temperature
    if nucleus:
        filt = t2n(tpolicy.nucleus_filter(torch.as_tensor(scaled), 0.8))
        np.testing.assert_array_equal(filt, np.asarray(jpolicy.nucleus_filter(jnp.asarray(scaled), 0.8)))
        assert set(np.unique(draws)) <= set(np.flatnonzero(filt > -1e30))
        scaled = filt
    p = np.exp(scaled - scaled.max())
    p /= p.sum()
    ok, info = _chi2_ok(draws, p, k)
    assert ok, info
