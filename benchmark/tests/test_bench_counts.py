"""The yardstick's arithmetic against counts worked by hand: interval
unions with overlapping kernels, the idle share, the admitted pairs of the
mask, the kernels' least times and the model operation counts."""

from __future__ import annotations

import itertools
from types import SimpleNamespace

import pytest

from benchmark import harness, yardstick
from benchmark.trace import DeviceTrace, Spans

BENCH = harness.manifest()
CTRL = harness.flat_sizes(harness.config_file(BENCH, "ctrl_sim")["sizes"])
DT = harness.flat_sizes(harness.config_file(BENCH, "dt")["sizes"])
TRAIN = harness.traffic_file("train_b64")
STREAM = harness.traffic_file("stream_256")


def _trace(ops, lo, hi):
    t = DeviceTrace()
    t.ops, t.lo, t.hi = ops, lo, hi
    return t


@pytest.mark.parametrize("intervals, lo, hi, union", [
    ([(10, 20), (15, 30), (50, 60)], 0, 100, 30),  # two overlapping kernels count once
    ([(10, 20), (10, 20), (12, 18)], 0, 100, 10),  # nested and repeated
    ([(0, 50), (40, 120)], 10, 100, 90),  # clipped to the window
    ([(10, 20), (20, 30)], 0, 100, 20),  # touching
    ([], 0, 100, 0),
])
def test_interval_union(intervals, lo, hi, union):
    assert yardstick.interval_union_ns(intervals, lo, hi) == union
    gaps = yardstick.idle_gaps(intervals, lo, hi)
    assert sum(b - a for a, b in gaps) == (hi - lo) - union


def test_idle_share_counts_overlaps_once_and_gaps_between_steps():
    # window 1 s; kernels: 0.1-0.3 s and 0.2-0.4 s overlapping (0.3 s busy), 0.6-0.7 s: 0.4 s busy
    ops = [(100, 300, "a"), (200, 400, "b"), (600, 700, "a")]
    t = _trace([(s * 10**6, e * 10**6, n) for s, e, n in ops], 0, 10**9)
    assert t.busy_s == pytest.approx(0.4)
    ctx = SimpleNamespace(trace=t)
    for name in ("device_idle_pct.train", "device_idle_pct.rollout"):
        assert harness.load_reader(name).read(ctx) == pytest.approx(60.0)
    # summing the kernels would give 0.5 s busy and 50% idle: the union gives 60%
    assert t.kernel_seconds(lambda n: True) == pytest.approx(0.5)


def test_breakdown_names_the_innermost_span_over_each_gap():
    t = _trace([(10, 20, "k1"), (15, 30, "k2"), (50, 60, "k1")], 0, 100)
    spans = Spans()
    spans.items = [("bench.window", 0, 100), ("bench.batch", 32, 48), ("bench.train_step", 48, 95)]
    out = t.breakdown(spans)
    assert out["device_ops"] == [["k1", 20e-9], ["k2", 15e-9]]
    assert dict(out["idle_gaps"]) == pytest.approx({"bench.window": 10e-9, "bench.batch": 20e-9,
                                                    "bench.train_step": 40e-9})


def _brute_pairs(steps, agents, types, state_index, own=False, window=None):
    n = 0
    for i, j in itertools.product(range(steps * agents * types), repeat=2):
        ti, ai, ki = i // (agents * types), (i // types) % agents, i % types
        tj, aj, kj = j // (agents * types), (j // types) % agents, j % types
        see = (kj == state_index and tj <= ti) or (
            j <= i and (tj < ti or aj == ai) and not (own and tj < ti and aj != ai and kj != state_index))
        if window is not None:
            see = see and tj > ti - window
        n += see
    return n


@pytest.mark.parametrize("steps, agents, types, si, own, window", [
    (2, 2, 3, 0, False, None), (3, 2, 3, 1, False, None), (3, 3, 2, 0, True, None), (4, 2, 3, 0, False, 2),
])
def test_admitted_pairs_against_the_rule_pair_by_pair(steps, agents, types, si, own, window):
    assert yardstick.admitted_pairs(steps, agents, types, si, own, window) == _brute_pairs(
        steps, agents, types, si, own, window)


def test_admitted_pairs_by_hand():
    # one step, one agent, types (state, rtg, action): state sees itself; rtg sees state and itself;
    # action sees all three
    assert yardstick.admitted_pairs(1, 1, 3, 0) == 1 + 2 + 3
    # the training sequence of the train cells (the port's K3 bound counts the same 2,628,864)
    assert yardstick.admitted_pairs(32, 24, 3, 0) == 2628864


def test_stream_admitted_by_hand():
    # step 0, one agent, one slot of the ring (window 1), CtRL-Sim's pass 2: the rtg row sees the
    # state and itself; pass 1's t - 1 action row sees nothing, its state row itself
    assert yardstick.stream_admitted(0, [(1, 0)], 1, 3, 0, 1) == 2
    assert yardstick.stream_admitted(0, [(2, -1), (0, 0)], 1, 3, 0, 1) == 1
    # the ring's labels: at step 33 of a window of 32, slot 1 holds step 33, slot 2 step 2
    assert list(yardstick.ring_labels(33, 32)[:3]) == [32, 33, 2]
    assert list(yardstick.ring_labels(1, 4)) == [0, 1, -1, -1]


def test_k1_least_time_matches_the_bytes_by_hand():
    k1 = harness.load_reader("k1_roofline_pct")
    # B = 256 lanes, Q = 32, N = 32 x 3 x 16 = 1536, H = 256, bf16: 2 B Q H 2 + 2 B N H 2 + Q N bytes
    nbytes = 2 * 256 * 32 * 256 * 2 + 2 * 256 * 1536 * 256 * 2 + 32 * 1536
    assert k1.launch_least_s(256, 32, 1536, 256) == pytest.approx(nbytes / 3.35e12)
    assert k1.launch_least_s(256, 32, 1536, 256) * 1e3 == pytest.approx(0.1227, abs=1e-4)


def _cfg(preset: str, traffic: dict, extra: dict | None = None):
    from benchmark.reference.sim import config as ref_config

    return harness.build_config(ref_config, {"preset": preset}, traffic, extra)


def _ctx(sizes, traffic, preset, counts, kernels, window_s=1.0, extra=None):
    """A reader's context over a trace that holds ``kernels[name] = (seconds,
    launches)``, each launch of an equal share."""
    ops = []
    for name, (seconds, launches) in kernels.items():
        total = round(seconds * 1e9)
        ops += [(0, total // launches + (total % launches if i == 0 else 0), name) for i in range(launches)]
    return SimpleNamespace(sizes=sizes, traffic=traffic, cfg=_cfg(preset, traffic, extra), counts=counts,
                           trace=_trace(ops, 0, int(window_s * 1e9)))


def test_k3_k4_roofline_by_hand():
    # one train step: 4 layers x 4 microbatches = 16 launches of B = 16 rows
    pairs, H, B, T = 2628864, 256, 16, 2304
    k3_least = max(4 * pairs * H * B / 989e12, (4 * B * T * H * 2 + B * 8 * T * 4) / 3.35e12)
    k4_least = max(10 * pairs * H * B / 989e12, (8 * B * T * H * 2 + B * 8 * T * 4) / 3.35e12)
    assert k3_least * 1e3 == pytest.approx(0.0436, abs=1e-4) and k4_least * 1e3 == pytest.approx(0.1089, abs=1e-4)
    ctx = _ctx(CTRL, TRAIN, "ctrl_sim", {"steps": 2},
               {"void flash_fwd_wgmma_kernel<32>": (0.0144, 32), "flash_bwd_dq_wgmma_kernel": (0.0096, 32),
                "flash_bwd_dkdv_wgmma_kernel": (0.0192, 32)})
    assert harness.load_reader("k3_roofline_pct").read(ctx) == pytest.approx(100 * 32 * k3_least / 0.0144)
    assert harness.load_reader("k4_roofline_pct").read(ctx) == pytest.approx(100 * 32 * k4_least / 0.0288)


@pytest.mark.parametrize("reader, kernel", [("k3_roofline_pct", "flash_fwd_wgmma_kernel"),
                                            ("k4_roofline_pct", "flash_bwd_dkdv_wgmma_kernel")])
def test_k3_k4_launches_held_against_the_trace(reader, kernel):
    # 2 steps count 32 launches; a trace with 48 (a third microbatch in each of 16) is not read
    ctx = _ctx(CTRL, TRAIN, "ctrl_sim", {"steps": 2}, {kernel: (0.02, 48)})
    assert harness.load_reader(reader).read(ctx) is None


@pytest.mark.parametrize("preset, extra, passes", [
    ("ctrl_sim", None, [[(2, -1), (0, 0)], [(1, 0)]]),
    ("ctrl_sim", {"eval.streaming_passes": 3}, [[(2, -1)], [(0, 0)], [(1, 0)]]),
    ("dt", None, [[(2, -1), (0, 0), (1, 0)]]),
    ("il", None, [[(1, -1), (0, 0)]]),
    ("trajeglish", None, [[(0, -1), (0, 0)]]),
])
def test_decode_passes_follow_the_configuration(preset, extra, passes):
    assert yardstick.decode_passes(_cfg(preset, STREAM, extra)) == passes


def test_k1_roofline_by_family():
    k1 = harness.load_reader("k1_roofline_pct")
    ctx = _ctx(CTRL, STREAM, "ctrl_sim", {"chunks": 1}, {"decode_attention_wgmma_kernel": (0.2, 720),
                                                         "decode_attention_q8_keys_kernel": (5.0, 720)})
    per_step = 4 * (k1.launch_least_s(256, 32, 1536, 256) + k1.launch_least_s(256, 16, 1536, 256))
    assert k1.read(ctx) == pytest.approx(100 * 90 * per_step / 0.2)
    ctx = _ctx(DT, STREAM, "dt", {"chunks": 2}, {"decode_attention_wgmma_kernel": (0.2, 720)})
    assert k1.read(ctx) == pytest.approx(100 * 180 * 4 * k1.launch_least_s(256, 48, 1536, 256) / 0.2)
    assert k1.read(_ctx(CTRL, STREAM, "ctrl_sim", {"chunks": 1}, {"other": (1.0, 1)})) is None


def test_k1_reads_the_passes_of_the_configuration_and_holds_them_against_the_trace():
    k1 = harness.load_reader("k1_roofline_pct")
    three = {"eval.streaming_passes": 3}
    # the 3-pass decode: 90 steps x 4 layers x 3 passes of 16 rows each
    ctx = _ctx(CTRL, STREAM, "ctrl_sim", {"chunks": 1}, {"decode_attention_wgmma_kernel": (0.3, 1080)},
               extra=three)
    assert k1.read(ctx) == pytest.approx(100 * 90 * 4 * 3 * k1.launch_least_s(256, 16, 1536, 256) / 0.3)
    # a trace whose launches the configuration does not account for is not read
    ctx = _ctx(CTRL, STREAM, "ctrl_sim", {"chunks": 1}, {"decode_attention_wgmma_kernel": (0.3, 720)},
               extra=three)
    assert k1.read(ctx) is None
    # an f32 cache: K and V read at 4 bytes
    ctx = _ctx(CTRL, STREAM, "ctrl_sim", {"chunks": 1}, {"decode_attention_kernel": (0.4, 720)},
               extra={"model.kv_cache_dtype": "float32"})
    per_step = 4 * (k1.launch_least_s(256, 32, 1536, 256, 2, 4) + k1.launch_least_s(256, 16, 1536, 256, 2, 4))
    assert k1.read(ctx) == pytest.approx(100 * 90 * per_step / 0.4)


def test_dense_and_mlp_counts():
    assert yardstick.dense(10, 3, 4) == 240
    assert yardstick.mlp(10, 3, 4, 5) == 240 + 400


def test_mfu_train_by_hand():
    mfu = harness.load_reader("mfu.train")
    s, H, FF = CTRL, 256, 1024
    rows, A, T, P, L = 16, 24, 32, 200, 100
    n, m, mem = rows * T * A, rows * (P + A), P + A
    d = lambda t, i, o: 2 * t * i * o  # noqa: E731
    map_enc = (d(rows * P * L, 3, H) + d(rows * P * L, H, H) + 2 * d(rows * P * L, H, H) + 2 * d(rows * P, H, H)
               + 4 * rows * P * L * H + 2 * d(rows * P, H, H) + d(rows * P, 8, H) + d(rows * P, H, H)
               + d(rows * P, 2 * H, H) + d(rows * P, H, H))
    embed = (d(n, 12, H) + d(n, H, H) + d(n, 5, H) + d(n, H, H) + d(n, 2 * H, H)) + d(n, 3 * H, H)
    encoder = 2 * (4 * d(m, H, H) + 4 * rows * mem * mem * H + d(m, H, FF) + d(m, FF, H))
    decoder = 4 * (4 * d(3 * n, H, H) + 4 * rows * 2628864 * H + 2 * d(3 * n, H, H) + 4 * 3 * n * mem * H
                   + d(3 * n, H, FF) + d(3 * n, FF, H) + 2 * d(m, H, H))
    heads = d(n, H, H) + d(n, H, 1000) + d(n, H, H) + d(n, H, 1050) + d(n, H, H) + d(n, H, 64)
    step = 3 * 4 * (map_enc + embed + encoder + decoder + heads)
    ctx = _ctx(s, TRAIN, "ctrl_sim", {"steps": 10}, {"k": (0.5, 1)}, window_s=2.0)
    assert mfu.read(ctx) == pytest.approx(100 * 10 * step / 2.0 / 989e12)


def test_mfu_rollout_counts_each_step_and_the_memory_once():
    mfu = harness.load_reader("mfu.rollout")
    cfg = _cfg("ctrl_sim", STREAM)
    one = mfu.chunk_flops({**CTRL, "steps": 1}, cfg, 4, 16)
    two = mfu.chunk_flops({**CTRL, "steps": 2}, cfg, 4, 16)
    once = (yardstick.map_encoder_flops(4, CTRL) + yardstick.state_embed_flops(64, CTRL)
            + yardstick.encoder_layers_flops(4, 216, CTRL) + 4 * 2 * yardstick.dense(4 * 216, 256, 256))
    assert two - one > 0 and one > once
    assert mfu.chunk_flops({**CTRL, "steps": 1}, cfg, 8, 16) == pytest.approx(2 * one)
    ctx = _ctx(DT, STREAM, "dt", {"chunks": 3}, {"k": (0.1, 1)}, window_s=4.0)
    assert mfu.read(ctx) == pytest.approx(100 * 3 * mfu.chunk_flops(DT, _cfg("dt", STREAM), 256, 16) / 4.0 / 989e12)


def test_mfu_rollout_step_by_hand_at_step_zero():
    # one step, one lane, CtRL-Sim's fused passes at step 0 of a window of 32 over 16 slots: pass 1
    # (t-1 actions, t states) admits each state row its own step's 16 states; pass 2 (t returns)
    # each return row the 16 states and its own return
    mfu = harness.load_reader("mfu.rollout")
    s, rows, mem = {**CTRL, "steps": 1}, 16, 216
    once = (yardstick.map_encoder_flops(1, s) + yardstick.state_embed_flops(rows, s)
            + yardstick.encoder_layers_flops(1, mem, s) + 4 * 2 * yardstick.dense(mem, 256, 256))
    step = (yardstick.state_embed_flops(rows, s) + yardstick.rtg_embed_flops(rows, s)
            + 4 * yardstick.decoder_layer_flops(2 * rows, 16 * 16, mem, s)
            + 4 * yardstick.decoder_layer_flops(rows, 16 * 17, mem, s) + yardstick.heads_flops(rows, rows, 0, s))
    assert mfu.chunk_flops(s, _cfg("ctrl_sim", STREAM), 1, 16) == pytest.approx(once + step)


def test_rollout_rate_and_device_time_per_env_step_by_hand():
    # 3 chunks of 256 scenes x 90 steps in a 40 s window; the card busy 0.1-0.3 s and 0.2-0.5 s (0.4 s)
    counts = {"chunks": 3, "env_steps": 3 * 256 * 90, "window_s": 40.0}
    ctx = SimpleNamespace(counts=counts, trace=_trace([(10**8, 3 * 10**8, "a"), (2 * 10**8, 5 * 10**8, "b")],
                                                      0, 40 * 10**9))
    assert harness.load_reader("env_steps_per_s.traced").read(ctx) == pytest.approx(69120 / 40.0)
    assert harness.load_reader("device_us_per_env_step").read(ctx) == pytest.approx(0.4e6 / 69120)
