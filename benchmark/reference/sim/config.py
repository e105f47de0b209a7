"""Configuration of the PyTorch port: the dataclasses the streaming rollout
and the trainer read.

A copy of the JAX package's ``ctrl_sim_tpu/config.py``: the simulator,
dataset, model, CTG++ diffusion, training, policy and evaluation sections,
with the same field names and defaults (``tests/test_torch_env.py`` holds them
equal). The port keeps its own copy so that it imports nothing of the JAX
package. Overrides compose through ``load_config`` with dotted keys.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


# ---------------------------------------------------------------------------
# Simulator / environment
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RewardConfig:
    """Reward shaping constants (reference: cfgs/config.yaml `nocturne.rew_cfg`)."""

    shared_reward: bool = False
    goal_tolerance: float = 0.5
    reward_scaling: float = 1.0
    collision_penalty: float = 0.0
    shaped_goal_distance_scaling: float = 0.2
    shaped_goal_distance: bool = True
    goal_distance_penalty: bool = False
    position_target: bool = True
    position_target_tolerance: float = 1.0
    speed_target: bool = True
    speed_target_tolerance: float = 1.0
    heading_target: bool = True
    heading_target_tolerance: float = 0.3


@dataclass(frozen=True)
class PhysicsConfig:
    """FreeCar physics constants (reference: nocturne/cpp/include/physics/defines.h)."""

    max_speed: float = 50.0
    max_reverse_speed: float = -5.0
    max_throttle_accel: float = 1.0
    max_throttle_reverse_accel: float = 0.0
    max_brake_accel: float = 1.0
    side_speed_damping: float = 25.0
    angular_damping: float = 10.0
    brake_deadband: float = 0.001  # FreeCar::Brake ignores |value|<0.001


@dataclass(frozen=True)
class SimConfig:
    """Environment stepping constants (reference: cfgs/config.yaml `nocturne`)."""

    steps: int = 90
    dt: float = 0.1
    history_steps: int = 10
    collision_fix: bool = True  # use split veh/edge collision flags
    allow_non_vehicles: bool = False
    moving_threshold: float = 0.2  # goal at least this far from initial position
    speed_threshold: float = 0.05  # or speed above this at some point
    # dynamics contract: 'kinematic' replicates Object::KinematicBicycleStep
    # (object.cc:126); 'physics' replicates the Box2D FreeCar velocity-level
    # model (FreeCar.cpp:98-181) used by the reference eval / data-gen path.
    dynamics: str = "physics"
    # Box2D-style impulse contact resolution between vehicles
    # (env/contacts.py; PhysicsSimulation.cpp:16-25 b2World::Step(dt, 8, 3)).
    # ON by default: the reference always simulates contacts (every vehicle
    # is physics_simulated, evaluators/evaluator.py:33-41), and the solver is
    # pinned to executed Box2D streams (tests/test_physics_goldens.py).
    # Switching off is a perf knob for pure collision-as-reward rollouts.
    resolve_contacts: bool = True
    max_agents: int = 24  # padded agent axis of the batched env
    max_road_edge_segments: int = 1024  # padded road-edge segment soup
    rewards: RewardConfig = field(default_factory=RewardConfig)
    physics: PhysicsConfig = field(default_factory=PhysicsConfig)


# ---------------------------------------------------------------------------
# Dataset / tokenization
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WaymoDatasetConfig:
    """All tokenization / normalization constants
    (reference: cfgs/dataset/waymo/base.yaml)."""

    train_context_length: int = 32
    num_agent_types: int = 5
    num_road_types: int = 8
    map_attr: int = 2
    k_attr: int = 7
    agent_dist_threshold: float = 60.0
    map_dist_threshold: float = 100.0
    max_timestep: int = 90
    parked_car_velocity_threshold: float = 0.05
    max_accel: float = 10.0
    min_accel: float = -10.0
    max_steer: float = 0.7
    min_steer: float = -0.7

    max_veh_veh_distance: float = 15.0
    dist_to_road_edge_scaling_factor: float = 15.0
    veh_veh_collision_rew_multiplier: float = 10.0
    veh_edge_collision_rew_multiplier: float = 10.0
    pos_goal_shaped_min: float = 0.0
    pos_goal_shaped_max: float = 0.2
    pos_target_achieved_rew_multiplier: float = 10.0
    moving_threshold: float = 0.05

    min_rtg_pos: float = 0.0
    max_rtg_pos: float = 10.0
    min_rtg_veh: float = -10.0
    max_rtg_veh: float = 90.0
    min_rtg_road: float = -10.0
    max_rtg_road: float = 90.0

    max_num_agents: int = 24
    max_num_road_polylines: int = 200
    max_num_road_pts_per_polyline: int = 100
    accel_discretization: int = 20
    steer_discretization: int = 50
    rtg_discretization: int = 350

    goal_dim: int = 5
    remove_shaped_goal: bool = True
    remove_shaped_veh_reward: bool = False
    remove_shaped_edge_reward: bool = False

    # CTG++ additions (cfgs/dataset/waymo/ctg_plus_plus.yaml)
    input_horizon: int = 10
    ctg_action_dim: int = 2  # continuous (accel, steer)
    future_relative_encoding: bool = False
    pos_div: float = 100.0  # state_normalizer.pos_div
    vel_div: float = 40.0  # state_normalizer.vel_div

    # finetuning (cfgs/dataset/waymo/ctrl_sim_finetuning.yaml)
    replay_ratio: float = 0.5
    center_on_focal_agent: bool = True
    supervise_focal_agent: bool = True

    # anchor the training frame at episode start (the streaming rollout's
    # frame) instead of the window start
    episode_start_normalization: bool = False

    @property
    def action_dim(self) -> int:
        return self.accel_discretization * self.steer_discretization


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """CtRL-Sim transformer config (reference: cfgs/model/{base,ctrl_sim}.yaml)."""

    hidden_dim: int = 256
    map_attr: int = 3  # note: the reference model reads its own map_attr=3
    num_road_types: int = 8
    no_actions: bool = False
    num_heads: int = 8
    num_reward_components: int = 3
    dim_feedforward: int = 1024
    dropout: float = 0.1
    state_dim: int = 12  # 7 kinematic features + 5 agent-type one-hot
    use_map: bool = True
    goal_dropout: float = 0.1
    supervise_moving: bool = True
    predict_rtg: bool = True
    attend_own_return_action: bool = False
    # model-family flags (DT / IL / trajeglish are token-layout variants)
    trajeglish: bool = False
    il: bool = False
    ctg_plus_plus: bool = False
    decision_transformer: bool = False

    num_transformer_encoder_layers: int = 2
    num_decoder_layers: int = 4
    predict_future_states: bool = True
    local_frame_predictions: bool = False
    loss_action_coef: float = 1.0
    encode_initial_state: bool = True

    # CTG++ diffusion fields (cfgs/model/ctg_plus_plus.yaml)
    diffusion_type: str = "states_actions"
    n_diffusion_steps: int = 100
    action_weight: float = 10.0
    loss_discount: float = 1.0
    predict_epsilon: bool = False
    returns_condition: bool = True
    condition_dropout: float = 0.25
    condition_guidance_w: float = 1.2
    test_ret: float = 0.9
    n_eval_diffusion_step: int = 50
    use_rtg: bool = False

    # numeric policy: params in fp32, activations and matmuls in compute_dtype
    compute_dtype: str = "bfloat16"
    # streaming KV-cache storage: "int8" holds per-token quantized K/V with
    # fp32 scales (kernel K2); any other value holds compute_dtype (kernel K1)
    kv_cache_dtype: str = "bfloat16"
    # dtype of the stored cross-attention score matrix: float32 = exact;
    # bfloat16 rounds the stored scores and exp outputs, reductions stay f32
    cross_score_dtype: str = "float32"
    # the fields below are read by the JAX package's training and TPU paths;
    # the port keeps them so that both configs have the same fields
    use_pallas_attention: bool = True
    remat: bool = False
    use_flash_attention: bool = True
    flash_block_q: int = 128
    flash_interpret: bool = False

    @property
    def num_token_types(self) -> int:
        if self.trajeglish:
            return 1
        if self.il:
            return 2
        return 3

    @property
    def state_token_index(self) -> int:
        # DT layout: (rtg, state, action); default: (state, rtg, action)
        return 1 if self.decision_transformer else 0


@dataclass(frozen=True)
class DiffusionConfig:
    """CTG++ diffusion baseline (reference: cfgs/model/ctg_plus_plus.yaml).
    The models read the diffusion settings of ``ModelConfig``; this section
    is kept so that a CTG++ ``config.json`` of either package reads whole."""

    diffusion_type: str = "states_actions"
    n_diffusion_steps: int = 100
    action_weight: float = 10.0
    loss_discount: float = 1.0
    predict_epsilon: bool = False
    returns_condition: bool = True
    condition_dropout: float = 0.25
    condition_guidance_w: float = 1.2
    test_ret: float = 0.9
    n_eval_diffusion_step: int = 50
    future_len: int = 22
    history_len: int = 10


@dataclass(frozen=True)
class TrainConfig:
    """Reference: cfgs/train/base.yaml (+ finetuning variant)."""

    seed: int = 0
    max_steps: int = 200_000
    warmup_steps: int = 500
    lr: float = 5e-4
    weight_decay: float = 1e-4
    gradient_clip_val: float = 10.0
    global_batch_size: int = 64
    # microbatch gradient accumulation: each step runs accum_steps
    # sequential microbatches of global_batch_size / accum_steps (the
    # reference's global 64 = 16 x 4 GPUs; one card uses 16 x 4 accumulation)
    accum_steps: int = 1
    check_val_every_n_steps: int = 2000
    finetuning: bool = False
    replay_ratio: float = 0.5
    save_dir: str = "checkpoints"
    keep_last_n: int = 2
    # metrics always go to save_dir/metrics.jsonl; the JAX package's wandb
    # mirror (track) is not ported
    track: bool = False
    log_grad_norms: bool = False


@dataclass(frozen=True)
class TiltConfig:
    """Exponential tilting of predicted RTG distributions
    (reference: cfgs/policy/ctrl_sim*.yaml)."""

    tilt: bool = True
    goal_tilt: float = 0.0
    veh_veh_tilt: float = 0.0
    veh_edge_tilt: float = 0.0


@dataclass(frozen=True)
class PolicyConfig:
    """Rollout-time policy config (reference: cfgs/policy/*.yaml)."""

    use_rtg: bool = True
    predict_rtgs: bool = True
    discretize_rtgs: bool = True
    real_time_rewards: bool = False
    privileged_return: bool = False
    max_return: bool = False
    min_return: bool = False
    action_temperature: float = 1.0
    nucleus_sampling: bool = False
    nucleus_threshold: float = 0.8
    tilt: TiltConfig = field(default_factory=TiltConfig)
    ctg_goal_guidance: float = 0.0
    ctg_collision_guidance: float = 0.0
    ctg_collision_radius: float = 4.0


@dataclass(frozen=True)
class EvalConfig:
    """Reference: cfgs/eval/base.yaml."""

    seed: int = 0
    history_steps: int = 10
    interesting_traj_len_threshold: int = 60
    interesting_goal_dist_threshold: float = 10.0
    interesting_timestep_diff_threshold: int = 20
    multi_agent_eval_threshold: int = 8
    num_files_to_evaluate: int = 1000
    eval_mode: str = "multi_agent"  # one_agent | two_agent | multi_agent
    # rollout execution mode: 'exact' (re-normalized sliding window) or
    # 'streaming' (fixed frame + KV-cached decode; the port runs this one)
    rollout_mode: str = "exact"
    allow_normalization_mismatch: bool = False
    # streaming sub-pass structure of the default family: 2 = the t-1 action
    # tokens ride the t state pass; 3 = sequential decode (not ported yet)
    streaming_passes: int = 2
    # packed agent slots (streaming rollout only): 0 = waymo.max_num_agents
    # slots; N packs the N closest in-range agents into N model slots
    # (rollout/groups.py:packed_trivial_groups states the overflow rule)
    agent_slots: int = 0


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Config:
    sim: SimConfig = field(default_factory=SimConfig)
    waymo: WaymoDatasetConfig = field(default_factory=WaymoDatasetConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    policy: PolicyConfig = field(default_factory=PolicyConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    def replace(self, **updates: Any) -> "Config":
        return dataclasses.replace(self, **updates)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)


def _set_dotted(cfg: Any, key: str, value: Any) -> Any:
    """Return a copy of ``cfg`` with dotted ``key`` (e.g. 'model.hidden_dim')
    replaced by ``value``."""
    head, _, rest = key.partition(".")
    if not rest:
        return dataclasses.replace(cfg, **{head: value})
    sub = getattr(cfg, head)
    return dataclasses.replace(cfg, **{head: _set_dotted(sub, rest, value)})


def load_config(overrides: dict | None = None) -> Config:
    """Build a Config with optional dotted-key overrides.

    >>> cfg = load_config({"model.hidden_dim": 64, "sim.dynamics": "kinematic"})
    """
    cfg = Config()
    for key, value in (overrides or {}).items():
        cfg = _set_dotted(cfg, key, value)
    return cfg


def config_from_dict(data: dict) -> Config:
    """The Config a ``config.json`` snapshot describes (``Config.to_dict``
    of the port or of the JAX package); a section or field the port does
    not know raises."""
    cfg = Config()

    def walk(prefix: str, tree: dict) -> None:
        nonlocal cfg
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(f"{prefix}{key}.", value)
            else:
                cfg = _set_dotted(cfg, f"{prefix}{key}", value)

    walk("", data)
    return cfg


_NO_RTG_HEADS = {"model.predict_future_states": False, "model.predict_rtg": False, "policy.predict_rtgs": False}
# the reference's cfgs/model/{dt,il,trajeglish,ctg_plus_plus}.yaml
_PRESETS = {
    "ctrl_sim": {},
    "dt": {
        "model.decision_transformer": True, **_NO_RTG_HEADS,
        "policy.discretize_rtgs": False, "policy.real_time_rewards": True, "policy.max_return": True,
        "policy.tilt": TiltConfig(tilt=False),
    },
    "il": {"model.il": True, **_NO_RTG_HEADS, "policy.use_rtg": False, "policy.tilt": TiltConfig(tilt=False)},
    "trajeglish": {
        "model.trajeglish": True, **_NO_RTG_HEADS, "policy.use_rtg": False, "policy.tilt": TiltConfig(tilt=False),
    },
    # cfgs/train/ctg_plus_plus.yaml: lr 2e-4, gradient_accumulate_every 2
    "ctg_plus_plus": {
        "model.ctg_plus_plus": True, "model.predict_rtg": False, "model.num_transformer_encoder_layers": 2,
        "policy.predict_rtgs": False, "train.lr": 2e-4, "train.accum_steps": 2,
    },
}


def preset(name: str) -> Config:
    """The configuration of a model family: CtRL-Sim, DT, IL, trajeglish or
    CTG++."""
    if name not in _PRESETS:
        raise ValueError(f"unknown preset: {name!r}")
    return load_config(_PRESETS[name])
