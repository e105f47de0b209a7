"""Traffic lights (reference: nocturne/cpp/{src,include}/traffic_light.*;
port of ``ctrl_sim_tpu/env/traffic_lights.py``).

The reference parses per-lane timestamped 9-state lights from the scenario
JSON's ``tl_states`` (scenario.cc:222-241) and exposes the state at the
current step. The CtRL-Sim datasets are the no-TL Waymo exports
(``formatted_json_v2_no_tl_*``), so lights never reach its training or
evaluation; this module keeps the simulator's surface: the dense arrays,
the per-step state query and the observation's visible-light features.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ctrl_sim_tpu_torch.env.observation import nearest_k, one_hot

Tensor = torch.Tensor

# TrafficLightState enum (traffic_light.h:21-31)
TL_UNKNOWN = 0
TL_STOP = 1
TL_CAUTION = 2
TL_GO = 3
TL_ARROW_STOP = 4
TL_ARROW_CAUTION = 5
TL_ARROW_GO = 6
TL_FLASHING_STOP = 7
TL_FLASHING_CAUTION = 8

_STATE_NAMES = {
    "unknown": TL_UNKNOWN,
    "stop": TL_STOP,
    "caution": TL_CAUTION,
    "go": TL_GO,
    "arrow_stop": TL_ARROW_STOP,
    "arrow_caution": TL_ARROW_CAUTION,
    "arrow_go": TL_ARROW_GO,
    "flashing_stop": TL_FLASHING_STOP,
    "flashing_caution": TL_FLASHING_CAUTION,
}


class TrafficLights(NamedTuple):
    """Dense light arrays of one scene (padded)."""

    position: Tensor  # [L, 2]
    state: Tensor  # [L, T] int8: the state at each step (TL_UNKNOWN where none is recorded)
    valid: Tensor  # [L] bool

    @staticmethod
    def empty(num_lights: int = 1, num_steps: int = 91, device: torch.device | str = "cpu") -> "TrafficLights":
        return TrafficLights(
            position=torch.zeros((num_lights, 2), device=device),
            state=torch.zeros((num_lights, num_steps), dtype=torch.int8, device=device),
            valid=torch.zeros((num_lights,), dtype=torch.bool, device=device),
        )


def parse_tl_states_np(
    tl_json: list, num_steps: int, max_lights: int | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Numpy core of the ``tl_states`` parse (scenario.cc:222-241): each
    entry has x[.], y[.] (static: the first element is used), state[.] and
    time_index[.] streams. Returns (position [L, 2] f32, state [L, T] int8,
    valid [L] bool)."""
    n = len(tl_json)
    L = max_lights or max(n, 1)
    position = np.zeros((L, 2), np.float32)
    state = np.zeros((L, num_steps), np.int8)
    valid = np.zeros((L,), bool)
    for i, tl in enumerate(tl_json[:L]):
        position[i] = [float(tl["x"][0]), float(tl["y"][0])]
        valid[i] = True
        for s, t in zip(tl["state"], tl["time_index"]):
            ti = int(t)
            if 0 <= ti < num_steps:
                state[i, ti] = _STATE_NAMES.get(s.lower(), TL_UNKNOWN) if isinstance(s, str) else int(s)
    return position, state, valid


def parse_tl_states(
    tl_json: list, num_steps: int, max_lights: int | None = None, device: torch.device | str = "cpu"
) -> TrafficLights:
    """The JSON ``tl_states`` list as TrafficLights on ``device``."""
    position, state, valid = parse_tl_states_np(tl_json, num_steps, max_lights)
    return TrafficLights(*(torch.as_tensor(x, device=device) for x in (position, state, valid)))


def state_at(lights: TrafficLights, t: int | Tensor) -> Tensor:
    """[..., L] light state at step t (TrafficLight::set_current_time
    query) of lights whose fields may lead with a scene axis. Indexed as the
    JAX package indexes: t past the last step reads the last, a negative t
    counts from the end (``lax.dynamic_index_in_dim``)."""
    T = lights.state.shape[-1]
    t = torch.clamp_max(torch.as_tensor(t, device=lights.state.device).long(), T - 1)
    t = torch.clamp(torch.where(t < 0, t + T, t), 0, T - 1)
    return lights.state.index_select(-1, t.reshape(1)).squeeze(-1)


def visible_light_features(
    lights: TrafficLights,  # fields [E, L, ...]
    t: int | Tensor,
    ego_position: Tensor,  # [E, 2]
    ego_heading: Tensor,  # [E]
    max_visible: int = 20,
) -> Tensor:
    """[E, max_visible, 12] nearest-first light features, [valid, dist,
    azimuth, 9-state one-hot] (scenario.cc:184-205
    ExtractTrafficLightFeature); the JAX function vmapped over scenes."""
    rel = lights.position - ego_position[:, None]
    dist = torch.sqrt((rel * rel).sum(-1))
    azimuth = torch.atan2(rel[..., 1], rel[..., 0]) - ego_heading[:, None]
    azimuth = torch.remainder(azimuth + math.pi, 2 * math.pi) - math.pi
    feats = torch.cat(
        [lights.valid[..., None].float(), dist[..., None], azimuth[..., None],
         one_hot(state_at(lights, t), 9, torch.float32)],
        dim=-1,
    )
    key = torch.where(lights.valid, dist, torch.full_like(dist, math.inf))
    return nearest_k(feats, key, max_visible)
