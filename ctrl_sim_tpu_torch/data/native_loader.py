"""ctypes binding of the native C++ scenario loader (``native/scenario_loader.cc``).

``load_scenario_json_native`` parses a scenario JSON in C++ into flat
arrays and wraps them into the same ``Scenario`` that the Python loader
(``data/scenario.py:load_scenario_json``) gives: the same ``_finalize``
downstream, several times faster ingestion of large scene sets. The
``_ScenarioRaw`` layout is the one the source defines (and
``ctrl_sim_tpu/data/native_loader.py`` binds).

The library is built at first use by ``g++ -O3 -std=c++17 -fPIC -shared``
from the checkout's source into ``ctrl_sim_tpu_torch/_build/``, named by a
hash of the source and the flags (as ``ops/build.py`` names the kernels);
a library committed elsewhere, built for another machine, is never loaded.
Nothing falls back: a failed build raises, and the caller picks this
loader or the Python one explicitly.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.data.scenario import ROAD_TYPES, Scenario, _finalize
from ctrl_sim_tpu_torch.ops.build import BUILD_DIR, PACKAGE_DIR

SOURCE = PACKAGE_DIR.parent / "native" / "scenario_loader.cc"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
ROAD_TYPE_NAMES = sorted(ROAD_TYPES, key=ROAD_TYPES.get)


class _ScenarioRaw(ctypes.Structure):
    _fields_ = [
        ("num_agents", ctypes.c_int32),
        ("num_steps", ctypes.c_int32),
        ("is_physics", ctypes.c_int32),
        ("positions", ctypes.POINTER(ctypes.c_float)),
        ("headings", ctypes.POINTER(ctypes.c_float)),
        ("velocities", ctypes.POINTER(ctypes.c_float)),
        ("valid", ctypes.POINTER(ctypes.c_uint8)),
        ("length", ctypes.POINTER(ctypes.c_float)),
        ("width", ctypes.POINTER(ctypes.c_float)),
        ("type", ctypes.POINTER(ctypes.c_int32)),
        ("goal_position", ctypes.POINTER(ctypes.c_float)),
        ("goal_heading", ctypes.POINTER(ctypes.c_float)),
        ("goal_speed", ctypes.POINTER(ctypes.c_float)),
        ("rewards", ctypes.POINTER(ctypes.c_float)),
        ("actions", ctypes.POINTER(ctypes.c_float)),
        ("num_roads", ctypes.c_int32),
        ("total_road_points", ctypes.c_int32),
        ("road_points", ctypes.POINTER(ctypes.c_float)),
        ("road_offsets", ctypes.POINTER(ctypes.c_int32)),
        ("road_counts", ctypes.POINTER(ctypes.c_int32)),
        ("road_types", ctypes.POINTER(ctypes.c_int32)),
        ("num_lights", ctypes.c_int32),
        ("tl_positions", ctypes.POINTER(ctypes.c_float)),
        ("tl_state", ctypes.POINTER(ctypes.c_int8)),
        ("error", ctypes.c_char * 256),
    ]


def library_path():
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"scenario_loader_{digest.hexdigest()[:16]}.so"


def build() -> str:
    """Compile the loader if its library is missing; returns its path.
    Raises with the compiler's output when the build fails."""
    target = library_path()
    if target.exists():
        return str(target)
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found: the native scenario loader cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    return str(target)


def native_available() -> bool:
    """Whether the native loader can be used here without building
    anything new, or can be built: its library is built, or its source is
    in the checkout and a C++ compiler is on the PATH. Builds nothing."""
    if library_path().exists():
        return True
    return SOURCE.exists() and (shutil.which("g++") or shutil.which("c++")) is not None


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    lib.scenario_load.restype = ctypes.POINTER(_ScenarioRaw)
    lib.scenario_load.argtypes = [ctypes.c_char_p]
    lib.scenario_free.argtypes = [ctypes.POINTER(_ScenarioRaw)]
    return lib


def _arr(ptr, shape, dtype=np.float32) -> np.ndarray:
    n = int(np.prod(shape))
    return np.array(np.ctypeslib.as_array(ptr, shape=(n,)), dtype=dtype).reshape(shape)


def load_scenario_json_native(path: str, cfg: Config) -> Scenario:
    """Either JSON dialect parsed in C++, finalized as the Python loader
    finalizes it."""
    lib = _lib()
    raw_p = lib.scenario_load(path.encode())
    raw = raw_p.contents
    try:
        if raw.error:
            raise ValueError(f"native loader: {raw.error.decode()} ({path})")
        A, T = raw.num_agents, raw.num_steps
        positions = _arr(raw.positions, (A, T, 2))
        headings = _arr(raw.headings, (A, T))
        velocities = _arr(raw.velocities, (A, T, 2))
        valid = _arr(raw.valid, (A, T), dtype=np.uint8).astype(bool)
        length, width = _arr(raw.length, (A,)), _arr(raw.width, (A,))
        agent_type = _arr(raw.type, (A,), dtype=np.int64)
        goal_position = _arr(raw.goal_position, (A, 2))
        goal_heading, goal_speed = _arr(raw.goal_heading, (A,)), _arr(raw.goal_speed, (A,))
        rewards = actions = None
        if raw.is_physics:
            rewards = _arr(raw.rewards, (A, T, 8))
            actions = _arr(raw.actions, (A, T, 2))

        # roads back to the dict form that _finalize's chunker reads
        roads = []
        if raw.num_roads > 0:
            pts = _arr(raw.road_points, (raw.total_road_points, 2))
            offsets = _arr(raw.road_offsets, (raw.num_roads,), dtype=np.int64)
            counts = _arr(raw.road_counts, (raw.num_roads,), dtype=np.int64)
            rtypes = _arr(raw.road_types, (raw.num_roads,), dtype=np.int64)
            for r in range(raw.num_roads):
                o, c = int(offsets[r]), int(counts[r])
                name = ROAD_TYPE_NAMES[int(rtypes[r])]
                if name == "stop_sign" and c == 1:
                    geometry = {"x": float(pts[o, 0]), "y": float(pts[o, 1])}
                else:
                    geometry = [{"x": float(x), "y": float(y)} for x, y in pts[o:o + c]]
                roads.append({"geometry": geometry, "type": name})

        # traffic lights: the C side expands them to dense [L, T] states; they
        # go back through _finalize as dense (state, time_index) streams
        tl_states = None
        if raw.num_lights > 0:
            L = raw.num_lights
            tl_pos = _arr(raw.tl_positions, (L, 2))
            tl_st = _arr(raw.tl_state, (L, T), dtype=np.int8)
            tl_states = [{"x": [float(tl_pos[i, 0])], "y": [float(tl_pos[i, 1])],
                          "state": [int(s) for s in tl_st[i]], "time_index": list(range(T))} for i in range(L)]

        speed = np.linalg.norm(velocities, axis=-1)
        if not raw.is_physics:
            # raw dialect: drop non-vehicles and agents invalid at the start,
            # as LoadObjects does (scenario.cc:954-957)
            keep = valid[:, 0] & ((agent_type == 1) if not cfg.sim.allow_non_vehicles else np.ones(A, bool))
            positions, headings, speed, valid = positions[keep], headings[keep], speed[keep], valid[keep]
            length, width, agent_type = length[keep], width[keep], agent_type[keep]
            goal_position, goal_heading, goal_speed = goal_position[keep], goal_heading[keep], goal_speed[keep]

        f64 = lambda x: x.astype(np.float64)  # noqa: E731
        return _finalize(
            cfg, f64(positions), f64(headings), f64(speed), valid, f64(length), f64(width), agent_type,
            f64(goal_position), f64(goal_heading), f64(goal_speed), roads, path,
            rewards=None if rewards is None else f64(rewards),
            actions=None if actions is None else f64(actions),
            tl_states=tl_states,
        )
    finally:
        lib.scenario_free(raw_p)
