"""Scene visualization (port of ``ctrl_sim_tpu/viz.py``; reference:
utils/viz.py generate_video/_frames).

Renders rollout frames with matplotlib: road polylines colored by type,
vehicle boxes with heading arrows, goals, collision highlighting; optional
mp4 via matplotlib animation (moviepy isn't assumed present); and
``feature_image``, a numpy rasterizer of the scene. Everything here runs on
the host in numpy: the functions take the port's ``Scenario`` and
``RolloutOutput`` with fields on any device and bring what they draw to
the host (``device.host``). matplotlib is imported only by the functions
that draw with it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ctrl_sim_tpu_torch.config import Config
from ctrl_sim_tpu_torch.data.scenario import DEAD_POSITION, Scenario
from ctrl_sim_tpu_torch.device import host
from ctrl_sim_tpu_torch.rollout.rollout import RolloutOutput

ROAD_COLORS = {
    0: "#cccccc",  # none
    1: "#a0a0a0",  # lane
    2: "#e0d070",  # road_line
    3: "#303030",  # road_edge
    4: "#d04040",  # stop_sign
    5: "#70a0e0",  # crosswalk
    6: "#c080c0",  # speed_bump
    7: "#cccccc",  # other
}


def _box(ax, x, y, heading, length, width, color, alpha=0.9):
    import matplotlib.transforms as mtransforms
    from matplotlib.patches import Rectangle

    rect = Rectangle(
        (-length / 2, -width / 2), length, width,
        facecolor=color, edgecolor="black", linewidth=0.5, alpha=alpha,
    )
    t = (
        mtransforms.Affine2D().rotate(heading).translate(x, y) + ax.transData
    )
    rect.set_transform(t)
    ax.add_patch(rect)
    ax.plot(
        [x, x + 0.6 * length * np.cos(heading)],
        [y, y + 0.6 * length * np.sin(heading)],
        color="white", linewidth=0.8,
    )


def render_frame(
    ax,
    scene: Scenario,
    positions: np.ndarray,  # [A, 2]
    headings: np.ndarray,  # [A]
    existence: np.ndarray,  # [A]
    controlled: np.ndarray | None = None,
    collided: np.ndarray | None = None,
    view_radius: float = 80.0,
    center: np.ndarray | None = None,
):
    """Draw one frame onto an axes."""
    positions, headings, existence = host(positions), host(headings), host(existence)
    rp = host(scene.road_points)
    rt = host(scene.road_types)
    for p in range(rp.shape[0]):
        pts = rp[p]
        valid = pts[:, 2] > 0
        if valid.sum() < 2:
            continue
        kind = int(np.argmax(rt[p])) if rt[p].max() > 0 else 7
        lw = 1.2 if kind == 3 else 0.6
        ax.plot(
            pts[valid, 0], pts[valid, 1],
            color=ROAD_COLORS.get(kind, "#cccccc"), linewidth=lw, zorder=1,
        )

    lengths = host(scene.length)
    widths = host(scene.width)
    for a in range(len(positions)):
        if existence[a] <= 0 or positions[a, 0] <= DEAD_POSITION / 2:
            continue
        if collided is not None and collided[a]:
            color = "#e04040"
        elif controlled is not None and controlled[a]:
            color = "#4080e0"
        else:
            color = "#70c070"
        _box(ax, positions[a, 0], positions[a, 1], headings[a],
             lengths[a], widths[a], color)

    goals = host(scene.goal_position)
    for a in range(len(goals)):
        if existence[a] > 0:
            ax.plot(goals[a, 0], goals[a, 1], "x", color="#e0a040", markersize=4)

    if center is None:
        live = positions[existence > 0]
        center = live.mean(axis=0) if len(live) else np.zeros(2)
    ax.set_xlim(center[0] - view_radius, center[0] + view_radius)
    ax.set_ylim(center[1] - view_radius, center[1] + view_radius)
    ax.set_aspect("equal")
    ax.set_xticks([])
    ax.set_yticks([])


def render_ego_cone(
    ax,
    scene: Scenario,
    positions: np.ndarray,  # [A, 2]
    headings: np.ndarray,  # [A]
    existence: np.ndarray,  # [A]
    ego_index: int,
    view_dist: float = 80.0,
    view_angle: float = float(np.pi) * (120.0 / 180.0),
):
    """Overlay the ego visibility cone and highlight visible agents — the
    rendering analog of Scenario::EgoVehicleConeImage (scenario.cc:742-893),
    driven by the same cone+occlusion predicate the observation API uses
    (env/observation.py). Call after render_frame on the same axes."""
    from matplotlib.patches import Wedge

    from ctrl_sim_tpu_torch.env.observation import visible_objects_mask

    positions, headings, existence = host(positions), host(headings), host(existence)
    ego = int(ego_index)
    if existence[ego] <= 0:
        return
    theta = float(headings[ego])
    ax.add_patch(
        Wedge(
            (float(positions[ego, 0]), float(positions[ego, 1])),
            view_dist,
            np.degrees(theta - view_angle / 2),
            np.degrees(theta + view_angle / 2),
            facecolor="#4080e0", alpha=0.10, edgecolor="#4080e0",
            linewidth=0.8, zorder=2,
        )
    )
    one = (positions, headings, host(scene.length), host(scene.width), existence > 0)
    vis = host(visible_objects_mask(*(torch.as_tensor(x)[None] for x in one), torch.tensor([ego]),
                                    view_dist=view_dist, view_angle=view_angle)[0])
    for a in np.where(vis)[0]:
        ax.plot(
            positions[a, 0], positions[a, 1], "o",
            markerfacecolor="none", markeredgecolor="#4080e0",
            markersize=10, zorder=5,
        )


def render_rollout(
    cfg: Config,
    scene: Scenario,
    rollout: RolloutOutput,
    env_index: int,
    out_dir: str,
    every: int = 5,
    fmt: str = "png",
) -> list[str]:
    """Render frames of one lane of a rollout to out_dir; returns paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    pos = host(rollout.position)[:, env_index]  # [T+1, A, 2]
    heading = host(rollout.heading)[:, env_index]
    exist = host(rollout.existence)[:, env_index]
    reward8 = host(rollout.reward8)[:, env_index]
    controlled = host(rollout.controlled_mask)[env_index]
    paths = []
    for t in range(0, pos.shape[0], every):
        fig, ax = plt.subplots(figsize=(6, 6), dpi=110)
        collided = reward8[min(t, reward8.shape[0] - 1), :, 6:8].sum(-1) > 0
        render_frame(ax, scene, pos[t], heading[t], exist[t],
                     controlled=controlled, collided=collided)
        ax.set_title(f"t={t}")
        path = os.path.join(out_dir, f"frame_{t:03d}.{fmt}")
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        paths.append(path)
    return paths


def render_video(
    cfg: Config, scene: Scenario, rollout: RolloutOutput, env_index: int,
    out_path: str, fps: int = 10,
) -> str:
    """mp4 via matplotlib animation (10 fps like the reference)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    pos = host(rollout.position)[:, env_index]
    heading = host(rollout.heading)[:, env_index]
    exist = host(rollout.existence)[:, env_index]
    reward8 = host(rollout.reward8)[:, env_index]
    controlled = host(rollout.controlled_mask)[env_index]

    fig, ax = plt.subplots(figsize=(6, 6), dpi=110)

    def update(t):
        ax.clear()
        collided = reward8[min(t, reward8.shape[0] - 1), :, 6:8].sum(-1) > 0
        render_frame(ax, scene, pos[t], heading[t], exist[t],
                     controlled=controlled, collided=collided)
        ax.set_title(f"t={t}")

    anim = animation.FuncAnimation(fig, update, frames=pos.shape[0])
    anim.save(out_path, fps=fps, writer="ffmpeg" if _has_ffmpeg() else "pillow")
    plt.close(fig)
    return out_path


def _has_ffmpeg() -> bool:
    import shutil

    return shutil.which("ffmpeg") is not None


# ---------------------------------------------------------------------------
# Rasterized feature images (scenario.cc:742-780 Image /
# :849-886 EgoVehicleFeaturesImage) — the reference renders these with SFML
# into uint8 canvases for image-based RL consumers; here a pure-numpy
# rasterizer produces the same surface (roads by type color, vehicle OBBs,
# stop signs/lights as dots, optional goals), either whole-scene or as the
# ego-centric rotated crop.
# ---------------------------------------------------------------------------

_ROAD_RGB = {
    0: (204, 204, 204), 1: (160, 160, 160), 2: (224, 208, 112),
    3: (64, 200, 64), 4: (208, 64, 64), 5: (112, 160, 224),
    6: (96, 200, 200), 7: (204, 204, 204),
}


def _world_to_pixel(pts, center, rot, half_extent, size):
    """[N, 2] world -> float pixel coords; view rotated by -rot so the ego
    heading points up (View(rotation = heading - 90deg)), y flipped."""
    c, s = np.cos(-rot), np.sin(-rot)
    rel = pts - center[None]
    x = c * rel[:, 0] - s * rel[:, 1]
    y = s * rel[:, 0] + c * rel[:, 1]
    px = (x / half_extent + 1.0) * 0.5 * (size - 1)
    py = (1.0 - (y / half_extent + 1.0) * 0.5) * (size - 1)  # y-flip
    return np.stack([px, py], axis=-1)


def _draw_polyline(img, pix, color):
    """Sampled line strokes (no AA): ~2 samples per pixel of length."""
    for a, b in zip(pix[:-1], pix[1:]):
        n = int(max(2, 2 * np.hypot(*(b - a))))
        ts = np.linspace(0.0, 1.0, n)
        p = a[None] * (1 - ts[:, None]) + b[None] * ts[:, None]
        ij = np.round(p).astype(int)
        ok = (
            (ij[:, 0] >= 0) & (ij[:, 0] < img.shape[1])
            & (ij[:, 1] >= 0) & (ij[:, 1] < img.shape[0])
        )
        img[ij[ok, 1], ij[ok, 0]] = color


def _fill_box(img, corners_pix, color):
    """Fill a convex quad given pixel corners [4, 2]."""
    lo = np.maximum(np.floor(corners_pix.min(0)).astype(int), 0)
    hi = np.minimum(
        np.ceil(corners_pix.max(0)).astype(int) + 1,
        [img.shape[1], img.shape[0]],
    )
    if (hi <= lo).any():
        return
    xs = np.arange(lo[0], hi[0])
    ys = np.arange(lo[1], hi[1])
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=-1).astype(float)
    inside = np.ones(len(pts), bool)
    for i in range(4):
        a, b = corners_pix[i], corners_pix[(i + 1) % 4]
        cross = (b[0] - a[0]) * (pts[:, 1] - a[1]) - (b[1] - a[1]) * (
            pts[:, 0] - a[0]
        )
        inside &= cross <= 1e-9
    if not inside.any():  # winding flipped
        inside = np.ones(len(pts), bool)
        for i in range(4):
            a, b = corners_pix[i], corners_pix[(i + 1) % 4]
            cross = (b[0] - a[0]) * (pts[:, 1] - a[1]) - (b[1] - a[1]) * (
                pts[:, 0] - a[0]
            )
            inside &= cross >= -1e-9
    ij = pts[inside].astype(int)
    img[ij[:, 1], ij[:, 0]] = color


def feature_image(
    scenario: Scenario,
    position: np.ndarray,  # [A, 2] current vehicle positions
    heading: np.ndarray,  # [A]
    alive: np.ndarray,  # [A] bool
    ego_index: int | None = None,
    img_size: int = 200,
    view_dist: float = 80.0,
    rotate_with_ego: bool = True,
    draw_goals: bool = False,
) -> np.ndarray:
    """[img_size, img_size, 3] uint8 rasterization.

    ``ego_index=None``: the whole scenario fitted into the canvas
    (Scenario::Image without a source). Otherwise the (2*view_dist)-wide
    window centered on the ego, rotated so its heading points up
    (EgoVehicleFeaturesImage's View(rotation = heading - 90)).
    """
    position = host(position)
    heading = host(heading)
    alive = host(alive)
    length = host(scenario.length)
    width = host(scenario.width)
    roads = host(scenario.road_points)  # [P, L, 3]
    road_types = host(scenario.road_types)  # [P, 8]

    img = np.zeros((img_size, img_size, 3), np.uint8)
    if ego_index is None:
        valid_pts = roads[roads[..., 2] > 0][:, :2]
        if len(valid_pts) == 0:
            valid_pts = position[alive]
        center = (valid_pts.max(0) + valid_pts.min(0)) / 2.0
        half = float(max((valid_pts.max(0) - valid_pts.min(0)).max() / 2, 1.0))
        half *= 1.05  # padding
        rot = 0.0
    else:
        center = position[ego_index]
        half = view_dist
        rot = float(heading[ego_index]) - np.pi / 2 if rotate_with_ego else 0.0

    # roads (stop-sign rows drawn as dots below)
    for p in range(roads.shape[0]):
        if road_types[p].max() <= 0:
            continue
        rtype = int(np.argmax(road_types[p]))
        pts = roads[p][roads[p][:, 2] > 0][:, :2]
        if len(pts) == 0:
            continue
        pix = _world_to_pixel(pts, center, rot, half, img_size)
        color = _ROAD_RGB.get(rtype, (204, 204, 204))
        if rtype == 4 or len(pts) == 1:  # stop sign / degenerate: dot
            ij = np.round(pix[0]).astype(int)
            if 0 <= ij[0] < img_size and 0 <= ij[1] < img_size:
                img[max(ij[1] - 1, 0) : ij[1] + 2,
                    max(ij[0] - 1, 0) : ij[0] + 2] = color
        else:
            _draw_polyline(img, pix, color)

    # traffic lights as dots (state-independent marker, like the SFML circle)
    if scenario.tl_position is not None:
        tlp = host(scenario.tl_position)
        tlv = host(scenario.tl_valid)
        for i in range(len(tlp)):
            if not tlv[i]:
                continue
            ij = np.round(
                _world_to_pixel(tlp[i : i + 1], center, rot, half, img_size)[0]
            ).astype(int)
            if 0 <= ij[0] < img_size and 0 <= ij[1] < img_size:
                img[max(ij[1] - 1, 0) : ij[1] + 2,
                    max(ij[0] - 1, 0) : ij[0] + 2] = (230, 180, 40)

    # vehicles as filled OBBs; ego in a distinct color
    c, s = np.cos(heading), np.sin(heading)
    fwd = np.stack([c, s], -1)
    left = np.stack([-s, c], -1)
    for a in np.where(alive & (position[:, 0] > DEAD_POSITION / 2))[0]:
        half_l = length[a] / 2.0
        half_w = width[a] / 2.0
        corners = np.stack(
            [
                position[a] + half_l * fwd[a] + half_w * left[a],
                position[a] + half_l * fwd[a] - half_w * left[a],
                position[a] - half_l * fwd[a] - half_w * left[a],
                position[a] - half_l * fwd[a] + half_w * left[a],
            ]
        )
        pix = _world_to_pixel(corners, center, rot, half, img_size)
        color = (
            (40, 120, 230) if ego_index is not None and a == ego_index
            else (235, 235, 235)
        )
        _fill_box(img, pix, color)

    if draw_goals:
        goals = host(scenario.goal_position)
        for a in np.where(alive)[0]:
            ij = np.round(
                _world_to_pixel(goals[a : a + 1], center, rot, half, img_size)[0]
            ).astype(int)
            if 0 <= ij[0] < img_size and 0 <= ij[1] < img_size:
                img[max(ij[1] - 1, 0) : ij[1] + 2,
                    max(ij[0] - 1, 0) : ij[0] + 2] = (60, 200, 90)

    return img
