"""2-D geometry on batched tensors (port of ``ctrl_sim_tpu/geometry.py``).

Angle ops, SE(2), oriented bounding boxes with the strict SAT test
(reference: geometry/polygon.cc:19-96), the rectangle-vs-segment test in
its support form (``obb_segment_hits``, which collision runs;
intersection.cc:200-232), and the Waymo signed distance to many polylines
(utils/data.py:185-290).
Same predicates and arithmetic order as the JAX functions, written for
leading batch axes instead of ``vmap``.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

TWO_PI = 2.0 * math.pi

# ---------------------------------------------------------------------------
# Angles and SE(2)
# ---------------------------------------------------------------------------


def angle_sub(current: Tensor, target: Tensor) -> Tensor:
    """Minimum signed angle from ``current`` to ``target``
    (reference: utils/geometry.py:3-19)."""
    diff = torch.remainder(target - current, TWO_PI)
    return torch.where(diff > math.pi, diff - TWO_PI, diff)


def normalize_angle(angle: Tensor) -> Tensor:
    """Wrap to (-pi, pi] (reference: geometry_utils.h NormalizeAngle)."""
    wrapped = torch.remainder(angle, TWO_PI)
    return torch.where(wrapped > math.pi, wrapped - TWO_PI, wrapped)


def angle_add(a: Tensor, b: Tensor) -> Tensor:
    """Angle addition with wrapping (reference: geometry_utils.h AngleAdd)."""
    return normalize_angle(a + b)


def apply_se2(coordinates: Tensor, translation: Tensor, yaw: Tensor) -> Tensor:
    """Rotate (coordinates - translation) counterclockwise by ``yaw``
    (reference: utils/geometry.py:36-47).

    coordinates [B, ..., 2]; translation [B, 2] or broadcastable to
    coordinates; yaw [B] — one frame per leading batch row (the JAX
    function is vmapped over that axis by its callers)."""
    shifted = coordinates - translation
    extra = coordinates.dim() - yaw.dim()
    c = torch.cos(yaw).reshape(yaw.shape + (1,) * (extra - 1))
    s = torch.sin(yaw).reshape(yaw.shape + (1,) * (extra - 1))
    x, y = shifted[..., 0], shifted[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def cross2(a: Tensor, b: Tensor) -> Tensor:
    """Signed magnitude of the 2-D cross product."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def dot2(a: Tensor, b: Tensor) -> Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


# ---------------------------------------------------------------------------
# Oriented bounding boxes
# ---------------------------------------------------------------------------


def obb_corners(position: Tensor, heading: Tensor, length: Tensor, width: Tensor) -> Tensor:
    """Counterclockwise corners of the vehicle bounding box, [..., 4, 2]
    (reference: object.cc:14-28 Object::BoundingPolygon)."""
    hl, hw = length * 0.5, width * 0.5
    half = torch.stack(
        [
            torch.stack([hl, hw], dim=-1),
            torch.stack([-hl, hw], dim=-1),
            torch.stack([-hl, -hw], dim=-1),
            torch.stack([hl, -hw], dim=-1),
        ],
        dim=-2,
    )  # [..., 4, 2]
    c = torch.cos(heading)[..., None]
    s = torch.sin(heading)[..., None]
    rotated = torch.stack(
        [half[..., 0] * c - half[..., 1] * s, half[..., 0] * s + half[..., 1] * c],
        dim=-1,
    )
    return rotated + position[..., None, :]


def _separates(edges_p0: Tensor, edges_d: Tensor, verts: Tensor) -> Tensor:
    """True per edge (e0, d) of polygon A if every vertex of polygon B lies
    strictly right of it (reference: polygon.cc:19-27)."""
    rel = verts[..., None, :, :] - edges_p0[..., :, None, :]  # [..., E, V, 2]
    crosses = cross2(rel, edges_d[..., :, None, :])
    return (crosses > 0.0).all(dim=-1)


def _poly_edges(corners: Tensor) -> tuple[Tensor, Tensor]:
    nxt = torch.roll(corners, shifts=-1, dims=-2)
    return corners, nxt - corners


def obb_obb_intersects(corners_a: Tensor, corners_b: Tensor) -> Tensor:
    """SAT intersection test for counterclockwise convex quads, broadcastable
    (reference: polygon.cc:82-96). Touching counts as intersecting."""
    corners_a, corners_b = torch.broadcast_tensors(corners_a, corners_b)
    a0, ad = _poly_edges(corners_a)
    b0, bd = _poly_edges(corners_b)
    sep_a = _separates(a0, ad, corners_b).any(dim=-1)
    sep_b = _separates(b0, bd, corners_a).any(dim=-1)
    return ~(sep_a | sep_b)


def _box_edges(position: Tensor, heading: Tensor, length: Tensor, width: Tensor):
    """Per box edge (outward normal perp_t [..., A, 2], threshold [..., A]) in
    obb_corners' CCW order: a point x is strictly outside edge k iff
    dot(x, perp_t) > threshold."""
    c, s = torch.cos(heading), torch.sin(heading)
    u = torch.stack([c, s], -1)  # box long axis
    w = torch.stack([-s, c], -1)  # box lateral axis
    hl = (length * 0.5)[..., None]
    hw = (width * 0.5)[..., None]
    out = []
    for tdir, e0_off in (
        (-u, u * hl + w * hw),  # edge 0: c0 -> c1
        (-w, -u * hl + w * hw),  # edge 1: c1 -> c2
        (u, -u * hl - w * hw),  # edge 2: c2 -> c3
        (w, u * hl - w * hw),  # edge 3: c3 -> c0
    ):
        perp_t = torch.stack([tdir[..., 1], -tdir[..., 0]], -1)
        thresh = ((position + e0_off) * perp_t).sum(-1)
        out.append((perp_t, thresh))
    return u, w, out


def obb_segment_hits(
    position: Tensor,  # [..., A, 2]
    heading: Tensor,  # [..., A]
    length: Tensor,  # [..., A]
    width: Tensor,  # [..., A]
    seg_p0: Tensor,  # [..., S, 2]
    seg_p1: Tensor,  # [..., S, 2]
) -> Tensor:
    """All-pairs rectangle-vs-segment intersection, [..., A, S] — the
    support-function form of ``ctrl_sim_tpu.geometry.obb_segment_hits``
    (intersection.cc:200-232), including the degenerate-segment
    point-containment fallback."""
    u, w, edges = _box_edges(position, heading, length, width)
    hl = length * 0.5
    hw = width * 0.5

    d = seg_p1 - seg_p0  # [..., S, 2]
    degenerate = (d == 0.0).all(dim=-1)  # [..., S]
    pd = torch.stack([d[..., 1], -d[..., 0]], -1)  # dot(x, pd) = cross(x, d)

    # (1) all corners strictly on one side of the segment's line
    pdT = pd.transpose(-1, -2)
    center_pd = position @ pdT  # [..., A, S]
    spread = (u @ pdT).abs() * hl[..., None] + (w @ pdT).abs() * hw[..., None]
    base = (seg_p0 * pd).sum(-1)[..., None, :]  # [..., 1, S]
    cross_max = center_pd + spread - base
    cross_min = center_pd - spread - base
    all_one_side = (cross_max < 0.0) | (cross_min > 0.0)

    # (2) both endpoints strictly outside one box edge; (3) containment of a
    # degenerate segment's point = inside all four edges
    outside = torch.zeros_like(all_one_side)
    inside_all = torch.ones_like(all_one_side)
    for perp_t, thresh in edges:
        v0 = perp_t @ seg_p0.transpose(-1, -2)  # [..., A, S]
        v1 = perp_t @ seg_p1.transpose(-1, -2)
        th = thresh[..., None]
        outside = outside | ((v0 > th) & (v1 > th))
        inside_all = inside_all & (v0 <= th)

    hit = ~(all_one_side | outside)
    return torch.where(degenerate[..., None, :], inside_all, hit)


# ---------------------------------------------------------------------------
# Signed distance to polyline boundary (Waymo off-road convention)
# ---------------------------------------------------------------------------


def signed_distance_to_polylines(xys: Tensor, polylines: Tensor, valids: Tensor) -> Tensor:
    """Signed distance from query points to the nearest of many padded
    polylines (reference: utils/data.py:185-290): negative inside the
    drivable boundary, positive off-road; the polylines wind CCW.

    xys [E, N, 2]; polylines [E, K, P, 2]; valids [E, K, P] bool (prefix
    masks). Returns [E, N]. A polyline with fewer than 2 valid vertices
    gives +1e10 (no constraint); the result is the per-point value of
    smallest magnitude.
    """
    large = 1e10
    E, K, P, _ = polylines.shape
    num_valid = valids.sum(-1)  # [E, K]
    seg_valid = valids[..., :-1] & valids[..., 1:]  # [E, K, S]

    first = polylines[..., 0, :]
    last_idx = (num_valid - 1).clamp(min=0)
    last = torch.gather(polylines, 2, last_idx[..., None, None].expand(E, K, 1, 2))[..., 0, :]
    is_cyclic = ((first - last) ** 2).sum(-1) < 1.0  # [E, K]

    starts = polylines[..., :-1, :][:, :, None]  # [E, K, 1, S, 2]
    ends = polylines[..., 1:, :][:, :, None]
    stp = xys[:, None, :, None, :] - starts  # [E, K, N, S, 2]
    ste = ends - starts  # [E, K, 1, S, 2]

    denom = dot2(ste, ste)
    pos = denom > 0.0
    rel_t = torch.where(pos, dot2(stp, ste) / torch.where(pos, denom, torch.ones_like(denom)), torch.zeros_like(denom))
    n = torch.sign(cross2(stp, ste))  # [E, K, N, S]
    clamped = rel_t.clamp(0.0, 1.0)[..., None]
    diff = stp - ste * clamped
    dist_seg = torch.sqrt(dot2(diff, diff).clamp(min=0.0))
    dist_seg = torch.where(seg_valid[:, :, None, :], dist_seg, large)

    last_seg_idx = (num_valid - 2).clamp(min=0)  # [E, K]
    ste0 = ste[:, :, 0]  # [E, K, S, 2]
    last_seg = torch.gather(ste0, 2, last_seg_idx[..., None, None].expand(E, K, 1, 2))
    padded = torch.cat([last_seg, ste0, ste0[:, :, :1]], dim=2)  # [E, K, S+2, 2]
    convex = cross2(padded[:, :, :-1], padded[:, :, 1:]) > 0.0  # [E, K, S+1]

    N = xys.shape[1]
    n_last = torch.gather(n, 3, last_seg_idx[:, :, None, None].expand(E, K, N, 1))
    n_first = n[..., :1]
    cyc = is_cyclic[:, :, None, None]
    n_prior = torch.cat([torch.where(cyc, n_last, n_first), n[..., :-1]], dim=-1)
    n_next_tail = torch.where(cyc, n_first, n_last)
    n_next = torch.cat([n[..., 1:], n_next_tail], dim=-1)
    seg_ids = torch.arange(n.shape[-1], device=n.device)
    n_next = torch.where(seg_ids == last_seg_idx[:, :, None, None], n_next_tail, n_next)

    before = torch.where(convex[:, :, None, :-1], torch.maximum(n, n_prior), torch.minimum(n, n_prior))
    after = torch.where(convex[:, :, None, 1:], torch.maximum(n, n_next), torch.minimum(n, n_next))
    sign_seg = torch.where(rel_t < 0.0, before, torch.where(rel_t < 1.0, n, after))

    min_dist, closest = dist_seg.min(dim=-1)  # [E, K, N]
    sign = torch.gather(sign_seg, 3, closest[..., None])[..., 0]
    per_poly = torch.where(num_valid[:, :, None] >= 2, sign * min_dist, large)  # [E, K, N]
    best = per_poly.abs().argmin(dim=1)  # [E, N]
    return torch.gather(per_poly, 1, best[:, None])[:, 0]
