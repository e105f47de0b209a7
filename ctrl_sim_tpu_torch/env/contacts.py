"""Box2D-style contact resolution for vehicle-vehicle collisions (port of
``ctrl_sim_tpu/env/contacts.py``).

The reference steps a zero-gravity ``b2World`` with 8 velocity and 3 position
iterations (nocturne/cpp/src/physics/PhysicsSimulation.cpp:16-25); every car
is a dynamic box fixture with density 20 and Box2D's default material
(friction 0.2, restitution 0). When two vehicles touch, a sequential-impulse
solver zeroes the approaching normal velocity, applies Coulomb friction
along the tangent, and a Baumgarte pass removes the residual overlap.

The same all-pairs Jacobi solver as the JAX package, over the dense
[E, A, A] pair tensors of every scene at once (the JAX code is written per
scene and vmapped over scenes):

- contact geometry from the separating-axis test (the minimum-overlap axis
  of the 4 box axes) with a 2-point manifold mirroring b2CollidePolygons:
  the incident edge's endpoints clipped to the reference face, kept within
  the polygon skin, placed at the b2WorldManifold midpoints;
- mass and inertia of the fixture: m = rho L W, I = m (L^2 + W^2) / 12;
- 8 velocity sweeps: friction per manifold point first, then each pair's
  2-point normal LCP solved exactly (Box2D's 2x2 block solver over its four
  active-set cases);
- 3 position sweeps of Box2D's per-point pseudo-impulse correction with
  rotation, on a manifold computed once at the integrated pose.

The JAX package skips the solve for a scene without contact
(``lax.cond``); here both branches are computed for every scene and the
result is selected per scene with ``torch.where``, so nothing waits on a
value from the device. Every per-body sum over pairs is a dense reduction
(no scatter, no atomics): deterministic on the card, but in another order
than on the CPU, so the two agree to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import torch

from ctrl_sim_tpu_torch.env.dynamics import BodyState
from ctrl_sim_tpu_torch.geometry import angle_add, obb_corners

Tensor = torch.Tensor

# Box2D fixture/material constants (FreeCar.cpp:40, b2_settings defaults)
DENSITY = 20.0
FRICTION = 0.2
VELOCITY_ITERATIONS = 8
POSITION_ITERATIONS = 3
BAUMGARTE = 0.2  # b2_baumgarte
LINEAR_SLOP = 0.005  # b2_linearSlop
MAX_CORRECTION = 0.2  # b2_maxLinearCorrection
KEY_TIE = 1e-3  # m: corners this close along an edge normal lie on one edge


def _cross2(a: Tensor, b: Tensor) -> Tensor:
    """z-component of the 2-D cross product (broadcasts on leading dims)."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _dot(a: Tensor, b: Tensor) -> Tensor:
    """Dot product over the last axis (broadcasts on leading dims)."""
    return (a * b).sum(-1)


def _perp(x: Tensor) -> Tensor:
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1)


def _contact_geometry(
    position: Tensor,  # [E, A, 2]
    heading: Tensor,  # [E, A]
    length: Tensor,  # [E, A]
    width: Tensor,  # [E, A]
    active: Tensor,  # [E, A] bool
):
    """All-pairs SAT contact manifold of every scene.

    Returns (touching [E, A, A] bool on i < j, normal [E, A, A, 2] from i to
    j, points [E, A, A, 2, 2] world manifold points, point_valid [E, A, A, 2]
    skin filter, sep [E, A, A, 2] per-point separations); see
    ``ctrl_sim_tpu/env/contacts.py:_contact_geometry`` for the derivation of
    each step.
    """
    E, A = heading.shape
    corners = obb_corners(position, heading, length, width)  # [E, A, 4, 2]
    c, s = torch.cos(heading), torch.sin(heading)
    axes_own = torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)], dim=2)  # [E, A, 2, 2]

    # candidate axes per pair: i's two, then j's two -> [E, A, A, 4, 2]
    ax_i = axes_own[:, :, None].expand(E, A, A, 2, 2)
    ax_j = axes_own[:, None].expand(E, A, A, 2, 2)
    axes = torch.cat([ax_i, ax_j], dim=3)

    # both boxes' corners projected on every candidate axis: [E, A, A, 4, 4]
    proj_i = _dot(corners[:, :, None, None], axes[..., None, :])
    proj_j = _dot(corners[:, None, :, None], axes[..., None, :])
    overlap = torch.minimum(proj_i.amax(-1), proj_j.amax(-1)) - torch.maximum(
        proj_i.amin(-1), proj_j.amin(-1)
    )  # [E, A, A, 4]

    touching = (overlap > 0.0).all(-1)
    depth = overlap.amin(-1)
    kidx = torch.arange(4, device=position.device)
    is_min = overlap == depth[..., None]
    first_min = is_min & (is_min.cumsum(-1) == 1)  # argmin's tie-breaking
    kmin = (first_min * kidx).sum(-1)  # [E, A, A]
    normal = (axes * first_min[..., None]).sum(3)  # [E, A, A, 2]
    d_ij = position[:, None, :] - position[:, :, None]  # [e, i, j] = p_j - p_i
    flip = _dot(normal, d_ij) < 0.0
    normal = torch.where(flip[..., None], -normal, normal)

    # the incident box does not own the min-overlap axis (axes 0-1 are i's)
    inc_is_j = kmin < 2
    corners_i = corners[:, :, None].expand(E, A, A, 4, 2)
    corners_j = corners[:, None].expand(E, A, A, 4, 2)
    inc_corners = torch.where(inc_is_j[..., None, None], corners_j, corners_i)
    ref_corners = torch.where(inc_is_j[..., None, None], corners_i, corners_j)
    inc_axes = torch.where(inc_is_j[..., None, None], ax_j, ax_i)  # [E, A, A, 2, 2]
    # outward reference-face normal
    n_out = torch.where(inc_is_j[..., None], normal, -normal)

    # incident edge normal: the incident axis most (anti-)parallel to n_out
    d_ax = _dot(inc_axes, n_out[..., None, :])  # [E, A, A, 2]
    pick1 = d_ax[..., 1].abs() > d_ax[..., 0].abs()
    ax_pick = torch.where(pick1[..., None], inc_axes[..., 1, :], inc_axes[..., 0, :])
    d_pick = torch.where(pick1, d_ax[..., 1], d_ax[..., 0])
    e_n = -torch.sign(d_pick)[..., None] * ax_pick

    # the edge: the two corners extremal along e_n, ranked sort-free with
    # index tie-breaks. The edge's two corners project equally in exact
    # arithmetic, so the JAX package's order of them (which is manifold
    # point 0, solved first by the friction and position sweeps) follows
    # float32 rounding; here keys within KEY_TIE of each other tie, so the
    # order is the corners' index order on every device
    key = -_dot(inc_corners, e_n[..., None, :])  # [E, A, A, 4]
    diff = key[..., :, None] - key[..., None, :]
    lt = (diff > KEY_TIE) | ((diff.abs() <= KEY_TIE) & (kidx[:, None] > kidx[None, :]))
    rank = lt.sum(-1)
    edge2 = torch.stack(
        [(inc_corners * (rank == 0)[..., None]).sum(3), (inc_corners * (rank == 1)[..., None]).sum(3)],
        dim=3,
    )  # [E, A, A, 2, 2]

    # clip the incident edge to the reference face's tangent extent
    tangent = _perp(normal)
    ref_t = _dot(ref_corners, tangent[..., None, :])  # [E, A, A, 4]
    t_lo, t_hi = ref_t.amin(-1), ref_t.amax(-1)
    pt_t = _dot(edge2, tangent[..., None, :])  # [E, A, A, 2]
    pt_t_cl = torch.minimum(torch.maximum(pt_t, t_lo[..., None]), t_hi[..., None])
    points = edge2 + (pt_t_cl - pt_t)[..., None] * tangent[..., None, :]

    # keep clip points within the polygon skin (4 * linearSlop in total)
    ref_face = _dot(ref_corners, n_out[..., None, :]).amax(-1)
    sep = _dot(points, n_out[..., None, :]) - ref_face[..., None]
    point_valid = sep <= 4.0 * LINEAR_SLOP

    # world manifold point: the clip point slid half the separation back
    points = points - 0.5 * sep[..., None] * n_out[..., None, :]

    ar = torch.arange(A, device=position.device)
    upper = ar[:, None] < ar[None, :]
    touching = touching & upper & active[:, :, None] & active[:, None, :]
    return touching, normal, points, point_valid, sep


def _pair_inverse_mass(inv_m: Tensor) -> Tensor:
    """inv_m_i + inv_m_j as [E, A, A, 1] (broadcast over manifold points)."""
    return inv_m[:, :, None, None] + inv_m[:, None, :, None]


def _solve_velocities(
    velocity: Tensor,  # [E, A, 2]
    angular_velocity: Tensor,  # [E, A]
    position: Tensor,  # [E, A, 2] (pre-integration, = contact frame)
    inv_m: Tensor,  # [E, A]
    inv_i: Tensor,  # [E, A]
    touching: Tensor,  # [E, A, A] (i < j)
    normal: Tensor,  # [E, A, A, 2]
    points: Tensor,  # [E, A, A, P, 2], 2-point manifold
    point_valid: Tensor,  # [E, A, A, P]
    iterations: int,
) -> tuple[Tensor, Tensor]:
    """Accumulated-impulse Jacobi solve over the 2-point manifolds,
    restitution 0 and Coulomb friction."""
    r_i = points - position[:, :, None, None]  # [E, A, A, P, 2]
    r_j = points - position[:, None, :, None]
    n_p = normal[..., None, :]  # over the point axis
    t_p = _perp(normal)[..., None, :]
    inv_i_i, inv_i_j = inv_i[:, :, None, None], inv_i[:, None, :, None]

    rin, rjn = _cross2(r_i, n_p), _cross2(r_j, n_p)  # [E, A, A, P]
    rit, rjt = _cross2(r_i, t_p), _cross2(r_j, t_p)
    inv_m2 = _pair_inverse_mass(inv_m)
    kn = inv_m2 + rin**2 * inv_i_i + rjn**2 * inv_i_j
    kt = inv_m2 + rit**2 * inv_i_i + rjt**2 * inv_i_j
    # off-diagonal normal coupling between the two manifold points
    k12 = inv_m2[..., 0] + rin[..., 0] * rin[..., 1] * inv_i_i[..., 0] + rjn[..., 0] * rjn[..., 1] * inv_i_j[..., 0]
    solvable = touching[..., None] & (kn > 0.0) & point_valid
    kn = torch.where(kn > 0.0, kn, 1.0)
    kt = torch.where(kt > 0.0, kt, 1.0)
    # block solve only where K is well-conditioned (k_maxConditionNumber)
    det = kn[..., 0] * kn[..., 1] - k12 * k12
    well_cond = solvable.all(-1) & (kn[..., 0] * kn[..., 0] < 1000.0 * det)
    det_safe = torch.where(det.abs() > 1e-12, det, 1.0)
    perp_ri, perp_rj = _perp(r_i), _perp(r_j)  # w x r = w * perp(r)

    def apply_points(v, w, imp_n, imp_t):
        # impulse P[i, j, p] acts +P on j, -P on i; both points at once
        P = imp_n[..., None] * n_p + imp_t[..., None] * t_p  # [E, A, A, P, 2]
        Ps = P.sum(3)
        dv = Ps.sum(1) * inv_m[..., None] - Ps.sum(2) * inv_m[..., None]
        dw = (_cross2(r_j, P).sum((1, 3)) - _cross2(r_i, P).sum((2, 3))) * inv_i
        return v + dv, w + dw

    def vrel(v, w):  # relative velocity at every manifold point [E, A, A, P, 2]
        return (
            v[:, None, :, None] + perp_rj * w[:, None, :, None, None]
            - v[:, :, None, None] - perp_ri * w[:, :, None, None, None]
        )

    v, w = velocity, angular_velocity
    acc_n = torch.zeros_like(kn)
    acc_t = torch.zeros_like(kn)
    sels = torch.eye(2, dtype=kn.dtype, device=kn.device)
    for _ in range(iterations):
        # friction first, one manifold point at a time, |acc_t| <= mu acc_n
        # against the previous sweep's normal impulses
        for sel in sels:
            vt = _dot(vrel(v, w), t_p)
            dt_ = torch.where(solvable, -vt / kt, 0.0) * sel
            hi = FRICTION * acc_n
            new_t = torch.minimum(torch.maximum(acc_t + dt_, -hi), hi)
            dt_ = torch.where(sel > 0, new_t - acc_t, 0.0)
            acc_t = torch.where(sel > 0, new_t, acc_t)
            v, w = apply_points(v, w, torch.zeros_like(dt_), dt_)

        # normal impulses: the exact 2x2 block LCP per pair, over the four
        # active-set cases, selected by mask
        vn = _dot(vrel(v, w), n_p)  # [E, A, A, P]
        Ka = torch.stack(
            [kn[..., 0] * acc_n[..., 0] + k12 * acc_n[..., 1], k12 * acc_n[..., 0] + kn[..., 1] * acc_n[..., 1]],
            dim=-1,
        )
        b = vn - Ka
        x1_0 = (-kn[..., 1] * b[..., 0] + k12 * b[..., 1]) / det_safe  # both points active
        x1_1 = (k12 * b[..., 0] - kn[..., 0] * b[..., 1]) / det_safe
        ok1 = well_cond & (x1_0 >= 0.0) & (x1_1 >= 0.0)
        x2_0 = -b[..., 0] / kn[..., 0]  # point 0 only
        ok2 = (x2_0 >= 0.0) & (k12 * x2_0 + b[..., 1] >= 0.0)
        x3_1 = -b[..., 1] / kn[..., 1]  # point 1 only
        ok3 = (x3_1 >= 0.0) & (k12 * x3_1 + b[..., 0] >= 0.0)
        ok4 = (b[..., 0] >= 0.0) & (b[..., 1] >= 0.0)  # separating at both
        pick1 = ok1
        pick2 = ~pick1 & ok2
        pick3 = ~pick1 & ~pick2 & ok3
        pick4 = ~pick1 & ~pick2 & ~pick3 & ok4
        # no case valid (a numeric corner): the relaxed per-point update
        xf = torch.clamp_min(acc_n - 0.5 * vn / kn, 0.0)
        x0 = torch.where(pick1, x1_0, torch.where(pick2, x2_0, torch.where(pick3 | pick4, 0.0, xf[..., 0])))
        x1 = torch.where(pick1, x1_1, torch.where(pick3, x3_1, torch.where(pick2 | pick4, 0.0, xf[..., 1])))
        new_n = torch.where(solvable, torch.stack([x0, x1], dim=-1), 0.0)
        # ill-conditioned K: the relaxed per-point update
        deg = ~well_cond[..., None] & solvable
        new_n = torch.where(deg, xf, new_n)
        dn = new_n - acc_n
        acc_n = new_n
        v, w = apply_points(v, w, dn, torch.zeros_like(dn))
    return v, w


def _correct_positions(
    position: Tensor,  # [E, A, 2]
    heading: Tensor,  # [E, A]
    length: Tensor,
    width: Tensor,
    active: Tensor,
    inv_m: Tensor,
    inv_i: Tensor,
    iterations: int,
) -> tuple[Tensor, Tensor]:
    """Box2D-style positional correction with rotation: per manifold point,
    a pseudo-impulse -C/K along the normal (C = beta (separation + slop),
    clamped to the maximum correction) moves and rotates both bodies. The
    manifold is computed once at the integrated pose and each correction
    advances both points' separations through the pair's coupling, as the
    JAX package does."""
    touching, normal, points, point_valid, sep = _contact_geometry(position, heading, length, width, active)
    r_i = points - position[:, :, None, None]  # frozen arms
    r_j = points - position[:, None, :, None]
    n_p = normal[..., None, :]
    rin, rjn = _cross2(r_i, n_p), _cross2(r_j, n_p)  # [E, A, A, P]
    inv_i_i, inv_i_j = inv_i[:, :, None, None], inv_i[:, None, :, None]
    inv_m2 = _pair_inverse_mass(inv_m)
    kp = inv_m2 + rin**2 * inv_i_i + rjn**2 * inv_i_j
    # cross-coupling: how much point q separates when point p is pushed
    k_cross = inv_m2[..., 0] + rin[..., 0] * rin[..., 1] * inv_i_i[..., 0] + rjn[..., 0] * rjn[..., 1] * inv_i_j[..., 0]
    ok = touching[..., None] & point_valid & (kp > 0.0)
    kp_safe = torch.where(kp > 0.0, kp, 1.0)

    for _ in range(iterations):
        for p in (0, 1):
            C = torch.clamp(BAUMGARTE * (sep[..., p] + LINEAR_SLOP), -MAX_CORRECTION, 0.0)
            lam = torch.where(ok[..., p], -C / kp_safe[..., p], 0.0)  # [E, A, A] >= 0
            P = lam[..., None] * normal
            dpos = P.sum(1) * inv_m[..., None] - P.sum(2) * inv_m[..., None]
            dhd = ((rjn[..., p] * lam).sum(1) - (rin[..., p] * lam).sum(2)) * inv_i
            dsep_p, dsep_q = lam * kp[..., p], lam * k_cross
            sep = sep + torch.stack([dsep_p, dsep_q] if p == 0 else [dsep_q, dsep_p], dim=-1)
            position = position + dpos
            heading = angle_add(heading, dhd)
    return position, heading


def resolve_contacts(
    pre: BodyState,  # bodies at the start of the step, [E, A] leading axes
    proposed: BodyState,  # FreeCar-stepped bodies (velocities to correct)
    length: Tensor,  # [E, A]
    width: Tensor,  # [E, A]
    dynamic: Tensor,  # [E, A] bool: finite-mass bodies (alive, policy/replay)
    kinematic: Tensor,  # [E, A] bool: infinite-mass participants (expert teleport)
    dt: float,
) -> BodyState:
    """b2World::Step-ordered contact response for every scene: takes the
    velocities FreeCar proposed for this step, solves the contact
    constraints against the pre-step poses, and re-integrates. Scenes with
    no touching pair keep the proposed velocities and skip the position
    pass; non-dynamic bodies pass through untouched."""
    active = dynamic | kinematic
    mass = DENSITY * length * width
    inv_m = torch.where(dynamic, 1.0 / torch.clamp_min(mass, 1e-6), 0.0)
    inv_i = torch.where(dynamic, 12.0 / torch.clamp_min(mass * (length**2 + width**2), 1e-6), 0.0)

    touching, normal, points, point_valid, _ = _contact_geometry(
        pre.position, pre.heading, length, width, active
    )
    any_contact = touching.flatten(1).any(-1)  # [E]: the JAX package's lax.cond, as a select
    v, w = _solve_velocities(
        proposed.velocity, proposed.angular_velocity, pre.position, inv_m, inv_i, touching, normal,
        points, point_valid, VELOCITY_ITERATIONS,
    )
    v = torch.where(any_contact[:, None, None], v, proposed.velocity)
    w = torch.where(any_contact[:, None], w, proposed.angular_velocity)

    position = pre.position + v * dt
    heading = angle_add(pre.heading, w * dt)
    corrected = _correct_positions(position, heading, length, width, active, inv_m, inv_i, POSITION_ITERATIONS)
    position = torch.where(any_contact[:, None, None], corrected[0], position)
    heading = torch.where(any_contact[:, None], corrected[1], heading)

    speed = torch.sqrt(torch.clamp_min((v * v).sum(-1), 0.0))
    return BodyState(
        position=torch.where(dynamic[..., None], position, proposed.position),
        heading=torch.where(dynamic, heading, proposed.heading),
        speed=torch.where(dynamic, speed, proposed.speed),
        velocity=torch.where(dynamic[..., None], v, proposed.velocity),
        angular_velocity=torch.where(dynamic, w, proposed.angular_velocity),
        throttle_accel=proposed.throttle_accel,
        brake_accel=proposed.brake_accel,
    )
