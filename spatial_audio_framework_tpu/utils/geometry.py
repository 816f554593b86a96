"""Geometry: spherical/cartesian conversions, Euler/quaternion rotations.

Counterpart of ``saf_utility_geometry.h/.c``.  All functions are
backend-agnostic: they accept NumPy or JAX arrays and return the same kind
(design-time code uses NumPy; traced process-paths pass jnp arrays).

Conventions (matching the reference exactly):

* spherical triplets are (azimuth, elevation, radius); elevation is measured
  up from the horizontal plane (saf_utility_geometry.c ``sph2cart``).
* ``euler2rotationMatrix`` composes R = R3 @ R2 @ R1 with row-vector style
  rotation matrices Rz/Ry/Rx (saf_utility_geometry.c:213-255).
* quaternions are (w, x, y, z) with the reference's component mapping
  (saf_utility_geometry.c:89-121).
"""
from __future__ import annotations

import numpy as np

# Euler conventions (saf_utility_geometry.h:77-90)
EULER_ROTATION_Y_CONVENTION = 0     # Rz(a) Ry(b) Rz(g)
EULER_ROTATION_X_CONVENTION = 1     # Rz(a) Rx(b) Rz(g)
EULER_ROTATION_YAW_PITCH_ROLL = 2   # Rz(yaw) Ry(pitch) Rx(roll)
EULER_ROTATION_ROLL_PITCH_YAW = 3   # Rx(roll) Ry(pitch) Rz(yaw)


def _xp(*arrays):
    """Pick numpy or jax.numpy based on argument types."""
    for a in arrays:
        if type(a).__module__.startswith("jax"):
            import jax.numpy as jnp

            return jnp
    return np


def sph2cart(sph, degrees: bool = False):
    """(..., 3) [azi, elev, r] → (..., 3) [x, y, z]  (saf_utility_geometry.c:272)."""
    xp = _xp(sph)
    azi, elev, r = sph[..., 0], sph[..., 1], sph[..., 2]
    if degrees:
        azi = azi * (np.pi / 180.0)
        elev = elev * (np.pi / 180.0)
    ce = xp.cos(elev)
    return xp.stack([r * ce * xp.cos(azi), r * ce * xp.sin(azi), r * xp.sin(elev)], axis=-1)


def cart2sph(cart, degrees: bool = False):
    """(..., 3) [x,y,z] → (..., 3) [azi, elev, r]  (saf_utility_geometry.c:304)."""
    xp = _xp(cart)
    x, y, z = cart[..., 0], cart[..., 1], cart[..., 2]
    hypot_xy = xp.sqrt(x * x + y * y)
    r = xp.sqrt(x * x + y * y + z * z)
    azi = xp.arctan2(y, x)
    elev = xp.arctan2(z, hypot_xy)
    if degrees:
        azi = azi * (180.0 / np.pi)
        elev = elev * (180.0 / np.pi)
    return xp.stack([azi, elev, r], axis=-1)


def unit_sph2cart(dirs, degrees: bool = False):
    """(..., 2) [azi, elev] → unit vectors (..., 3)."""
    xp = _xp(dirs)
    r = xp.ones_like(dirs[..., :1])
    return sph2cart(xp.concatenate([dirs, r], axis=-1), degrees=degrees)


def unit_cart2sph(cart, degrees: bool = False):
    """Unit vectors (..., 3) → (..., 2) [azi, elev]."""
    return cart2sph(cart, degrees=degrees)[..., :2]


def _rot_x(theta, xp):
    c, s = xp.cos(theta), xp.sin(theta)
    one, zero = xp.ones_like(c), xp.zeros_like(c)
    return xp.stack([
        xp.stack([one, zero, zero], -1),
        xp.stack([zero, c, s], -1),
        xp.stack([zero, -s, c], -1),
    ], -2)


def _rot_y(theta, xp):
    c, s = xp.cos(theta), xp.sin(theta)
    one, zero = xp.ones_like(c), xp.zeros_like(c)
    return xp.stack([
        xp.stack([c, zero, -s], -1),
        xp.stack([zero, one, zero], -1),
        xp.stack([s, zero, c], -1),
    ], -2)


def _rot_z(theta, xp):
    c, s = xp.cos(theta), xp.sin(theta)
    one, zero = xp.ones_like(c), xp.zeros_like(c)
    return xp.stack([
        xp.stack([c, s, zero], -1),
        xp.stack([-s, c, zero], -1),
        xp.stack([zero, zero, one], -1),
    ], -2)


def euler2rotation_matrix(alpha, beta, gamma, degrees: bool = False,
                          convention: int = EULER_ROTATION_YAW_PITCH_ROLL):
    """R = R3(gamma) @ R2(beta) @ R1(alpha)  (saf_utility_geometry.c:213-255).

    Scalars or batched angle arrays; returns (..., 3, 3).
    """
    xp = _xp(alpha, beta, gamma)
    alpha, beta, gamma = xp.asarray(alpha), xp.asarray(beta), xp.asarray(gamma)
    if degrees:
        d = np.pi / 180.0
        alpha, beta, gamma = alpha * d, beta * d, gamma * d
    if convention == EULER_ROTATION_Y_CONVENTION:
        R1, R2, R3 = _rot_z(alpha, xp), _rot_y(beta, xp), _rot_z(gamma, xp)
    elif convention == EULER_ROTATION_X_CONVENTION:
        R1, R2, R3 = _rot_z(alpha, xp), _rot_x(beta, xp), _rot_z(gamma, xp)
    elif convention == EULER_ROTATION_YAW_PITCH_ROLL:
        R1, R2, R3 = _rot_z(alpha, xp), _rot_y(beta, xp), _rot_x(gamma, xp)
    elif convention == EULER_ROTATION_ROLL_PITCH_YAW:
        R1, R2, R3 = _rot_x(alpha, xp), _rot_y(beta, xp), _rot_z(gamma, xp)
    else:
        raise ValueError(convention)
    return R3 @ R2 @ R1


def yaw_pitch_roll2_rzyx(yaw, pitch, roll, roll_pitch_yaw: bool = False):
    """saf_utility_geometry.c:257-270 (radians)."""
    conv = EULER_ROTATION_ROLL_PITCH_YAW if roll_pitch_yaw else EULER_ROTATION_YAW_PITCH_ROLL
    return euler2rotation_matrix(yaw, pitch, roll, degrees=False, convention=conv)


def quaternion2rotation_matrix(q):
    """q: (..., 4) [w, x, y, z] → (..., 3, 3)  (saf_utility_geometry.c:89-104)."""
    xp = _xp(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return xp.stack([
        xp.stack([2 * (w * w + z * z) - 1, 2 * (z * y - w * x), 2 * (z * x + w * y)], -1),
        xp.stack([2 * (z * y + w * x), 2 * (w * w + y * y) - 1, 2 * (y * x - w * z)], -1),
        xp.stack([2 * (z * x - w * y), 2 * (y * x + w * z), 2 * (w * w + x * x) - 1], -1),
    ], -2)


def rotation_matrix2quaternion(R):
    """(..., 3, 3) → (..., 4) [w,x,y,z]  (saf_utility_geometry.c:107-121)."""
    xp = _xp(R)
    w = xp.sqrt(xp.maximum(0.0, 1 + R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])) / 2
    z = xp.sqrt(xp.maximum(0.0, 1 + R[..., 0, 0] - R[..., 1, 1] - R[..., 2, 2])) / 2
    y = xp.sqrt(xp.maximum(0.0, 1 - R[..., 0, 0] + R[..., 1, 1] - R[..., 2, 2])) / 2
    x = xp.sqrt(xp.maximum(0.0, 1 - R[..., 0, 0] - R[..., 1, 1] + R[..., 2, 2])) / 2
    z = xp.where(R[..., 2, 1] - R[..., 1, 2] < 0, -z, z)
    y = xp.where(R[..., 0, 2] - R[..., 2, 0] < 0, -y, y)
    x = xp.where(R[..., 1, 0] - R[..., 0, 1] < 0, -x, x)
    return xp.stack([w, x, y, z], -1)


def euler2quaternion(alpha, beta, gamma, degrees: bool = False,
                     convention: int = EULER_ROTATION_YAW_PITCH_ROLL):
    """Euler angles → quaternion (..., 4) [w, x, y, z]
    (saf_utility_geometry.c:123-161 ``euler2Quaternion``)."""
    xp = _xp(alpha, beta, gamma)
    if convention == EULER_ROTATION_YAW_PITCH_ROLL:
        a_y, a_p, a_r = alpha, beta, gamma
    elif convention == EULER_ROTATION_ROLL_PITCH_YAW:
        a_y, a_p, a_r = gamma, beta, alpha
    else:
        raise ValueError(f"convention {convention!r} not supported "
                         "(saf: saf_print_error)")
    if degrees:
        a_y, a_p, a_r = (xp.radians(a_y), xp.radians(a_p), xp.radians(a_r))
    cy, sy = xp.cos(a_y * 0.5), xp.sin(a_y * 0.5)
    cp, sp = xp.cos(a_p * 0.5), xp.sin(a_p * 0.5)
    cr, sr = xp.cos(a_r * 0.5), xp.sin(a_r * 0.5)
    return xp.stack([cy * cr * cp + sy * sr * sp,
                     cy * sr * cp - sy * cr * sp,
                     cy * cr * sp + sy * sr * cp,
                     sy * cr * cp - cy * sr * sp], -1)


def quaternion2euler(q, degrees: bool = False,
                     convention: int = EULER_ROTATION_YAW_PITCH_ROLL):
    """Quaternion (..., 4) [w, x, y, z] → (alpha, beta, gamma)
    (saf_utility_geometry.c:163-213 ``quaternion2euler``)."""
    xp = _xp(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sinr_cosp = 2.0 * (w * x + y * z)
    cosr_cosp = 1.0 - 2.0 * (x * x + y * y)
    sinp = 2.0 * (w * y - z * x)
    siny_cosp = 2.0 * (w * z + x * y)
    cosy_cosp = 1.0 - 2.0 * (y * y + z * z)
    beta = xp.where(xp.abs(sinp) >= 1.0,
                    xp.sign(sinp) * (np.pi / 2.0),
                    xp.arcsin(xp.clip(sinp, -1.0, 1.0)))
    if convention == EULER_ROTATION_YAW_PITCH_ROLL:
        gamma = xp.arctan2(sinr_cosp, cosr_cosp)
        alpha = xp.arctan2(siny_cosp, cosy_cosp)
    elif convention == EULER_ROTATION_ROLL_PITCH_YAW:
        alpha = xp.arctan2(sinr_cosp, cosr_cosp)
        gamma = xp.arctan2(siny_cosp, cosy_cosp)
    else:
        raise ValueError(f"convention {convention!r} not supported "
                         "(saf: saf_print_error)")
    if degrees:
        alpha, beta, gamma = (xp.degrees(alpha), xp.degrees(beta),
                              xp.degrees(gamma))
    return alpha, beta, gamma


def crossProduct3(a, b):
    xp = _xp(a, b)
    return xp.cross(a, b)


def L2_norm(v):
    xp = _xp(v)
    return xp.sqrt((v * v).sum(-1))


def sph_delaunay(dirs_deg):
    """Delaunay triangulation of points on the sphere == their convex hull
    (saf_utility_geometry.c ``sphDelaunay``).  dirs_deg: (nDirs, 2) [azi, elev]
    → (faces (nF, 3) int, vertices (nDirs, 3))."""
    from scipy.spatial import ConvexHull

    verts = np.asarray(unit_sph2cart(np.asarray(dirs_deg, np.float64), degrees=True))
    hull = ConvexHull(verts)
    return hull.simplices.astype(int), verts


def sph_voronoi(faces, vertices):
    """Spherical Voronoi diagram from a spherical Delaunay triangulation
    (saf_utility_geometry.c:693-868 ``sphVoronoi``): each triangle's
    circumcentre on the unit sphere — its outward unit normal — is a
    Voronoi vertex; each input direction's cell is the ring of its incident
    triangles' vertices, here ordered by angle in the direction's tangent
    plane (the C sorts by shared-edge adjacency; same polygon).

    faces: (nF, 3) int; vertices: (nDirs, 3) unit →
    (vor_verts (nF, 3), cells: list of nDirs index lists into vor_verts)."""
    faces = np.asarray(faces, int)
    verts = np.asarray(vertices, np.float64)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    normal = np.cross(v1 - v0, v2 - v0)
    vor = normal / np.linalg.norm(normal, axis=-1, keepdims=True)
    # orient outward: scipy's simplices — unlike the C's convhull_3d faces,
    # whose winding quickhull keeps consistently outward — have arbitrary
    # winding.  "Outward" must be judged against an interior point of the
    # hull (its vertex centroid), NOT the origin: for cap-confined layouts
    # (e.g. a dome) the origin lies outside the hull and the large back
    # face's circumcentre sits on the far side of the sphere.
    centroid = verts.mean(axis=0)
    flip = (vor * (v0 - centroid)).sum(-1) < 0.0
    vor[flip] = -vor[flip]
    # Global duplicate canonicalisation (C:731-746): an unclaimed vertex n
    # claims every m (componentwise within 1e-5) — NOT a consecutive-chain
    # dedup, so A≈A'≈A'' with |A-A''|>1e-5 keeps both A and A''.  The C
    # stores the canonical index in duplicates[m], where 0 doubles as
    # "not a duplicate" — so vertices claimed by vertex 0 are never
    # remapped; mirrored here (the `if dup[i] != 0` below).
    n_vert = vor.shape[0]
    dup = np.zeros(n_vert, int)
    for n in range(n_vert):
        if dup[n] == 0:
            close = (np.abs(vor - vor[n]) < 1e-5).all(axis=1)
            close[n] = False
            dup[close] = n
    cells = []
    for m in range(verts.shape[0]):
        inc = np.nonzero((faces == m).any(axis=1))[0]
        d = verts[m]
        # tangent-plane basis at d (the C walks shared-edge adjacency;
        # angle-sorting in the tangent plane yields the same cyclic polygon)
        a = np.array([1.0, 0.0, 0.0]) if abs(d[0]) < 0.9 \
            else np.array([0.0, 1.0, 0.0])
        t1 = np.cross(d, a)
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(d, t1)
        ang = np.arctan2(vor[inc] @ t2, vor[inc] @ t1)
        ring = inc[np.argsort(ang)]
        # remap to canonical vertices, keep first occurrences in ring order
        # (C:842-858 unique_i + ascending position sort)
        keep, seen = [], set()
        for i in ring:
            i = int(dup[i]) if dup[i] != 0 else int(i)
            if i not in seen:
                seen.add(i)
                keep.append(i)
        cells.append(keep)
    return vor, cells


def sph_voronoi_areas(vor_verts, cells):
    """Areas of spherical Voronoi polygons via the spherical excess
    Σ interior angles − (N−2)π (saf_utility_geometry.c:870-945
    ``sphVoronoiAreas``).  → (nDirs,) float32, summing to 4π."""
    vor = np.asarray(vor_verts, np.float64)
    areas = np.empty(len(cells), np.float32)
    for m, cell in enumerate(cells):
        N = len(cell)
        if N < 3:
            areas[m] = 0.0
            continue
        theta = 0.0
        for n in range(N):
            p0 = vor[cell[n - 1]]
            p1 = vor[cell[n]]
            p2 = vor[cell[(n + 1) % N]]
            # tangents at p1 toward p0 and p2 along the great circles
            t10 = np.cross(np.cross(p1, p0), p1)
            t12 = np.cross(np.cross(p1, p2), p1)
            t10 /= np.linalg.norm(t10)
            t12 /= np.linalg.norm(t12)
            theta += np.arccos(np.clip(t10 @ t12, -1.0, 1.0))
        areas[m] = theta - (N - 2) * np.pi
    return areas


def get_voronoi_weights(dirs_deg):
    """Spherical Voronoi cell areas per direction, summing to 4π
    (saf_utility_geometry.c:930-990 ``getVoronoiWeights``): composed exactly
    as the C — sphDelaunay → sphVoronoi → sphVoronoiAreas.  → (nDirs,)."""
    faces, verts = sph_delaunay(dirs_deg)
    vor, cells = sph_voronoi(faces, verts)
    return sph_voronoi_areas(vor, cells)


def rodrigues(axis, theta):
    """Rotation about a unit axis by theta (general helper)."""
    xp = _xp(axis)
    axis = xp.asarray(axis, dtype=float)
    K = xp.stack([
        xp.stack([xp.zeros_like(axis[..., 0]), -axis[..., 2], axis[..., 1]], -1),
        xp.stack([axis[..., 2], xp.zeros_like(axis[..., 0]), -axis[..., 0]], -1),
        xp.stack([-axis[..., 1], axis[..., 0], xp.zeros_like(axis[..., 0])], -1),
    ], -2)
    eye = xp.eye(3)
    return eye + xp.sin(theta) * K + (1 - xp.cos(theta)) * (K @ K)


def convhull_nd(points):
    """N-dimensional convex hull (saf_utility_geometry.h ``convhullnd`` via
    convhull_3d/qhull) → simplex vertex indices (nFaces, d)."""
    from scipy.spatial import ConvexHull

    return ConvexHull(np.asarray(points, np.float64)).simplices


def delaunay_nd(points):
    """N-dimensional Delaunay triangulation (``delaunaynd``) → (nSimplices,
    d+1) vertex indices."""
    from scipy.spatial import Delaunay

    return Delaunay(np.asarray(points, np.float64)).simplices
