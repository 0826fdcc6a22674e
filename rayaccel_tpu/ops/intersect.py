"""Vectorized intersection primitives.

The TrianglePair test is the math of the reference's OpenCL
``trianglePairIntersect`` (reference Kernels.h:36-115) — two triangles
sharing edge e1 intersected with one shared cross-product set — expressed
with plain float selects instead of sign-bit integer tricks (vectorized
selects are as cheap, and the bit tricks cost readability).

The slab AABB test mirrors ``aabbIntersect`` (Kernels.h:117-135) in
mad-form: tNear = bbmin * invDir + OoD with OoD = -origin * invDir.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

DIR_EPSILON = 1e-10  # direction component clamp, Kernels.h:149-157


def _cross(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by,
            az * bx - ax * bz,
            ax * by - ay * bx)


def safe_inv_dir(d: jnp.ndarray) -> jnp.ndarray:
    """1/d with tiny components clamped away from zero, preserving sign
    (Kernels.h:149-159)."""
    small = jnp.abs(d) < DIR_EPSILON
    d = jnp.where(small, jnp.where(d < 0, -DIR_EPSILON, DIR_EPSILON), d)
    return 1.0 / d


def aabb_hit(bbmin, bbmax, inv_d, ood, tmin, tmax):
    """Slab test. ``bbmin``/``bbmax``: (..., 3); ``inv_d``/``ood``: (..., 3).

    Returns (hit, t_enter): hit where the [tmin, tmax] interval overlaps the
    box; t_enter is the clamped entry distance used for near-child ordering
    (Kernels.h:117-135 returns tFar as the miss marker; a bool is clearer).
    """
    t_near = bbmin * inv_d + ood
    t_far = bbmax * inv_d + ood
    lo = jnp.minimum(t_near, t_far)
    hi = jnp.maximum(t_near, t_far)
    t0 = jnp.maximum(jnp.max(lo, axis=-1), tmin)
    t1 = jnp.minimum(jnp.min(hi, axis=-1), tmax)
    return t0 <= t1, t0


def aabb_hit_soa(bmin, bmax, inv_d, ood, tmin, tmax):
    """Component-wise slab test: every argument is a tuple of three (R,)
    arrays (or (R,) scalars for tmin/tmax). Flat lane vectors give
    contiguous loads, where (R, 3) arrays would stride the minor
    dimension."""
    t0 = tmin
    t1 = tmax
    for a in range(3):
        tn = bmin[a] * inv_d[a] + ood[a]
        tf = bmax[a] * inv_d[a] + ood[a]
        t0 = jnp.maximum(t0, jnp.minimum(tn, tf))
        t1 = jnp.minimum(t1, jnp.maximum(tn, tf))
    return t0 <= t1, t0


class PairHit(NamedTuple):
    valid: jnp.ndarray  # (...,) bool — hit either triangle of the pair
    which: jnp.ndarray  # (...,) int32 — 0/1: which pair triangle
    t: jnp.ndarray      # (...,) float32
    u: jnp.ndarray      # (...,) float32 (pair-local barycentric)
    v: jnp.ndarray      # (...,) float32


def triangle_pair_intersect(pair_row: jnp.ndarray,
                            o: jnp.ndarray, d: jnp.ndarray,
                            tmin: jnp.ndarray, tmax: jnp.ndarray) -> PairHit:
    """Intersect rays with triangle pairs (row layout [e1,e2,e3,p0,...]).

    All inputs broadcast over the leading batch shape; ``pair_row`` is
    (..., >=12).
    """
    cols = tuple(pair_row[..., k] for k in range(12))
    oc = (o[..., 0], o[..., 1], o[..., 2])
    dc = (d[..., 0], d[..., 1], d[..., 2])
    return triangle_pair_intersect_soa(cols, oc, dc, tmin, tmax)


def triangle_pair_intersect_soa(cols, o, d, tmin, tmax) -> PairHit:
    """Component-wise TrianglePair test (the math of Kernels.h:36-115):
    triangle 1 = (p0, p0-e1 side, p0+e2), triangle 2 = (p0, p0+e3,
    p0-e1 side); both share the cross products built from e1.

    ``cols``: 12 arrays [e1xyz, e2xyz, e3xyz, p0xyz]; ``o``/``d``: tuples of
    three (R,) arrays.
    """
    (e1x, e1y, e1z, e2x, e2y, e2z,
     e3x, e3y, e3z, p0x, p0y, p0z) = cols
    ox, oy, oz = o
    dx, dy, dz = d

    n1x, n1y, n1z = _cross(e1x, e1y, e1z, e2x, e2y, e2z)
    n2x, n2y, n2z = _cross(e3x, e3y, e3z, e1x, e1y, e1z)

    cx, cy, cz = p0x - ox, p0y - oy, p0z - oz
    rx, ry, rz = _cross(dx, dy, dz, cx, cy, cz)

    det1 = n1x * dx + n1y * dy + n1z * dz
    det2 = n2x * dx + n2y * dy + n2z * dz
    s1 = jnp.where(det1 < 0, -1.0, 1.0)  # sign-bit XOR analog, Kernels.h:60-66
    s2 = jnp.where(det2 < 0, -1.0, 1.0)

    r_e1 = rx * e1x + ry * e1y + rz * e1z
    r_e2 = rx * e2x + ry * e2y + rz * e2z
    r_e3 = rx * e3x + ry * e3y + rz * e3z

    u1 = r_e2 * s1
    v1 = r_e1 * s1
    u2 = -r_e1 * s2
    v2 = -r_e3 * s2

    abs_det1 = jnp.abs(det1)
    abs_det2 = jnp.abs(det2)
    w1 = abs_det1 - u1 - v1
    w2 = abs_det2 - u2 - v2

    t1 = (n1x * cx + n1y * cy + n1z * cz) * s1
    t2 = (n2x * cx + n2y * cy + n2z * cz) * s2

    # Inside tests + t-range (Kernels.h:68-89). The reference uses
    # bitwise sign-or; >= 0 comparisons are equivalent for our purposes.
    ok1 = ((u1 >= 0) & (v1 >= 0) & (w1 >= 0)
           & (t1 > abs_det1 * tmin) & (t1 <= abs_det1 * tmax))
    ok2 = ((u2 >= 0) & (v2 >= 0) & (w2 >= 0)
           & (t2 > abs_det2 * tmin) & (t2 <= abs_det2 * tmax))

    # Pick the closer hit (Kernels.h:94-105): triangle 2 wins when it is
    # the only hit, or both hit and T1/absDet1 > T2/absDet2.
    pick2 = (ok2 & ~ok1) | (ok1 & ok2 & (t1 * abs_det2 > t2 * abs_det1))

    abs_det = jnp.where(pick2, abs_det2, abs_det1)
    tt = jnp.where(pick2, t2, t1)
    uu = jnp.where(pick2, u2, u1)
    vv = jnp.where(pick2, v2, v1)

    rcp = 1.0 / jnp.where(abs_det == 0, 1.0, abs_det)
    return PairHit(
        valid=ok1 | ok2,
        which=pick2.astype(jnp.int32),
        t=tt * rcp, u=uu * rcp, v=vv * rcp,
    )


def rotate_barycentrics(code: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """Un-rotate pair-local barycentrics to the original vertex order
    (Kernels.h:224-238). code 0/3: identity; 1: (u,v)<-(w,u); 2: (u,v)<-(v,w)."""
    w = 1.0 - u - v
    u_out = jnp.where(code == 1, w, jnp.where(code == 2, v, u))
    v_out = jnp.where(code == 1, u, jnp.where(code == 2, w, v))
    return u_out, v_out


def moller_trumbore(v0, v1, v2, o, d, tmin, tmax):
    """Classic single-triangle test (Embree-convention u toward v1, v toward
    v2) used by the brute-force oracle. Shapes broadcast."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = jnp.cross(d, e2)
    det = jnp.sum(p * e1, axis=-1)
    inv = 1.0 / jnp.where(det == 0, 1.0, det)
    tvec = o - v0
    u = jnp.sum(p * tvec, axis=-1) * inv
    q = jnp.cross(tvec, e1)
    v = jnp.sum(q * d, axis=-1) * inv
    t = jnp.sum(q * e2, axis=-1) * inv
    valid = ((det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
             & (t > tmin) & (t <= tmax))
    return valid, t, u, v
