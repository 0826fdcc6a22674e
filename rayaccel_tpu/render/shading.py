"""Shared shading geometry: attribute interpolation and the spawn rules
for secondary rays.

Vectorized re-expression of the gather/interpolate/validate sequence both
integrators share (reference PathTracingRenderer.cpp:144-419,
WhittedRenderer.cpp:226-475).

Normal-orientation convention: this framework stores OUTWARD face normals.
The reference's sign tests (flip shading normal when d.Ng < 0,
PathTracingRenderer.cpp:345-349; refraction eta chosen by the same sign,
WhittedRenderer.cpp:429-432) are only coherent if its scene content stores
inward face normals, so our equivalents flip the comparison direction; the
side-consistency test and the epsilon offset are orientation-invariant and
carry over unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rayaccel_tpu.scene.clusters import (ATTR_GEOM_COL, ATTR_PACK_COLS,
                                         ATTR_UV_COL)
from rayaccel_tpu.scene.compile import TpuScene
from rayaccel_tpu.types import Hits, Rays

WEIGHT_CUTOFF = 0.01        # PathTracingRenderer.cpp:394, WhittedRenderer.cpp:407
ORIGIN_EPSILON = 1e-4       # PathTracingRenderer.cpp:410-412
SECONDARY_TMIN = 1e-3       # PathTracingRenderer.cpp:421
SECONDARY_TMAX = 1e6


class SurfaceSample(NamedTuple):
    pos: jnp.ndarray        # (R, 3) hit position (o + t*d)
    ns: jnp.ndarray         # (R, 3) shading normal, flipped toward the ray
    ng: jnp.ndarray         # (R, 3) geometric normal (outward, unflipped)
    uv: jnp.ndarray         # (R, 2) interpolated texcoords
    mat_params: jnp.ndarray  # (R, 4) gathered material parameters
    d_dot_ng: jnp.ndarray   # (R,) sign carrier for side tests
    entering: jnp.ndarray   # (R,) bool: ray hits the outward-facing side


def interpolate_surface(scene: TpuScene, rays: Rays, hits: Hits,
                        active: jnp.ndarray) -> SurfaceSample:
    """Gather per-triangle / per-vertex attributes and build the shading
    frame (PathTracingRenderer.cpp:156-349 vectorized: texcoord + normal
    interpolation with weights (1-u-v, u, v), normalization, two-sided
    flip)."""
    tri = jnp.where(active, hits.tri, 0)
    idx3 = jnp.take(scene.tri_index, tri, axis=0)          # (R, 3)
    vn = jnp.take(scene.vert_normal, idx3, axis=0)         # (R, 3, 3)
    vt = jnp.take(scene.vert_uv, idx3, axis=0)             # (R, 3, 2)

    u = hits.u[:, None]
    v = hits.v[:, None]
    w = 1.0 - u - v
    ns = vn[:, 0] * w + vn[:, 1] * u + vn[:, 2] * v
    ns = ns * jax.lax.rsqrt(jnp.sum(ns * ns, axis=-1, keepdims=True))
    uv = vt[:, 0] * w + vt[:, 1] * u + vt[:, 2] * v

    ng = jnp.take(scene.tri_normal, tri, axis=0)
    mat = jnp.take(scene.tri_mat, tri, axis=0)
    params = jnp.take(scene.mat_params, mat, axis=0)

    d_dot_ng = jnp.sum(rays.d * ng, axis=-1)
    entering = d_dot_ng < 0
    # Two-sided flip toward the incoming ray (outward-normal convention).
    ns = jnp.where(entering[:, None], ns, -ns)

    pos = rays.o + hits.t[:, None] * rays.d
    return SurfaceSample(pos=pos, ns=ns, ng=ng, uv=uv, mat_params=params,
                         d_dot_ng=d_dot_ng, entering=entering)


def surface_from_attrs(attrs: jnp.ndarray, mat_table: jnp.ndarray,
                       rays: Rays, hits: Hits) -> SurfaceSample:
    """Build the shading frame from the cluster tracer's per-hit attribute
    rows (scene/clusters.py layout) — the per-vertex-gather-free
    equivalent of :func:`interpolate_surface`."""
    u = hits.u[:, None]
    v = hits.v[:, None]
    w = 1.0 - u - v
    # Unpack the bf16-pair shading words (scene/clusters.py layout): a
    # bf16 is the top half of an f32, so each half decodes with one mask
    # or shift + bitcast — no float16 hardware path involved.
    pk = jax.lax.bitcast_convert_type(attrs[:, :ATTR_PACK_COLS], jnp.int32)
    hi = jax.lax.bitcast_convert_type(
        pk & jnp.int32(-0x10000), jnp.float32)
    lo = jax.lax.bitcast_convert_type(pk << 16, jnp.float32)
    n0 = jnp.stack([hi[:, 0], lo[:, 0], hi[:, 1]], axis=-1)
    n1 = jnp.stack([lo[:, 1], hi[:, 2], lo[:, 2]], axis=-1)
    n2 = jnp.stack([hi[:, 3], lo[:, 3], hi[:, 4]], axis=-1)
    ns = n0 * w + n1 * u + n2 * v
    ns = ns * jax.lax.rsqrt(jnp.maximum(
        jnp.sum(ns * ns, axis=-1, keepdims=True), 1e-30))
    # Geometric normal from the exact stored edges — same winding and
    # formula as scene/data.py compute_face_normals.
    e1 = attrs[:, ATTR_GEOM_COL + 3:ATTR_GEOM_COL + 6]
    e2 = attrs[:, ATTR_GEOM_COL + 6:ATTR_GEOM_COL + 9]
    ng = jnp.cross(e1, e2)
    ng = ng * jax.lax.rsqrt(jnp.maximum(
        jnp.sum(ng * ng, axis=-1, keepdims=True), 1e-30))
    # uv words ride the TAIL of the attr row (scene/clusters.py
    # ATTR_UV_COL): no current material consumes uv, so XLA dead-codes
    # this decode and narrows the winner row gather to the used
    # 15-column prefix.
    pu = jax.lax.bitcast_convert_type(
        attrs[:, ATTR_UV_COL:ATTR_UV_COL + 3], jnp.int32)
    uhi = jax.lax.bitcast_convert_type(
        pu & jnp.int32(-0x10000), jnp.float32)
    ulo = jax.lax.bitcast_convert_type(pu << 16, jnp.float32)
    uv = (uhi[:, 0:1] * w + uhi[:, 1:2] * u + uhi[:, 2:3] * v)
    uv = jnp.concatenate(
        [uv, ulo[:, 0:1] * w + ulo[:, 1:2] * u + ulo[:, 2:3] * v], axis=-1)

    # Material parameters by exact row gather from the small table (the
    # reference's per-instance virtual dispatch, Materials.h:15-20). A
    # one-hot matmul here would run in TF32 on the GPU at default
    # precision and round the parameters.
    m = lo[:, 4].astype(jnp.int32)
    params = jnp.take(mat_table, m, axis=0)

    d_dot_ng = jnp.sum(rays.d * ng, axis=-1)
    entering = d_dot_ng < 0
    ns = jnp.where(entering[:, None], ns, -ns)
    pos = rays.o + hits.t[:, None] * rays.d
    return SurfaceSample(pos=pos, ns=ns, ng=ng, uv=uv, mat_params=params,
                         d_dot_ng=d_dot_ng, entering=entering)


def spawn_secondary(surf: SurfaceSample, wi: jnp.ndarray,
                    new_weight: jnp.ndarray, transmitted: jnp.ndarray,
                    d_dot_ng: jnp.ndarray):
    """Common secondary-ray validation + construction
    (PathTracingRenderer.cpp:394-423):

    - weight cutoff: any channel > 0.01;
    - side consistency: wi leaves on the opposite side of the geometric
      normal than the ray arrived, XOR transmitted (orientation-invariant);
    - NaN kill;
    - origin offset 1e-4 along Ng toward the departing side;
    - tmin/tmax = 1e-3 / 1e6.

    Returns (rays, ok).
    """
    wi_dot_ng = jnp.sum(wi * surf.ng, axis=-1)
    opposite = (wi_dot_ng > 0) != (d_dot_ng > 0)
    ok_side = opposite != transmitted

    ok_weight = jnp.any(new_weight > WEIGHT_CUTOFF, axis=-1)

    offset_sign = jnp.where(wi_dot_ng >= 0, 1.0, -1.0)
    pos = surf.pos + surf.ng * (ORIGIN_EPSILON * offset_sign)[:, None]

    finite = (jnp.all(jnp.isfinite(pos), axis=-1)
              & jnp.all(jnp.isfinite(wi), axis=-1))

    n = wi.shape[0]
    rays = Rays(
        o=pos, d=wi,
        tmin=jnp.full((n,), SECONDARY_TMIN, jnp.float32),
        tmax=jnp.full((n,), SECONDARY_TMAX, jnp.float32),
    )
    return rays, ok_weight & ok_side & finite


def merge_rays(cond: jnp.ndarray, a: Rays, b: Rays) -> Rays:
    c = cond[:, None]
    return Rays(
        o=jnp.where(c, a.o, b.o),
        d=jnp.where(c, a.d, b.d),
        tmin=jnp.where(cond, a.tmin, b.tmin),
        tmax=jnp.where(cond, a.tmax, b.tmax),
    )
