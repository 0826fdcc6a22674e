"""Cluster-dense wavefront tracer ("mxu" engine) in plain jax.numpy/lax.

Replaces per-ray-per-step traversal (the reference's OpenCL kernel,
Kernels.h:139-242) with dense per-tile linear algebra:

- Rays are processed as contiguous *tiles* (default 512 rays). The
  renderers emit waves in block-swizzled pixel order so a tile is a
  compact screen block (the analog of the reference's 128x128 tiles,
  TiledRenderer.h:37, re-shaped for wavefront coherence).
- Stage A (cull): every ray is slab-tested against every cluster AABB in
  one fused broadcast kernel; reductions over each tile yield a
  front-to-back cluster queue per tile.
- Stage B (intersect): a lockstep loop over queue position k, batched
  across all tiles: step k fetches each tile's k-th cluster block (one
  coarse gather of a whole cluster per tile) and intersects tile x
  cluster with one batched (RT,16)@(16,4C) float32 product using the
  bilinear Moller-Trumbore factorization (scene/clusters.py).
- Shading attributes of the winning triangle are fetched with ONE
  per-ray row gather at the end (the winner's global slot id is carried
  through the loop).  A one-hot matmul would be wrong here, not just
  slower: the attr rows carry bf16-pair packed words whose f32 bit
  patterns can be denormal (scene/clusters.py), and matmul/FTZ flushes
  them to zero; gathers are bit-exact.
- Waves wider than MAX_BATCH rays are traced as a sequence of equal
  chunks of whole tiles (every tile's result is independent of the
  others, so chunking changes no hit). This bounds the shapes XLA
  compiles and the loop's temporaries at frame-pool widths.

Front-to-back queue order + per-ray closest-t rejection give the same
pruning the reference gets from ordered traversal with tMax shrinking
(Kernels.h:190-198).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from rayaccel_tpu.environment import Environment, sample_environment_onehot
from rayaccel_tpu.ops.intersect import safe_inv_dir
from rayaccel_tpu.scene.clusters import ATTR_COLS, RAY_FEATURES, ClusterScene
from rayaccel_tpu.types import Hits, Rays, INVALID_TRIANGLE

_INF = jnp.float32(3e38)
_HP = jax.lax.Precision.HIGHEST   # true float32 products (no TF32 on GPU)
MAX_BATCH = 65536                 # widest ray batch one trace loop runs


def map_chunks(fn, n_lanes: int, unit: int, *xs, max_batch=None):
    """``fn(*xs)`` over the leading (lane) axis in the fewest equal chunks
    of at most ``max_batch`` lanes (default MAX_BATCH) whose size is a
    multiple of ``unit``, run one after another under ``lax.map``;
    outputs are re-joined along the lane axis."""
    max_batch = MAX_BATCH if max_batch is None else max_batch
    units = n_lanes // unit
    n = max(1, -(-n_lanes // max_batch))
    while units % n:
        n += 1
    if n == 1:
        return fn(*xs)
    out = jax.lax.map(lambda a: fn(*a),
                      tuple(x.reshape((n, n_lanes // n) + x.shape[1:])
                            for x in xs))
    return jax.tree.map(lambda a: a.reshape((n_lanes,) + a.shape[2:]), out)


class MxuHits(NamedTuple):
    """Hits plus the hit triangle's shading attribute row (gather-free)."""

    hits: Hits
    attrs: jnp.ndarray  # (R, ATTR_COLS); see scene/clusters.py layout


def _ray_features(o, d):
    """F = [d, o, d x o, 1, 0*6] per ray, (R, 16)."""
    ox, oy, oz = o
    dx, dy, dz = d
    cx = dy * oz - dz * oy
    cy = dz * ox - dx * oz
    cz = dx * oy - dy * ox
    one = jnp.ones_like(dx)
    zero = jnp.zeros_like(dx)
    return jnp.stack([dx, dy, dz, ox, oy, oz, cx, cy, cz, one,
                      zero, zero, zero, zero, zero, zero], axis=1)


@partial(jax.jit, static_argnames=("tile",))
def trace_occlusion_mxu(cs: ClusterScene, rays: Rays,
                        active: jnp.ndarray | None = None,
                        tile: int = 512) -> jnp.ndarray:
    """Any-hit (occlusion/shadow) query: True where some triangle blocks
    the ray within [tmin, tmax]. The role of an RTC_OCCLUDED-style query —
    the reference exposes only closest-hit (Scene.h:25), but its streaming
    architecture is routinely used for shadow rays (bench.py config 1),
    so the capability is first-class here. Cheaper than trace_mxu: no
    closest-t race, no attribute fetch, and a tile stops at its first
    fully-occluded iteration.
    """
    R = rays.o.shape[0]
    assert R % tile == 0
    tmax_eff = (rays.tmax if active is None
                else jnp.where(active, rays.tmax, -1.0))
    return map_chunks(partial(_occlusion_chunk, cs, tile=tile), R, tile,
                      rays.o, rays.d, rays.tmin, tmax_eff)


def _occlusion_chunk(cs, ro, rd, tmin, tmax_eff, tile):
    R = ro.shape[0]
    T = R // tile
    C = cs.cluster_size
    n_c = cs.n_clusters

    o = tuple(ro[:, a] for a in range(3))
    inv3 = safe_inv_dir(rd)
    d = tuple(rd[:, a] for a in range(3))
    inv_d = tuple(inv3[:, a] for a in range(3))

    t0 = jnp.broadcast_to(tmin[:, None], (R, n_c))
    t1 = jnp.broadcast_to(tmax_eff[:, None], (R, n_c))
    for a in range(3):
        tn = (cs.cl_bbmin[:, a][None, :] - o[a][:, None]) * inv_d[a][:, None]
        tf = (cs.cl_bbmax[:, a][None, :] - o[a][:, None]) * inv_d[a][:, None]
        t0 = jnp.maximum(t0, jnp.minimum(tn, tf))
        t1 = jnp.minimum(t1, jnp.maximum(tn, tf))
    entry = jnp.where(t0 <= t1, t0, _INF)
    tile_entry = entry.reshape(T, tile, n_c).min(axis=1)
    order = jnp.argsort(tile_entry, axis=1)
    count = jnp.sum((tile_entry < _INF).astype(jnp.int32), axis=1)
    max_count = jnp.max(count)

    F = _ray_features(o, d).reshape(T, tile, RAY_FEATURES)
    G3 = cs.G.reshape(RAY_FEATURES, n_c, 4 * C).transpose(1, 0, 2)
    tmin_t = tmin.reshape(T, tile)
    tmax_t = tmax_eff.reshape(T, tile)

    # Derived-from-input init (shard_map varying-axes, see trace_mxu).
    state = dict(k=jnp.int32(0), occluded=tmax_t < -1e30)

    def cond(s):
        live = (s["k"] < count) & jnp.any(~s["occluded"], axis=1)
        return (s["k"] < max_count) & jnp.any(live)

    def body(s):
        k = s["k"]
        c_t = jax.lax.dynamic_slice(order, (0, k), (T, 1))[:, 0]
        live = (k < count) & jnp.any(~s["occluded"], axis=1)
        c_t = jnp.where(live, c_t, 0)
        G_blk = jnp.take(G3, c_t, axis=0)
        S = jax.lax.dot_general(F, G_blk, (((2,), (1,)), ((0,), (0,))),
                                precision=_HP)
        det = S[:, :, 0 * C:1 * C]
        u_n = S[:, :, 1 * C:2 * C]
        v_n = S[:, :, 2 * C:3 * C]
        t_n = S[:, :, 3 * C:4 * C]
        sgn = jnp.where(det < 0, -1.0, 1.0)
        ad = jnp.abs(det)
        u = u_n * sgn
        v = v_n * sgn
        t = t_n * sgn
        valid = ((ad > 0) & (u >= 0) & (v >= 0) & (u + v <= ad)
                 & (t > ad * tmin_t[:, :, None])
                 & (t <= ad * tmax_t[:, :, None]))
        hit_any = jnp.any(valid, axis=2) & live[:, None]
        return dict(k=k + 1, occluded=s["occluded"] | hit_any)

    out = jax.lax.while_loop(cond, body, state)
    return out["occluded"].reshape(R)


@partial(jax.jit, static_argnames=("tile",))
def trace_mxu(cs: ClusterScene, rays: Rays, env: Environment | None = None,
              active: jnp.ndarray | None = None, tile: int = 512) -> MxuHits:
    """Trace a wave. R must be a multiple of ``tile``."""
    R = rays.o.shape[0]
    assert R % tile == 0, f"wave size {R} not a multiple of tile {tile}"
    tmax_eff = (rays.tmax if active is None
                else jnp.where(active, rays.tmax, -1.0))
    t, u, v, tri, slot = map_chunks(partial(_closest_chunk, cs, tile=tile),
                                    R, tile, rays.o, rays.d, rays.tmin,
                                    tmax_eff)
    attr = jnp.take(cs.attrs, slot, axis=0)

    hit = tri >= 0
    if env is not None:
        miss_rgb = sample_environment_onehot(env, rays.d)
        mask = hit if active is None else (hit | ~active)
        miss_rgb = jnp.where(mask[:, None], 0.0, miss_rgb)
    else:
        miss_rgb = jnp.zeros((R, 3), jnp.float32)

    hits = Hits(
        tri=jnp.where(hit, tri, INVALID_TRIANGLE),
        t=jnp.where(hit, t, rays.tmax),
        u=u, v=v,
        miss_rgb=miss_rgb,
    )
    return MxuHits(hits=hits, attrs=attr)


def _closest_chunk(cs, ro, rd, tmin, tmax_eff, tile):
    """Closest hits of one chunk: (t, u, v, tri, slot) per ray."""
    R = ro.shape[0]
    T = R // tile
    C = cs.cluster_size
    n_c = cs.n_clusters

    o = tuple(ro[:, a] for a in range(3))
    inv3 = safe_inv_dir(rd)
    d = tuple(rd[:, a] for a in range(3))
    inv_d = tuple(inv3[:, a] for a in range(3))

    # ---- stage A: dense cull, fused over the whole wave ----
    t0 = jnp.broadcast_to(tmin[:, None], (R, n_c))
    t1 = jnp.broadcast_to(tmax_eff[:, None], (R, n_c))
    for a in range(3):
        tn = (cs.cl_bbmin[:, a][None, :] - o[a][:, None]) * inv_d[a][:, None]
        tf = (cs.cl_bbmax[:, a][None, :] - o[a][:, None]) * inv_d[a][:, None]
        t0 = jnp.maximum(t0, jnp.minimum(tn, tf))
        t1 = jnp.minimum(t1, jnp.maximum(tn, tf))
    entry = jnp.where(t0 <= t1, t0, _INF)              # (R, N_c)
    tile_entry = entry.reshape(T, tile, n_c).min(axis=1)   # (T, N_c)

    order = jnp.argsort(tile_entry, axis=1)            # (T, N_c) front-to-back
    sorted_entry = jnp.take_along_axis(tile_entry, order, axis=1)
    count = jnp.sum((tile_entry < _INF).astype(jnp.int32), axis=1)  # (T,)
    max_count = jnp.max(count)

    # Reshaped views for batched per-tile work.
    F = _ray_features(o, d).reshape(T, tile, RAY_FEATURES)
    G3 = cs.G.reshape(RAY_FEATURES, n_c, 4 * C).transpose(1, 0, 2)  # (N_c,16,4C)
    I3 = cs.tri_id.reshape(n_c, C)

    tmin_t = tmin.reshape(T, tile)
    # Carry inits derive from the (possibly device-varying) ray inputs so
    # the while_loop typechecks under shard_map.
    bt0 = tmax_eff.reshape(T, tile)
    z = bt0 * 0.0
    state = dict(
        k=jnp.int32(0),
        best_t=bt0,
        best_u=z,
        best_v=z,
        best_tri=z.astype(jnp.int32) + INVALID_TRIANGLE,
        best_slot=z.astype(jnp.int32),
    )

    def cond(s):
        k = s["k"]
        in_range = k < max_count
        # Tile-level front-to-back early-out: a tile is live while its k-th
        # nearest cluster can still beat some ray's current best.
        ek = jax.lax.dynamic_slice(sorted_entry,
                                   (0, jnp.minimum(k, n_c - 1)), (T, 1))[:, 0]
        live = (k < count) & (ek <= jnp.max(s["best_t"], axis=1))
        return in_range & jnp.any(live)

    def body(s):
        k = s["k"]
        c_t = jax.lax.dynamic_slice(order, (0, k), (T, 1))[:, 0]   # (T,)
        ek = jax.lax.dynamic_slice(sorted_entry, (0, k), (T, 1))[:, 0]
        live = (k < count) & (ek <= jnp.max(s["best_t"], axis=1))  # (T,)
        c_t = jnp.where(live, c_t, 0)

        G_blk = jnp.take(G3, c_t, axis=0)              # (T, 16, 4C) coarse gather
        S = jax.lax.dot_general(F, G_blk,
                                (((2,), (1,)), ((0,), (0,))),
                                precision=_HP)         # (T, tile, 4C)
        det = S[:, :, 0 * C:1 * C]
        u_n = S[:, :, 1 * C:2 * C]
        v_n = S[:, :, 2 * C:3 * C]
        t_n = S[:, :, 3 * C:4 * C]

        sgn = jnp.where(det < 0, -1.0, 1.0)
        ad = jnp.abs(det)
        u = u_n * sgn
        v = v_n * sgn
        t = t_n * sgn
        valid = ((ad > 0) & (u >= 0) & (v >= 0) & (u + v <= ad)
                 & (t > ad * tmin_t[:, :, None])
                 & (t < ad * s["best_t"][:, :, None]))
        rcp_ad = 1.0 / jnp.maximum(ad, 1e-30)
        tt = jnp.where(valid, t * rcp_ad, _INF)

        j = jnp.argmin(tt, axis=2)                     # (T, tile)
        onehot = (jax.lax.broadcasted_iota(jnp.int32, (T, tile, C), 2)
                  == j[:, :, None])
        tj = jnp.sum(jnp.where(onehot, tt, 0.0), axis=2)
        better = (tj < s["best_t"]) & live[:, None]

        sel = onehot & better[:, :, None]
        uj = jnp.sum(jnp.where(sel, u * rcp_ad, 0.0), axis=2)
        vj = jnp.sum(jnp.where(sel, v * rcp_ad, 0.0), axis=2)

        ids_blk = jnp.take(I3, c_t, axis=0)            # (T, C)
        tri_j = jnp.sum(jnp.where(sel, ids_blk[:, None, :], 0), axis=2)
        slot_j = c_t[:, None] * C + j                  # global attr row id

        return dict(
            k=k + 1,
            best_t=jnp.where(better, tj, s["best_t"]),
            best_u=jnp.where(better, uj, s["best_u"]),
            best_v=jnp.where(better, vj, s["best_v"]),
            best_tri=jnp.where(better, tri_j, s["best_tri"]),
            best_slot=jnp.where(better, slot_j, s["best_slot"]),
        )

    out = jax.lax.while_loop(cond, body, state)
    return tuple(out[k].reshape(R) for k in ("best_t", "best_u", "best_v",
                                             "best_tri", "best_slot"))
