"""Lockstep wavefront BVH traversal compiled by XLA.

Wavefront re-design of the reference's two traversal engines (the
per-ray stack loop of the OpenCL kernel, reference Kernels.h:139-242, and
the Embree CPU path, Scene.cpp:374-484): every ray in the wave runs the
same state machine in lockstep under one ``lax.while_loop``; per-ray
divergence is handled by masking, per-ray stacks live in a (R, D) array,
and node/pair fetches are XLA gathers of aligned 64-byte rows.

Per iteration each lane is either
  - at an interior node (``cur >= 0``): fetch the 2-wide node row, slab-test
    both children, descend near-first and push the far child
    (Kernels.h:169-198), or
  - inside a leaf (``cur < 0``): intersect one TrianglePair and advance the
    encoded (first, count) cursor (Kernels.h:200-204), or
  - popping / done.

The loop runs until every lane is DONE; lanes that finish early idle (the
lockstep analog of SIMT divergence). On miss the environment radiance is folded
into the result, mirroring the Result hit/miss union contract
(RayAccelerator.h:66-76, Kernels.h:213-222).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from rayaccel_tpu.environment import Environment, sample_environment_onehot
from rayaccel_tpu.ops.intersect import (aabb_hit_soa, rotate_barycentrics,
                                        safe_inv_dir,
                                        triangle_pair_intersect_soa)
from rayaccel_tpu.scene.compile import TpuScene
from rayaccel_tpu.types import Hits, Rays, INVALID_TRIANGLE

DONE = jnp.int32(0x7FFFFFFF)
POP = jnp.int32(0x7FFFFFFE)
_LEAF_MASK = 0xFFFFFF


def _bitcast_i32(x: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.bitcast_convert_type(x, jnp.int32)


@partial(jax.jit, static_argnames=("stack_depth",))
def trace_bvh(scene: TpuScene, rays: Rays, env: Environment | None = None,
              stack_depth: int = 48, active: jnp.ndarray | None = None) -> Hits:
    """Trace a wave of rays through the compiled scene.

    Returns closest hits with barycentrics un-rotated to the original
    triangle vertex order (Embree convention), and environment radiance in
    ``miss_rgb`` where no triangle was hit. Lanes where ``active`` is False
    are skipped entirely (reported as misses with zero radiance) — the
    wavefront analog of a partially filled ray stream
    (RayAccelerator.h:78-83 RayStream.count).
    """
    R = rays.o.shape[0]

    # Unpack to flat per-component lane vectors once: (R,) arrays give
    # contiguous, coalesced loads ((R, 3) layouts stride the minor dim).
    o = tuple(rays.o[:, a] for a in range(3))
    inv3 = safe_inv_dir(rays.d)
    d = tuple(rays.d[:, a] for a in range(3))
    inv_d = tuple(inv3[:, a] for a in range(3))
    ood = tuple(-o[a] * inv_d[a] for a in range(3))

    if active is None:
        cur0 = jnp.zeros((R,), jnp.int32)
    else:
        cur0 = jnp.where(active, jnp.int32(0), DONE)

    # Per-ray stacks live TRANSPOSED, (depth, R): pushes/pops are one-hot
    # level-mask blends over contiguous lanes instead of per-lane
    # scatters into an (R, depth) layout.
    level = jax.lax.broadcasted_iota(jnp.int32, (stack_depth, R), 0)
    # Carry inits derive from ray inputs so the loop typechecks under
    # shard_map (constant inits lack the varying-axes tag).
    zi = cur0 * 0
    zf = rays.tmax * 0.0
    state = dict(
        cur=cur0,                                 # start at root node 0
        sp=zi,
        stack=jnp.broadcast_to(zi[None, :], (stack_depth, R)),
        t_cur=rays.tmax,
        best=zi - 1,                              # pair-triangle slot (2p+w)
        bu=zf,
        bv=zf,
    )

    def cond(s):
        return jnp.any(s["cur"] != DONE)

    def body(s):
        cur, sp, stack = s["cur"], s["sp"], s["stack"]
        t_cur = s["t_cur"]

        # ---- interior-node step (Kernels.h:170-198) ----
        is_node = (cur >= 0) & (cur != DONE) & (cur != POP)
        node_idx = jnp.where(is_node, cur, 0)
        row = jnp.take(scene.nodes, node_idx, axis=0)  # (R, 16) gather

        c0 = _bitcast_i32(row[:, 12])
        c1 = _bitcast_i32(row[:, 13])
        hit0, t0 = aabb_hit_soa(
            (row[:, 0], row[:, 1], row[:, 2]),
            (row[:, 3], row[:, 4], row[:, 5]),
            inv_d, ood, rays.tmin, t_cur)
        hit1, t1 = aabb_hit_soa(
            (row[:, 6], row[:, 7], row[:, 8]),
            (row[:, 9], row[:, 10], row[:, 11]),
            inv_d, ood, rays.tmin, t_cur)
        both = hit0 & hit1
        near_is_1 = t1 < t0
        near = jnp.where(near_is_1, c1, c0)
        far = jnp.where(near_is_1, c0, c1)
        node_next = jnp.where(both, near,
                              jnp.where(hit0, c0, jnp.where(hit1, c1, POP)))

        push = is_node & both
        stack = jnp.where((level == sp[None, :]) & push[None, :],
                          far[None, :], stack)
        sp = sp + push.astype(jnp.int32)

        # ---- leaf step: one TrianglePair per iteration (Kernels.h:200-204) ----
        is_leaf = cur < 0
        enc = jnp.where(is_leaf, -cur - 1, 0)
        first = enc & _LEAF_MASK
        count = jax.lax.shift_right_logical(enc, 24)
        prow = jnp.take(scene.pairs, first, axis=0)   # (R, 16) gather
        ph = triangle_pair_intersect_soa(
            tuple(prow[:, k] for k in range(12)), o, d, rays.tmin, t_cur)
        hit_ok = is_leaf & (count > 0) & ph.valid

        best = jnp.where(hit_ok, first * 2 + ph.which, s["best"])
        bu = jnp.where(hit_ok, ph.u, s["bu"])
        bv = jnp.where(hit_ok, ph.v, s["bv"])
        t_cur = jnp.where(hit_ok, ph.t, t_cur)

        count2 = count - 1
        # Addition, not OR: if first+1 carried into bit 24 an OR would
        # corrupt the count field (encode_leaf also bounds first+count).
        leaf_next = jnp.where(count2 > 0,
                              -((first + 1) + (count2 << 24)) - 1, POP)

        nxt = jnp.where(is_node, node_next,
                        jnp.where(is_leaf, leaf_next, DONE))

        # ---- pop (Kernels.h:207-210) ----
        need_pop = nxt == POP
        can_pop = need_pop & (sp > 0)
        sp = sp - can_pop.astype(jnp.int32)
        popped = jnp.sum(jnp.where((level == sp[None, :]) & can_pop[None, :],
                                   stack, 0), axis=0)
        nxt = jnp.where(need_pop, jnp.where(can_pop, popped, DONE), nxt)

        return dict(cur=nxt, sp=sp, stack=stack, t_cur=t_cur,
                    best=best, bu=bu, bv=bv)

    out = jax.lax.while_loop(cond, body, state)

    best = out["best"]
    hit = best >= 0
    remap = jnp.take(scene.pair_tri, jnp.where(hit, best, 0), axis=0)
    remap_u = remap.astype(jnp.uint32)
    tri = (remap_u & jnp.uint32(0x3FFFFFFF)).astype(jnp.int32)
    code = jax.lax.shift_right_logical(remap_u, jnp.uint32(30)).astype(jnp.int32)
    u, v = rotate_barycentrics(code, out["bu"], out["bv"])

    if env is not None:
        miss_rgb = sample_environment_onehot(env, rays.d)
        mask = hit if active is None else (hit | ~active)
        miss_rgb = jnp.where(mask[:, None], 0.0, miss_rgb)
    else:
        miss_rgb = jnp.zeros((R, 3), jnp.float32)

    return Hits(
        tri=jnp.where(hit, tri, INVALID_TRIANGLE),
        t=jnp.where(hit, out["t_cur"], rays.tmax),
        u=jnp.where(hit, u, 0.0),
        v=jnp.where(hit, v, 0.0),
        miss_rgb=miss_rgb,
    )


@partial(jax.jit, static_argnames=("stack_depth",))
def trace_occlusion_bvh(scene: TpuScene, rays: Rays,
                        active: jnp.ndarray | None = None,
                        stack_depth: int = 48) -> jnp.ndarray:
    """Any-hit (occlusion/shadow) query on the lockstep BVH engine: True
    where some triangle blocks the ray within [tmin, tmax].

    The early-exit analog of the traversal kernel's shrinking-tMax
    ordered descent (Kernels.h:190-210) taken to its limit: a lane whose
    pair test hits ANYTHING retires immediately (cur -> DONE), no
    closest-t race, no barycentric bookkeeping — measurably cheaper than
    a closest-hit traversal for shadow rays.
    """
    R = rays.o.shape[0]
    o = tuple(rays.o[:, a] for a in range(3))
    inv3 = safe_inv_dir(rays.d)
    d = tuple(rays.d[:, a] for a in range(3))
    inv_d = tuple(inv3[:, a] for a in range(3))
    ood = tuple(-o[a] * inv_d[a] for a in range(3))

    if active is None:
        cur0 = jnp.zeros((R,), jnp.int32)
    else:
        cur0 = jnp.where(active, jnp.int32(0), DONE)

    level = jax.lax.broadcasted_iota(jnp.int32, (stack_depth, R), 0)
    zi = cur0 * 0
    state = dict(
        cur=cur0,
        sp=zi,
        stack=jnp.broadcast_to(zi[None, :], (stack_depth, R)),
        occluded=cur0 < -1,
    )

    def cond(s):
        return jnp.any(s["cur"] != DONE)

    def body(s):
        cur, sp, stack = s["cur"], s["sp"], s["stack"]

        is_node = (cur >= 0) & (cur != DONE) & (cur != POP)
        node_idx = jnp.where(is_node, cur, 0)
        row = jnp.take(scene.nodes, node_idx, axis=0)
        c0 = _bitcast_i32(row[:, 12])
        c1 = _bitcast_i32(row[:, 13])
        hit0, _ = aabb_hit_soa((row[:, 0], row[:, 1], row[:, 2]),
                               (row[:, 3], row[:, 4], row[:, 5]),
                               inv_d, ood, rays.tmin, rays.tmax)
        hit1, _ = aabb_hit_soa((row[:, 6], row[:, 7], row[:, 8]),
                               (row[:, 9], row[:, 10], row[:, 11]),
                               inv_d, ood, rays.tmin, rays.tmax)
        # Any-hit: no near/far ordering needed — descend 0 first, push 1.
        node_next = jnp.where(hit0, c0, jnp.where(hit1, c1, POP))
        push = is_node & hit0 & hit1
        stack = jnp.where((level == sp[None, :]) & push[None, :],
                          c1[None, :], stack)
        sp = sp + push.astype(jnp.int32)

        is_leaf = cur < 0
        enc = jnp.where(is_leaf, -cur - 1, 0)
        first = enc & _LEAF_MASK
        count = jax.lax.shift_right_logical(enc, 24)
        prow = jnp.take(scene.pairs, first, axis=0)
        ph = triangle_pair_intersect_soa(
            tuple(prow[:, k] for k in range(12)), o, d, rays.tmin, rays.tmax)
        hit_ok = is_leaf & (count > 0) & ph.valid
        occluded = s["occluded"] | hit_ok

        count2 = count - 1
        leaf_next = jnp.where(hit_ok, DONE,           # early exit on any hit
                              jnp.where(count2 > 0,
                                        -((first + 1) + (count2 << 24)) - 1,
                                        POP))
        nxt = jnp.where(is_node, node_next,
                        jnp.where(is_leaf, leaf_next, DONE))

        need_pop = nxt == POP
        can_pop = need_pop & (sp > 0)
        sp = sp - can_pop.astype(jnp.int32)
        popped = jnp.sum(jnp.where((level == sp[None, :]) & can_pop[None, :],
                                   stack, 0), axis=0)
        nxt = jnp.where(need_pop, jnp.where(can_pop, popped, DONE), nxt)
        return dict(cur=nxt, sp=sp, stack=stack, occluded=occluded)

    out = jax.lax.while_loop(cond, body, state)
    return out["occluded"]


def trace(scene, rays: Rays, env: Environment | None = None,
          backend: str = "xla", stack_depth: int = 48) -> Hits:
    """Backend dispatcher, analog of the reference's engine selection
    (hybrid scheduler routing streams to Embree or the OpenCL kernel,
    RayAccelerator.cpp:268-300). ``scene`` is a TpuScene for the
    xla/bruteforce engines or a ClusterScene for mxu."""
    if backend == "xla":
        return trace_bvh(scene, rays, env, stack_depth=stack_depth)
    if backend == "mxu":
        from rayaccel_tpu.ops.trace_mxu import trace_mxu
        return trace_mxu(scene, rays, env).hits
    if backend == "bruteforce":
        from rayaccel_tpu.ops.bruteforce import trace_bruteforce
        hits = trace_bruteforce(scene.tri_verts, rays)
        if env is not None:
            miss = hits.tri == INVALID_TRIANGLE
            rgb = sample_environment_onehot(env, rays.d)
            hits = hits._replace(miss_rgb=jnp.where(miss[:, None], rgb, 0.0))
        return hits
    from rayaccel_tpu.config import BACKENDS
    raise ValueError(f"unknown backend {backend!r}; the engines are "
                     f"{', '.join(BACKENDS)}")
