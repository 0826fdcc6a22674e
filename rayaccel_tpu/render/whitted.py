"""Wavefront Whitted renderer: ray *trees* on a streaming engine.

Re-design of the reference WhittedRenderer (reference
WhittedRenderer.cpp:38-697). The reference bounds ray-tree fan-out with a
global mutex-protected LoopData pool: when a hit spawns both a reflection
and a refraction ray, the reflection continues in the output stream and
the refraction is *parked*, linked onto the continuation's head chain
(WhittedRenderer.cpp:119-133); when a path terminates, one parked ray per
terminated head is resurrected (WhittedRenderer.cpp:91-115).

In the wavefront each lane owns exactly one pixel's whole ray tree, so
the linked-list pool collapses into a *lane-local stack*: parking pushes
the refraction ray, termination pops it — a classic depth-first binary
tree traversal, no mutex, no links. The pool-size bound (maxShadingDepth=8
entries per in-flight ray, WhittedRenderer.cpp:47-50) becomes the stack
depth; the frame-end pool-drained assert (WhittedRenderer.cpp:62) becomes
"every lane finished with an empty stack", which holds by construction,
plus an overflow counter the tests require to be zero.

Shading is the reference's inline headlight model
(WhittedRenderer.cpp:343-372): gray 0.3 albedo, directional light
(0.57, 0.57, 0.57), fixed eta 1.1 glass for refraction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from rayaccel_tpu.camera import Camera, generate_pixel_rays
from rayaccel_tpu.context import Context
from rayaccel_tpu.environment import Environment, create_environment
from rayaccel_tpu.ops.trace import trace_bvh, trace_occlusion_bvh
from rayaccel_tpu.ops.trace_mxu import trace_mxu, trace_occlusion_mxu
from rayaccel_tpu.render.shading import (ORIGIN_EPSILON, SECONDARY_TMAX,
                                         SECONDARY_TMIN, WEIGHT_CUTOFF,
                                         interpolate_surface, merge_rays,
                                         surface_from_attrs)
from rayaccel_tpu.render.tiled import TiledRenderer
from rayaccel_tpu.scene.clusters import ClusterScene, compile_clusters
from rayaccel_tpu.scene.compile import TpuScene, compile_scene
from rayaccel_tpu.scene.data import SceneData
from rayaccel_tpu.types import INVALID_TRIANGLE, Rays

# Invalid-lane marker for gather-free shrink pieces (see
# render/pathtracer.py _LANE_INVALID — same reassembly contract).
_LANE_INVALID = jnp.float32(3e38)

MATERIAL_GRAY = 0.3                      # WhittedRenderer.cpp:343-345
LIGHT_DIR = (0.57, 0.57, 0.57)           # WhittedRenderer.cpp:357-359
ETA_GLASS = 1.1                          # WhittedRenderer.cpp:429-430


def whitted_shade(surf, rays: Rays, weight):
    """Compute direct radiance + both child rays for active hits, given a
    shading frame (from gathers or from the cluster tracer's attribute
    rows).

    Vectorized analog of WhittedRenderer::shade's 8-wide block
    (WhittedRenderer.cpp:203-581). Returns
    (radiance, new_weight, refl_rays, refl_ok, refr_rays, refr_ok).
    """
    d = rays.d
    ns = surf.ns  # already flipped toward the incoming ray

    light = jnp.asarray(LIGHT_DIR, jnp.float32)
    ndotl = jnp.maximum(jnp.sum(ns * light[None, :], axis=-1), 0.0)
    new_weight = weight * MATERIAL_GRAY
    radiance = new_weight * ndotl[:, None]

    cont = jnp.any(new_weight > WEIGHT_CUTOFF, axis=-1)  # :407-411

    d_dot_n = jnp.sum(d * ns, axis=-1)

    # Reflection (:420-424).
    refl_d = d - (2.0 * d_dot_n)[:, None] * ns

    # Refraction (:428-442); eta by travel side (outward-normal convention:
    # entering uses 1/1.1).
    eta = jnp.where(surf.entering, 1.0 / ETA_GLASS, ETA_GLASS)
    r = 1.0 - eta * eta * (1.0 - d_dot_n * d_dot_n)
    mu = eta * d_dot_n + jnp.sqrt(jnp.maximum(r, 0.0))
    refr_d = eta[:, None] * d - mu[:, None] * ns

    d_side = surf.d_dot_ng > 0

    def finish(dir_new, extra_ok):
        dot = jnp.sum(dir_new * surf.ng, axis=-1)
        pos = surf.pos + surf.ng * (
            ORIGIN_EPSILON * jnp.where(dot >= 0, 1.0, -1.0))[:, None]
        finite = (jnp.all(jnp.isfinite(pos), axis=-1)
                  & jnp.all(jnp.isfinite(dir_new), axis=-1))
        n = dir_new.shape[0]
        out = Rays(pos, dir_new,
                   jnp.full((n,), SECONDARY_TMIN, jnp.float32),
                   jnp.full((n,), SECONDARY_TMAX, jnp.float32))
        return out, cont & extra_ok & finite, dot > 0

    refl_rays, refl_base, refl_side = finish(refl_d, jnp.ones_like(cont))
    refr_rays, refr_base, refr_side = finish(refr_d, r > 0.0)
    # Side consistency (:445-449): reflection leaves on the opposite side
    # of Ng, refraction on the same side.
    refl_ok = refl_base & (refl_side != d_side)
    refr_ok = refr_base & (refr_side == d_side)
    return radiance, new_weight, refl_rays, refl_ok, refr_rays, refr_ok


def _occlusion_query(scene, srays, active, bk, tile, stack_depth):
    """Exact any-hit shadow query on the engine matching ``bk`` (the
    reference's any-hit semantics, Kernels.h:190-210)."""
    if bk == "mxu":
        return trace_occlusion_mxu(scene, srays, active=active, tile=tile)
    return trace_occlusion_bvh(scene, srays, active=active,
                               stack_depth=stack_depth)


def _whitted_trace(scene, env, rays, alive, bk, tile, stack_depth):
    """Closest-hit trace + shading-frame build on engine ``bk`` (env
    radiance folded at trace time per the Result union contract).
    Returns (hits, surf)."""
    if bk == "xla":
        hits = trace_bvh(scene, rays, env=env, active=alive,
                         stack_depth=stack_depth)
        surf = interpolate_surface(scene, rays, hits,
                                   alive & (hits.tri >= 0))
        return hits, surf
    res = trace_mxu(scene, rays, env=env, active=alive, tile=tile)
    surf = surface_from_attrs(res.attrs, scene.mat_params, rays, res.hits)
    return res.hits, surf


def _whitted_step(scene, s, hits, surf, bk, tile, stack_depth, max_depth,
                  stack_size, shadows, primary_only):
    """Post-trace lane-state advance shared by the per-wave and pooled
    frame paths: env on miss, direct light (+ optional shadow query),
    reflection/refraction spawn, refraction parking, and terminated-head
    resurrection (loopHandling, WhittedRenderer.cpp:82-135). Width is
    whatever ``s`` carries; returns the advanced state dict."""
    rays, alive, weight = s["rays"], s["alive"], s["weight"]
    R = rays.o.shape[0]
    level = jax.lax.broadcasted_iota(jnp.int32, (stack_size, R), 0)
    traced = s["traced"] + jnp.sum(alive.astype(jnp.int32))

    radiance = s["radiance"]
    # Miss => environment (WhittedRenderer.cpp:586-680); env radiance is
    # folded into the trace result (Result union contract).
    miss = alive & (hits.tri == INVALID_TRIANGLE)
    radiance = radiance + jnp.where(miss[:, None],
                                    weight * hits.miss_rgb, 0.0)

    # Active hits: direct light + children (hits at depth == max_depth
    # terminate without contribution, WhittedRenderer.cpp:171-187).
    active = alive & (hits.tri >= 0) & (s["depth"] < max_depth)
    direct, new_w, refl, refl_ok, refr, refr_ok = whitted_shade(
        surf, rays, weight)
    if primary_only:
        # bench config 1: primary + shadow rays only — no
        # reflection/refraction trees.
        refl_ok = refl_ok & False
        refr_ok = refr_ok & False
    refl_ok = refl_ok & active
    refr_ok = refr_ok & active
    if shadows:
        # Shadow rays toward the directional light (bench config 1:
        # primary+shadow): direct light is masked by an any-hit
        # occlusion query from the offset hit point.
        light = jnp.asarray(LIGHT_DIR, jnp.float32)
        light = light / jnp.linalg.norm(light)
        sgn = jnp.where(jnp.sum(surf.ng * light[None, :], axis=-1) >= 0,
                        1.0, -1.0)
        spos = surf.pos + surf.ng * (ORIGIN_EPSILON * sgn)[:, None]
        srays = Rays(o=spos,
                     d=jnp.broadcast_to(light[None, :], spos.shape) + spos * 0.0,
                     tmin=SECONDARY_TMIN + spos[:, 0] * 0.0,
                     tmax=SECONDARY_TMAX + spos[:, 0] * 0.0)
        occluded = _occlusion_query(scene, srays, active, bk, tile,
                                    stack_depth)
        traced = traced + jnp.sum(active.astype(jnp.int32))
        direct = jnp.where(occluded[:, None], 0.0, direct)
    radiance = radiance + jnp.where(active[:, None], direct, 0.0)

    # Continuation selection (WhittedRenderer.cpp:535-565): reflection
    # continues; lone refraction continues; both => park refraction.
    next_rays = merge_rays(refl_ok, refl, refr)
    has_next = refl_ok | refr_ok
    park = refl_ok & refr_ok

    sp = s["sp"]
    can_park = park & (sp < stack_size)
    dropped = s["dropped"] + jnp.sum((park & ~can_park).astype(jnp.int32))
    push_mask = (level == sp[None, :]) & can_park[None, :]
    entry = jnp.stack([refr.o[:, 0], refr.o[:, 1], refr.o[:, 2],
                       refr.d[:, 0], refr.d[:, 1], refr.d[:, 2],
                       (s["depth"] + 1).astype(jnp.float32)])  # (7, R)
    stk = jnp.where(push_mask[:, None, :], entry[None, :, :], s["stk"])
    stk_w = jnp.where(push_mask[:, None, :], new_w.T[None, :, :],
                      s["stk_w"])
    sp = sp + can_park.astype(jnp.int32)

    # Termination => resurrect a parked ray (loopHandling,
    # WhittedRenderer.cpp:91-115), else the lane dies.
    terminated = alive & ~has_next
    pop = terminated & (sp > 0)
    sp = sp - pop.astype(jnp.int32)
    pop_mask = (level == sp[None, :]) & pop[None, :]
    pe = jnp.sum(jnp.where(pop_mask[:, None, :], stk, 0.0), axis=0)  # (7,R)
    pw = jnp.sum(jnp.where(pop_mask[:, None, :], stk_w, 0.0), axis=0)
    popped = Rays(
        o=pe[0:3].T, d=pe[3:6].T,
        tmin=jnp.full((R,), SECONDARY_TMIN, jnp.float32),
        tmax=jnp.full((R,), SECONDARY_TMAX, jnp.float32))

    alive_next = (active & has_next) | pop
    out_rays = merge_rays(pop, popped, merge_rays(has_next, next_rays, rays))
    out_w = jnp.where(pop[:, None], pw.T,
                      jnp.where(active[:, None], new_w, weight))
    out_depth = jnp.where(pop, pe[6].astype(jnp.int32),
                          s["depth"] + active.astype(jnp.int32))
    return dict(rays=out_rays, weight=out_w, depth=out_depth,
                alive=alive_next, sp=sp, stk=stk, stk_w=stk_w,
                radiance=radiance, lane=s["lane"], traced=traced,
                dropped=dropped)


@partial(jax.jit, static_argnames=("max_depth", "stack_size", "backend",
                                   "tile", "stack_depth", "shadows",
                                   "primary_only", "regroup"))
def whitted_trace_wave(scene, env: Environment, cam_arrays,
                       x: jnp.ndarray, y: jnp.ndarray, alive0: jnp.ndarray,
                       key: jax.Array, max_depth: int, stack_size: int = 9,
                       backend: str = "mxu", tile: int = 512,
                       stack_depth: int = 48, shadows: bool = False,
                       primary_only: bool = False, regroup: bool = True):
    """Trace one wave of pixels through their full Whitted ray trees.

    Returns (radiance, rays_traced, dropped): per-lane accumulated
    radiance; ``dropped`` counts refraction rays lost to parked-stack
    overflow (must be 0 when stack_size > max_depth — the analog of the
    reference's pool-drained invariant, WhittedRenderer.cpp:62).

    The parked-ray stacks live transposed, (stack_size, R), so pushes and
    pops are one-hot level blends over contiguous lanes instead of
    per-lane scatters.
    """
    R = x.shape[0]
    rays = generate_pixel_rays(cam_arrays, x, y, key=key)
    # Regrouping pays a wide multi-column state move per bounce; with
    # primary_only (bench config 1) no bounce ever follows the first
    # shade, so the move would be pure waste.
    do_regroup = regroup and not primary_only and backend == "mxu"
    if do_regroup:
        from rayaccel_tpu.render.regroup import coherence_key, regroup_state
        bmin = jnp.min(scene.cl_bbmin, axis=0)
        binv = 1.0 / jnp.maximum(
            jnp.max(scene.cl_bbmax, axis=0) - bmin, 1e-20)

    def trace_and_surface(rays, alive):
        return _whitted_trace(scene, env, rays, alive, backend, tile,
                              stack_depth)

    # Carry inits derive from ray/pixel inputs (shard_map varying-axes).
    zf = rays.tmax * 0.0
    state = dict(
        rays=rays,
        weight=jnp.ones_like(rays.o),
        depth=x * 0,
        alive=alive0,
        sp=x * 0,
        stk=jnp.broadcast_to(zf[None, None, :],
                             (stack_size, 7, R)),  # o(3) d(3) depth(1)
        stk_w=jnp.broadcast_to(zf[None, None, :], (stack_size, 3, R)),
        radiance=rays.o * 0.0,
        lane=x * 0 + jnp.arange(R, dtype=jnp.int32),
        traced=jnp.sum(x) * 0,
        dropped=jnp.sum(x) * 0,
    )

    # Live-prefix buckets for the bounce traces (see pathtracer.py): the
    # regroup sorts dead lanes last, so only the smallest compiled prefix
    # covering the live count is traced.
    sizes = [s for s in (R // 4, R // 2)
             if s >= tile and s % tile == 0] + [R]

    def traced_prefix(rays, alive):
        from rayaccel_tpu.types import Hits
        n_live = jnp.sum(alive.astype(jnp.int32))

        def make_branch(size):
            def branch(rays, alive):
                sub = Rays(rays.o[:size], rays.d[:size],
                           rays.tmin[:size], rays.tmax[:size])
                hits, surf = trace_and_surface(sub, alive[:size])
                if size == R:
                    return hits, surf
                pad = R - size

                def tail(xx, fill=0):
                    widths = ((0, pad),) + ((0, 0),) * (xx.ndim - 1)
                    return jnp.pad(xx, widths, constant_values=fill)

                hits = Hits(tri=tail(hits.tri, INVALID_TRIANGLE),
                            t=tail(hits.t), u=tail(hits.u), v=tail(hits.v),
                            miss_rgb=tail(hits.miss_rgb))
                return hits, jax.tree.map(tail, surf)
            return branch

        idx = sum((n_live > s).astype(jnp.int32) for s in sizes[:-1])
        return jax.lax.switch(idx, [make_branch(s) for s in sizes],
                              rays, alive)

    def cond(s):
        return jnp.any(s["alive"])

    def body(s, use_prefix=False):
        rays, alive = s["rays"], s["alive"]
        if use_prefix:
            hits, surf = traced_prefix(rays, alive)
        else:
            hits, surf = trace_and_surface(rays, alive)
        s = _whitted_step(scene, s, hits, surf, backend, tile, stack_depth,
                          max_depth, stack_size, shadows, primary_only)
        out_rays, out_w, out_depth, alive_next = (
            s["rays"], s["weight"], s["depth"], s["alive"])
        sp, stk, stk_w, radiance, lane = (s["sp"], s["stk"], s["stk_w"],
                                          s["radiance"], s["lane"])

        if do_regroup:
            # Between-bounce regroup (the PT regroup extended to ray
            # trees): the parked-ray stacks flatten into per-lane columns
            # and ride the same multi-operand sort as the lane state, so
            # a lane's pending subtree moves with it. Accumulated
            # radiance moves too; the frame unsorts once by lane at the
            # end. Dead lanes sort last, enabling the prefix buckets.
            ck = coherence_key(out_rays, alive_next, bmin, binv)
            stk_cols = stk.reshape(stack_size * 7, R).T      # (R, S*7)
            stkw_cols = stk_w.reshape(stack_size * 3, R).T   # (R, S*3)
            out_rays, (out_w, out_depth, alive_next, sp, lane, radiance,
                       stk_cols, stkw_cols) = regroup_state(
                ck, out_rays, [out_w, out_depth, alive_next, sp, lane,
                               radiance, stk_cols, stkw_cols])
            stk = stk_cols.T.reshape(stack_size, 7, R)
            stk_w = stkw_cols.T.reshape(stack_size, 3, R)

        return dict(rays=out_rays, weight=out_w, depth=out_depth,
                    alive=alive_next, sp=sp, stk=stk, stk_w=stk_w,
                    radiance=radiance, lane=lane, traced=s["traced"],
                    dropped=s["dropped"])

    # Peel the primary trace: it runs at full width, bounces run on the
    # live prefix.
    state = jax.lax.cond(jnp.any(state["alive"]), body, lambda s: s, state)
    out = jax.lax.while_loop(
        cond, partial(body, use_prefix=do_regroup), state)
    radiance = out["radiance"]
    if do_regroup:
        from rayaccel_tpu.render.regroup import regroup_state as _rs
        _, (radiance,) = _rs(out["lane"], out["rays"], [radiance])
    return radiance, out["traced"], out["dropped"]


@partial(jax.jit, static_argnames=("max_depth", "stack_size", "backend",
                                   "tile", "stack_depth", "shadows",
                                   "min_stage_width", "mesh_axis",
                                   "stage_ratio", "hot_levels",
                                   "n_shards", "reshard"))
def whitted_trace_frame(scene, env: Environment, cam_arrays,
                        xs: jnp.ndarray, ys: jnp.ndarray,
                        alives: jnp.ndarray, key: jax.Array,
                        max_depth: int, stack_size: int = 9,
                        backend: str = "mxu", tile: int = 512,
                        stack_depth: int = 48, shadows: bool = False,
                        min_stage_width: int = 8192,
                        mesh_axis: str | None = None,
                        stage_ratio: int = 2,
                        hot_levels: int = 3,
                        n_shards: int = 1,
                        reshard: bool = True):
    """Frame-pooled Whitted: trace a whole frame of ray TREES with ONE
    bounce loop (the pt_trace_frame pattern applied to the parked-stack
    state). The reference analog is the frame-global loopData pool sized
    8*maxRaysInFlight (WhittedRenderer.cpp:47-50) rather than per-tile
    pools: secondary work from every tile shares one in-flight set, so
    per-bounce fixed costs (cluster cull, shade width, loop launch) are
    paid once per frame-level bounce, not once per wave.

    Stage 1 traces + first-shades the coherent primaries wave by wave;
    stage 2 pools all surviving tree state — including each lane's
    parked refraction stack — into frame order and runs the bounce loop
    with the staged width shrink (dead lanes leave only (lane, radiance)
    behind; the pool never permutes).

    Returns (radiance (W, R, 3) in original lane order, traced, dropped).
    """
    W, R = xs.shape
    N = W * R
    # Global lane ids ride a float32 reassembly sort (and, with
    # re-sharding, the route-home exchange), exact only below 2^24.
    assert N * n_shards < (1 << 24), \
        f"frame pool {N} x {n_shards} shards >= 2^24: lane ids lose " \
        "precision in the float32 reassembly sort"
    S = stack_size
    # Whitted shading is deterministic, so the only randomness is the
    # primary camera jitter, keyed by pixel (camera.generate_pixel_rays):
    # a frame renders the same on any device count.
    shard = 0 if mesh_axis is None else jax.lax.axis_index(mesh_axis)
    lane0 = jnp.arange(N, dtype=jnp.int32) + shard * N

    def trace_and_surface(rays, alive):
        return _whitted_trace(scene, env, rays, alive, backend, tile,
                              stack_depth)

    # ---- stage 1: primary trace + first shade/park, wave by wave ----
    def prim_step(carry, inputs):
        traced, dropped, w = carry
        x, y, alive0 = inputs
        wkey = jax.random.fold_in(key, w)
        rays = generate_pixel_rays(cam_arrays, x, y, key=wkey)
        zf = rays.tmax * 0.0
        st0 = dict(
            rays=rays, weight=jnp.ones_like(rays.o), depth=x * 0,
            alive=alive0, sp=x * 0,
            stk=jnp.broadcast_to(zf[None, None, :], (S, 7, R)),
            stk_w=jnp.broadcast_to(zf[None, None, :], (S, 3, R)),
            radiance=rays.o * 0.0, lane=x * 0,
            traced=jnp.sum(x) * 0, dropped=jnp.sum(x) * 0,
        )

        def live(st):
            hits, surf = trace_and_surface(st["rays"], st["alive"])
            return _whitted_step(scene, st, hits, surf, backend, tile,
                                 stack_depth, max_depth, S, shadows,
                                 False)

        st = jax.lax.cond(jnp.any(alive0), live, lambda st: st, st0)
        # Only stack LEVEL 0 can be occupied after the single primary
        # step (a step pushes at most once, from sp = 0, and pops never
        # write), so the scan carries 10 stack columns instead of 10*S:
        # the stacked scan output shrinks 248 MB -> 27 MB and the
        # pool-layout transpose moves S times less data.
        out = (st["rays"].o, st["rays"].d, st["weight"], st["depth"],
               st["alive"], st["sp"], st["stk"][0], st["stk_w"][0],
               st["radiance"])
        return (traced + st["traced"], dropped + st["dropped"], w + 1), out

    (traced0, dropped0, _), stacked = jax.lax.scan(
        prim_step, (jnp.int32(0), jnp.int32(0), jnp.int32(0)),
        (xs, ys, alives))
    o_s, d_s, w_s, dep_s, al_s, sp_s, stk0_s, stkw0_s, rad_s = stacked

    def flat(a):
        return a.reshape((N,) + a.shape[2:])

    # ---- stage 2: one frame-level bounce loop over the pooled trees ----
    o_f, d_f, w_f = flat(o_s), flat(d_s), flat(w_s)
    dep_f, al_f, sp_f, rad_f = (flat(dep_s), flat(al_s), flat(sp_s),
                                flat(rad_s))
    stk0 = stk0_s.transpose(1, 0, 2).reshape(7, N)
    stkw0 = stkw0_s.transpose(1, 0, 2).reshape(3, N)
    lane_f = lane0

    # Cross-chip tree balance (stream stealing applies to ALL
    # integrators identically, RayAccelerator.cpp:215-244): ray TREES
    # skew shards at least as hard as PT bounces — sky shards die after
    # stage 1 while geometry shards keep whole trees (plus parked
    # refractions) alive. Exchange once, before the bounce loop, when the
    # measured imbalance pays for the move. At pool time only stack LEVEL
    # 0 can be occupied (the single primary step pushes at most once,
    # from sp=0), so the exchange moves 25 columns, not 15 + 10*S.
    do_reshard = mesh_axis is not None and n_shards > 1 and reshard
    if do_reshard:
        from rayaccel_tpu.parallel.mesh import reshard_balance_cols
        S_mat = jnp.concatenate([
            o_f, d_f, w_f, rad_f,
            dep_f.astype(jnp.float32)[:, None],
            sp_f.astype(jnp.float32)[:, None],
            al_f.astype(jnp.float32)[:, None],
            stk0.T, stkw0.T], axis=1)
        S_mat, lane_f, resharded = reshard_balance_cols(
            S_mat, lane_f, al_f, mesh_axis, n_shards)
        o_f, d_f, w_f, rad_f = (S_mat[:, 0:3], S_mat[:, 3:6],
                                S_mat[:, 6:9], S_mat[:, 9:12])
        dep_f = S_mat[:, 12].astype(jnp.int32)
        sp_f = S_mat[:, 13].astype(jnp.int32)
        al_f = S_mat[:, 14] > 0
        stk0 = S_mat[:, 15:22].T
        stkw0 = S_mat[:, 22:25].T

    state = dict(
        rays=Rays(o_f, d_f,
                  jnp.full((N,), SECONDARY_TMIN, jnp.float32),
                  jnp.full((N,), SECONDARY_TMAX, jnp.float32)),
        weight=w_f, depth=dep_f, alive=al_f,
        sp=sp_f,
        stk=jnp.concatenate(
            [stk0[None], jnp.zeros((S - 1, 7, N), jnp.float32)], axis=0),
        stk_w=jnp.concatenate(
            [stkw0[None], jnp.zeros((S - 1, 3, N), jnp.float32)], axis=0),
        radiance=rad_f, lane=lane_f,
        traced=traced0, dropped=dropped0,
    )

    def bounce_body(st):
        hits, surf = trace_and_surface(st["rays"], st["alive"])
        out = _whitted_step(scene, st, hits, surf, backend, tile,
                            stack_depth, max_depth, S, shadows, False)
        return dict(out, n_fresh=st["n_fresh"])

    # Staged width shrink (see pt_trace_frame): alive never resurrects a
    # dead lane (pop only fires on still-alive terminating lanes), so
    # the live set is monotone and the pool can shrink whenever it fits
    # the next stage — one live-first 1-operand sort + one head row
    # gather; dead lanes leave a (lane, radiance) piece behind for the
    # final reassembly. Unlike the PT pool (live collapses after 1-2
    # bounces), Whitted trees keep a large share of lanes alive for MANY
    # iterations, so the default ladder ratio is 2, not 4 — several
    # iterations amortize each haul, and a ratio-4 ladder leaves extra
    # iterations at full width.
    stage_widths = [N]
    while stage_widths[-1] // stage_ratio >= min_stage_width:
        stage_widths.append(
            -(-stage_widths[-1] // stage_ratio // 1024) * 1024)

    # Two-tier stack haul: battlefield's depth-8 trees rarely park deeper
    # than sp=3, so stack levels >= hot_levels ride each shrink only under
    # a cond on the actual max sp — the common case hauls 15 + 10*H
    # columns instead of 15 + 10*S, and the deep levels stay exact when a
    # scene does park that deep.
    H = min(hot_levels, S)

    # Gather-free shrink pieces need only the [:N] slice of a global
    # sort; with resharding, lanes cross shards and the route-home
    # exchange needs exactly-N rows per shard — the gathered-piece path
    # remains (same trade as pt_trace_frame's fast_shrink).
    fast_shrink = not do_reshard

    def run_stage(st, width, next_width):
        def cond(s):
            more = jnp.any(s["alive"])
            if next_width is None:
                return more
            return more & (jnp.sum(s["alive"].astype(jnp.int32))
                           > next_width)

        st = jax.lax.while_loop(cond, bounce_body, st)
        if next_width is None:
            return st, None

        # Gather-free shrink (see pt_trace_frame): the dead-lane piece is
        # emitted at FULL width from CARRIED (lane, radiance) columns —
        # no tail row-gather — with exactly-once validity (fresh & dead,
        # freshness = position < n_fresh, positions stable in-stage; the
        # final sort's [:N] slice drops invalid rows). Live lanes keep
        # their accumulated radiance in the head (radiance is additive
        # but sort-reassembly can't sum, so partial sums never split).
        r = st["rays"]
        iota_w = jnp.arange(width, dtype=jnp.int32)
        n_live = jnp.sum(st["alive"].astype(jnp.int32))
        perm = jax.lax.sort(
            (jnp.where(st["alive"], iota_w, jnp.int32(0x7FFFFFFF)),
             iota_w), num_keys=1)[1]
        head_perm = perm[:next_width]
        S_mat = jnp.concatenate([
            r.o, r.d, st["weight"], st["radiance"],
            st["depth"].astype(jnp.float32)[:, None],
            st["sp"].astype(jnp.float32)[:, None],
            st["stk"][:H].reshape(H * 7, width).T,
            st["stk_w"][:H].reshape(H * 3, width).T], axis=1)
        head = jnp.take(S_mat, head_perm, axis=0)
        lane_h = jnp.take(st["lane"], head_perm)

        if H < S:
            # Deep tier: occupied levels are 0..sp-1, so levels >= H
            # hold data only when some lane has sp > H.
            D = S - H
            deep_needed = jnp.any(st["sp"] > H)

            def haul_deep(_):
                M = jnp.concatenate([
                    st["stk"][H:].reshape(D * 7, width).T,
                    st["stk_w"][H:].reshape(D * 3, width).T], axis=1)
                return jnp.take(M, head_perm, axis=0)

            deep = jax.lax.cond(
                deep_needed, haul_deep,
                lambda _: jnp.zeros((next_width, D * 10), jnp.float32),
                0)
            stk2 = jnp.concatenate(
                [head[:, 14:14 + H * 7].T.reshape(H, 7, next_width),
                 deep[:, :D * 7].T.reshape(D, 7, next_width)], axis=0)
            stkw2 = jnp.concatenate(
                [head[:, 14 + H * 7:14 + H * 10].T.reshape(
                    H, 3, next_width),
                 deep[:, D * 7:].T.reshape(D, 3, next_width)], axis=0)
        else:
            stk2 = head[:, 14:14 + S * 7].T.reshape(S, 7, next_width)
            stkw2 = head[:, 14 + S * 7:14 + S * 10].T.reshape(
                S, 3, next_width)

        if fast_shrink:
            valid = (iota_w < st["n_fresh"]) & ~st["alive"]
            piece = jnp.concatenate([
                jnp.where(valid, st["lane"].astype(jnp.float32),
                          _LANE_INVALID)[:, None],
                st["radiance"]], axis=1)
        else:
            # Gathered piece (reshard path): lanes cross shards, and the
            # route-home exchange needs exactly N rows per shard, so the
            # pieces must PARTITION the pool — the tail rows, gathered.
            S7 = jnp.concatenate([st["lane"].astype(jnp.float32)[:, None],
                                  st["radiance"]], axis=1)
            piece = jnp.take(S7, perm[next_width:], axis=0)

        st2 = dict(
            rays=Rays(head[:, 0:3], head[:, 3:6],
                      jnp.full((next_width,), SECONDARY_TMIN, jnp.float32),
                      jnp.full((next_width,), SECONDARY_TMAX, jnp.float32)),
            weight=head[:, 6:9], radiance=head[:, 9:12],
            depth=head[:, 12].astype(jnp.int32),
            sp=head[:, 13].astype(jnp.int32),
            alive=jnp.arange(next_width, dtype=jnp.int32) < n_live,
            stk=stk2, stk_w=stkw2,
            lane=lane_h, n_fresh=n_live,
            traced=st["traced"], dropped=st["dropped"],
        )
        return st2, piece

    pieces = []
    st = dict(state, n_fresh=jnp.int32(N))
    for si, w_sz in enumerate(stage_widths):
        nxt = stage_widths[si + 1] if si + 1 < len(stage_widths) else None
        st, piece = run_stage(st, w_sz, nxt)
        if piece is not None:
            pieces.append(piece)
    final_lane = st["lane"].astype(jnp.float32)
    if fast_shrink and len(stage_widths) > 1:
        fw = stage_widths[-1]
        final_lane = jnp.where(
            jnp.arange(fw, dtype=jnp.int32) < st["n_fresh"],
            final_lane, _LANE_INVALID)
    pieces.append(jnp.concatenate(
        [final_lane[:, None], st["radiance"]], axis=1))

    # ---- stage 3: reassembly by lane id ----
    allp = jnp.concatenate(pieces, axis=0) if len(pieces) > 1 else pieces[0]
    if do_reshard:
        # Route exchanged lanes home (parallel.mesh.route_rows_home); the
        # gathered pieces partition the pool exactly (N rows per shard).
        from rayaccel_tpu.parallel.mesh import route_rows_home
        allp = route_rows_home(allp, mesh_axis, resharded)
    radiance = allp[:, 1:4]
    if len(pieces) > 1 or do_reshard:
        _, r0, r1, r2 = jax.lax.sort(
            (allp[:, 0], radiance[:, 0], radiance[:, 1], radiance[:, 2]),
            num_keys=1)
        radiance = jnp.stack([r0[:N], r1[:N], r2[:N]], axis=1)
    rad = radiance.reshape(W, R, 3)
    return rad, st["traced"], st["dropped"]


class WhittedRenderer(TiledRenderer):
    """Whitted ray tracer producing bounded ray trees per pixel."""

    def __init__(self, context: Context, camera: Camera, scene_data: SceneData,
                 tpu_scene: TpuScene | None = None,
                 environment: Environment | None = None,
                 shadows: bool = False, primary_only: bool = False):
        super().__init__(context, scene_data.viewport_width,
                         scene_data.viewport_height)
        self.camera = camera
        self.scene_data = scene_data
        self.shadows = shadows
        self.primary_only = primary_only
        self.backend = context.configuration.backend
        if tpu_scene is not None:
            self.scene = tpu_scene
            if isinstance(tpu_scene, ClusterScene):
                self.backend = "mxu"
            elif self.backend == "mxu":
                self.backend = "xla"
        elif self.backend == "mxu":
            self.scene = compile_clusters(scene_data)
        else:
            self.scene = compile_scene(scene_data)
        if environment is None:
            env_px = scene_data.env_pixels
            assert env_px is not None, "scene has no environment probe"
            environment = create_environment(env_px, env_px.shape[1], env_px.shape[0])
        self.environment = environment
        # Raw (pre-replication) bindings for render/api.py's rebind check.
        self._bound_scene = self.scene
        self._bound_env = self.environment
        # main.cpp:346 forces maxDepth=8 for the Whitted demo.
        self.max_depth = int(scene_data.max_depth)
        if context.mesh is not None:
            from rayaccel_tpu.parallel.mesh import replicate_scene
            self.scene = replicate_scene(context.mesh, self.scene)
            self.environment = replicate_scene(context.mesh, self.environment)

    def _extra_wave_args(self):
        return (self.camera.as_arrays(),)

    def _build_frame_body(self):
        """Frame-pooled ray trees (whitted_trace_frame) whenever the
        config would regroup on a cluster engine and trees actually
        bounce; primary_only (bench config 1) keeps the per-wave scan
        — its trees die after the first shade, so the pooled path's
        shrink plumbing would be pure overhead."""
        cfg = self.context.configuration
        if (self.primary_only or not cfg.regroup
                or self.backend != "mxu"):
            return super()._build_frame_body()
        scene, env = self.scene, self.environment
        max_depth = self.max_depth
        stack_size = max(cfg.max_shading_depth, max_depth + 1)
        backend = self.backend
        stack_depth = cfg.traversal_stack_depth
        trace_block = cfg.trace_block
        shadows = self.shadows
        mesh = self.context.mesh
        mesh_axis = "tiles" if mesh is not None else None
        n_shards = mesh.devices.size if mesh is not None else 1
        reshard = cfg.reshard_bounces

        min_stage_width = cfg.min_stage_width
        stage_ratio = cfg.whitted_stage_ratio
        hot_levels = cfg.whitted_hot_levels

        def frame_body(fb3, xs, ys, alives, key, spp, cam_arrays):
            del spp  # Whitted uses per-frame keys only
            tile = min(trace_block, xs.shape[1])
            rad, traced, dropped = whitted_trace_frame(
                scene, env, cam_arrays, xs, ys, alives, key, max_depth,
                stack_size, backend=backend, tile=tile,
                stack_depth=stack_depth, shadows=shadows,
                min_stage_width=min_stage_width,
                mesh_axis=mesh_axis, stage_ratio=stage_ratio,
                hot_levels=hot_levels,
                n_shards=n_shards, reshard=reshard)
            return fb3 + rad, traced, dropped

        return frame_body

    def _build_wave_fn(self):
        scene, env = self.scene, self.environment
        max_depth = self.max_depth
        stack_size = max(self.context.configuration.max_shading_depth,
                         max_depth + 1)
        stack_depth = self.context.configuration.traversal_stack_depth
        backend = self.backend
        shard_lanes = self.wave_size
        if self.context.mesh is not None:
            shard_lanes //= self.context.mesh.devices.size
        tile = min(self.context.configuration.trace_block, shard_lanes)

        shadows = self.shadows
        primary_only = self.primary_only
        regroup = self.context.configuration.regroup

        def wave_fn(x, y, alive, key, spp, cam_arrays):
            del spp  # Whitted uses per-frame keys only
            return whitted_trace_wave(
                scene, env, cam_arrays, x, y, alive, key,
                max_depth, stack_size, backend=backend, tile=tile,
                stack_depth=stack_depth, shadows=shadows,
                primary_only=primary_only, regroup=regroup)

        return wave_fn
