"""Wavefront path tracer.

Re-design of the reference PathTracingRenderer (reference
PathTracingRenderer.cpp:53-570) as a compiled wavefront. The
reference's scheduler-driven spawn/shade callbacks with material-sorted
8-wide batches become one compiled wave: a ``lax.while_loop`` over bounces
where every iteration traces the surviving rays and regenerates the
continuation rays in place.

Wavefront specifics:

- Material sorting is unnecessary: BSDF dispatch is branchless parameter
  gathering (rayaccel_tpu.materials), so the radix sort at
  PathTracingRenderer.cpp:16-51 has no equivalent.
- A lane serves exactly one pixel for its whole path, so radiance
  accumulates in per-lane registers; the framebuffer is written once per
  wave as a contiguous slice (no scatters; replaces the reference's racy
  shared-framebuffer adds, SURVEY.md §5, with something deterministic).
- A path samples the environment at most once (paths terminate on their
  first miss), so the probe lookup is deferred out of the bounce loop and
  executed once per wave.
- With the default "mxu" backend, shading consumes the tracer's attribute
  rows (one winner-row gather per trace, no per-vertex gathers).
- Depth lives in its own (R,) array rather than the pixel id's top byte
  (PathTracingRenderer.cpp:414) — same semantics without bit packing.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from rayaccel_tpu.camera import Camera, generate_pixel_rays, id_uniform
from rayaccel_tpu.context import Context
from rayaccel_tpu.environment import (Environment, create_environment,
                                      sample_environment_onehot)
from rayaccel_tpu.materials import sample_reflective_diffuse
from rayaccel_tpu.ops.trace import trace_bvh
from rayaccel_tpu.ops.trace_mxu import trace_mxu
from rayaccel_tpu.render.regroup import coherence_key, regroup_state
from rayaccel_tpu.render.shading import (SECONDARY_TMAX, SECONDARY_TMIN,
                                         interpolate_surface, merge_rays,
                                         spawn_secondary, surface_from_attrs)
from rayaccel_tpu.render.tiled import TiledRenderer
from rayaccel_tpu.scene.clusters import ClusterScene, compile_clusters
from rayaccel_tpu.scene.compile import compile_scene
from rayaccel_tpu.scene.data import SceneData
from rayaccel_tpu.types import Hits, INVALID_TRIANGLE, Rays

# Piece rows carrying this lane value are live-lane duplicates emitted by
# the gather-free fast shrink; the reassembly sort pushes them past every
# real lane id (< 2^24) and a [:N] slice drops them.
_LANE_INVALID = jnp.float32(3e38)


def pt_shade(surf, rays, weight, key, lane):
    """One shading step given a surface frame: the vectorized analog of
    PathTracingRenderer::shade's active path
    (PathTracingRenderer.cpp:133-463). Returns (new_rays, new_weight, ok).

    BSDF random draws are keyed per lane id (placement-invariant — see
    camera.id_uniform)."""
    rnd = id_uniform(key, lane, 3)
    wo = -rays.d
    wi, color, transmitted = sample_reflective_diffuse(
        surf.mat_params, rnd, surf.ns, wo)
    new_weight = weight * color
    new_rays, ok = spawn_secondary(surf, wi, new_weight, transmitted,
                                   surf.d_dot_ng)
    return new_rays, new_weight, ok


def _trace_and_surface(scene, rays, alive, bk, tile, stack_depth):
    """Dispatch one closest-hit trace + shading-frame build to engine
    ``bk``. Returns (hits, surf)."""
    if bk == "xla":
        hits = trace_bvh(scene, rays, env=None, active=alive,
                         stack_depth=stack_depth)
        surf = interpolate_surface(scene, rays, hits,
                                   alive & (hits.tri >= 0))
        return hits, surf
    res = trace_mxu(scene, rays, env=None, active=alive, tile=tile)
    surf = surface_from_attrs(res.attrs, scene.mat_params, rays, res.hits)
    return res.hits, surf


def _shade_advance(hits, surf, rays, weight, depth, alive, miss_d, miss_w,
                   skey, max_depth, lane):
    """Post-trace lane-state advance shared by the per-wave and pooled
    paths: terminal-miss capture, depth budgeting
    (PathTracingRenderer.cpp:120-121), BSDF sample + continuation spawn.
    Returns (rays, weight, depth, alive, miss_d, miss_w). ``lane`` keys
    the BSDF draws per lane id (placement-invariant, see
    camera.id_uniform)."""
    # Terminal miss: remember direction+weight; the env probe lookup is
    # deferred out of the loop (one sample per path, total).
    miss = alive & (hits.tri == INVALID_TRIANGLE)
    miss_d = jnp.where(miss[:, None], rays.d, miss_d)
    miss_w = jnp.where(miss[:, None], weight, miss_w)

    active = alive & (hits.tri >= 0) & (depth < max_depth)
    new_rays, new_weight, ok = pt_shade(surf, rays, weight, skey, lane)
    alive2 = active & ok
    rays2 = merge_rays(alive2, new_rays, rays)
    weight2 = jnp.where(alive2[:, None], new_weight, weight)
    depth2 = depth + active.astype(jnp.int32)
    return rays2, weight2, depth2, alive2, miss_d, miss_w


def _primary_rays(cam_arrays, x, y, wave_key, sampler, spp_index,
                  sampler_key):
    """Per-wave primary ray generation (uniform jitter, or the progressive
    R2 low-discrepancy sequence for bench config 4)."""
    if sampler == "stratified":
        # Low-discrepancy progressive jitter: the R2 sequence advanced per
        # sample, Cranley-Patterson-rotated per PIXEL by a frame-independent
        # random offset — stratified across spp where the reference reseeds
        # rand() per call (PathTracingRenderer.cpp:102). The rotation must
        # be a function of the pixel, not the lane index: waves reuse lane
        # offsets, so a lane-indexed rotation would tile identical jitter
        # sequences across wave-sized screen regions.
        assert spp_index is not None and sampler_key is not None
        pix = (y.astype(jnp.uint32) << jnp.uint32(16)) | x.astype(jnp.uint32)
        rot = jax.vmap(
            lambda p: jax.random.uniform(
                jax.random.fold_in(sampler_key, p), (2,), jnp.float32))(pix)
        g = jnp.float32(0.7548776662466927)   # plastic-constant R2
        g2 = jnp.float32(0.5698402909980532)
        s_f = spp_index.astype(jnp.float32)
        jx = jnp.mod(rot[:, 0] + s_f * g, 1.0)
        jy = jnp.mod(rot[:, 1] + s_f * g2, 1.0)
        return generate_pixel_rays(cam_arrays, x, y, jitter=(jx, jy))
    return generate_pixel_rays(cam_arrays, x, y,
                               key=jax.random.fold_in(wave_key, 0))


@partial(jax.jit, static_argnames=("max_depth", "backend", "tile",
                                   "stack_depth", "regroup", "sampler"))
def pt_trace_wave(scene, env: Environment, cam_arrays,
                  x: jnp.ndarray, y: jnp.ndarray, alive0: jnp.ndarray,
                  key: jax.Array, max_depth: int, backend: str = "mxu",
                  tile: int = 512, stack_depth: int = 48,
                  regroup: bool = True, sampler: str = "uniform",
                  spp_index: jnp.ndarray | None = None,
                  sampler_key: jax.Array | None = None):
    """Trace one wave of pixels to completion (all bounces).

    Returns (radiance, rays_traced, dropped): per-lane accumulated
    radiance; ``dropped`` is 0 (both engines are exact, and a path
    parks nothing).

    With ``regroup`` (cluster backend only), the whole lane state is
    re-sorted between bounces by a spatial coherence key (dead lanes
    last) — the wavefront form of the reference's ray-stream regrouping
    (SURVEY.md §7); lanes carry their original index for the final
    framebuffer unsort.
    """
    R = x.shape[0]
    rays = _primary_rays(cam_arrays, x, y, key, sampler, spp_index,
                         sampler_key)
    do_regroup = regroup and backend == "mxu"
    if do_regroup:
        bmin = jnp.min(scene.cl_bbmin, axis=0)
        bext = jnp.max(scene.cl_bbmax, axis=0) - bmin
        binv = 1.0 / jnp.maximum(bext, 1e-20)
    # Carry inits derive from ray/pixel inputs (shard_map varying-axes).
    state = dict(
        rays=rays,
        weight=jnp.ones_like(rays.o),
        depth=x * 0,
        alive=alive0,
        lane=x * 0 + jnp.arange(R, dtype=jnp.int32),
        miss_d=rays.d,
        miss_w=rays.o * 0.0,
        traced=jnp.sum(x) * 0,
        bounce=jnp.int32(0),
    )

    def trace_and_surface(rays, alive):
        return _trace_and_surface(scene, rays, alive, backend, tile,
                                  stack_depth)

    # Live-prefix buckets: regrouping compacts live lanes to the front of
    # the wave, so a bounce trace only needs the smallest power-of-two
    # prefix covering the live count — a lax.switch over pre-compiled
    # sizes (no host sync). The wavefront analog of the reference recycling
    # partially-filled ray streams instead of tracing empty slots
    # (RayAccelerator.cpp:77-82 stream routing by fill level).
    sizes = [s for s in (R // 4, R // 2)
             if s >= tile and s % tile == 0] + [R]

    def traced_prefix(rays, alive):
        n_live = jnp.sum(alive.astype(jnp.int32))

        def make_branch(size):
            def branch(rays, alive):
                sub = Rays(rays.o[:size], rays.d[:size],
                           rays.tmin[:size], rays.tmax[:size])
                hits, surf = trace_and_surface(sub, alive[:size])
                if size == R:
                    return hits, surf
                pad = R - size

                def tail(x, fill=0):
                    widths = ((0, pad),) + ((0, 0),) * (x.ndim - 1)
                    return jnp.pad(x, widths, constant_values=fill)

                hits = Hits(tri=tail(hits.tri, INVALID_TRIANGLE),
                            t=tail(hits.t), u=tail(hits.u), v=tail(hits.v),
                            miss_rgb=tail(hits.miss_rgb))
                surf = jax.tree.map(tail, surf)
                return hits, surf
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
        traced = s["traced"] + jnp.sum(alive.astype(jnp.int32))

        skey = jax.random.fold_in(key, s["bounce"] + 1)
        rays, weight, depth, alive, miss_d, miss_w = _shade_advance(
            hits, surf, rays, s["weight"], s["depth"], alive,
            s["miss_d"], s["miss_w"], skey, max_depth, lane=s["lane"])
        lane = s["lane"]

        if do_regroup:
            k = coherence_key(rays, alive, bmin, binv)
            rays, (weight, depth, alive, lane, miss_d, miss_w) = \
                regroup_state(k, rays, [weight, depth, alive, lane,
                                        miss_d, miss_w])

        return dict(
            rays=rays,
            weight=weight,
            depth=depth,
            alive=alive,
            lane=lane,
            miss_d=miss_d,
            miss_w=miss_w,
            traced=traced,
            bounce=s["bounce"] + 1,
        )

    # Peel the primary trace out of the loop: it runs at full width,
    # bounces run on the live prefix. lax.cond keeps the all-dead-wave
    # (padding) case cheap.
    state = jax.lax.cond(jnp.any(state["alive"]), body, lambda s: s, state)
    out = jax.lax.while_loop(
        cond, partial(body, use_prefix=do_regroup), state)
    env_rgb = sample_environment_onehot(env, out["miss_d"])
    radiance = out["miss_w"] * env_rgb
    if do_regroup:
        # Unsort back to original lane order for the framebuffer write.
        _, rcols = regroup_state(out["lane"],
                                 out["rays"], [radiance])
        radiance = rcols[0]
    return radiance, out["traced"], jnp.int32(0)


def _reshard_balance(st, axis, D):
    """Cross-chip bounce load balance for the PT pool: the shared striped
    exchange (parallel.mesh.reshard_balance_cols) over the PT lane-state
    columns. Lane ids are GLOBAL (shard * N + local), so the radiance
    pieces are routed home with the inverse exchange at reassembly, and
    the lane-keyed bounce RNG (camera.id_uniform) makes the image
    BITWISE invariant to the re-sharding. Returns (state, resharded?)."""
    from rayaccel_tpu.parallel.mesh import reshard_balance_cols
    r = st["rays"]
    S = jnp.concatenate([
        r.o, r.d, r.tmin[:, None], r.tmax[:, None], st["weight"],
        st["miss_d"], st["miss_w"],
        st["depth"].astype(jnp.float32)[:, None],
        st["alive"].astype(jnp.float32)[:, None]], axis=1)
    S, lane, need = reshard_balance_cols(S, st["lane"], st["alive"],
                                         axis, D)
    st = dict(
        st,
        rays=Rays(S[:, 0:3], S[:, 3:6], S[:, 6], S[:, 7]),
        weight=S[:, 8:11], miss_d=S[:, 11:14], miss_w=S[:, 14:17],
        depth=S[:, 17].astype(jnp.int32), alive=S[:, 18] > 0,
        lane=lane)
    return st, need


@partial(jax.jit, static_argnames=("max_depth", "backend", "tile",
                                   "stack_depth", "sampler",
                                   "min_stage_width", "mesh_axis",
                                   "n_shards", "reshard"))
def pt_trace_frame(scene, env: Environment, cam_arrays,
                   xs: jnp.ndarray, ys: jnp.ndarray, alives: jnp.ndarray,
                   key: jax.Array, max_depth: int, backend: str = "mxu",
                   tile: int = 512, stack_depth: int = 48,
                   sampler: str = "uniform",
                   spp_index: jnp.ndarray | None = None,
                   sampler_key: jax.Array | None = None,
                   min_stage_width: int = 8192,
                   mesh_axis: str | None = None,
                   n_shards: int = 1,
                   reshard: bool = True):
    """Frame-pooled wavefront: trace a whole frame with ONE bounce loop.

    The per-wave structure (pt_trace_wave under a scan) pays every bounce
    fixed cost — cluster cull, shade at wave width, loop launch — once
    per wave per bounce, and each wave's while_loop runs to ITS deepest
    lane. This function instead:

    1. traces + shades the coherent primaries one wave at a time under a
       ``lax.scan`` (spatially-swizzled tiles),
    2. pools ALL surviving continuation rays across the frame into one
       frame-order lane array and runs a single frame-level bounce loop
       whose width shrinks in stages as paths die.

    Fixed costs are paid once per BOUNCE instead of once per wave-bounce
    (~15x fewer on a 983k-lane frame). This is the wavefront analog of
    the reference's global in-flight ray pool fed by partial streams
    (RayAccelerator.cpp:48-90 spawn routing + :436 maxRaysInFlight)
    rather than per-tile scheduling.

    Returns (radiance (W, R, 3) in original lane order, traced, dropped).
    """
    W, R = xs.shape
    N = W * R
    # Lane ids are GLOBAL across the mesh (shard * N + local) and ride
    # the reassembly sort as float32 payloads (stage 3); float32 is exact
    # only below 2^24, so larger pools would silently scramble the
    # framebuffer. 2^24 covers a 4K frame on an 8-chip mesh.
    assert N * n_shards < (1 << 24), \
        f"frame pool {N} x {n_shards} shards >= 2^24: lane ids lose " \
        "precision in the float32 reassembly sort"
    shard = 0 if mesh_axis is None else jax.lax.axis_index(mesh_axis)
    lane0 = jnp.arange(N, dtype=jnp.int32) + shard * N

    def rng_id(lane):
        # Every draw is keyed by the lane's position in the UNSHARDED
        # (W, R * n_shards) frame, never by its shard or array position:
        # a frame renders the same on any device count, and re-sharding
        # or shrinking the pool cannot touch a lane's random stream.
        local = lane % N
        return ((local // R) * (R * n_shards) + (lane // N) * R
                + local % R)

    # ---- stage 1: primary trace + first shade, wave by wave ----
    def prim_step(carry, inputs):
        traced, w = carry
        x, y, alive0 = inputs
        wkey = jax.random.fold_in(key, w)
        rays = _primary_rays(cam_arrays, x, y, wkey, sampler, spp_index,
                             sampler_key)
        zero3 = jnp.zeros((R, 3), jnp.float32)
        ones3 = jnp.ones((R, 3), jnp.float32)
        depth0 = jnp.zeros((R,), jnp.int32)

        def live(_):
            hits, surf = _trace_and_surface(scene, rays, alive0, backend,
                                            tile, stack_depth)
            lane_w = jax.lax.dynamic_slice(lane0, (w * R,), (R,))
            return _shade_advance(hits, surf, rays, ones3, depth0, alive0,
                                  rays.d, zero3,
                                  jax.random.fold_in(wkey, 1), max_depth,
                                  lane=rng_id(lane_w))

        def dead(_):
            return (rays, ones3, depth0, alive0, rays.d, zero3)

        out = jax.lax.cond(jnp.any(alive0), live, dead, None)
        n = jnp.sum(alive0.astype(jnp.int32))
        return (traced + n, w + 1), out

    (traced0, _), stacked = jax.lax.scan(
        prim_step, (jnp.int32(0), jnp.int32(0)), (xs, ys, alives))
    rays_s, weight_s, depth_s, alive_s, miss_d_s, miss_w_s = stacked

    def flat(a):
        return a.reshape((N,) + a.shape[2:])

    # ---- stage 2: one frame-level bounce loop over the pooled lanes ----
    # The lane state stays in FRAME ORDER for the whole loop and moves
    # only at the staged width shrinks below: a per-bounce permute of the
    # whole pool (multi-operand sort or row gather) costs a frame-scale
    # state move every bounce.
    state = dict(
        rays=Rays(flat(rays_s.o), flat(rays_s.d), flat(rays_s.tmin),
                  flat(rays_s.tmax)),
        weight=flat(weight_s), depth=flat(depth_s), alive=flat(alive_s),
        miss_d=flat(miss_d_s), miss_w=flat(miss_w_s),
        lane=lane0,
        traced=traced0, bounce=jnp.int32(0),
    )

    # Cross-chip bounce balance: sky shards die after stage 1 while
    # geometry shards keep their whole pool alive; exchange once, before
    # the bounce loop, when the measured imbalance pays for the move.
    do_reshard = mesh_axis is not None and n_shards > 1 and reshard
    if do_reshard:
        state, resharded = _reshard_balance(state, mesh_axis, n_shards)

    def bounce_body(st):
        n_live = jnp.sum(st["alive"].astype(jnp.int32))
        hits, surf = _trace_and_surface(scene, st["rays"], st["alive"],
                                        backend, tile, stack_depth)
        skey = jax.random.fold_in(key, 4096 + st["bounce"])
        rays2, weight2, depth2, alive2, miss_d2, miss_w2 = \
            _shade_advance(hits, surf, st["rays"], st["weight"],
                           st["depth"], st["alive"], st["miss_d"],
                           st["miss_w"], skey, max_depth,
                           lane=rng_id(st["lane"]))
        out = dict(
            rays=rays2, weight=weight2, depth=depth2, alive=alive2,
            miss_d=miss_d2, miss_w=miss_w2, lane=st["lane"],
            traced=st["traced"] + n_live,
            bounce=st["bounce"] + 1,
        )
        if "n_fresh" in st:
            out["n_fresh"] = st["n_fresh"]
        return out

    # Staged width shrink: a bounce iteration pays the cluster cull and
    # the shade at the POOL width no matter how few lanes remain. When
    # the live set fits a quarter of the current width, the pool shrinks
    # ONCE — live-first 1-operand sort, one head row-gather — and every
    # later bounce runs at the smaller width. Lanes left behind are dead;
    # their (lane, miss_d, miss_w) rows are saved as a piece for the
    # final env pass. No scatters anywhere.
    # min_stage_width floors the shrink ladder (tests force/disable the
    # shrink with it; shrink and no-shrink paths must agree bitwise).
    # At most max_depth stages can ever hold live lanes (bounce b runs
    # in stage <= b), so cap the ladder there: an uncapped ladder runs
    # its tail shrinks on an all-dead pool — pure gather waste.
    stage_widths = [N]
    while (len(stage_widths) < max_depth
           and stage_widths[-1] // 4 >= min_stage_width):
        stage_widths.append(-(-stage_widths[-1] // 4 // 1024) * 1024)

    # Fast shrink (single-shard / no-reshard pools): emit the dead-lane
    # piece at FULL width from CARRIED columns only — rows that must not
    # contribute are invalid-marked (lane = _LANE_INVALID) and dropped by
    # the final reassembly sort's [:N] slice. This deletes the tail
    # row-gather entirely (a 7-column gather of the whole dead tail) and
    # shrinks the head haul 19 -> 10 columns, exploiting invariants
    # of live lanes:
    #   - miss_w == 0 (a terminal miss kills the lane), so miss_d is
    #     irrelevant and both reset to (d, 0) after the haul;
    #   - tmin/tmax are the SECONDARY_* constants (spawn_secondary);
    #   - the live-first sort is stable, so alive == (position < live).
    # Exactly-once emission: a lane's row is valid in the piece of the
    # first stage it is BOTH fresh (alive at stage entry) and dead.
    # Positions never move within a stage, and the head is live-first,
    # so freshness is just (position < n_fresh) with the SCALAR n_fresh
    # = live count at the previous shrink (N at stage 1, where
    # initially-dead padding lanes must emit too) — dead padding lanes
    # hauled into the head as filler are not fresh and never re-emit.
    # With resharding, lanes cross shards and the route-home exchange
    # needs exactly-N rows per shard — the gathered-piece path remains.
    fast_shrink = not do_reshard
    if fast_shrink:
        state["n_fresh"] = jnp.int32(N)

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

        # Shrink: live lanes first, head keeps the live set (live count
        # <= next_width by the loop condition), tail piece keeps only
        # what the env pass needs.
        r = st["rays"]
        iota_w = jnp.arange(width, dtype=jnp.int32)
        perm = jax.lax.sort(
            (jnp.where(st["alive"], iota_w, jnp.int32(0x7FFFFFFF)),
             iota_w), num_keys=1)[1]
        if fast_shrink:
            n_live = jnp.sum(st["alive"].astype(jnp.int32))
            S = jnp.concatenate([
                r.o, r.d, st["weight"],
                st["depth"].astype(jnp.float32)[:, None]], axis=1)
            head = jnp.take(S, perm[:next_width], axis=0)
            lane_h = jnp.take(st["lane"], perm[:next_width])
            valid = (iota_w < st["n_fresh"]) & ~st["alive"]
            piece = jnp.concatenate([
                jnp.where(valid, st["lane"].astype(jnp.float32),
                          _LANE_INVALID)[:, None],
                st["miss_d"], st["miss_w"]], axis=1)
            nw = next_width
            st2 = dict(
                rays=Rays(head[:, 0:3], head[:, 3:6],
                          jnp.full((nw,), SECONDARY_TMIN, jnp.float32),
                          jnp.full((nw,), SECONDARY_TMAX, jnp.float32)),
                weight=head[:, 6:9],
                miss_d=head[:, 3:6],
                miss_w=jnp.zeros((nw, 3), jnp.float32),
                depth=head[:, 9].astype(jnp.int32),
                alive=jnp.arange(nw, dtype=jnp.int32) < n_live,
                lane=lane_h,
                n_fresh=n_live,
                traced=st["traced"], bounce=st["bounce"],
            )
            return st2, piece
        S = jnp.concatenate([
            r.o, r.d, r.tmin[:, None], r.tmax[:, None], st["weight"],
            st["miss_d"], st["miss_w"],
            st["depth"].astype(jnp.float32)[:, None],
            st["alive"].astype(jnp.float32)[:, None]], axis=1)
        head = jnp.take(S, perm[:next_width], axis=0)
        lane_h = jnp.take(st["lane"], perm[:next_width])

        S7 = jnp.concatenate([st["lane"].astype(jnp.float32)[:, None],
                              st["miss_d"], st["miss_w"]], axis=1)
        piece = jnp.take(S7, perm[next_width:], axis=0)

        st2 = dict(
            rays=Rays(head[:, 0:3], head[:, 3:6], head[:, 6], head[:, 7]),
            weight=head[:, 8:11], miss_d=head[:, 11:14],
            miss_w=head[:, 14:17],
            depth=head[:, 17].astype(jnp.int32),
            alive=head[:, 18] > 0, lane=lane_h,
            traced=st["traced"], bounce=st["bounce"],
        )
        return st2, piece

    pieces = []
    st = state
    for si, w_s in enumerate(stage_widths):
        nxt = stage_widths[si + 1] if si + 1 < len(stage_widths) else None
        st, piece = run_stage(st, w_s, nxt)
        if piece is not None:
            pieces.append(piece)
    final_lane = st["lane"].astype(jnp.float32)
    if fast_shrink and len(stage_widths) > 1:
        # Non-fresh rows (dead padding hauled as head filler) already
        # emitted their contribution in an earlier stage's piece.
        fw = stage_widths[-1]
        final_lane = jnp.where(
            jnp.arange(fw, dtype=jnp.int32) < st["n_fresh"],
            final_lane, _LANE_INVALID)
    pieces.append(jnp.concatenate(
        [final_lane[:, None], st["miss_d"], st["miss_w"]], axis=1))

    # ---- stage 3: deferred env lookup + reassembly by lane id ----
    # Fast-shrink pieces total ~1.31N rows (full stage widths) with live
    # lanes' rows invalid-marked; the sort below floats the N real lanes
    # to the front and the [:N] slice drops the rest. Gathered pieces
    # (reshard path) partition the pool exactly (N rows).
    allp = jnp.concatenate(pieces, axis=0) if len(pieces) > 1 else pieces[0]
    # Lanes with miss_w == 0 (hit lanes, cutoff kills, invalid piece
    # rows) multiply the env sample by zero anyway — pin their direction
    # to a constant so the quad-table gather's dead rows all fetch ONE
    # row (a gather's cost grows with the entropy of its indices).
    # Bitwise identical radiance: 0 * finite == 0 either way.
    is_miss = jnp.sum(allp[:, 4:7], axis=1) > 0
    miss_dir = jnp.where(is_miss[:, None], allp[:, 1:4],
                         jnp.asarray([0.0, 1.0, 0.0], jnp.float32))
    env_rgb = sample_environment_onehot(env, miss_dir)
    radiance = allp[:, 4:7] * env_rgb
    lane_f = allp[:, 0]
    if do_reshard:
        # Route exchanged lanes home (parallel.mesh.route_rows_home: the
        # outbound stripe sent exactly N/D lanes to each shard, dead or
        # alive, so one lane-sort + tiled all_to_all returns every lane
        # to its producer).
        from rayaccel_tpu.parallel.mesh import route_rows_home
        rows = jnp.concatenate([lane_f[:, None], radiance], axis=1)
        rows = route_rows_home(rows, mesh_axis, resharded)
        lane_f, radiance = rows[:, 0], rows[:, 1:4]
    if len(pieces) > 1 or do_reshard:
        _, r0, r1, r2 = jax.lax.sort(
            (lane_f, radiance[:, 0], radiance[:, 1], radiance[:, 2]),
            num_keys=1)
        radiance = jnp.stack([r0[:N], r1[:N], r2[:N]], axis=1)
    rad = radiance.reshape(W, R, 3)
    return rad, st["traced"], jnp.int32(0)


class PathTracingRenderer(TiledRenderer):
    """Progressive wavefront path tracer over a compiled scene."""

    def __init__(self, context: Context, camera: Camera, scene_data: SceneData,
                 tpu_scene=None, environment: Environment | None = None):
        super().__init__(context, scene_data.viewport_width,
                         scene_data.viewport_height)
        self.camera = camera
        self.scene_data = scene_data
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
        # Raw (pre-replication) bindings: render/api.py's rebind check
        # compares against these, so re-passing the same scene object
        # every frame (the reference re-publish pattern,
        # RayAccelerator.cpp:741-746) never drops the compiled frame fn.
        self._bound_scene = self.scene
        self._bound_env = self.environment
        self.max_depth = int(scene_data.max_depth)
        self.sampler = context.configuration.sampler
        self._sampler_key = jax.random.PRNGKey(0x5EED)
        if context.mesh is not None:
            from rayaccel_tpu.parallel.mesh import replicate_scene
            self.scene = replicate_scene(context.mesh, self.scene)
            self.environment = replicate_scene(context.mesh, self.environment)

    def _extra_wave_args(self):
        return (self.camera.as_arrays(),)

    def _build_frame_body(self):
        """Use the frame-pooled bounce loop whenever regrouping is on and
        the cluster engine is selected; otherwise fall back to the
        per-wave scan body."""
        cfg = self.context.configuration
        if not (cfg.regroup and self.backend == "mxu"):
            return super()._build_frame_body()
        scene, env = self.scene, self.environment
        max_depth = self.max_depth
        backend = self.backend
        stack_depth = cfg.traversal_stack_depth
        trace_block = cfg.trace_block
        sampler = self.sampler
        sampler_key = self._sampler_key
        mesh = self.context.mesh
        mesh_axis = "tiles" if mesh is not None else None
        n_shards = mesh.devices.size if mesh is not None else 1
        reshard = cfg.reshard_bounces

        min_stage_width = cfg.min_stage_width

        def frame_body(fb3, xs, ys, alives, key, spp, cam_arrays):
            tile = min(trace_block, xs.shape[1])
            rad, traced, dropped = pt_trace_frame(
                scene, env, cam_arrays, xs, ys, alives, key, max_depth,
                backend=backend, tile=tile, stack_depth=stack_depth,
                sampler=sampler, spp_index=spp, sampler_key=sampler_key,
                min_stage_width=min_stage_width,
                mesh_axis=mesh_axis, n_shards=n_shards, reshard=reshard)
            return fb3 + rad, traced, dropped

        return frame_body

    def _build_wave_fn(self):
        scene, env = self.scene, self.environment
        max_depth = self.max_depth
        backend = self.backend
        stack_depth = self.context.configuration.traversal_stack_depth
        shard_lanes = self.wave_size
        if self.context.mesh is not None:
            shard_lanes //= self.context.mesh.devices.size
        tile = min(self.context.configuration.trace_block, shard_lanes)

        regroup = self.context.configuration.regroup
        sampler = self.sampler
        sampler_key = self._sampler_key

        def wave_fn(x, y, alive, key, spp, cam_arrays):
            return pt_trace_wave(scene, env, cam_arrays, x, y, alive, key,
                                 max_depth, backend=backend, tile=tile,
                                 stack_depth=stack_depth, regroup=regroup,
                                 sampler=sampler,
                                 spp_index=spp,
                                 sampler_key=sampler_key)

        return wave_fn
