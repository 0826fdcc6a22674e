"""Per-stage device timing (SURVEY.md §5, tracing/profiling row).

The reference measures only wall-clock Mrays/s per frame (main.cpp:208-231).
This module times each pipeline stage of one wave — primary trace, bounce
trace, shade, regroup, environment sampling — as N iterations chained
*inside one jit* with a hard data dependency between iterations (so
nothing is hoisted), waited on with ``block_until_ready``.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp


def _timed_loop(fn, args, iters):
    """Time ``fn`` applied ``iters`` times with a chained perturbation so
    nothing is hoisted or deduplicated. Returns seconds per iteration."""

    @jax.jit
    def run(eps, *args):
        def step(i, acc):
            out = fn(acc, *args)
            return jnp.sum(out) * 1e-12 + eps
        return jax.lax.fori_loop(0, iters, step, eps)

    jax.block_until_ready(run(jnp.float32(0), *args))      # compile + warm
    t0 = time.perf_counter()
    jax.block_until_ready(run(jnp.float32(1e-7), *args))
    return (time.perf_counter() - t0) / iters


def profile_stages(renderer, key=None, iters: int = 10) -> dict:
    """Measure per-stage times of one wave of the given PathTracing/Whitted
    renderer. Returns {stage: ms}. Stages: primary_trace, bounce_trace,
    shade, regroup, env_sample."""
    from rayaccel_tpu.camera import generate_pixel_rays
    from rayaccel_tpu.environment import sample_environment_onehot
    from rayaccel_tpu.materials import sample_reflective_diffuse
    from rayaccel_tpu.ops.trace import trace_bvh
    from rayaccel_tpu.ops.trace_mxu import trace_mxu
    from rayaccel_tpu.render.regroup import coherence_key, regroup_state
    from rayaccel_tpu.types import Rays

    key = key if key is not None else jax.random.PRNGKey(0)
    x, y, alive = renderer._wave_inputs[len(renderer._wave_inputs) // 2]
    cam = renderer.camera.as_arrays()
    rays = generate_pixel_rays(cam, x, y, key=key)
    scene = renderer.scene
    env = renderer.environment
    R = x.shape[0]
    tile = min(renderer.context.configuration.trace_block, R)

    def trace(eps, o, d, tmin, tmax, act):
        r = Rays(o, d, tmin + eps, tmax)
        if renderer.backend == "xla":
            return trace_bvh(scene, r, active=act).t
        return trace_mxu(scene, r, active=act, tile=tile).hits.t

    out = {}
    targs = (rays.o, rays.d, rays.tmin, rays.tmax, alive)
    out["primary_trace_ms"] = _timed_loop(trace, targs, iters) * 1e3
    # Bounce-shaped rays: scattered directions from jittered origins.
    kd = jax.random.normal(jax.random.fold_in(key, 1), (R, 3))
    kd = kd / jnp.linalg.norm(kd, axis=-1, keepdims=True)
    brays = Rays(rays.o + rays.d, kd, rays.tmin, rays.tmax)
    bargs = (brays.o, brays.d, brays.tmin, brays.tmax, alive)
    out["bounce_trace_ms"] = _timed_loop(trace, bargs, iters) * 1e3

    mat = jnp.broadcast_to(scene.mat_params[:1], (R, scene.mat_params.shape[1]))
    ns = -rays.d

    def shade(eps, d):
        rnd = jax.random.uniform(jax.random.PRNGKey(3), (R, 3)) + eps
        wi, color, _ = sample_reflective_diffuse(mat, rnd % 1.0, ns, -d)
        return wi + color
    out["shade_ms"] = _timed_loop(shade, (rays.d,), iters) * 1e3

    if hasattr(scene, "cl_bbmin"):
        bmin = jnp.min(scene.cl_bbmin, axis=0)
        binv = 1.0 / jnp.maximum(jnp.max(scene.cl_bbmax, axis=0) - bmin,
                                 1e-20)

        def regroup(eps, o, d, tmin, tmax, act):
            r = Rays(o + eps, d, tmin, tmax)
            ck = coherence_key(r, act, bmin, binv)
            r2, (a2,) = regroup_state(ck, r, [act])
            return r2.o + a2[:, None]
        out["regroup_ms"] = _timed_loop(regroup, targs, iters) * 1e3

    def envs(eps, d):
        return sample_environment_onehot(env, d + eps)
    out["env_sample_ms"] = _timed_loop(envs, (rays.d,), iters) * 1e3
    return {k: round(v, 3) for k, v in out.items()}
