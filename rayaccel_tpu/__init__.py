"""rayaccel_tpu — a wavefront ray-tracing framework on JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
RayAccelerator reference (rasmusbarr/rayaccel): a producer/consumer
ray-streaming renderer that pairs throughput-oriented intersection with
SIMD material-sorted shading.

On one accelerator the CPU<->iGPU split of the reference collapses onto
one device: intersection ("test") and shading both run as fused XLA
stages over device-resident SoA ray streams, and the reference's
mutex/worker-thread scheduler (reference RayAccelerator.cpp:48-244) becomes a compiled
wavefront loop. Multi-device scaling shards tiles over a
``jax.sharding.Mesh`` and exchanges bounce rays with collectives.

Public API (mirrors reference RayAccelerator.h:95-116)::

    import rayaccel_tpu as racc
    racc.init()
    cfg   = racc.default_configuration()
    ctx   = racc.create_context(cfg)
    scene = racc.create_scene(ctx, vertices, indices)
    env   = racc.create_environment(ctx, colors, width, height)
    stats = racc.render(ctx, scene, env, callbacks)   # callbacks = integrator

Idiomatic usage goes through the renderer classes instead::

    from rayaccel_tpu import PathTracingRenderer, Camera
    r = PathTracingRenderer(ctx, camera, scene_data)
    frame = r.render_frame(...)
"""

from rayaccel_tpu.config import Configuration, ContextInfo, default_configuration
from rayaccel_tpu.context import Context, create_context, destroy, info, init, deinit
from rayaccel_tpu.types import Rays, Hits, Stats, INVALID_TRIANGLE
from rayaccel_tpu.camera import Camera
from rayaccel_tpu.environment import Environment, create_environment
from rayaccel_tpu.materials import MaterialTable, reflective_diffuse
from rayaccel_tpu.scene import SceneData, TpuScene, create_scene
from rayaccel_tpu.render.api import render
from rayaccel_tpu.render.tiled import TiledRenderer
from rayaccel_tpu.render.pathtracer import PathTracingRenderer
from rayaccel_tpu.render.whitted import WhittedRenderer

__all__ = [
    "Configuration", "ContextInfo", "default_configuration",
    "Context", "create_context", "destroy", "info", "init", "deinit",
    "Rays", "Hits", "Stats", "INVALID_TRIANGLE",
    "Camera", "Environment", "create_environment",
    "MaterialTable", "reflective_diffuse",
    "SceneData", "TpuScene", "create_scene",
    "render", "TiledRenderer", "PathTracingRenderer", "WhittedRenderer",
]

__version__ = "0.1.0"
