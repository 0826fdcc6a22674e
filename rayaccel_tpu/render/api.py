"""racc::render-shaped frame entry point (reference RayAccelerator.h:115,
RayAccelerator.cpp:738-759).

The reference publishes the scene/environment/callbacks to persistent
workers and blocks on a condition variable until the frame drains. Here a
frame is a plain function call: the renderer object carries the
spawn/shade behavior (the callback analog) and the wave loop is the frame
barrier.
"""

from __future__ import annotations

import jax

from rayaccel_tpu.context import Context
from rayaccel_tpu.types import Stats


def render(context: Context, scene, environment, renderer,
           key: jax.Array | None = None) -> Stats:
    """Render one progressive frame through ``renderer`` (a TiledRenderer
    subclass). ``scene``/``environment`` override the renderer's current
    bindings when given, mirroring how the reference re-publishes them per
    frame (RayAccelerator.cpp:741-746).

    The compiled frame fn closes over the scene/environment arrays, so an
    override must drop the ``_frame_fn`` cache (render/tiled.py:148) —
    the next frame rebuilds the closure around the new bindings.

    Identity is checked against the RAW bound objects (``_bound_scene``/
    ``_bound_env``), not ``renderer.scene`` — with a mesh context the
    latter is the replicated tree, so comparing against it would
    re-replicate and recompile on EVERY re-publish of the same scene
    (a full XLA recompile per frame)."""
    rebind = False
    if scene is not None and scene is not getattr(renderer, "_bound_scene",
                                                  renderer.scene):
        renderer.scene = scene
        renderer._bound_scene = scene
        rebind = True
    if environment is not None and environment is not getattr(
            renderer, "_bound_env", renderer.environment):
        renderer.environment = environment
        renderer._bound_env = environment
        rebind = True
    if rebind:
        if context.mesh is not None:
            from rayaccel_tpu.parallel.mesh import replicate_scene
            renderer.scene = replicate_scene(context.mesh, renderer.scene)
            renderer.environment = replicate_scene(context.mesh,
                                                   renderer.environment)
        renderer._frame_fn = None
    if key is None:
        key = jax.random.PRNGKey(renderer.spp)
    return renderer.render_frame(key)
