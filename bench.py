"""Benchmarks on the battlefield-like scene (72k triangles, 1280x720).

Mirrors the reference's figure of merit — Mrays/s with rays counted at
intersection-test dispatch (reference main.cpp:215-231,
RayAccelerator.cpp:200) — over the renderer configurations, plus the
cross-engine oracle on the same scene:

    2  path tracer, 2 bounces, 1 spp/frame (headline)
    5  the same through the shard_map frame path on a 1-device mesh
    1  Whitted, primary + shadow rays
    6  Whitted ray trees, depth 8
    3  path tracer, 8 bounces
    4  path tracer, stratified progressive sampling
    7  engines against bruteforce + whole-image mxu vs xla gate

    python bench.py     # env: BENCH_ONLY=2,1  BENCH_FRAMES=8  BENCH_WAVE
                        #      BENCH_TILE  BENCH_CS  BENCH_DEADLINE_S

Frames are timed on the host clock around work that ends in
``jax.block_until_ready`` on the framebuffer, after a warm-up frame that
compiles. Every line names the platform, device kind, device count, and
the card with its power limit. The headline runs first and is printed
again last. Without a GPU the bench refuses to run; a config that raises
prints an error line, the rest still run, and the exit code is nonzero.
"""

import json
import os
import sys
import time
import traceback

HEADLINE = "pt_battlefield_mrays_per_s"


def run_config(renderer, frames, key0=1):
    """Warm up (compile), then time ``frames`` frames. Returns (Mrays/s,
    ms per frame, rays)."""
    import jax
    renderer.render_frame(jax.random.PRNGKey(0))
    jax.block_until_ready(renderer.frame_buffer)
    keys = [jax.random.PRNGKey(key0 + i) for i in range(frames)]
    base = renderer.rays_traced_total
    t0 = time.perf_counter()
    for k in keys:
        renderer.render_frame(k)
    jax.block_until_ready(renderer.frame_buffer)
    dt = time.perf_counter() - t0
    rays = renderer.rays_traced_total - base
    return rays / dt / 1e6, dt / frames * 1e3, rays


def run_configs(configs, label, deadline_s=None):
    """Run ``(metric, fn)`` pairs in order, each its own failure domain.
    ``fn`` returns the fields of its line. Prints one JSON line per
    config (``label`` fields appended) and the headline again last.
    Returns the exit code: 1 if any config raised, else 0."""
    t_start = time.perf_counter()
    failed = False
    headline = None

    def emit(fields):
        print(json.dumps({**fields, **label}), flush=True)

    for metric, fn in configs:
        elapsed = time.perf_counter() - t_start
        if deadline_s is not None and elapsed > deadline_s:
            emit({"metric": metric, "value": 0, "unit": "skipped_deadline",
                  "elapsed_s": elapsed})
            continue
        try:
            fields = {"metric": metric, **fn()}
        except Exception as e:  # noqa: BLE001 — one config, one failure
            traceback.print_exc()
            failed = True
            fields = {"metric": metric, "value": 0, "unit": "error",
                      "error": f"{type(e).__name__}: {e}"[:500]}
        emit(fields)
        if metric == HEADLINE:
            headline = fields
    if headline is not None:
        emit(headline)
    return 1 if failed else 0


def main():
    import jax

    from rayaccel_tpu.utils.compile_cache import enable_compile_cache
    from rayaccel_tpu.utils.device import card_info, require_gpu

    device = require_gpu()
    enable_compile_cache()
    label = {"device": device, "card": card_info().splitlines()[0]}

    import rayaccel_tpu as racc
    from rayaccel_tpu.scene.clusters import compile_clusters
    from rayaccel_tpu.scene.loader import make_battlefield_like

    wave = int(os.environ.get("BENCH_WAVE", 128 * 128 * 4))
    tile = int(os.environ.get("BENCH_TILE", 1024))
    cs_size = int(os.environ.get("BENCH_CS", 128))
    frames = int(os.environ.get("BENCH_FRAMES", 8))
    only = set(os.environ.get("BENCH_ONLY", "2,5,1,6,3,4,7").split(","))
    deadline = float(os.environ.get("BENCH_DEADLINE_S", 4500))

    scene_data = make_battlefield_like()
    cluster_scene = compile_clusters(scene_data, cluster_size=cs_size)
    base_cfg = racc.Configuration(wave_size=wave, trace_block=tile)
    print(json.dumps({
        "metric": "bench_knobs", "unit": "knobs", "value": 1,
        "knobs": dict(backend=base_cfg.backend, wave_size=wave,
                      trace_block=tile, cluster_size=cs_size, frames=frames,
                      **base_cfg.pool_knobs()), **label}), flush=True)

    def with_depth(depth):
        return type(scene_data)(**{**scene_data.__dict__,
                                   "max_depth": depth})

    def cam_of(sd):
        return racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                                   sd.cam_fov, sd.viewport_width,
                                   sd.viewport_height)

    def ctx(**kw):
        return racc.create_context(racc.Configuration(
            wave_size=wave, trace_block=tile, **kw))

    def line(renderer, n_frames, **extra):
        mrays, ms, rays = run_config(renderer, n_frames)
        return dict(value=mrays, unit="Mrays/s", frame_ms=ms,
                    frames=n_frames, rays=rays, dropped=renderer.dropped,
                    **extra)

    def pt(depth, n_frames, **kw):
        sd = with_depth(depth)
        return lambda: line(racc.PathTracingRenderer(
            ctx(**kw), cam_of(sd), sd, cluster_scene), n_frames)

    def whitted(depth, n_frames, **kw):
        sd = with_depth(depth)
        return lambda: line(racc.WhittedRenderer(
            ctx(), cam_of(sd), sd, cluster_scene, **kw), n_frames)

    def oracle():
        from rayaccel_tpu.scene.compile import compile_scene
        from tools.oracle_lib import run_image_oracle, run_oracle
        bvh_scene = compile_scene(scene_data)
        rows, ok = run_oracle(cluster_scene, bvh_scene, scene_data,
                              n_rays=wave, tile=tile)
        img = run_image_oracle(cluster_scene, bvh_scene, with_depth(2),
                               wave=wave, tile=tile)
        if not (ok and img["ok"]):
            raise RuntimeError(f"oracle gate failed: rows={rows} "
                               f"image={img}")
        return dict(value=1, unit="ok", rows=len(rows),
                    min_hit_agree=min(r["hit_agree"] for r in rows),
                    **{k: img[k] for k in ("image_rmse", "rmse_trimmed",
                                           "frac_flip", "spp")})

    configs = [c for c in (
        ("2", HEADLINE, pt(2, frames)),
        ("5", "pt_mesh1_mrays_per_s", pt(2, max(frames // 4, 1),
                                         mesh_shape=(1,))),
        ("1", "whitted_primary_shadow_mrays_per_s",
         whitted(1, frames, shadows=True, primary_only=True)),
        ("6", "whitted_depth8_mrays_per_s", whitted(8, max(frames // 2, 1))),
        ("3", "pt8_fullbsdf_mrays_per_s", pt(8, max(frames // 2, 1))),
        ("4", "pt_stratified_mrays_per_s", pt(2, frames,
                                              sampler="stratified")),
        ("7", "oracle", oracle),
    ) if c[0] in only]
    return run_configs([(m, fn) for _, m, fn in configs], label, deadline)


if __name__ == "__main__":
    sys.exit(main())
