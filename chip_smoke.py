"""Smoke test of the main rendering path on NVIDIA GPUs.

    python chip_smoke.py               # phases (i)-(iv) on one card
    python chip_smoke.py --four-cards  # phase (v) only, on four cards

(i)   card name and power limit, native scene compiler, scene build time;
(ii)  the mxu and xla engines against the brute-force reference on 65,536
      battlefield camera rays and 65,536 bounce rays, closest and any hit;
(iii) PathTracingRenderer (depth 2, 4 frames) and WhittedRenderer (depth 8,
      2 frames) at 1280x720: compile time, frame time, Mrays/s, memory;
(iv)  whole 1280x720 2-spp images, pooled mxu against pooled xla;
(v)   tile-parallel PT and Whitted frames over a 4-card mesh with bounce
      re-sharding, against the same keys on one card.

Every phase raises on failure; the last line of standard output is one
JSON object, printed only when every phase passed. Exits nonzero, with no
JSON line, when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

WAVE = 65536
TILE = 1024


T0 = time.perf_counter()


def emit(phase: str, card: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, "card": card}), flush=True)


def progress(msg: str) -> None:
    """Where the run is, on standard error (a cut run shows its stage)."""
    print(f"[{time.perf_counter() - T0:8.1f} s] {msg}", file=sys.stderr,
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def build_scene(depth: int):
    """Battlefield-like scene (72k triangles, 1280x720) in both device
    forms. Returns (scene_data, cluster_scene, bvh_scene, seconds)."""
    import jax
    from rayaccel_tpu.scene.clusters import compile_clusters
    from rayaccel_tpu.scene.compile import compile_scene
    from rayaccel_tpu.scene.loader import make_battlefield_like
    t0 = time.perf_counter()
    sd = make_battlefield_like(max_depth=depth)
    cs = compile_clusters(sd, cluster_size=128)
    ts = compile_scene(sd)
    jax.block_until_ready((cs, ts))
    return sd, cs, ts, time.perf_counter() - t0


def with_depth(sd, depth):
    return type(sd)(**{**sd.__dict__, "max_depth": depth})


def camera_of(sd):
    import rayaccel_tpu as racc
    return racc.Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                               sd.cam_fov, sd.viewport_width,
                               sd.viewport_height)


def phase_engines(cs, ts, sd, card, n_rays=WAVE, tile=TILE):
    """(ii) mxu and xla against bruteforce, closest hit and any hit."""
    from tools import oracle_lib
    progress("engines against bruteforce")
    rows, ok = oracle_lib.run_oracle(cs, ts, sd, n_rays=n_rays, tile=tile)
    for r in rows:
        emit("engines", card, precision=oracle_lib.PRECISION,
             gate=dict(min_hit_agree=oracle_lib.MIN_HIT_AGREE,
                       min_t_agree=oracle_lib.MIN_T_AGREE,
                       t_rtol=oracle_lib.T_RTOL,
                       tie_rtol=oracle_lib.TIE_RTOL), **r)
    check(ok, "engine agreement with bruteforce")


def render_timed(renderer, frames):
    """Compile (for the memory analysis), then warm up and time
    ``frames`` frames as bench.py does. Returns a dict of measurements."""
    import jax
    from bench import run_config
    t0 = time.perf_counter()
    compiled = renderer.lower_frame(jax.random.PRNGKey(0)).compile()
    compile_s = time.perf_counter() - t0
    progress(f"compiled in {compile_s:.1f} s")
    mem = compiled.memory_analysis()
    mrays, frame_ms, rays = run_config(renderer, frames)
    stats = jax.devices()[0].memory_stats() or {}
    img = renderer.image()
    return dict(
        compile_s=compile_s, frames=frames, frame_ms=frame_ms,
        mrays_per_s=mrays, rays=rays, dropped=renderer.dropped,
        finite=bool(np.isfinite(img).all()),
        memory_analysis=dict(
            temp_bytes=mem.temp_size_in_bytes,
            argument_bytes=mem.argument_size_in_bytes,
            output_bytes=mem.output_size_in_bytes,
            generated_code_bytes=mem.generated_code_size_in_bytes),
        peak_bytes_in_use=stats.get("peak_bytes_in_use"))


def phase_main_path(cs, sd, card, pt_frames=4, whitted_frames=2,
                    wave=WAVE):
    """(iii) the two renderers through their public entry points."""
    import rayaccel_tpu as racc
    ctx = racc.create_context(racc.Configuration(wave_size=wave))
    for name, make, frames in (
            ("pt_depth2", lambda: racc.PathTracingRenderer(
                ctx, camera_of(sd), with_depth(sd, 2), cs),
             pt_frames),
            ("whitted_depth8", lambda: racc.WhittedRenderer(
                ctx, camera_of(sd), with_depth(sd, 8), cs),
             whitted_frames)):
        progress(f"main path: {name}")
        m = render_timed(make(), frames)
        emit("main_path", card, renderer=name,
             viewport=[sd.viewport_width, sd.viewport_height], **m)
        check(m["finite"], f"{name}: finite image")
        check(m["rays"] > 0, f"{name}: rays traced")
        check(m["dropped"] == 0, f"{name}: dropped == 0")


def phase_image(cs, ts, sd, card, wave=WAVE, tile=TILE):
    """(iv) whole pooled image, mxu against the xla reference."""
    from tools.oracle_lib import run_image_oracle
    progress("whole image, mxu against xla")
    img = run_image_oracle(cs, ts, with_depth(sd, 2), n_spp=2, wave=wave,
                           tile=tile)
    emit("image", card, gate="rmse_trimmed < 1e-3 and frac_flip < 0.005",
         **img)
    check(img["ok"], "whole-image gate")


def phase_four_cards(cs, sd, card, devices, frames=2, wave=WAVE):
    """(v) PT and Whitted over a 4-card tile mesh with bounce re-sharding
    against the same keys on one card. Every draw is keyed by pixel or by
    unsharded lane position, so the two renders trace the same paths; the
    two programs are separate compilations, whose float rounding may
    differ in the last bit."""
    import jax
    import rayaccel_tpu as racc
    max_rel_rays = 1e-5        # tolerated relative ray-count difference
    max_frac_px = 1e-3         # tolerated share of pixels off by > 1e-3
    for name, cls, depth in (("pt_depth2", racc.PathTracingRenderer, 2),
                             ("whitted_depth8", racc.WhittedRenderer, 8)):
        out = {}
        for n in (4, 1):
            progress(f"four cards: {name} on {n} card(s)")
            cfg = racc.Configuration(
                wave_size=wave, reshard_bounces=True,
                mesh_shape=(4,) if n == 4 else None)
            ctx = racc.create_context(cfg, devices=devices[:n])
            r = cls(ctx, camera_of(sd), with_depth(sd, depth), cs)
            t0 = time.perf_counter()
            for i in range(frames):
                r.render_frame(jax.random.PRNGKey(i))
            jax.block_until_ready(r.frame_buffer)
            out[n] = dict(img=r.image(), rays=r.rays_traced_total,
                          dropped=r.dropped,
                          seconds=time.perf_counter() - t0)
        diff = np.abs(out[4]["img"] - out[1]["img"]).max(axis=-1)
        d_rays = out[4]["rays"] - out[1]["rays"]
        m = dict(renderer=name, frames=frames, rays_4=out[4]["rays"],
                 rays_1=out[1]["rays"], rays_diff=d_rays,
                 max_abs_diff=float(diff.max()),
                 frac_px_gt_1e3=float((diff > 1e-3).mean()),
                 bitwise_equal=bool(np.array_equal(out[4]["img"],
                                                   out[1]["img"])),
                 dropped_4=out[4]["dropped"],
                 seconds_4_incl_compile=out[4]["seconds"],
                 seconds_1_incl_compile=out[1]["seconds"],
                 gate=dict(max_rel_rays=max_rel_rays,
                           max_frac_px=max_frac_px))
        emit("four_cards", card, **m)
        check(abs(d_rays) <= max_rel_rays * out[1]["rays"],
              f"{name}: ray counts 4 vs 1 card")
        check(m["frac_px_gt_1e3"] <= max_frac_px,
              f"{name}: images 4 vs 1 card")
        check(out[4]["dropped"] == 0 and out[1]["dropped"] == 0,
              f"{name}: dropped == 0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card tile-parallel phase")
    args = ap.parse_args(argv)

    import jax
    from rayaccel_tpu.utils.compile_cache import enable_compile_cache
    from rayaccel_tpu.utils.device import card_info, require_gpu

    device = require_gpu()
    need = 4 if args.four_cards else 1
    if device["count"] < need:
        raise RuntimeError(f"need {need} GPUs, JAX found {device['count']}")
    enable_compile_cache()
    cards = card_info()
    card = cards.splitlines()[0]
    print(f"card: {cards}", flush=True)

    from rayaccel_tpu.scene.native import native_available
    t0 = time.perf_counter()
    native = native_available()
    native_s = time.perf_counter() - t0
    sd, cs, ts, build_s = build_scene(depth=2)
    emit("setup", card, native_compiler_built=native,
         native_build_s=native_s, scene_build_s=build_s,
         triangles=int(len(sd.indices)), clusters=int(cs.n_clusters),
         viewport=[sd.viewport_width, sd.viewport_height], device=device)

    if args.four_cards:
        phase_four_cards(cs, sd, card, jax.devices())
    else:
        phase_engines(cs, ts, sd, card)
        phase_main_path(cs, sd, card)
        phase_image(cs, ts, sd, card)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
