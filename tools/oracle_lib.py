"""Cross-engine agreement against the plain reference engines, shared by
chip_smoke.py, bench.py and the tests.

The reference's de-facto oracle is its runnable backend flag matrix — the
same frame must agree with any engine disabled (main.cpp:289-302). Here
the production cluster engine (``mxu``, ops/trace_mxu.py) and the BVH
engine (``xla``, ops/trace.py) trace the same rays as the brute-force
reference (``bruteforce``, ops/bruteforce.py) on whatever device JAX runs
on, and whole images from the two engines must agree.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from rayaccel_tpu.camera import Camera, generate_pixel_rays
from rayaccel_tpu.ops.bruteforce import trace_bruteforce
from rayaccel_tpu.ops.trace import trace_bvh, trace_occlusion_bvh
from rayaccel_tpu.ops.trace_mxu import trace_mxu, trace_occlusion_mxu
from rayaccel_tpu.render.tiled import block_swizzle
from rayaccel_tpu.types import Rays

PRECISION = ("float32 everywhere: the mxu ray x cluster product runs at "
             "Precision.HIGHEST (no TF32); bruteforce is elementwise "
             "Moller-Trumbore with no matmul")

# Closest-hit gate: hit/miss agreement, t within 1e-3 relative on the rays
# both engines hit, and a winner that differs from the reference's only
# at a near-tie (|dt| <= 1e-4 t) among the rays whose t agrees.
MIN_HIT_AGREE = 0.9995
MIN_T_AGREE = 0.999
T_RTOL = 1e-3
TIE_RTOL = 1e-4


def camera_and_bounce_rays(ts, sd, n_rays, key=None):
    """Two ray classes of ``n_rays`` each, built on the device:

    - ``primary``: jittered camera rays from the middle of the frame, in
      the block-swizzled order the renderers trace them (the top of a
      battlefield-class frame is sky, which agrees vacuously);
    - ``bounce``: cosine-weighted directions about the geometric normal,
      leaving the reference's primary hit points the way the renderers
      spawn secondaries (origin offset 1e-4 along the normal, tmin 1e-3).
    """
    key = jax.random.PRNGKey(42) if key is None else key
    w, h = sd.viewport_width, sd.viewport_height
    cam = Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up, sd.cam_fov,
                         w, h).as_arrays()
    _, x, y = block_swizzle(w, h, max(n_rays, (-(-w // 32)) * 32
                                      * (-(-h // 16)) * 16))
    base = (x.shape[0] - n_rays) // 2
    prim = generate_pixel_rays(cam, jnp.asarray(x[base:base + n_rays],
                                                jnp.int32),
                               jnp.asarray(y[base:base + n_rays], jnp.int32),
                               key=jax.random.fold_in(key, 0))
    ref = trace_bruteforce(ts.tri_verts, prim)
    hit = ref.tri >= 0
    order = jnp.argsort(~hit)                      # hit lanes first
    n_hit = jnp.maximum(jnp.sum(hit.astype(jnp.int32)), 1)
    src = jnp.take(order, jnp.arange(n_rays) % n_hit)
    tri = jnp.take(ref.tri, src)
    d_in = jnp.take(prim.d, src, axis=0)
    ng = jnp.take(ts.tri_normal, jnp.maximum(tri, 0), axis=0)
    ng = jnp.where((jnp.sum(ng * d_in, axis=1) > 0)[:, None], -ng, ng)
    pos = (jnp.take(prim.o, src, axis=0)
           + jnp.take(ref.t, src)[:, None] * d_in)
    g = jax.random.normal(jax.random.fold_in(key, 1), (n_rays, 3))
    g = g / jnp.linalg.norm(g, axis=1, keepdims=True)
    d = ng + g
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    bounce = Rays(pos + 1e-4 * ng, d, jnp.full((n_rays,), 1e-3),
                  jnp.full((n_rays,), 1e6))
    return {"primary": prim, "bounce": bounce}


def compare_hits(ref, got) -> dict:
    """Agreement of one engine's closest hits with the reference's."""
    tri_r, tri_g = np.asarray(ref.tri), np.asarray(got.tri)
    t_r, t_g = np.asarray(ref.t), np.asarray(got.t)
    hit_r, hit_g = tri_r >= 0, tri_g >= 0
    both = hit_r & hit_g
    dt = np.abs(t_g - t_r)
    t_ok = both & (dt <= T_RTOL * np.maximum(t_r, 1e-6))
    far_flip = t_ok & (tri_g != tri_r) & (dt > TIE_RTOL * t_r)
    return dict(hit_agree=float((hit_r == hit_g).mean()),
                t_agree=float(t_ok.sum() / max(both.sum(), 1)),
                tri_flips=int((both & (tri_g != tri_r)).sum()),
                far_flips=int(far_flip.sum()),
                hit_frac=float(hit_r.mean()), n=int(tri_r.size))


def hits_ok(row) -> bool:
    return (row["hit_agree"] >= MIN_HIT_AGREE
            and row["t_agree"] >= MIN_T_AGREE and row["far_flips"] == 0)


def attrs_match_host(cs, res) -> bool:
    """True when the attribute rows trace_mxu returned for its winners are
    bitwise the host table's rows at the winners' slots (the bf16-pair
    words may be denormal float32 patterns that must survive the gather)."""
    tri = np.asarray(res.hits.tri)
    hit = tri >= 0
    tri_id = np.asarray(cs.tri_id)
    slot_of = np.zeros(tri_id.max() + 1, np.int64)
    slot_of[tri_id[tri_id >= 0]] = np.flatnonzero(tri_id >= 0)
    host = np.asarray(cs.attrs)[slot_of[tri[hit]]]
    got = np.asarray(res.attrs)[hit]
    return bool(np.array_equal(got.view(np.uint32), host.view(np.uint32)))


def run_oracle(cs, ts, sd, n_rays=65536, tile=1024, key=None):
    """Closest-hit and any-hit agreement of ``mxu`` and ``xla`` with
    ``bruteforce`` on the camera and bounce ray classes, and the mxu
    winners' attribute rows bitwise against a host gather. Returns
    (rows, ok): one dict per (ray class, engine, query)."""
    rows = []
    for name, rays in camera_and_bounce_rays(ts, sd, n_rays, key).items():
        ref = trace_bruteforce(ts.tri_verts, rays)
        # Any hit in [tmin, tmax] exists iff a closest hit does.
        occ_ref = np.asarray(ref.tri) >= 0
        res = trace_mxu(cs, rays, tile=tile)
        row = compare_hits(ref, res.hits)
        attrs_ok = attrs_match_host(cs, res)
        rows.append(dict(rays=name, engine="mxu", query="closest",
                         ok=hits_ok(row) and attrs_ok,
                         attrs_bitwise_host=attrs_ok, **row))
        row = compare_hits(ref, trace_bvh(ts, rays))
        rows.append(dict(rays=name, engine="xla", query="closest",
                         ok=hits_ok(row), **row))
        for engine, anyhit in (
                ("mxu", lambda r: trace_occlusion_mxu(cs, r, tile=tile)),
                ("xla", lambda r: trace_occlusion_bvh(ts, r))):
            agree = float((np.asarray(anyhit(rays)) == occ_ref).mean())
            rows.append(dict(rays=name, engine=engine, query="any",
                             ok=agree >= MIN_HIT_AGREE, hit_agree=agree,
                             n=int(occ_ref.size)))
    return rows, all(r["ok"] for r in rows)


def frame_inputs(w, h, wave):
    """Block-swizzled (W, wave) lane inputs covering a w x h frame, as the
    renderers lay them out. Returns (xs, ys, alives, perm)."""
    n_lanes = (-(-w // 32)) * 32 * (-(-h // 16)) * 16
    n_lanes = -(-n_lanes // wave) * wave
    perm, x, y = block_swizzle(w, h, n_lanes)
    W = n_lanes // wave
    return (jnp.asarray(x.reshape(W, wave), jnp.int32),
            jnp.asarray(y.reshape(W, wave), jnp.int32),
            jnp.asarray((perm >= 0).reshape(W, wave)), perm)


def run_image_oracle(cs, ts, sd, n_spp=2, max_depth=2, wave=65536,
                     tile=1024, key=None):
    """Whole-image agreement of the production pooled path on the cluster
    engine (``mxu``) with the same pooled path on the BVH engine (``xla``)
    at the scene's own viewport.

    Both renders run pt_trace_frame with the SAME keys, so primary jitter
    and BSDF draws are identical; the images differ only where the
    engines disagree — shared-edge tie-breaks and ulp-level t/u/v
    differences between the bilinear cluster math and the BVH pair math.
    Returns a dict with the raw and trimmed RMSE, the winner-flip
    fraction, and each engine's last-sample frame time in ms (timed with
    block_until_ready; the first sample includes compilation).
    """
    from rayaccel_tpu.environment import create_environment
    from rayaccel_tpu.render.pathtracer import pt_trace_frame

    key = jax.random.PRNGKey(7) if key is None else key
    w, h = sd.viewport_width, sd.viewport_height
    cam = Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up, sd.cam_fov,
                         w, h).as_arrays()
    xs, ys, alives, perm = frame_inputs(w, h, wave)
    px = sd.env_pixels
    env = create_environment(px, px.shape[1], px.shape[0])

    def render(scene, backend):
        fb = jnp.zeros(xs.shape + (3,), jnp.float32)
        ms = 0.0
        for i in range(n_spp):
            t0 = time.perf_counter()
            rad, _, _ = pt_trace_frame(
                scene, env, cam, xs, ys, alives, jax.random.fold_in(key, i),
                max_depth, backend=backend, tile=min(tile, wave))
            fb = jax.block_until_ready(fb + rad)
            ms = (time.perf_counter() - t0) * 1e3
        return np.asarray(fb).reshape(-1, 3) / n_spp, ms

    img_prod, ms_mxu = render(cs, "mxu")
    img_ref, ms_xla = render(ts, "xla")
    valid = perm >= 0
    diff = (img_prod - img_ref)[valid]
    rmse = float(np.sqrt(np.mean(diff * diff)))
    pix_diff = np.abs(diff).max(axis=1)
    # Two-class gate: pixels whose paths CHAOTICALLY diverged (a
    # shared-edge winner flip on some segment re-aims every later
    # segment, so the radiance difference is full-magnitude however small
    # the underlying ulp gap was) are counted as ``frac_flip``; the REST
    # of the image must meet the 1e-3 RMSE (``rmse_trimmed``). Raw RMSE is
    # reported but not gated: it is dominated by the flip class times
    # depth, which no engine can remove.
    flip = pix_diff > 0.05
    d_trim = diff[~flip]
    rmse_trim = float(np.sqrt(np.mean(d_trim * d_trim)))
    return dict(image_rmse=rmse, rmse_trimmed=rmse_trim,
                frac_flip=float(flip.mean()),
                max_abs=float(pix_diff.max()),
                n_pixels=int(valid.sum()), spp=n_spp,
                viewport=[w, h], depth=max_depth,
                frame_ms_mxu=ms_mxu, frame_ms_xla=ms_xla,
                ok=rmse_trim < 1e-3 and float(flip.mean()) < 0.005)
