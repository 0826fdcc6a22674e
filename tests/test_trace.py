"""Traversal correctness: the BVH backend must agree with the brute-force
oracle — the analog of the reference's cross-engine redundancy oracle
(Embree CPU vs OpenCL GPU, SURVEY.md §4)."""

import numpy as np
import jax.numpy as jnp

from rayaccel_tpu.camera import Camera, generate_pixel_rays
from rayaccel_tpu.ops.bruteforce import trace_bruteforce
from rayaccel_tpu.ops.trace import trace_bvh
from rayaccel_tpu.types import Rays, make_rays, INVALID_TRIANGLE
from rayaccel_tpu.scene.compile import compile_scene
from rayaccel_tpu.scene.loader import make_test_scene


def camera_rays(scene_data, n=64):
    cam = Camera.look_at(scene_data.cam_origin,
                         scene_data.cam_dir,
                         scene_data.cam_up,
                         scene_data.cam_fov, n, n)
    yy, xx = np.mgrid[0:n, 0:n]
    return generate_pixel_rays(cam.as_arrays(),
                               jnp.asarray(xx.ravel()), jnp.asarray(yy.ravel()))


def assert_hits_match_near_ties(h_ref, h, rays, flip_frac=0.005,
                               flip_rtol=3e-3):
    """Like assert_hits_match, but tolerates a small fraction of winner
    flips between candidates whose exact t differ by < flip_rtol (packed
    approximate ranking engines legitimately reorder near-ties; the
    returned t is exact for the picked triangle)."""
    miss_ref = np.asarray(h_ref.tri) == INVALID_TRIANGLE
    miss_h = np.asarray(h.tri) == INVALID_TRIANGLE
    np.testing.assert_array_equal(miss_ref, miss_h)
    hit = ~miss_ref
    t_ref = np.asarray(h_ref.t)[hit]
    t_h = np.asarray(h.t)[hit]
    close = np.abs(t_h - t_ref) <= 1e-3 + 1e-4 * np.abs(t_ref)
    flipped = ~close
    assert flipped.mean() <= flip_frac, (
        f"{flipped.mean():.2%} winners flipped (> {flip_frac:.2%})")
    np.testing.assert_allclose(t_h[flipped], t_ref[flipped],
                               rtol=flip_rtol, atol=1e-3)


def assert_hits_match(h_ref, h_bvh, rays, atol=1e-3):
    miss_ref = np.asarray(h_ref.tri) == INVALID_TRIANGLE
    miss_bvh = np.asarray(h_bvh.tri) == INVALID_TRIANGLE
    np.testing.assert_array_equal(miss_ref, miss_bvh)
    hit = ~miss_ref
    # t must match everywhere (different tris at equal t are acceptable,
    # so compare distance, then barycentrics only where tri agrees).
    np.testing.assert_allclose(np.asarray(h_bvh.t)[hit],
                               np.asarray(h_ref.t)[hit], rtol=1e-4, atol=atol)
    same = hit & (np.asarray(h_ref.tri) == np.asarray(h_bvh.tri))
    if hit.sum() >= 50:  # ties on shared edges legitimately differ
        # 0.97: tie-break order on shared edges shifts with the XLA CPU
        # codegen (host machine / cache generation) — a small scene saw
        # 4/190 legitimate equal-t tie flips, tripping the old 0.98
        # guard while every t matched. The guard only needs to catch
        # systematically-wrong winners, not exact ties.
        assert same.sum() > 0.97 * hit.sum()
    np.testing.assert_allclose(np.asarray(h_bvh.u)[same],
                               np.asarray(h_ref.u)[same], atol=5e-3)
    np.testing.assert_allclose(np.asarray(h_bvh.v)[same],
                               np.asarray(h_ref.v)[same], atol=5e-3)


def test_primary_rays_match_oracle(test_scene_data, test_scene):
    rays = camera_rays(test_scene_data)
    h_ref = trace_bruteforce(test_scene.tri_verts, rays)
    h_bvh = trace_bvh(test_scene, rays)
    hit_frac = (np.asarray(h_bvh.tri) >= 0).mean()
    assert hit_frac > 0.3, "camera should see the scene"
    assert_hits_match(h_ref, h_bvh, rays)


def test_random_rays_match_oracle(test_scene, rng):
    n = 4096
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.2, 6, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = make_rays(jnp.asarray(o), jnp.asarray(d), tmin=0.0, tmax=1e6)
    h_ref = trace_bruteforce(test_scene.tri_verts, rays)
    h_bvh = trace_bvh(test_scene, rays)
    assert_hits_match(h_ref, h_bvh, rays)


def test_tmin_tmax_respected(test_scene, rng):
    n = 512
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.5, 5, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = make_rays(jnp.asarray(o), jnp.asarray(d), tmin=1.0, tmax=4.0)
    h_ref = trace_bruteforce(test_scene.tri_verts, rays)
    h_bvh = trace_bvh(test_scene, rays)
    t = np.asarray(h_bvh.t)
    hit = np.asarray(h_bvh.tri) >= 0
    assert np.all(t[hit] > 1.0 - 1e-6)
    assert np.all(t[hit] <= 4.0 + 1e-6)
    assert_hits_match(h_ref, h_bvh, rays)


def test_axis_aligned_rays(test_scene):
    # Degenerate direction components exercise the epsilon clamp
    # (Kernels.h:149-157).
    o = jnp.asarray(np.array([[0.0, 5.0, 0.0], [0.0, 0.5, -10.0],
                              [-10.0, 0.5, 0.0], [0.0, -5.0, 0.0]], np.float32))
    d = jnp.asarray(np.array([[0.0, -1.0, 0.0], [0.0, 0.0, 1.0],
                              [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32))
    rays = make_rays(o, d, tmin=0.0, tmax=1e6)
    h_ref = trace_bruteforce(test_scene.tri_verts, rays)
    h_bvh = trace_bvh(test_scene, rays)
    assert_hits_match(h_ref, h_bvh, rays)


def test_empty_direction_miss(test_scene):
    # Rays pointing away from everything must miss cleanly.
    o = jnp.broadcast_to(jnp.asarray([0.0, 100.0, 0.0]), (16, 3))
    d = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), (16, 3))
    rays = make_rays(o, d)
    h = trace_bvh(test_scene, rays)
    assert np.all(np.asarray(h.tri) == INVALID_TRIANGLE)
