"""Both production-path engines against the brute-force reference on the
ray classes that stress a traversal: camera and scattered rays, grazing
rays, tmin/tmax windows, active masks, deep cluster overlap, rays that
start inside many cluster boxes at once, and the any-hit query on the
same sets (the cross-engine oracle of SURVEY.md §4; reference any-hit
semantics Kernels.h:190-210)."""

import numpy as np
import jax.numpy as jnp
import pytest

from rayaccel_tpu.camera import Camera, generate_pixel_rays
from rayaccel_tpu.ops.bruteforce import trace_bruteforce
from rayaccel_tpu.ops.trace import trace_bvh, trace_occlusion_bvh
from rayaccel_tpu.ops.trace_mxu import trace_mxu, trace_occlusion_mxu
from rayaccel_tpu.scene.clusters import compile_clusters
from rayaccel_tpu.scene.compile import compile_scene
from rayaccel_tpu.scene.data import (SceneData, compute_face_normals,
                                     compute_vertex_normals)
from rayaccel_tpu.scene.loader import make_test_scene
from rayaccel_tpu.types import INVALID_TRIANGLE, make_rays

from tests.test_trace import assert_hits_match_near_ties

TILE = 512


def _scene(verts, idx):
    verts = np.asarray(verts, np.float32)
    idx = np.asarray(idx, np.uint32)
    return SceneData(
        vertices=verts, indices=idx,
        triangle_materials=np.zeros(len(idx), np.uint16),
        triangle_normals=compute_face_normals(verts, idx),
        normals=compute_vertex_normals(verts, idx),
        texcoords=np.zeros((len(verts), 2), np.float32),
        materials=np.asarray([[0.8, 0.8, 0.8, 1.5]], np.float32),
    ).validate()


def slab_stack_scene(n_slabs=160):
    """n_slabs stacked quads under a ray column + a far-off ground quad:
    rays through the stack overlap every slab cluster (at cluster_size=2),
    rays over the ground overlap almost nothing."""
    verts, idx = [], []
    for i in range(n_slabs):
        y = 10.0 - 0.05 * i
        b = len(verts)
        verts += [(-1, y, -1), (1, y, -1), (1, y, 1), (-1, y, 1)]
        idx += [(b, b + 1, b + 2), (b, b + 2, b + 3)]
    b = len(verts)
    verts += [(90, 0, -10), (110, 0, -10), (110, 0, 10), (90, 0, 10)]
    idx += [(b, b + 1, b + 2), (b, b + 2, b + 3)]
    return _scene(verts, idx)


def fan_scene(n_tri=64):
    """A fan of triangles sharing the apex (0, 1, 0): every cluster box
    contains the apex, so rays leaving it enter all clusters at t = 0."""
    verts, idx = [], []
    for i in range(n_tri):
        a = 2 * np.pi * i / n_tri
        b = a + 0.05
        bi = len(verts)
        verts += [(0.0, 1.0, 0.0), (3 * np.cos(a), 1.3, 3 * np.sin(a)),
                  (3 * np.cos(b), 0.7, 3 * np.sin(b))]
        idx.append((bi, bi + 1, bi + 2))
    return _scene(verts, idx)


def _random_dirs(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _random_origins(rng, n, y_lo=0.2):
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(y_lo, 6, n)
    return o


def scenario(name, rng):
    """(scene_data, cluster_size, rays, active) for one ray class."""
    if name in ("camera", "random", "grazing", "window", "active"):
        sd, cs_size = make_test_scene(), 16
    if name == "camera":
        cam = Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up,
                             sd.cam_fov, 64, 64)
        yy, xx = np.mgrid[0:64, 0:64]
        rays = generate_pixel_rays(cam.as_arrays(), jnp.asarray(xx.ravel()),
                                   jnp.asarray(yy.ravel()))
        return sd, cs_size, rays, None
    if name == "random":
        n = 4096
        return sd, cs_size, make_rays(
            jnp.asarray(_random_origins(rng, n)),
            jnp.asarray(_random_dirs(rng, n)), tmin=0.0, tmax=1e6), None
    if name == "grazing":
        # Nearly parallel to the ground plane and the box faces.
        n = 2048
        o = _random_origins(rng, n)
        o[:, 1] = rng.uniform(0.01, 0.3, n)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d[:, 1] = rng.uniform(-0.02, 0.0, n)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return sd, cs_size, make_rays(jnp.asarray(o), jnp.asarray(d),
                                      tmin=0.0, tmax=1e6), None
    if name == "window":
        n = 1024
        return sd, cs_size, make_rays(
            jnp.asarray(_random_origins(rng, n, y_lo=0.5)),
            jnp.asarray(_random_dirs(rng, n)), tmin=1.0, tmax=4.0), None
    if name == "active":
        n = 2048
        active = jnp.asarray(np.arange(n) % 4 != 3)
        return sd, cs_size, make_rays(
            jnp.asarray(_random_origins(rng, n)),
            jnp.asarray(_random_dirs(rng, n)), tmin=0.0, tmax=20.0), active
    if name == "deep_overlap":
        # Column rays through all 160 slab clusters, plus a tile of rays
        # whose winner (the far ground) sits behind every slab cluster.
        sd = slab_stack_scene()
        n = 2 * TILE
        o = np.zeros((n, 3), np.float32)
        o[:, 0] = np.linspace(-0.9, -0.1, n)   # off the quads' diagonals
        o[:, 1] = 20.0
        o[:, 2] = 0.3
        o[TILE:, 0] += 100.0
        d = np.zeros((n, 3), np.float32)
        d[:, 1] = -1.0
        return sd, 2, make_rays(jnp.asarray(o), jnp.asarray(d), tmin=0.0,
                                tmax=1e6), None
    if name == "inside_clusters":
        sd = fan_scene()
        n = 512
        o = np.tile(np.asarray([1e-3, 1.0, 2e-3], np.float32), (n, 1))
        return sd, 8, make_rays(jnp.asarray(o),
                                jnp.asarray(_random_dirs(rng, n)),
                                tmin=0.0, tmax=1e6), None
    raise ValueError(name)


def closest(engine, sd, cs_size, rays, active):
    if engine == "mxu":
        cs = compile_clusters(sd, cluster_size=cs_size)
        return trace_mxu(cs, rays, active=active, tile=TILE).hits
    return trace_bvh(compile_scene(sd), rays, active=active)


def occluded(engine, sd, cs_size, rays, active):
    if engine == "mxu":
        cs = compile_clusters(sd, cluster_size=cs_size)
        return trace_occlusion_mxu(cs, rays, active=active, tile=TILE)
    return trace_occlusion_bvh(compile_scene(sd), rays, active=active)


def reference(sd, rays, active):
    """Brute-force closest hits, inactive lanes forced to a miss."""
    ref = trace_bruteforce(compile_scene(sd).tri_verts, rays)
    if active is None:
        return ref
    return ref._replace(tri=jnp.where(active, ref.tri, INVALID_TRIANGLE),
                        t=jnp.where(active, ref.t, rays.tmax))


CLOSEST = ("camera", "random", "grazing", "window", "active",
           "deep_overlap", "inside_clusters")
ANY = ("random", "active", "deep_overlap")


@pytest.mark.parametrize("engine", ["mxu", "xla"])
@pytest.mark.parametrize("name", CLOSEST)
def test_closest_hit_matches_bruteforce(name, engine, rng):
    sd, cs_size, rays, active = scenario(name, rng)
    ref = reference(sd, rays, active)
    hits = closest(engine, sd, cs_size, rays, active)
    assert (np.asarray(ref.tri) >= 0).any(), "scenario must hit something"
    assert_hits_match_near_ties(ref, hits, rays)
    t = np.asarray(hits.t)[np.asarray(hits.tri) >= 0]
    assert np.all(t >= np.asarray(rays.tmin).min() - 1e-6)
    assert np.all(t <= np.asarray(rays.tmax).max() * (1 + 1e-6))


@pytest.mark.parametrize("engine", ["mxu", "xla"])
@pytest.mark.parametrize("name", ANY)
def test_any_hit_matches_bruteforce(name, engine, rng):
    sd, cs_size, rays, active = scenario(name, rng)
    want = np.asarray(reference(sd, rays, active).tri) >= 0
    got = np.asarray(occluded(engine, sd, cs_size, rays, active))
    np.testing.assert_array_equal(got, want)
