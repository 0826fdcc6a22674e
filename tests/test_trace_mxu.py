"""Cluster tracer correctness vs the brute-force oracle, and attribute
fetch correctness vs direct gathers — extending the multi-engine oracle
(SURVEY.md §4) to the cluster backend."""

import numpy as np
import jax.numpy as jnp
import pytest

from rayaccel_tpu.camera import Camera, generate_pixel_rays
from rayaccel_tpu.ops.bruteforce import trace_bruteforce
from rayaccel_tpu.ops.trace_mxu import trace_mxu
from rayaccel_tpu.scene.clusters import (ATTR_GEOM_COL, compile_clusters,
                                          unpack_attrs_np)
from rayaccel_tpu.scene.loader import make_test_scene
from rayaccel_tpu.types import make_rays, INVALID_TRIANGLE

from tests.test_trace import assert_hits_match


@pytest.fixture(scope="module")
def scenes():
    sd = make_test_scene()
    from rayaccel_tpu.scene.compile import compile_scene
    return sd, compile_scene(sd), compile_clusters(sd, cluster_size=16)


def test_mxu_camera_rays(scenes):
    sd, ts, cs = scenes
    cam = Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up, sd.cam_fov, 64, 64)
    yy, xx = np.mgrid[0:64, 0:64]
    rays = generate_pixel_rays(cam.as_arrays(),
                               jnp.asarray(xx.ravel()), jnp.asarray(yy.ravel()))
    h_ref = trace_bruteforce(ts.tri_verts, rays)
    h_mxu = trace_mxu(cs, rays, tile=1024).hits
    assert (np.asarray(h_mxu.tri) >= 0).mean() > 0.3
    assert_hits_match(h_ref, h_mxu, rays)


def test_mxu_random_rays(scenes, rng):
    sd, ts, cs = scenes
    n = 4096
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.2, 6, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = make_rays(jnp.asarray(o), jnp.asarray(d), tmin=0.0, tmax=1e6)
    h_ref = trace_bruteforce(ts.tri_verts, rays)
    h_mxu = trace_mxu(cs, rays, tile=512).hits
    assert_hits_match(h_ref, h_mxu, rays)


def test_mxu_attrs_match_gathers(scenes, rng):
    """Winner attribute rows must equal directly gathered attributes."""
    sd, ts, cs = scenes
    n = 2048
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.5, 6, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = make_rays(jnp.asarray(o), jnp.asarray(d), tmin=0.0, tmax=1e6)
    res = trace_mxu(cs, rays, tile=1024)
    tri = np.asarray(res.hits.tri)
    attrs = np.asarray(res.attrs)
    hit = tri >= 0
    assert hit.sum() > 100
    idx = sd.indices[tri[hit]]
    up = unpack_attrs_np(attrs[hit])
    # Shading attrs are stored bf16 (2^-9 round-to-nearest rel error).
    np.testing.assert_allclose(up["n0"], sd.normals[idx[:, 0]], atol=2.5e-3)
    np.testing.assert_allclose(up["n1"], sd.normals[idx[:, 1]], atol=2.5e-3)
    np.testing.assert_allclose(up["n2"], sd.normals[idx[:, 2]], atol=2.5e-3)
    # ng is derived from the exact stored edges.
    e1 = attrs[hit, ATTR_GEOM_COL + 3:ATTR_GEOM_COL + 6]
    e2 = attrs[hit, ATTR_GEOM_COL + 6:ATTR_GEOM_COL + 9]
    ng = np.cross(e1, e2)
    ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
    np.testing.assert_allclose(ng, sd.triangle_normals[tri[hit]], atol=1e-5)
    np.testing.assert_allclose(up["mat"],
                               sd.triangle_materials[tri[hit]].astype(np.float32),
                               atol=0)


def test_mxu_active_mask(scenes):
    sd, ts, cs = scenes
    n = 512
    o = jnp.broadcast_to(jnp.asarray([0.0, 5.0, 0.0]), (n, 3))
    d = jnp.broadcast_to(jnp.asarray([0.0, -1.0, 0.0]), (n, 3))
    rays = make_rays(o, d, tmin=0.0)
    active = jnp.arange(n) % 2 == 0
    h = trace_mxu(cs, rays, active=active, tile=512).hits
    tri = np.asarray(h.tri)
    assert np.all(tri[0::2] >= 0)
    assert np.all(tri[1::2] == INVALID_TRIANGLE)


def test_mxu_tmin_tmax(scenes, rng):
    sd, ts, cs = scenes
    n = 1024
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.5, 5, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = make_rays(jnp.asarray(o), jnp.asarray(d), tmin=1.0, tmax=4.0)
    h_ref = trace_bruteforce(ts.tri_verts, rays)
    h_mxu = trace_mxu(cs, rays, tile=512).hits
    t = np.asarray(h_mxu.t)
    hit = np.asarray(h_mxu.tri) >= 0
    assert np.all(t[hit] > 1.0 - 1e-6)
    assert np.all(t[hit] <= 4.0 + 1e-5)
    assert_hits_match(h_ref, h_mxu, rays)


def test_occlusion_matches_closest_hit(scenes, rng):
    """Any-hit occlusion query agrees with 'closest hit exists'
    (an RTC_OCCLUDED-style query; bench.py config 1 shadow rays)."""
    from rayaccel_tpu.ops.trace_mxu import trace_occlusion_mxu
    sd, ts, cs = scenes
    n = 2048
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.2, 6, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = make_rays(jnp.asarray(o), jnp.asarray(d), tmin=0.0, tmax=20.0)
    occ = np.asarray(trace_occlusion_mxu(cs, rays, tile=512))
    hit = np.asarray(trace_mxu(cs, rays, tile=512).hits.tri) >= 0
    np.testing.assert_array_equal(occ, hit)


def test_occlusion_respects_active_and_tmax(scenes):
    from rayaccel_tpu.ops.trace_mxu import trace_occlusion_mxu
    sd, ts, cs = scenes
    n = 512
    o = jnp.broadcast_to(jnp.asarray([0.0, 5.0, 0.0]), (n, 3))
    d = jnp.broadcast_to(jnp.asarray([0.0, -1.0, 0.0]), (n, 3))
    rays = make_rays(o, d, tmin=0.0, tmax=100.0)
    active = jnp.arange(n) % 2 == 0
    occ = np.asarray(trace_occlusion_mxu(cs, rays, active=active, tile=512))
    assert occ[0::2].all() and not occ[1::2].any()
    # tmax shorter than the ground distance: nothing occludes.
    rays2 = make_rays(o, d, tmin=0.0, tmax=1.0)
    occ2 = np.asarray(trace_occlusion_mxu(cs, rays2, tile=512))
    assert not occ2.any()


def test_occlusion_xla_and_pallas_match_mxu(scenes, rng):
    """Any-hit queries must agree between the BVH engine and the cluster
    engine (the same cross-engine oracle as closest-hit; reference
    early-exit semantics Kernels.h:190-210). The cluster engine is the
    only one left of the former cluster-kernel family."""
    from rayaccel_tpu.ops.trace import trace_occlusion_bvh
    from rayaccel_tpu.ops.trace_mxu import trace_occlusion_mxu
    sd, ts, cs = scenes
    n = 2048
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.2, 6, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = make_rays(jnp.asarray(o), jnp.asarray(d), tmin=0.0, tmax=20.0)
    active = jnp.arange(n) % 4 != 3
    occ_mxu = np.asarray(trace_occlusion_mxu(cs, rays, active=active, tile=512))
    occ_xla = np.asarray(trace_occlusion_bvh(ts, rays, active=active))
    np.testing.assert_array_equal(occ_xla, occ_mxu)
    assert occ_mxu.any()
    assert not occ_mxu[3::4].any()


def test_mxu_attrs_bitwise_equal_host_gather(scenes, rng):
    """The attribute rows the tracer returns for the winners are bitwise
    the rows of the host-side table at the winners' slots: the bf16-pair
    words can be denormal float32 bit patterns, which a gather must carry
    unchanged (a matmul or a flushing copy would zero them)."""
    from tools.oracle_lib import attrs_match_host
    sd, ts, cs = scenes
    n = 2048
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.5, 6, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = make_rays(jnp.asarray(o), jnp.asarray(d), tmin=0.0, tmax=1e6)
    res = trace_mxu(cs, rays, tile=1024)
    assert (np.asarray(res.hits.tri) >= 0).sum() > 100
    assert attrs_match_host(cs, res)


def test_material_gather_bitwise_equal_table_rows(scenes, rng):
    """Material parameters reach the shading frame as exact table rows
    (a row gather, not a one-hot product that may round in TF32)."""
    from rayaccel_tpu.render.shading import surface_from_attrs
    sd, ts, cs = scenes
    n = 2048
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.5, 6, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = make_rays(jnp.asarray(o), jnp.asarray(d), tmin=0.0, tmax=1e6)
    # A table whose entries need all 24 mantissa bits.
    table = jnp.asarray(np.random.default_rng(3).uniform(
        0, 1, np.asarray(cs.mat_params).shape).astype(np.float32)
        + np.float32(1.0 / 3.0))
    res = trace_mxu(cs, rays, tile=1024)
    surf = surface_from_attrs(res.attrs, table, rays, res.hits)
    tri = np.asarray(res.hits.tri)
    hit = tri >= 0
    assert len(set(sd.triangle_materials[tri[hit]].tolist())) > 1
    want = np.asarray(table)[sd.triangle_materials[tri[hit]]]
    np.testing.assert_array_equal(
        np.asarray(surf.mat_params)[hit].view(np.uint32),
        want.view(np.uint32))


def test_wide_waves_trace_in_chunks_with_identical_hits(scenes, rng,
                                                         monkeypatch):
    """Waves wider than MAX_BATCH run as a sequence of whole-tile chunks;
    every tile is independent, so the hits, attributes and any-hit flags
    are bitwise those of the one-batch trace."""
    import rayaccel_tpu.ops.trace_mxu as mod
    from rayaccel_tpu.ops.trace_mxu import map_chunks, trace_occlusion_mxu
    sd, ts, cs = scenes
    n = 4096
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(0.2, 6, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = make_rays(jnp.asarray(o), jnp.asarray(d), tmin=0.0, tmax=20.0)
    active = jnp.arange(n) % 5 != 0

    def run():
        trace_mxu.clear_cache()
        trace_occlusion_mxu.clear_cache()
        res = trace_mxu(cs, rays, active=active, tile=512)
        occ = trace_occlusion_mxu(cs, rays, active=active, tile=512)
        return [np.asarray(x) for x in (res.hits.tri, res.hits.t,
                                         res.hits.u, res.hits.v, res.attrs,
                                         occ)]

    whole = run()
    monkeypatch.setattr(mod, "MAX_BATCH", 1024)      # 4 chunks of 2 tiles
    chunked = run()
    trace_mxu.clear_cache()
    trace_occlusion_mxu.clear_cache()
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a, b)
    # Chunk count: fewest equal whole-tile chunks within the cap.
    sizes = []
    map_chunks(lambda x: sizes.append(x.shape[0]) or x, 245760, 1024,
               jnp.zeros(245760), max_batch=65536)
    assert sizes == [61440]
