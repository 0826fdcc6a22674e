"""Multi-chip tile parallelism on the virtual 8-device CPU mesh
(bench.py config 5: replicated scene, sharded waves, psum counters)."""

import numpy as np
import jax
import pytest

import rayaccel_tpu as racc
from rayaccel_tpu.scene.loader import make_test_scene


@pytest.fixture(scope="module")
def scene64():
    return make_test_scene(viewport=(64, 64), max_depth=2)


def make_renderer(scene, mesh_shape=None, backend="mxu", whitted=False):
    cfg = racc.Configuration(wave_size=4096, backend=backend,
                             mesh_shape=mesh_shape)
    ctx = racc.create_context(cfg)
    cam = racc.Camera.look_at(scene.cam_origin, scene.cam_dir, scene.cam_up,
                              scene.cam_fov, 64, 64)
    cls = racc.WhittedRenderer if whitted else racc.PathTracingRenderer
    return cls(ctx, cam, scene)


def test_mesh_context_created(scene64):
    ctx = racc.create_context(racc.Configuration(mesh_shape=(8,)))
    assert ctx.mesh is not None
    assert ctx.mesh.devices.size == 8


@pytest.mark.parametrize("whitted", [False, True])
def test_sharded_render_runs(scene64, whitted):
    r = make_renderer(scene64, mesh_shape=(8,), whitted=whitted)
    stats = r.render_frame(jax.random.PRNGKey(0))
    img = r.image()
    assert np.isfinite(img).all() and (img >= 0).all()
    assert img.max() > 0.01
    assert int(stats.rays_traced) >= 64 * 64
    if whitted:
        assert r.dropped == 0


def test_sharded_matches_single_chip_statistically(scene64):
    """Sharded and single-chip renders use decorrelated per-shard keys, so
    compare converged images (the same scene integrated two ways)."""
    r1 = make_renderer(scene64, mesh_shape=None)
    r8 = make_renderer(scene64, mesh_shape=(8,))
    for i in range(12):
        r1.render_frame(jax.random.PRNGKey(i))
        r8.render_frame(jax.random.PRNGKey(1000 + i))
    rmse = np.sqrt(np.mean((r1.image() - r8.image()) ** 2))
    assert rmse < 0.05, f"sharded render diverges: rmse={rmse}"


def test_sharded_whitted_matches_single_chip(scene64):
    """Whitted is deterministic given primary jitter; with the same
    per-wave key structure differing only in shard folding, images agree
    at the converged level."""
    s8 = type(scene64)(**{**scene64.__dict__, "max_depth": 8})
    r1 = make_renderer(s8, mesh_shape=None, whitted=True)
    r8 = make_renderer(s8, mesh_shape=(8,), whitted=True)
    for i in range(4):
        r1.render_frame(jax.random.PRNGKey(i))
        r8.render_frame(jax.random.PRNGKey(1000 + i))
    rmse = np.sqrt(np.mean((r1.image() - r8.image()) ** 2))
    assert rmse < 0.05


def test_replicate_scene_places_on_all_devices(scene64):
    from rayaccel_tpu.parallel.mesh import make_mesh, replicate_scene
    from rayaccel_tpu.scene.clusters import compile_clusters
    mesh = make_mesh(jax.devices()[:8])
    cs = compile_clusters(scene64, cluster_size=16)
    rep = replicate_scene(mesh, cs)
    assert len(rep.G.sharding.device_set) == 8


def test_bounce_resharding_balances_and_preserves_image(scene64):
    """Cross-chip bounce load balance (SURVEY §2d work-stealing analog;
    reference RayAccelerator.cpp:215-244, 360-363): with half the mesh's
    lanes dead after stage 1, the reshard exchange must (a) spread bounce
    trace work across all shards and (b) leave the image BITWISE
    unchanged — bounce RNG is keyed by global lane id (_lane_uniform),
    so lane placement cannot affect radiance."""
    from functools import partial
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map
    import jax.numpy as jnp
    from rayaccel_tpu.camera import Camera
    from rayaccel_tpu.environment import create_environment
    from rayaccel_tpu.parallel.mesh import replicate_scene
    from rayaccel_tpu.render.pathtracer import pt_trace_frame
    from rayaccel_tpu.render.tiled import block_swizzle
    from rayaccel_tpu.scene.clusters import compile_clusters

    sd = make_test_scene(viewport=(128, 128), max_depth=3)
    D = 8
    mesh = Mesh(np.asarray(jax.devices()[:D]), ("tiles",))
    scene = replicate_scene(mesh, compile_clusters(sd, cluster_size=32))
    env = replicate_scene(mesh, create_environment(
        sd.env_pixels, sd.env_pixels.shape[1], sd.env_pixels.shape[0]))
    cam = Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up, sd.cam_fov,
                         128, 128).as_arrays()

    n_lanes = 16384
    perm, x, y = block_swizzle(128, 128, n_lanes)
    xs = jnp.asarray(x[None, :], jnp.int32)           # one wave
    ys = jnp.asarray(y[None, :], jnp.int32)
    # Kill the lanes of shards 4-7 (the R axis shards contiguously):
    # shards 0-3 carry every live bounce ray -> 2x imbalance.
    alive = (perm >= 0) & (np.arange(n_lanes) < n_lanes // 2)
    alives = jnp.asarray(alive[None, :])

    def run(reshard):
        @jax.jit
        @partial(shard_map, mesh=mesh,
                 in_specs=(P(None, "tiles"),) * 3 + (P(),),
                 out_specs=(P(None, "tiles"), P("tiles")),
                 check_vma=False)
        def fn(xs, ys, alives, key):
            rad, traced, _ = pt_trace_frame(
                scene, env, cam, xs, ys, alives, key, max_depth=3,
                backend="mxu", tile=512, mesh_axis="tiles", n_shards=D,
                reshard=reshard)
            return rad, traced[None]

        rad, traced = fn(xs, ys, alives, jax.random.PRNGKey(7))
        return np.asarray(rad), np.asarray(traced)

    rad_off, traced_off = run(False)
    rad_on, traced_on = run(True)

    # (b) bitwise-identical radiance in original lane order.
    np.testing.assert_array_equal(rad_on, rad_off)

    # (a) without resharding the dead shards do only stage-1 work; with
    # it, bounce work spreads: the idle half's share of traced rays must
    # grow and the busy half's max must drop.
    idle_off = traced_off[D // 2:].sum()
    idle_on = traced_on[D // 2:].sum()
    assert traced_on.sum() == traced_off.sum(), "ray conservation"
    assert idle_on > idle_off, (
        f"resharding moved no work: {traced_off} -> {traced_on}")
    assert traced_on.max() < traced_off.max(), (
        f"busiest shard not relieved: {traced_off} -> {traced_on}")


def _mesh_frame_fixture(viewport=128, n_lanes=16384, max_depth=3, D=8):
    from jax.sharding import Mesh
    import jax.numpy as jnp
    from rayaccel_tpu.camera import Camera
    from rayaccel_tpu.environment import create_environment
    from rayaccel_tpu.parallel.mesh import replicate_scene
    from rayaccel_tpu.render.tiled import block_swizzle
    from rayaccel_tpu.scene.clusters import compile_clusters

    sd = make_test_scene(viewport=(viewport, viewport), max_depth=max_depth)
    mesh = Mesh(np.asarray(jax.devices()[:D]), ("tiles",))
    scene = replicate_scene(mesh, compile_clusters(sd, cluster_size=32))
    env = replicate_scene(mesh, create_environment(
        sd.env_pixels, sd.env_pixels.shape[1], sd.env_pixels.shape[0]))
    cam = Camera.look_at(sd.cam_origin, sd.cam_dir, sd.cam_up, sd.cam_fov,
                         viewport, viewport).as_arrays()
    perm, x, y = block_swizzle(viewport, viewport, n_lanes)
    xs = jnp.asarray(x[None, :], jnp.int32)
    ys = jnp.asarray(y[None, :], jnp.int32)
    return mesh, scene, env, cam, perm, xs, ys


def test_whitted_resharding_balances_and_preserves_image():
    """The Whitted pooled tree loop gets the SAME cross-chip balance as
    PT (stream stealing is integrator-agnostic in the
    reference, RayAccelerator.cpp:215-244): the parked level-0 stacks
    ride the exchange, radiance pieces route home, and the image is
    bitwise invariant (Whitted shading is deterministic and the engines
    are batch-width invariant)."""
    from functools import partial
    from jax.sharding import PartitionSpec as P
    from jax import shard_map
    import jax.numpy as jnp
    from rayaccel_tpu.render.whitted import whitted_trace_frame

    D = 8
    mesh, scene, env, cam, perm, xs, ys = _mesh_frame_fixture(D=D)
    n_lanes = xs.shape[1]
    alive = (perm >= 0) & (np.arange(n_lanes) < n_lanes // 2)
    alives = jnp.asarray(alive[None, :])

    def run(reshard):
        @jax.jit
        @partial(shard_map, mesh=mesh,
                 in_specs=(P(None, "tiles"),) * 3 + (P(),),
                 out_specs=(P(None, "tiles"), P("tiles")),
                 check_vma=False)
        def fn(xs, ys, alives, key):
            rad, traced, dropped = whitted_trace_frame(
                scene, env, cam, xs, ys, alives, key, max_depth=3,
                stack_size=4, backend="mxu", tile=512, min_stage_width=1024,
                mesh_axis="tiles", n_shards=D, reshard=reshard)
            del dropped
            return rad, traced[None]

        rad, traced = fn(xs, ys, alives, jax.random.PRNGKey(7))
        return np.asarray(rad), np.asarray(traced)

    rad_off, traced_off = run(False)
    rad_on, traced_on = run(True)
    np.testing.assert_array_equal(rad_on, rad_off)
    assert traced_on.sum() == traced_off.sum(), "ray conservation"
    idle_off = traced_off[D // 2:].sum()
    idle_on = traced_on[D // 2:].sum()
    assert idle_on > idle_off, (
        f"resharding moved no work: {traced_off} -> {traced_on}")
    assert traced_on.max() < traced_off.max(), (
        f"busiest shard not relieved: {traced_off} -> {traced_on}")


def test_reshard_no_fire_on_mild_imbalance():
    """Boundary pin: when the imbalance is under the
    >25%+slack threshold, `need` stays False and the no-fire cond leaves
    the whole frame BITWISE identical to reshard=False — for both frame
    pools — and an alternating fire/no-fire frame pair agrees too."""
    from functools import partial
    from jax.sharding import PartitionSpec as P
    from jax import shard_map
    import jax.numpy as jnp
    from rayaccel_tpu.render.pathtracer import pt_trace_frame
    from rayaccel_tpu.render.whitted import whitted_trace_frame

    D = 8
    mesh, scene, env, cam, perm, xs, ys = _mesh_frame_fixture(D=D)
    n_lanes = xs.shape[1]
    # Mild imbalance: kill 5% of ONE shard's lanes. max*D = 2048*8 =
    # 16384 < total (16282) + total//4 — far below the fire threshold.
    mild = (perm >= 0) & ~((np.arange(n_lanes) >= n_lanes - 102)
                           & (np.arange(n_lanes) < n_lanes))
    # Gross imbalance: half the mesh dead (fires).
    gross = (perm >= 0) & (np.arange(n_lanes) < n_lanes // 2)

    def run(fn_impl, alives, reshard, **kw):
        @jax.jit
        @partial(shard_map, mesh=mesh,
                 in_specs=(P(None, "tiles"),) * 3 + (P(),),
                 out_specs=P(None, "tiles"),
                 check_vma=False)
        def fn(xs, ys, alives, key):
            rad = fn_impl(
                scene, env, cam, xs, ys, alives, key, max_depth=3,
                backend="mxu", tile=512, mesh_axis="tiles", n_shards=D,
                reshard=reshard, **kw)[0]
            return rad

        return np.asarray(fn(xs, ys, alives, jax.random.PRNGKey(3)))

    for impl, kw in ((pt_trace_frame, {}),
                     (whitted_trace_frame,
                      dict(stack_size=4, min_stage_width=1024))):
        a_mild = jnp.asarray(mild[None, :])
        np.testing.assert_array_equal(
            run(impl, a_mild, True, **kw), run(impl, a_mild, False, **kw))
        # Alternating fire / no-fire frames agree with reshard off.
        a_gross = jnp.asarray(gross[None, :])
        np.testing.assert_array_equal(
            run(impl, a_gross, True, **kw), run(impl, a_gross, False, **kw))


@pytest.mark.parametrize("whitted", [False, True])
def test_mesh_frame_matches_single_device(whitted):
    """A tile-parallel frame with bounce re-sharding renders the same
    image, with the same ray count, as one device given the same keys:
    camera jitter is keyed by pixel and every BSDF draw by the lane's
    position in the unsharded frame (camera.id_uniform), never by shard.
    Tolerance is float rounding: the two are separate compilations."""
    sd = make_test_scene(viewport=(64, 64), max_depth=8 if whitted else 2)
    out = {}
    for mesh_shape in ((4,), None):
        r = make_renderer(sd, mesh_shape=mesh_shape, whitted=whitted)
        for i in range(2):
            r.render_frame(jax.random.PRNGKey(20 + i))
        out[mesh_shape] = (r.image(), r.rays_traced_total, r.dropped)
    img4, rays4, drop4 = out[(4,)]
    img1, rays1, drop1 = out[None]
    assert rays4 == rays1 and drop4 == drop1 == 0
    np.testing.assert_allclose(img4, img1, rtol=1e-5, atol=1e-6)


def test_id_uniform_is_keyed_by_id_not_position():
    """Draws for an id do not depend on the batch it is drawn in."""
    import jax.numpy as jnp
    from rayaccel_tpu.camera import id_uniform
    key = jax.random.PRNGKey(3)
    ids = jnp.arange(4096, dtype=jnp.int32) * 7 + 11
    full = np.asarray(id_uniform(key, ids, 3))
    perm = np.random.default_rng(0).permutation(4096)
    part = np.asarray(id_uniform(key, ids[perm[:1000]], 3))
    np.testing.assert_array_equal(part, full[perm[:1000]])
    assert full.shape == (4096, 3)
    assert 0.0 <= full.min() and full.max() < 1.0
    assert abs(full.mean() - 0.5) < 0.02
