"""Integrator tests: golden checks against direct oracle evaluation and the
invariants mirrored from the reference's runtime asserts (SURVEY.md §4).
Parameterized over both traversal backends (the dual-engine oracle)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import rayaccel_tpu as racc
from rayaccel_tpu.environment import create_environment, sample_environment_onehot
from rayaccel_tpu.camera import Camera, generate_pixel_rays
from rayaccel_tpu.ops.bruteforce import trace_bruteforce
from rayaccel_tpu.types import INVALID_TRIANGLE


def make_context(backend, wave_size=4096, **kw):
    cfg = racc.Configuration(wave_size=wave_size, backend=backend, **kw)
    return racc.create_context(cfg)


@pytest.fixture(scope="module")
def small_scene():
    from rayaccel_tpu.scene.loader import make_test_scene
    return make_test_scene(viewport=(64, 64), max_depth=3)


def cam_of(s):
    return Camera.look_at(s.cam_origin, s.cam_dir, s.cam_up, s.cam_fov,
                          s.viewport_width, s.viewport_height)


def env_of(scene_data):
    px = scene_data.env_pixels
    return create_environment(px, px.shape[1], px.shape[0])


@pytest.mark.parametrize("backend", ["mxu", "xla"])
def test_pt_depth0_matches_oracle(small_scene, backend):
    """With max_depth=0 a pixel is exactly env radiance on miss, 0 on hit
    (misses contribute, hits terminate): checkable without any BVH."""
    s = small_scene
    s0 = type(s)(**{**s.__dict__, "max_depth": 0})
    ctx = make_context(backend)
    cam = cam_of(s)
    r = racc.PathTracingRenderer(ctx, cam, s0)
    key = jax.random.PRNGKey(0)
    stats = r.render_frame(key)
    img = r.image().reshape(-1, 3)

    n = s.viewport_width * s.viewport_height
    assert int(stats.rays_traced) == n

    # Oracle: regenerate the same primary rays wave by wave (same key path)
    # and evaluate env-on-miss directly.
    from rayaccel_tpu.scene.compile import compile_scene
    tri_verts = compile_scene(s0).tri_verts
    expected = np.zeros((n, 3), np.float32)
    env = env_of(s)
    for w, (x, y, alive) in enumerate(r._wave_inputs):
        wave_key = jax.random.fold_in(jax.random.fold_in(key, w), 0)
        rays = generate_pixel_rays(cam.as_arrays(), x, y, key=wave_key)
        hits = trace_bruteforce(tri_verts, rays)
        miss = np.asarray(hits.tri) == INVALID_TRIANGLE
        env_rgb = np.asarray(sample_environment_onehot(env, rays.d))
        rad = np.where(miss[:, None], env_rgb, 0.0)
        perm = r._perm[w * r.wave_size:(w + 1) * r.wave_size]
        ok = perm >= 0
        expected[perm[ok]] = rad[ok]
    np.testing.assert_allclose(img, expected, atol=2e-4)


@pytest.mark.parametrize("backend", ["mxu", "xla"])
def test_pt_progressive_and_finite(small_scene, backend):
    ctx = make_context(backend)
    s = small_scene
    r = racc.PathTracingRenderer(ctx, cam_of(s), s)
    total = 0
    for i in range(3):
        stats = r.render_frame(jax.random.PRNGKey(i))
        total += int(stats.rays_traced)
    assert r.spp == 3
    img = r.image()
    assert np.isfinite(img).all()
    assert (img >= 0).all()
    assert img.max() > 0.01, "image should not be black"
    n = s.viewport_width * s.viewport_height
    # Ray conservation: every pixel traces at least the primary each frame,
    # at most max_depth+1 rays (RayAccelerator.cpp:63-74 analog).
    assert 3 * n <= total <= 3 * n * (s.max_depth + 1)


def test_pt_pooled_matches_per_wave_depth0(small_scene):
    """The frame-pooled loop (regroup=True) and the per-wave fallback
    (regroup=False) derive identical primary jitter keys, so at
    max_depth=0 — where no stochastic shading happens — their images
    must match bitwise. Pins the pooled pipeline's piece reassembly."""
    import numpy as np
    s = type(small_scene)(**{**small_scene.__dict__, "max_depth": 0})
    imgs = {}
    for pooled in (True, False):
        r = racc.PathTracingRenderer(make_context("mxu", regroup=pooled),
                                     cam_of(s), s)
        r.render_frame(jax.random.PRNGKey(11))
        imgs[pooled] = r.image()
    np.testing.assert_array_equal(imgs[True], imgs[False])


def _frame_inputs(n_lanes, wave, w, h):
    from rayaccel_tpu.render.tiled import block_swizzle
    perm, x, y = block_swizzle(w, h, n_lanes)
    W = n_lanes // wave
    return (jnp.asarray(x.reshape(W, wave), jnp.int32),
            jnp.asarray(y.reshape(W, wave), jnp.int32),
            jnp.asarray((perm >= 0).reshape(W, wave)))


def test_pt_pooled_depth2_cross_engine(small_scene):
    """The production frame-pooled pipeline at depth 2 on the cluster
    engine against the same pipeline on the BVH engine: both share RNG
    keys, so the pooled radiance agrees everywhere except the pixels
    whose path forks at a shared-edge tie — a percent-level radiance bug
    in the shrink/reassembly of either engine's path breaks this."""
    from rayaccel_tpu.render.pathtracer import pt_trace_frame
    from rayaccel_tpu.scene.clusters import compile_clusters
    from rayaccel_tpu.scene.compile import compile_scene
    s = small_scene
    scenes = {"mxu": compile_clusters(s), "xla": compile_scene(s)}
    env = env_of(s)
    xs, ys, als = _frame_inputs(4096, 1024, 64, 64)
    cam = cam_of(s).as_arrays()
    out = {}
    for bk, scene in scenes.items():
        rad, traced, dropped = pt_trace_frame(
            scene, env, cam, xs, ys, als, jax.random.PRNGKey(5), 2,
            backend=bk, tile=512)
        assert int(dropped) == 0
        out[bk] = np.asarray(rad).reshape(-1, 3)
    d = np.abs(out["mxu"] - out["xla"]).max(axis=-1)
    forked = d > 0.05
    assert forked.mean() < 0.005, f"{forked.sum()} lanes forked"
    assert np.sqrt(np.mean(d[~forked] ** 2)) < 1e-4


def test_pt_pooled_shrink_boundary_bitwise(small_scene):
    """Force a mid-frame pool shrink (min_stage_width floor) and check
    lane reassembly against the same frame with the shrink disabled: the
    staged shrink and piece reassembly must be a pure re-ordering of
    lanes. Tolerance is 1-ULP scale (the deferred env batch is row-
    permuted by the shrink, which perturbs XLA's reduction order); a
    reassembly bug scrambles whole pixels and fails by many orders."""
    from rayaccel_tpu.render.pathtracer import pt_trace_frame
    from rayaccel_tpu.scene.clusters import compile_clusters
    s = small_scene
    cs = compile_clusters(s)
    from rayaccel_tpu.environment import create_environment
    env = create_environment(s.env_pixels, s.env_pixels.shape[1],
                             s.env_pixels.shape[0])
    xs, ys, als = _frame_inputs(4096, 512, 64, 64)
    cam = cam_of(s).as_arrays()
    rads = {}
    for msw in (1024, 1 << 30):  # 4096 -> [4096, 1024] vs [4096]
        rad, _, dropped = pt_trace_frame(
            cs, env, cam, xs, ys, als, jax.random.PRNGKey(9), 2,
            backend="mxu", tile=512, min_stage_width=msw)
        assert int(dropped) == 0
        rads[msw] = np.asarray(rad)
    np.testing.assert_allclose(rads[1024], rads[1 << 30],
                               rtol=5e-7, atol=1e-7)


def test_pt_backends_agree(small_scene):
    """The two traversal engines must produce statistically identical
    renders — the cross-engine oracle (reference: Embree vs OpenCL image
    agreement via --no-gpu/--no-cpu-tracing, main.cpp:289-302)."""
    s = small_scene
    imgs = {}
    for backend in ("mxu", "xla"):
        # regroup permutes the RNG-to-path assignment; disable it so the
        # engines see identical sample sequences.
        r = racc.PathTracingRenderer(make_context(backend, regroup=False),
                                     cam_of(s), s)
        for i in range(4):
            r.render_frame(jax.random.PRNGKey(i))
        imgs[backend] = r.image()
    # Engines may pick either winner at shared-edge ties; each such pick
    # forks the whole bounce path of that pixel (an O(1) radiance diff at
    # 1/spp weight). So the contract is: at most a handful of tie pixels
    # fork, and every NON-forked pixel matches to float noise.
    d = np.abs(imgs["mxu"] - imgs["xla"]).max(axis=-1).reshape(-1)
    forked = d > 1e-2
    assert forked.mean() < 0.005, (
        f"{forked.sum()} of {d.size} pixels diverge — more than edge "
        "ties can explain")
    rest = d[~forked]
    assert np.sqrt(np.mean(rest ** 2)) < 1e-3, (
        f"non-tie pixels diverge: rmse={np.sqrt(np.mean(rest ** 2))}")


def test_pt_regroup_unbiased(small_scene):
    """Between-bounce ray regrouping must not change the integrand: the
    regrouped render converges to the non-regrouped one."""
    s = small_scene
    imgs = {}
    for rg in (False, True):
        r = racc.PathTracingRenderer(make_context("mxu", regroup=rg),
                                     cam_of(s), s)
        for i in range(16):
            r.render_frame(jax.random.PRNGKey(100 + i))
        imgs[rg] = r.image()
    rmse = np.sqrt(np.mean((imgs[True] - imgs[False]) ** 2))
    assert rmse < 0.04, f"regroup changes the image: rmse={rmse}"


def test_pt_wave_regroup_bitwise(small_scene):
    """In-wave regrouping must be EXACTLY radiance-preserving: BSDF draws
    are keyed by lane id (camera.id_uniform), so the live-compaction
    permutation cannot touch any lane's random stream and the per-lane
    radiance must be bitwise identical with regrouping on and off.
    (Stronger than the statistical test above, which would pass with a
    subtle per-lane RNG coupling bug; the two
    RENDERER paths compared there use different loop structures and can
    only agree in distribution.)

    Tolerance is a few ULP, not bitwise: regroup on/off are two separate
    XLA compilations and fusion (FMA contraction) legitimately differs
    (measured: 1-ULP diffs on 0.2% of lanes). An RNG coupling bug shifts
    whole uniform draws — O(1) radiance changes on many lanes — which
    this still fails loudly."""
    from rayaccel_tpu.render.pathtracer import pt_trace_wave
    from rayaccel_tpu.render.tiled import block_swizzle
    from rayaccel_tpu.scene.clusters import compile_clusters

    s = small_scene
    scene = compile_clusters(s, cluster_size=32)
    env = env_of(s)
    cam = cam_of(s).as_arrays()
    perm, x, y = block_swizzle(64, 64, 4096)
    x = jnp.asarray(x, jnp.int32)
    y = jnp.asarray(y, jnp.int32)
    alive = jnp.asarray(perm >= 0)

    out = {}
    for rg in (False, True):
        rad, traced, dropped = pt_trace_wave(
            scene, env, cam, x, y, alive, jax.random.PRNGKey(11),
            max_depth=3, backend="mxu", tile=512, regroup=rg)
        out[rg] = np.asarray(rad)
    np.testing.assert_allclose(out[True], out[False], rtol=1e-6, atol=1e-7)
    # And the mismatch set must be tiny: fusion noise touches isolated
    # lanes; an RNG permutation bug would touch most bounced lanes.
    frac_diff = np.mean(out[True] != out[False])
    assert frac_diff < 0.01, f"{frac_diff:.3%} of lanes differ"


def test_pt_regroup_variance_paired_seeds(small_scene):
    """Paired-seed variance check for the FRAME-POOLED loop. The in-wave
    bitwise test above cannot see the pooled loop's cross-wave lane
    permutation; a subtle RNG coupling bug there
    (two paths sharing uniform draws) keeps the mean image right while
    shifting second moments. Estimate per-pixel variance across K
    independent single-frame renders for pooled on/off and require the
    two variance fields to agree in aggregate — coupling inflates or
    deflates variance O(1), far outside the Monte-Carlo noise band of
    the ratio at this K (chi-square spread ~ sqrt(2/K) per pixel,
    averaged over 4096 pixels)."""
    s = small_scene
    K = 12
    var = {}
    for rg in (False, True):
        r = racc.PathTracingRenderer(make_context("mxu", regroup=rg),
                                     cam_of(s), s)
        frames = []
        for i in range(K):
            r.clear()
            r.render_frame(jax.random.PRNGKey(500 + i))
            frames.append(r.image())
        stack = np.stack(frames)            # (K, H, W, 3)
        var[rg] = stack.var(axis=0).mean()
    ratio = var[True] / var[False]
    assert 0.7 < ratio < 1.4, (
        f"pooled-loop per-pixel variance differs from per-wave: "
        f"ratio={ratio:.3f} (pooled {var[True]:.5f} vs {var[False]:.5f})")


def test_pt_variance_decreases(small_scene):
    ctx = make_context("mxu")
    s = small_scene
    r = racc.PathTracingRenderer(ctx, cam_of(s), s)
    r.render_frame(jax.random.PRNGKey(0))
    img1 = r.image()
    for i in range(1, 8):
        r.render_frame(jax.random.PRNGKey(i))
    img8 = r.image()
    r2 = racc.PathTracingRenderer(ctx, cam_of(s), s)
    for i in range(8, 24):
        r2.render_frame(jax.random.PRNGKey(i))
    ref = r2.image()
    err1 = np.sqrt(np.mean((img1 - ref) ** 2))
    err8 = np.sqrt(np.mean((img8 - ref) ** 2))
    assert err8 < err1


@pytest.mark.parametrize("backend", ["mxu", "xla"])
def test_whitted_renders_and_pool_drains(small_scene, backend):
    ctx = make_context(backend)
    s = small_scene
    s8 = type(s)(**{**s.__dict__, "max_depth": 8})  # main.cpp:346
    r = racc.WhittedRenderer(ctx, cam_of(s), s8)
    stats = r.render_frame(jax.random.PRNGKey(0))
    img = r.image()
    assert np.isfinite(img).all() and (img >= 0).all()
    assert img.max() > 0.01
    # Pool-drained invariant (WhittedRenderer.cpp:62): no overflow drops.
    assert r.dropped == 0
    n = s.viewport_width * s.viewport_height
    assert int(stats.rays_traced) >= n


def test_whitted_backends_agree(small_scene):
    s = small_scene
    s8 = type(s)(**{**s.__dict__, "max_depth": 8})
    imgs = {}
    for backend in ("mxu", "xla"):
        r = racc.WhittedRenderer(make_context(backend), cam_of(s), s8)
        r.render_frame(jax.random.PRNGKey(3))
        imgs[backend] = r.image()
    # Whitted is deterministic, so geometry-edge pixels where float noise
    # flips a reflection branch differ persistently; require agreement
    # everywhere else (the reference's oracle is likewise visual agreement
    # between Embree and the OpenCL engine, not bit equality).
    diff = np.abs(imgs["mxu"] - imgs["xla"]).max(axis=-1)
    frac_diff = (diff > 1e-3).mean()
    rmse = np.sqrt(np.mean((imgs["mxu"] - imgs["xla"]) ** 2))
    assert frac_diff < 0.02, f"{frac_diff:.1%} pixels diverge"
    assert rmse < 0.02, f"backend images diverge: rmse={rmse}"


def test_whitted_deterministic(small_scene):
    ctx = make_context("mxu")
    s = small_scene
    imgs = []
    for _ in range(2):
        r = racc.WhittedRenderer(ctx, cam_of(s), s)
        r.render_frame(jax.random.PRNGKey(7))
        imgs.append(r.image())
    np.testing.assert_array_equal(imgs[0], imgs[1])


def test_render_api_parity(small_scene):
    """racc::render-shaped API drives a frame (RayAccelerator.h:115)."""
    ctx = make_context("mxu")
    s = small_scene
    r = racc.PathTracingRenderer(ctx, cam_of(s), s)
    stats = racc.render(ctx, None, None, r)
    assert int(stats.rays_traced) > 0
    assert r.spp == 1


def test_whitted_pooled_matches_per_wave(small_scene):
    """Whitted shading is deterministic (no RNG), so the frame-pooled
    tree loop (regroup=True => pooled) must reproduce the per-wave
    fallback (regroup=False) exactly: same primaries, same trees, same
    parked-stack drain — only the schedule differs."""
    s = type(small_scene)(**{**small_scene.__dict__, "max_depth": 4})
    imgs = {}
    for pooled in (True, False):
        r = racc.WhittedRenderer(make_context("mxu", regroup=pooled),
                                 cam_of(s), s)
        r.render_frame(jax.random.PRNGKey(2))
        assert r.dropped == 0
        imgs[pooled] = r.image()
    np.testing.assert_allclose(imgs[True], imgs[False],
                               rtol=1e-5, atol=1e-6)


def test_whitted_pooled_shrink_boundary(small_scene):
    """Force the pooled Whitted shrink ladder and compare against the
    unshrunk frame: moving a lane's parked stack through the shrink
    gather must preserve its pending subtree bitwise."""
    from rayaccel_tpu.render.whitted import whitted_trace_frame
    from rayaccel_tpu.scene.clusters import compile_clusters
    s = type(small_scene)(**{**small_scene.__dict__, "max_depth": 6})
    cs = compile_clusters(s)
    from rayaccel_tpu.environment import create_environment
    env = create_environment(s.env_pixels, s.env_pixels.shape[1],
                             s.env_pixels.shape[0])
    xs, ys, als = _frame_inputs(4096, 512, 64, 64)
    cam = cam_of(s).as_arrays()
    rads = {}
    for msw in (1024, 1 << 30):
        rad, traced, dropped = whitted_trace_frame(
            cs, env, cam, xs, ys, als, jax.random.PRNGKey(4), 4,
            stack_size=6, backend="mxu", tile=512, shadows=True,
            min_stage_width=msw)
        assert int(dropped) == 0
        rads[msw] = np.asarray(rad)
    np.testing.assert_array_equal(rads[1024], rads[1 << 30])


def test_whitted_pooled_deep_stack_tier(small_scene):
    """The two-tier stack haul (levels >= hot_levels gathered under a
    cond on max sp) must be exact when the deep tier IS occupied:
    hot_levels=1 forces every sp>=2 park through the cond path, and the
    image must match the all-hot haul bitwise. Also pins stage_ratio
    invariance (2 vs 4 ladders are pure re-stagings)."""
    from rayaccel_tpu.render.whitted import whitted_trace_frame
    from rayaccel_tpu.scene.clusters import compile_clusters
    s = type(small_scene)(**{**small_scene.__dict__, "max_depth": 6})
    cs = compile_clusters(s)
    from rayaccel_tpu.environment import create_environment
    env = create_environment(s.env_pixels, s.env_pixels.shape[1],
                             s.env_pixels.shape[0])
    xs, ys, als = _frame_inputs(4096, 512, 64, 64)
    cam = cam_of(s).as_arrays()
    rads = {}
    for name, kw in (("hot_all", dict(hot_levels=6)),
                     ("hot1", dict(hot_levels=1)),
                     ("hot1_r4", dict(hot_levels=1, stage_ratio=4))):
        rad, traced, dropped = whitted_trace_frame(
            cs, env, cam, xs, ys, als, jax.random.PRNGKey(4), 6,
            stack_size=6, backend="mxu", tile=512, min_stage_width=1024,
            **kw)
        assert int(dropped) == 0
        rads[name] = np.asarray(rad)
    np.testing.assert_array_equal(rads["hot1"], rads["hot_all"])
    np.testing.assert_array_equal(rads["hot1_r4"], rads["hot_all"])


def test_render_api_scene_override(small_scene):
    """Passing a scene/environment override through racc.render must drop
    the compiled-frame cache (which closes over the old arrays): the next
    frame renders the NEW scene (regression: only ``_wave_fn`` was
    invalidated, so overrides silently rendered the stale closure)."""
    from rayaccel_tpu.scene.clusters import compile_clusters
    from rayaccel_tpu.scene.loader import make_test_scene
    ctx = make_context("mxu")
    s = small_scene
    r = racc.PathTracingRenderer(ctx, cam_of(s), s)
    racc.render(ctx, None, None, r, key=jax.random.PRNGKey(3))
    img_before = r.image()

    # A visibly different scene: same format, geometry shifted far away
    # so the camera sees mostly environment.
    s2 = make_test_scene(viewport=(64, 64), max_depth=3)
    s2.vertices = s2.vertices + np.float32(500.0)
    cs2 = compile_clusters(s2)
    r.clear()
    racc.render(ctx, cs2, None, r, key=jax.random.PRNGKey(3))
    img_after = r.image()
    assert not np.allclose(img_before, img_after), \
        "scene override rendered the stale compiled closure"

    # Overriding with the SAME object must not recompile (cache kept).
    fn = r._frame_fn
    assert fn is not None
    racc.render(ctx, cs2, None, r, key=jax.random.PRNGKey(4))
    assert r._frame_fn is fn


def test_whitted_shadows(small_scene):
    """Shadow rays (bench config 1): the shadowed render must be
    strictly darker than the unshadowed one where geometry blocks the
    light, never brighter anywhere."""
    s = small_scene
    s8 = type(s)(**{**s.__dict__, "max_depth": 1})
    base = racc.WhittedRenderer(make_context("mxu"), cam_of(s), s8)
    shad = racc.WhittedRenderer(make_context("mxu"), cam_of(s), s8,
                                shadows=True)
    base.render_frame(jax.random.PRNGKey(0))
    shad.render_frame(jax.random.PRNGKey(0))
    a, b = base.image(), shad.image()
    assert (b <= a + 1e-5).all(), "shadows must never add light"
    assert (a - b).max() > 0.01, "some pixels must actually be shadowed"


def test_stratified_sampler_converges_faster(small_scene):
    """Stratified (R2) sampling should reach lower error than independent
    uniform sampling at equal spp (bench config 4)."""
    s = small_scene
    imgs = {}
    for sampler in ("uniform", "stratified"):
        r = racc.PathTracingRenderer(
            make_context("mxu", sampler=sampler), cam_of(s), s)
        for i in range(8):
            r.render_frame(jax.random.PRNGKey(i))
        imgs[sampler] = r.image()
    ref = racc.PathTracingRenderer(
        make_context("mxu", sampler="stratified"), cam_of(s), s)
    for i in range(100, 140):
        ref.render_frame(jax.random.PRNGKey(i))
    ref_img = ref.image()
    err_u = np.sqrt(np.mean((imgs["uniform"] - ref_img) ** 2))
    err_s = np.sqrt(np.mean((imgs["stratified"] - ref_img) ** 2))
    # Stratification should not be worse; usually clearly better.
    assert err_s < err_u * 1.1, (err_s, err_u)
