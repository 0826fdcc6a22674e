"""Tiled progressive renderer base.

Analog of the reference TiledRenderer (reference TiledRenderer.h:35-68,
TiledRenderer.cpp:11-77): owns the HDR accumulation framebuffer and walks
the frame in fixed-size tiles. Wavefront redesign:

- The atomic tile counter becomes a static partition of the frame into
  waves of ``wave_size`` pixels.
- Pixels are *block-swizzled* (32x16 screen blocks): consecutive wave
  lanes form compact screen tiles so the cluster tracer's ray tiles are
  spatially coherent — the wavefront analog of the reference's 128x128
  tile coherence (TiledRenderer.h:37).
- The framebuffer is stored in swizzled lane order and each wave writes
  one contiguous slice. Because a path-tracing/Whitted lane serves
  exactly one pixel, radiance accumulates in per-lane registers and no
  scatter ever touches the framebuffer (the reference instead relies on
  benignly-racy scatter into a shared buffer, SURVEY.md §5; lane-order
  accumulation is deterministic and needs no atomics). ``image()``
  un-permutes on the host once per readback.

Subclasses implement :meth:`_build_wave_fn` returning a jitted
``(x, y, alive, key) -> (radiance, rays_traced)`` closure; this inversion
mirrors the reference's spawn/shade callbacks (RayAccelerator.h:89-93)
with the library driving the loop.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from functools import partial

from jax import shard_map
from jax.sharding import PartitionSpec as P

from rayaccel_tpu.context import Context
from rayaccel_tpu.types import Stats

BLOCK_W = 32
BLOCK_H = 16


def block_swizzle(width: int, height: int, pad_to: int):
    """Flat pixel ids in block-major order, padded with -1 to ``pad_to``.

    Returns (perm, x, y) int32 arrays of length pad_to; padding lanes have
    perm == -1 and x = y = 0.
    """
    bw, bh = BLOCK_W, BLOCK_H
    nbx = -(-width // bw)
    nby = -(-height // bh)
    ys, xs = np.mgrid[0:nby * bh, 0:nbx * bw]
    inside = (xs < width) & (ys < height)
    key = (((ys // bh) * nbx + (xs // bw)).astype(np.int64) * (bw * bh)
           + (ys % bh) * bw + (xs % bw))
    order = np.argsort(key.ravel(), kind="stable")
    xs = xs.ravel()[order]
    ys = ys.ravel()[order]
    inside = inside.ravel()[order]
    n = len(xs)
    assert pad_to >= n
    perm = np.full(pad_to, -1, np.int64)
    x = np.zeros(pad_to, np.int64)
    y = np.zeros(pad_to, np.int64)
    perm[:n] = np.where(inside, ys * width + xs, -1)
    x[:n] = xs
    y[:n] = ys
    return perm, x, y


class TiledRenderer:
    tile_size = 128  # reference TiledRenderer.h:37 (kept for API parity)

    def __init__(self, context: Context, width: int, height: int):
        self.context = context
        self.width = int(width)
        self.height = int(height)
        # The reference caps in-flight rays with maxRaysInFlight
        # (RayAccelerator.cpp:436); here one wave is the in-flight set.
        self.wave_size = min(context.configuration.wave_size,
                             context.configuration.max_rays_in_flight)
        self.n_pixels = self.width * self.height

        n_blocks = (-(-self.width // BLOCK_W)) * (-(-self.height // BLOCK_H))
        n_lanes = n_blocks * BLOCK_W * BLOCK_H
        self.n_waves = -(-n_lanes // self.wave_size)
        self.n_lanes = self.n_waves * self.wave_size

        perm, x, y = block_swizzle(self.width, self.height, self.n_lanes)
        self._perm = perm
        self._wave_inputs = []
        for w in range(self.n_waves):
            sl = slice(w * self.wave_size, (w + 1) * self.wave_size)
            self._wave_inputs.append((
                jnp.asarray(x[sl], jnp.int32),
                jnp.asarray(y[sl], jnp.int32),
                jnp.asarray(perm[sl] >= 0),
            ))

        self.spp = 0
        # EVERY loop-carried input must have its mesh sharding pinned at
        # CREATION — the fb (P(None, 'tiles')) AND the replicated counter
        # scalars. A carried input whose call-1 sharding (fresh
        # uncommitted value) differs from its call-2 sharding (committed
        # frame-fn output) makes the SECOND frame a full recompile.
        self._dropped_dev = self._make_counter()
        self._rays_dev = self._make_counter()
        self._fb3 = self._make_fb()
        self._frame_fn = None  # built lazily from the subclass wave fn
        # Stacked wave inputs for the fused frame loop.
        self._wave_x = jnp.stack([w[0] for w in self._wave_inputs])
        self._wave_y = jnp.stack([w[1] for w in self._wave_inputs])
        self._wave_alive = jnp.stack([w[2] for w in self._wave_inputs])

    @property
    def dropped(self) -> int:
        """Overflow/drop counter (device-accumulated; reading syncs)."""
        return int(self._dropped_dev)

    @property
    def rays_traced_total(self) -> int:
        """Lifetime rays-traced counter, accumulated INSIDE the jitted
        frame fn (zero per-frame eager device ops). Reading syncs, so
        benchmark loops read it once per RUN (the reference's figure of
        merit is also one wall-clock over presented frames,
        main.cpp:215-231)."""
        return int(self._rays_dev)

    # -- framebuffer management (TiledRenderer.cpp:51-60) --
    def _make_fb(self) -> jnp.ndarray:
        fb3 = jnp.zeros((self.n_waves, self.wave_size, 3), jnp.float32)
        if self.context.mesh is not None:
            from jax.sharding import NamedSharding
            fb3 = jax.device_put(
                fb3, NamedSharding(self.context.mesh, P(None, "tiles")))
        return fb3

    def _make_counter(self) -> jnp.ndarray:
        """Zero counter scalar with the frame fn's output sharding
        (replicated over the mesh) pinned at creation — see __init__."""
        z = jnp.int32(0)
        if self.context.mesh is not None:
            from jax.sharding import NamedSharding
            z = jax.device_put(z, NamedSharding(self.context.mesh, P()))
        return z

    def clear(self):
        self._fb3 = self._make_fb()
        self.spp = 0

    @property
    def frame_buffer(self) -> jnp.ndarray:
        """Swizzled lane-order accumulation buffer (flat view)."""
        return self._fb3.reshape(self.n_lanes, 3)

    def set_frame_buffer(self, fb_flat: jnp.ndarray):
        """Restore a flat (n_lanes, 3) buffer (checkpoint resume),
        re-pinning the mesh sharding the frame fn expects."""
        fb3 = jnp.asarray(fb_flat, jnp.float32).reshape(
            self.n_waves, self.wave_size, 3)
        if self.context.mesh is not None:
            from jax.sharding import NamedSharding
            fb3 = jax.device_put(
                fb3, NamedSharding(self.context.mesh, P(None, "tiles")))
        self._fb3 = fb3

    def image(self) -> np.ndarray:
        """Accumulated HDR image divided by spp (DisplayBuffer.cpp:22-74
        does the divide during present). Un-permutes the swizzled buffer."""
        spp = max(self.spp, 1)
        fb = np.asarray(self._fb3).reshape(self.n_lanes, 3)
        img = np.zeros((self.n_pixels, 3), np.float32)
        valid = self._perm >= 0
        img[self._perm[valid]] = fb[valid]
        return img.reshape(self.height, self.width, 3) / spp

    # -- frame loop (role of racc::render + cpuWorkerThread spawn path) --
    def render_frame(self, key: jax.Array) -> Stats:
        """Render one progressive sample over the full viewport: the analog
        of one racc::render frame barrier (RayAccelerator.cpp:738-759).

        The whole frame (all waves, all bounces) is ONE compiled call —
        single-device AND multi-device: a lax.scan over waves accumulating
        into the framebuffer, with the scan INSIDE the shard_map in the
        mesh case so dispatch overhead is paid once per frame, never per
        wave; counters stay device-side until queried."""
        # No eager device ops in the dispatch path: the fb rides in the
        # frame fn's native 3D shape with its sharding pinned at creation
        # (the frame fn's P(None, 'tiles') output matches, so frame 2+
        # hits the same compiled executable instead of re-sharding the fb
        # every frame); spp rides as a host np scalar (uploaded with the
        # call), and the ray/drop counters accumulate INSIDE the compiled
        # frame fn (an eager `acc + x` per frame is one more dispatch).
        self._fb3, self._rays_dev, self._dropped_dev, traced = \
            self._frame_fn_built()(*self._frame_args(key))
        self.spp += 1
        self.end_frame()
        return Stats(rays_traced=traced)

    def lower_frame(self, key: jax.Array):
        """The frame function lowered for this renderer's arguments (for
        ``.compile().memory_analysis()`` and cost reports)."""
        return self._frame_fn_built().lower(*self._frame_args(key))

    def _frame_fn_built(self):
        if self._frame_fn is None:
            self._frame_fn = self._build_frame_fn()
        return self._frame_fn

    def _frame_args(self, key):
        return (self._fb3, self._rays_dev, self._dropped_dev,
                self._wave_x, self._wave_y, self._wave_alive, key,
                np.int32(self.spp), *self._extra_wave_args())

    def _build_frame_body(self):
        """Default frame body: a lax.scan over waves around the subclass
        wave fn, each wave tracing all its bounces to completion.
        Subclasses may override with a frame-pooled body (see
        PathTracingRenderer) that shares bounce work across waves."""
        wave_fn = self._build_wave_fn()
        mesh = self.context.mesh

        def frame_body(fb3, xs, ys, alives, key, spp, *extra):
            if mesh is not None:
                # Per-shard sample decorrelation: the per-wave bodies'
                # bounce draws are keyed by LOCAL lane, so the shard is
                # folded in here (the frame-pooled bodies key every draw
                # by global position and take the raw frame key).
                key = jax.random.fold_in(key, jax.lax.axis_index("tiles"))

            def step(carry, inputs):
                traced, dropped, w = carry
                x, y, alive = inputs
                wave_key = jax.random.fold_in(key, w)
                radiance, n, d = wave_fn(x, y, alive, wave_key, spp, *extra)
                return (traced + n, dropped + d, w + 1), radiance

            init = (jnp.int32(0), jnp.int32(0), jnp.int32(0))
            (traced, dropped, _), rad = jax.lax.scan(
                step, init, (xs, ys, alives))
            return fb3 + rad, traced, dropped

        return frame_body

    def _build_frame_fn(self):
        """Compile the whole-frame function. With a device mesh,
        rays/framebuffer lanes shard over the 'tiles' axis (scene
        replicated via parallel.mesh.replicate_scene), the ray counters
        psum across devices — the multi-device analog of the reference's
        atomic tile counter feeding identical workers
        (TiledRenderer.cpp:55-67).
        Bodies receive the RAW frame key and fold the shard index in
        themselves where positional draws need decorrelating (see
        _build_frame_body); lane-keyed draws stay shard-invariant."""
        mesh = self.context.mesh
        n_extra = len(self._extra_wave_args())
        frame_body = self._build_frame_body()

        if mesh is None:
            @jax.jit
            def frame_fn(fb3, rays_acc, dropped_acc, xs, ys, alives, key,
                         spp, *extra):
                fb3, traced, dropped = frame_body(fb3, xs, ys, alives,
                                                  key, spp, *extra)
                return (fb3, rays_acc + traced, dropped_acc + dropped,
                        traced)

            return frame_fn

        # check_vma=False: the frame bodies' lax.cond branches return
        # device-varying values in one branch and replicated constants in
        # the other, which the varying-axes check rejects.
        @jax.jit
        @partial(shard_map, mesh=mesh,
                 in_specs=(P(None, "tiles"), P(), P(), P(None, "tiles"),
                           P(None, "tiles"), P(None, "tiles"), P(), P())
                 + (P(),) * n_extra,
                 out_specs=(P(None, "tiles"), P(), P(), P()),
                 check_vma=False)
        def frame_fn(fb3, rays_acc, dropped_acc, xs, ys, alives, key, spp,
                     *extra):
            fb3, traced, dropped = frame_body(fb3, xs, ys, alives, key, spp,
                                              *extra)
            traced = jax.lax.psum(traced, "tiles")
            dropped = jax.lax.psum(dropped, "tiles")
            return (fb3, rays_acc + traced, dropped_acc + dropped, traced)

        return frame_fn

    def end_frame(self):
        """Hook mirroring TiledRenderer::endFrame (TiledRenderer.cpp:62-64)."""

    def _extra_wave_args(self) -> tuple:
        """Traced per-frame arguments appended to the wave fn (subclasses
        pass the camera here so a camera move re-uses the compiled frame
        fn — the wavefront form of the reference's interactive loop where
        every frame re-reads the camera, main.cpp:193-206)."""
        return ()

    def set_camera(self, camera):
        """Move the camera and reset progressive accumulation — the analog
        of the reference's accumulation reset on mouse/WASD movement
        (main.cpp:204-205, 248-251). No recompilation: the camera is a
        traced argument of the compiled frame fn."""
        self.camera = camera
        self.clear()

    def _build_wave_fn(self):
        raise NotImplementedError
