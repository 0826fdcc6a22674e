"""Pinhole camera and primary-ray generation.

Behavioral port of the reference camera (reference Camera.cpp:13-53) and
the SIMD tile ray generator (Camera.cpp:55-114), re-expressed as a single
vectorized JAX function over a whole pixel batch instead of an 8-wide
AVX loop. The pixel-delta scales are baked into ``right``/``up`` exactly
like the reference so ray directions match:

    dir(px, py) = normalize(view + right * px + up * py)

with ``right = normalize(cross(fwd, up_in)) * (-2/width * extentX)`` etc.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from rayaccel_tpu.types import Rays


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


@dataclasses.dataclass
class Camera:
    """Camera with baked per-pixel deltas (analog of Camera, Camera.h:15-30)."""

    origin: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    view: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0, 0, 1], np.float32))
    right: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    up: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))

    @staticmethod
    def look_at(origin, target, up, fov_deg, width, height) -> "Camera":
        """Analog of Camera::lookAt (reference Camera.cpp:13-26)."""
        origin = np.asarray(origin, np.float32)
        target = np.asarray(target, np.float32)
        up = np.asarray(up, np.float32)

        forward = _normalize(target - origin)
        right = _normalize(np.cross(forward, up))
        camera_up = np.cross(right, forward)

        aspect = float(width) / float(height)
        extent_x = math.tan(0.5 * fov_deg * (math.pi / 180.0)) * aspect
        extent_y = math.tan(0.5 * fov_deg * (math.pi / 180.0))

        return Camera(
            origin=origin,
            right=(right * (-2.0 / width * extent_x)).astype(np.float32),
            up=(camera_up * (-2.0 / height * extent_y)).astype(np.float32),
            view=(forward + right * extent_x + camera_up * extent_y).astype(np.float32),
        )

    def rotate(self, angle: float, axis, pivot=None) -> "Camera":
        """Analog of Camera::rotate (reference Camera.cpp:28-42)."""
        axis = _normalize(np.asarray(axis, np.float64))
        c, s = math.cos(angle), math.sin(angle)
        x, y, z = axis
        rot = np.array([
            [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
        ])
        pivot = self.origin if pivot is None else np.asarray(pivot, np.float32)
        origin = (rot @ (self.origin - pivot)) + pivot
        return Camera(
            origin=origin.astype(np.float32),
            view=(rot @ self.view).astype(np.float32),
            right=(rot @ self.right).astype(np.float32),
            up=(rot @ self.up).astype(np.float32),
        )

    def forward(self) -> np.ndarray:
        """Analog of Camera::forward (reference Camera.cpp:44-53)."""
        n = _normalize(self.right)
        t = _normalize(self.up)
        fwd = self.view - n * np.dot(self.view, n)
        fwd = fwd - t * np.dot(fwd, t)
        return _normalize(fwd)

    def as_arrays(self):
        return (jnp.asarray(self.origin, jnp.float32),
                jnp.asarray(self.view, jnp.float32),
                jnp.asarray(self.right, jnp.float32),
                jnp.asarray(self.up, jnp.float32))


def id_uniform(key: jax.Array, ids: jnp.ndarray, n: int) -> jnp.ndarray:
    """(R, n) uniforms in [0, 1), n <= 4, keyed by an integer ID per lane
    (< 2^30), not by array position: a lane's draws do not depend on the
    batch it is traced in, so images are reproducible across lane
    placements (regroup, staged width shrink, cross-device re-sharding,
    a different device count).

    ONE threefry sweep. Counter layout: ``m`` (n rounded up to even)
    segments [id, id + 2^30, id + 2^31, ...] — threefry_2x32 splits an
    even-length counter in half, so cipher block i pairs segment k with
    segment k + m/2 of the SAME id: every block is a function of the id
    only, never of the array length or position. The first n output
    segments are the draws."""
    from jax._src import prng as _prng
    m = n + n % 2
    kd = jax.random.key_data(key).astype(jnp.uint32)
    i = ids.astype(jnp.uint32)
    cnt = jnp.concatenate([i + jnp.uint32(k << 30) for k in range(m)])
    bits = _prng.threefry_2x32((kd[0], kd[1]), cnt)
    f = jax.lax.bitcast_convert_type(
        (bits >> 9) | jnp.uint32(0x3F800000), jnp.float32) - 1.0
    return f.reshape(m, -1)[:n].T


def generate_pixel_rays(cam_arrays, px: jnp.ndarray, py: jnp.ndarray,
                        key: jax.Array | None = None,
                        tmin: float = 0.0, tmax: float = 1e6,
                        jitter=None) -> Rays:
    """Generate jittered primary rays for a batch of pixel coordinates.

    Vectorized analog of generateTileRays (reference Camera.cpp:55-114):
    jitter in [0,1), dir = view + right*(x+jx) + up*(y+jy), normalized; the
    reference uses tmin=0 and tmax=1e6 for primaries (Camera.cpp:56, 85).

    Args:
      cam_arrays: ``Camera.as_arrays()`` output (traceable).
      px, py: ``(R,)`` integer pixel coordinates.
      key: PRNG key for jitter, or None for pixel-center sampling. The
        jitter is keyed by PIXEL (see :func:`id_uniform`), so a pixel
        gets the same ray whichever device or batch position traces it.
    """
    origin, view, right, up = cam_arrays
    if jitter is None and key is not None:
        pix = (py.astype(jnp.uint32) << jnp.uint32(16)) | px.astype(
            jnp.uint32)
        jit = id_uniform(key, pix, 2)
        jitter = (jit[:, 0], jit[:, 1])
    px = px.astype(jnp.float32)
    py = py.astype(jnp.float32)
    if jitter is not None:
        px = px + jitter[0]
        py = py + jitter[1]
    else:
        px = px + 0.5
        py = py + 0.5

    d = (view[None, :]
         + right[None, :] * px[:, None]
         + up[None, :] * py[:, None])
    d = d * jax.lax.rsqrt(jnp.sum(d * d, axis=-1, keepdims=True))

    # Mix a zero derived from the (possibly device-varying) pixel inputs
    # into the broadcast fields so every ray component carries the same
    # shard_map varying-axes tag as the pixel coordinates.
    zero = px * 0.0
    o = origin[None, :] + zero[:, None]
    return Rays(
        o=o, d=d,
        tmin=tmin + zero,
        tmax=tmax + zero,
    )
