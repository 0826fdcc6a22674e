"""Angular environment probe (Debevec light probe).

Behavioral port of the reference environment map: the direction->(u,v)
angular mapping and bilinear clamp-to-edge filtering of the CPU sampler
(reference Environment.h:27-82) and the GPU miss-path sampler
(Kernels.h:213-222), re-expressed as a batched gather-based bilinear
lookup in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Environment(NamedTuple):
    """Probe image as a device array (analog of racc::Environment,
    Environment.h:16-23; pixels stored inline after the struct,
    Environment.cpp:15,33). Width/height are derived from the pixel
    array's (static) shape so they remain Python ints under jit.

    ``quad`` is a precomputed (H*W, 12) clamped 2x2-neighborhood table
    ([p00 p10 p01 p11] rgb per base texel): the bilinear lookup becomes
    ONE row gather from a small table instead of four gathers or the
    one-hot matmul pair."""

    pixels: jnp.ndarray  # (H, W, 3) float32
    quad: jnp.ndarray | None = None  # (H*W, 12) float32 neighborhoods

    @property
    def width(self) -> int:
        return self.pixels.shape[1]

    @property
    def height(self) -> int:
        return self.pixels.shape[0]


def create_environment(colors, width: int, height: int) -> Environment:
    """Analog of racc::createEnvironment (reference Environment.cpp:13-62).

    ``colors`` is ``(H*W, 4)`` or ``(H, W, 3/4)``; alpha is dropped.
    """
    arr = np.asarray(colors, np.float32)
    if arr.ndim == 2:
        arr = arr.reshape(height, width, -1)
    arr = arr[..., :3]
    assert arr.shape[:2] == (height, width)
    h, w = height, width
    # Clamp-to-edge 2x2 neighborhoods, host-side once per probe.
    xs = np.arange(w)
    ys = np.arange(h)
    x1 = np.minimum(xs + 1, w - 1)
    y1 = np.minimum(ys + 1, h - 1)
    quad = np.concatenate([
        arr[ys[:, None], xs[None, :]],     # p00
        arr[ys[:, None], x1[None, :]],     # p10
        arr[y1[:, None], xs[None, :]],     # p01
        arr[y1[:, None], x1[None, :]],     # p11
    ], axis=-1).reshape(h * w, 12).astype(np.float32)
    return Environment(pixels=jnp.asarray(arr), quad=jnp.asarray(quad))


def _angular_uv(env: Environment, d: jnp.ndarray):
    """Direction -> probe pixel coordinates (fx, fy), the angular mapping of
    Environment.h:33-48 / Kernels.h:215-219."""
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    len2 = dy * dy + dz * dz
    rlen = jnp.where(len2 > 0, 1.0 / jnp.sqrt(len2), jnp.inf)
    r = jnp.arccos(jnp.clip(-dx, -1.0, 1.0)) * (1.0 / (2.0 * np.pi)) * rlen
    r = jnp.where(jnp.isfinite(r) & (rlen <= 1e6), r, 0.0)
    u = 0.5 - r * dz
    v = 0.5 - r * dy
    return u * env.width - 0.5, v * env.height - 0.5


def sample_environment_onehot(env: Environment, d: jnp.ndarray) -> jnp.ndarray:
    """Gather-free probe sampling. Bilinear filtering is separable, so the
    4-tap lookup becomes a bilinear form over small one-hot weight rows:

        rgb_r = wy_r^T  P  wx_r   =>   einsum('rh,hwc,rw->rc')

    i.e. one (R,H)@(H,W*3) matmul at HIGHEST precision and a
    (R,W)-weighted reduce. With the precomputed quad table (the default
    from create_environment) this is instead ONE row gather. Falls back to
    the 4-tap gather path for probes too large for the dense contraction.
    """
    w, h = env.width, env.height
    if env.quad is not None:
        # One small-table row gather (see Environment.quad). Identical
        # arithmetic to sample_environment => bitwise-equal radiance.
        fx, fy = _angular_uv(env, d)
        x0 = jnp.floor(fx)
        y0 = jnp.floor(fy)
        tx = (fx - x0)[:, None]
        ty = (fy - y0)[:, None]
        x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
        y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
        q = jnp.take(env.quad, y0i * w + x0i, axis=0)     # (R, 12)
        top = q[:, 0:3] * (1 - tx) + q[:, 3:6] * tx
        bot = q[:, 6:9] * (1 - tx) + q[:, 9:12] * tx
        return top * (1 - ty) + bot * ty
    if w * h > 512 * 256:
        return sample_environment(env, d)

    R = d.shape[0]
    fx, fy = _angular_uv(env, d)
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    x1i = jnp.clip(x0i + 1, 0, w - 1)
    y1i = jnp.clip(y0i + 1, 0, h - 1)

    cols = jax.lax.broadcasted_iota(jnp.int32, (R, w), 1)
    rows = jax.lax.broadcasted_iota(jnp.int32, (R, h), 1)
    wx = ((cols == x0i[:, None]) * (1 - tx)[:, None]
          + (cols == x1i[:, None]) * tx[:, None])        # (R, W)
    wy = ((rows == y0i[:, None]) * (1 - ty)[:, None]
          + (rows == y1i[:, None]) * ty[:, None])        # (R, H)

    hp = jax.lax.Precision.HIGHEST
    rowmix = jax.lax.dot(wy, env.pixels.reshape(h, w * 3),
                         precision=hp).reshape(R, w, 3)   # (R, W, 3)
    return jnp.einsum("rw,rwc->rc", wx, rowmix, precision=hp)


def sample_environment(env: Environment, d: jnp.ndarray) -> jnp.ndarray:
    """Sample the probe for a batch of directions ``d`` of shape (R, 3).

    Mirrors the angular mapping of Environment.h:33-48 / Kernels.h:215-219:

        r = acos(-d.x) / (2*pi) * rsqrt(d.y^2 + d.z^2)   (0 if not finite)
        u = 0.5 - r * d.z ;  v = 0.5 - r * d.y

    then bilinear with clamp-to-edge at pixel centers (uv*dim - 0.5).
    The r guards mirror Kernels.h:217 (rlen > 1e6 => 0) and
    Environment.h:42-43 (non-finite => 0).
    """
    w, h = env.width, env.height
    fx, fy = _angular_uv(env, d)

    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = fx - x0
    ty = fy - y0

    x0i = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    x1i = jnp.clip(x0i + 1, 0, w - 1)
    y1i = jnp.clip(y0i + 1, 0, h - 1)

    flat = env.pixels.reshape(-1, 3)
    p00 = jnp.take(flat, y0i * w + x0i, axis=0)
    p10 = jnp.take(flat, y0i * w + x1i, axis=0)
    p01 = jnp.take(flat, y1i * w + x0i, axis=0)
    p11 = jnp.take(flat, y1i * w + x1i, axis=0)

    tx = tx[:, None]
    ty = ty[:, None]
    top = p00 * (1 - tx) + p10 * tx
    bot = p01 * (1 - tx) + p11 * tx
    return top * (1 - ty) + bot * ty
