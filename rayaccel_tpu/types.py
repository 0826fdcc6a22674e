"""Core SoA data types for ray streams.

The reference keeps rays and results as 32-byte / 16-byte AoS records
(reference RayAccelerator.h:59-76) and transposes to SoA at every SIMD
kernel boundary (Renderer.h transpose macros). Here everything stays
SoA end-to-end: a ray stream is a NamedTuple of flat ``(R,)``/``(R,3)``
arrays, which XLA lays out as contiguous vector-friendly buffers and which
are pytrees (jit/scan/shard_map transparent).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

# Analog of racc::invalidTriangle (reference RayAccelerator.h:26).
INVALID_TRIANGLE = -1


class Rays(NamedTuple):
    """A ray stream in SoA layout (analog of racc::Ray[], RayAccelerator.h:59-64)."""

    o: jnp.ndarray      # (R, 3) float32 origin
    d: jnp.ndarray      # (R, 3) float32 direction
    tmin: jnp.ndarray   # (R,)  float32
    tmax: jnp.ndarray   # (R,)  float32

    @property
    def count(self) -> int:
        return self.o.shape[0]


class Hits(NamedTuple):
    """Intersection results in SoA layout (analog of racc::Result,
    RayAccelerator.h:66-76).

    The reference's hit/miss union is kept: ``tri == INVALID_TRIANGLE``
    means miss and ``miss_rgb`` carries the environment radiance, folded in
    at trace time by the producer (Scene.cpp:430-440, Kernels.h:213-222) so
    shading never needs to touch the environment map.

    ``u``/``v`` are barycentric coordinates in the Embree convention:
    P = (1-u-v)*v0 + u*v1 + v*v2 over the ORIGINAL triangle vertex order
    (the BVH backend un-rotates pair-local barycentrics before
    returning, mirroring Kernels.h:224-238).
    """

    tri: jnp.ndarray       # (R,) int32; INVALID_TRIANGLE on miss
    t: jnp.ndarray         # (R,) float32 hit distance
    u: jnp.ndarray         # (R,) float32
    v: jnp.ndarray         # (R,) float32
    miss_rgb: jnp.ndarray  # (R, 3) float32 environment radiance where miss


class Stats(NamedTuple):
    """Render statistics (analog of racc::Stats, RayAccelerator.h:85-87).

    ``rays_traced`` counts every ray dispatched to an intersection test,
    following the reference counting rule (RayAccelerator.cpp:200, 372).
    """

    rays_traced: jnp.ndarray  # () int32 counter (float32 mode)


def make_rays(o, d, tmin=1e-3, tmax=1e6) -> Rays:
    """Build a ray stream, broadcasting scalar tmin/tmax."""
    o = jnp.asarray(o, jnp.float32)
    d = jnp.asarray(d, jnp.float32)
    n = o.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (n,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (n,))
    return Rays(o, d, tmin, tmax)
