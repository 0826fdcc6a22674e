"""Ray regrouping: restore wavefront coherence between bounces.

The reference's core architectural idea is that rays must be marshalled
into coherent streams before hitting the throughput engine (ray streams +
batch thresholds, RayAccelerator.cpp:48-90; material-sorted shading,
PathTracingRenderer.cpp:16-51). Here the equivalent is a multi-operand
``lax.sort`` of the whole lane state by a spatial coherence key, which
turns scattered bounce rays back into tiles the cluster tracer culls
well.

Key layout (int32): [morton15(origin) | octant3(direction)], with dead
lanes forced to the maximum key so live lanes compact to the front of the
wave (dead tiles then cost nothing in the tracer).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from rayaccel_tpu.types import Rays

DEAD_KEY = jnp.int32(0x7FFFFFFF)


def _spread3(v: jnp.ndarray, bits: int = 5) -> jnp.ndarray:
    """Interleave-ready bit spread: bit i -> bit 3i."""
    out = jnp.zeros_like(v)
    for i in range(bits):
        out = out | (((v >> i) & 1) << (3 * i))
    return out


def coherence_key(rays: Rays, alive: jnp.ndarray,
                  bmin: jnp.ndarray, binv: jnp.ndarray) -> jnp.ndarray:
    """(R,) sort key: 15-bit origin morton + 3-bit direction octant."""
    p = (rays.o - bmin[None, :]) * binv[None, :]
    q = jnp.clip((p * 32.0).astype(jnp.int32), 0, 31)
    morton = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1)
              | (_spread3(q[:, 2]) << 2))
    octant = ((rays.d[:, 0] < 0).astype(jnp.int32) * 4
              + (rays.d[:, 1] < 0).astype(jnp.int32) * 2
              + (rays.d[:, 2] < 0).astype(jnp.int32))
    key = (morton << 3) | octant
    return jnp.where(alive, key, DEAD_KEY)


def regroup_state(key: jnp.ndarray, rays: Rays, columns: list):
    """Sort lane state by ``key``. ``columns`` is a flat list of (R,) or
    (R, k) arrays. Returns (rays, columns) permuted.

    Narrow states ride one fused multi-operand sort. Wide states (Whitted
    carries its parked-ray stacks, ~100 columns) instead sort (key, iota)
    once and apply the permutation with row gathers — a handful of
    wide-row gathers beats a 100-operand sort comparator in compile
    time."""
    ncols = 8 + sum(1 if c.ndim == 1 else c.shape[1] for c in columns)
    if ncols > 24:
        perm = jax.lax.sort(
            (key, jnp.arange(key.shape[0], dtype=jnp.int32)), num_keys=1)[1]

        def take(a):
            return jnp.take(a, perm, axis=0)

        out_rays = Rays(take(rays.o), take(rays.d), take(rays.tmin),
                        take(rays.tmax))
        return out_rays, [take(c) for c in columns]

    ops = [key]
    spec = []  # (n_cols,) per entry to rebuild
    def push(a):
        if a.ndim == 1:
            ops.append(a)
            spec.append(1)
        else:
            for c in range(a.shape[1]):
                ops.append(a[:, c])
            spec.append(a.shape[1])

    push(rays.o)
    push(rays.d)
    push(rays.tmin)
    push(rays.tmax)
    for col in columns:
        push(col)

    res = jax.lax.sort(tuple(ops), num_keys=1)
    it = iter(res[1:])

    def pop(n, like):
        if n == 1:
            out = next(it)
        else:
            out = jnp.stack([next(it) for _ in range(n)], axis=1)
        return out.astype(like.dtype) if out.dtype != like.dtype else out

    o = pop(3, rays.o)
    d = pop(3, rays.d)
    tmin = pop(1, rays.tmin)
    tmax = pop(1, rays.tmax)
    out_cols = [pop(spec[4 + i], columns[i]) for i in range(len(columns))]
    return Rays(o, d, tmin, tmax), out_cols
