"""Materials: vectorized BSDF sampling with a parameter table.

The reference exposes an 8-wide virtual BSDF interface
(``Material::sample8``, reference Materials.h:15-20) with one
implementation, ``ReflectiveDiffuseMaterial`` (Materials.cpp:32-151): a
Fresnel-weighted mirror lobe plus a cosine-hemisphere diffuse lobe, the
lobe chosen by a luminance-weighted random pick.

Wavefront redesign: function pointers and per-run virtual dispatch do not
exist under XLA. Because the BSDF family is *parametric* (albedo ``k`` and
``eta``), the whole material system becomes one vectorized function over
per-ray parameters gathered from a ``(M, 4)`` table. This subsumes the
reference's material-sorted shading (PathTracingRenderer.cpp:121-124):
sorting by material id is unnecessary when dispatch is branchless. Multiple
BSDF *families* would become a ``lax.switch`` over sorted segments; the
table design keeps that door open via the ``kind`` column.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class MaterialTable(NamedTuple):
    """Parameter table: one row per material instance.

    ``params[:, 0:3]`` = albedo k (rgb), ``params[:, 3]`` = eta
    (analog of ReflectiveDiffuseMaterial::ke, Materials.cpp:32-37).
    """

    params: jnp.ndarray  # (M, 4) float32


def reflective_diffuse(k, eta: float) -> np.ndarray:
    """One table row, analog of ReflectiveDiffuseMaterial(k, eta)."""
    k = np.broadcast_to(np.asarray(k, np.float32), (3,))
    return np.array([k[0], k[1], k[2], eta], np.float32)


def make_material_table(rows) -> MaterialTable:
    return MaterialTable(params=jnp.asarray(np.stack(rows), jnp.float32))


def default_materials() -> MaterialTable:
    """The four demo materials (reference main.cpp:163-168)."""
    return make_material_table([
        reflective_diffuse(0.8, 1.0 / 1.4),
        reflective_diffuse(0.1, 1.0 / 1.4),
        reflective_diffuse(0.6, 1.0 / 1.2),
        reflective_diffuse(0.3, 1.0 / 1.2),
    ])


def _orthonormal_basis(n: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Tangent frame construction mirroring Materials.cpp:82-98:
    pick base_u from whichever of x / z dominates, then v = cross-ish.
    """
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    base_mask = jnp.abs(nx) > 0.1
    ux = jnp.where(base_mask, -nz, 0.0)
    uy = jnp.where(base_mask, 0.0, -nz)
    uz = jnp.where(base_mask, nx, ny)
    inv = jax.lax.rsqrt(ux * ux + uy * uy + uz * uz)
    ux, uy, uz = ux * inv, uy * inv, uz * inv
    vx = ny * uz - nz * uy
    vy = nz * ux - nx * uz
    vz = nx * uy - ny * ux
    u = jnp.stack([ux, uy, uz], axis=-1)
    v = jnp.stack([vx, vy, vz], axis=-1)
    return u, v


def sample_reflective_diffuse(params: jnp.ndarray,
                              rnd: jnp.ndarray,
                              normal: jnp.ndarray,
                              wo: jnp.ndarray):
    """Vectorized ReflectiveDiffuseMaterial::sample8 (Materials.cpp:39-151).

    Args:
      params: (R, 4) gathered per-ray [kr, kg, kb, eta].
      rnd:    (R, 3) uniforms in [0, 1).
      normal: (R, 3) shading normal, already flipped toward the incoming ray.
      wo:     (R, 3) outgoing (toward viewer) direction = -ray_dir.

    Returns:
      (wi, color, transmitted): sampled direction (R,3) — NOT normalized for
      the mirror lobe, matching the reference which reflects the unnormalized
      construction; per-ray weight color (R,3); transmitted mask (R,) bool
      (always False for this BSDF, Materials.cpp:54).

    The only deliberate divergence from the reference: exact
    sin/cos(2*pi*r) replaces the 2-piece parabola approximation
    (Materials.cpp:11-28); the approximation buys nothing in vectorized
    code.
    """
    k = params[:, 0:3]
    eta = params[:, 3]

    # Mirror lobe + Fresnel (Materials.cpp:56-79).
    cosi = jnp.maximum(jnp.sum(normal * wo, axis=-1), 0.0)
    refl = 2.0 * cosi[:, None] * normal - wo

    one = jnp.float32(1.0)
    kk = eta * eta * (cosi * cosi - one) + one          # < 0 => TIR
    cost = jnp.sqrt(jnp.maximum(kk, 0.0))
    rper = (eta * cosi - cost) / (eta * cosi + cost)
    rpar = -((eta * cost - cosi) / (eta * cost + cosi))
    fresnel = 0.5 * (rpar * rpar + rper * rper)
    fresnel = jnp.where(kk < 0.0, one, fresnel)          # TIR (Materials.cpp:79)

    # Cosine-hemisphere diffuse lobe (Materials.cpp:82-116).
    u, v = _orthonormal_basis(normal)
    phi = 2.0 * jnp.pi * rnd[:, 0]
    sin_x = jnp.sin(phi)
    cos_x = jnp.cos(phi)
    r2 = rnd[:, 1]
    r2s = jnp.sqrt(r2)
    diff = (normal * jnp.sqrt(1.0 - r2)[:, None]
            + (u * cos_x[:, None] + v * sin_x[:, None]) * r2s[:, None])
    diff = diff * jax.lax.rsqrt(jnp.sum(diff * diff, axis=-1, keepdims=True))

    # Lobe selection by relative weight (Materials.cpp:122-142).
    s0 = fresnel * 3.0
    s1 = jnp.sum(k, axis=-1)
    total = s0 + s1
    pick_diffuse = rnd[:, 2] * total >= s0

    wi = jnp.where(pick_diffuse[:, None], diff, refl)
    color = jnp.where(pick_diffuse[:, None], k, fresnel[:, None])
    scale = total / jnp.sum(color, axis=-1)
    color = color * scale[:, None]

    transmitted = jnp.zeros(params.shape[0], bool)
    return wi, color, transmitted
