"""Multi-chip tile parallelism over a jax.sharding.Mesh.

The reference is a single-node shared-memory system; its data-parallel
axis is the atomic tile counter feeding persistent workers
(TiledRenderer.cpp:55-67, SURVEY.md §2d). Here the *wave axis*
(pixels/rays) shards across devices with ``shard_map``: the scene is
replicated (it is read-only, mirroring the reference's single shared
scene), every device traces and shades its own pixel range, and the
framebuffer stays sharded until readback.

The frame-pooled paths may re-shard live bounce rays once per frame when
per-device live counts diverge (reshard_balance_cols) and route each
lane's radiance home at reassembly (route_rows_home); the ray counters
are psum-reduced.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def make_mesh(devices=None, axis: str = "tiles") -> Mesh:
    devices = list(devices) if devices is not None else list(jax.devices())
    return Mesh(np.asarray(devices), (axis,))


def sharded_wave(mesh: Mesh, wave_fn, n_pixels: int):
    """Wrap a single-chip wave function for tile-parallel execution.

    ``wave_fn(fb_local, base_pixel, key) -> (fb_local, traced)`` must treat
    pixel ids relative to its local framebuffer shard. Returns
    ``run(fb, bases, keys) -> (fb, traced_total)`` where ``fb`` is the full
    (n_pixels, 3) framebuffer, ``bases``/``keys`` hold one entry per chip.
    """
    n_dev = mesh.devices.size
    assert n_pixels % n_dev == 0

    @partial(shard_map, mesh=mesh,
             in_specs=(P("tiles"), P("tiles"), P("tiles")),
             out_specs=(P("tiles"), P()))
    def run(fb_shard, base, key):
        fb_shard, traced = wave_fn(fb_shard, base[0], key[0])
        return fb_shard, jax.lax.psum(traced[None], "tiles")

    return run


def reshard_balance_cols(S, lane, alive, axis: str, D: int,
                         slack: int = 256):
    """Cross-chip pooled-state load balance (SURVEY §2d; the reference's
    work stealing, RayAccelerator.cpp:215-244, 360-363), shared by both
    frame pools: when per-shard live counts diverge (sky shards die early,
    geometry shards keep bouncing), stripe each shard's live-first-sorted
    pool round-robin over the mesh and all_to_all the slices, so every
    shard ends within ~D lanes of the mean live count.

    ``S`` is the caller-packed (N, C) float32 state matrix (must include
    an alive column so liveness rides the exchange); ``lane`` carries the
    GLOBAL lane ids (shard * N + local) so radiance pieces can be routed
    home at reassembly (route_rows_home). Gated on measured imbalance —
    the full-width state move costs a frame-scale row gather, so
    near-balanced frames skip it (the >25% + slack threshold). Returns
    (S, lane, resharded?); `need` is replicated (derived from the
    all_gather), so every shard picks the same branch."""
    N = lane.shape[0]
    assert N % D == 0, f"per-shard pool {N} not divisible by mesh {D}"
    Ns = N // D
    n_live = jnp.sum(alive.astype(jnp.int32))
    counts = jax.lax.all_gather(n_live, axis)
    total = jnp.sum(counts)
    # Rebalance when the worst shard exceeds the mean by >25% (+ slack
    # so tiny pools never pay the exchange).
    need = jnp.max(counts) * D > total + total // 4 + D * slack

    def do(args):
        S, lane = args
        iota = jnp.arange(N, dtype=jnp.int32)
        perm = jax.lax.sort(
            (jnp.where(alive, iota, jnp.int32(0x7FFFFFFF)), iota),
            num_keys=1)[1]
        # Stripe: live-rank k lands at slice (k % D), offset (k // D);
        # position j = s*Ns + t therefore takes sorted rank t*D + s.
        src_rank = (iota % Ns) * D + iota // Ns
        take = jnp.take(perm, src_rank)
        S2 = jnp.take(S, take, axis=0)
        lane2 = jnp.take(lane, take)
        S2 = jax.lax.all_to_all(S2, axis, split_axis=0, concat_axis=0,
                                tiled=True)
        lane2 = jax.lax.all_to_all(lane2, axis, split_axis=0,
                                   concat_axis=0, tiled=True)
        return S2, lane2

    S, lane = jax.lax.cond(need, do, lambda a: a, (S, lane))
    return S, lane, need


def route_rows_home(rows, axis: str, resharded):
    """Inverse of the reshard exchange at reassembly time: ``rows`` is
    (N, C) with the GLOBAL lane id in column 0. After a global-lane sort,
    the rows from home shard i are exactly the (N/D)-row slice i (the
    outbound stripe sent exactly N/D of each sender's lanes to every
    shard), so one tiled all_to_all returns every row to its producer.
    No-op (through the same cond) when the forward exchange didn't fire."""
    def route(rows):
        ops = jax.lax.sort(tuple(rows[:, j] for j in range(rows.shape[1])),
                           num_keys=1)
        return jax.lax.all_to_all(jnp.stack(ops, axis=1), axis,
                                  split_axis=0, concat_axis=0, tiled=True)

    return jax.lax.cond(resharded, route, lambda r: r, rows)


def replicate_scene(mesh: Mesh, tree):
    """Place a compiled scene replicated on every chip of the mesh
    (the multi-chip analog of the per-device CL_MEM_COPY_HOST_PTR scene
    uploads, Scene.cpp:341-346)."""
    sharding = jax.sharding.NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)
