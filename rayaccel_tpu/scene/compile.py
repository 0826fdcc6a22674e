"""Scene compiler: host geometry -> device-resident traversal structures.

Role of racc::createScene (reference Scene.cpp:183-357): build the BVH,
pair leaf triangles, translate to the 2-wide node format, and upload.

Device layout (redesign of the OpenCL buffers at Scene.cpp:341-346):

``nodes`` — (N, 16) float32, one 64-byte row per *interior* node so a
traversal step costs exactly one gather:
    [0:3]  child0 bbmin     [3:6]  child0 bbmax
    [6:9]  child1 bbmin     [9:12] child1 bbmax
    [12]   child0 ref (int32 bit pattern)
    [13]   child1 ref (int32 bit pattern)
    [14:16] zero padding
A ref >= 0 is an interior node index; a ref < 0 encodes a leaf:
``enc = first_pair | (pair_count << 24); ref = -enc - 1`` (the reference
packs the same way with a high flag bit, Scene.cpp:294-310).

``pairs`` — (P, 16) float32: [e1, e2, e3, p0, pad*4] (Scene.cpp:83-87,
padded from 48 to 64 bytes for aligned gathers).

``pair_tri`` — (2P,) int32: original triangle | rotation_code << 30
(Scene.cpp:263-271).

Shading attributes are separate arrays gathered per hit; the oracle
triangle soup ``tri_verts`` backs the brute-force reference intersector.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from rayaccel_tpu.scene.bvh import Bvh2, KIND_LEAF, build_bvh, triangle_bounds
from rayaccel_tpu.scene.data import SceneData
from rayaccel_tpu.scene.pairs import PairedScene, build_pairs

LEAF_COUNT_SHIFT = 24
LEAF_FIRST_MASK = (1 << 24) - 1


def encode_leaf(first: int, count: int) -> int:
    # first+count must fit the mask so the traversal cursor (first+1 each
    # step) never carries into the count bits (ops/trace.py leaf step).
    assert (0 <= first and 0 <= count < 256
            and first + count <= LEAF_FIRST_MASK)
    return -(first | (count << LEAF_COUNT_SHIFT)) - 1


class TpuScene(NamedTuple):
    """Device-resident compiled scene (all fields are jnp arrays, so the
    whole scene is a pytree and can be closed over or donated to jit)."""

    nodes: jnp.ndarray        # (N, 16) float32
    pairs: jnp.ndarray        # (P, 16) float32
    pair_tri: jnp.ndarray     # (2P,) int32
    tri_index: jnp.ndarray    # (T, 3) int32
    tri_normal: jnp.ndarray   # (T, 3) float32
    tri_mat: jnp.ndarray      # (T,) int32
    vert_normal: jnp.ndarray  # (V, 3) float32
    vert_uv: jnp.ndarray      # (V, 2) float32
    mat_params: jnp.ndarray   # (M, 4) float32
    tri_verts: jnp.ndarray    # (T, 3, 3) float32 oracle triangle soup

    @property
    def triangle_count(self) -> int:
        return self.tri_index.shape[0]

    @property
    def node_count(self) -> int:
        return self.nodes.shape[0]

    @property
    def pair_count(self) -> int:
        return self.pairs.shape[0]


def _collapse_nodes(bvh: Bvh2, paired: PairedScene) -> np.ndarray:
    """Translate the BVH2 into 2-wide interior rows (Scene.cpp:274-339)."""
    n_nodes = bvh.node_count
    interior = np.flatnonzero(bvh.kind != KIND_LEAF)

    if len(interior) == 0:
        # Single-leaf scene: synthesize one interior whose second child is
        # an empty leaf.
        row = np.zeros(16, np.float32)
        row[0:3] = bvh.bbmin[0]
        row[3:6] = bvh.bbmax[0]
        row[6:9] = np.float32(np.inf)
        row[9:12] = np.float32(-np.inf)
        refs = np.array([
            encode_leaf(int(paired.leaf_first[0]),
                        int(paired.leaf_last[0] - paired.leaf_first[0])),
            encode_leaf(0, 0),
        ], np.int32)
        row[12:14] = refs.view(np.float32)
        return row[None, :]

    remap = np.full(n_nodes, -1, np.int64)
    remap[interior] = np.arange(len(interior))

    def child_ref(c: int) -> np.int32:
        if bvh.kind[c] == KIND_LEAF:
            first = int(paired.leaf_first[c])
            count = int(paired.leaf_last[c] - paired.leaf_first[c])
            return np.int32(encode_leaf(first, count))
        return np.int32(remap[c])

    rows = np.zeros((len(interior), 16), np.float32)
    refs = np.zeros((len(interior), 2), np.int32)
    for out_i, i in enumerate(interior):
        l, r = int(bvh.first[i]), int(bvh.last[i])
        rows[out_i, 0:3] = bvh.bbmin[l]
        rows[out_i, 3:6] = bvh.bbmax[l]
        rows[out_i, 6:9] = bvh.bbmin[r]
        rows[out_i, 9:12] = bvh.bbmax[r]
        refs[out_i, 0] = child_ref(l)
        refs[out_i, 1] = child_ref(r)
    rows[:, 12:14] = refs.view(np.float32)
    return rows


def compile_scene(scene: SceneData, max_leaf: int = 64) -> TpuScene:
    """Compile and upload a scene. One-time host->device transfer,
    mirroring the once-per-scene CL_MEM_COPY_HOST_PTR uploads
    (Scene.cpp:341-346)."""
    verts = np.asarray(scene.vertices, np.float32)
    idx = np.asarray(scene.indices, np.int64)

    bvh = build_bvh(verts, idx, max_leaf=max_leaf)
    paired = build_pairs(bvh, verts, idx)
    nodes = _collapse_nodes(bvh, paired)

    pairs16 = np.zeros((max(paired.pairs.shape[0], 1), 16), np.float32)
    pairs16[:paired.pairs.shape[0], :12] = paired.pairs

    pair_tri = paired.pair_tri.view(np.int32)
    if pair_tri.size == 0:
        pair_tri = np.zeros(2, np.int32)

    tri_verts = verts[idx]  # (T, 3, 3)

    return TpuScene(
        nodes=jnp.asarray(nodes),
        pairs=jnp.asarray(pairs16),
        pair_tri=jnp.asarray(pair_tri),
        tri_index=jnp.asarray(idx, jnp.int32),
        tri_normal=jnp.asarray(scene.triangle_normals, jnp.float32),
        tri_mat=jnp.asarray(scene.triangle_materials, jnp.int32),
        vert_normal=jnp.asarray(scene.normals, jnp.float32),
        vert_uv=jnp.asarray(scene.texcoords, jnp.float32),
        mat_params=jnp.asarray(scene.materials, jnp.float32),
        tri_verts=jnp.asarray(tri_verts),
    )


def create_scene(context, vertices, indices, **kwargs) -> TpuScene:
    """racc::createScene-shaped entry point (RayAccelerator.h:107).

    ``vertices``: (V, 3/4) float32; ``indices``: flat (3T,) or (T, 3).
    Shading attributes default to face/vertex normals derived from the
    geometry; use :func:`compile_scene` with a full SceneData for control.
    """
    from rayaccel_tpu.scene.data import (compute_face_normals,
                                         compute_vertex_normals)
    from rayaccel_tpu.scene.loader import DEFAULT_MATERIALS

    del context  # the compiled scene is context-independent
    verts = np.asarray(vertices, np.float32)[:, :3]
    idx = np.asarray(indices, np.uint32).reshape(-1, 3)
    scene = SceneData(
        vertices=verts, indices=idx,
        triangle_materials=np.zeros(len(idx), np.uint16),
        triangle_normals=compute_face_normals(verts, idx),
        normals=compute_vertex_normals(verts, idx),
        texcoords=np.zeros((len(verts), 2), np.float32),
        materials=DEFAULT_MATERIALS.copy(),
    )
    return compile_scene(scene, **kwargs)
