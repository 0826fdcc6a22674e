"""Cluster scene compiler for the cluster-dense ("mxu") traversal engine.

Rationale: a traversal that fetches node or triangle data per ray per
step is bound by per-lane gathers; this module restructures the scene so
intersection becomes dense per-tile linear algebra instead:

- The SAH BVH2 is cut into *clusters*: maximal subtrees holding at most
  ``cluster_size`` triangles. Because the builder assigns each subtree a
  contiguous range of ``prim_order``, every cluster's triangles are
  contiguous after permutation — all per-cluster data is accessed with
  dynamic slices, never gathers.

- Moller-Trumbore factors bilinearly: with ray features
  f = [d, o, d x o, 1] (10 values) and per-triangle constant columns, the
  four intersection scalars for every (ray, triangle) pair are

      det   = d . (e2 x e1)
      t_num = o . n            - (v0 . n)
      u_num = (d x o) . (-e2)  + d . (-(e2 x v0))
      v_num = (d x o) . e1     + d . (-(v0 x e1))

  so a whole (rays x cluster) block is ONE (R,16)@(16,4C) float32
  product, with u = u_num/det etc. decoded elementwise.

- Per-triangle shading attributes live in per-cluster rows fetched by one
  row gather of the winner at hit time (no per-vertex gathers).

This plays the role the OpenCL BVH2 + TrianglePair buffers play for the
reference's iGPU (Scene.cpp:216-346) — the scene form consumed by the
throughput engine.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from rayaccel_tpu.scene.bvh import Bvh2, KIND_LEAF, build_bvh
from rayaccel_tpu.scene.data import SceneData

RAY_FEATURES = 16   # 10 used: d(3), o(3), d x o(3), 1; padded to 16
# Per-triangle attribute row. The winner attr gather runs at FULL pool
# width every bounce, so the row is kept narrow: the 15 shading floats +
# material id ride as bf16 pairs in 8 f32 words (2e-3 rel — under
# interpolation/normalization noise), the geometric normal is DERIVED from
# the exact stored edges (same winding and formula as scene/data.py
# compute_face_normals), and [v0, e1, e2] + tri id stay exact f32 (v0 and
# the id were read only by the removed winner-reconstruction kernels).
ATTR_COLS = 18
ATTR_PACK_COLS = 5    # bf16 pairs (hi|lo): [n0x|n0y, n0z|n1x, n1y|n1z,
                      #  n2x|n2y, n2z|mat]
ATTR_TRI_ID_COL = 5   # original triangle id as raw int32 bits (f32 container)
ATTR_GEOM_COL = 6     # [v0, e1, e2] exact geometry in cols 6:15
ATTR_UV_COL = 15      # uv bf16 pairs [uv0u|uv0v, uv1u|uv1v, uv2u|uv2v] ride
                      # LAST: no current material consumes uv, and XLA
                      # narrows a per-hit row gather only to a CONTIGUOUS
                      # used prefix — with uv mid-row the full 18 columns
                      # would be fetched at pool width every bounce;
                      # trailing dead columns narrow for free


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bits (uint32) with round-to-nearest-even."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint32)


def _pack_pairs(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Two f32 columns -> one f32 word holding (bf16(hi) << 16) | bf16(lo)."""
    return ((_bf16_bits(hi) << 16) | _bf16_bits(lo)).view(np.float32)


def unpack_attrs_np(attrs: np.ndarray) -> dict:
    """Decode the bf16-pair shading words of attr rows (numpy; tests and
    debugging — the jitted unpack lives in render/shading.py)."""
    w = np.ascontiguousarray(attrs[:, :ATTR_PACK_COLS],
                             np.float32).view(np.uint32)
    hi = (w & np.uint32(0xFFFF0000)).view(np.float32)
    lo = (w << np.uint32(16)).view(np.float32)
    wu = np.ascontiguousarray(attrs[:, ATTR_UV_COL:ATTR_UV_COL + 3],
                              np.float32).view(np.uint32)
    uhi = (wu & np.uint32(0xFFFF0000)).view(np.float32)
    ulo = (wu << np.uint32(16)).view(np.float32)
    return {
        "n0": np.stack([hi[:, 0], lo[:, 0], hi[:, 1]], -1),
        "n1": np.stack([lo[:, 1], hi[:, 2], lo[:, 2]], -1),
        "n2": np.stack([hi[:, 3], lo[:, 3], hi[:, 4]], -1),
        "mat": lo[:, 4],
        "uv0": np.stack([uhi[:, 0], ulo[:, 0]], -1),
        "uv1": np.stack([uhi[:, 1], ulo[:, 1]], -1),
        "uv2": np.stack([uhi[:, 2], ulo[:, 2]], -1),
    }


class ClusterScene(NamedTuple):
    """Device arrays for the cluster engine. N_c clusters of C padded tris."""

    G: jnp.ndarray            # (RAY_FEATURES, N_c*C*4) f32 intersection features
    attrs: jnp.ndarray        # (N_c*C, ATTR_COLS) f32 shading attributes +
                              # exact [v0,e1,e2] geometry (ATTR_GEOM_COL)
    tri_id: jnp.ndarray       # (N_c*C,) int32 original triangle id (-1 pad)
    cl_bbmin: jnp.ndarray     # (N_c, 3) f32
    cl_bbmax: jnp.ndarray     # (N_c, 3) f32
    mat_params: jnp.ndarray   # (M, 4) f32

    @property
    def cluster_size(self) -> int:
        return self.attrs.shape[0] // self.cl_bbmin.shape[0]

    @property
    def n_clusters(self) -> int:
        return self.cl_bbmin.shape[0]


def _cluster_cut(bvh: Bvh2, max_tris: int):
    """Cut the BVH into maximal subtrees with <= max_tris triangles.
    Returns list of (start, end) prim_order ranges + their bounds."""
    out = []
    stack = [0]
    while stack:
        i = stack.pop()
        if bvh.kind[i] == KIND_LEAF:
            out.append((int(bvh.first[i]), int(bvh.last[i]),
                        bvh.bbmin[i], bvh.bbmax[i]))
            continue
        # Subtree triangle count = width of its contiguous range; compute by
        # descending to leftmost/rightmost leaves via the shared-window
        # property of the builder.
        lo, hi = _subtree_range(bvh, i)
        if hi - lo <= max_tris:
            out.append((lo, hi, bvh.bbmin[i], bvh.bbmax[i]))
        else:
            stack.append(int(bvh.first[i]))
            stack.append(int(bvh.last[i]))
    out.sort(key=lambda r: r[0])
    return out


def _merge_cut(cut, max_tris: int, sa_gain: float = 0.8):
    """Greedily merge ADJACENT cut ranges (they partition prim_order, so
    adjacency = contiguity) when the union still fits a cluster and its
    bounding box is tight: union surface area <= sa_gain * (sa_a + sa_b).
    The BVH cut descends whenever a subtree exceeds max_tris, which
    strands sibling fragments in half-empty clusters; merging them cuts
    the cluster count the select/cull stages scan per ray without
    increasing expected per-ray overlap (SA ~ hit probability)."""
    def sa(bmin, bmax):
        e = np.maximum(np.asarray(bmax) - np.asarray(bmin), 0.0)
        return 2.0 * (e[0] * e[1] + e[1] * e[2] + e[2] * e[0])

    out = [list(cut[0])]
    for lo, hi, bmin, bmax in cut[1:]:
        plo, phi, pbmin, pbmax = out[-1]
        if hi - plo <= max_tris:
            ubmin = np.minimum(pbmin, bmin)
            ubmax = np.maximum(pbmax, bmax)
            if sa(ubmin, ubmax) <= sa_gain * (sa(pbmin, pbmax)
                                              + sa(bmin, bmax)):
                out[-1] = [plo, hi, ubmin, ubmax]
                continue
        out.append([lo, hi, bmin, bmax])
    return [tuple(x) for x in out]


def _subtree_range(bvh: Bvh2, i: int):
    j = i
    while bvh.kind[j] != KIND_LEAF:
        j = int(bvh.first[j])
    lo = int(bvh.first[j])
    j = i
    while bvh.kind[j] != KIND_LEAF:
        j = int(bvh.last[j])
    hi = int(bvh.last[j])
    return lo, hi


def _tri_feature_columns(v0, e1, e2):
    """Feature columns (16, 4) per triangle for the bilinear MT form."""
    n = np.cross(e1, e2)
    cols = np.zeros((len(v0), RAY_FEATURES, 4), np.float64)
    # det = d . (e2 x e1)
    cols[:, 0:3, 0] = np.cross(e2, e1)
    # u_num = (d x o) . (-e2) + d . (-(e2 x v0))
    cols[:, 6:9, 1] = -e2
    cols[:, 0:3, 1] = -np.cross(e2, v0)
    # v_num = (d x o) . e1 + d . (-(v0 x e1))
    cols[:, 6:9, 2] = e1
    cols[:, 0:3, 2] = -np.cross(v0, e1)
    # t_num = o . n - v0 . n
    cols[:, 3:6, 3] = n
    cols[:, 9, 3] = -np.sum(v0 * n, axis=-1)
    return cols.astype(np.float32)


def compile_clusters(scene: SceneData, cluster_size: int = 128,
                     bvh: Bvh2 | None = None) -> ClusterScene:
    """Compile a SceneData into the cluster-dense device form."""
    verts = np.asarray(scene.vertices, np.float64)
    idx = np.asarray(scene.indices, np.int64)
    if bvh is None:
        bvh = build_bvh(scene.vertices, idx, max_leaf=min(cluster_size, 127))

    cut = _merge_cut(_cluster_cut(bvh, cluster_size), cluster_size)
    n_c = len(cut)
    C = cluster_size
    TP = n_c * C

    tri_id = np.full(TP, -1, np.int64)
    cl_bbmin = np.zeros((n_c, 3), np.float32)
    cl_bbmax = np.zeros((n_c, 3), np.float32)
    for c, (lo, hi, bmin, bmax) in enumerate(cut):
        ids = bvh.prim_order[lo:hi]
        tri_id[c * C:c * C + len(ids)] = ids
        cl_bbmin[c] = bmin
        cl_bbmax[c] = bmax

    # Geometry features (zero columns for padding => det = 0 => never hit).
    G = np.zeros((TP, RAY_FEATURES, 4), np.float32)
    real = tri_id >= 0
    rid = tri_id[real]
    v0 = verts[idx[rid, 0]]
    v1 = verts[idx[rid, 1]]
    v2 = verts[idx[rid, 2]]
    G[real] = _tri_feature_columns(v0, v1 - v0, v2 - v0)
    # Column layout per cluster: [det(C) | u_num(C) | v_num(C) | t_num(C)]
    # so the tracer can slice each scalar kind contiguously from S = F @ G.
    G = (G.reshape(n_c, C, RAY_FEATURES, 4)
          .transpose(2, 0, 3, 1)            # (16, n_c, 4, C)
          .reshape(RAY_FEATURES, TP * 4)
          .copy())

    # Shading attributes per padded triangle row (bf16-pair layout, see
    # the ATTR_PACK_COLS comment at the top; ng is derived from e1 x e2
    # at shading time — scene.triangle_normals is used only by the xla
    # backend's scene-indexed shading path).
    A = np.zeros((TP, ATTR_COLS), np.float32)
    vn = np.asarray(scene.normals, np.float32)
    vt = np.asarray(scene.texcoords, np.float32)
    n0, n1, n2 = vn[idx[rid, 0]], vn[idx[rid, 1]], vn[idx[rid, 2]]
    uv0, uv1, uv2 = vt[idx[rid, 0]], vt[idx[rid, 1]], vt[idx[rid, 2]]
    mat = np.asarray(scene.triangle_materials, np.float32)[rid]
    # The material id rides a bf16 half-word (A[:, 4] below): bf16 has an
    # 8-bit mantissa, so integers are exact only up to 256 — beyond that
    # shading would silently pick wrong materials.
    if mat.size and mat.max() > 256:
        raise ValueError(
            f"material id {int(mat.max())} exceeds the bf16-exact packing "
            "range (256); widen ATTR packing before using more materials")
    A[real, 0] = _pack_pairs(n0[:, 0], n0[:, 1])
    A[real, 1] = _pack_pairs(n0[:, 2], n1[:, 0])
    A[real, 2] = _pack_pairs(n1[:, 1], n1[:, 2])
    A[real, 3] = _pack_pairs(n2[:, 0], n2[:, 1])
    A[real, 4] = _pack_pairs(n2[:, 2], mat)
    A[real, ATTR_UV_COL + 0] = _pack_pairs(uv0[:, 0], uv0[:, 1])
    A[real, ATTR_UV_COL + 1] = _pack_pairs(uv1[:, 0], uv1[:, 1])
    A[real, ATTR_UV_COL + 2] = _pack_pairs(uv2[:, 0], uv2[:, 1])
    # Original triangle id as raw bits (-1 bit pattern for padding slots).
    # No engine reads it today: trace_mxu takes ids from ``tri_id``.
    A[:, ATTR_TRI_ID_COL] = tri_id.astype(np.int32).view(np.float32)
    # Exact [v0, e1, e2] (padding rows stay zero). Shading derives the
    # geometric normal from e1 x e2; v0 is not read today.
    A[real, ATTR_GEOM_COL + 0:ATTR_GEOM_COL + 3] = v0
    A[real, ATTR_GEOM_COL + 3:ATTR_GEOM_COL + 6] = v1 - v0
    A[real, ATTR_GEOM_COL + 6:ATTR_GEOM_COL + 9] = v2 - v0

    return ClusterScene(
        G=jnp.asarray(G),
        attrs=jnp.asarray(A),
        tri_id=jnp.asarray(tri_id, jnp.int32),
        cl_bbmin=jnp.asarray(cl_bbmin),
        cl_bbmax=jnp.asarray(cl_bbmax),
        mat_params=jnp.asarray(scene.materials, jnp.float32),
    )
