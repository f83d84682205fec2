"""The port's own copy of ryujin_tpu/offline/mesh.py (plain numpy; the port imports
nothing of ryujin_tpu).  The original header follows.

Host-side quadrilateral/hexahedral mesh representation.

TPU-native re-design of the mesh layer of conservation-laws/ryujin.  The
reference delegates meshing to deal.II triangulations (see
source/discretization.h:131-173 and geometry_*.h); here we
keep a minimal, fully vectorized NumPy mesh container that supports

  * 1D line meshes, 2D quadrilateral meshes, 3D hexahedral meshes,
  * uniform ("global") refinement,
  * boundary faces tagged with ryujin Boundary ids,
  * optional manifold attachment (used e.g. for rounding the forward-facing
    step corner, cf. source/geometry_step.h:88-130).

Vertex ordering follows the deal.II convention for hypercubes: the d-th
coordinate toggles with stride 2**d, i.e. in 2D

    v2 --- v3
    |       |
    v0 --- v1

All offline data (mass matrices, c_ij, boundary maps) is assembled from this
container in assembly.py; nothing here ever runs on the TPU.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, Optional, Tuple

import numpy as np


class Boundary(enum.IntEnum):
    """Boundary condition ids (mirrors source/discretization.h:48-126)."""

    do_nothing = 0
    periodic = 1
    slip = 2
    no_slip = 3
    dirichlet = 4
    dynamic = 5
    dirichlet_momentum = 6


# Face -> (local vertex indices) for the deal.II hypercube numbering.
# Faces are ordered: (-x, +x, -y, +y, -z, +z), matching deal.II.
_FACE_VERTICES = {
    1: [np.array([0]), np.array([1])],
    2: [
        np.array([0, 2]),  # -x
        np.array([1, 3]),  # +x
        np.array([0, 1]),  # -y
        np.array([2, 3]),  # +y
    ],
    3: [
        np.array([0, 2, 4, 6]),  # -x
        np.array([1, 3, 5, 7]),  # +x
        np.array([0, 1, 4, 5]),  # -y
        np.array([2, 3, 6, 7]),  # +y
        np.array([0, 1, 2, 3]),  # -z
        np.array([4, 5, 6, 7]),  # +z
    ],
}


@dataclasses.dataclass
class Mesh:
    """An unstructured conforming quad/hex mesh.

    Attributes:
      dim: spatial dimension (1, 2, or 3).
      vertices: [n_vertices, dim] float64 coordinates.
      cells: [n_cells, 2**dim] int64 vertex indices (deal.II ordering).
      boundary_faces: [n_faces, 2**(dim-1)] int64 vertex indices of faces on
        the domain boundary.
      boundary_ids: [n_faces] int32 Boundary ids.
      face_manifold_ids: optional [n_faces] int32; faces with id != 0 are
        projected through `manifolds[id]` during refinement.
      manifolds: map manifold id -> averaging callable taking the face
        endpoint coordinates [k, n_face_vertices, dim] and returning the new
        midpoint [k, dim] (the analog of dealii::Manifold::get_new_point).
      periodic_pairs: optional [n_pairs, 2] int64 vertex identification list
        (slave, master) used for periodic boundary conditions.
      structured_shape: if the mesh is a subset of a tensor lattice, the
        lattice dims (nx+1, ny+1[, nz+1]) and `structured_index` maps each
        vertex to its lattice multi-index; used by the structured solver
        backend to turn gathers into shifts.
    """

    dim: int
    vertices: np.ndarray
    cells: np.ndarray
    boundary_faces: np.ndarray
    boundary_ids: np.ndarray
    face_manifold_ids: Optional[np.ndarray] = None
    manifolds: Optional[Dict[int, Callable[[np.ndarray], np.ndarray]]] = None
    # Interior manifold regions (the analog of dealii set_all_manifold_ids on
    # cells, cf. source/geometry_annulus.h:52-95): manifold id
    # -> predicate taking edge endpoint coordinates [k, nv, dim] and returning
    # a [k] bool mask; matching edges get their refinement midpoint projected
    # through manifolds[id] even when they are not boundary faces.
    edge_manifold_selectors: Optional[
        Dict[int, Callable[[np.ndarray], np.ndarray]]
    ] = None
    periodic_pairs: Optional[np.ndarray] = None
    structured_shape: Optional[Tuple[int, ...]] = None
    structured_index: Optional[np.ndarray] = None
    # Adaptive refinement state (offline/mesh_adaptor.py): hanging-node
    # constraints [k, 3] int64 rows (hanging, parent_a, parent_b) meaning
    # u_h = (u_a + u_b)/2, and per-cell refinement levels used for 2:1
    # balance during local refinement.
    hanging: Optional[np.ndarray] = None
    cell_levels: Optional[np.ndarray] = None
    # Refinement-tree state for coarsening (the analog of the p4est tree
    # the reference's MeshAdaptor coarsens through, mesh_adaptor.h:133-149):
    # [nc, 2] int64 — column 0 is the cell-midpoint vertex id identifying
    # the refine_local split this cell is a child of (-1 for cells not
    # created by local refinement), column 1 the refined parent's own
    # origin (one extra level of re-coarsening).  Vertex renumbering on
    # coarsening remaps both columns.
    cell_origin: Optional[np.ndarray] = None
    # Extrusion provenance (geometry.extrude): the 2D base mesh, the
    # number of cell layers, and whether z is periodic.  Vertex (l, v2)
    # has id l * base.n_vertices + v2; cells layer-major.  Lets the
    # multi-block packer build a (z, canvas-y, canvas-x) fast path for
    # extrusions whose base is a quilt rather than a single lattice
    # (the reference's 3D airfoil, geometry_airfoil.h:1279-1290).
    extrusion_base: Optional["Mesh"] = None
    extrusion_layers: Optional[int] = None
    extrusion_periodic_z: bool = False

    @property
    def n_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    def refine_global(self, times: int = 1) -> "Mesh":
        mesh = self
        for _ in range(times):
            mesh = _refine_once(mesh)
        return mesh


def _unique_rows(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Deduplicate integer rows; returns (unique_rows, inverse)."""
    sorted_rows = np.sort(rows, axis=1)
    _, idx, inverse = np.unique(
        sorted_rows, axis=0, return_index=True, return_inverse=True
    )
    return rows[idx], inverse


def _refine_once(mesh: Mesh) -> Mesh:
    """Uniformly refine: each cell splits into 2**dim children.

    New vertices are created at edge/face/cell midpoints.  Midpoints of
    boundary faces carrying a manifold id are projected through the attached
    manifold (this reproduces e.g. deal.II's SphericalManifold behavior used
    for the rounded step corner).
    """
    dim = mesh.dim
    nv = mesh.n_vertices
    cells = mesh.cells
    verts = mesh.vertices

    if dim == 1:
        mid = 0.5 * (verts[cells[:, 0]] + verts[cells[:, 1]])
        mid_idx = nv + np.arange(mesh.n_cells)
        new_verts = np.concatenate([verts, mid], axis=0)
        c0 = np.stack([cells[:, 0], mid_idx], axis=1)
        c1 = np.stack([mid_idx, cells[:, 1]], axis=1)
        new_cells = np.concatenate([c0, c1], axis=0)
        new_shape, new_sidx = None, None
        if mesh.structured_index is not None:
            si = mesh.structured_index
            mid_si = si[cells[:, 0]] + si[cells[:, 1]]
            new_sidx = np.concatenate([2 * si, mid_si], axis=0)
            new_shape = tuple(2 * s - 1 for s in mesh.structured_shape)
        # boundary faces in 1D are single vertices, unchanged:
        return dataclasses.replace(
            mesh, vertices=new_verts, cells=new_cells,
            structured_shape=new_shape, structured_index=new_sidx,
        )

    if dim == 2:
        # Edges of each quad (deal.II ordering): bottom(0,1) top(2,3)
        # left(0,2) right(1,3)
        edge_local = np.array([[0, 1], [2, 3], [0, 2], [1, 3]])
        cell_edges = cells[:, edge_local]  # [nc, 4, 2]
        flat_edges = cell_edges.reshape(-1, 2)
        uniq_edges, edge_inverse = _unique_rows(flat_edges)
        n_edges = uniq_edges.shape[0]
        edge_mid = 0.5 * (verts[uniq_edges[:, 0]] + verts[uniq_edges[:, 1]])

        # Interior manifold regions first (boundary projection below is more
        # specific and may overwrite):
        if mesh.edge_manifold_selectors and mesh.manifolds:
            for mid_id, selector in mesh.edge_manifold_selectors.items():
                sel = np.asarray(selector(verts[uniq_edges]), bool)
                if np.any(sel):
                    edge_mid[sel] = mesh.manifolds[mid_id](
                        verts[uniq_edges[sel]]
                    )

        # Manifold projection for boundary-face midpoints:
        if mesh.face_manifold_ids is not None and mesh.manifolds:
            # Map vertex-pair -> edge id via dictionary on sorted pairs.
            sorted_uniq = np.sort(uniq_edges, axis=1)
            edge_key = sorted_uniq[:, 0].astype(np.int64) * (4 * nv) + sorted_uniq[:, 1]
            order = np.argsort(edge_key)
            sorted_keys = edge_key[order]
            bf = np.sort(mesh.boundary_faces, axis=1)
            bf_key = bf[:, 0].astype(np.int64) * (4 * nv) + bf[:, 1]
            pos = order[np.searchsorted(sorted_keys, bf_key)]
            for mid_id, proj in mesh.manifolds.items():
                sel = mesh.face_manifold_ids == mid_id
                if np.any(sel):
                    eids = pos[sel]
                    edge_mid[eids] = proj(verts[uniq_edges[eids]])

        cell_mid = 0.25 * (
            verts[cells[:, 0]] + verts[cells[:, 1]]
            + verts[cells[:, 2]] + verts[cells[:, 3]]
        )

        new_verts = np.concatenate([verts, edge_mid, cell_mid], axis=0)
        e = nv + edge_inverse.reshape(-1, 4)  # per-cell edge-mid ids
        c = nv + n_edges + np.arange(mesh.n_cells)
        v0, v1, v2, v3 = cells[:, 0], cells[:, 1], cells[:, 2], cells[:, 3]
        eb, et, el, er = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
        children = [
            np.stack([v0, eb, el, c], axis=1),
            np.stack([eb, v1, c, er], axis=1),
            np.stack([el, c, v2, et], axis=1),
            np.stack([c, er, et, v3], axis=1),
        ]
        new_cells = np.concatenate(children, axis=0)

        # Refine boundary faces (each edge splits into two):
        bf = mesh.boundary_faces
        bf_sorted = np.sort(bf, axis=1)
        bf_key = bf_sorted[:, 0].astype(np.int64) * (4 * nv) + bf_sorted[:, 1]
        sorted_uniq = np.sort(uniq_edges, axis=1)
        edge_key = sorted_uniq[:, 0].astype(np.int64) * (4 * nv) + sorted_uniq[:, 1]
        order = np.argsort(edge_key)
        pos = order[np.searchsorted(edge_key[order], bf_key)]
        mid_ids = nv + pos
        f0 = np.stack([bf[:, 0], mid_ids], axis=1)
        f1 = np.stack([mid_ids, bf[:, 1]], axis=1)
        new_faces = np.concatenate([f0, f1], axis=0)
        new_ids = np.concatenate([mesh.boundary_ids, mesh.boundary_ids])
        new_mids = None
        if mesh.face_manifold_ids is not None:
            new_mids = np.concatenate(
                [mesh.face_manifold_ids, mesh.face_manifold_ids]
            )
        new_shape, new_sidx = None, None
        if mesh.structured_index is not None:
            si = mesh.structured_index
            edge_si = si[uniq_edges[:, 0]] + si[uniq_edges[:, 1]]
            cell_si = (si[cells[:, 0]] + si[cells[:, 1]]
                       + si[cells[:, 2]] + si[cells[:, 3]]) // 2
            new_sidx = np.concatenate([2 * si, edge_si, cell_si], axis=0)
            new_shape = tuple(2 * s - 1 for s in mesh.structured_shape)
        return dataclasses.replace(
            mesh,
            vertices=new_verts,
            cells=new_cells,
            boundary_faces=new_faces,
            boundary_ids=new_ids,
            face_manifold_ids=new_mids,
            structured_shape=new_shape,
            structured_index=new_sidx,
        )

    if dim == 3:
        # Edges (12), faces (6), center (1).
        edge_local = np.array(
            [[0, 1], [2, 3], [4, 5], [6, 7],
             [0, 2], [1, 3], [4, 6], [5, 7],
             [0, 4], [1, 5], [2, 6], [3, 7]]
        )
        face_local = np.array(_FACE_VERTICES[3])
        cell_edges = cells[:, edge_local].reshape(-1, 2)
        uniq_edges, edge_inv = _unique_rows(cell_edges)
        n_edges = uniq_edges.shape[0]
        edge_mid = 0.5 * (verts[uniq_edges[:, 0]] + verts[uniq_edges[:, 1]])

        cell_faces = cells[:, face_local].reshape(-1, 4)
        uniq_faces, face_inv = _unique_rows(cell_faces)
        n_faces = uniq_faces.shape[0]
        face_mid = verts[uniq_faces].mean(axis=1)

        cell_mid = verts[cells].mean(axis=1)

        new_verts = np.concatenate([verts, edge_mid, face_mid, cell_mid], axis=0)
        E = nv + edge_inv.reshape(-1, 12)
        F = nv + n_edges + face_inv.reshape(-1, 6)
        C = nv + n_edges + n_faces + np.arange(mesh.n_cells)

        # Build the 27-point lattice per cell: index (i,j,k) in {0,1,2}^3.
        lat = np.empty((mesh.n_cells, 3, 3, 3), dtype=np.int64)
        V = cells
        # corners
        for kz in (0, 2):
            for ky in (0, 2):
                for kx in (0, 2):
                    lv = (kx // 2) + 2 * (ky // 2) + 4 * (kz // 2)
                    lat[:, kz, ky, kx] = V[:, lv]
        # edge midpoints: x-edges 0..3, y-edges 4..7, z-edges 8..11
        lat[:, 0, 0, 1] = E[:, 0]
        lat[:, 0, 2, 1] = E[:, 1]
        lat[:, 2, 0, 1] = E[:, 2]
        lat[:, 2, 2, 1] = E[:, 3]
        lat[:, 0, 1, 0] = E[:, 4]
        lat[:, 0, 1, 2] = E[:, 5]
        lat[:, 2, 1, 0] = E[:, 6]
        lat[:, 2, 1, 2] = E[:, 7]
        lat[:, 1, 0, 0] = E[:, 8]
        lat[:, 1, 0, 2] = E[:, 9]
        lat[:, 1, 2, 0] = E[:, 10]
        lat[:, 1, 2, 2] = E[:, 11]
        # face midpoints (-x,+x,-y,+y,-z,+z)
        lat[:, 1, 1, 0] = F[:, 0]
        lat[:, 1, 1, 2] = F[:, 1]
        lat[:, 1, 0, 1] = F[:, 2]
        lat[:, 1, 2, 1] = F[:, 3]
        lat[:, 0, 1, 1] = F[:, 4]
        lat[:, 2, 1, 1] = F[:, 5]
        # center
        lat[:, 1, 1, 1] = C

        children = []
        for kz in range(2):
            for ky in range(2):
                for kx in range(2):
                    child = np.stack(
                        [
                            lat[:, kz + dz, ky + dy, kx + dx]
                            for dz in range(2)
                            for dy in range(2)
                            for dx in range(2)
                        ],
                        axis=1,
                    )
                    # reorder from (dz,dy,dx) nesting to deal.II (dx fastest)
                    perm = [0, 0, 0, 0, 0, 0, 0, 0]
                    for dz in range(2):
                        for dy in range(2):
                            for dx in range(2):
                                src = dz * 4 + dy * 2 + dx
                                dst = dx + 2 * dy + 4 * dz
                                perm[dst] = src
                    children.append(child[:, perm])
        new_cells = np.concatenate(children, axis=0)

        # Refine boundary faces (each quad face -> 4 children).
        bf = mesh.boundary_faces
        # face edge midpoints:
        f_edge_local = np.array([[0, 1], [2, 3], [0, 2], [1, 3]])
        sorted_uniq = np.sort(uniq_edges, axis=1)
        ekey = sorted_uniq[:, 0].astype(np.int64) * (8 * nv) + sorted_uniq[:, 1]
        eorder = np.argsort(ekey)

        def edge_id(pairs):
            p = np.sort(pairs, axis=1)
            key = p[:, 0].astype(np.int64) * (8 * nv) + p[:, 1]
            return eorder[np.searchsorted(ekey[eorder], key)]

        fkey_uniq = np.sort(uniq_faces, axis=1)
        fkey = (
            fkey_uniq[:, 0].astype(np.int64) * (8 * nv) ** 2
            + fkey_uniq[:, 1].astype(np.int64) * (8 * nv)
            + fkey_uniq[:, 2]
        )
        forder = np.argsort(fkey)
        bf_sorted = np.sort(bf, axis=1)
        bkey = (
            bf_sorted[:, 0].astype(np.int64) * (8 * nv) ** 2
            + bf_sorted[:, 1].astype(np.int64) * (8 * nv)
            + bf_sorted[:, 2]
        )
        fpos = forder[np.searchsorted(fkey[forder], bkey)]
        fmid = nv + n_edges + fpos

        eb = nv + edge_id(bf[:, f_edge_local[0]])
        et = nv + edge_id(bf[:, f_edge_local[1]])
        el = nv + edge_id(bf[:, f_edge_local[2]])
        er = nv + edge_id(bf[:, f_edge_local[3]])
        v0, v1, v2, v3 = bf[:, 0], bf[:, 1], bf[:, 2], bf[:, 3]
        nf0 = np.stack([v0, eb, el, fmid], axis=1)
        nf1 = np.stack([eb, v1, fmid, er], axis=1)
        nf2 = np.stack([el, fmid, v2, et], axis=1)
        nf3 = np.stack([fmid, er, et, v3], axis=1)
        new_faces = np.concatenate([nf0, nf1, nf2, nf3], axis=0)
        new_ids = np.concatenate([mesh.boundary_ids] * 4)
        new_mids = None
        if mesh.face_manifold_ids is not None:
            new_mids = np.concatenate([mesh.face_manifold_ids] * 4)
        new_shape, new_sidx = None, None
        if mesh.structured_index is not None:
            si = mesh.structured_index
            edge_si = si[uniq_edges[:, 0]] + si[uniq_edges[:, 1]]
            face_si = si[uniq_faces].sum(axis=1) // 2
            cell_si = si[cells].sum(axis=1) // 4
            new_sidx = np.concatenate([2 * si, edge_si, face_si, cell_si], axis=0)
            new_shape = tuple(2 * s - 1 for s in mesh.structured_shape)
        return dataclasses.replace(
            mesh,
            vertices=new_verts,
            cells=new_cells,
            boundary_faces=new_faces,
            boundary_ids=new_ids,
            face_manifold_ids=new_mids,
            structured_shape=new_shape,
            structured_index=new_sidx,
        )

    raise ValueError(f"unsupported dim={dim}")


# ---------------------------------------------------------------------------
# Local (adaptive) refinement with hanging-node constraints
# ---------------------------------------------------------------------------


def refine_local(mesh: Mesh, flags: np.ndarray):
    """Refine the flagged cells; returns (new_mesh, transfer).

    The analog of dealii Triangulation::execute_coarsening_and_refinement +
    SolutionTransfer used by the reference's AMR loop
    (source/time_loop.template.h:616-689).  2D only.

    * 2:1 balance is enforced by flag closure (a cell is also refined when a
      neighbor two levels finer would otherwise result).
    * Edges split on one side only produce hanging nodes, recorded in
      ``new_mesh.hanging`` as rows (h, a, b) with u_h = (u_a + u_b)/2; the
      assembly condenses these constraints into the stencil.
    * ``transfer`` is a scipy CSR matrix [n_new_vertices, n_old_vertices]
      interpolating raw nodal values onto the refined mesh (Q1 embedding:
      edge midpoints average their endpoints, cell midpoints their corners).

    Flagging every cell reproduces uniform refinement and regularizes all
    hanging nodes.
    """
    import scipy.sparse as sp

    assert mesh.dim == 2, "local refinement implemented for 2D"
    flags = np.asarray(flags, bool).copy()
    cells, verts = mesh.cells, mesh.vertices
    nc, nv = len(cells), len(verts)
    assert flags.shape == (nc,)
    levels = (
        mesh.cell_levels.copy()
        if mesh.cell_levels is not None
        else np.zeros(nc, np.int64)
    )
    hang = (
        mesh.hanging.copy()
        if mesh.hanging is not None
        else np.zeros((0, 3), np.int64)
    )

    edge_local = np.array([[0, 1], [2, 3], [0, 2], [1, 3]])
    ce = np.sort(cells[:, edge_local], axis=2)  # [nc, 4, 2]
    ekey = ce[..., 0].astype(np.int64) * nv + ce[..., 1]  # [nc, 4]

    hab = np.sort(hang[:, 1:3], axis=1)
    hkey = hab[:, 0].astype(np.int64) * nv + hab[:, 1]  # parent edge keys

    # --- 2:1 closure ------------------------------------------------------
    # edge -> owning cells (1 or 2 owners; hanging edges have 1)
    flat, owner = ekey.ravel(), np.repeat(np.arange(nc), 4)
    order = np.argsort(flat, kind="stable")
    fk, fo = flat[order], owner[order]
    grp_start = np.flatnonzero(np.concatenate([[True], fk[1:] != fk[:-1]]))
    grp_len = np.diff(np.concatenate([grp_start, [len(fk)]]))
    pair_at = grp_start[grp_len == 2]
    nbr1, nbr2 = fo[pair_at], fo[pair_at + 1]

    # hanging-mediated adjacency: coarse owner of (a,b) vs fine owners of
    # (a,h)/(h,b)
    def owners_of(keys):
        pos = np.searchsorted(fk, keys)
        ok = (pos < len(fk)) & (fk[np.minimum(pos, len(fk) - 1)] == keys)
        return np.where(ok, fo[np.minimum(pos, len(fk) - 1)], -1)

    h_id = hang[:, 0].astype(np.int64)
    k_ah = (
        np.minimum(hang[:, 1], h_id) * nv + np.maximum(hang[:, 1], h_id)
    )
    k_hb = (
        np.minimum(hang[:, 2], h_id) * nv + np.maximum(hang[:, 2], h_id)
    )
    coarse_own = owners_of(hkey)
    fine_own_a = owners_of(k_ah)
    fine_own_b = owners_of(k_hb)

    while True:
        changed = False
        # direct neighbors: refining c1 while c2 stays must keep the level
        # difference at most one
        for c1, c2 in ((nbr1, nbr2), (nbr2, nbr1)):
            need = flags[c1] & ~flags[c2] & (levels[c1] >= levels[c2] + 1)
            if np.any(need):
                flags[c2[need]] = True
                changed = True
        # a refined fine cell forces its hanging-edge coarse neighbor
        for fine in (fine_own_a, fine_own_b):
            sel = (fine >= 0) & (coarse_own >= 0)
            need = sel & flags[np.maximum(fine, 0)] & ~flags[
                np.maximum(coarse_own, 0)
            ]
            if np.any(need):
                flags[coarse_own[need]] = True
                changed = True
        if not changed:
            break

    # --- construction -------------------------------------------------------
    R = np.flatnonzero(flags)
    Un = np.flatnonzero(~flags)

    uniq_k, inv = np.unique(ekey[R].ravel(), return_inverse=True)
    ua = (uniq_k // nv).astype(np.int64)
    ub = (uniq_k % nv).astype(np.int64)

    # reuse existing hanging nodes as midpoints of their parent edge:
    hpos = np.searchsorted(hkey, uniq_k, sorter=np.argsort(hkey))
    hsort = np.argsort(hkey)
    hk_sorted = hkey[hsort]
    hit = (hpos < len(hkey)) & (
        hk_sorted[np.minimum(hpos, max(len(hkey) - 1, 0))] == uniq_k
        if len(hkey)
        else np.zeros(len(uniq_k), bool)
    )
    reuse = np.full(len(uniq_k), -1, np.int64)
    if len(hkey):
        reuse[hit] = hang[hsort[np.minimum(hpos[hit], len(hkey) - 1)], 0]

    mid_coord = 0.5 * (verts[ua] + verts[ub])

    # manifold projection (boundary faces first, then interior selectors):
    if mesh.edge_manifold_selectors and mesh.manifolds:
        pts = verts[np.stack([ua, ub], axis=1)]
        for mid_id_, selector in mesh.edge_manifold_selectors.items():
            sel = np.asarray(selector(pts), bool)
            if np.any(sel):
                mid_coord[sel] = mesh.manifolds[mid_id_](pts[sel])
    bf = np.sort(mesh.boundary_faces, axis=1)
    bfkey = bf[:, 0].astype(np.int64) * nv + bf[:, 1]
    if mesh.face_manifold_ids is not None and mesh.manifolds:
        pos = np.searchsorted(uniq_k, bfkey)
        okb = (pos < len(uniq_k)) & (
            uniq_k[np.minimum(pos, len(uniq_k) - 1)] == bfkey
        )
        for mid_id_, proj in mesh.manifolds.items():
            sel = (mesh.face_manifold_ids == mid_id_) & okb
            if np.any(sel):
                eids = pos[sel]
                mid_coord[eids] = proj(
                    verts[np.stack([ua[eids], ub[eids]], axis=1)]
                )

    new_mid = reuse < 0
    mid_ids = np.where(
        new_mid, nv + np.cumsum(new_mid) - 1, reuse
    ).astype(np.int64)
    n_new_mid = int(new_mid.sum())
    cmid_ids = nv + n_new_mid + np.arange(len(R), dtype=np.int64)
    cell_mid = verts[cells[R]].mean(axis=1)

    new_verts = np.concatenate([verts, mid_coord[new_mid], cell_mid], axis=0)

    e = mid_ids[inv.reshape(len(R), 4)]  # per refined cell edge-mid ids
    v0, v1, v2, v3 = (cells[R, k] for k in range(4))
    eb, et, el, er = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
    c = cmid_ids
    children = [
        np.stack([v0, eb, el, c], axis=1),
        np.stack([eb, v1, c, er], axis=1),
        np.stack([el, c, v2, et], axis=1),
        np.stack([c, er, et, v3], axis=1),
    ]
    new_cells = np.concatenate([cells[Un]] + children, axis=0)
    new_levels = np.concatenate([levels[Un]] + [levels[R] + 1] * 4)
    origin = (
        mesh.cell_origin.copy()
        if mesh.cell_origin is not None
        else np.full((nc, 2), -1, np.int64)
    )
    child_origin = np.stack([cmid_ids, origin[R, 0]], axis=1)
    new_origin = np.concatenate([origin[Un]] + [child_origin] * 4, axis=0)

    # --- hanging-node bookkeeping -----------------------------------------
    keep_old = ~np.isin(hkey, uniq_k) if len(hkey) else np.zeros(0, bool)

    shared_un = np.isin(uniq_k, ekey[Un].ravel())
    is_bf = np.isin(uniq_k, bfkey)
    # a half (parent, h) of a refined coarse edge (a, b) stays unsplit in the
    # coarse cell's child while the refined fine neighbor splits it -> the
    # new midpoint hangs.  Only exact halves qualify: the other endpoint
    # must be one of h's parents.
    if len(hkey):
        hs = np.argsort(h_id)
        h_sorted = h_id[hs]
        par = hang[hs][:, 1:3]
        h_is_refined = np.isin(hkey, uniq_k)[hs]

        def _half_mask(x, y):
            pos = np.searchsorted(h_sorted, y)
            posc = np.minimum(pos, len(h_sorted) - 1)
            ok = (pos < len(h_sorted)) & (h_sorted[posc] == y)
            return (
                ok
                & h_is_refined[posc]
                & ((par[posc, 0] == x) | (par[posc, 1] == x))
            )

        half_unsplit = _half_mask(ua, ub) | _half_mask(ub, ua)
    else:
        half_unsplit = np.zeros(len(uniq_k), bool)
    new_h = (shared_un | half_unsplit) & ~is_bf
    new_rows = np.stack([mid_ids[new_h], ua[new_h], ub[new_h]], axis=1)
    new_hanging = np.concatenate([hang[keep_old], new_rows], axis=0)

    # --- boundary faces ------------------------------------------------------
    pos = np.searchsorted(uniq_k, bfkey)
    split = (pos < len(uniq_k)) & (
        uniq_k[np.minimum(pos, len(uniq_k) - 1)] == bfkey
    )
    bsplit = mesh.boundary_faces[split]
    bmid = mid_ids[pos[split]]
    f0 = np.stack([bsplit[:, 0], bmid], axis=1)
    f1 = np.stack([bmid, bsplit[:, 1]], axis=1)
    new_faces = np.concatenate(
        [mesh.boundary_faces[~split], f0, f1], axis=0
    )
    new_ids = np.concatenate(
        [mesh.boundary_ids[~split]]
        + [mesh.boundary_ids[split]] * 2
    )
    new_fmids = None
    if mesh.face_manifold_ids is not None:
        new_fmids = np.concatenate(
            [mesh.face_manifold_ids[~split]]
            + [mesh.face_manifold_ids[split]] * 2
        )

    # --- Q1 embedding transfer ----------------------------------------------
    n_new = len(new_verts)
    rows = [np.arange(nv), ]
    cols = [np.arange(nv)]
    vals = [np.ones(nv)]
    nm = np.flatnonzero(new_mid)
    rows += [mid_ids[nm]] * 2
    cols += [ua[nm], ub[nm]]
    vals += [np.full(len(nm), 0.5)] * 2
    for k in range(4):
        rows.append(cmid_ids)
        cols.append(cells[R, k])
        vals.append(np.full(len(R), 0.25))
    transfer = sp.csr_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(n_new, nv),
    )

    new_mesh = dataclasses.replace(
        mesh,
        vertices=new_verts,
        cells=new_cells,
        boundary_faces=new_faces,
        boundary_ids=new_ids,
        face_manifold_ids=new_fmids,
        structured_shape=None,
        structured_index=None,
        hanging=new_hanging if len(new_hanging) else None,
        cell_levels=new_levels,
        cell_origin=new_origin,
    )
    return new_mesh, transfer


def coarsen_local(mesh: Mesh, flags: np.ndarray):
    """Coarsen sibling quartets whose four children are all flagged.

    The coarsening half of the reference's fixed-number AMR marking
    (source/mesh_adaptor.h:133-149; deal.II
    execute_coarsening_and_refinement + SolutionTransfer,
    time_loop.template.h:616-689).  A quartet merges back into its parent
    cell when (a) its four cells are the children of one refine_local
    split (mesh.cell_origin), (b) all four are flagged, and (c) no child
    edge carries a hanging node (the neighbor across would end up two
    levels finer) — the conservative 2:1 guard; coarsening under a finer
    neighbor therefore takes an extra adaptation cycle after the neighbor
    has coarsened.  2D only.

    Returns (new_mesh, transfer, cell_map): `transfer` is the
    [n_new, n_old] injection CSR interpolating nodal values onto the
    coarsened mesh (parent corners coincide with child corners — the
    deal.II SolutionTransfer semantics), `cell_map` maps old cell ids to
    new ids (-1 for merged-away children) so refinement flags marked on
    the old mesh can be carried across.
    """
    import scipy.sparse as sp

    assert mesh.dim == 2, "local coarsening implemented for 2D"
    flags = np.asarray(flags, bool)
    cells, verts = mesh.cells, mesh.vertices
    nc, nv = len(cells), len(verts)
    identity = sp.identity(nv, format="csr")
    if mesh.cell_origin is None:
        return mesh, identity, np.arange(nc, dtype=np.int64)
    origin = mesh.cell_origin
    levels = (
        mesh.cell_levels
        if mesh.cell_levels is not None
        else np.zeros(nc, np.int64)
    )
    hang = (
        mesh.hanging if mesh.hanging is not None else np.zeros((0, 3), np.int64)
    )

    # ---- candidate quartets: same origin, 4 members, all flagged --------
    org = origin[:, 0]
    cand = np.flatnonzero((org >= 0) & flags)
    if len(cand) == 0:
        return mesh, identity, np.arange(nc, dtype=np.int64)
    order = cand[np.argsort(org[cand], kind="stable")]
    og = org[order]
    starts = np.flatnonzero(np.concatenate([[True], og[1:] != og[:-1]]))
    lens = np.diff(np.concatenate([starts, [len(og)]]))
    # a split's children may have been refined further (then fewer than 4
    # cells carry the origin) — only complete quartets coarsen:
    full = starts[lens == 4]
    quartets = np.stack([order[s : s + 4] for s in full], axis=0) \
        if len(full) else np.zeros((0, 4), np.int64)

    # ---- 2:1 guard: no child edge may be a hanging parent edge ----------
    if len(quartets) and len(hang):
        edge_local = np.array([[0, 1], [2, 3], [0, 2], [1, 3]])
        qcells = cells[quartets.reshape(-1)]  # [4q, 4]
        ce = np.sort(qcells[:, edge_local], axis=2)
        ekey = (ce[..., 0].astype(np.int64) * nv + ce[..., 1]).reshape(
            len(quartets), 16
        )
        hab = np.sort(hang[:, 1:3], axis=1)
        hkey = np.sort(hab[:, 0].astype(np.int64) * nv + hab[:, 1])
        blocked = np.isin(ekey, hkey).any(axis=1)
        quartets = quartets[~blocked]
    if len(quartets) == 0:
        return mesh, identity, np.arange(nc, dtype=np.int64)

    # ---- merge: reconstruct the parents ----------------------------------
    # refine_local's children hold the center vertex c at local index
    # 3 - role (children = [[v0,eb,el,c],[eb,v1,c,er],[el,c,v2,et],
    # [c,er,et,v3]]); the parent corner k comes from the role-k child:
    qc = cells[quartets]  # [q, 4, 4]
    c_vert = org[quartets[:, 0]]  # [q]
    pos_c = np.argmax(qc == c_vert[:, None, None], axis=2)  # [q, 4]
    role = 3 - pos_c  # [q, 4] role of each member
    assert (np.sort(role, axis=1) == np.arange(4)).all(), "broken quartet"
    rorder = np.argsort(role, axis=1)
    qs = np.take_along_axis(quartets, rorder, axis=1)  # role-sorted members
    qcs = cells[qs]  # [q, 4, 4] role-sorted
    parents = np.stack([qcs[:, k, k] for k in range(4)], axis=1)  # [q, 4]
    # quartet edge midpoints (on the merged parent's edges):
    mids = np.stack(
        [qcs[:, 0, 1], qcs[:, 2, 3], qcs[:, 0, 2], qcs[:, 1, 3]], axis=1
    )  # [q, 4] = eb, et, el, er
    mid_ends = np.stack(
        [parents[:, [0, 1]], parents[:, [2, 3]],
         parents[:, [0, 2]], parents[:, [1, 3]]],
        axis=1,
    )  # [q, 4, 2]

    merged = np.zeros(nc, bool)
    merged[quartets.reshape(-1)] = True
    keep_cells = np.flatnonzero(~merged)
    new_cells = np.concatenate([cells[keep_cells], parents], axis=0)
    lv = levels[qs[:, 0]] - 1
    new_levels = np.concatenate([levels[keep_cells], lv])
    new_origin = np.concatenate(
        [origin[keep_cells],
         np.stack([origin[qs[:, 0], 1], np.full(len(qs), -1, np.int64)],
                  axis=1)],
        axis=0,
    )
    cell_map = np.full(nc, -1, dtype=np.int64)
    cell_map[keep_cells] = np.arange(len(keep_cells))

    # ---- vertex removal ---------------------------------------------------
    used = np.zeros(nv, bool)
    used[new_cells.reshape(-1)] = True
    # center vertices are interior to their quartet -> always removed;
    # edge midpoints survive iff a remaining (level-L) neighbor still uses
    # them, in which case they hang on the merged parent edge:
    m_flat = mids.reshape(-1)
    e_flat = mid_ends.reshape(-1, 2)
    hangs = used[m_flat]
    new_rows = np.unique(
        np.stack(
            [m_flat[hangs], e_flat[hangs, 0], e_flat[hangs, 1]], axis=1
        ),
        axis=0,
    )
    # previous hanging rows whose node vanishes (the quartet was the only
    # user — its across-neighbor is the coarse parent edge) are dropped:
    keep_h = used[hang[:, 0]] if len(hang) else np.zeros(0, bool)
    new_hanging = np.concatenate([hang[keep_h], new_rows], axis=0)

    # ---- boundary faces: merge the split halves of coarsened edges -------
    faces, fids = mesh.boundary_faces, mesh.boundary_ids
    fmids = mesh.face_manifold_ids
    gone = ~used
    has_gone = gone[faces].any(axis=1)
    keep_f = ~has_gone
    mf = faces[has_gone]
    mi = fids[has_gone]
    mm = fmids[has_gone] if fmids is not None else None
    if len(mf):
        # pair the two halves by their removed midpoint
        mid_of = np.where(gone[mf[:, 0]], mf[:, 0], mf[:, 1])
        other = np.where(gone[mf[:, 0]], mf[:, 1], mf[:, 0])
        o = np.argsort(mid_of, kind="stable")
        mid_s, oth_s, id_s = mid_of[o], other[o], mi[o]
        assert (mid_s[0::2] == mid_s[1::2]).all(), "unpaired boundary half"
        assert (id_s[0::2] == id_s[1::2]).all(), "boundary id mismatch"
        # preserve the (x, m)/(m, y) -> (x, y) orientation: the half whose
        # FIRST vertex survives supplies the merged face's first vertex
        first_is_end = gone[mf[:, 0]]
        f_s = first_is_end[o]
        a = np.where(f_s[0::2], oth_s[1::2], oth_s[0::2])
        b = np.where(f_s[0::2], oth_s[0::2], oth_s[1::2])
        mergedf = np.stack([a, b], axis=1)
        new_faces = np.concatenate([faces[keep_f], mergedf], axis=0)
        new_fids = np.concatenate([fids[keep_f], id_s[0::2]])
        new_fm = (
            np.concatenate([fmids[keep_f], mm[o][0::2]])
            if fmids is not None else None
        )
    else:
        new_faces, new_fids = faces[keep_f], fids[keep_f]
        new_fm = fmids[keep_f] if fmids is not None else None

    # ---- compact vertices + injection transfer ---------------------------
    vmap = np.full(nv, -1, dtype=np.int64)
    kept_v = np.flatnonzero(used)
    vmap[kept_v] = np.arange(len(kept_v))
    new_verts = verts[kept_v]
    new_cells = vmap[new_cells]
    new_faces = vmap[new_faces]
    new_hanging = vmap[new_hanging]
    assert (new_hanging >= 0).all()
    oshape = new_origin >= 0
    new_origin = np.where(oshape, vmap[np.maximum(new_origin, 0)], -1)
    transfer = sp.csr_matrix(
        (np.ones(len(kept_v)), (np.arange(len(kept_v)), kept_v)),
        shape=(len(kept_v), nv),
    )

    new_mesh = dataclasses.replace(
        mesh,
        vertices=new_verts,
        cells=new_cells,
        boundary_faces=new_faces,
        boundary_ids=new_fids,
        face_manifold_ids=new_fm,
        structured_shape=None,
        structured_index=None,
        hanging=new_hanging if len(new_hanging) else None,
        cell_levels=new_levels,
        cell_origin=new_origin,
    )
    return new_mesh, transfer, cell_map
