"""The port's own copy of ryujin_tpu/offline/ansatz.py (plain numpy; the port imports
nothing of ryujin_tpu).  The original header follows.

Finite element ansatz spaces: cG Q1-Q3, dG Q0-Q3.

The analog of the reference's Discretization Ansatz enum and finite
element / quadrature selection (source/discretization.h:131-173,
discretization.template.h:126-192): continuous FE_Q(p) with Gauss-Lobatto
support points, discontinuous FE_DGQ(p), QGauss(p+1) volume quadrature.

This module owns the reference-element data (1D Gauss-Lobatto support
points, tensor-product Lagrange bases) and the global DoF enumeration over
a Mesh:

  * cG Qp: vertex dofs first (= mesh vertex ids), then (p-1) dofs per
    unique edge (parameterized from the lower to the higher vertex id so
    both neighboring cells agree), then (p-1)^dim interior dofs per cell.
  * dG Qp: (p+1)^dim independent dofs per cell.

Local dofs use lexicographic tensor ordering (x fastest), NOT deal.II's
hierarchic ordering — the global assembly is ours, so only internal
consistency matters.  Geometry uses the (sub-parametric) Q1 bilinear map
of the mesh cells.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .mesh import Mesh

ANSATZE = (
    "cG Q1", "cG Q2", "cG Q3", "dG Q0", "dG Q1", "dG Q2", "dG Q3",
)


def parse_ansatz(name: str) -> Tuple[bool, int]:
    """Return (continuous, degree)."""
    if name not in ANSATZE:
        raise ValueError(f"unknown ansatz '{name}' (choose from {ANSATZE})")
    kind, deg = name.split()
    return kind == "cG", int(deg[1])


def gauss_lobatto_points(p: int) -> np.ndarray:
    """p+1 Gauss-Lobatto support points on [0, 1] (FE_Q node positions)."""
    if p == 0:
        return np.array([0.5])
    if p == 1:
        return np.array([0.0, 1.0])
    # roots of (1-x^2) P'_p(x) on [-1, 1]:
    legendre = np.polynomial.legendre.Legendre.basis(p)
    interior = legendre.deriv().roots()
    pts = np.concatenate([[-1.0], np.sort(interior), [1.0]])
    return 0.5 * (pts + 1.0)


def lagrange_1d(nodes: np.ndarray, x: np.ndarray):
    """Lagrange basis values/derivatives at x for the given nodes.

    Returns (V [nx, n], D [nx, n])."""
    n = len(nodes)
    x = np.asarray(x, np.float64)
    V = np.ones((len(x), n))
    D = np.zeros((len(x), n))
    for i in range(n):
        others = [k for k in range(n) if k != i]
        denom = np.prod([nodes[i] - nodes[k] for k in others])
        for k in others:
            V[:, i] *= x - nodes[k]
        V[:, i] /= denom
        # derivative via sum over products
        for m in others:
            term = np.ones(len(x))
            for k in others:
                if k != m:
                    term *= x - nodes[k]
            D[:, i] += term
        D[:, i] /= denom
    return V, D


def shape_qp(dim: int, p: int, qpts: np.ndarray):
    """Tensor Lagrange basis on Gauss-Lobatto nodes, lexicographic order.

    qpts: [nq, dim].  Returns (N [nq, nsh], dN [nq, nsh, dim]) with local
    dof (i0, i1, ...) flattened x-fastest: loc = i0 + (p+1)*i1 + ...
    """
    nodes = gauss_lobatto_points(p)
    n1 = len(nodes)
    nsh = n1**dim
    nq = qpts.shape[0]
    V = []
    D = []
    for d in range(dim):
        v, dv = lagrange_1d(nodes, qpts[:, d])
        V.append(v)
        D.append(dv)
    N = np.ones((nq, nsh))
    dN = np.ones((nq, nsh, dim))
    for loc in range(nsh):
        idx = [(loc // n1**d) % n1 for d in range(dim)]
        for d in range(dim):
            N[:, loc] *= V[d][:, idx[d]]
            for dd in range(dim):
                dN[:, loc, dd] *= (
                    D[d][:, idx[d]] if dd == d else V[d][:, idx[d]]
                )
    return N, dN


@dataclasses.dataclass
class DofMap:
    """Global DoF enumeration for one ansatz over one mesh."""

    continuous: bool
    degree: int
    n_dofs: int
    n_loc: int
    cell_dofs: np.ndarray  # [nc, n_loc] int64, lexicographic local order
    positions: np.ndarray  # [n_dofs, dim]
    # boundary faces in dof numbering: [nf, p+1] (2D) / [nf] object (1D);
    # for dG, boundary faces reference the adjacent cell's face dofs.
    face_dofs: np.ndarray


def _q1_geometry_map(mesh: Mesh, unit_pts: np.ndarray) -> np.ndarray:
    """Map unit-cell points [k, dim] into every cell: returns [nc, k, dim]."""
    from .assembly import _shape_q1

    N, _ = _shape_q1(mesh.dim, unit_pts)
    return np.einsum("qs,nsd->nqd", N, mesh.vertices[mesh.cells])


def _local_lattice(dim: int, p: int) -> np.ndarray:
    """Unit-cell lexicographic node coordinates [(p+1)^dim, dim]."""
    nodes = gauss_lobatto_points(p)
    if dim == 1:
        return nodes[:, None]
    grids = np.meshgrid(*([nodes] * dim), indexing="ij")
    # x fastest: meshgrid ij gives first axis slowest; stack reversed
    pts = np.stack([g.ravel(order="F") for g in grids], axis=1)
    return pts


def build_dof_map(mesh: Mesh, ansatz: str) -> DofMap:
    continuous, p = parse_ansatz(ansatz)
    dim = mesh.dim
    nc = mesh.n_cells
    n1 = p + 1
    n_loc = n1**dim
    unit = _local_lattice(dim, p)

    if not continuous:
        cell_dofs = np.arange(nc * n_loc, dtype=np.int64).reshape(nc, n_loc)
        positions = _q1_geometry_map(mesh, unit).reshape(nc * n_loc, dim)
        face_dofs = _dg_face_dofs(mesh, p, cell_dofs)
        return DofMap(False, p, nc * n_loc, n_loc, cell_dofs, positions,
                      face_dofs)

    # --- continuous -------------------------------------------------------
    if p == 1:
        cell_dofs = mesh.cells.copy()
        face_dofs = mesh.boundary_faces.copy()
        return DofMap(True, 1, mesh.n_vertices, n_loc, cell_dofs,
                      mesh.vertices.copy(), face_dofs)

    nv = mesh.n_vertices
    gl = gauss_lobatto_points(p)
    t_int = gl[1:-1]  # (p-1) interior parameters

    if dim == 1:
        cells = mesh.cells
        n_int = p - 1
        cell_dofs = np.zeros((nc, n1), np.int64)
        cell_dofs[:, 0] = cells[:, 0]
        cell_dofs[:, -1] = cells[:, 1]
        interior = nv + np.arange(nc * n_int).reshape(nc, n_int)
        cell_dofs[:, 1:-1] = interior
        xa = mesh.vertices[cells[:, 0]]
        xb = mesh.vertices[cells[:, 1]]
        pos_int = (
            xa[:, None, :] * (1 - t_int)[None, :, None]
            + xb[:, None, :] * t_int[None, :, None]
        ).reshape(-1, 1)
        positions = np.concatenate([mesh.vertices, pos_int], axis=0)
        return DofMap(True, p, len(positions), n_loc, cell_dofs, positions,
                      mesh.boundary_faces.copy())

    if dim == 3:
        return _build_dof_map_cg_3d(mesh, p)

    # dim == 2
    cells = mesh.cells
    edge_local = np.array([[0, 1], [2, 3], [0, 2], [1, 3]])
    ce = cells[:, edge_local]  # [nc, 4, 2]
    ce_sorted = np.sort(ce, axis=2)
    flat = ce_sorted.reshape(-1, 2)
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    n_edges = len(uniq)
    n_int_e = p - 1
    edge_dof0 = nv + np.arange(n_edges, dtype=np.int64) * n_int_e
    n_int_c = (p - 1) ** 2
    cell_dof0 = nv + n_edges * n_int_e + np.arange(nc, dtype=np.int64) * n_int_c

    cell_dofs = np.zeros((nc, n_loc), np.int64)
    # corners (lexicographic (0,0),(p,0),(0,p),(p,p) = deal.II v0,v1,v2,v3):
    cell_dofs[:, 0] = cells[:, 0]
    cell_dofs[:, p] = cells[:, 1]
    cell_dofs[:, p * n1] = cells[:, 2]
    cell_dofs[:, p * n1 + p] = cells[:, 3]

    edge_ids = inv.reshape(nc, 4)
    # orientation: edge dofs run from the lower to the higher vertex id;
    # flip the local slot order when the cell traverses the edge backwards.
    for e_loc, (la, lb) in enumerate(edge_local):
        va, vb = cells[:, la], cells[:, lb]
        forward = va < vb
        base = edge_dof0[edge_ids[:, e_loc]]
        for k in range(n_int_e):
            k_eff = np.where(forward, k, n_int_e - 1 - k)
            dof = base + k_eff
            if e_loc == 0:  # bottom: (k+1, 0)
                slot = (k + 1)
            elif e_loc == 1:  # top: (k+1, p)
                slot = p * n1 + (k + 1)
            elif e_loc == 2:  # left: (0, k+1)
                slot = (k + 1) * n1
            else:  # right: (p, k+1)
                slot = (k + 1) * n1 + p
            cell_dofs[:, slot] = dof
    # interior
    for jy in range(1, p):
        for jx in range(1, p):
            slot = jy * n1 + jx
            cell_dofs[:, slot] = cell_dof0 + (jy - 1) * (p - 1) + (jx - 1)

    # positions: vertices, edge interiors, cell interiors
    ea = mesh.vertices[uniq[:, 0]]
    eb = mesh.vertices[uniq[:, 1]]
    pos_e = (
        ea[:, None, :] * (1 - t_int)[None, :, None]
        + eb[:, None, :] * t_int[None, :, None]
    ).reshape(-1, dim)
    # order must match the interior slot loop above ((jy, jx), jx fastest):
    int_unit = np.stack(
        [np.tile(t_int, p - 1), np.repeat(t_int, p - 1)], axis=1
    )
    pos_c = _q1_geometry_map(mesh, int_unit).reshape(-1, dim)
    positions = np.concatenate([mesh.vertices, pos_e, pos_c], axis=0)

    # boundary faces -> dof lists [nf, p+1], ordered v0, edge dofs..., v1
    bf = mesh.boundary_faces
    bf_sorted = np.sort(bf, axis=1)
    pos_in_uniq = np.searchsorted(
        uniq[:, 0] * (nv + 1) + uniq[:, 1],
        bf_sorted[:, 0] * (nv + 1) + bf_sorted[:, 1],
    )
    face_dofs = np.zeros((len(bf), n1), np.int64)
    face_dofs[:, 0] = bf[:, 0]
    face_dofs[:, -1] = bf[:, 1]
    fwd = bf[:, 0] < bf[:, 1]
    base = edge_dof0[pos_in_uniq]
    for k in range(n_int_e):
        k_eff = np.where(fwd, k, n_int_e - 1 - k)
        face_dofs[:, k + 1] = base + k_eff
    return DofMap(True, p, len(positions), n_loc, cell_dofs, positions,
                  face_dofs)


# 3D cell edges in the mesh's (deal.II bit-toggle) local vertex order; the
# slot lattice coordinate that varies along each edge and the two fixed ones:
_EDGE_LOCAL_3D = np.array(
    [[0, 1], [2, 3], [4, 5], [6, 7],
     [0, 2], [1, 3], [4, 6], [5, 7],
     [0, 4], [1, 5], [2, 6], [3, 7]]
)


def _edge_slot_info(p: int):
    """Per 3D cell edge: (varying axis, fixed lattice coords of the other two
    axes) so slot = sum over axes of coord * (p+1)**axis."""
    info = []
    for (a, b) in _EDGE_LOCAL_3D:
        ca = np.array([(a >> d) & 1 for d in range(3)]) * p
        cb = np.array([(b >> d) & 1 for d in range(3)]) * p
        axis = int(np.flatnonzero(ca != cb)[0])
        info.append((axis, ca))
    return info


def _build_dof_map_cg_3d(mesh: Mesh, p: int) -> "DofMap":
    """cG Qp (p >= 2) DoF enumeration in 3D.

    DoF order: mesh vertices, then (p-1) per unique edge (parameterized low
    to high vertex id), then (p-1)^2 per unique face in a canonical frame
    both neighbor cells agree on, then (p-1)^3 interior dofs per cell."""
    from .mesh import _FACE_VERTICES

    dim, n1 = 3, p + 1
    nc, nv = mesh.n_cells, mesh.n_vertices
    cells = mesh.cells
    n_loc = n1**3
    gl = gauss_lobatto_points(p)
    t_int = gl[1:-1]
    n_e = p - 1          # dofs per edge
    n_f = (p - 1) ** 2   # dofs per face
    n_c = (p - 1) ** 3   # dofs per cell interior

    # ---- unique edges ---------------------------------------------------
    ce = cells[:, _EDGE_LOCAL_3D]                     # [nc, 12, 2]
    ce_sorted = np.sort(ce, axis=2).reshape(-1, 2)
    uniq_e, inv_e = np.unique(ce_sorted, axis=0, return_inverse=True)
    n_edges = len(uniq_e)
    edge_ids = inv_e.reshape(nc, 12)
    edge_dof0 = nv + np.arange(n_edges, dtype=np.int64) * n_e

    # ---- unique faces ---------------------------------------------------
    face_local = np.stack(_FACE_VERTICES[3])          # [6, 4] (s,t) order
    cf = cells[:, face_local]                         # [nc, 6, 4]
    cf_sorted = np.sort(cf, axis=2).reshape(-1, 4)
    uniq_f, inv_f = np.unique(cf_sorted, axis=0, return_inverse=True)
    n_faces = len(uniq_f)
    face_ids = inv_f.reshape(nc, 6)
    face_dof0 = nv + n_edges * n_e + np.arange(n_faces, dtype=np.int64) * n_f
    cell_dof0 = (nv + n_edges * n_e + n_faces * n_f
                 + np.arange(nc, dtype=np.int64) * n_c)

    cell_dofs = np.zeros((nc, n_loc), np.int64)

    # corners: local vertex v (bits (bx,by,bz)) -> slot bx*p + by*p*n1 + ...
    for v in range(8):
        slot = sum(((v >> d) & 1) * p * n1**d for d in range(3))
        cell_dofs[:, slot] = cells[:, v]

    # edges: dofs run from the lower to the higher global vertex id
    for e_loc, (axis, fixed) in enumerate(_edge_slot_info(p)):
        va, vb = ce[:, e_loc, 0], ce[:, e_loc, 1]
        forward = va < vb
        base = edge_dof0[edge_ids[:, e_loc]]
        fixed_slot = int(sum(fixed[d] * n1**d for d in range(3))
                         - fixed[axis] * n1**axis)
        for k in range(n_e):
            k_eff = np.where(forward, k, n_e - 1 - k)
            slot = fixed_slot + (k + 1) * n1**axis
            cell_dofs[:, slot] = base + k_eff

    # faces: canonical frame = origin at the min global id corner; u axis
    # toward the smaller-id of its two face neighbors.  Both adjacent cells
    # derive the same frame, so the shared dofs coincide.
    # corners in the cell's (s,t) frame: k = s_bit + 2*t_bit.
    g = cf  # [nc, 6, 4] global ids in (s,t) corner order
    for f_loc in range(6):
        gf = g[:, f_loc, :]                              # [nc, 4]
        k0 = np.argmin(gf, axis=1)                       # origin corner
        s0, t0 = k0 & 1, k0 >> 1
        k_s = (1 - s0) + 2 * t0                          # s-neighbor of k0
        k_t = s0 + 2 * (1 - t0)                          # t-neighbor of k0
        u_is_s = (np.take_along_axis(gf, k_s[:, None], 1)[:, 0]
                  < np.take_along_axis(gf, k_t[:, None], 1)[:, 0])
        base = face_dof0[face_ids[:, f_loc]]
        # face_slots returns the flat (s fastest) lattice; sl[s, t]:
        sl = face_slots(3, p)[f_loc].reshape(n1, n1).T
        for i_s in range(1, p):
            for i_t in range(1, p):
                cs = np.where(s0 == 0, i_s, p - i_s)
                ct = np.where(t0 == 0, i_t, p - i_t)
                a = np.where(u_is_s, cs, ct)
                b = np.where(u_is_s, ct, cs)
                dof = base + (a - 1) + (p - 1) * (b - 1)
                cell_dofs[:, sl[i_s, i_t]] = dof

    # interiors (x fastest)
    for kz in range(1, p):
        for ky in range(1, p):
            for kx in range(1, p):
                slot = kx + ky * n1 + kz * n1 * n1
                local = (kx - 1) + (p - 1) * (ky - 1) + (p - 1) ** 2 * (kz - 1)
                cell_dofs[:, slot] = cell_dof0 + local

    # ---- positions ------------------------------------------------------
    positions = np.zeros((int(cell_dofs.max()) + 1, 3))
    positions[:nv] = mesh.vertices
    ea, eb = mesh.vertices[uniq_e[:, 0]], mesh.vertices[uniq_e[:, 1]]
    pos_e = (ea[:, None, :] * (1 - t_int)[None, :, None]
             + eb[:, None, :] * t_int[None, :, None]).reshape(-1, 3)
    positions[nv: nv + n_edges * n_e] = pos_e
    # face dof positions: scatter through cell_dofs using the Q1 cell map
    # (bilinear face interpolation = trilinear cell map restricted to the
    # face, so every incident cell writes the identical value); interior
    # dof positions likewise.
    unit = _local_lattice(3, p)
    allpos = _q1_geometry_map(mesh, unit)                # [nc, n_loc, 3]
    positions[cell_dofs.ravel()] = allpos.reshape(-1, 3)
    positions[:nv] = mesh.vertices
    n_dofs = len(positions)

    # ---- boundary face dofs --------------------------------------------
    face_dofs = _face_dofs_from_owner(mesh, p, cell_dofs)
    return DofMap(True, p, n_dofs, n_loc, cell_dofs, positions, face_dofs)


# local face -> lexicographic slots on the face, in face-tangential order;
# faces ordered (-x, +x, -y, +y[, -z, +z]) like mesh._FACE_VERTICES; in 3D
# the flat order is the face (s, t) lattice with s fastest.
def face_slots(dim: int, p: int):
    n1 = p + 1
    if dim == 1:
        return [np.array([0]), np.array([p])]
    if dim == 2:
        return [
            np.arange(n1) * n1,            # -x: (0, j)
            np.arange(n1) * n1 + p,        # +x: (p, j)
            np.arange(n1),                 # -y: (i, 0)
            p * n1 + np.arange(n1),        # +y: (i, p)
        ]
    sv = np.tile(np.arange(n1), n1)        # s, fastest
    tv = np.repeat(np.arange(n1), n1)      # t
    return [
        sv * n1 + tv * n1 * n1,            # -x: (y, z) = (s, t)
        p + sv * n1 + tv * n1 * n1,        # +x
        sv + tv * n1 * n1,                 # -y: (x, z)
        p * n1 + sv + tv * n1 * n1,        # +y
        sv + tv * n1,                      # -z: (x, y)
        p * n1 * n1 + sv + tv * n1,        # +z
    ]


def boundary_face_owners(mesh: Mesh):
    """Match each boundary face to its owning (cell, local face) by vertex
    sets.  Returns a list of (cell, f_loc) in boundary-face order."""
    from .mesh import _FACE_VERTICES

    table = {}
    for f_loc, lv in enumerate(_FACE_VERTICES[mesh.dim]):
        for c in range(mesh.n_cells):
            key = tuple(sorted(mesh.cells[c, lv].tolist()))
            table[key] = (c, f_loc)
    return [table[tuple(sorted(bfv.tolist()))]
            for bfv in mesh.boundary_faces]


def _face_dofs_from_owner(mesh: Mesh, p: int, cell_dofs: np.ndarray
                          ) -> np.ndarray:
    """Boundary-face dof lists [nf, (p+1)^(dim-1)] in the owning cell's face
    frame (used by both the dG and the 3D cG paths)."""
    dim = mesh.dim
    slots = face_slots(dim, p)
    n_face = (p + 1) ** (dim - 1) if dim > 1 else 1
    out = np.zeros((len(mesh.boundary_faces), n_face), np.int64)
    for k, (c, f_loc) in enumerate(boundary_face_owners(mesh)):
        out[k] = cell_dofs[c, slots[f_loc]]
    return out


# retained name for the dG path
_dg_face_dofs = _face_dofs_from_owner
