"""The port's own copy of ryujin_tpu/offline/assembly.py (plain numpy; the port imports
nothing of ryujin_tpu).  The original header follows.

Q1 finite element assembly of the offline data.

TPU-native re-design of source/offline_data.template.h:419-1105.
The reference assembles, once per mesh,

  * the consistent mass matrix  m_ij = ∫ φ_i φ_j dx,
  * the lumped mass matrix      m_i  = Σ_j m_ij,
  * the transport matrix        c_ij[d] = ∫ φ_i ∂_d φ_j dx
    (offline_data.template.h:566-578),
  * the measure of the domain   |Ω|,
  * the boundary map: per boundary DoF the filtered/merged averaged normal,
    normal mass, boundary mass, boundary id and position
    (offline_data.template.h:1171-1364),

using cell-wise quadrature (QGauss(2) per direction for the Q1 ansatz,
discretization.template.h:165).  Here everything is assembled with fully
vectorized NumPy over all cells at once and returned as a CSR-like graph
that ell.py packs into TPU-friendly padded ELL arrays.

DEBUG-mode consistency checks of the reference
(offline_data.template.h:1002-1104: Σm_i = |Ω|, zero row sums, symmetry of
m_ij, antisymmetry of interior c_ij) are exposed as `validate()` and run in
the unit tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .mesh import Boundary, Mesh

__all__ = ["Q1Assembly", "assemble", "SparseOfflineData"]


def _gauss_1d(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule on [0, 1]."""
    pts, wts = np.polynomial.legendre.leggauss(n)
    return 0.5 * (pts + 1.0), 0.5 * wts


def _shape_q1(dim: int, qpts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Q1 shape functions / gradients on the unit hypercube.

    qpts: [nq, dim] points. Returns (N [nq, nsh], dN [nq, nsh, dim]) with the
    deal.II vertex ordering (coordinate d toggles with stride 2**d).
    """
    nsh = 2**dim
    nq = qpts.shape[0]
    N = np.ones((nq, nsh))
    dN = np.ones((nq, nsh, dim))
    for i in range(nsh):
        for d in range(dim):
            bit = (i >> d) & 1
            xi = qpts[:, d]
            f = xi if bit else 1.0 - xi
            df = 1.0 if bit else -1.0
            N[:, i] *= f
            for dd in range(dim):
                dN[:, i, dd] *= df if dd == d else f
    return N, dN


def _cell_quadrature(dim: int, n1d: int) -> Tuple[np.ndarray, np.ndarray]:
    p, w = _gauss_1d(n1d)
    if dim == 1:
        return p[:, None], w
    grids = np.meshgrid(*([p] * dim), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=1)
    wgrids = np.meshgrid(*([w] * dim), indexing="ij")
    wts = np.ones(pts.shape[0])
    for g in wgrids:
        wts = wts * g.ravel()
    return pts, wts


@dataclasses.dataclass
class BoundaryGroup:
    """Boundary DoFs of one boundary-condition id, vectorized."""

    index: np.ndarray  # [k] node indices
    normal: np.ndarray  # [k, dim] averaged, normalized normals
    normal_mass: np.ndarray  # [k]
    boundary_mass: np.ndarray  # [k]
    position: np.ndarray  # [k, dim]


@dataclasses.dataclass
class SparseOfflineData:
    """Everything mesh-dependent, in node-graph (CSR) form."""

    dim: int
    n_nodes: int
    positions: np.ndarray  # [n, dim] nodal positions
    # CSR of the node-coupling graph *excluding* the diagonal:
    indptr: np.ndarray  # [n+1]
    indices: np.ndarray  # [nnz]
    cij: np.ndarray  # [nnz, dim]
    mij: np.ndarray  # [nnz]
    cii: np.ndarray  # [n, dim] diagonal of c
    mii: np.ndarray  # [n] diagonal of m
    lumped_mass: np.ndarray  # [n]
    measure_of_omega: float
    # Boundary map, grouped by Boundary id, in multimap application order:
    # a list of "rounds"; within a round all node indices are unique.  The
    # reference applies the (index-sorted) multimap sequentially
    # (hyperbolic_module.template.h:123-144); duplicated indices (corners)
    # land in later rounds.
    boundary_rounds: List[Dict[int, BoundaryGroup]]
    # masters[i] gives the representative node for constrained (periodic
    # slave) nodes; identity elsewhere.
    master: np.ndarray  # [n]
    is_constrained: np.ndarray  # [n] bool
    # hanging-node rows (h, a, b), u_h = (u_a + u_b)/2, already condensed
    # into the matrices above; kept for output/error interpolation:
    hanging: Optional[np.ndarray] = None
    # dG incidence matrix beta_ij [nnz] aligned with `indices`
    # (offline_data.template.h:809-940); None for continuous ansatz:
    incidence: Optional[np.ndarray] = None
    ansatz: str = "cG Q1"
    # Node-level lattice for non-Q1 tensor ansatz on structured meshes
    # (the refined lattice whose points are exactly the DoFs: spacing h/p
    # for cG Qp, h/(p+1) cell-interleaved for dG Qp) — lets the canvas
    # fast path (offline/structured.py) run every ansatz the way the
    # reference's single SIMD loop does (discretization.h:131-173,
    # hyperbolic_module.template.h:417-420).  None when the mesh has no
    # lattice or the cells are not lattice-aligned; cG Q1 keeps using the
    # mesh's vertex lattice directly.
    node_lattice_index: Optional[np.ndarray] = None  # [n, dim] int
    node_lattice_shape: Optional[Tuple[int, ...]] = None
    node_lattice_periodic: Optional[Tuple[bool, ...]] = None
    # max |lattice offset| of any stencil edge: p for cG Qp, max(p, 1)
    # for dG Qp (in-cell span p, cross-face span 1):
    stencil_reach: int = 1

    def validate(self, tol: float = 1e-10):
        """Reference DEBUG consistency checks (offline_data.template.h:1002-1104)."""
        total_mass = float(self.lumped_mass[~self.is_constrained].sum())
        assert abs(total_mass - self.measure_of_omega) < tol * max(
            1.0, self.measure_of_omega
        ), (total_mass, self.measure_of_omega)

        n = self.n_nodes
        # row sums of m equal lumped mass; c row sums are zero:
        for i in range(n):
            if self.is_constrained[i]:
                continue
            sl = slice(self.indptr[i], self.indptr[i + 1])
            msum = self.mii[i] + self.mij[sl].sum()
            assert abs(msum - self.lumped_mass[i]) < tol, i
            csum = self.cii[i] + self.cij[sl].sum(axis=0)
            assert np.abs(csum).max() < tol, (i, csum)

        # symmetry of m, antisymmetry of interior c:
        A: Dict[Tuple[int, int], int] = {}
        for i in range(n):
            for k in range(self.indptr[i], self.indptr[i + 1]):
                A[(i, int(self.indices[k]))] = k
        boundary_nodes = set()
        for rounds in self.boundary_rounds:
            for g in rounds.values():
                boundary_nodes.update(g.index.tolist())
        for (i, j), k in A.items():
            kT = A[(j, i)]
            assert abs(self.mij[k] - self.mij[kT]) < tol
            if i not in boundary_nodes or j not in boundary_nodes:
                assert np.abs(self.cij[k] + self.cij[kT]).max() < tol, (i, j)


def _vertex_masters(mesh: Mesh) -> Tuple[np.ndarray, np.ndarray]:
    """Union-find over periodic vertex pairs -> (master, is_constrained)."""
    n_raw = mesh.n_vertices
    master = np.arange(n_raw)
    constrained = np.zeros(n_raw, dtype=bool)
    if mesh.periodic_pairs is not None and len(mesh.periodic_pairs):
        for s, m in mesh.periodic_pairs:
            # union toward the smaller index, path-compress chains (corners)
            rs, rm = int(s), int(m)
            while master[rs] != rs:
                rs = master[rs]
            while master[rm] != rm:
                rm = master[rm]
            if rs != rm:
                hi, lo = max(rs, rm), min(rs, rm)
                master[hi] = lo
                constrained[hi] = True
        # path compression
        for i in range(n_raw):
            r = i
            while master[r] != r:
                r = master[r]
            master[i] = r
    return master, constrained


def assemble(
    mesh: Mesh, order_nodes: bool = True, ansatz: str = "cG Q1"
) -> SparseOfflineData:
    """Assemble all offline data for the chosen ansatz.

    cG Q1 takes the fast vertex-dof path below (with periodic and
    hanging-node constraint condensation); all other ansatz spaces go
    through the generic DoF-map path (_assemble_ansatz)."""
    if ansatz != "cG Q1":
        return _assemble_ansatz(mesh, ansatz)
    dim = mesh.dim
    nsh = 2**dim
    cells = mesh.cells
    nc = cells.shape[0]

    # ---- periodic identification --------------------------------------
    n_raw = mesh.n_vertices
    master, constrained = _vertex_masters(mesh)

    # ---- hanging-node constraints (AMR) --------------------------------
    # Expand every vertex into a weighted combination of free vertices:
    # identity for free/periodic-master vertices, (1/2, 1/2) over the two
    # parents for hanging nodes (mesh.refine_local).  Scattering cell
    # matrices through this expansion is the analog of deal.II's
    # AffineConstraints::distribute_local_to_global condensation the
    # reference relies on for adaptively refined meshes.
    hanging = mesh.hanging
    if hanging is not None and len(hanging):
        h, a, b = hanging[:, 0], hanging[:, 1], hanging[:, 2]
        pp = mesh.periodic_pairs
        if pp is not None and len(pp):
            # periodic + hanging COMPOSE through the shared master map
            # (the AffineConstraints analog, offline_data.template.h:
            # 186-416): hanging parents that are periodic slaves resolve
            # via master[].  Only refinement touching the periodic seam
            # itself (a hanging node whose parent edge lies IN the seam,
            # which would also need 2:1 balance across the wrap) is
            # rejected.
            on_seam = np.zeros(n_raw, bool)
            on_seam[np.asarray(pp).ravel()] = True
            # a refined cell AT the seam splits a periodic boundary
            # face; its new midpoints have no periodic partner (the
            # wrap neighbor stayed coarse), which would silently break
            # conformity across the identification:
            per_faces = mesh.boundary_faces[
                mesh.boundary_ids == Boundary.periodic
            ]
            seam_ok = on_seam[per_faces].all()
            if (
                (on_seam[a] & on_seam[b]).any()
                or constrained[h].any()
                or not seam_ok
            ):
                raise NotImplementedError(
                    "local refinement touching the periodic boundary "
                    "is not supported (split seam faces need matched "
                    "refinement + 2:1 balance across the wrap)"
                )
        else:
            assert not (constrained[a].any() or constrained[b].any())
        exp_idx = np.stack([master, master], axis=1)  # [n_raw, 2]
        exp_w = np.stack(
            [np.ones(n_raw), np.zeros(n_raw)], axis=1
        )
        exp_idx[h, 0], exp_idx[h, 1] = master[a], master[b]
        exp_w[h, 0] = exp_w[h, 1] = 0.5
        constrained[h] = True
        master[h] = master[a]  # representative for packing/output
        n_expand = 2
    else:
        exp_idx = master[:, None]
        exp_w = np.ones((n_raw, 1))
        n_expand = 1

    acells = master[cells]

    # ---- native fast path (C++, ryujin_tpu_torch/native/assembly.cc) ---------
    # Covers the hot case (cG Q1, no hanging nodes); identical math, with
    # the heavy cell-quadrature + CSR scatter loops compiled.
    if n_expand == 1:
        from .. import native

        out = native.q1_assemble(mesh.vertices, cells, acells)
        if out is not None:
            indptr, indices, omij, ocij, mii, cii, lumped, measure = out
            boundary_rounds = _build_boundary_map(mesh, master, constrained)
            return SparseOfflineData(
                dim=dim,
                n_nodes=n_raw,
                positions=mesh.vertices.copy(),
                indptr=indptr,
                indices=indices,
                cij=ocij,
                mij=omij,
                cii=cii,
                mii=mii,
                lumped_mass=lumped,
                measure_of_omega=measure,
                boundary_rounds=boundary_rounds,
                master=master,
                is_constrained=constrained,
                hanging=hanging,
            )

    # ---- quadrature ----------------------------------------------------
    qp, qw = _cell_quadrature(dim, 2)  # QGauss(2): exact for Q1 mass on affine cells
    N, dN = _shape_q1(dim, qp)  # [nq, nsh], [nq, nsh, dim]
    nq = qp.shape[0]

    X = mesh.vertices[cells]  # [nc, nsh, dim]
    # Jacobian J[q] = dx/dxi: [nc, nq, dim, dim]
    J = np.einsum("qsd,nse->nqed", dN, X)  # J[n,q,e,d] = d x_e / d xi_d
    detJ = np.linalg.det(J)
    assert (detJ > 0).all(), "negatively oriented or degenerate cells"
    Jinv = np.linalg.inv(J)  # [nc, nq, dim, dim] = d xi / d x
    # physical gradients: grad_e phi_s = dN[q,s,d] * dxi_d/dx_e
    gradN = np.einsum("qsd,nqde->nqse", dN, Jinv)  # [nc, nq, nsh, dim]
    JxW = detJ * qw[None, :]  # [nc, nq]

    measure = float(JxW.sum())

    # cell matrices
    cell_m = np.einsum("qi,qj,nq->nij", N, N, JxW)  # [nc, nsh, nsh]
    cell_c = np.einsum("qi,nqje,nq->nije", N, gradN, JxW)  # [nc,nsh,nsh,dim]

    # ---- scatter into COO, sum duplicates ------------------------------
    # order: for each cell, (i, j) with j fastest must match cell_m[n, i, j]
    if n_expand == 1:
        rows = np.repeat(acells[:, :, None], nsh, axis=2).ravel()
        cols = np.repeat(acells[:, None, :], nsh, axis=1).ravel()
        mvals = cell_m.ravel()
        cvals = cell_c.reshape(-1, dim)
    else:
        E_idx = exp_idx[cells]  # [nc, nsh, L]
        E_w = exp_w[cells]  # [nc, nsh, L]
        r_list, c_list, m_list, cc_list = [], [], [], []
        for li in range(n_expand):
            for lj in range(n_expand):
                w = E_w[:, :, li][:, :, None] * E_w[:, :, lj][:, None, :]
                keep = np.flatnonzero(w.ravel())
                if not len(keep):
                    continue
                ri = np.broadcast_to(
                    E_idx[:, :, li][:, :, None], (nc, nsh, nsh)
                ).ravel()
                cj = np.broadcast_to(
                    E_idx[:, :, lj][:, None, :], (nc, nsh, nsh)
                ).ravel()
                r_list.append(ri[keep])
                c_list.append(cj[keep])
                m_list.append((cell_m * w).ravel()[keep])
                cc_list.append((cell_c * w[..., None]).reshape(-1, dim)[keep])
        rows = np.concatenate(r_list)
        cols = np.concatenate(c_list)
        mvals = np.concatenate(m_list)
        cvals = np.concatenate(cc_list)

    key = rows.astype(np.int64) * n_raw + cols
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq_key, start = np.unique(key_s, return_index=True)
    m_sum = np.add.reduceat(mvals[order], start)
    c_sum = np.add.reduceat(cvals[order], start, axis=0)
    ui = (uniq_key // n_raw).astype(np.int64)
    uj = (uniq_key % n_raw).astype(np.int64)

    # drop entries touching constrained rows/cols (they were remapped already;
    # constrained nodes have no entries by construction)
    # build diag / offdiag split
    diag_mask = ui == uj
    di = ui[diag_mask]
    mii = np.zeros(n_raw)
    cii = np.zeros((n_raw, dim))
    mii[di] = m_sum[diag_mask]
    cii[di] = c_sum[diag_mask]

    oi, oj = ui[~diag_mask], uj[~diag_mask]
    omij = m_sum[~diag_mask]
    ocij = c_sum[~diag_mask]

    counts = np.bincount(oi, minlength=n_raw)
    indptr = np.zeros(n_raw + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    # entries are already sorted by (i, j)
    indices = oj
    lumped = mii.copy()
    np.add.at(lumped, oi, omij)

    # ---- boundary map ---------------------------------------------------
    boundary_rounds = _build_boundary_map(mesh, master, constrained)

    positions = mesh.vertices.copy()

    data = SparseOfflineData(
        dim=dim,
        n_nodes=n_raw,
        positions=positions,
        indptr=indptr,
        indices=indices,
        cij=ocij,
        mij=omij,
        cii=cii,
        mii=mii,
        lumped_mass=lumped,
        measure_of_omega=measure,
        boundary_rounds=boundary_rounds,
        master=master,
        is_constrained=constrained,
        hanging=hanging,
    )
    return data


def _build_boundary_map(
    mesh: Mesh, master: np.ndarray, constrained: np.ndarray
) -> List[Dict[int, BoundaryGroup]]:
    """Reference construct_boundary_map (offline_data.template.h:1171-1364).

    Per boundary face and per face DoF we accumulate a face-normal integral
    and boundary mass with a 3-point Gauss rule.  Entries of the same node
    are merged when they share a boundary id and their normals describe an
    angle with cos > 0.5; in 2D, unmerged slip pairs degrade to no_slip.
    """
    dim = mesh.dim
    entries: Dict[int, List] = {}

    if len(mesh.boundary_faces) == 0:
        return []

    if dim == 1:
        for f, bid in zip(mesh.boundary_faces, mesh.boundary_ids):
            if bid == Boundary.periodic:
                continue
            v = int(f[0])
            if constrained[v]:
                continue
            x = mesh.vertices[f[0]]
            # outward normal: -1 at left end, +1 at right end
            interior_mean = mesh.vertices.mean()
            nrm = np.array([1.0 if x[0] > interior_mean else -1.0])
            entries.setdefault(v, []).append(
                [nrm, 1.0, 1.0, int(bid), mesh.vertices[f[0]].copy()]
            )
    elif dim == 2:
        qp, qw = _gauss_1d(3)
        faces = mesh.boundary_faces
        ids = mesh.boundary_ids
        keep = ids != Boundary.periodic
        faces, ids = faces[keep], ids[keep]
        p0 = mesh.vertices[faces[:, 0]]  # [nf, 2]
        p1 = mesh.vertices[faces[:, 1]]
        tang = p1 - p0  # [nf, 2]
        # The outward normal: faces come from cells with deal.II local face
        # ordering; we orient by checking against the owning cell's interior.
        # Build a map face -> cell center.
        nrm = np.stack([tang[:, 1], -tang[:, 0]], axis=1)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        cellcenter = _face_cell_centers(mesh, faces)
        mid = 0.5 * (p0 + p1)
        flip = np.einsum("fd,fd->f", nrm, mid - cellcenter) < 0
        nrm[flip] *= -1.0
        length = np.linalg.norm(tang, axis=1)

        # per-face-per-endpoint shape integrals with 3-pt Gauss:
        # phi_0 = 1 - s, phi_1 = s on the face
        w_phi0 = float(np.sum((1 - qp) * qw))
        w_phi1 = float(np.sum(qp * qw))
        for k in range(len(faces)):
            for loc, wphi in ((0, w_phi0), (1, w_phi1)):
                v_raw = int(faces[k, loc])
                if constrained[v_raw]:
                    continue
                v = int(master[v_raw])
                bmass = wphi * length[k]
                entries.setdefault(v, []).append(
                    [
                        nrm[k] * bmass,
                        bmass,
                        bmass,
                        int(ids[k]),
                        mesh.vertices[v_raw].copy(),
                    ]
                )
    else:  # dim == 3
        qp1, qw1 = _gauss_1d(3)
        P, Q = np.meshgrid(qp1, qp1, indexing="ij")
        W = np.outer(qw1, qw1).ravel()
        S, T = P.ravel(), Q.ravel()
        # bilinear shape functions on the face (vertex order v0,v1,v2,v3
        # with deal.II face numbering: s toggles 0/1, t toggles 0/2)
        shp = np.stack(
            [(1 - S) * (1 - T), S * (1 - T), (1 - S) * T, S * T], axis=1
        )  # [nq, 4]
        dshp_s = np.stack([-(1 - T), (1 - T), -T, T], axis=1)
        dshp_t = np.stack([-(1 - S), -S, (1 - S), S], axis=1)
        faces = mesh.boundary_faces
        ids = mesh.boundary_ids
        keep = ids != Boundary.periodic
        faces, ids = faces[keep], ids[keep]
        XF = mesh.vertices[faces]  # [nf, 4, 3]
        xs = np.einsum("qs,fsd->fqd", dshp_s, XF)
        xt = np.einsum("qs,fsd->fqd", dshp_t, XF)
        nq_v = np.cross(xs, xt)  # [nf, nq, 3] area-weighted normal
        cellcenter = _face_cell_centers(mesh, faces)
        fmid = XF.mean(axis=1)
        sign = np.where(
            np.einsum("fd,fd->f", nq_v.mean(axis=1), fmid - cellcenter) < 0,
            -1.0,
            1.0,
        )
        nq_v *= sign[:, None, None]
        area_el = np.linalg.norm(nq_v, axis=2)  # [nf, nq]
        for k in range(len(faces)):
            for loc in range(4):
                v_raw = int(faces[k, loc])
                if constrained[v_raw]:
                    continue
                v = int(master[v_raw])
                phi = shp[:, loc]
                bmass = float(np.sum(phi * area_el[k] * W))
                nvec = np.einsum("q,qd->d", phi * W, nq_v[k])
                entries.setdefault(v, []).append(
                    [nvec, bmass, bmass, int(ids[k]), mesh.vertices[v_raw].copy()]
                )

    return _merge_boundary_entries(entries, dim)


def _merge_boundary_entries(
    entries: Dict[int, List], dim: int
) -> List[Dict[int, BoundaryGroup]]:
    # ---- filter/merge (offline_data.template.h:1295-1340) -------------
    final: Dict[int, List] = {}
    for v in sorted(entries.keys()):
        flist: List = []
        for e in entries[v]:
            new_normal, _, new_bmass, new_id, pt = e
            inserted = False
            for f in flist:
                normal, _, bmass, fid, _ = f
                if fid != new_id:
                    continue
                nn = np.linalg.norm(normal) * np.linalg.norm(new_normal)
                if nn > 0 and float(normal @ new_normal) / nn > 0.50:
                    f[0] = normal + new_normal
                    f[2] = bmass + new_bmass
                    inserted = True
                elif dim == 2 and new_id == Boundary.slip:
                    f[3] = Boundary.no_slip
                    e[3] = Boundary.no_slip
                    new_id = int(Boundary.no_slip)
            if not inserted:
                flist.append(e)
        final[v] = flist

    # normalize normals, split into rounds / id groups
    max_rounds = max((len(v) for v in final.values()), default=0)
    rounds: List[Dict[int, BoundaryGroup]] = []
    eps = np.finfo(np.float64).eps
    for r in range(max_rounds):
        groups: Dict[int, List] = {}
        for v, flist in final.items():
            if r >= len(flist):
                continue
            normal, _, bmass, fid, pt = flist[r]
            nmass = float(np.linalg.norm(normal)) + eps
            groups.setdefault(fid, []).append(
                (v, normal / nmass, nmass, bmass, pt)
            )
        gdict: Dict[int, BoundaryGroup] = {}
        for fid, lst in groups.items():
            gdict[fid] = BoundaryGroup(
                index=np.array([l[0] for l in lst], dtype=np.int64),
                normal=np.array([l[1] for l in lst]),
                normal_mass=np.array([l[2] for l in lst]),
                boundary_mass=np.array([l[3] for l in lst]),
                position=np.array([l[4] for l in lst]),
            )
        rounds.append(gdict)
    return rounds


def _face_cell_centers(mesh: Mesh, faces: np.ndarray) -> np.ndarray:
    """For each (boundary) face return the center of the owning cell."""
    dim = mesh.dim
    nv = mesh.n_vertices

    from .. import native

    owners = native.face_owners(dim, mesh.cells, nv, faces)
    if owners is not None:
        return mesh.vertices[mesh.cells[owners]].mean(axis=1)

    fsort = np.sort(faces, axis=1)
    if dim == 2:
        fkey = fsort[:, 0].astype(np.int64) * nv + fsort[:, 1]
    else:
        fkey = (
            (fsort[:, 0].astype(np.int64) * nv + fsort[:, 1]) * nv + fsort[:, 2]
        ) * nv + fsort[:, 3]

    from .mesh import _FACE_VERTICES

    cf = np.concatenate(
        [mesh.cells[:, fl] for fl in _FACE_VERTICES[dim]], axis=0
    )
    owner = np.tile(np.arange(mesh.n_cells), len(_FACE_VERTICES[dim]))
    cfs = np.sort(cf, axis=1)
    if dim == 2:
        ckey = cfs[:, 0].astype(np.int64) * nv + cfs[:, 1]
    else:
        ckey = (
            (cfs[:, 0].astype(np.int64) * nv + cfs[:, 1]) * nv + cfs[:, 2]
        ) * nv + cfs[:, 3]
    order = np.argsort(ckey)
    pos = np.searchsorted(ckey[order], fkey)
    cell_ids = owner[order[pos]]
    return mesh.vertices[mesh.cells[cell_ids]].mean(axis=1)


def assemble_stiffness(mesh: Mesh, data: SparseOfflineData):
    """Assemble the gradient-product family K^{ab}_ij = int d_a phi_i d_b phi_j.

    Needed by the Navier-Stokes parabolic solver (the reference evaluates
    the stress/diffusion bilinear forms matrix-free with FEEvaluation,
    navier_stokes/parabolic_solver.template.h:485-560; here the operators
    become stencil matvecs with these statically assembled coefficients).

    Returns (kab_offdiag [nnz, dim, dim], kab_diag [n, dim, dim]) aligned
    with data.indptr/indices.
    """
    dim = mesh.dim
    nsh = 2**dim
    cells = mesh.cells
    acells = data.master[cells]
    n_raw = data.n_nodes

    qp, qw = _cell_quadrature(dim, 2)
    N, dN = _shape_q1(dim, qp)
    X = mesh.vertices[cells]
    J = np.einsum("qsd,nse->nqed", dN, X)
    detJ = np.linalg.det(J)
    Jinv = np.linalg.inv(J)
    gradN = np.einsum("qsd,nqde->nqse", dN, Jinv)
    JxW = detJ * qw[None, :]

    cell_k = np.einsum("nqia,nqjb,nq->nijab", gradN, gradN, JxW)

    rows = np.repeat(acells[:, :, None], nsh, axis=2).ravel()
    cols = np.repeat(acells[:, None, :], nsh, axis=1).ravel()
    kvals = cell_k.reshape(-1, dim, dim)

    key = rows.astype(np.int64) * n_raw + cols
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq_key, start = np.unique(key_s, return_index=True)
    k_sum = np.add.reduceat(kvals[order], start, axis=0)
    ui = (uniq_key // n_raw).astype(np.int64)
    uj = (uniq_key % n_raw).astype(np.int64)

    diag_mask = ui == uj
    kab_diag = np.zeros((n_raw, dim, dim))
    kab_diag[ui[diag_mask]] = k_sum[diag_mask]
    kab_off = k_sum[~diag_mask]
    # entries sorted by (i, j) exactly like assemble(); verify alignment:
    oi, oj = ui[~diag_mask], uj[~diag_mask]
    assert np.array_equal(oj, data.indices), "stiffness sparsity mismatch"
    return kab_off, kab_diag


# Backwards-compatible alias
Q1Assembly = SparseOfflineData


# ---------------------------------------------------------------------------
# Generic ansatz assembly (cG Q2/Q3, dG Q0-Q3)
# ---------------------------------------------------------------------------


def _assemble_ansatz(mesh: Mesh, ansatz: str) -> SparseOfflineData:
    """Assemble offline data for higher-order / discontinuous elements.

    Mirrors offline_data.template.h:419-940: QGauss(p+1) volume terms for
    m_ij and c_ij; for the discontinuous ansatz additionally the interface
    terms  c_ij -= 1/2 int_f n phi_i phi_j  (both dofs in-cell) and
    c_ij += 1/2 int_f n phi_i phi_j^nbr  (coupling), plus the nodal
    incidence matrix beta_ij = hd_ij^(relax/dim) between colocated face
    dofs (offline_data.template.h:581-663, 809-940).
    """
    from .ansatz import (
        build_dof_map, face_slots, gauss_lobatto_points, lagrange_1d,
        parse_ansatz, shape_qp,
    )

    continuous, p = parse_ansatz(ansatz)
    dim = mesh.dim
    if mesh.hanging is not None and len(mesh.hanging):
        raise NotImplementedError(f"AMR + '{ansatz}' not supported")

    dm = build_dof_map(mesh, ansatz)
    nc = mesh.n_cells
    n = dm.n_dofs
    n_loc = dm.n_loc
    cells = mesh.cells

    # periodic identification over dofs (vertex masters + paired edge dofs)
    master, constrained = _ansatz_dof_masters(mesh, dm, continuous, p)

    n1d = max(p + 1, 1)
    qp, qw = _cell_quadrature(dim, n1d)
    N, dN = shape_qp(dim, p, qp)
    N1, dN1 = _shape_q1(dim, qp)  # geometry (sub-parametric Q1 map)

    X = mesh.vertices[cells]
    J = np.einsum("qsd,nse->nqed", dN1, X)
    detJ = np.linalg.det(J)
    assert (detJ > 0).all(), "negatively oriented or degenerate cells"
    Jinv = np.linalg.inv(J)
    gradN = np.einsum("qsd,nqde->nqse", dN, Jinv)
    JxW = detJ * qw[None, :]
    measure = float(JxW.sum())

    cell_m = np.einsum("qi,qj,nq->nij", N, N, JxW)
    cell_c = np.einsum("qi,nqje,nq->nije", N, gradN, JxW)

    acd = master[dm.cell_dofs]
    rows_l = [np.repeat(acd[:, :, None], n_loc, axis=2).ravel()]
    cols_l = [np.repeat(acd[:, None, :], n_loc, axis=1).ravel()]
    m_l = [cell_m.ravel()]
    c_l = [cell_c.reshape(-1, dim)]
    inc_l = [np.zeros(rows_l[0].shape[0])]

    inc_rows = []  # (i, j) pairs needing incidence values
    if not continuous:
        fr, fc, fcv, finc = _dg_face_terms(mesh, dm, p)
        rows_l.append(fr)
        cols_l.append(fc)
        m_l.append(np.zeros(len(fr)))
        c_l.append(fcv)
        inc_l.append(np.zeros(len(fr)))
        inc_rows = finc  # [(i, j)] colocated pairs, value filled below

    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    mvals = np.concatenate(m_l)
    cvals = np.concatenate(c_l)

    key = rows.astype(np.int64) * n + cols
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq_key, start = np.unique(key_s, return_index=True)
    m_sum = np.add.reduceat(mvals[order], start)
    c_sum = np.add.reduceat(cvals[order], start, axis=0)
    ui = (uniq_key // n).astype(np.int64)
    uj = (uniq_key % n).astype(np.int64)

    diag_mask = ui == uj
    di = ui[diag_mask]
    mii = np.zeros(n)
    cii = np.zeros((n, dim))
    mii[di] = m_sum[diag_mask]
    cii[di] = c_sum[diag_mask]

    oi, oj = ui[~diag_mask], uj[~diag_mask]
    omij = m_sum[~diag_mask]
    ocij = c_sum[~diag_mask]

    counts = np.bincount(oi, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = oj
    # lumped mass from the mass matrix only (face terms carry zero mass):
    lumped = mii.copy()
    np.add.at(lumped, oi, omij)

    incidence = None
    if not continuous and inc_rows:
        # beta_ij = hd_ij^(relax/dim), hd_ij = (m_i + m_j) / (2 |Omega|);
        # relax = 0.5 for even degree, 0.0 (constant 1) for odd degree
        # (offline_data.template.h:46-58, 900-930):
        relax = 0.5 if p % 2 == 0 else 0.0
        incidence = np.zeros(len(oi))
        ir = np.array([x[0] for x in inc_rows], np.int64)
        jr = np.array([x[1] for x in inc_rows], np.int64)
        hd = 0.5 * (lumped[ir] + lumped[jr]) / measure
        vals = hd ** (relax / dim)
        # locate (ir, jr) in the offdiag CSR:
        okey = oi * n + oj
        pos = np.searchsorted(okey, ir * n + jr)
        assert np.array_equal(okey[pos], ir * n + jr)
        np.maximum.at(incidence, pos, vals)

    boundary_rounds = _boundary_map_ansatz(mesh, dm, p, master, constrained)

    nl = _node_lattice(mesh, dm, continuous, p)
    data = SparseOfflineData(
        dim=dim,
        n_nodes=n,
        positions=dm.positions.copy(),
        indptr=indptr,
        indices=indices,
        cij=ocij,
        mij=omij,
        cii=cii,
        mii=mii,
        lumped_mass=lumped,
        measure_of_omega=measure,
        boundary_rounds=boundary_rounds,
        master=master,
        is_constrained=constrained,
        incidence=incidence,
        ansatz=ansatz,
        node_lattice_index=None if nl is None else nl[0],
        node_lattice_shape=None if nl is None else nl[1],
        node_lattice_periodic=None if nl is None else nl[2],
        stencil_reach=max(p, 1),
    )
    return data


def _interior_face_pairs(mesh: Mesh):
    """All interior faces as ((cell_a, floc_a), (cell_b, floc_b)) pairs.

    Faces are keyed by periodic vertex masters, so a pair of periodic
    boundary faces shows up as one interior pair (the analog of the
    reference's has_periodic_neighbor handling in the dG face assembly,
    offline_data.template.h:592-640)."""
    from .mesh import _FACE_VERTICES

    vmaster, _ = _vertex_masters(mesh)
    fv = _FACE_VERTICES[mesh.dim]
    table: Dict[tuple, List[Tuple[int, int]]] = {}
    for f_loc, lv in enumerate(fv):
        fverts = vmaster[mesh.cells[:, lv]]
        for c in range(mesh.n_cells):
            key = tuple(sorted(fverts[c].tolist()))
            table.setdefault(key, []).append((c, f_loc))
    return [v for v in table.values() if len(v) == 2]


def _mean0(x):
    """x.mean(axis=0) as numpy forms it (np.add.reduce, then the division
    by the count), without mean's dispatch, which the per-face loops
    below would pay some hundred thousand times."""
    return np.add.reduce(x, axis=0) / x.shape[0]


def _centred(x):
    """x minus its mean over the first axis."""
    return x - _mean0(x)


def _close(a, b):
    """np.allclose(a, b) at its default tolerances (rtol 1e-5, atol 1e-8)
    for finite a and b, by its own comparison |a - b| <= atol + rtol |b|,
    without its dispatch."""
    return bool((np.abs(a - b) <= 1e-8 + 1e-5 * np.abs(b)).all())


def _dg_face_terms(mesh: Mesh, dm, p: int):
    """Interface contributions to c_ij for the discontinuous ansatz.

    Returns (rows, cols, cvals, incidence_pairs).  For each interior face
    with owner A and neighbor B (and vice versa — both orientations are
    emitted):
      in-cell:   c[i, j] -= 1/2 int_f n_A phi_i phi_j      (i, j in A)
      coupling:  c[i, j] += 1/2 int_f n_A phi_i phi_j^B    (i in A, j in B)
    incidence pairs are the colocated (i in A, j in B) face-dof pairs.
    """
    from .ansatz import face_slots, gauss_lobatto_points, lagrange_1d

    dim = mesh.dim
    slots = face_slots(dim, p)
    pairs = _interior_face_pairs(mesh)
    rows, cols, cvals, inc = [], [], [], []

    if dim == 1:
        for (ca, fa), (cb, fb) in pairs:
            for (A, fA), (B, fB) in (((ca, fa), (cb, fb)),
                                     ((cb, fb), (ca, fa))):
                dofs_A = dm.cell_dofs[A, slots[fA]]
                dofs_B = dm.cell_dofs[B, slots[fB]]
                n_out = -1.0 if fA == 0 else 1.0
                i, j = int(dofs_A[0]), int(dofs_B[0])
                # phi values at the face point are 1 for the face dof
                rows += [i, i]
                cols += [i, j]
                cvals += [[-0.5 * n_out], [0.5 * n_out]]
                inc.append((i, j))
        return (np.array(rows, np.int64), np.array(cols, np.int64),
                np.array(cvals), inc)

    if dim == 3:
        return _dg_face_terms_3d(mesh, dm, p, pairs)

    # dim == 2: 1D Lagrange basis on the face at QGauss(p+1) points
    nodes = gauss_lobatto_points(p)
    qp1, qw1 = _gauss_1d(max(p + 1, 2))
    V, _ = lagrange_1d(nodes, qp1)  # [nq, p+1]
    phi2 = np.einsum("qi,qj,q->ij", V, V, qw1)  # unscaled int phi_i phi_j

    for (ca, fa), (cb, fb) in pairs:
        for (A, fA), (B, fB) in (((ca, fa), (cb, fb)), ((cb, fb), (ca, fa))):
            dofs_A = dm.cell_dofs[A, slots[fA]]
            dofs_B = dm.cell_dofs[B, slots[fB]]
            # geometric face endpoints from the mesh (dof positions are off
            # the face for p = 0, where the single dof is the cell center):
            from .mesh import _FACE_VERTICES

            fverts_A = mesh.cells[A, _FACE_VERTICES[2][fA]]
            pa = mesh.vertices[fverts_A]
            if p > 0:
                pda = dm.positions[dofs_A]
                pdb = dm.positions[dofs_B]
                # match B's tangential order to A's; comparison is
                # translation-invariant so periodic partner faces work:
                rel_a = _centred(pda)
                rel_b = _centred(pdb)
                if not _close(rel_a, rel_b):
                    dofs_B = dofs_B[::-1]
                    rel_b = rel_b[::-1]
                assert _close(rel_a, rel_b), "face dof mismatch"
                pa = pda
            t = pa[-1] - pa[0]
            length = float(np.linalg.norm(t))
            nrm = np.array([t[1], -t[0]]) / length
            center = _mean0(mesh.vertices[mesh.cells[A]])
            if nrm @ (0.5 * (pa[0] + pa[-1]) - center) < 0:
                nrm = -nrm
            block = phi2 * length  # int_f phi_i phi_j ds
            n1 = p + 1
            ii = np.repeat(dofs_A, n1)
            jj_in = np.tile(dofs_A, n1)
            jj_cp = np.tile(dofs_B, n1)
            flat = block.ravel()
            rows.append(np.concatenate([ii, ii]))
            cols.append(np.concatenate([jj_in, jj_cp]))
            cvals.append(np.concatenate([
                -0.5 * flat[:, None] * nrm[None, :],
                0.5 * flat[:, None] * nrm[None, :],
            ]))
            inc += list(zip(dofs_A.tolist(), dofs_B.tolist()))
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(cvals), inc)


def _dg_face_terms_3d(mesh: Mesh, dm, p: int, pairs):
    """3D interface contributions to c_ij for the discontinuous ansatz.

    Bilinear (possibly non-planar) quad faces: per-quadrature-point
    area-weighted normals from the cross product of the tangents, tensor
    Lagrange basis on the face (s, t) lattice.  Neighbor face dofs are
    matched to the owner's lattice by colocated positions (translation
    invariant so periodic partner faces work)."""
    from .ansatz import face_slots, gauss_lobatto_points, lagrange_1d
    from .mesh import _FACE_VERTICES

    slots = face_slots(3, p)
    n1 = p + 1
    nsf = n1 * n1
    nodes = gauss_lobatto_points(p)
    qp1, qw1 = _gauss_1d(max(p + 1, 2))
    nq1 = len(qp1)
    V1, _ = lagrange_1d(nodes, qp1)  # [nq1, n1]
    S = np.tile(qp1, nq1)            # s fastest
    T = np.repeat(qp1, nq1)
    W = (qw1[None, :] * qw1[:, None]).ravel()  # [t, s] -> s fastest
    # phiF[q, k] for face dof k = i_s + n1 * i_t:
    phiF = np.einsum("qi,qj->qji", V1[np.tile(np.arange(nq1), nq1)],
                     V1[np.repeat(np.arange(nq1), nq1)]).reshape(-1, nsf)
    # bilinear geometry shape functions in the (s, t) corner order:
    gN = np.stack([(1 - S) * (1 - T), S * (1 - T), (1 - S) * T, S * T], 1)
    gNs = np.stack([-(1 - T), (1 - T), -T, T], 1)
    gNt = np.stack([-(1 - S), -S, (1 - S), S], 1)

    rows, cols, cvals, inc = [], [], [], []
    for (ca, fa), (cb, fb) in pairs:
        for (A, fA), (B, fB) in (((ca, fa), (cb, fb)), ((cb, fb), (ca, fa))):
            dofs_A = dm.cell_dofs[A, slots[fA]]
            dofs_B = dm.cell_dofs[B, slots[fB]]
            if p > 0:
                # permute B's dofs onto A's lattice by relative position
                pa = dm.positions[dofs_A]
                pb = dm.positions[dofs_B]
                ra = pa - pa.mean(axis=0)
                rb = pb - pb.mean(axis=0)
                d2 = ((ra[:, None, :] - rb[None, :, :]) ** 2).sum(-1)
                perm = np.argmin(d2, axis=1)
                assert len(np.unique(perm)) == nsf, "face dof match failed"
                assert d2[np.arange(nsf), perm].max() < 1e-20
                dofs_B = dofs_B[perm]
            XF = mesh.vertices[mesh.cells[A, _FACE_VERTICES[3][fA]]]
            xs = gNs @ XF  # [nq, 3]
            xt = gNt @ XF
            nvec = np.cross(xs, xt)  # area-weighted
            center = mesh.vertices[mesh.cells[A]].mean(axis=0)
            fmid = (gN @ XF).mean(axis=0)
            if nvec.mean(axis=0) @ (fmid - center) < 0:
                nvec = -nvec
            # blockv[i, j, d] = int_f n_d phi_i phi_j
            blockv = np.einsum("qi,qj,qd,q->ijd", phiF, phiF, nvec, W)
            ii = np.repeat(dofs_A, nsf)
            rows.append(np.concatenate([ii, ii]))
            cols.append(np.concatenate([np.tile(dofs_A, nsf),
                                        np.tile(dofs_B, nsf)]))
            flat = blockv.reshape(-1, 3)
            cvals.append(np.concatenate([-0.5 * flat, 0.5 * flat]))
            inc += list(zip(dofs_A.tolist(), dofs_B.tolist()))
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(cvals), inc)


def _boundary_map_ansatz(mesh: Mesh, dm, p: int, master=None,
                         constrained=None):
    """Boundary map over face dofs for the generic ansatz path."""
    if master is None:
        master = np.arange(dm.n_dofs)
    if constrained is None:
        constrained = np.zeros(dm.n_dofs, bool)
    from .ansatz import gauss_lobatto_points, lagrange_1d

    dim = mesh.dim
    entries: Dict[int, List] = {}
    if len(mesh.boundary_faces) == 0:
        return []

    if dim == 1:
        interior_mean = mesh.vertices.mean()
        for fd, f, bid in zip(dm.face_dofs, mesh.boundary_faces,
                              mesh.boundary_ids):
            if bid == Boundary.periodic:
                continue
            v = int(fd[0])
            if constrained[v]:
                continue
            x = mesh.vertices[f[0]]
            nrm = np.array([1.0 if x[0] > interior_mean else -1.0])
            entries.setdefault(v, []).append(
                [nrm, 1.0, 1.0, int(bid), dm.positions[v].copy()]
            )
        return _merge_boundary_entries(entries, dim)

    if dim == 3:
        return _boundary_map_ansatz_3d(mesh, dm, p, master, constrained)

    nodes = gauss_lobatto_points(p)
    qp1, qw1 = _gauss_1d(max(p + 1, 3))
    V, _ = lagrange_1d(nodes, qp1)
    wphi = np.einsum("qi,q->i", V, qw1)  # int phi_i over unit face

    faces = mesh.boundary_faces
    ids = mesh.boundary_ids
    fdofs = dm.face_dofs
    keep = ids != Boundary.periodic
    faces, ids, fdofs = faces[keep], ids[keep], fdofs[keep]
    p0 = mesh.vertices[faces[:, 0]]
    p1 = mesh.vertices[faces[:, 1]]
    tang = p1 - p0
    nrm = np.stack([tang[:, 1], -tang[:, 0]], axis=1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    cellcenter = _face_cell_centers(mesh, faces)
    mid = 0.5 * (p0 + p1)
    flip = np.einsum("fd,fd->f", nrm, mid - cellcenter) < 0
    nrm[flip] *= -1.0
    length = np.linalg.norm(tang, axis=1)

    for k in range(len(faces)):
        for loc in range(p + 1):
            v_raw = int(fdofs[k, loc])
            if constrained[v_raw]:
                continue
            v = int(master[v_raw])
            bmass = float(wphi[loc]) * length[k]
            entries.setdefault(v, []).append(
                [nrm[k] * bmass, bmass, bmass, int(ids[k]),
                 dm.positions[v_raw].copy()]
            )
    return _merge_boundary_entries(entries, dim)


def _boundary_map_ansatz_3d(mesh: Mesh, dm, p: int, master, constrained):
    """3D boundary map over face dofs: per-dof face-normal integral and
    boundary mass on bilinear quad faces with a tensor Gauss rule, in the
    owning cell's face frame (matching dm.face_dofs)."""
    from .ansatz import (boundary_face_owners, gauss_lobatto_points,
                         lagrange_1d)
    from .mesh import _FACE_VERTICES

    n1 = p + 1
    nsf = n1 * n1
    nodes = gauss_lobatto_points(p)
    qp1, qw1 = _gauss_1d(max(p + 1, 3))
    nq1 = len(qp1)
    V1, _ = lagrange_1d(nodes, qp1)
    S = np.tile(qp1, nq1)
    T = np.repeat(qp1, nq1)
    W = (qw1[None, :] * qw1[:, None]).ravel()
    phiF = np.einsum("qi,qj->qji", V1[np.tile(np.arange(nq1), nq1)],
                     V1[np.repeat(np.arange(nq1), nq1)]).reshape(-1, nsf)
    gN = np.stack([(1 - S) * (1 - T), S * (1 - T), (1 - S) * T, S * T], 1)
    gNs = np.stack([-(1 - T), (1 - T), -T, T], 1)
    gNt = np.stack([-(1 - S), -S, (1 - S), S], 1)

    owners = boundary_face_owners(mesh)
    entries: Dict[int, List] = {}
    for k, ((c, f_loc), bid) in enumerate(zip(owners, mesh.boundary_ids)):
        if bid == Boundary.periodic:
            continue
        fdofs = dm.face_dofs[k]
        XF = mesh.vertices[mesh.cells[c, _FACE_VERTICES[3][f_loc]]]
        xs = gNs @ XF
        xt = gNt @ XF
        nvec = np.cross(xs, xt)
        center = mesh.vertices[mesh.cells[c]].mean(axis=0)
        fmid = (gN @ XF).mean(axis=0)
        if nvec.mean(axis=0) @ (fmid - center) < 0:
            nvec = -nvec
        area_el = np.linalg.norm(nvec, axis=1)
        for loc in range(nsf):
            v_raw = int(fdofs[loc])
            if constrained[v_raw]:
                continue
            v = int(master[v_raw])
            phi = phiF[:, loc]
            bmass = float(np.sum(phi * area_el * W))
            nrm = np.einsum("q,qd->d", phi * W, nvec)
            entries.setdefault(v, []).append(
                [nrm, bmass, bmass, int(bid), dm.positions[v_raw].copy()]
            )
    return _merge_boundary_entries(entries, 3)


def _ansatz_dof_masters_3d(mesh, dm, p, master, constrained, vmaster):
    """Periodic edge/face dof identification for 3D cG Qp (p >= 2).

    The analog of deal.II's AffineConstraints periodicity for
    higher-order elements (offline_data.template.h:186-416): edges are
    paired slot-wise through the vertex correspondence (orientation from
    the low->high global-id parameterization of build_dof_map), faces
    through the corner correspondence expressed in each face's CANONICAL
    frame (origin at the min-global-id corner, u toward the smaller-id
    neighbor — _build_dof_map_cg_3d).  Cell interiors are never shared.
    """
    from .ansatz import _EDGE_LOCAL_3D
    from .mesh import _FACE_VERTICES

    nv = mesh.n_vertices
    cells = mesh.cells
    n_e = p - 1
    n_f = (p - 1) ** 2

    # unique edges / faces exactly as _build_dof_map_cg_3d enumerates them
    ce = cells[:, _EDGE_LOCAL_3D]  # [nc, 12, 2]
    uniq_e = np.unique(np.sort(ce, axis=2).reshape(-1, 2), axis=0)
    n_edges = len(uniq_e)
    edge_dof0 = nv + np.arange(n_edges, dtype=np.int64) * n_e
    face_local = np.stack(_FACE_VERTICES[3])
    cf = cells[:, face_local]  # [nc, 6, 4] in (s, t) corner order k=s+2t
    cf_sorted = np.sort(cf, axis=2).reshape(-1, 4)
    uniq_f, uidx = np.unique(cf_sorted, axis=0, return_index=True)
    # a representative UNsorted corner list per unique face (the frame
    # construction only uses global-id comparisons, so any incident
    # cell's corner order yields the same dof grid):
    rep_f = cf.reshape(-1, 4)[uidx]
    n_faces = len(uniq_f)
    face_dof0 = nv + n_edges * n_e + np.arange(n_faces, dtype=np.int64) * n_f

    pos = mesh.vertices
    scale = max(float(np.abs(pos).max()), 1.0)

    def _sig(vecs):
        """Translation-invariant geometric signature: rounded relative
        position vectors.  Periodic images share master-vertex keys AND
        this signature; two DISTINCT edges/faces that merely touch the
        same master vertices (e.g. the two x-edges of a 2-cell periodic
        line) differ in it."""
        return tuple(np.round(np.ravel(vecs) / scale, 9).tolist())

    # ---- edges ----------------------------------------------------------
    mkey_e = np.sort(vmaster[uniq_e], axis=1)
    key_e = mkey_e[:, 0].astype(np.int64) * nv + mkey_e[:, 1]
    order = np.argsort(key_e, kind="stable")
    ks = key_e[order]
    starts = np.flatnonzero(np.concatenate([[True], ks[1:] != ks[:-1]]))
    lens = np.diff(np.concatenate([starts, [len(ks)]]))

    def _edge_sig(g):
        a, b = uniq_e[g]
        # orient from the endpoint whose master is the smaller id:
        if vmaster[a] > vmaster[b]:
            a, b = b, a
        return _sig(pos[b] - pos[a])

    for s0_, ln in zip(starts, lens):
        if ln < 2:
            continue
        cand = order[s0_ : s0_ + ln]
        subs: Dict[tuple, list] = {}
        for g in cand:
            subs.setdefault(_edge_sig(g), []).append(g)
        for group in subs.values():
            if len(group) < 2:
                continue
            group = np.asarray(group)
            own = np.array([
                np.array_equal(np.sort(vmaster[uniq_e[g]]),
                               np.sort(uniq_e[g]))
                for g in group
            ])
            mg = group[np.argmax(own)] if own.any() else group[0]
            a_m, b_m = uniq_e[mg]  # sorted: master dofs run from a_m
            for g_ in group:
                if g_ == mg:
                    continue
                a_s, b_s = uniq_e[g_]
                # slave dofs run from its lower global id; same orientation
                # iff that end's image is the master edge's low end:
                img_lo = vmaster[min(a_s, b_s)]
                same = vmaster[int(a_m)] == img_lo
                for k in range(n_e):
                    k_m = k if same else n_e - 1 - k
                    master[edge_dof0[g_] + k] = edge_dof0[mg] + k_m
                    constrained[edge_dof0[g_] + k] = True

    # ---- faces ----------------------------------------------------------
    if n_f == 0:
        return master, constrained

    def dof_grid(gf, base):
        """[p-1, p-1] dof ids indexed by the face's (s, t) lattice
        (i_s, i_t in 1..p-1), mirroring _build_dof_map_cg_3d."""
        k0 = int(np.argmin(gf))
        s0, t0 = k0 & 1, k0 >> 1
        k_s = (1 - s0) + 2 * t0
        k_t = s0 + 2 * (1 - t0)
        u_is_s = gf[k_s] < gf[k_t]
        grid = np.zeros((p - 1, p - 1), np.int64)
        for i_s in range(1, p):
            for i_t in range(1, p):
                cs = i_s if s0 == 0 else p - i_s
                ct = i_t if t0 == 0 else p - i_t
                a, b = (cs, ct) if u_is_s else (ct, cs)
                grid[i_s - 1, i_t - 1] = base + (a - 1) + (p - 1) * (b - 1)
        return grid

    mkey_f = np.sort(vmaster[uniq_f], axis=1)
    key_f = (
        (mkey_f[:, 0].astype(np.int64) * nv + mkey_f[:, 1]) * nv
        + mkey_f[:, 2]
    ) * nv + mkey_f[:, 3]
    order = np.argsort(key_f, kind="stable")
    ks = key_f[order]
    starts = np.flatnonzero(np.concatenate([[True], ks[1:] != ks[:-1]]))
    lens = np.diff(np.concatenate([starts, [len(ks)]]))
    def _face_sig(g):
        gf = rep_f[g]
        o = np.argsort(vmaster[gf], kind="stable")
        pts = pos[gf[o]]
        return _sig(pts[1:] - pts[0])

    for s0_, ln in zip(starts, lens):
        if ln < 2:
            continue
        cand = order[s0_ : s0_ + ln]
        fsubs: Dict[tuple, list] = {}
        for g in cand:
            fsubs.setdefault(_face_sig(g), []).append(g)
        for group in fsubs.values():
            if len(group) < 2:
                continue
            group = np.asarray(group)
            own = np.array([
                np.array_equal(np.sort(vmaster[rep_f[g]]),
                               np.sort(rep_f[g]))
                for g in group
            ])
            mg = group[np.argmax(own)] if own.any() else group[0]
            gf_m = rep_f[mg]
            grid_m = dof_grid(gf_m, face_dof0[mg])
            vm_m = vmaster[gf_m]
            for g_ in group:
                if g_ == mg:
                    continue
                gf_s = rep_f[g_]
                grid_s = dof_grid(gf_s, face_dof0[g_])
                # corner correspondence through the vertex masters: slave
                # corner k (bits (ks_, kt_)) -> master corner position j
                c2m = np.array([
                    int(np.flatnonzero(vm_m == vmaster[v])[0]) for v in gf_s
                ])
                # sigma over (i_s, i_t): derived from where (0,0) and the
                # two unit steps land
                j00 = c2m[0]
                js0, jt0 = j00 & 1, j00 >> 1
                j10 = c2m[1]  # slave s-step
                swap = ((j10 & 1) == js0)  # s-step moved master's t bit
                for i_s in range(1, p):
                    for i_t in range(1, p):
                        # master lattice coords of the slave point: flips
                        # apply to the master coordinate that the slave
                        # axis maps to
                        if swap:
                            ms_ = p - i_t if js0 else i_t
                            mt_ = p - i_s if jt0 else i_s
                        else:
                            ms_ = p - i_s if js0 else i_s
                            mt_ = p - i_t if jt0 else i_t
                        s_dof = grid_s[i_s - 1, i_t - 1]
                        m_dof = grid_m[ms_ - 1, mt_ - 1]
                        master[s_dof] = m_dof
                        constrained[s_dof] = True
    return master, constrained


def _node_lattice(mesh: Mesh, dm, continuous: bool, p: int):
    """Integer lattice coordinates of every DoF of a tensor-product ansatz
    on a structured mesh.

    The DoFs of cG Qp on a vertex lattice (nx, ny[, nz]) are exactly the
    points of the p-refined lattice (p*(nx-1)+1, ...); the DoFs of dG Qp
    are the (p+1)-per-cell interleaved lattice ((p+1)*(nx-1), ...) with
    coincident interface nodes at distinct lattice positions.  Returns
    (index [n_dofs, dim], shape, periodic_flags) or None when the mesh
    carries no lattice or its cells are not axis-aligned on it.

    This is what lets the canvas backend treat every ansatz like the
    reference's one SIMD loop treats them (discretization.h:131-173):
    neighbor access stays a static shift, just with reach p instead of 1.
    """
    if mesh.structured_index is None or mesh.structured_shape is None:
        return None
    si_v = np.asarray(mesh.structured_index)
    lat = np.asarray(mesh.structured_shape, dtype=np.int64)
    dim = mesh.dim
    cells = mesh.cells
    o = si_v[cells[:, 0]]  # [nc, dim] cell lattice origins
    # orientation: the deal.II bit-toggle corner v_{2^d} must sit at
    # origin + unit vector d for EVERY cell (lattice generators construct
    # cells this way; anything else falls back to ELL/multiblock):
    for d in range(dim):
        dv = si_v[cells[:, 1 << d]] - o
        want = np.zeros(dim, np.int64)
        want[d] = 1
        if not (dv == want[None, :]).all():
            return None
    n1 = p + 1
    # local integer coords per lexicographic slot (x fastest), matching
    # ansatz._local_lattice / cell_dofs ordering:
    s = np.arange(dm.n_loc)
    loc = np.stack([(s // n1**d) % n1 for d in range(dim)], axis=1)
    stride = p if continuous else p + 1
    node_si = np.zeros((dm.n_dofs, dim), np.int64)
    node_si[dm.cell_dofs.reshape(-1)] = (
        stride * o[:, None, :] + loc[None, :, :]
    ).reshape(-1, dim)
    shape = tuple(
        int(stride * (lat[d] - 1) + (1 if continuous else 0))
        for d in range(dim)
    )
    # explicit periodic flags from the vertex lattice: the far face is
    # periodic iff all its vertices are constrained slaves.  (cG infers
    # this from the constrained far-face DoFs too, but dG has no
    # constrained DoFs at all — its wrap shows up only in the face
    # coupling, so the canvas needs the explicit flag.)
    vmaster, vconstr = _vertex_masters(mesh)
    del vmaster
    periodic = []
    for d in range(dim):
        hi = si_v[:, d] == lat[d] - 1
        periodic.append(bool(hi.any()) and bool(vconstr[hi].all()))
    return node_si, shape, tuple(periodic)


def _ansatz_dof_masters(mesh: Mesh, dm, continuous: bool, p: int):
    """Periodic dof identification for the generic ansatz path.

    Vertex dofs inherit the vertex union-find; for cG Qp the edge dofs of a
    periodic boundary edge are identified slot-wise with the edge whose
    vertex pair consists of the masters (orientation matched through the
    vertex correspondence).  dG spaces share no dofs (periodicity enters
    through the face terms instead).
    """
    n = dm.n_dofs
    master = np.arange(n)
    constrained = np.zeros(n, bool)
    if mesh.periodic_pairs is None or not len(mesh.periodic_pairs):
        return master, constrained
    if not continuous:
        return master, constrained

    vmaster, vconstr = _vertex_masters(mesh)
    nv = mesh.n_vertices
    master[:nv] = vmaster
    constrained[:nv] = vconstr
    if p == 1 or mesh.dim == 1:
        return master, constrained
    if mesh.dim == 3:
        return _ansatz_dof_masters_3d(
            mesh, dm, p, master, constrained, vmaster
        )

    # edge dofs (2D): unique edges in dof-map order
    cells = mesh.cells
    edge_local = np.array([[0, 1], [2, 3], [0, 2], [1, 3]])
    ce_sorted = np.sort(cells[:, edge_local], axis=2).reshape(-1, 2)
    uniq, _ = np.unique(ce_sorted, axis=0, return_inverse=True)
    n_int_e = p - 1
    edge_dof0 = nv + np.arange(len(uniq), dtype=np.int64) * n_int_e

    mkey = np.sort(vmaster[uniq], axis=1)
    key = mkey[:, 0].astype(np.int64) * nv + mkey[:, 1]
    order = np.argsort(key, kind="stable")
    ks = key[order]
    starts = np.flatnonzero(np.concatenate([[True], ks[1:] != ks[:-1]]))
    lens = np.diff(np.concatenate([starts, [len(ks)]]))
    for s, ln in zip(starts, lens):
        if ln < 2:
            continue
        group = order[s : s + ln]
        # the master edge: the one whose own vertices are the masters
        own = np.array([
            np.array_equal(np.sort(vmaster[uniq[g]]), np.sort(uniq[g]))
            for g in group
        ])
        mg = group[np.argmax(own)] if own.any() else group[0]
        a_m, b_m = uniq[mg]
        fwd_m = vmaster[a_m] < vmaster[b_m] if a_m != b_m else True
        for g in group:
            if g == mg:
                continue
            a_s, b_s = uniq[g]
            fwd_s = vmaster[a_s] < vmaster[b_s]
            same = fwd_s == fwd_m
            for k in range(n_int_e):
                k_m = k if same else n_int_e - 1 - k
                s_dof = edge_dof0[g] + k
                m_dof = edge_dof0[mg] + k_m
                master[s_dof] = m_dof
                constrained[s_dof] = True
    return master, constrained
