"""Pack the assembled node graph into padded ELL arrays: the port's copy
of ryujin_tpu/offline/ell.py (numpy; the port imports nothing of
ryujin_tpu).  The original header follows.

The reference stores the stencil in a SIMD-blocked CSR (SparseMatrixSIMD,
sparse_matrix_simd.h:40-297).  On TPU the idiomatic
layout is a dense padded ELL: every node carries exactly K off-diagonal
neighbor slots (K = max stencil size, e.g. 8 for Q1 in 2D); unused slots are
masked self-loops with zero coefficients.  All per-edge data (c_ij, m_ij)
lives in [n_pad, K, ...] arrays so the hot kernels become pure gathers +
vectorized math with static shapes.

The transposed-edge permutation (needed for d_ji / l_ji access, cf.
sparse_matrix_simd.h get_transposed_tensor) is precomputed here as a single
flattened index array.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .assembly import BoundaryGroup, SparseOfflineData


@dataclasses.dataclass
class EllData:
    """Host-side (NumPy) padded stencil data; converted to tensors by the
    solver (solver/stencil.py stencil_from_ell)."""

    dim: int
    n_nodes: int  # number of real (unconstrained) nodes
    n_pad: int  # padded node count
    max_degree: int  # K

    cols: np.ndarray  # [n_pad, K] int32
    cij: np.ndarray  # [n_pad, K, dim]
    mij: np.ndarray  # [n_pad, K]
    mask: np.ndarray  # [n_pad, K] float64 (1 real edge, 0 padding)
    trans: np.ndarray  # [n_pad, K] int32 flattened transposed-edge index

    @property
    def cij_t(self) -> np.ndarray:
        """Transposed-edge coefficients: cij_t[i, k] = cij at the (j->i) edge.

        Static data enabling local evaluation of d_ji = |c_ji| lambda(U_j,
        U_i, n_ji) without a runtime transposed gather (the analog of
        get_transposed_tensor, sparse_matrix_simd.h:651).
        """
        n, K, dim = self.cij.shape
        return self.cij.reshape(n * K, dim)[self.trans]
    cii: np.ndarray  # [n_pad, dim]
    incidence: Optional[np.ndarray]  # [n_pad, K] dG incidence or None
    lumped_mass: np.ndarray  # [n_pad]
    n_nbrs: np.ndarray  # [n_pad] float (row_length - 1, >= 1)
    node_mask: np.ndarray  # [n_pad] float
    positions: np.ndarray  # [n_pad, dim]
    measure_of_omega: float

    # mapping from original mesh vertex ids to packed node ids (constrained
    # vertices map to their master's packed id):
    vertex_to_node: np.ndarray  # [n_raw] int64
    node_to_vertex: np.ndarray  # [n_pad] int64 (representative vertex; -1 pad)

    # boundary data: list of rounds; each round maps Boundary id ->
    # BoundaryGroup with `index` already in packed node numbering.
    boundary_rounds: List[Dict[int, BoundaryGroup]]

    # finite element ansatz this graph was assembled with:
    ansatz: str = "cG Q1"


def _locality_order(data: SparseOfflineData, real: np.ndarray) -> np.ndarray:
    """Order real nodes for gather locality (reverse Cuthill-McKee).

    Mirrors the intent of the reference's Cuthill-McKee pass
    (offline_data.template.h:186-416) — neighbors end up close in memory so
    TPU gathers over the ELL arrays hit nearby HBM lines.
    """
    try:
        import scipy.sparse as sp
        import scipy.sparse.csgraph as csgraph

        n = data.n_nodes
        indptr, indices = data.indptr, data.indices
        g = sp.csr_matrix(
            (np.ones(len(indices), np.int8), indices, indptr), shape=(n, n)
        )
        sub = g[real][:, real]
        perm = csgraph.reverse_cuthill_mckee(sub, symmetric_mode=True)
        return real[perm]
    except Exception:
        return real


def pack_edge_values(packed: "EllData", data: SparseOfflineData,
                     values: np.ndarray) -> np.ndarray:
    """Pack CSR-aligned per-edge values [nnz, ...] into [n_pad, K, ...]."""
    K = packed.max_degree
    out = np.zeros((packed.n_pad, K) + values.shape[1:], values.dtype)
    order = packed.node_to_vertex[: packed.n_nodes]
    deg = (data.indptr[1:] - data.indptr[:-1])[order]
    total = int(deg.sum())
    cum = np.cumsum(deg) - deg
    slot = np.arange(total) - np.repeat(cum, deg)
    src = slot + np.repeat(data.indptr[order], deg)
    rows_rep = np.repeat(np.arange(len(order)), deg)
    out[rows_rep, slot] = values[src]
    return out


def pack_node_values(packed: "EllData", values: np.ndarray,
                     fill=0.0) -> np.ndarray:
    """Pack per-node values [n_raw, ...] into [n_pad, ...]."""
    out = np.full((packed.n_pad,) + values.shape[1:], fill, values.dtype)
    order = packed.node_to_vertex[: packed.n_nodes]
    out[: packed.n_nodes] = values[order]
    return out


def pack(
    data: SparseOfflineData,
    pad_to: int = 8,
    order: Optional[np.ndarray] = None,
    reorder: bool = True,
) -> EllData:
    """Pack a SparseOfflineData node graph into ELL form.

    order: optional explicit ordering of real nodes (packed id -> vertex id).
    """
    n_raw = data.n_nodes
    real = np.flatnonzero(~data.is_constrained)
    if order is None:
        order = _locality_order(data, real) if reorder else real
    n_real = len(order)
    n_pad = ((n_real + pad_to - 1) // pad_to) * pad_to

    vertex_to_node = np.full(n_raw, -1, dtype=np.int64)
    vertex_to_node[order] = np.arange(n_real)
    # constrained vertices route to their master's node:
    vertex_to_node = np.where(
        vertex_to_node >= 0, vertex_to_node, vertex_to_node[data.master]
    )

    deg = (data.indptr[1:] - data.indptr[:-1])[order]
    K = int(deg.max()) if n_real else 1

    cols = np.tile(np.arange(n_pad, dtype=np.int64)[:, None], (1, K))
    cij = np.zeros((n_pad, K, data.dim))
    mij = np.zeros((n_pad, K))
    mask = np.zeros((n_pad, K))

    # vectorized CSR->ELL scatter
    starts = data.indptr[order]
    rows_rep = np.repeat(np.arange(n_real), deg)
    total = int(deg.sum())
    cum = np.cumsum(deg) - deg
    slot = np.arange(total) - np.repeat(cum, deg)
    src = slot + np.repeat(starts, deg)
    cols[rows_rep, slot] = vertex_to_node[data.indices[src]]
    cij[rows_rep, slot] = data.cij[src]
    mij[rows_rep, slot] = data.mij[src]
    mask[rows_rep, slot] = 1.0
    incidence = None
    if getattr(data, "incidence", None) is not None:
        incidence = np.zeros((n_pad, K))
        incidence[rows_rep, slot] = data.incidence[src]

    cii = np.zeros((n_pad, data.dim))
    cii[:n_real] = data.cii[order]
    lumped = np.ones(n_pad)
    lumped[:n_real] = data.lumped_mass[order]
    n_nbrs = np.ones(n_pad)
    n_nbrs[:n_real] = np.maximum(deg, 1)
    node_mask = np.zeros(n_pad)
    node_mask[:n_real] = 1.0
    positions = np.zeros((n_pad, data.dim))
    positions[:n_real] = data.positions[order]

    # transpose map: for edge (i, k) -> flattened index of (j, k') with
    # cols[j, k'] == i.
    trans = np.arange(n_pad * K, dtype=np.int64).reshape(n_pad, K)
    if n_real:
        i_e = rows_rep
        j_e = cols[rows_rep, slot]
        # build lookup (j, i) -> slot: sort edges by (i_of_edge, j_of_edge)
        key = i_e * n_pad + j_e
        okey = np.argsort(key)
        rev_key = j_e * n_pad + i_e
        pos = np.searchsorted(key[okey], rev_key)
        assert np.all(key[okey[pos]] == rev_key), "stencil graph not symmetric"
        k_rev = slot[okey[pos]]
        trans[i_e, slot] = j_e * K + k_rev

    # remap boundary groups into packed numbering
    rounds: List[Dict[int, BoundaryGroup]] = []
    for rnd in data.boundary_rounds:
        g2: Dict[int, BoundaryGroup] = {}
        for fid, g in rnd.items():
            g2[fid] = BoundaryGroup(
                index=vertex_to_node[g.index],
                normal=g.normal,
                normal_mass=g.normal_mass,
                boundary_mass=g.boundary_mass,
                position=g.position,
            )
        rounds.append(g2)

    node_to_vertex = np.full(n_pad, -1, dtype=np.int64)
    node_to_vertex[:n_real] = order

    return EllData(
        dim=data.dim,
        n_nodes=n_real,
        n_pad=n_pad,
        max_degree=K,
        cols=cols.astype(np.int32),
        cij=cij,
        mij=mij,
        mask=mask,
        trans=trans.astype(np.int32),
        cii=cii,
        incidence=incidence,
        lumped_mass=lumped,
        n_nbrs=n_nbrs,
        node_mask=node_mask,
        positions=positions,
        measure_of_omega=data.measure_of_omega,
        vertex_to_node=vertex_to_node,
        node_to_vertex=node_to_vertex,
        boundary_rounds=rounds,
        ansatz=getattr(data, "ansatz", "cG Q1"),
    )
