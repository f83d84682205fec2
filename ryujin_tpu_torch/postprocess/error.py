"""Nodal interpolation of an initial state and the error norms against an
analytic solution (ryujin_tpu/postprocess/error.py).

compute_error follows TimeLoop::compute_error
(time_loop.template.h:694-833): per selected component, the consolidated
(optionally normalized) L-inf, L1 and L2 norms of (numerical - analytic)
at the final time.  As in the reference, the analytic solution is
interpolated at the nodes, the error is formed there, and L1 / L2
integrate the finite element interpolant of that nodal error by cellwise
Gauss quadrature (QGauss(3) per direction, more for a higher degree).
It runs in numpy on the host; the state may come as a tensor on any
device.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..offline.ansatz import build_dof_map, shape_qp
from ..offline.assembly import _cell_quadrature, _shape_q1
from ..offline.mesh import Mesh


def interpolate_nodal(initial_state_fn, sd, eq, t, dtype, device):
    """Initial/analytic state at the packed nodes [C, n_pad]
    (initial_values.template.h:223-266) of a canvas (StructuredData) or a
    padded-ELL packing (EllData): both carry the node positions and the
    node mask.  Padded nodes receive the safe state rho = E = 1, m = 0, so
    downstream math never sees zeros."""
    pos = torch.as_tensor(sd.positions.T, dtype=dtype, device=device)
    U = initial_state_fn(pos, t)
    safe = torch.zeros((eq.n_comp, 1), dtype=dtype, device=device)
    safe[0, 0] = 1.0
    safe[-1, 0] = 1.0
    mask = torch.as_tensor(sd.node_mask, dtype=dtype, device=device)[None]
    return torch.where(mask > 0, U, safe)


def _cell_quad_setup(mesh: Mesh, dof_map=None):
    """Per-cell quadrature data: (N, cell_dofs, JxW, xq) where xq
    [nc, nq, dim] are the physical quadrature points."""
    dim = mesh.dim
    qp, qw = _cell_quadrature(dim, max(3, (
        dof_map.degree + 1 if dof_map is not None else 0)))
    N1, dN1 = _shape_q1(dim, qp)
    if dof_map is None:
        N, cell_dofs = N1, mesh.cells
    else:
        N, _ = shape_qp(dim, dof_map.degree, qp)
        cell_dofs = dof_map.cell_dofs
    X = mesh.vertices[mesh.cells]  # [nc, nsh, dim]
    J = np.einsum("qsd,nse->nqed", dN1, X)
    JxW = np.abs(np.linalg.det(J)) * qw[None, :]
    xq = np.einsum("qs,nsd->nqd", N1, X)
    return N, cell_dofs, JxW, xq


def _quad_norms(vals: np.ndarray, JxW: np.ndarray, kind: str) -> float:
    """L1 or L2 norm of per-quadrature-point values [nc, nq]."""
    if kind == "L1":
        return float(np.sum(np.abs(vals) * JxW))
    if kind == "L2":
        return float(np.sqrt(np.sum(vals * vals * JxW)))
    raise ValueError(kind)


def _cell_norms(mesh: Mesh, nodal: np.ndarray, kind: str,
                dof_map=None) -> float:
    """Integrate the finite element interpolant of `nodal` (raw dof
    values) over the cells."""
    N, cell_dofs, JxW, _ = _cell_quad_setup(mesh, dof_map)
    vals = np.einsum("qs,ns->nq", N, nodal[cell_dofs])
    return _quad_norms(vals, JxW, kind)


def compute_error(
    eq,
    mesh: Mesh,
    sd,
    U,
    t,
    initial_state_fn: Callable,
    components: Optional[Sequence[str]] = None,
    normalize: bool = True,
):
    """(linf, l1, l2) consolidated over the selected components of U
    [C, n_pad] on `sd` packed from `mesh`: a canvas (StructuredData) or a
    padded-ELL packing (EllData), in 1D, 2D or 3D.  Its `vertex_to_node`
    reads each raw dof (its master where it is constrained), its `ansatz`
    names the dof map."""
    names = eq.component_names
    if components is None:
        components = names
    if torch.is_tensor(U):
        U = U.detach().cpu().numpy()
    U = np.asarray(U)
    t = float(t)

    # raw dof positions: the mesh vertices for cG Q1, the dof map else
    dm = None
    if sd.ansatz != "cG Q1":
        dm = build_dof_map(mesh, sd.ansatz)
        pos = dm.positions
    else:
        pos = mesh.vertices
    analytic = initial_state_fn(
        torch.as_tensor(pos.T, dtype=torch.from_numpy(U[:1, :1]).dtype), t
    ).numpy()  # [C, n_raw]: the nodal interpolation
    U_vertices = U[:, sd.vertex_to_node]

    N, cell_dofs, JxW, _ = _cell_quad_setup(mesh, dm)
    linf = l1 = l2 = 0.0
    for name in components:
        idx = names.index(name)
        err = U_vertices[idx] - analytic[idx]
        err_q = np.einsum("qs,ns->nq", N, err[cell_dofs])
        linf_e = float(np.max(np.abs(err)))
        l1_e = _quad_norms(err_q, JxW, "L1")
        l2_e = _quad_norms(err_q, JxW, "L2")
        if normalize:
            a_q = np.einsum("qs,ns->nq", N, analytic[idx][cell_dofs])
            linf += linf_e / float(np.max(np.abs(analytic[idx])))
            l1 += l1_e / _quad_norms(a_q, JxW, "L1")
            l2 += l2_e / _quad_norms(a_q, JxW, "L2")
        else:
            linf += linf_e
            l1 += l1_e
            l2 += l2_e
    return linf, l1, l2
