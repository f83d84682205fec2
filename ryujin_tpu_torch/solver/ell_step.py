"""The substep on the padded-ELL stencil through the CUDA kernels: the ELL
counterpart of solver/canvas_step.py, for the JAX package's generic gather
path (HyperbolicModule.step on a Stencil, ryujin_tpu/solver/hyperbolic.py:
1519-1700), which covers 1D, irregular meshes (gmsh imports, the airfoil)
and every ansatz.

One substep launches, in order: ell_pk1 (e on every live slot and alpha:
the two-direction route, as the JAX package takes on ELL, whose generic
transpose cannot pair slots), the glue in torch (d = max(e, e at the
transposed edge) on live edges, the d row sums and tau's min), ell_pk2
(U_low, F, bounds), ell_pk3 (P, the first limiter pass, okp), okp.min(),
and ell_pk_up twice (PK4 re-limits, PK5 is the last).  There is no
boundary-pair fixup.  Every kernel wrapper runs its plain version for CPU
tensors, so the same orchestration is testable on the CPU.
"""

from __future__ import annotations

import dataclasses

from ..kernels.ell import ell_pk1, ell_pk2, ell_pk3, ell_pk_up
from ..offline.ell import EllData
from .hyperbolic import d_from_e, tau_max_from_d
from .stencil import int32_columns, int32_edges, stencil_from_ell


class EllStepper:
    """Runs HyperbolicModule.step through the ELL kernels for the Euler
    equations in 1D, 2D or 3D, on a continuous or a discontinuous ansatz
    (the dG instances of ell_pk2 and ell_pk3 read the incidence); owns the
    stencil's device statics, with the int32 columns of ell_pk1, ell_pk2
    and ell_pk3 and the int32 transposed edges of ell_pk_up (4 K n bytes
    each beside the int64 ones, which the torch glue and the plain versions
    read)."""

    def __init__(self, eq, params, ell: EllData, dtype, device):
        if getattr(eq, "name", None) != "euler" or ell.dim not in (1, 2, 3):
            raise ValueError("the ELL kernels take the 1D, 2D or 3D Euler "
                             "equations")
        if eq.dim != ell.dim:
            raise ValueError(f"a {eq.dim}D equation on a {ell.dim}D mesh")
        self.eq = eq
        self.params = params
        st = stencil_from_ell(ell, dtype, device)
        self.stencil = dataclasses.replace(
            st, cols32=int32_columns(st.cols), trans32=int32_edges(st.trans))

    def step(self, U, prec, stage_U, stage_weights, tau, cfl, tau_cap,
             compute_tau):
        """Same contract as HyperbolicModule.step."""
        eq, p, st = self.eq, self.params, self.stencil
        e, alpha = ell_pk1(eq, p, st, U, prec)
        d = d_from_e(st.mask, e, st.transpose_edge(e))
        tau_max = tau_max_from_d(st, d, cfl, tau_cap)
        if compute_tau:
            tau = tau_max
        U_low, F, bounds = ell_pk2(eq, p, st, U, prec, d, alpha, stage_U,
                                   stage_weights, tau)
        P, l, okp = ell_pk3(eq, p, st, U, d, alpha, F, U_low, bounds,
                            stage_U, stage_weights, tau)
        ok = okp.min() > 0.5
        U_cur = U_low
        for it in range(p.limiter_iterations):
            last = it + 1 == p.limiter_iterations
            U_cur, l = ell_pk_up(eq, p, st, U_cur, bounds, P, l, last)
        return U_cur, tau, ok
