"""The extraordinary-vertex side rows of a 2D multi-block canvas in
PyTorch: the port's Sideband (ryujin_tpu/solver/hyperbolic.py:595-870).

Rows whose stencil exceeds the canvas 8-neighbourhood (block corners of
valence other than 4, the coarse and fine rows of a 2:1 hanging-node
interface; StructuredData.ev_side, offline/multiblock.py) are computed
here on a small padded-ELL stencil of their own, one evaluation of each
phase function over the O(#EV) rows, and scattered back into the canvas
arrays after each kernel phase, so every other row keeps the canvas
kernels.  It is plain torch on either device: the JAX package evaluates it
in XLA, not in Pallas.

Gathers read owner cells, whose values are real without a refresh.  The
transposed-edge gathers (`trans`) read reader rows of the flat [K n]
canvas edge layout, or, for an edge between two side rows (the coarse
line of a 2:1 interface), the side's own values (`trans_side`).  The e / l
scatter (`edst` / `esrc`) writes each side edge's value at its owner slot,
where it is embedded, and at every reader's transpose-route entry.  The
canvas edge arrays are the two-direction route's [K, n]: a canvas with
side rows has no half-slot route (its StructuredData.sym_fixup is None).
"""

from __future__ import annotations

import numpy as np
import torch

from .hyperbolic import (
    d_from_e, phase_e_alpha, phase_low_order, phase_p_l1, phase_update,
    tau_max_from_d,
)
from .stencil import EllStencil


class Sideband:
    """The side rows of `sd` (a StructuredData with ev_side) as an
    EllStencil whose columns are canvas owner cells, and the index maps
    between the side and the canvas, on `device`.  `Sideband.calls`
    counts the glue's calls (each phase and each scatter; every call is
    several torch launches), over all instances."""

    calls = 0

    def __init__(self, eq, params, sd, dtype, device):
        ev = sd.ev_side
        self.eq, self.p = eq, params

        def idx(x):
            return torch.as_tensor(np.ascontiguousarray(x, np.int64),
                                   device=device)

        def f(x):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                   device=device)

        self.cells = idx(ev["cells"])  # [r]
        cols = idx(ev["cols_cell"].T)  # [Ks, r]
        # flat k * n + cell entries of the [K, n] canvas edge layout
        self.trans = idx(ev["trans"].T)  # [Ks, r]
        ts = np.asarray(ev.get("trans_side", np.full(ev["trans"].shape, -1,
                                                     np.int64))).T
        self.has_side_trans = bool((ts >= 0).any())
        # the side-internal transposes, into the flat [r Ks] side layout
        self.trans_side = idx(np.maximum(ts, 0))
        self.trans_is_side = torch.as_tensor(ts >= 0, device=device)
        self.edst = idx(ev["edst"])  # flat [K n], sorted, unique
        self.esrc = idx(ev["esrc"])  # flat [r Ks]
        m_l = np.asarray(ev["m_lumped"])
        r = len(ev["rows"])
        self.st = EllStencil(
            cols=cols,
            trans=self.trans,  # unused: the canvas gathers are done here
            cij=f(np.transpose(ev["cij"], (2, 1, 0))),  # [dim, Ks, r]
            mij=f(ev["mij"].T),
            mask=f(ev["mask"].T),
            cii=f(ev["cii"].T),
            m_lumped=f(m_l),
            m_lumped_inv=f(1.0 / m_l),
            n_nbrs=f(np.maximum(ev["n_nbrs"], 1)),
            node_mask=f(np.ones(r)),
            measure_inv=float(1.0 / sd.measure_of_omega),
        )

    # ---- gathers and the scatter ---------------------------------------
    def ctr(self, X):
        return X[..., self.cells]

    def nbr(self, X):
        return self.st.nbr(X)

    def edge_T(self, E, side_vals):
        """The transposed edge of each side slot [Ks, r]: from the canvas
        edge array E [K, n], or from the side's own values side_vals
        [Ks, r] where both ends are side rows."""
        out = E.reshape(-1)[self.trans]
        if self.has_side_trans:
            sv = side_vals.T.reshape(-1)[self.trans_side]
            out = torch.where(self.trans_is_side, sv, out)
        return out

    def scatter_edge_(self, E, vals):
        """Write the side edge values vals [Ks, r] into the canvas edge
        array E [K, n], in place, at every consumer entry (owner slots and
        reader routes; the destinations are unique)."""
        Sideband.calls += 1
        v = vals.T.reshape(-1)[self.esrc]
        E.view(-1).index_copy_(0, self.edst, v)

    def scatter_rows_(self, X, vals):
        """X[..., cells] = vals, in place, on a node array [..., n]."""
        Sideband.calls += 1
        X.index_copy_(X.ndim - 1, self.cells, vals)

    # ---- the phases ------------------------------------------------------
    def e_alpha(self, U, prec):
        """(e [Ks, r], alpha [r]) of the side rows, both directions."""
        Sideband.calls += 1
        return phase_e_alpha(
            self.eq, self.p, self.st, self.ctr(U), self.ctr(prec),
            self.nbr(U), self.nbr(prec), half=False,
        )

    def d_side(self, e_side, e_canvas):
        """d [Ks, r] of the side rows from their e and the canvas e [K, n]."""
        Sideband.calls += 1
        return d_from_e(self.st.mask, e_side,
                        self.edge_T(e_canvas, side_vals=e_side))

    def tau_side(self, d, cfl, tau_cap):
        return tau_max_from_d(self.st, d, cfl, tau_cap)

    def _stages(self, stage_U, stage_weights):
        S = len(stage_weights)
        if not S:
            return stage_U, []
        return (stage_U[:, :, self.cells],
                [self.nbr(stage_U[s]) for s in range(S)])

    def low_order(self, U, prec, d, alpha, tau, stage_U, stage_weights):
        """(U_low, F, bounds) of the side rows; alpha is the canvas alpha
        with the side's scattered in."""
        Sideband.calls += 1
        sU, sUj = self._stages(stage_U, stage_weights)
        return phase_low_order(
            self.eq, self.p, self.st, self.ctr(U), self.ctr(prec),
            self.nbr(U), self.nbr(prec), d, self.ctr(alpha),
            self.nbr(alpha), tau, sU, sUj, stage_weights,
        )

    def p_l1(self, U, d, alpha, tau, F, m_lumped, U_low_side, bounds_side,
             stage_U, stage_weights):
        """(P, l, success) of the side rows; F is the canvas F with the
        side's scattered in, m_lumped the canvas lumped masses."""
        Sideband.calls += 1
        sU, sUj = self._stages(stage_U, stage_weights)
        return phase_p_l1(
            self.eq, self.p, self.st, self.ctr(U), self.nbr(U), d,
            self.ctr(alpha), self.nbr(alpha), tau, self.ctr(F), self.nbr(F),
            self.nbr(m_lumped), U_low_side, bounds_side, sU, sUj,
            stage_weights,
        )

    def update(self, U_side, bounds_side, P_side, l_side, l_canvas, last):
        """One limiter pass of the side rows, reading the same pass's
        canvas l [K, n] (refreshed) for the transposed edges."""
        Sideband.calls += 1
        return phase_update(
            self.eq, self.p, self.st, U_side, bounds_side, P_side, l_side,
            self.edge_T(l_canvas, side_vals=l_side), last,
        )
