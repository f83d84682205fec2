"""The substep on the single-block 2D or 3D canvas through the CUDA
kernels: the counterpart of ryujin_tpu/solver/pallas_step.py
(PallasStepper.step, :2582-3318, and its 3D z-slab form _step_slab,
:2072-2579).

One substep launches, in order: PK1 (wavespeeds + alpha), the
boundary-pair fixup, the d rebuild and tau reduction in torch, PK2
(U_low, F, bounds), PK3 (P, first limiter pass, okp), and pk_up twice
(PK4 re-limits, PK5 is the last update).  On a dG canvas PK2 and PK3
read the incidence planes (g_inc) as well.  A 2D reach-1 canvas (cG or
dG Q1, K = 8) runs pk1 / pk2 / pk3 on the raw lambda; a 2D canvas of a
larger reach (cG or dG Q2: reach 2, K = 24) and a 3D canvas (cG or dG
Q1: K = 26) run the slot-streaming pk1_stream / pk2_stream / pk3_stream
(`CanvasStepper.stream`), as the JAX package does (pallas_step.py:2626;
its 3D dG canvas takes the stacked 3D launcher instead, :1226-1234).
The stream kernels take one of two routes, chosen once by the hyperbolic
module (`half`): the half-slot pre-scaled e = lambda * cmax with the
boundary-pair fixup, or, when the boundary-pair set is too large for
that fixup (a 3D box's whole surface), the two-direction e = |c_ij|
lambda on every slot with d = max(e, e_T) and no fixup.  With separable
statics (a 3D cG canvas that is an extrusion along z,
`CanvasArrays.from_structured(separable=True)`) the kernels take their
SEP instances, which synthesize c_ij, m_ij, the mask, c_ii and cmax from
z-profiles and 2D fields, and the d / tau glue rebuilds d offset by
offset from the synthesized mask (pallas_step.py:2198-2212).  On a
canvas with ghost rows (periodic ghost bands, slabs of canvas axis 0, a
padded periodic minor axis) `refresh` copies the wrapped real rows into
the ghost rows of each array before a kernel reads it at its neighbours,
where PallasStepper refreshes (pallas_step.py:1646-1810, 2611-2620,
2789-2790, 3017, 3253, 3316).  Every kernel wrapper runs its plain-torch
reference for CPU tensors, so the same orchestration is testable on the
CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..offline.separable import separate_z
from ..offline.structured import StructuredData, lattice_offsets

from ..kernels.pk1 import pk1
from ..kernels.pk1_stream import pk1_stream
from ..kernels.pk2 import pk2
from ..kernels.pk2_stream import pk2_stream, slot_d
from ..kernels.pk3 import pk3
from ..kernels.pk3_stream import pk3_stream
from ..kernels.pk_up import pk_up
from .hyperbolic import (
    d_from_e, d_from_lambda, tau_max_from_d, tau_max_from_row_sum,
)
from .stencil import StructuredStencil, check_single_block


@dataclasses.dataclass(frozen=True)
class CanvasArrays:
    """Static canvases on the device (the torch form of PallasArrays,
    pallas_step.py:1049): planes first, [planes, H, W] in 2D and
    [planes, D, H, W] in 3D, contiguous.  (The TPU's z-major
    [D, planes, H, W] 3D layout is a DMA choice and is not carried over.)
    With separable statics the five stacks g_cij, g_mask, g_cmax, g_mij
    and g_cii are not allocated (None), as canv_or_empty leaves them empty
    (:1319-1326), and g_sep2 [48, H, W] / f_sepz [133, D] hold the factors
    (:1383-1395; the TPU's [D, PF, 1, 128] lane broadcast of f_sepz is a
    layout choice and is not carried over)."""

    shape: Tuple[int, ...]
    offsets: Tuple[Tuple[int, ...], ...]
    measure_inv: float
    g_cij: Optional[torch.Tensor]  # [dim * K, *shape], plane d * K + k
    g_mask: Optional[torch.Tensor]  # [K, *shape]
    g_cmax: Optional[torch.Tensor]  # [K, *shape]: max(|c_ij|, |c_ji|)
    g_mij: Optional[torch.Tensor]  # [K, *shape]
    g_cii: Optional[torch.Tensor]  # [dim, *shape]
    g_node: torch.Tensor  # [5, *shape]: m_i, 1/m_i, n_nbrs, node_mask, value_mask
    g_lam: torch.Tensor  # [1, *shape]: 1/n_nbrs
    # dG incidence beta_ij [K, *shape]; None for a continuous ansatz
    g_inc: Optional[torch.Tensor] = None
    # separable statics (solver/stencil.py has the plane order); None
    # with the full canvases
    g_sep2: Optional[torch.Tensor] = None  # [48, H, W]
    f_sepz: Optional[torch.Tensor] = None  # [133, D]
    # host seconds that separate_z took (0 with the full canvases)
    factor_seconds: float = 0.0
    # the ghost layouts (StructuredData.ghosts, slab_spec, minor_wrap)
    ghosts: Tuple[Optional[Tuple[int, int]], ...] = ()
    slab_spec: Optional[Tuple[int, int, int]] = None
    minor_wrap: Optional[Tuple[int, int]] = None

    @property
    def K(self) -> int:
        return len(self.offsets)

    @property
    def n(self) -> int:
        return int(np.prod(self.shape))

    @property
    def separable(self) -> bool:
        return self.g_sep2 is not None

    @property
    def stencil(self) -> StructuredStencil:
        """The same arrays as a StructuredStencil (views, no copies), for
        the plain-torch kernel references."""
        K, n = self.K, self.n
        dim = len(self.shape)

        def view(t, planes):
            return None if t is None else t.reshape(planes + (n,))

        return StructuredStencil(
            shape=self.shape,
            offsets=self.offsets,
            cij=view(self.g_cij, (dim, K)),
            mij=view(self.g_mij, (K,)),
            mask=view(self.g_mask, (K,)),
            cii=view(self.g_cii, (dim,)),
            m_lumped=self.g_node[0].reshape(n),
            m_lumped_inv=self.g_node[1].reshape(n),
            n_nbrs=self.g_node[2].reshape(n),
            node_mask=self.g_node[3].reshape(n),
            measure_inv=self.measure_inv,
            incidence=view(self.g_inc, (K,)),
            cmax=view(self.g_cmax, (K,)),
            g_sep2=self.g_sep2,
            f_sepz=self.f_sepz,
            ghosts=self.ghosts,
            slab_spec=self.slab_spec,
            minor_wrap=self.minor_wrap,
        )

    @staticmethod
    def from_structured(sd: StructuredData, dtype, device,
                        separable: bool = False) -> "CanvasArrays":
        """Built as pallas_step.py:1328-1395 builds PallasArrays.

        separable=True factors the statics (offline/separable.py) and
        keeps only the factors; it raises ValueError on a canvas that the
        JAX package would not factor: a 2D or dG canvas (not on its z-slab
        path, :1226-1234) or one that separate_z rejects (not an extrusion
        along z).  There is no fallback to the full canvases: the caller
        asked for the mode by name."""
        check_single_block(sd)
        canvas = tuple(sd.shape)
        caxes = tuple(range(len(canvas)))
        K, dim = sd.max_degree, sd.dim
        offsets = tuple(map(tuple, sd.offsets))

        def canv(x, planes):
            a = np.ascontiguousarray(x).reshape((planes,) + canvas)
            return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

        sep, factor_seconds = None, 0.0
        if separable:
            if dim != 3 or sd.incidence is not None:
                raise ValueError(
                    "separable statics take a 3D cG canvas (the z-slab "
                    f"path), not a {dim}D "
                    f"{'dG' if sd.incidence is not None else 'cG'} canvas"
                )
            t0 = time.perf_counter()
            sep = separate_z(sd)
            factor_seconds = time.perf_counter() - t0
            if sep is None:
                raise ValueError(
                    "the statics of this canvas do not factor into "
                    "z-profiles x 2D fields (not an extrusion along z)"
                )
        statics = dict(g_cij=None, g_mask=None, g_cmax=None, g_mij=None,
                       g_cii=None)
        if sep is None:
            cij = np.moveaxis(
                sd.cij.reshape(canvas + (K, dim)), (-1, -2), (0, 1)
            )  # [dim, K, *canvas]
            norm_c = np.linalg.norm(cij, axis=0)  # [K, *canvas]
            cmax = norm_c.copy()
            for k, off in enumerate(offsets):
                rolled = np.roll(
                    norm_c[K - 1 - k], tuple(-o for o in off), axis=caxes
                )
                cmax[k] = np.maximum(cmax[k], rolled)
            statics = dict(
                g_cij=canv(cij, dim * K),
                g_mask=canv(np.moveaxis(sd.mask, -1, 0), K),
                g_cmax=canv(cmax, K),
                g_mij=canv(np.moveaxis(sd.mij, -1, 0), K),
                g_cii=canv(np.moveaxis(sd.cii, -1, 0), dim),
            )
        else:
            D, H, W = canvas
            g2 = np.concatenate([
                sep.g_cij.reshape(9 * dim, H, W), sep.g_mij, sep.g_mask,
                sep.g_cii,
            ])
            fz = np.concatenate([
                sep.f_cij.reshape(K * dim, D), sep.f_mij, sep.f_mask,
                sep.f_cii,
            ])
            statics = dict(
                statics,
                g_sep2=torch.as_tensor(g2, dtype=dtype, device=device),
                f_sepz=torch.as_tensor(fz, dtype=dtype, device=device),
            )
        lumped = sd.lumped_mass.reshape((1,) + canvas)
        value_mask = sd.node_mask if sd.value_mask is None else sd.value_mask
        return CanvasArrays(
            shape=canvas,
            offsets=offsets,
            measure_inv=float(1.0 / sd.measure_of_omega),
            factor_seconds=factor_seconds,
            ghosts=tuple(sd.ghosts or (None,) * len(canvas)),
            slab_spec=sd.slab_spec,
            minor_wrap=sd.minor_wrap,
            **statics,
            g_node=canv(
                np.concatenate(
                    [
                        lumped,
                        1.0 / lumped,
                        sd.n_nbrs.reshape((1,) + canvas),
                        sd.node_mask.reshape((1,) + canvas),
                        value_mask.reshape((1,) + canvas),
                    ],
                    axis=0,
                ),
                5,
            ),
            g_lam=canv(
                np.where(sd.n_nbrs > 0, 1.0 / np.maximum(sd.n_nbrs, 1), 1.0),
                1,
            ),
            g_inc=(
                None if sd.incidence is None
                else canv(np.moveaxis(sd.incidence, -1, 0), K)
            ),
        )


def refresh(st: StructuredStencil, *arrays) -> None:
    """Copy the wrapped real rows into the ghost rows of each node or edge
    array [..., n] of the canvas, in place, by torch slice assignments on
    the current stream (the XLA glue of PallasStepper._refresh,
    _refresh_zm and _refresh_edge, pallas_step.py:1646-1810: the whole
    g-row bands, where the TPU path copies `reach` rows of the slab bands).
    A no-op on a canvas without ghosts; else each array adds one to
    `refresh.launches`.  None entries are skipped."""
    if not st.have_ghosts:
        return
    for X in arrays:
        if X is None:
            continue
        if not X.is_contiguous():
            raise ValueError("refresh takes contiguous arrays")
        st.refresh_ghosts_(X)
        refresh.launches += 1


refresh.launches = 0


class CanvasStepper:
    """Runs HyperbolicModule.step through the kernels.  Takes the Euler
    equations on a single-block lattice canvas, 2D of reach 1 or more or
    3D of reach 1, of a continuous or a discontinuous ansatz, with or
    without ghosts (periodic ghost bands, slabs of canvas axis 0, a padded
    periodic minor axis: the kernels read every neighbour through the
    canvas's wrap, and `refresh` copies the ghost rows of each array
    before a kernel reads its neighbours), and rejects any other
    configuration (initial precomputed values, a sideband, multi-block).
    A dG canvas (cG's lattice with the incidence beta_ij,
    `CanvasArrays.g_inc`) takes the kernel form of its reach and
    dimension, as a cG one does: dG Q1 in 2D the stacked pk1 / pk2 / pk3,
    dG Q2 in 2D and dG Q1 in 3D the stream forms; PK2 and PK3 then raise
    the high-order viscosity factor to beta_ij.  `half` is the hyperbolic
    module's choice of Riemann route: the half-slot evaluation with
    `lambda_fixup`, or the two-direction evaluation on every slot (3D
    canvases only).  `separable` keeps the statics as factors (3D cG
    canvases only; see CanvasArrays.from_structured)."""

    def __init__(self, eq, params, sd: StructuredData, dtype, device,
                 lambda_fixup: Callable, half: bool, separable: bool = False):
        if getattr(eq, "name", None) != "euler" or sd.dim not in (2, 3):
            raise ValueError("the canvas kernels take the 2D or 3D Euler "
                             "equations")
        offsets = tuple(map(tuple, sd.offsets))
        reach = max(abs(o) for off in offsets for o in off)
        if offsets != lattice_offsets(sd.dim, reach) or (
            sd.dim == 3 and reach != 1
        ):
            raise ValueError(
                "the canvas kernels take the full lattice stencil of the "
                f"canvas's reach ({reach}) in 2D, and of reach 1 (K = 26) in "
                f"3D, not K = {len(offsets)} in {sd.dim}D"
            )
        self.eq = eq
        self.params = params
        self.lambda_fixup = lambda_fixup
        # The one place that chooses the kernel form: a 2D canvas of
        # reach > 1 and every 3D canvas run the slot-streaming PK1-PK3, a
        # 2D reach-1 canvas the stacked K = 8 kernels (PallasStepper
        # decides the same at pallas_step.py:2734-2745, 2982-2985,
        # 3040-3042 and, for 3D, :1226-1234 and :2626).  The ansatz does
        # not enter: a 3D dG canvas, which the JAX package sends to the
        # stacked 3D launcher (_tiled_call_3d, :597), runs the 3D stream
        # forms here, as a cG one does.
        self.stream = reach > 1 or sd.dim == 3
        self.half = half
        self.arrays = CanvasArrays.from_structured(sd, dtype, device,
                                                   separable)
        self.stencil = self.arrays.stencil

    def step(self, U, prec, stage_U, stage_weights, tau, cfl, tau_cap,
             compute_tau):
        """Same contract as HyperbolicModule.step."""
        eq, p, ca, st = self.eq, self.params, self.arrays, self.stencil
        # the inputs' ghost rows, before PK1 (pallas_step.py:2611-2620)
        refresh(st, U, prec, stage_U)
        if self.stream:
            half = self.half
            lam, alpha = pk1_stream(eq, p, ca, U, prec, half)
            if half:
                # e = lambda * cmax: the glue and PK2/PK3 never read cmax
                lam = self.lambda_fixup(lam, U, prescaled=True)
            refresh(st, lam, alpha)
            if st.separable:
                # the row sums of d offset by offset from the synthesized
                # mask: no K-plane static mask lives in the glue
                d_sum = torch.zeros_like(alpha)
                for k in range(st.K):
                    d_sum += slot_d(st, lam, k, half)
                tau_max = tau_max_from_row_sum(st, d_sum, cfl, tau_cap)
            elif half:
                tau_max = tau_max_from_d(st, d_from_lambda(st, lam), cfl,
                                         tau_cap)
            else:
                # e = |c_ij| lambda on every slot, d = max(e, e_T)
                d = d_from_e(st.mask, lam, st.transpose_edge(lam))
                tau_max = tau_max_from_d(st, d, cfl, tau_cap)
            run_pk2 = functools.partial(pk2_stream, half=half)
            run_pk3 = functools.partial(pk3_stream, half=half)
        else:
            lam, alpha = pk1(eq, p, ca, U, prec)
            lam = self.lambda_fixup(lam, U)
            refresh(st, lam, alpha)
            d = d_from_lambda(st, lam, ca.g_cmax.reshape(ca.K, -1))
            tau_max = tau_max_from_d(st, d, cfl, tau_cap)
            run_pk2, run_pk3 = pk2, pk3
        if compute_tau:
            tau = tau_max
        U_low, F, bounds = run_pk2(
            eq, p, ca, U, prec, lam, alpha, stage_U, stage_weights, tau
        )
        refresh(st, F)
        P, l, okp = run_pk3(
            eq, p, ca, U, lam, alpha, F, U_low, bounds, stage_U,
            stage_weights, tau,
        )
        ok = okp.min() > 0.5
        U_cur = U_low
        for it in range(p.limiter_iterations):
            last = it + 1 == p.limiter_iterations
            # l after PK3 and after each PK4 (pallas_step.py:3253, 3316)
            refresh(st, l)
            U_cur, l = pk_up(eq, p, ca, U_cur, bounds, P, l, last)
        return U_cur, tau, ok
