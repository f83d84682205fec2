"""The substep on the 2D single-block canvas through the CUDA kernels: the
counterpart of ryujin_tpu/solver/pallas_step.py (PallasStepper.step,
:2582-3318) for the Mach-3 step.

One substep launches, in order: PK1 (half-slot wavespeeds + alpha), the
boundary-pair fixup, the d rebuild and tau reduction in torch, PK2
(U_low, F, bounds), PK3 (P, first limiter pass, okp), and pk_up twice
(PK4 re-limits, PK5 is the last update).  A reach-1 canvas (cG Q1, K = 8)
runs pk1 / pk2 / pk3 on the raw lambda; a canvas of a larger reach (cG Q2:
reach 2, K = 24) runs the slot-streaming pk1_stream / pk2_stream /
pk3_stream on the pre-scaled e = lambda * cmax (`CanvasStepper.stream`).
Every kernel wrapper runs its plain-torch reference for CPU tensors, so
the same orchestration is testable on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from ..offline.structured import StructuredData, lattice_offsets

from ..kernels.pk1 import pk1
from ..kernels.pk1_stream import pk1_stream
from ..kernels.pk2 import pk2
from ..kernels.pk2_stream import pk2_stream
from ..kernels.pk3 import pk3
from ..kernels.pk3_stream import pk3_stream
from ..kernels.pk_up import pk_up
from .hyperbolic import d_from_lambda, tau_max_from_d
from .stencil import StructuredStencil, check_single_block


@dataclasses.dataclass(frozen=True)
class CanvasArrays:
    """Static canvases on the device (the torch form of PallasArrays,
    pallas_step.py:1049): planes first, [planes, H, W] contiguous."""

    shape: Tuple[int, int]
    offsets: Tuple[Tuple[int, int], ...]
    measure_inv: float
    g_cij: torch.Tensor  # [dim * K, H, W], plane d * K + k
    g_mask: torch.Tensor  # [K, H, W]
    g_cmax: torch.Tensor  # [K, H, W]: max(|c_ij|, |c_ji|)
    g_mij: torch.Tensor  # [K, H, W]
    g_cii: torch.Tensor  # [dim, H, W]
    g_node: torch.Tensor  # [5, H, W]: m_i, 1/m_i, n_nbrs, node_mask, value_mask
    g_lam: torch.Tensor  # [1, H, W]: 1/n_nbrs

    @property
    def K(self) -> int:
        return len(self.offsets)

    @property
    def n(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def stencil(self) -> StructuredStencil:
        """The same arrays as a StructuredStencil (views, no copies), for
        the plain-torch kernel references."""
        K, n = self.K, self.n
        dim = self.g_cii.shape[0]
        return StructuredStencil(
            shape=self.shape,
            offsets=self.offsets,
            cij=self.g_cij.reshape(dim, K, n),
            mij=self.g_mij.reshape(K, n),
            mask=self.g_mask.reshape(K, n),
            cii=self.g_cii.reshape(dim, n),
            m_lumped=self.g_node[0].reshape(n),
            m_lumped_inv=self.g_node[1].reshape(n),
            n_nbrs=self.g_node[2].reshape(n),
            node_mask=self.g_node[3].reshape(n),
            measure_inv=self.measure_inv,
        )

    @staticmethod
    def from_structured(sd: StructuredData, dtype, device) -> "CanvasArrays":
        """Built as pallas_step.py:1328-1381 builds PallasArrays."""
        check_single_block(sd)
        canvas = tuple(sd.shape)
        caxes = tuple(range(len(canvas)))
        K, dim = sd.max_degree, sd.dim
        offsets = tuple(map(tuple, sd.offsets))

        def canv(x, planes):
            a = np.ascontiguousarray(x).reshape((planes,) + canvas)
            return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

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
        lumped = sd.lumped_mass.reshape((1,) + canvas)
        value_mask = sd.node_mask if sd.value_mask is None else sd.value_mask
        return CanvasArrays(
            shape=canvas,
            offsets=offsets,
            measure_inv=float(1.0 / sd.measure_of_omega),
            g_cij=canv(cij, dim * K),
            g_mask=canv(np.moveaxis(sd.mask, -1, 0), K),
            g_cmax=canv(cmax, K),
            g_mij=canv(np.moveaxis(sd.mij, -1, 0), K),
            g_cii=canv(np.moveaxis(sd.cii, -1, 0), dim),
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
        )


class CanvasStepper:
    """Runs HyperbolicModule.step through the kernels.  Takes the 2D Euler
    equations on a single-block lattice canvas of reach 1 or more
    (symmetric half-slot Riemann, no initial precomputed values, no
    sideband, multi-block, slab or dG incidence) and rejects any other
    configuration."""

    def __init__(self, eq, params, sd: StructuredData, dtype, device,
                 lambda_fixup: Callable):
        if getattr(eq, "name", None) != "euler" or sd.dim != 2:
            raise ValueError("the canvas kernels take the 2D Euler equations")
        offsets = tuple(map(tuple, sd.offsets))
        reach = max(abs(o) for off in offsets for o in off)
        if offsets != lattice_offsets(2, reach):
            raise ValueError(
                "the canvas kernels take the full lattice stencil of the "
                f"canvas's reach ({reach}), K = {(2 * reach + 1) ** 2 - 1}"
            )
        self.eq = eq
        self.params = params
        self.lambda_fixup = lambda_fixup
        # The one place that chooses the kernel form: a canvas of reach > 1
        # runs the slot-streaming PK1-PK3 on pre-scaled wavespeeds, reach 1
        # the stacked K = 8 kernels (PallasStepper decides the same at
        # pallas_step.py:2734-2745, 2982-2985 and 3040-3042).
        self.stream = reach > 1
        self.arrays = CanvasArrays.from_structured(sd, dtype, device)
        self.stencil = self.arrays.stencil

    def step(self, U, prec, stage_U, stage_weights, tau, cfl, tau_cap,
             compute_tau):
        """Same contract as HyperbolicModule.step."""
        eq, p, ca, st = self.eq, self.params, self.arrays, self.stencil
        if self.stream:
            # e = lambda * cmax: the glue and PK2/PK3 never read cmax
            lam, alpha = pk1_stream(eq, p, ca, U, prec)
            lam = self.lambda_fixup(lam, U, prescaled=True)
            d = d_from_lambda(st, lam)
            run_pk2, run_pk3 = pk2_stream, pk3_stream
        else:
            lam, alpha = pk1(eq, p, ca, U, prec)
            lam = self.lambda_fixup(lam, U)
            d = d_from_lambda(st, lam, ca.g_cmax.reshape(ca.K, -1))
            run_pk2, run_pk3 = pk2, pk3
        tau_max = tau_max_from_d(st, d, cfl, tau_cap)
        if compute_tau:
            tau = tau_max
        U_low, F, bounds = run_pk2(
            eq, p, ca, U, prec, lam, alpha, stage_U, stage_weights, tau
        )
        P, l, okp = run_pk3(
            eq, p, ca, U, lam, alpha, F, U_low, bounds, stage_U,
            stage_weights, tau,
        )
        ok = okp.min() > 0.5
        U_cur = U_low
        for it in range(p.limiter_iterations):
            last = it + 1 == p.limiter_iterations
            U_cur, l = pk_up(eq, p, ca, U_cur, bounds, P, l, last)
        return U_cur, tau, ok
