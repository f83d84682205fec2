"""Lattice-canvas stencil in PyTorch (ryujin_tpu/solver/hyperbolic.py
StructuredStencil, :144-398), for a single-block canvas without ghosts,
of any lattice reach (K = (2 reach + 1)^dim - 1 offsets), continuous or
discontinuous (dG, with the incidence beta_ij on the slots).

Neighbour access is a static shift of the canvas: `nbr` gives
out[..., k, i] = X[..., i + offsets[k]] with the same wrap as jnp.roll /
torch.roll; values wrapped in at the canvas edge only ever feed masked
edges.  The offsets are ordered so that offsets[k] == -offsets[K-1-k]:
the transposed slot of offset k is K-1-k for every reach.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..offline.structured import StructuredData


def _unsupported(what: str):
    raise NotImplementedError(
        f"{what} canvases are not ported to the torch stencil yet "
        "(ROADMAP queue 1 items 9-11)"
    )


def check_single_block(sd: StructuredData) -> None:
    """Raise on the canvas features the torch stencil does not carry."""
    if any(g is not None for g in (getattr(sd, "ghosts", ()) or ())):
        _unsupported("ghost-banded (periodic)")
    if getattr(sd, "slab_spec", None) is not None:
        _unsupported("slab-decomposed")
    for name in ("gmap_node", "gmap_edge", "gmap_node_z", "gmap_edge_z",
                 "ev_side"):
        if getattr(sd, name, None) is not None:
            _unsupported("multi-block")
    if getattr(sd, "minor_wrap", None) is not None:
        _unsupported("padded periodic-minor (minor_wrap)")


@dataclasses.dataclass(frozen=True)
class StructuredStencil:
    """Static canvas arrays, node axis last and canvas-flattened; built
    as views of the kernels' canvases by CanvasArrays.stencil
    (solver/canvas_step.py)."""

    shape: Tuple[int, ...]
    offsets: Tuple[Tuple[int, ...], ...]
    cij: torch.Tensor  # [dim, K, n]
    mij: torch.Tensor  # [K, n]
    mask: torch.Tensor  # [K, n]
    cii: torch.Tensor  # [dim, n]
    m_lumped: torch.Tensor  # [n]
    m_lumped_inv: torch.Tensor  # [n]
    n_nbrs: torch.Tensor  # [n]
    node_mask: torch.Tensor  # [n]
    measure_inv: float
    # dG incidence beta_ij [K, n]; None for a continuous ansatz
    incidence: Optional[torch.Tensor] = None

    @property
    def K(self) -> int:
        return len(self.offsets)

    def _shift(self, Xc: torch.Tensor, off) -> torch.Tensor:
        d = len(self.shape)
        dims = tuple(range(Xc.ndim - d, Xc.ndim))
        return torch.roll(Xc, tuple(-o for o in off), dims)

    def shift(self, X: torch.Tensor, off) -> torch.Tensor:
        """[..., n] -> [..., n]: out[..., i] = X[..., i + off], one slot of
        `nbr` (the per-offset read of the slot-streaming forms)."""
        lead = X.shape[:-1]
        return self._shift(X.reshape(lead + self.shape), off).reshape(X.shape)

    def nbr(self, X: torch.Tensor) -> torch.Tensor:
        """[..., n] -> [..., K, n] by K static canvas shifts."""
        lead = X.shape[:-1]
        Xc = X.reshape(lead + self.shape)
        out = torch.stack(
            [self._shift(Xc, off) for off in self.offsets], len(lead)
        )
        return out.reshape(lead + (self.K,) + X.shape[-1:])

    def transpose_edge(self, E: torch.Tensor) -> torch.Tensor:
        """[..., K, n] -> [..., K, n]: out[..., k, i] = E[..., K-1-k, i+off_k]."""
        K = E.shape[-2]
        lead = E.shape[:-2]
        Ec = E.reshape(lead + (K,) + self.shape)
        kax = len(lead)
        out = torch.stack(
            [
                self._shift(Ec.select(kax, K - 1 - k), off)
                for k, off in enumerate(self.offsets)
            ],
            kax,
        )
        return out.reshape(E.shape)
