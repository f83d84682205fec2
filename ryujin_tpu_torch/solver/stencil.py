"""Lattice-canvas stencil in PyTorch (ryujin_tpu/solver/hyperbolic.py
StructuredStencil, :144-398), for a single-block canvas of any lattice
reach (K = (2 reach + 1)^dim - 1 offsets), continuous or discontinuous
(dG, with the incidence beta_ij on the slots), with the ghost layouts of
offline/structured.py: ghost bands on periodic leading axes, the slab
decomposition of canvas axis 0, and the padded periodic minor axis
(minor_wrap).

Neighbour access is a static shift of the canvas: `nbr` gives
out[..., k, i] = X[..., i + offsets[k]] with the same wrap as jnp.roll /
torch.roll; values wrapped in at the canvas edge only ever feed masked
edges.  The offsets are ordered so that offsets[k] == -offsets[K-1-k]:
the transposed slot of offset k is K-1-k for every reach.  On a canvas
with ghosts `nbr` and `transpose_edge` first copy the wrapped real rows
into the ghost rows of their input (`refresh_ghosts`, hyperbolic.py:
199-276), as the JAX nbr does; the per-offset `shift` reads its input as
it stands, and its callers refresh each input once.

The kernel references, the plain substep and the glue read the static
planes through per-offset accessors (`cij_k`, `mask_k` / `live_k`,
`mij_k`, `cmax_k`, `c_ii`).  Each either indexes the stored [K, n]
stacks or, with separable statics (a 3D canvas that is an extrusion along z,
offline/separable.py), synthesizes the plane as a z-profile times a 2D
field, f[p](z) * g[q](y, x): the torch form of _SepTile and _sep_full /
_sep_cmax_full (ryujin_tpu/solver/pallas_step.py:1092-1164, 2022-2053).

The padded-ELL stencil (`EllStencil`, built by `stencil_from_ell`) is the
torch form of the JAX package's generic gather stencil (Stencil and
_stencil_from_ell, ryujin_tpu/solver/hyperbolic.py:65-130): every node
carries K neighbour slots, neighbour j of slot k is cols[k, i], and the
transposed edge is a flat index into the [K, n] edge layout.  It carries
1D, irregular meshes and any ansatz; the phase functions of
solver/hyperbolic.py run on it unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..offline.ell import EllData
from ..offline.structured import StructuredData


def _unsupported(what: str):
    raise NotImplementedError(
        f"{what} canvases are not ported to the torch stencil yet "
        '(ROADMAP queue 1, "Multi-block canvases, then bench.py\'s last '
        'case")'
    )


def check_single_block(sd: StructuredData) -> None:
    """Raise NotImplementedError on a multi-block canvas, the one canvas
    feature the torch stencil does not carry, and ValueError on ghosts
    narrower than the stencil reads (check_ghost_width)."""
    for name in ("gmap_node", "gmap_edge", "gmap_node_z", "gmap_edge_z",
                 "ev_side"):
        if getattr(sd, name, None) is not None:
            _unsupported("multi-block")
    check_ghost_width(
        getattr(sd, "ghosts", ()) or (), getattr(sd, "slab_spec", None),
        getattr(sd, "minor_wrap", None), sd.reach,
    )


def check_ghost_width(ghosts, slab_spec, minor_wrap, reach: int) -> None:
    """Raise ValueError where a neighbour read at the reach would pass the
    ghost rows: every ghost band (g, P) and the slab bands (n, Ls, g) need
    g >= reach, the padded periodic minor axis (P, W) W - P >= 2 reach
    (the reference packs these widths and never checks them)."""
    for ax, gh in enumerate(ghosts):
        if gh is not None and gh[0] < reach:
            raise ValueError(
                f"canvas axis {ax}: ghost band of {gh[0]} rows, narrower "
                f"than the stencil's reach {reach}"
            )
    if slab_spec is not None and slab_spec[2] < reach:
        raise ValueError(
            f"canvas axis 0: slab ghost bands of {slab_spec[2]} rows, "
            f"narrower than the stencil's reach {reach}"
        )
    if minor_wrap is not None and minor_wrap[1] - minor_wrap[0] < 2 * reach:
        P, W = minor_wrap
        raise ValueError(
            f"minor canvas axis: period {P} padded to {W} leaves {W - P} "
            f"ghost columns, fewer than 2 x reach {reach}"
        )


# Separable statics in the JAX package's plane order (pallas_step.py:
# 1383-1395), on a 3D reach-1 canvas (K = 26, 9 in-plane slots): g_sep2
# [48, H, W] stacks the 2D fields of c_ij (plane 3 q + c), m_ij (27 + q),
# the mask (36 + q) and c_ii (45 + c); f_sepz [133, D] the z-profiles of
# c_ij (3 k + c), m_ij (78 + k), the mask (104 + k) and c_ii (130 + c).
# q = 3 (dy + 1) + dx + 1 is the in-plane slot of offset k = (dz, dy, dx).
def sep_planes(kind: str, k: int, offsets, comp: int = 0) -> Tuple[int, int]:
    """(z-profile p, 2D field q) of one separable plane: kind "cij" (offset
    k, component comp), "mij" or "mask" (offset k), or "cii" (component
    comp; k is not read)."""
    _, dy, dx = offsets[k]
    K, q = len(offsets), 3 * (dy + 1) + dx + 1
    if kind == "cij":
        return 3 * k + comp, 3 * q + comp
    if kind == "mij":
        return 3 * K + k, 27 + q
    if kind == "mask":
        return 4 * K + k, 36 + q
    if kind == "cii":
        return 5 * K + comp, 45 + comp
    raise ValueError(kind)


@dataclasses.dataclass(frozen=True)
class StructuredStencil:
    """Static canvas arrays, node axis last and canvas-flattened; built
    as views of the kernels' canvases by CanvasArrays.stencil
    (solver/canvas_step.py).  With separable statics the stored stacks
    (cij, mij, mask, cii, cmax) are None and g_sep2 / f_sepz hold the
    factors; read the planes through the per-offset accessors, or take
    `full()` for the stacks."""

    shape: Tuple[int, ...]
    offsets: Tuple[Tuple[int, ...], ...]
    cij: Optional[torch.Tensor]  # [dim, K, n]
    mij: Optional[torch.Tensor]  # [K, n]
    mask: Optional[torch.Tensor]  # [K, n]
    cii: Optional[torch.Tensor]  # [dim, n]
    m_lumped: torch.Tensor  # [n]
    m_lumped_inv: torch.Tensor  # [n]
    n_nbrs: torch.Tensor  # [n]
    node_mask: torch.Tensor  # [n]
    measure_inv: float
    # dG incidence beta_ij [K, n]; None for a continuous ansatz
    incidence: Optional[torch.Tensor] = None
    # max(|c_ij|, |c_ji|) [K, n]
    cmax: Optional[torch.Tensor] = None
    # separable statics: 2D fields [48, H, W] and z-profiles [133, D]
    g_sep2: Optional[torch.Tensor] = None
    f_sepz: Optional[torch.Tensor] = None
    # the ghost layouts (StructuredData.ghosts, slab_spec, minor_wrap):
    # (g, P) or None per canvas axis, (n_slabs, Ls, g), (P, W)
    ghosts: Tuple[Optional[Tuple[int, int]], ...] = ()
    slab_spec: Optional[Tuple[int, int, int]] = None
    minor_wrap: Optional[Tuple[int, int]] = None

    @property
    def K(self) -> int:
        return len(self.offsets)

    @property
    def reach(self) -> int:
        return max(abs(o) for off in self.offsets for o in off)

    @property
    def have_ghosts(self) -> bool:
        return (any(g is not None for g in self.ghosts)
                or self.slab_spec is not None or self.minor_wrap is not None)

    def refresh_ghosts(self, X: torch.Tensor) -> torch.Tensor:
        """[..., n]: a copy of X with the wrapped real rows copied into its
        ghost rows (X itself on a canvas without ghosts).  An edge array
        [..., K, n] takes the same copies slot by slot: bands, slabs and
        the minor wrap move whole rows of a uniform slot layout
        (refresh_edges, hyperbolic.py:289-335)."""
        if not self.have_ghosts:
            return X
        X = X.clone(memory_format=torch.contiguous_format)
        self.refresh_ghosts_(X)
        return X

    def refresh_ghosts_(self, X: torch.Tensor) -> None:
        """refresh_ghosts in place on a contiguous [..., n] tensor, by slice
        assignments on the canvas view (the whole g-row bands, as the XLA
        path copies them): the slab bands first (a cyclic roll along the
        slab axis: top band of slab s <- the last g real rows of slab
        s - 1, bottom band <- the first g of slab s + 1), then the periodic
        bands (top [0, g) <- [P, P + g), bottom [g + P, 2 g + P) <-
        [g, 2 g)), then the minor wrap last, for corner completeness (cols
        [P, P + reach) <- [0, reach), [W - reach, W) <- [P - reach, P))
        (hyperbolic.py StructuredStencil._roll_ghosts, :216-276).  Each
        source is copied before its destination is written."""
        if not self.have_ghosts:
            return
        lead = X.ndim - 1
        Xc = X.view(X.shape[:-1] + self.shape)
        if self.slab_spec is not None:
            n_sl, Ls, g = self.slab_spec
            A = Ls + 2 * g
            Xs = Xc.view(Xc.shape[:lead] + (n_sl, A) + Xc.shape[lead + 1:])
            top = torch.roll(Xs.narrow(lead + 1, Ls, g), 1, lead)
            bot = torch.roll(Xs.narrow(lead + 1, g, g), -1, lead)
            Xs.narrow(lead + 1, 0, g).copy_(top)
            Xs.narrow(lead + 1, g + Ls, g).copy_(bot)
        for ax, gh in enumerate(self.ghosts):
            if gh is None:
                continue
            g, P = gh
            a = lead + ax
            Xc.narrow(a, 0, g).copy_(Xc.narrow(a, P, g).clone())
            Xc.narrow(a, g + P, g).copy_(Xc.narrow(a, g, g).clone())
        if self.minor_wrap is not None:
            P, W = self.minor_wrap
            r, a = self.reach, Xc.ndim - 1
            Xc.narrow(a, P, r).copy_(Xc.narrow(a, 0, r).clone())
            Xc.narrow(a, W - r, r).copy_(Xc.narrow(a, P - r, r).clone())

    @property
    def separable(self) -> bool:
        return self.g_sep2 is not None

    # ---- the statics, one offset at a time ------------------------------
    def sep_plane(self, kind: str, k: int, comp: int = 0) -> torch.Tensor:
        """[n]: the synthesized plane f[p](z) * g[q](y, x), one rounding
        (the mask not yet tested); the counterpart of _sep_full
        (pallas_step.py:2024).  Separable statics only."""
        p, q = sep_planes(kind, k, self.offsets, comp)
        return (self.f_sepz[p][:, None, None] * self.g_sep2[q]).reshape(-1)

    def cij_k(self, k: int) -> torch.Tensor:
        """c_ij of offset k [dim, n]."""
        if not self.separable:
            return self.cij[:, k]
        return torch.stack([self.sep_plane("cij", k, c) for c in range(3)])

    def mask_k(self, k: int) -> torch.Tensor:
        """The edge mask of offset k [n]: 1 on live edges, 0 elsewhere.  A
        synthesized plane is tested > 0, as the JAX package tests it; a
        dead edge has a zero factor, so its product is exactly 0."""
        if not self.separable:
            return self.mask[k]
        return self.live_k(k).to(self.f_sepz.dtype)

    def live_k(self, k: int) -> torch.Tensor:
        """The live edges of offset k [n], bool: mask_k(k) > 0."""
        if not self.separable:
            return self.mask[k] > 0
        return self.sep_plane("mask", k) > 0

    def mij_k(self, k: int) -> torch.Tensor:
        """m_ij of offset k [n]."""
        if not self.separable:
            return self.mij[k]
        return self.sep_plane("mij", k)

    def c_ii(self) -> torch.Tensor:
        """The diagonal c_ii [dim, n]."""
        if not self.separable:
            return self.cii
        return torch.stack([self.sep_plane("cii", 0, c) for c in range(3)])

    def cmax_k(self, k: int) -> torch.Tensor:
        """max(|c_ij|, |c_ji|) of offset k [n].  Synthesized, |c_ji| is
        |c| of the transposed slot K-1-k at neighbour k: its z-profile read
        at (z + dz) mod D and its 2D fields rolled in-plane, the wrap of the
        stored canvas (_SepTile.cmax_k, pallas_step.py:1147-1164).  Both
        norms square and add the components in order."""
        if not self.separable:
            return self.cmax[k]
        off = self.offsets[k]
        kt = self.K - 1 - k
        ni = nj = None
        for c in range(3):
            a = self.sep_plane("cij", k, c)
            p, q = sep_planes("cij", kt, self.offsets, c)
            f = torch.roll(self.f_sepz[p], -off[0])
            g = torch.roll(self.g_sep2[q], (-off[1], -off[2]), (0, 1))
            b = (f[:, None, None] * g).reshape(-1)
            ni = a * a if ni is None else ni + a * a
            nj = b * b if nj is None else nj + b * b
        return torch.maximum(torch.sqrt(ni), torch.sqrt(nj))

    def full(self) -> "StructuredStencil":
        """The stencil with every static stack stored: itself, or with
        separable statics a copy that holds the synthesized stacks (for the
        plain phase functions, which read [K, n] stacks)."""
        if not self.separable:
            return self
        K = self.K
        return dataclasses.replace(
            self,
            cij=torch.stack([self.cij_k(k) for k in range(K)], 1),
            mij=torch.stack([self.mij_k(k) for k in range(K)]),
            mask=torch.stack([self.mask_k(k) for k in range(K)]),
            cii=self.c_ii(),
            cmax=torch.stack([self.cmax_k(k) for k in range(K)]),
            g_sep2=None,
            f_sepz=None,
        )

    def _shift(self, Xc: torch.Tensor, off) -> torch.Tensor:
        d = len(self.shape)
        dims = tuple(range(Xc.ndim - d, Xc.ndim))
        return torch.roll(Xc, tuple(-o for o in off), dims)

    def shift(self, X: torch.Tensor, off) -> torch.Tensor:
        """[..., n] -> [..., n]: out[..., i] = X[..., i + off], one slot of
        `nbr` (the per-offset read of the slot-streaming forms).  X is read
        as it stands: its reader refreshes its ghosts once
        (refresh_ghosts), not once a slot."""
        lead = X.shape[:-1]
        return self._shift(X.reshape(lead + self.shape), off).reshape(X.shape)

    def nbr(self, X: torch.Tensor) -> torch.Tensor:
        """[..., n] -> [..., K, n] by K static canvas shifts of X with its
        ghosts refreshed."""
        X = self.refresh_ghosts(X)
        lead = X.shape[:-1]
        Xc = X.reshape(lead + self.shape)
        out = torch.stack(
            [self._shift(Xc, off) for off in self.offsets], len(lead)
        )
        return out.reshape(lead + (self.K,) + X.shape[-1:])

    def transpose_edge(self, E: torch.Tensor) -> torch.Tensor:
        """[..., K, n] -> [..., K, n]: out[..., k, i] = E[..., K-1-k, i+off_k],
        of E with its ghosts refreshed."""
        E = self.refresh_ghosts(E)
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


@dataclasses.dataclass(frozen=True)
class EllStencil:
    """Padded-ELL stencil on the device, node axis last (the JAX Stencil,
    hyperbolic.py:65-102).  cols [K, n] and trans [K, n] are int64 gather
    indices; trans is flat over [K, n]: the edge (j -> i) of slot k at
    node i sits at k_rev * n + j.  Masked slots (padding) point at their
    own node with zero coefficients."""

    cols: torch.Tensor  # [K, n] int64
    trans: torch.Tensor  # [K, n] int64, flat over [K, n]
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
    # the node planes [4, n] (m_i, 1/m_i, n_nbrs, node_mask) that the ELL
    # kernels read; the four node arrays above are its rows
    node: Optional[torch.Tensor] = None
    # cols as int32, which ell_pk1, ell_pk2 and ell_pk3 read
    # (int32_columns), and trans as int32, which ell_pk_up reads
    # (int32_edges); set by solver/ell_step.EllStepper
    cols32: Optional[torch.Tensor] = None
    trans32: Optional[torch.Tensor] = None

    @property
    def K(self) -> int:
        return self.cols.shape[0]

    @property
    def n(self) -> int:
        return self.cols.shape[1]

    @property
    def dim(self) -> int:
        return self.cij.shape[0]

    def nbr(self, X: torch.Tensor) -> torch.Tensor:
        """Gather neighbour values: [..., n] -> [..., K, n]."""
        return X[..., self.cols]

    def transpose_edge(self, E: torch.Tensor) -> torch.Tensor:
        """Transposed-edge gather: out[..., k, i] = E at the (j -> i) edge."""
        flat = E.reshape(E.shape[:-2] + (self.K * self.n,))
        return flat[..., self.trans]

    def live_k(self, k: int) -> torch.Tensor:
        """The live edges of slot k [n], bool."""
        return self.mask[k] > 0

    def full(self) -> "EllStencil":
        """Itself: every static array is stored (the canvas stencil's
        interface for the plain substep)."""
        return self


def check_int32_rows(n: int) -> None:
    """Raise ValueError unless n rows can be addressed by int32 columns
    (n < 2^31)."""
    if n >= 2 ** 31:
        raise ValueError(f"{n} rows: int32 columns address fewer than 2^31")


def int32_columns(cols: torch.Tensor) -> torch.Tensor:
    """The gather columns [K, n] as int32, on cols' device; raises at n >=
    2^31."""
    check_int32_rows(cols.shape[-1])
    return cols.to(torch.int32).contiguous()


def check_int32_edges(K: int, n: int) -> None:
    """Raise ValueError unless the K n edges of [K, n] edge arrays can be
    addressed by int32 flat indices (K n < 2^31)."""
    if K * n >= 2 ** 31:
        raise ValueError(f"{K} x {n} edges: int32 flat indices address "
                         "fewer than 2^31")


def int32_edges(trans: torch.Tensor) -> torch.Tensor:
    """The transposed-edge indices [K, n], flat over [K, n], as int32 on
    trans' device; raises at K n >= 2^31."""
    check_int32_edges(*trans.shape)
    return trans.to(torch.int32).contiguous()


def stencil_from_ell(ell: EllData, dtype, device) -> EllStencil:
    """The host ELL arrays in the node-last device layout
    (_stencil_from_ell, hyperbolic.py:105-130): ell.trans holds flat
    indices into the row-major [n, K] edge numbering, the device layout
    flattens [K, n], so (j, k_rev) -> k_rev * n + j."""
    K, n = ell.max_degree, ell.n_pad
    j = ell.trans.astype(np.int64) // K
    k_rev = ell.trans.astype(np.int64) % K

    def f(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    def idx(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.int64,
                               device=device)

    node = f(np.stack([ell.lumped_mass, 1.0 / ell.lumped_mass, ell.n_nbrs,
                       ell.node_mask]))
    return EllStencil(
        cols=idx(ell.cols.T),
        trans=idx((k_rev * n + j).T),
        cij=f(np.transpose(ell.cij, (2, 1, 0))),
        mij=f(ell.mij.T),
        mask=f(ell.mask.T),
        cii=f(ell.cii.T),
        m_lumped=node[0],
        m_lumped_inv=node[1],
        n_nbrs=node[2],
        node_mask=node[3],
        measure_inv=float(1.0 / ell.measure_of_omega),
        incidence=None if ell.incidence is None else f(ell.incidence.T),
        node=node,
    )
