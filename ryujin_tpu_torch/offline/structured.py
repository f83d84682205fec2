"""The port's own copy of ryujin_tpu/offline/structured.py (plain numpy; the port imports
nothing of ryujin_tpu).  The original header follows.

Pack the assembled node graph onto a structured lattice canvas.

TPU-native alternative to the padded-ELL layout (ell.py): when the mesh is a
tensor lattice (possibly with holes, e.g. the forward-facing step), every
node sits at a lattice position and the Q1 stencil is exactly the set of
lattice neighbors at offsets {-1,0,1}^dim.  Neighbor access then becomes a
*static shift* of a [H, W] (2D) canvas instead of a gather — on TPU this
compiles to fused slice/concat at HBM bandwidth, whereas irregular gathers
serialize.  This is the structured analog of the reference's SIMD-blocked
CSR (sparse_matrix_simd.h:40-297): the reference pays bookkeeping for
stride-uniform rows; the lattice makes every row uniform by construction.

Lattice positions without a node (removed cells, padding added for TPU tile
alignment) are masked: their edge masks are zero and their states are held
at a safe constant.  Canvas dims of non-periodic axes are padded to TPU
friendly multiples.  A periodic minor (x) axis whose period is a multiple
of 128 keeps its exact width — the wrap-around of the shift *is* the
periodic identification; otherwise it is padded to a lane-aligned width
with two ghost columns realizing the identification on the padded canvas
(StructuredData.minor_wrap), keeping the compiled Pallas kernels
available.  Periodic leading axes get ghost bands instead (see
StructuredData.ghosts) so that neither the shifts nor the Pallas halo
windows ever wrap.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from .assembly import BoundaryGroup, SparseOfflineData
from .mesh import Mesh


def lattice_offsets(dim: int, reach: int = 1) -> Tuple[Tuple[int, ...], ...]:
    """All (2*reach+1)**dim - 1 nonzero offsets in {-reach..reach}**dim,
    lexicographic.

    The ordering is symmetric under negation-reversal: offsets[k] ==
    -offsets[K-1-k], so the transposed-edge slot of k is K-1-k for ANY
    reach.  reach=1 is the cG Q1 stencil; reach=p covers cG Qp on the
    p-refined node lattice and dG Qp on the (p+1)-interleaved lattice
    (offline/assembly.py _node_lattice).
    """
    r = range(-reach, reach + 1)
    offs = [o for o in itertools.product(r, repeat=dim) if any(o)]
    return tuple(offs)


@dataclasses.dataclass
class StructuredData:
    """Host-side structured stencil data (canvas-flattened, row-major)."""

    dim: int
    n_nodes: int
    n_pad: int  # prod(shape)
    max_degree: int  # K = 3**dim - 1
    shape: Tuple[int, ...]  # canvas dims (slowest first)
    offsets: Tuple[Tuple[int, ...], ...]  # K lattice offsets (canvas axes)
    margins: Tuple[int, ...]  # masked margin width per canvas axis

    cij: np.ndarray  # [n_pad, K, dim]
    mij: np.ndarray  # [n_pad, K]
    mask: np.ndarray  # [n_pad, K]

    @property
    def cij_t(self) -> np.ndarray:
        """Transposed-edge coefficients via canvas shifts (see EllData.cij_t)."""
        K = self.max_degree
        c = self.cij.reshape(self.shape + (K, self.dim))
        out = np.empty_like(c)
        axes = tuple(range(len(self.shape)))
        for k, off in enumerate(self.offsets):
            out[..., k, :] = np.roll(
                c[..., K - 1 - k, :], tuple(-o for o in off), axis=axes
            )
        return out.reshape(self.cij.shape)
    cii: np.ndarray  # [n_pad, dim]
    lumped_mass: np.ndarray  # [n_pad]
    n_nbrs: np.ndarray  # [n_pad]
    node_mask: np.ndarray  # [n_pad]
    positions: np.ndarray  # [n_pad, dim]
    measure_of_omega: float

    vertex_to_node: np.ndarray  # [n_raw] canvas id of (master of) vertex
    node_to_vertex: np.ndarray  # [n_pad] representative vertex; -1 pad
    boundary_rounds: List[Dict[int, BoundaryGroup]]

    # Ghost bands per canvas axis: None, or (g, P) meaning the axis is
    # laid out [g ghost | P real | g ghost | pad]; ghost rows mirror the
    # wrapped real rows (top ghost [0, g) <- [P, P+g), bottom ghost
    # [g+P, g+P+g) <- [g, 2g)).  Added for *periodic* non-minor axes so
    # the neighbor shift never has to wrap the canvas: static arrays are
    # ghost-filled at pack time, dynamic arrays must be refreshed before
    # neighbor access (StructuredStencil.refresh_ghosts / the Pallas
    # stepper's per-kernel refresh).  This is the SPMD rendition of the
    # reference's ghost-row layer (sparse_matrix_simd.h:651-771).
    ghosts: Tuple[Optional[Tuple[int, int]], ...] = ()
    # 1.0 at real AND ghost positions (whose *values* are valid after a
    # refresh); node_mask stays 0 at ghosts:
    value_mask: Optional[np.ndarray] = None  # [n_pad]
    # Slab decomposition of canvas axis 0 for multi-chip sharding:
    # (n_slabs, Ls, g) — the axis is n_slabs uniform slabs
    # [g ghost | Ls rows | g ghost]; slab s's ghosts mirror the wrapped
    # real edge rows of slabs s-1 / s+1 (cyclic).  Refreshing is a roll
    # along the slab axis — exactly a collective-permute when that axis
    # is sharded over a device mesh (the XLA-SPMD halo exchange of
    # SURVEY.md §5.7).  For non-periodic axes the two outermost ghost
    # bands receive wrapped garbage, but value_mask is 0 there so every
    # edge into them is masked:
    slab_spec: Optional[Tuple[int, int, int]] = None

    # Multi-block refresh maps (offline/multiblock.py): gather/scatter
    # index pairs (dst, src) copying owner values into cross-block ghost
    # cells.  gmap_node indexes canvas cells (node arrays [..., n]);
    # gmap_edge indexes the flattened device edge layout k * n_pad + cell
    # (edge arrays [..., K, n]), realizing the reader-frame slot
    # permutation at block interfaces:
    gmap_node: Optional[Tuple[np.ndarray, np.ndarray]] = None
    gmap_edge: Optional[Tuple[np.ndarray, np.ndarray]] = None
    # z-vectorized refresh maps for EXTRUDED multi-block canvases
    # (pack_multiblock_extruded): one 2D map applied to every z-plane.
    # gmap_node_z: (dst2, src2) cells in the [H*W] cross-section;
    # gmap_edge_z: (dst_k, dst2, src_k, src2) — the interface slot
    # permutation is z-preserving (block rotations are in-plane), so the
    # D axis free-rides in one sliced scatter instead of a D-times
    # bigger flat map:
    gmap_node_z: Optional[Tuple[np.ndarray, np.ndarray]] = None
    gmap_edge_z: Optional[
        Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]
    ] = None
    # CSR edge -> host (cell * K + slot) map (multi-block pack_edge_values):
    edge_map: Optional[Tuple[np.ndarray, np.ndarray]] = None
    # Multi-block symmetric-Riemann interface fixup (offline/multiblock.py
    # _assemble_canvas): the O(interface) directed edges whose canvas
    # transposed-slot pairing breaks at block interfaces, to be evaluated
    # in both directions and scattered into the assembled d canvas
    # (solver/hyperbolic.py _interface_fixup).  Keys: dst (flat K*n slot),
    # i, j (canvas cells), c_f, c_r ([m, dim] forward/reverse c_ij):
    sym_fixup: Optional[Dict[str, np.ndarray]] = None
    # Extraordinary-vertex side stencil (offline/multiblock.py): rows
    # whose stencil exceeds the canvas 8-neighborhood, computed on a tiny
    # ELL stencil in XLA (solver/hyperbolic.py Sideband) and scattered
    # back after each kernel phase.  Keys: rows, cells, cols_cell, cij,
    # mij, mask, cii, m_lumped, n_nbrs, trans, edst, esrc:
    ev_side: Optional[Dict[str, np.ndarray]] = None
    # Periodic MINOR axis whose period P is not lane-aligned: the axis is
    # padded to W (a multiple of 128) and carries two ghost columns so the
    # minor-axis roll/lane-roll wrap still realizes the periodic
    # identification on the padded canvas: col P <- col 0 (the dx=+1
    # neighbor of col P-1) and col W-1 <- col P-1 (the dx=-1 neighbor of
    # col 0 after the roll wraps).  (P, W); None when the period is
    # already a multiple of 128 (the wrap alone is the identification)
    # or the axis is not periodic:
    minor_wrap: Optional[Tuple[int, int]] = None
    # dG incidence matrix beta_ij packed onto the canvas slots [n_pad, K]
    # (offline_data.template.h:809-940); None for a continuous ansatz:
    incidence: Optional[np.ndarray] = None
    # finite element ansatz this canvas was packed from:
    ansatz: str = "cG Q1"
    # the minor (x) canvas axis is periodic (wrap = lane roll, or the
    # minor_wrap ghost columns); column-split tilings are then invalid:
    periodic_minor: bool = False

    @property
    def reach(self) -> int:
        """Max |offset| component: 1 for Q1, p for the Qp node lattice."""
        return max(abs(o) for off in self.offsets for o in off)


def _lattice_info(data: SparseOfflineData, mesh: Mesh):
    """Resolve the packing lattice: the mesh's vertex lattice for cG Q1,
    or the assembly-provided node lattice for any other tensor ansatz
    (assembly._node_lattice).  Returns (si [n, dim] per-node lattice
    coords, lat_shape, logical period per dim, periodic flags, reach)."""
    if getattr(data, "node_lattice_index", None) is not None:
        si = np.asarray(data.node_lattice_index)
        lat_shape = tuple(int(v) for v in data.node_lattice_shape)
        explicit = data.node_lattice_periodic
        reach = int(data.stencil_reach)
    else:
        if mesh.structured_index is None or mesh.structured_shape is None:
            raise ValueError("mesh carries no lattice structure")
        si = np.asarray(mesh.structured_index)
        lat_shape = tuple(int(v) for v in mesh.structured_shape)
        explicit = None
        reach = 1
    dim = data.dim
    real = ~data.is_constrained
    periodic = np.zeros(dim, dtype=bool)
    logical = np.zeros(dim, dtype=np.int64)
    for d in range(dim):
        hi = si[:, d] == lat_shape[d] - 1
        # a far face occupied only by constrained slaves collapses out of
        # the canvas (cG periodic); dG has no slave DoFs at all — its
        # wrap is flagged explicitly by the assembly:
        far_slaves = bool(hi.any()) and not bool(real[hi].any())
        periodic[d] = far_slaves or bool(
            explicit is not None and explicit[d]
        )
        logical[d] = lat_shape[d] - 1 if far_slaves else lat_shape[d]
    return si, lat_shape, logical, periodic, reach


def _edge_deltas(si, i_e, j_e, logical, periodic, dim):
    """Per-edge lattice delta on canvas axes (slowest first), wrapping
    periodic dims into the centered range."""
    delta = np.empty((len(i_e), dim), dtype=np.int64)
    for axis in range(dim):
        d = dim - 1 - axis
        dd = si[j_e, d] - si[i_e, d]
        if periodic[d]:
            P = int(logical[d])
            dd = dd % P
            dd = np.where(dd > P // 2, dd - P, dd)
        delta[:, axis] = dd
    return delta


def _slot_lut(offsets, dim, reach):
    """offset -> slot index lookup over base (2*reach+1) digits."""
    base = 2 * reach + 1
    lut = np.full(base**dim, -1, dtype=np.int64)
    for k, o in enumerate(offsets):
        key = 0
        for v in o:
            key = base * key + (v + reach)
        lut[key] = k
    return lut, base


def pack_edge_values(sd: StructuredData, data: SparseOfflineData,
                     mesh: Mesh, values: np.ndarray) -> np.ndarray:
    """Pack CSR-aligned per-edge values [nnz, ...] into [n_pad, K, ...]."""
    out = np.zeros((sd.n_pad, sd.max_degree) + values.shape[1:], values.dtype)
    if sd.edge_map is not None:  # multi-block canvas (offline/multiblock.py)
        src, dst = sd.edge_map
        out.reshape((sd.n_pad * sd.max_degree,) + values.shape[1:])[dst] = (
            values[src]
        )
        return out
    real = np.flatnonzero(sd.node_to_vertex >= 0)
    # reconstruct the edge scatter exactly as pack_structured does:
    rows = sd.node_to_vertex[real]
    deg = data.indptr[rows + 1] - data.indptr[rows]
    total = int(deg.sum())
    cum = np.cumsum(deg) - deg
    src = (
        np.arange(total) - np.repeat(cum, deg)
        + np.repeat(data.indptr[rows], deg)
    )
    i_e = np.repeat(rows, deg)
    j_e = data.indices[src]
    ci = np.repeat(real, deg)
    # slot via lattice delta, mirroring pack_structured:
    si, _, logical, periodic, reach = _lattice_info(data, mesh)
    dim = sd.dim
    delta = _edge_deltas(si, i_e, j_e, logical, periodic, dim)
    lut, base = _slot_lut(sd.offsets, dim, reach)
    key_e = np.zeros(len(i_e), dtype=np.int64)
    for axis in range(dim):
        key_e = base * key_e + (delta[:, axis] + reach)
    slot = lut[key_e]
    out[ci, slot] = values[src]
    return out


def pack_node_values(sd: StructuredData, values: np.ndarray,
                     fill=0.0) -> np.ndarray:
    """Pack per-node values [n_raw, ...] into [n_pad, ...]."""
    out = np.full((sd.n_pad,) + values.shape[1:], fill, values.dtype)
    real = np.flatnonzero(sd.node_to_vertex >= 0)
    out[real] = values[sd.node_to_vertex[real]]
    return out


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pack_structured(
    data: SparseOfflineData,
    mesh: Mesh,
    pad_minor: int = 128,
    pad_major: int = 8,
    margin=8,
    slabs: int = 1,
) -> StructuredData:
    """Pack onto the lattice canvas recorded in mesh.structured_index.

    Canvas axis order is (slowest ... fastest) = reversed lattice dims, i.e.
    2D canvas is [ny, nx] with x fastest — matching the row-major vertex
    numbering of the lattice generators.

    margin: masked band width for the leading canvas axes — an int, or a
    per-leading-axis tuple (slowest first).  The 2D row-tiled Pallas
    kernels need TH(=8)-row y margins; the 3D z-slab kernels only need
    TD(=8) planes on z and >=1 row on y (solver/pallas_step.py
    pallas_default_margin), which cuts 3D canvas padding substantially.

    slabs > 1 decomposes canvas axis 0 into `slabs` uniform ghost-banded
    slabs (StructuredData.slab_spec) so the canvas can be sharded over a
    device mesh along that axis — the domain-decomposition analog of the
    reference's MPI partitioning (offline_data.h:136-169).
    """
    dim = data.dim
    margins_in = (
        tuple(margin) if isinstance(margin, (tuple, list))
        else (margin,) * max(dim - 1, 0)
    )
    assert len(margins_in) >= dim - 1
    # the packing lattice: the mesh's vertex lattice for cG Q1, the
    # assembly-provided node lattice (reach p) otherwise:
    si, lat_shape, logical, periodic, reach = _lattice_info(data, mesh)
    real = ~data.is_constrained
    assert (si[real].max(axis=0) < logical).all()

    # Canvas dims, slowest-first: (…, ny, nx).  Non-periodic leading axes
    # get a `margin`-row masked band top and bottom so that halo windows
    # of the fused Pallas kernels (solver/pallas_step.py) never leave the
    # canvas for tiles containing real nodes.  PERIODIC leading axes get
    # the same band as *ghost* rows mirroring the wrapped real rows (the
    # shift then never wraps the canvas; dynamic arrays are refreshed
    # before neighbor access).  The periodic minor (x) axis needs neither:
    # its wrap is the lane roll itself.
    pads = [pad_major] * (dim - 1) + [pad_minor]
    canvas = []
    offs = []
    ghost_bands: List[Optional[Tuple[int, int]]] = []
    minor_wrap: Optional[Tuple[int, int]] = None
    for axis in range(dim):  # canvas axis 0 = lattice dim (dim-1)
        d = dim - 1 - axis
        size = int(logical[d])
        off = 0
        gh = None
        m_ax = margins_in[axis] if axis < dim - 1 else 0
        if dim > 1 and axis < dim - 1 and m_ax:
            off = m_ax
            size = size + 2 * m_ax
            if periodic[d]:
                gh = (m_ax, int(logical[d]))
        if not periodic[d] or gh is not None:
            size = _round_up(size, pads[axis] if dim > 1 else pad_minor)
        elif periodic[d] and not (dim > 1 and axis < dim - 1):
            # periodic minor axis: a period that is already lane-aligned
            # keeps its exact width (the lane-roll wrap IS the periodic
            # identification); otherwise pad to a multiple of 128 and
            # carry two ghost columns realizing the identification on the
            # padded canvas (StructuredData.minor_wrap) so the compiled
            # Pallas kernels stay available (pallas_supports)
            if dim > 1 and size % pad_minor:
                W = _round_up(size, pad_minor)
                # the 2*reach ghost columns must not collide:
                if W < size + 2 * reach:
                    W = _round_up(size + 2 * reach, pad_minor)
                minor_wrap = (size, W)
                size = W
        canvas.append(size)
        offs.append(off)
        ghost_bands.append(gh)
    # slab decomposition of canvas axis 0 (multi-chip sharding):
    slab_spec = None
    if slabs > 1:
        if dim < 2:
            raise ValueError("slab decomposition needs dim >= 2")
        d0 = dim - 1
        L = int(logical[d0])
        if periodic[d0]:
            if L % slabs or (L // slabs) % pad_major:
                raise ValueError(
                    f"periodic axis of period {L} cannot be split into "
                    f"{slabs} slabs of a multiple of {pad_major} rows"
                )
            Ls = L // slabs
        else:
            Ls = _round_up(-(-L // slabs), pad_major)
        g = margins_in[0]
        slab_spec = (slabs, Ls, g)
        canvas[0] = slabs * (Ls + 2 * g)
        offs[0] = g
        ghost_bands[0] = None  # slab ghosts supersede the periodic band

    canvas = tuple(canvas)
    margins = tuple(offs)
    ghost_bands = tuple(ghost_bands)
    n_pad = int(np.prod(canvas))

    # canvas multi-index per vertex (canvas order: slowest-first):
    cidx = si[:, ::-1].copy()  # [n_raw, dim] now (iy..., ix) for 2D
    cidx += np.asarray(margins)[None, :]
    if slab_spec is not None:
        n_sl, Ls, g = slab_spec
        r = si[:, dim - 1] % max(int(logical[dim - 1]), 1)
        cidx[:, 0] = (r // Ls) * (Ls + 2 * g) + g + (r % Ls)
    flat = np.ravel_multi_index(tuple(cidx.T), canvas, mode="wrap")
    vertex_to_node = flat[data.master]

    offsets = lattice_offsets(dim, reach)
    K = len(offsets)

    cij = np.zeros((n_pad, K, dim))
    mij = np.zeros((n_pad, K))
    mask = np.zeros((n_pad, K))
    incidence = (
        np.zeros((n_pad, K)) if data.incidence is not None else None
    )
    cii = np.zeros((n_pad, dim))
    lumped = np.ones(n_pad)
    n_nbrs = np.ones(n_pad)
    node_mask = np.zeros(n_pad)
    positions = np.zeros((n_pad, dim))
    node_to_vertex = np.full(n_pad, -1, dtype=np.int64)

    rows = np.flatnonzero(real)
    rid = flat[rows]
    node_mask[rid] = 1.0
    lumped[rid] = data.lumped_mass[rows]
    cii[rid] = data.cii[rows]
    positions[rid] = data.positions[rows]
    deg = data.indptr[rows + 1] - data.indptr[rows]
    n_nbrs[rid] = np.maximum(deg, 1)
    node_to_vertex[rid] = rows

    # edges: native one-pass packing (ryujin_tpu_torch/native/assembly.cc) for
    # the reach-1 / no-incidence case, with the vectorized numpy pipeline
    # as fallback (and for higher-order / dG stencils)
    from .. import native

    if reach == 1 and data.incidence is None and native.pack_edges(
        dim, rows, data.indptr, data.indices, si, logical, flat,
        data.cij, data.mij, K, cij, mij, mask,
    ):
        return _finalize_structured(
            data, mesh, dim, K, offsets, canvas, margins, n_pad, logical,
            periodic, cij, mij, mask, cii, lumped, n_nbrs, node_mask,
            positions, node_to_vertex, vertex_to_node, flat, real,
            ghost_bands, slab_spec, bool(periodic[dim - 1]),
            minor_wrap=minor_wrap, minor_periodic=bool(periodic[0]),
        )

    # edges, vectorized: source row i repeated deg times
    i_e = np.repeat(rows, deg)
    total = int(deg.sum())
    cum = np.cumsum(deg) - deg
    src = (
        np.arange(total)
        - np.repeat(cum, deg)
        + np.repeat(data.indptr[rows], deg)
    )
    j_e = data.indices[src]
    # lattice delta per canvas axis, wrapped into {-reach..reach}:
    delta = _edge_deltas(si, i_e, j_e, logical, periodic, dim)
    assert (np.abs(delta) <= reach).all(), "edge beyond lattice reach"
    lut, base = _slot_lut(offsets, dim, reach)
    key_e = np.zeros(len(i_e), dtype=np.int64)
    for axis in range(dim):
        key_e = base * key_e + (delta[:, axis] + reach)
    slot = lut[key_e]
    assert (slot >= 0).all(), "degenerate zero-offset edge"
    ci = flat[i_e]
    cij[ci, slot] = data.cij[src]
    mij[ci, slot] = data.mij[src]
    mask[ci, slot] = 1.0
    if incidence is not None:
        incidence[ci, slot] = data.incidence[src]

    return _finalize_structured(
        data, mesh, dim, K, offsets, canvas, margins, n_pad, logical,
        periodic, cij, mij, mask, cii, lumped, n_nbrs, node_mask,
        positions, node_to_vertex, vertex_to_node, flat, real,
        ghost_bands, slab_spec, bool(periodic[dim - 1]),
        minor_wrap=minor_wrap, incidence=incidence,
        minor_periodic=bool(periodic[0]),
    )


def _fill_ghosts(arr: np.ndarray, canvas, ghost_bands) -> None:
    """Copy the wrapped real rows into the ghost bands, in place.

    arr is [n_pad, ...]; axes are processed in order so that corner
    regions (ghosts in several axes) end up double-wrapped."""
    a = arr.reshape(canvas + arr.shape[1:])
    for ax, gh in enumerate(ghost_bands):
        if gh is None:
            continue
        g, P = gh
        sl = [slice(None)] * a.ndim
        dst, src = list(sl), list(sl)
        dst[ax], src[ax] = slice(0, g), slice(P, P + g)
        a[tuple(dst)] = a[tuple(src)]
        dst[ax], src[ax] = slice(g + P, 2 * g + P), slice(g, 2 * g)
        a[tuple(dst)] = a[tuple(src)]


def _fill_minor_wrap(arr: np.ndarray, canvas, minor_wrap,
                     reach: int = 1) -> None:
    """Fill the 2*reach periodic minor-axis ghost columns, in place.

    cols [P, P+reach) <- cols [0, reach) and cols [W-reach, W) <-
    cols [P-reach, P) (StructuredData.minor_wrap); uniform slot layout,
    so the same copy serves node and edge arrays."""
    P, W = minor_wrap
    a = arr.reshape(canvas + arr.shape[1:])
    ax = len(canvas) - 1
    sl = [slice(None)] * a.ndim
    dst, src = list(sl), list(sl)
    dst[ax], src[ax] = slice(P, P + reach), slice(0, reach)
    a[tuple(dst)] = a[tuple(src)]
    dst[ax], src[ax] = slice(W - reach, W), slice(P - reach, P)
    a[tuple(dst)] = a[tuple(src)]


def _fill_slab_ghosts(arr: np.ndarray, canvas, slab_spec) -> None:
    """Fill the slab ghost bands of canvas axis 0 with the wrapped real
    edge rows of the cyclically adjacent slabs, in place."""
    n, Ls, g = slab_spec
    A = Ls + 2 * g
    a = arr.reshape((n, A) + canvas[1:] + arr.shape[1:])
    a[:, :g] = np.roll(a[:, Ls : Ls + g], 1, axis=0)
    a[:, g + Ls : g + Ls + g] = np.roll(a[:, g : 2 * g], -1, axis=0)


def _finalize_structured(
    data, mesh, dim, K, offsets, canvas, margins, n_pad, logical, periodic,
    cij, mij, mask, cii, lumped, n_nbrs, node_mask, positions,
    node_to_vertex, vertex_to_node, flat, real, ghost_bands=(),
    slab_spec=None, axis0_periodic=False, minor_wrap=None, incidence=None,
    minor_periodic=False,
):
    del mesh, logical, periodic, flat
    value_mask = node_mask.copy()
    statics = [cij, mij, mask, cii, lumped, n_nbrs, positions, value_mask]
    if incidence is not None:
        statics.append(incidence)
    if any(gh is not None for gh in ghost_bands):
        for arr in statics:
            _fill_ghosts(arr, canvas, ghost_bands)
    if slab_spec is not None:
        n_sl, Ls, g = slab_spec
        if Ls < g:
            raise ValueError(f"slab rows {Ls} smaller than ghost band {g}")
        for arr in statics:
            _fill_slab_ghosts(arr, canvas, slab_spec)
        if not axis0_periodic:
            # the outermost ghost bands received wrapped garbage; mask
            # any (nonexistent) edges into them:
            A = Ls + 2 * g
            vm = value_mask.reshape((n_sl, A) + canvas[1:])
            vm[0, :g] = 0.0
            vm[-1, g + Ls : g + Ls + g] = 0.0
    if minor_wrap is not None:
        # last, so the ghost columns pick up the band/slab-filled rows of
        # their owner columns (corner completeness):
        reach = max(abs(o) for off in offsets for o in off)
        for arr in statics:
            _fill_minor_wrap(arr, canvas, minor_wrap, reach)
    # boundary rounds in canvas numbering
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

    return StructuredData(
        dim=dim,
        n_nodes=int(real.sum()),
        n_pad=n_pad,
        max_degree=K,
        shape=canvas,
        offsets=offsets,
        margins=margins,
        cij=cij,
        mij=mij,
        mask=mask,
        cii=cii,
        lumped_mass=lumped,
        n_nbrs=n_nbrs,
        node_mask=node_mask,
        positions=positions,
        measure_of_omega=data.measure_of_omega,
        vertex_to_node=vertex_to_node,
        node_to_vertex=node_to_vertex,
        boundary_rounds=rounds,
        ghosts=ghost_bands,
        value_mask=value_mask,
        slab_spec=slab_spec,
        minor_wrap=minor_wrap,
        incidence=incidence,
        ansatz=getattr(data, "ansatz", "cG Q1"),
        periodic_minor=minor_periodic,
    )
