"""The port's own copy of the 2D part of ryujin_tpu/offline/multiblock.py
(plain numpy; the port imports nothing of ryujin_tpu).  Re-laying a
multi-block canvas into slabs (`slabs > 1`, _slabify) and the extruded
quilts (pack_multiblock_extruded, _z_line_factors) are not carried
over yet: they raise NotImplementedError (ROADMAP queue 1, "Multi-block
canvases": the extruded quilts and multi-block slabs).  The original
header follows.

Multi-block structured packing: canvas layout for block-decomposable
quad meshes.

The reference's "unstructured" production geometries — the airfoil C-type
blocking (geometry_airfoil.h:823-1416), the cylinder block construction
(geometry_cylinder.h:62-144), disk, annulus, wall — are all quilts of
logically-structured patches glued along conforming interfaces.  The
TPU-native consequence: instead of falling back to gather-based ELL
(measured: XLA HBM gathers reach ~15 Mnode/s on v5e, and Mosaic's
in-kernel dynamic_gather is restricted to single-vreg extents —
scripts/probe_gather.py), we

  1. recover the block structure automatically from the cell graph (BFS
     propagation of integer lattice coordinates with D4 orientation
     tracking, `decompose`),
  2. pack every block onto a shared canvas (stacked along the major axis)
     with a one-cell ghost ring around each block,
  3. resolve every cross-block stencil edge onto a ghost-ring cell so the
     fused Pallas kernels (solver/pallas_step.py) and the XLA shift
     stencil see a plain lattice everywhere, and
  4. emit runtime *refresh maps*: small gather/scatter index pairs that
     copy owner values into ghost cells (gmap_node, node arrays) and
     owner edge slots into ghost-ring slots in the reader block's frame
     (gmap_edge, edge arrays like the wavespeed products e and the
     limiter values l).  This is the multi-block rendition of the ghost-
     row exchange of the reference's SparseMatrixSIMD
     (sparse_matrix_simd.h:651-771): O(interface) copies per phase
     instead of O(n) gathers per neighbor access.

Reader/owner block frames may be rotated relative to each other, which
breaks the k <-> K-1-k transposed-slot pairing across interfaces; the
hyperbolic module therefore disables the half-slot symmetric-Riemann
shortcut on multi-block canvases and evaluates both edge directions
(hyperbolic.py _sym_riemann).

Vertices whose full stencil cannot be embedded in their canvas
8-neighborhood (extraordinary block corners, the interface rows of 2:1
hanging-node interfaces) are computed on a small side ELL stencil
(ev_side / solver Sideband) while every other row keeps the canvas fast
path; a mesh with a VOLUME fraction of such rows is genuinely
unstructured — `pack_multiblock` raises `MultiblockError` and the caller
falls back to the padded-ELL layout.  Conforming quilts with regular
interfaces and 3-/4-valent corners (annulus, disk, airfoil, cylinder
blocks) pack fully; locally-refined (AMR) meshes with hanging-node
constraints pack with O(interface) side rows — closing the throughput
cliff the ELL fallback would otherwise be (the reference runs one
uniform CSR loop for every mesh, hyperbolic_module.template.h:417-420;
the canvas + side-row split is the TPU rendition).

2D bases: the reference's multi-block geometries are 2D; their 3D
variants are z-extrusions.  An extrusion whose 2D base is itself a
single lattice (the cylinder o-grid x z) keeps a global lattice and
uses pack_structured directly.  An extrusion of a genuinely
multi-block base (the 3D airfoil C-mesh, geometry_airfoil.h:1279-1290)
has NO global lattice; it packs via `pack_multiblock_extruded` below:
the 2D cross-section quilt x a plain z lattice dimension, with the 3D
statics synthesized exactly as (2D packed statics) x (1D z factors)
and the refresh maps z-vectorized (StructuredData.gmap_*_z).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from .assembly import SparseOfflineData
from .mesh import Mesh
from .structured import (
    StructuredData,
    _finalize_structured,
    _round_up,
    lattice_offsets,
)


class MultiblockError(ValueError):
    """Mesh cannot be embedded in a multi-block canvas."""


# The 8 elements of D4 as integer 2x2 matrices acting on (x, y) columns.
_D4 = [
    np.array(m, dtype=np.int64)
    for m in (
        [[1, 0], [0, 1]],
        [[0, -1], [1, 0]],
        [[-1, 0], [0, -1]],
        [[0, 1], [-1, 0]],
        [[-1, 0], [0, 1]],
        [[1, 0], [0, -1]],
        [[0, 1], [1, 0]],
        [[0, -1], [-1, 0]],
    )
]

# Local (x, y) corner offsets of the deal.II vertex ordering
# (coordinate d toggles with stride 2**d): v0=(0,0) v1=(1,0) v2=(0,1) v3=(1,1).
_CORNERS = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], dtype=np.int64)


@dataclasses.dataclass
class Block:
    """One logically-structured patch: grid[y, x] = vertex id or -1."""

    grid: np.ndarray  # [H, W] int64
    cells: np.ndarray  # member cell ids


def _face_neighbors(cells: np.ndarray) -> np.ndarray:
    """[nc, 4] neighbor cell per deal.II face (-x, +x, -y, +y); -1 boundary."""
    nc = len(cells)
    faces = np.stack(
        [cells[:, [0, 2]], cells[:, [1, 3]], cells[:, [0, 1]],
         cells[:, [2, 3]]],
        axis=1,
    ).reshape(-1, 2)
    fkey = np.sort(faces, axis=1)
    order = np.lexsort((fkey[:, 1], fkey[:, 0]))
    sk = fkey[order]
    same = np.all(sk[1:] == sk[:-1], axis=1)
    nbr = np.full(nc * 4, -1, dtype=np.int64)
    a = order[:-1][same]
    b = order[1:][same]
    nbr[a] = b // 4
    nbr[b] = a // 4
    return nbr.reshape(nc, 4)


def decompose(mesh: Mesh) -> List[Block]:
    """Greedy BFS block decomposition of a conforming 2D quad mesh.

    Cells are absorbed into the current block when their four vertices
    admit exactly one conflict-free D4 placement on the block lattice;
    otherwise they seed/join another block.  The frontier is a priority
    queue keyed by |x| of the cell center so growth sweeps column by
    column: when a block wraps around an annular topology onto itself,
    the two fronts meet along a STRAIGHT column instead of the jagged
    diagonal a plain BFS produces — the leftover seam cells then form a
    clean sliver block whose stencil rows embed on the canvas.  Runs
    once per mesh on the host (python BFS over cells, ~1 us/cell).
    """
    if mesh.dim != 2:
        raise MultiblockError("multi-block packing is 2D only")
    cells = np.asarray(mesh.cells, dtype=np.int64)
    nc = len(cells)
    nbr = _face_neighbors(cells)

    block_of = np.full(nc, -1, dtype=np.int64)
    blocks: List[Block] = []

    for seed in range(nc):
        if block_of[seed] >= 0:
            continue
        bid = len(blocks)
        vcoord: Dict[int, Tuple[int, int]] = {}
        vat: Dict[Tuple[int, int], int] = {}
        centers = set()
        members: List[int] = []

        def assign(cell_id, coords):
            for v, xy in coords:
                vcoord[v] = xy
                vat[xy] = v
            cx = sum(xy[0] for _, xy in coords)
            cy = sum(xy[1] for _, xy in coords)
            centers.add((cx, cy))  # 4 * cell center, integer
            block_of[cell_id] = bid
            members.append(cell_id)
            return (abs(cx), abs(cy))

        cs = cells[seed]
        key0 = assign(
            seed,
            [(int(cs[i]), (int(_CORNERS[i, 0]), int(_CORNERS[i, 1])))
             for i in range(4)],
        )
        q = [(key0, seed)]
        while q:
            _, cur = heapq.heappop(q)
            for f in range(4):
                nb = int(nbr[cur, f])
                if nb < 0 or block_of[nb] >= 0:
                    continue
                vs = [int(v) for v in cells[nb]]
                known = [(i, vcoord[vs[i]]) for i in range(4)
                         if vs[i] in vcoord]
                if len(known) < 2:
                    continue
                placements: Dict[Tuple[int, int], list] = {}
                for R in _D4:
                    loc = _CORNERS @ R.T  # [4, 2] rotated corners
                    i0, xy0 = known[0]
                    t = np.array(xy0, dtype=np.int64) - loc[i0]
                    pts = loc + t
                    if any(
                        (int(pts[i, 0]), int(pts[i, 1])) != xy
                        for i, xy in known
                    ):
                        continue
                    center = (int(pts[:, 0].sum()), int(pts[:, 1].sum()))
                    if center in centers or center in placements:
                        continue
                    ok = True
                    coords = []
                    for i in range(4):
                        xy = (int(pts[i, 0]), int(pts[i, 1]))
                        v = vs[i]
                        if vcoord.get(v, xy) != xy or vat.get(xy, v) != v:
                            ok = False
                            break
                        coords.append((v, xy))
                    if ok:
                        placements[center] = coords
                if len(placements) == 1:
                    (coords,) = placements.values()
                    key = assign(nb, coords)
                    heapq.heappush(q, (key, nb))
        xs = np.array([xy[0] for xy in vcoord.values()])
        ys = np.array([xy[1] for xy in vcoord.values()])
        x0, y0 = xs.min(), ys.min()
        H = int(ys.max() - y0 + 1)
        W = int(xs.max() - x0 + 1)
        grid = np.full((H, W), -1, dtype=np.int64)
        for v, (x, y) in vcoord.items():
            grid[y - y0, x - x0] = v
        blocks.append(Block(grid=grid, cells=np.asarray(members)))
    return blocks


def _crop(grid: np.ndarray) -> np.ndarray:
    """Trim empty border rows/cols of a block grid."""
    occ = grid >= 0
    rows = np.flatnonzero(occ.any(axis=1))
    cols = np.flatnonzero(occ.any(axis=0))
    return grid[rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1]


def _cropped_area(grid: np.ndarray) -> int:
    occ = grid >= 0
    rows = np.flatnonzero(occ.any(axis=1))
    cols = np.flatnonzero(occ.any(axis=0))
    if len(rows) == 0:
        return 0
    return int((rows[-1] - rows[0] + 1) * (cols[-1] - cols[0] + 1))


def split_sparse_blocks(blocks: List[Block], min_fill: float = 0.85,
                        max_splits: int = 24) -> List[Block]:
    """Guillotine-split ragged block grids to tighten their bounding boxes.

    The BFS decomposition can merge several patches of a quilt into one
    block whose bounding box is mostly empty (e.g. the airfoil's C-mesh
    absorbed into an L-shaped union — pad ratio > 2).  Splitting along a
    row/column (the cut line is DUPLICATED so each half contains its
    interface vertices; the halves then stitch through the ordinary
    ghost-ring machinery) lets the shelf layout pack the pieces tightly.
    Cuts are greedy: the candidate (axis, line) minimizing the children's
    cropped area, accepted while it saves >= 10%.
    """
    work = [_crop(b.grid) for b in blocks if (b.grid >= 0).any()]
    out: List[np.ndarray] = []
    splits = 0
    while work:
        g = work.pop()
        if not (g >= 0).any():
            continue
        g = _crop(g)
        H, W = g.shape
        occ_frac = float((g >= 0).mean())
        if (
            splits >= max_splits
            or occ_frac >= min_fill
            or min(H, W) < 17
        ):
            out.append(g)
            continue
        best = None
        for axis in (0, 1):
            n = g.shape[axis]
            for cut in np.unique(
                np.linspace(8, n - 9, 15).astype(int)
            ):
                if axis == 0:
                    a, b2 = g[: cut + 1], g[cut:]
                else:
                    a, b2 = g[:, : cut + 1], g[:, cut:]
                area = _cropped_area(a) + _cropped_area(b2)
                if best is None or area < best[0]:
                    best = (area, axis, int(cut))
        if best is not None and best[0] <= 0.9 * H * W:
            _, axis, cut = best
            if axis == 0:
                work.append(g[: cut + 1])
                work.append(g[cut:])
            else:
                work.append(g[:, : cut + 1])
                work.append(g[:, cut:])
            splits += 1
        else:
            out.append(g)
    return [
        Block(grid=_crop(g), cells=np.empty(0, np.int64)) for g in out
    ]


def _shelf_layout(blocks, margin: int, pad_minor: int, pad_major: int,
                  stack: bool = False):
    """Shelf-pack the block grids onto one canvas.

    Each block consumes (h + 2) x (w + 2) cells (1-cell ghost ring).
    Rings of side-by-side blocks may abut (distinct cells), so a block's
    horizontal stride is w + 2 starting at x = 1.  Several candidate
    canvas widths (pad_minor multiples) are tried with a height-sorted
    first-fit shelf pack; the minimum-area layout wins — e.g. the
    airfoil's one wide + one narrow block pack side by side instead of
    leaving half the canvas masked.

    Returns (y_off, x_off, (Hc, Wc)) with y_off/x_off the canvas position
    of each block's grid[0, 0].
    """
    sizes = [(b.grid.shape[0], b.grid.shape[1]) for b in blocks]
    wmin = _round_up(max(w for _, w in sizes) + 2, pad_minor)
    wsum = _round_up(sum(w + 2 for _, w in sizes), pad_minor)
    if stack:
        candidates = [wmin]
    else:
        candidates = sorted(
            {min(wmin + j * pad_minor, wsum) for j in range(0, 33, 2)}
        )

    order = sorted(range(len(blocks)), key=lambda i: -sizes[i][0])
    best = None
    for Wc in candidates:
        shelves = []  # [y, height, x_used]
        pos = [None] * len(blocks)
        y = margin
        for i in order:
            h, w = sizes[i]
            placed = False
            for s in ([] if stack else shelves):
                if s[2] + w + 2 <= Wc and h + 2 <= s[1]:
                    pos[i] = (s[0] + 1, s[2] + 1)
                    s[2] += w + 2
                    placed = True
                    break
            if not placed:
                shelves.append([y, h + 2, w + 2])
                pos[i] = (y + 1, 1)
                y += h + 2
        Hc = _round_up(y + margin, pad_major)
        area = Hc * Wc
        if best is None or area < best[0]:
            best = (area, pos, (Hc, Wc))
    _, pos, canvas = best
    y_off = [p[0] for p in pos]
    x_off = [p[1] for p in pos]
    return y_off, x_off, canvas


class _EdgeCellLookup:
    """(i, j) vertex pair -> one mesh cell containing both (sorted keys)."""

    def __init__(self, cells: np.ndarray, n_vertices: int):
        nc, nv = cells.shape
        i = np.repeat(cells, nv, axis=1).reshape(-1)
        j = np.tile(cells, (1, nv)).reshape(-1)
        c = np.repeat(np.arange(nc, dtype=np.int64), nv * nv)
        sel = i != j
        key = i[sel] * n_vertices + j[sel]
        order = np.argsort(key, kind="stable")
        self.key = key[order]
        self.cell = c[sel][order]
        self.n = n_vertices

    def get(self, i: int, j: int) -> Optional[int]:
        k = i * self.n + j
        pos = np.searchsorted(self.key, k)
        if pos < len(self.key) and self.key[pos] == k:
            return int(self.cell[pos])
        return None


def pack_multiblock(
    data: SparseOfflineData,
    mesh: Mesh,
    pad_minor: int = 128,
    pad_major: int = 8,
    margin: int = 8,
    blocks: Optional[List[Block]] = None,
    layout: str = "shelf",
    slabs: int = 1,
) -> StructuredData:
    """Pack a block-decomposable 2D mesh onto a multi-block canvas.

    Raises MultiblockError when a stencil row cannot be embedded in its
    canvas 8-neighborhood (extraordinary corner) — callers fall back to
    ELL.  The shelf layout may (rarely) make two blocks' ghost rings
    collide at corners; packing then retries with single-column stacking
    before giving up.

    slabs > 1 (the JAX package's slab re-layout of the canvas rows for
    sharding) is not ported and raises NotImplementedError.
    """
    if data.dim != 2:
        raise MultiblockError("multi-block packing is 2D only")
    if data.is_constrained.any() and getattr(data, "hanging", None) is None:
        raise MultiblockError(
            "multi-block packing does not support periodic constraints"
        )
    if slabs > 1:
        _not_ported("multi-block slabs (_slabify)")
    if blocks is None:
        blocks = split_sparse_blocks(decompose(mesh))
    if layout == "shelf":
        try:
            return pack_multiblock(
                data, mesh, pad_minor, pad_major, margin, blocks,
                layout="shelf-once", slabs=slabs,
            )
        except MultiblockError:
            return pack_multiblock(
                data, mesh, pad_minor, pad_major, margin, blocks,
                layout="stack", slabs=slabs,
            )

    K = 8
    offsets = lattice_offsets(2)
    n_raw = data.n_nodes

    # ------------------------------------------------------------------
    # Canvas layout: blocks shelf-packed (side by side within row bands,
    # shelves stacked along axis 0), each block with a 1-cell ghost ring;
    # global masked margin bands top/bottom for the Pallas halo windows.
    # The canvas width is chosen among pad_minor multiples to minimize
    # total area (a lone narrow block in a wide canvas wastes rows).
    # ------------------------------------------------------------------
    y_off, x_off, canvas = _shelf_layout(
        blocks, margin, pad_minor, pad_major,
        stack=(layout == "stack"),
    )
    Hc, Wc = canvas
    n_pad = Hc * Wc

    # flat canvas offsets of the K lattice offsets (dy, dx):
    nbr_off = np.array([o[0] * Wc + o[1] for o in offsets], dtype=np.int64)

    # cell occupancy + ownership
    cell_vertex = np.full(n_pad, -1, dtype=np.int64)
    owner_cell = np.full(n_raw, -1, dtype=np.int64)
    occ_cells: List[np.ndarray] = []
    occ_verts: List[np.ndarray] = []
    in_block: List[Dict[int, int]] = []
    for b, blk in enumerate(blocks):
        yy, xx = np.nonzero(blk.grid >= 0)
        v = blk.grid[yy, xx]
        cell = (y_off[b] + yy) * Wc + (x_off[b] + xx)
        cell_vertex[cell] = v
        first = owner_cell[v] < 0
        owner_cell[v[first]] = cell[first]
        occ_cells.append(cell)
        occ_verts.append(v)
        in_block.append({int(a): int(c) for a, c in zip(v, cell)})
    if (owner_cell < 0).any():
        raise MultiblockError("mesh has vertices outside every block")

    # Ownership refinement: an interface vertex appears in several blocks;
    # its stencil row lives at the OWNER cell and must embed in that cell's
    # 8-neighborhood.  At rotational seams (a block wrapping onto itself,
    # e.g. an annulus absorbed into one block) the first occurrence may be
    # surrounded by unrelated grid vertices while a sliver-block occurrence
    # has the full neighborhood on-grid — pick the occurrence where the
    # most mesh neighbors are already lattice-adjacent.
    occ_count = np.zeros(n_raw, dtype=np.int64)
    for v in np.concatenate(occ_verts):
        occ_count[v] += 1
    indptr_, indices_ = data.indptr, data.indices
    for v in np.flatnonzero(occ_count > 1):
        nbrs = indices_[indptr_[v]:indptr_[v + 1]]
        best, best_n = None, -1
        for b in range(len(blocks)):
            cell = in_block[b].get(int(v))
            if cell is None:
                continue
            # score: neighbors already lattice-adjacent, plus free cells
            # available for ghost-ring placements of the missing ones
            # (a crowded rotational-seam neighborhood scores low even
            # when its adjacency count ties a clean sliver occurrence):
            adj = {int(cell_vertex[cell + o]) for o in nbr_off}
            cnt = sum(1 for w in nbrs if int(w) in adj)
            free = sum(1 for o in nbr_off if cell_vertex[cell + o] < 0)
            score = cnt + min(free, len(nbrs) - cnt)
            if score > best_n:
                best, best_n = cell, score
        owner_cell[v] = best

    # blocks containing each vertex (for shared-cell frame lookups):
    vertex_blocks: List[List[int]] = [[] for _ in range(n_raw)]
    for b in range(len(blocks)):
        for v in occ_verts[b]:
            vertex_blocks[v].append(b)

    # CSR directed edges
    indptr, indices = data.indptr, data.indices
    deg = indptr[1:] - indptr[:-1]
    i_e = np.repeat(np.arange(n_raw, dtype=np.int64), deg)
    j_e = indices.astype(np.int64)
    p_e = owner_cell[i_e]

    def unresolved_mask():
        bad = np.ones(len(i_e), dtype=bool)
        for o in nbr_off:
            bad &= cell_vertex[p_e + o] != j_e
        return bad

    # ------------------------------------------------------------------
    # Ghost-ring construction.  For each unresolved edge (i, j): map the
    # shared mesh cell (which lives in another block) into owner(i)'s
    # frame via an anchor edge whose endpoints are already placed, and
    # write the cell's remaining vertices onto ring cells.  Iterated:
    # corner diagonals resolve once their edge-ring neighbors exist.
    # ------------------------------------------------------------------
    eclook = _EdgeCellLookup(np.asarray(mesh.cells, np.int64), n_raw)
    tried: Dict[int, set] = {}
    for _owner_round in range(4):
        todo = np.flatnonzero(unresolved_mask())
        for _ in range(6):
            if len(todo) == 0:
                break
            progress = False
            remaining = []
            for eidx in todo:
                i, j, p = int(i_e[eidx]), int(j_e[eidx]), int(p_e[eidx])
                if any(cell_vertex[p + o] == j for o in nbr_off):
                    progress = True
                    continue
                if _place_via_shared_cell(
                    i, j, p, eclook, vertex_blocks, in_block, mesh,
                    cell_vertex, nbr_off, Wc, n_pad,
                ):
                    progress = True
                else:
                    remaining.append(eidx)
            todo = np.asarray(remaining, dtype=np.int64)
            if not progress:
                break
        bad = unresolved_mask()
        if not bad.any():
            break
        # Rows that could not embed at their current owner cell (e.g. the
        # crowded side of a rotational seam): retry with ownership moved
        # to another occurrence of the same vertex, where the ring has
        # room (the sliver side).  Ghost copies stay value-correct under
        # any ownership choice, so previously placed ring cells remain
        # valid.
        switched = False
        for i in np.unique(i_e[bad]):
            cur = int(owner_cell[i])
            seen = tried.setdefault(int(i), {cur})
            for b in range(len(blocks)):
                cell = in_block[b].get(int(i))
                if cell is not None and cell not in seen:
                    owner_cell[i] = cell
                    seen.add(cell)
                    switched = True
                    break
        if not switched:
            break
        p_e = owner_cell[i_e]

    bad = unresolved_mask()
    ev_rows = None
    if bad.any():
        # Extraordinary vertices: rows whose full stencil cannot embed in
        # their canvas 8-neighborhood (block corners of valence != 4).
        # Their rows are computed OUTSIDE the canvas kernels on a small
        # side ELL stencil (StructuredData.ev_side, solver/hyperbolic.py
        # Sideband) — the reference's uniform CSR treats them for free
        # (sparse_matrix_simd.h); here they cost O(#EV) XLA work per
        # substep while the other 99.9% of rows keep canvas speed.  A
        # mesh with MANY such rows is genuinely unstructured — fall back
        # to ELL.
        ev_rows = np.unique(i_e[bad])
        # Interface-like EV sets (2:1 AMR interfaces, block corners) scale
        # as the domain SURFACE, O(sqrt n) in 2D; a genuinely unstructured
        # mesh has EV rows at a volume fraction of nodes.  Accept up to
        # max(surface-scaled, n/64) side rows before falling back to ELL:
        if len(ev_rows) > max(64, n_raw // 64,
                              8 * int(np.sqrt(n_raw))):
            k = int(bad.sum())
            ex = [(int(a), int(b))
                  for a, b in zip(i_e[bad][:3], j_e[bad][:3])]
            raise MultiblockError(
                f"{k} stencil edges at {len(ev_rows)} rows not embeddable "
                f"(not block-structured), e.g. {ex}"
            )

    return _assemble_canvas(
        data, mesh, canvas, margin, cell_vertex, owner_cell,
        np.concatenate(occ_cells), np.concatenate(occ_verts),
        i_e, j_e, p_e, nbr_off, offsets, ev_rows=ev_rows,
    )


def _place_via_shared_cell(
    i, j, p, eclook, vertex_blocks, in_block, mesh, cell_vertex, nbr_off,
    Wc, n_pad,
):
    """Place the vertices of the mesh cell shared by (i, j) on ring cells
    around owner(i)'s cell p.  Returns True when j became reachable."""
    q_cell = eclook.get(i, j)
    if q_cell is None:
        return False
    qvs = [int(v) for v in mesh.cells[q_cell]]
    for B in vertex_blocks[qvs[0]]:
        pb = in_block[B]
        if all(v in pb for v in qvs):
            if _place_in_frame(
                qvs, pb, p, cell_vertex, nbr_off, Wc, n_pad
            ) and any(cell_vertex[p + o] == j for o in nbr_off):
                return True
    return False


def _place_in_frame(qvs, pb, p, cell_vertex, nbr_off, Wc, n_pad):
    """Map the quad `qvs` (placed in block frame `pb`) onto ring cells
    around canvas cell p via an anchor edge already placed near p."""

    def near(v):
        """Cell at or adjacent to p currently holding v (else None)."""
        if cell_vertex[p] == v:
            return p
        for o in nbr_off:
            t = p + o
            if 0 <= t < n_pad and cell_vertex[t] == v:
                return int(t)
        return None

    # anchor edges of the quad (deal.II ordering):
    for (a, b) in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 0), (3, 2),
                   (2, 0), (3, 1)):
        va, vb = qvs[a], qvs[b]
        ca, cb = near(va), near(vb)
        if ca is None or cb is None:
            continue
        d = cb - ca
        if d not in (1, -1, Wc, -Wc):
            continue
        nrm = Wc if abs(d) == 1 else 1
        fa = pb[va]
        dB = pb[vb] - fa
        # corner offsets of the quad in B's frame are {0, dB, nB, nB+dB}:
        rest = [pb[v] - fa for v in qvs if pb[v] - fa not in (0, dB)]
        if len(rest) != 2:
            continue
        if rest[0] + dB == rest[1]:
            nB = rest[0]
        elif rest[1] + dB == rest[0]:
            nB = rest[1]
        else:
            continue
        placed = False
        for sgn in (1, -1):
            trial = {}
            good = True
            n_match = 0
            for v in qvs:
                ob = pb[v] - fa
                alpha = beta = None
                for al in (0, 1):
                    for be in (0, 1):
                        if al * dB + be * nB == ob:
                            alpha, beta = al, be
                if alpha is None:
                    good = False
                    break
                tgt = ca + alpha * d + beta * sgn * nrm
                if not (0 <= tgt < n_pad):
                    good = False
                    break
                cv = cell_vertex[tgt]
                if cv >= 0:
                    if cv != v:
                        good = False
                        break
                    n_match += 1
                else:
                    trial[tgt] = v
            if not good:
                continue
            # the interior side of the anchor conflicts (A's own grid
            # vertices differ from the quad's), so the first conflict-
            # free side is the outward one; require at least the two
            # anchor vertices to match to avoid drifting placements:
            if n_match >= 2:
                for t, v in trial.items():
                    cell_vertex[t] = v
                placed = True
                break
        if placed:
            return True
    return False


def _assemble_canvas(
    data, mesh, canvas, margin, cell_vertex, owner_cell,
    all_cells, all_verts, i_e, j_e, p_e, nbr_off, offsets, ev_rows=None,
):
    """Build the StructuredData arrays + refresh maps from the layout."""
    Hc, Wc = canvas
    n_pad = Hc * Wc
    K = 8
    n_raw = data.n_nodes

    # --- slot of every directed edge at the owner cell (vectorized) ---
    slot_e = np.full(len(i_e), -1, dtype=np.int64)
    for k, o in enumerate(nbr_off):
        tgt = p_e + o
        hit = (slot_e < 0) & (cell_vertex[tgt] == j_e)
        slot_e[hit] = k
    is_ev_row = np.zeros(n_raw, dtype=bool)
    if ev_rows is not None:
        is_ev_row[ev_rows] = True
    unres = slot_e < 0
    if (unres & ~is_ev_row[i_e]).any():
        raise MultiblockError("internal: unresolved edge after ring pass")
    res = ~unres

    # --- static arrays at owner cells (resolved edges only; EV rows'
    # missing edges live in the side stencil, ev_side below) ---
    cij = np.zeros((n_pad, K, 2))
    mij = np.zeros((n_pad, K))
    mask = np.zeros((n_pad, K))
    cij[p_e[res], slot_e[res]] = data.cij[res]
    mij[p_e[res], slot_e[res]] = data.mij[res]
    mask[p_e[res], slot_e[res]] = 1.0

    cii = np.zeros((n_pad, 2))
    lumped = np.ones(n_pad)
    n_nbrs = np.ones(n_pad)
    node_mask = np.zeros(n_pad)
    positions = np.zeros((n_pad, 2))
    node_to_vertex = np.full(n_pad, -1, dtype=np.int64)

    oc = owner_cell
    # constrained (hanging) vertices occupy canvas cells inside their
    # block grid but carry no stencil row: node data is assigned for
    # ACTIVE rows only, so their cells stay masked with the safe defaults
    # (lumped/n_nbrs 1, cii 0).  Positions are set for every vertex so
    # interpolated states at masked cells stay physical (finite garbage
    # is only ever read through zero-mask slots).
    active = ~data.is_constrained
    act = np.flatnonzero(active)
    oca = oc[act]
    node_mask[oca] = 1.0
    lumped[oca] = data.lumped_mass[act]
    cii[oca] = data.cii[act]
    positions[oc] = data.positions
    deg = data.indptr[1:] - data.indptr[:-1]
    n_nbrs[oca] = np.maximum(deg[act], 1)
    node_to_vertex[oca] = act
    # hanging slaves route to their representative parent's cell, the
    # same semantics as the ELL layout (offline/ell.py vertex_to_node):
    vertex_to_node = oc[data.master]

    # --- node refresh map: every non-owner value cell <- owner ---
    nonowner = all_cells != oc[all_verts]
    ghost = all_cells[nonowner]
    gverts = all_verts[nonowner]
    ring_mask = cell_vertex >= 0
    ring_mask[all_cells] = False
    ring_cells = np.flatnonzero(ring_mask)
    ring_verts = cell_vertex[ring_cells]
    g_dst = np.concatenate([ghost, ring_cells])
    g_vsrc = np.concatenate([gverts, ring_verts])
    g_src = oc[g_vsrc]
    gmap_node = (g_dst.astype(np.int32), g_src.astype(np.int32))

    # static node values at ghost cells (host-side refresh) so that
    # neighbor reads of lumped mass etc. are valid without runtime work:
    for arr in (lumped, n_nbrs, cii, positions):
        arr[g_dst] = arr[g_src]

    # --- edge refresh map -------------------------------------------------
    # ghost cell g hosting v: slot s holds the edge value (v -> w) where
    # w = cell_vertex[g + o_s]; source = owner(v)'s slot for that edge.
    # Vectorized: look up (v, w) pairs in the sorted directed-edge list.
    ekey = i_e * (n_pad + 1) + 0  # placeholder to define dtype
    ekey = i_e * n_raw + j_e
    eorder = np.argsort(ekey, kind="stable")
    ekey_s = ekey[eorder]
    slot_s = slot_e[eorder]

    gcell = np.repeat(g_dst, K)
    gvert = np.repeat(g_vsrc, K)
    gslot = np.tile(np.arange(K, dtype=np.int64), len(g_dst))
    tgt = gcell + nbr_off[gslot]
    ok = (tgt >= 0) & (tgt < n_pad)
    w = np.where(ok, cell_vertex[np.clip(tgt, 0, n_pad - 1)], -1)
    ok &= w >= 0
    key = gvert * n_raw + np.where(ok, w, 0)
    pos = np.searchsorted(ekey_s, key)
    pos = np.clip(pos, 0, len(ekey_s) - 1)
    ok &= ekey_s[pos] == key
    src_slot = slot_s[pos]
    ok &= src_slot >= 0  # EV-row edges without an owner slot: the side
    #                      scatter (ev_side e_dst) provides those entries
    e_dst = (gslot[ok] * n_pad + gcell[ok]).astype(np.int32)
    e_src = (src_slot[ok] * n_pad + oc[gvert[ok]]).astype(np.int32)
    gmap_edge = (e_dst, e_src)

    # fill static edge arrays at ghost cells (host-side gmap application)
    # so the transpose-roll construction of cij_t / cmax is exact at
    # reader rows adjacent to interfaces:
    for arr in (cij, mij, mask):
        flat = np.moveaxis(arr, 1, 0).reshape((K * n_pad,) + arr.shape[2:])
        flat[e_dst] = flat[e_src]
        arr[:] = np.moveaxis(
            flat.reshape((K, n_pad) + arr.shape[2:]), 0, 1
        )

    sd = _finalize_structured(
        data, mesh, 2, K, offsets, canvas, (margin, 0), n_pad,
        None, None, cij, mij, mask, cii, lumped, n_nbrs, node_mask,
        positions, node_to_vertex, vertex_to_node, None,
        active, ghost_bands=(None, None),
        slab_spec=None, axis0_periodic=False,
    )
    value_mask = node_mask.copy()
    value_mask[g_dst] = 1.0
    sd.value_mask = value_mask
    sd.gmap_node = gmap_node
    sd.gmap_edge = gmap_edge
    sd.edge_map = (
        np.flatnonzero(res).astype(np.int64),
        (p_e[res] * K + slot_e[res]).astype(np.int64),
    )

    # --- extraordinary-vertex side stencil --------------------------------
    # Rows whose stencil exceeds the canvas 8-neighborhood are computed
    # on a tiny ELL stencil in XLA (solver/hyperbolic.py Sideband) and
    # scattered back after each kernel phase.  Recorded here: the side
    # ELL arrays (neighbor OWNER cells, so gathers always read real
    # values), the transposed-edge gather entries into the flat [K * n]
    # canvas edge layout, and the scatter targets where readers'
    # transpose routes expect the side edges' values (their own owner
    # slot when embedded, plus the route entry (K-1-k_j, oc[j] + off_kj)
    # of every reader j — disjoint-by-frame, deduplicated, dst-sorted).
    if ev_rows is not None and len(ev_rows):
        R = np.asarray(ev_rows, dtype=np.int64)
        r = len(R)
        indptr = data.indptr
        degR = (indptr[R + 1] - indptr[R]).astype(np.int64)
        Ks = int(degR.max())
        cols_v = np.tile(R[:, None], (1, Ks))
        epos = np.zeros((r, Ks), np.int64)
        smask = np.zeros((r, Ks))
        for ri, row in enumerate(R):
            a, b = int(indptr[row]), int(indptr[row + 1])
            cols_v[ri, : b - a] = data.indices[a:b]
            epos[ri, : b - a] = np.arange(a, b)
            smask[ri, : b - a] = 1.0
        live = smask.reshape(-1) > 0
        side_cij = np.where(
            smask[..., None] > 0, np.asarray(data.cij)[epos], 0.0
        )
        side_mij = np.asarray(data.mij)[epos] * smask
        # reverse-edge canvas entries (edges INTO an EV always resolve):
        ekey2 = i_e * n_raw + j_e
        eord2 = np.argsort(ekey2, kind="stable")
        ekey2_s = ekey2[eord2]
        key_rev = (cols_v * n_raw + R[:, None]).reshape(-1)
        rp = np.clip(np.searchsorted(ekey2_s, key_rev), 0, len(ekey2_s) - 1)
        hit = (ekey2_s[rp] == key_rev) & live
        if not hit[live].all():
            raise MultiblockError("EV side row with asymmetric edge")
        rev_e = eord2[rp]
        rev_slot_raw = np.where(live, slot_e[rev_e], 0)
        # Reverse edges with no canvas slot connect two EV rows (adjacent
        # extraordinary vertices — e.g. the coarse interface line of a
        # 2:1 AMR interface, where every interface row is EV).  Their
        # transposed-edge values live in the side stencil itself: record
        # a side-internal transpose index rj * Ks + k' (into the [r, Ks]
        # flat side edge layout, cols_v[rj, k'] == i) instead of a canvas
        # entry; the solver's Sideband.edge_T where-selects between the
        # canvas gather and the side gather.
        is_side_rev = live & (rev_slot_raw < 0)
        rev_slot = np.where(is_side_rev, 0, rev_slot_raw)
        trans_side = np.full(r * Ks, -1, dtype=np.int64)
        if is_side_rev.any():
            side_pos = np.full(n_raw, -1, dtype=np.int64)
            side_pos[R] = np.arange(r)
            i_flat = np.repeat(R, Ks)
            j_flat = cols_v.reshape(-1)
            jv = j_flat[is_side_rev]
            iv = i_flat[is_side_rev]
            if (side_pos[jv] < 0).any():
                raise MultiblockError(
                    "reverse edge without canvas slot at a non-EV row"
                )
            # k' with cols_v[side_pos[j], k'] == i: look up the directed
            # side edge (j -> i) in the sorted (row, col) key list (dead
            # slots hold self-keys R * n + R, which never match j != i):
            skey = i_flat * n_raw + j_flat
            sorder = np.argsort(skey, kind="stable")
            want = jv * n_raw + iv
            p2 = np.clip(np.searchsorted(skey[sorder], want), 0, r * Ks - 1)
            if not (skey[sorder][p2] == want).all():
                raise MultiblockError("EV-EV edge without side reverse")
            trans_side[np.flatnonzero(is_side_rev)] = sorder[p2]
        j_cell = oc[cols_v.reshape(-1)]
        trans = np.where(live & ~is_side_rev, rev_slot * n_pad + j_cell, 0)
        # scatter targets (side-internal edges have no canvas readers —
        # both endpoints' rows are side-computed — so no route for them):
        own_slot = np.where(live, slot_e[epos.reshape(-1)], -1)
        own_cell = oc[np.tile(R[:, None], (1, Ks)).reshape(-1)]
        dst_own = own_slot * n_pad + own_cell
        route = (K - 1 - rev_slot) * n_pad + (j_cell + nbr_off[rev_slot])
        route_ok = live & ~is_side_rev
        eidx = np.arange(r * Ks)
        d_all = np.concatenate(
            [dst_own[live & (own_slot >= 0)], route[route_ok]]
        )
        s_all = np.concatenate(
            [eidx[live & (own_slot >= 0)], eidx[route_ok]]
        )
        d_u, first = np.unique(d_all, return_index=True)
        sd.ev_side = {
            "rows": R,
            "cells": oc[R].astype(np.int64),
            "cols_cell": oc[cols_v].astype(np.int64),  # [r, Ks]
            "cij": side_cij,  # [r, Ks, dim]
            "mij": side_mij,  # [r, Ks]
            "mask": smask,  # [r, Ks]
            "cii": np.asarray(data.cii)[R],
            "m_lumped": np.asarray(data.lumped_mass)[R],
            "n_nbrs": degR,
            "trans": trans.reshape(r, Ks),  # flat [K * n] entries
            # side-internal transpose: rj * Ks + k' into the [r, Ks] flat
            # side layout where >= 0, else the canvas `trans` applies:
            "trans_side": trans_side.reshape(r, Ks),
            "edst": d_u.astype(np.int64),
            "esrc": s_all[first].astype(np.int64),  # flat [r * Ks] index
        }
        # the half-slot symmetric path is not supported alongside EV
        # side rows (untested interplay); keep the two-direction default
        sd.sym_fixup = None
        return sd

    # --- symmetric-Riemann interface fixup list ---------------------------
    # The lattice k <-> K-1-k transposed-slot pairing (one Riemann solve
    # per undirected edge, hyperbolic.py phase_e_alpha half=True) breaks
    # at block interfaces: the transpose route of a slot k >= K/2 edge
    # reads slot K-1-k of canvas cell q = p + off_k, and at an interface
    # that entry may refresh from an owner slot >= K/2 (uncomputed under
    # the half-slot evaluation) or resolve to nothing at all.  Rather
    # than enumerate break modes, trace the route of EVERY owner directed
    # edge at a slot k >= K/2 on the host and record each mismatch as a
    # fixup: the solver evaluates those edges in both directions (the
    # reference's d_ij = max(d_ij, d_ji),
    # hyperbolic_module.template.h:461-490) and scatters the
    # cmax-normalized result straight into the half lambda canvas at the
    # route's read entry (K-1-k, q) — each such entry has exactly ONE
    # consumer (the broken route itself: q is a ghost/masked cell, and
    # the route's (k', q) |-> (k, p) correspondence is bijective), so
    # the downstream d reconstruction (kernel _d_win_sym / the XLA roll
    # transpose) needs no other change and block interiors keep the
    # half-slot evaluation at full speed.
    K2 = K // 2
    edge_at = np.full(K * n_pad, -1, dtype=np.int64)  # owner rows
    edge_at[slot_e * n_pad + p_e] = np.arange(len(i_e))
    gsrc = np.full(K * n_pad, -1, dtype=np.int64)  # ghost refresh map
    gsrc[e_dst.astype(np.int64)] = e_src.astype(np.int64)
    sel = np.flatnonzero(slot_e >= K2)
    q_s = p_e[sel] + nbr_off[slot_e[sel]]
    in_rng = (q_s >= 0) & (q_s < n_pad)
    f_s = (K - 1 - slot_e[sel]) * n_pad + np.clip(q_s, 0, n_pad - 1)
    # effective source entry: the owner row itself, or one ghost hop
    own_hit = edge_at[f_s] >= 0
    eff = np.where(own_hit, f_s, gsrc[f_s])
    e2 = edge_at[np.clip(eff, 0, K * n_pad - 1)]
    valid = in_rng & (eff >= 0) & (e2 >= 0)
    computed = valid & (eff // n_pad < K2)  # half pass fills slots < K2
    matches = valid & (i_e[np.clip(e2, 0, None)] == j_e[sel]) \
        & (j_e[np.clip(e2, 0, None)] == i_e[sel])
    bad = ~(computed & matches)
    fix = sel[bad]
    dst = f_s[bad]  # the route's read entry in the HALF canvas layout
    if (edge_at[dst] >= 0).any():
        # a fixed entry would shadow a real owner edge (cannot happen for
        # ghost-ring-separated blocks; guard for exotic packings): the
        # half-slot evaluation is unsafe here — no fixup list, the solver
        # falls back to the two-direction evaluation
        sd.sym_fixup = None
        return sd
    order = np.argsort(dst, kind="stable")  # sorted-scatter hint
    fix, dst = fix[order], dst[order]
    if len(fix):
        # reverse CSR entry of each fixup edge (exists: symmetric pattern)
        key_rev = j_e[fix] * n_raw + i_e[fix]
        rpos = np.searchsorted(ekey_s, key_rev)
        assert (ekey_s[rpos] == key_rev).all()
        rev = eorder[rpos]
        c_f = np.asarray(data.cij)[fix]
        c_r = np.asarray(data.cij)[rev]
        # the consumer reconstructs d = lam_entry * cmax[k, p]; cmax is
        # built from the ghost-filled static cij (exact at interfaces):
        inv_cmax = 1.0 / np.maximum(
            np.linalg.norm(c_f, axis=1), np.linalg.norm(c_r, axis=1)
        )
        sd.sym_fixup = {
            "dst": dst.astype(np.int64),
            "i": oc[i_e[fix]].astype(np.int64),
            "j": oc[j_e[fix]].astype(np.int64),
            "c_f": c_f,
            "c_r": c_r,
            "inv_cmax": inv_cmax,
        }
    else:
        sd.sym_fixup = {
            "dst": np.zeros(0, np.int64),
            "i": np.zeros(0, np.int64),
            "j": np.zeros(0, np.int64),
            "c_f": np.zeros((0, 2)),
            "c_r": np.zeros((0, 2)),
            "inv_cmax": np.zeros(0),
        }
    return sd


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to the torch package yet (ROADMAP queue 1, "
        '"Multi-block canvases": the extruded quilts and multi-block slabs)'
    )


def pack_multiblock_extruded(*args, **kwargs) -> StructuredData:
    """The extruded multi-block quilt (a 2D quilt x a z lattice, the 3D
    airfoil): not ported; raises NotImplementedError."""
    _not_ported("pack_multiblock_extruded (extruded multi-block quilts)")
