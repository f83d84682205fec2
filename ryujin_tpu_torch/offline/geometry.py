"""The port's own copy of ryujin_tpu/offline/geometry.py (plain numpy; the port imports
nothing of ryujin_tpu).  The airfoil generator is left out:
it needs utils/cubic_spline.py and offline/airfoil_profiles.py, which are
not copied yet.  The original header follows.

Parameter-driven mesh generator library.

Mirrors the geometry library of the reference
(source/geometry_library.h:35 and geometry_*.h) with
TPU-friendly host-side NumPy mesh construction:

  * ``rectangular domain``  (geometry_rectangular_domain.h)
  * ``step``                (geometry_step.h:163, Mach-3 forward facing step)
  * ``cylinder``            (geometry_cylinder.h)
  * ``annulus``             (geometry_annulus.h)
  * ``disk``                (geometry_disk.h)
  * ``wall``                (geometry_wall.h)
  * ``wave tank``           (geometry_tank.h)

Each generator returns a :class:`ryujin_tpu_torch.offline.mesh.Mesh`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .mesh import Boundary, Mesh


def _lattice_mesh_2d(
    x: np.ndarray, y: np.ndarray, cell_mask: Optional[np.ndarray] = None
) -> Mesh:
    """Build a tensor-product quad mesh from 1D coordinate arrays.

    cell_mask: optional [ny_cells, nx_cells] bool; False cells are removed
    (used for the forward-facing step).  Vertices not referenced by any cell
    are dropped.  The surviving lattice structure is recorded in
    ``structured_shape`` / ``structured_index`` for the structured backend.
    """
    nx, ny = len(x), len(y)
    X, Y = np.meshgrid(x, y, indexing="xy")  # [ny, nx]
    verts = np.stack([X.ravel(), Y.ravel()], axis=1)

    ix, iy = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="xy")
    ix, iy = ix.ravel(), iy.ravel()
    if cell_mask is not None:
        keep = cell_mask[iy, ix]
        ix, iy = ix[keep], iy[keep]
    v0 = iy * nx + ix
    cells = np.stack([v0, v0 + 1, v0 + nx, v0 + nx + 1], axis=1)

    # compress vertices
    used = np.zeros(nx * ny, dtype=bool)
    used[cells.ravel()] = True
    new_id = -np.ones(nx * ny, dtype=np.int64)
    new_id[used] = np.arange(used.sum())
    cells = new_id[cells]
    verts_kept = verts[used]
    lattice_idx = np.stack(
        [np.arange(nx * ny) % nx, np.arange(nx * ny) // nx], axis=1
    )[used]

    # boundary faces: cell faces not shared by two cells
    face_local = [
        np.array([0, 2]),  # -x
        np.array([1, 3]),  # +x
        np.array([0, 1]),  # -y
        np.array([2, 3]),  # +y
    ]
    faces = np.concatenate([cells[:, fl] for fl in face_local], axis=0)
    fs = np.sort(faces, axis=1)
    key = fs[:, 0] * (verts_kept.shape[0] + 1) + fs[:, 1]
    _, first, counts = np.unique(key, return_index=True, return_counts=True)
    bidx = first[counts == 1]
    bfaces = faces[bidx]

    return Mesh(
        dim=2,
        vertices=verts_kept,
        cells=cells,
        boundary_faces=bfaces,
        boundary_ids=np.zeros(len(bfaces), dtype=np.int32),
        structured_shape=(nx, ny),
        structured_index=lattice_idx,
    )


def rectangular_domain(
    point_left: Sequence[float],
    point_right: Sequence[float],
    subdivisions: Sequence[int],
    refinement: int,
    boundary_conditions: Sequence[int],
    dim: int = 2,
    grading_pull_back: Optional[Sequence[str]] = None,
    grading_push_forward: Optional[Sequence[str]] = None,
) -> Mesh:
    """Rectangular domain generator (geometry_rectangular_domain.h).

    boundary_conditions: per-face Boundary ids ordered (left, right) in 1D,
    (left, right, bottom, top) in 2D, (+back/front appended) in 3D.

    grading_pull_back / grading_push_forward: optional per-component
    python expressions over x[, y[, z]] defining a chart manifold; the
    *coarse* subdivisions stay uniform, refinement midpoints are computed
    as push_forward(mean(pull_back(...))) — the analog of the reference's
    FunctionManifold grading (geometry_rectangular_domain.h:145-153),
    e.g. the Daru–Tenaud wall clustering pull_back ["x", "(1-y)**2"],
    push_forward ["x", "1-y**0.5"].
    """
    point_left = np.asarray(point_left, dtype=np.float64)
    point_right = np.asarray(point_right, dtype=np.float64)
    subs = [int(s) * 2**refinement for s in subdivisions]

    if grading_push_forward is not None or grading_pull_back is not None:
        if grading_pull_back is None or grading_push_forward is None:
            raise ValueError("grading needs both pull back and push forward")
        # chart-averaging manifold: build the UNREFINED mesh, attach the
        # grading manifold everywhere, then refine through it
        coarse = rectangular_domain(
            point_left, point_right, subdivisions, 0,
            boundary_conditions, dim=dim,
        )
        chart = _grading_manifold(
            grading_pull_back, grading_push_forward, dim
        )
        coarse.manifolds = dict(coarse.manifolds or {})
        coarse.manifolds[7] = chart
        coarse.edge_manifold_selectors = dict(
            coarse.edge_manifold_selectors or {}
        )
        coarse.edge_manifold_selectors[7] = lambda pts: np.ones(
            len(pts), dtype=bool
        )
        if coarse.face_manifold_ids is None:
            coarse.face_manifold_ids = np.full(
                len(coarse.boundary_faces), 7, dtype=np.int32
            )
        else:
            coarse.face_manifold_ids[coarse.face_manifold_ids == 0] = 7
        return coarse.refine_global(refinement)

    if dim == 1:
        x = np.linspace(point_left[0], point_right[0], subs[0] + 1)
        verts = x[:, None]
        cells = np.stack([np.arange(subs[0]), np.arange(1, subs[0] + 1)], axis=1)
        bfaces = np.array([[0], [subs[0]]], dtype=np.int64)
        bids = np.array(boundary_conditions[:2], dtype=np.int32)
        mesh = Mesh(
            dim=1, vertices=verts, cells=cells,
            boundary_faces=bfaces, boundary_ids=bids,
            structured_shape=(subs[0] + 1,),
            structured_index=np.arange(subs[0] + 1)[:, None],
        )
        _maybe_build_periodic_pairs_1d(mesh, point_left, point_right)
        return mesh

    if dim == 2:
        x = np.linspace(point_left[0], point_right[0], subs[0] + 1)
        y = np.linspace(point_left[1], point_right[1], subs[1] + 1)
        mesh = _lattice_mesh_2d(x, y)
        _tag_rect_boundaries_2d(mesh, point_left, point_right, boundary_conditions)
        _maybe_build_periodic_pairs(mesh, point_left, point_right)
        return mesh

    if dim == 3:
        return _rectangular_domain_3d(
            point_left, point_right, subs, boundary_conditions
        )

    raise ValueError(f"unsupported dim={dim}")


def _grading_manifold(pull_back, push_forward, dim):
    """Chart manifold from per-component numpy expressions: refinement
    midpoints are push_forward(mean(pull_back(points)))."""
    pb = [compile(str(e), "<grading>", "eval") for e in pull_back]
    pf = [compile(str(e), "<grading>", "eval") for e in push_forward]
    if len(pb) != dim or len(pf) != dim:
        raise ValueError("grading needs one expression per dimension")

    def apply(codes, pts):  # [..., dim] -> [..., dim]
        env = {"__builtins__": {}, "np": np}
        for k in ("sqrt", "exp", "log", "sin", "cos", "tanh", "abs",
                  "sign", "minimum", "maximum", "pi", "where"):
            env[k] = getattr(np, k)
        env["x"] = pts[..., 0]
        if dim >= 2:
            env["y"] = pts[..., 1]
        if dim >= 3:
            env["z"] = pts[..., 2]
        out = [
            np.broadcast_to(
                np.asarray(eval(c, env), dtype=np.float64),  # noqa: S307
                pts[..., 0].shape,
            )
            for c in codes
        ]
        return np.stack(out, axis=-1)

    def manifold(pts):  # [k, nv, dim] -> [k, dim]
        return apply(pf, apply(pb, pts).mean(axis=1))

    return manifold


def _tag_rect_boundaries_2d(mesh, pl, pr, bcs):
    """bcs = (left, right, bottom, top)."""
    centers = mesh.vertices[mesh.boundary_faces].mean(axis=1)
    tol = 1e-10 * max(np.abs(pl).max(), np.abs(pr).max(), 1.0)
    ids = mesh.boundary_ids
    ids[np.abs(centers[:, 0] - pl[0]) < tol] = bcs[0]
    ids[np.abs(centers[:, 0] - pr[0]) < tol] = bcs[1]
    ids[np.abs(centers[:, 1] - pl[1]) < tol] = bcs[2]
    ids[np.abs(centers[:, 1] - pr[1]) < tol] = bcs[3]


def _maybe_build_periodic_pairs_1d(mesh: Mesh, pl, pr) -> None:
    if np.any(mesh.boundary_ids == Boundary.periodic):
        left = int(np.argmin(np.abs(mesh.vertices[:, 0] - pl[0])))
        right = int(np.argmin(np.abs(mesh.vertices[:, 0] - pr[0])))
        mesh.periodic_pairs = np.array([[right, left]], dtype=np.int64)


def _maybe_build_periodic_pairs(mesh: Mesh, pl, pr) -> None:
    """Identify periodic vertex pairs for faces tagged Boundary.periodic."""
    per_faces = mesh.boundary_faces[mesh.boundary_ids == Boundary.periodic]
    if len(per_faces) == 0:
        return
    vids = np.unique(per_faces.ravel())
    coords = mesh.vertices[vids]
    extent = pr - pl
    pairs = []
    for d in range(mesh.dim):
        lo = np.abs(coords[:, d] - pl[d]) < 1e-10 * max(1.0, abs(extent[d]))
        hi = np.abs(coords[:, d] - pr[d]) < 1e-10 * max(1.0, abs(extent[d]))
        lo_ids, hi_ids = vids[lo], vids[hi]
        if len(lo_ids) == 0:
            continue
        # match by the remaining coordinates
        other = [k for k in range(mesh.dim) if k != d]
        lo_key = mesh.vertices[lo_ids][:, other]
        hi_key = mesh.vertices[hi_ids][:, other]
        lo_order = np.lexsort(lo_key.T)
        hi_order = np.lexsort(hi_key.T)
        assert len(lo_ids) == len(hi_ids)
        pairs.append(np.stack([hi_ids[hi_order], lo_ids[lo_order]], axis=1))
    if pairs:
        mesh.periodic_pairs = np.concatenate(pairs, axis=0)


def _rectangular_domain_3d(pl, pr, subs, bcs) -> Mesh:
    nx, ny, nz = subs[0] + 1, subs[1] + 1, subs[2] + 1
    x = np.linspace(pl[0], pr[0], nx)
    y = np.linspace(pl[1], pr[1], ny)
    z = np.linspace(pl[2], pr[2], nz)
    Z, Y, X = np.meshgrid(z, y, x, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    iz, iy, ix = np.meshgrid(
        np.arange(nz - 1), np.arange(ny - 1), np.arange(nx - 1), indexing="ij"
    )
    v0 = (iz * ny + iy) * nx + ix
    v0 = v0.ravel()
    dx, dy, dz = 1, nx, nx * ny
    cells = np.stack(
        [v0, v0 + dx, v0 + dy, v0 + dx + dy,
         v0 + dz, v0 + dx + dz, v0 + dy + dz, v0 + dx + dy + dz],
        axis=1,
    )

    face_local = [
        np.array([0, 2, 4, 6]),
        np.array([1, 3, 5, 7]),
        np.array([0, 1, 4, 5]),
        np.array([2, 3, 6, 7]),
        np.array([0, 1, 2, 3]),
        np.array([4, 5, 6, 7]),
    ]
    faces = np.concatenate([cells[:, fl] for fl in face_local], axis=0)
    fs = np.sort(faces, axis=1)
    nvv = verts.shape[0] + 1
    key = ((fs[:, 0] * nvv + fs[:, 1]) * nvv + fs[:, 2]) * nvv + fs[:, 3]
    _, first, counts = np.unique(key, return_index=True, return_counts=True)
    bfaces = faces[first[counts == 1]]
    centers = verts[bfaces].mean(axis=1)
    tol = 1e-10 * max(np.abs(pl).max(), np.abs(pr).max(), 1.0)
    ids = np.zeros(len(bfaces), dtype=np.int32)
    # order: left,right,bottom,top,back,front
    ids[np.abs(centers[:, 0] - pl[0]) < tol] = bcs[0]
    ids[np.abs(centers[:, 0] - pr[0]) < tol] = bcs[1]
    ids[np.abs(centers[:, 1] - pl[1]) < tol] = bcs[2]
    ids[np.abs(centers[:, 1] - pr[1]) < tol] = bcs[3]
    ids[np.abs(centers[:, 2] - pl[2]) < tol] = bcs[4]
    ids[np.abs(centers[:, 2] - pr[2]) < tol] = bcs[5]
    iz3, iy3, ix3 = np.meshgrid(
        np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij"
    )
    mesh = Mesh(
        dim=3, vertices=verts, cells=cells,
        boundary_faces=bfaces, boundary_ids=ids,
        structured_shape=(nx, ny, nz),
        structured_index=np.stack(
            [ix3.ravel(), iy3.ravel(), iz3.ravel()], axis=1
        ),
    )
    _maybe_build_periodic_pairs(mesh, pl, pr)
    return mesh


def spherical_manifold(center: Sequence[float]):
    """Endpoint-averaging manifold (dealii::SphericalManifold analog).

    Returns a callable mapping face endpoint coordinates [k, nv, dim] to new
    midpoints [k, dim]: the spherical average around `center` (mean radius,
    normalized mean direction).
    """
    c = np.asarray(center, dtype=np.float64)

    def avg(endpoints: np.ndarray) -> np.ndarray:
        d = endpoints - c
        r = np.linalg.norm(d, axis=2)  # [k, nv]
        dirs = d / np.maximum(r[..., None], 1e-300)
        mean_dir = dirs.mean(axis=1)
        mean_dir /= np.maximum(
            np.linalg.norm(mean_dir, axis=1, keepdims=True), 1e-300
        )
        return c + r.mean(axis=1)[:, None] * mean_dir

    return avg


def step(
    length: float = 3.0,
    height: float = 1.0,
    step_position: float = 0.6,
    step_height: float = 0.2,
    refinement: int = 0,
) -> Mesh:
    """Mach-3 forward facing step (geometry_step.h:34-131).

    Follows the reference construction exactly: build the 15x4 + 3x1 coarse
    lattice, tag boundary ids (slip top/bottom/step, dirichlet inflow,
    do_nothing outflow), refine 4 times plain, then round off the re-entrant
    corner: attach a spherical manifold (radius 0.0125) to the two boundary
    faces containing the corner vertex and snap the corner-cell vertices onto
    the arc (geometry_step.h:92-129).  `refinement` further global
    refinements are applied with the manifold active (the reference does
    these later in Discretization::prepare).
    """
    x = np.linspace(0.0, length, 16)
    y = np.linspace(0.0, height, 6)
    assert abs(x[3] - step_position) < 1e-12 and abs(y[1] - step_height) < 1e-12
    cm = np.ones((5, 15), dtype=bool)
    cm[0, 3:] = False  # remove the step cells below y=0.2, x>0.6
    mesh = _lattice_mesh_2d(x, y, cm)

    centers = mesh.vertices[mesh.boundary_faces].mean(axis=1)
    ids = mesh.boundary_ids
    ids[:] = Boundary.do_nothing
    interior_x = (centers[:, 0] > 1e-6) & (centers[:, 0] < length - 1e-6)
    ids[interior_x] = Boundary.slip
    ids[centers[:, 0] < 1e-6] = Boundary.dirichlet

    mesh = mesh.refine_global(4)

    # Corner rounding (geometry_step.h:92-129): radius r circle centered at
    # (step_position + r, step_height - r).
    r = 0.0125
    corner = np.array([step_position, step_height])
    mesh.manifolds = {1: spherical_manifold([step_position + r, step_height - r])}

    # Tag the boundary faces containing the corner vertex:
    fv = mesh.vertices[mesh.boundary_faces]  # [nf, 2, 2]
    touches = (np.linalg.norm(fv - corner, axis=2) < 1e-6).any(axis=1)
    fm = np.zeros(len(mesh.boundary_faces), dtype=np.int32)
    fm[touches] = 1
    mesh.face_manifold_ids = fm

    # Snap the vertices of the cells touching the corner vertex:
    cv = mesh.vertices[mesh.cells]  # [nc, 4, 2]
    corner_cells = (np.linalg.norm(cv - corner, axis=2) < 1e-6).any(axis=1)
    vids = np.unique(mesh.cells[corner_cells].ravel())
    v = mesh.vertices
    snap = r * (1.0 - np.sqrt(0.5))
    for vid in vids:
        if (
            abs(v[vid, 0] - step_position) < 1e-6
            and v[vid, 1] > step_height - 1e-6
        ):
            v[vid, 0] = step_position + snap
        if (
            abs(v[vid, 1] - step_height) < 1e-6
            and v[vid, 0] < step_position + 0.005
        ):
            v[vid, 1] = step_height - snap

    if refinement:
        mesh = mesh.refine_global(refinement)
    return mesh


def extrude(
    mesh2: Mesh,
    z0: float,
    z1: float,
    n_layers: int,
    bc_minus: int = Boundary.slip,
    bc_plus: int = Boundary.slip,
) -> Mesh:
    """Extrude a 2D quad mesh into a 3D hex mesh of n_layers cell layers.

    The analog of dealii::GridGenerator::extrude_triangulation
    (used by the reference's 3D cylinder, geometry_cylinder.h:162).
    Side faces inherit the 2D boundary ids; the z- / z+ faces get
    bc_minus / bc_plus.  Periodic pairs and lattice structure are carried
    along when present (z becomes the slowest lattice dim).
    """
    n2 = mesh2.n_vertices
    zs = np.linspace(z0, z1, n_layers + 1)
    verts = np.concatenate(
        [
            np.concatenate(
                [mesh2.vertices, np.full((n2, 1), z)], axis=1
            )
            for z in zs
        ],
        axis=0,
    )
    cells = np.concatenate(
        [
            np.concatenate(
                [mesh2.cells + l * n2, mesh2.cells + (l + 1) * n2], axis=1
            )
            for l in range(n_layers)
        ],
        axis=0,
    )
    # side faces: 2D face [a, b] -> quad [a, b, a', b'] per layer
    side_faces = np.concatenate(
        [
            np.concatenate(
                [
                    mesh2.boundary_faces + l * n2,
                    mesh2.boundary_faces + (l + 1) * n2,
                ],
                axis=1,
            )
            for l in range(n_layers)
        ],
        axis=0,
    )
    side_ids = np.tile(mesh2.boundary_ids, n_layers)
    bottom = mesh2.cells.copy()
    top = mesh2.cells + n_layers * n2
    bfaces = np.concatenate([side_faces, bottom, top], axis=0)
    ids = np.concatenate(
        [
            side_ids,
            np.full(len(bottom), bc_minus, dtype=np.int32),
            np.full(len(top), bc_plus, dtype=np.int32),
        ]
    )
    fm = None
    manifolds = None
    if mesh2.face_manifold_ids is not None and mesh2.manifolds:
        fm = np.concatenate(
            [
                np.tile(mesh2.face_manifold_ids, n_layers),
                np.zeros(2 * len(bottom), dtype=np.int32),
            ]
        )

        def wrap(m2):
            def m3(pts):  # [k, nv, 3] -> [k, 3]
                xy = m2(pts[..., :2])
                z = pts[..., 2].mean(axis=-1)
                return np.concatenate([xy, z[:, None]], axis=1)

            return m3

        manifolds = {mid: wrap(m) for mid, m in mesh2.manifolds.items()}
    st_shape = st_index = None
    if mesh2.structured_shape is not None:
        st_shape = tuple(mesh2.structured_shape) + (n_layers + 1,)
        si2 = np.asarray(mesh2.structured_index)
        st_index = np.concatenate(
            [
                np.concatenate(
                    [si2, np.full((n2, 1), l, si2.dtype)], axis=1
                )
                for l in range(n_layers + 1)
            ],
            axis=0,
        )
    pp = None
    if mesh2.periodic_pairs is not None:
        pp2 = np.asarray(mesh2.periodic_pairs)
        pp = np.concatenate(
            [pp2 + l * n2 for l in range(n_layers + 1)], axis=0
        )
    if bc_minus == Boundary.periodic and bc_plus == Boundary.periodic:
        # periodic extrusion (the reference's 3D airfoil,
        # geometry_airfoil.h:1385-1396): identify the top layer with the
        # bottom layer, [slave, master] like the face-driven pairs
        pp_z = np.stack(
            [np.arange(n2) + n_layers * n2, np.arange(n2)], axis=1
        )
        pp = pp_z if pp is None else np.concatenate([pp, pp_z], axis=0)
    return Mesh(
        dim=3, vertices=verts, cells=cells,
        boundary_faces=bfaces, boundary_ids=ids,
        face_manifold_ids=fm, manifolds=manifolds,
        periodic_pairs=pp,
        structured_shape=st_shape, structured_index=st_index,
        extrusion_base=mesh2, extrusion_layers=n_layers,
        extrusion_periodic_z=(
            bc_minus == Boundary.periodic and bc_plus == Boundary.periodic
        ),
    )


def cylinder_ogrid(
    length: float = 4.0,
    height: float = 2.0,
    object_position: float = 0.6,
    object_diameter: float = 0.5,
    refinement: int = 0,
    n_theta: int = 16,
    n_radial: int = 4,
) -> Mesh:
    """Channel-with-cylinder as ONE logically-structured O-grid.

    Same domain and boundary conditions as the reference's block
    construction (geometry_cylinder.h:146-213), but meshed as a single
    (theta, r) lattice: radial grid lines run from the cylinder surface
    straight to the channel perimeter (transfinite/ruled between the two
    closed boundary curves), with the four channel corners snapped onto
    grid lines so the domain is the exact rectangle.  theta is the
    periodic minor lattice axis, so the structured backend packs the mesh
    onto a canvas whose lane wrap IS the periodic identification
    (offline/structured.py) — the whole benchmark then runs the fused
    Pallas kernels instead of the gather-based ELL fallback.

    Radial spacing is graded per ray: geometric growth starting from the
    surface azimuthal spacing (near-isotropic cells at the cylinder,
    smoothly growing to the far field) — the standard structured-CFD
    O-grid layout.

    n_theta / n_radial are the cell counts at refinement 0; each
    refinement level doubles both.
    """
    r0 = object_diameter / 2.0
    cx, cy = object_position, height / 2.0
    nt = int(n_theta) * 2**refinement
    nr = int(n_radial) * 2**refinement

    # clockwise angles so the (theta, r) lattice is right-handed:
    jj = np.arange(nt)
    theta = -2.0 * np.pi * jj / nt
    dirs = np.stack([np.cos(theta), np.sin(theta)], axis=1)  # [nt, 2]

    # ray-cast to the channel perimeter:
    with np.errstate(divide="ignore"):
        tx = np.where(
            dirs[:, 0] > 0, (length - cx) / dirs[:, 0],
            np.where(dirs[:, 0] < 0, (0.0 - cx) / dirs[:, 0], np.inf),
        )
        ty = np.where(
            dirs[:, 1] > 0, (height - cy) / dirs[:, 1],
            np.where(dirs[:, 1] < 0, (0.0 - cy) / dirs[:, 1], np.inf),
        )
    rmax = np.minimum(tx, ty)
    outer = np.array([cx, cy])[None] + rmax[:, None] * dirs

    # snap the four corners onto the nearest ray so the outer boundary
    # polyline contains them exactly:
    corners = np.array(
        [[0.0, 0.0], [length, 0.0], [length, height], [0.0, height]]
    )
    for c in corners:
        phi = np.arctan2(c[1] - cy, c[0] - cx)
        j = int(np.round(-phi * nt / (2.0 * np.pi))) % nt
        outer[j] = c
    rmax = np.linalg.norm(outer - np.array([cx, cy])[None], axis=1)

    # per-ray geometric radial grading: first spacing = surface azimuthal
    # spacing, growth ratio solved so nr steps span the ray:
    dr0 = 2.0 * np.pi * r0 / nt
    L = rmax - r0
    q = np.full(nt, 1.0 + 1e-12)
    for _ in range(60):  # vectorized Newton on f(q) = dr0 (q^n - 1)/(q-1) - L
        qn = q**nr
        f = dr0 * (qn - 1.0) / (q - 1.0) - L
        df = dr0 * (nr * qn / q * (q - 1.0) - (qn - 1.0)) / (q - 1.0) ** 2
        q = np.clip(q - f / df, 0.2, 5.0)
    kk = np.arange(nr + 1)
    g = (q[:, None] ** kk[None] - 1.0) / (q[:, None] ** nr - 1.0)[..., :1]
    g = np.where(np.abs(q[:, None] - 1.0) < 1e-9, kk[None] / nr, g)  # [nt, nr+1]

    inner = np.array([cx, cy])[None] + r0 * dirs  # [nt, 2]
    # vertices: id = k * (nt + 1) + j, with the seam column j = nt
    # duplicating j = 0 bitwise (identified via periodic_pairs):
    pts = inner[:, None, :] + g[:, :, None] * (outer - inner)[:, None, :]
    pts = np.concatenate([pts, pts[:1]], axis=0)  # [nt+1, nr+1, 2]
    verts = np.transpose(pts, (1, 0, 2)).reshape(-1, 2)

    j_c, k_c = np.meshgrid(np.arange(nt), np.arange(nr), indexing="ij")
    j_c, k_c = j_c.ravel(), k_c.ravel()
    v00 = k_c * (nt + 1) + j_c
    cells = np.stack(
        [v00, v00 + 1, v00 + (nt + 1), v00 + (nt + 1) + 1], axis=1
    )
    p = verts[cells]
    det = (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1]) - (
        p[:, 1, 1] - p[:, 0, 1]
    ) * (p[:, 2, 0] - p[:, 0, 0])
    assert (det > 0).all(), "O-grid produced inverted cells"

    # boundary faces: inner ring (slip, circle manifold) + outer ring by
    # channel side:
    jf = np.arange(nt)
    inner_faces = np.stack([jf, (jf + 1)], axis=1)  # k = 0 row
    outer_faces = inner_faces + nr * (nt + 1)
    bfaces = np.concatenate([inner_faces, outer_faces], axis=0)
    centers = verts[bfaces].mean(axis=1)
    ids = np.full(len(bfaces), Boundary.slip, dtype=np.int32)
    tol = 1e-9 * max(length, height)
    is_outer = np.arange(len(bfaces)) >= nt
    ids[is_outer & (np.abs(centers[:, 0] - 0.0) < tol)] = Boundary.dirichlet
    ids[is_outer & (np.abs(centers[:, 0] - length) < tol)] = Boundary.do_nothing
    fm = np.zeros(len(bfaces), dtype=np.int32)
    fm[~is_outer] = 1

    # lattice structure + periodic seam:
    j_l, k_l = np.meshgrid(np.arange(nt + 1), np.arange(nr + 1), indexing="ij")
    st_index = np.stack([j_l.T.ravel(), k_l.T.ravel()], axis=1)
    seam = np.arange(nr + 1) * (nt + 1) + nt
    master = np.arange(nr + 1) * (nt + 1)
    pairs = np.stack([seam, master], axis=1)

    mesh = Mesh(
        dim=2, vertices=verts, cells=cells,
        boundary_faces=bfaces, boundary_ids=ids,
        structured_shape=(nt + 1, nr + 1),
        structured_index=st_index,
        periodic_pairs=pairs,
    )
    mesh.manifolds = {1: spherical_manifold([cx, cy])}
    mesh.face_manifold_ids = fm
    return mesh


def cylinder(
    length: float = 4.0,
    height: float = 2.0,
    object_position: float = 0.6,
    object_diameter: float = 0.5,
    refinement: int = 0,
    dim: int = 2,
    variant: str = "ogrid",
) -> Mesh:
    """2D channel with a cylindrical obstacle (geometry_cylinder.h).

    dim == 3 extrudes the 2D mesh over [-height/2, height/2] with slip
    conditions on the z faces, matching the reference's
    GridGenerator::extrude_triangulation construction
    (geometry_cylinder.h:146-213); the layer count matches the in-plane
    spacing so cells stay near-cubic.

    variant "ogrid" (default): single logically-structured O-grid
    (cylinder_ogrid) — canvas-packable, runs the fused Pallas fast path.
    variant "blocks": the reference-style block construction — a square
    ring graded onto the circle embedded in a rectangular channel lattice
    (unstructured; ELL fallback).
    """
    if variant == "ogrid":
        mesh = cylinder_ogrid(
            length=length, height=height,
            object_position=object_position,
            object_diameter=object_diameter,
            refinement=refinement,
        )
        if dim == 3:
            # dz ~ the median radial spacing of the 2D O-grid:
            n_layers = max(1, int(round(height * 4 * 2**refinement)))
            return extrude(
                mesh, -height / 2.0, height / 2.0, n_layers,
                bc_minus=Boundary.slip, bc_plus=Boundary.slip,
            )
        return mesh
    if variant != "blocks":
        raise ValueError(f"unknown cylinder variant '{variant}'")
    r = object_diameter / 2.0
    cx, cy = object_position, height / 2.0

    # Build square [cx-2r, cx+2r]^2 with square hole [cx-r,cx+r]^2, then
    # project the inner ring onto the circle; embed in the channel lattice.
    # Simpler robust approach: polar O-grid ring + outer lattice blocks.
    n_theta = 8 * 2**refinement  # cells around (per quadrant: n_theta/4)
    n_rad = 2 * 2**refinement
    box = 2.0 * r

    thetas = np.linspace(0, 2 * np.pi, n_theta + 1)[:-1]
    # outer square ring param: map theta to square of half-width `box`
    ring_layers = []
    for k in range(n_rad + 1):
        t = k / n_rad
        pts = []
        for th in thetas:
            cdir = np.array([np.cos(th), np.sin(th)])
            # point on circle:
            pc = np.array([cx, cy]) + r * cdir
            # point on square:
            m = max(abs(cdir[0]), abs(cdir[1]))
            ps = np.array([cx, cy]) + box * cdir / m
            pts.append((1 - t) * pc + t * ps)
        ring_layers.append(np.array(pts))
    ring_pts = np.concatenate(ring_layers, axis=0)
    ring_cells = []
    for k in range(n_rad):
        for j in range(n_theta):
            a = k * n_theta + j
            b = k * n_theta + (j + 1) % n_theta
            c = (k + 1) * n_theta + j
            d = (k + 1) * n_theta + (j + 1) % n_theta
            ring_cells.append([a, b, c, d])
    ring_cells = np.array(ring_cells)

    # outer lattice covering the channel minus the square hole:
    h = box / max(2, n_rad)  # roughly matching spacing
    nx = int(round(length / h))
    ny = int(round(height / h))
    x = np.linspace(0, length, nx + 1)
    y = np.linspace(0, height, ny + 1)
    # snap lattice lines to the box edges
    for val in (cx - box, cx + box):
        x[np.argmin(np.abs(x - val))] = val
    for val in (cy - box, cy + box):
        y[np.argmin(np.abs(y - val))] = val
    cmask = np.ones((ny, nx), dtype=bool)
    xc = 0.5 * (x[:-1] + x[1:])
    yc = 0.5 * (y[:-1] + y[1:])
    XC, YC = np.meshgrid(xc, yc, indexing="xy")
    cmask[(np.abs(XC - cx) < box - 1e-12) & (np.abs(YC - cy) < box - 1e-12)] = False
    outer = _lattice_mesh_2d(x, y, cmask)

    # merge meshes (dedupe coincident vertices on the square interface)
    all_verts = np.concatenate([outer.vertices, ring_pts], axis=0)
    all_cells = np.concatenate(
        [outer.cells, ring_cells + outer.n_vertices], axis=0
    )
    # deduplicate vertices
    scale = max(length, height)
    key = np.round(all_verts / (1e-9 * scale)).astype(np.int64)
    _, uniq_idx, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)
    new_verts = all_verts[uniq_idx]
    new_cells = inv[all_cells]
    # fix orientation: ensure positive jacobian (det of bilinear map at center)
    p = new_verts[new_cells]
    det = (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1]) - (
        p[:, 1, 1] - p[:, 0, 1]
    ) * (p[:, 2, 0] - p[:, 0, 0])
    flip = det < 0
    new_cells[flip] = new_cells[flip][:, [1, 0, 3, 2]]

    # boundary faces
    face_local = [
        np.array([0, 2]), np.array([1, 3]), np.array([0, 1]), np.array([2, 3]),
    ]
    faces = np.concatenate([new_cells[:, fl] for fl in face_local], axis=0)
    fsrt = np.sort(faces, axis=1)
    fkey = fsrt[:, 0] * (len(new_verts) + 1) + fsrt[:, 1]
    _, first, counts = np.unique(fkey, return_index=True, return_counts=True)
    bfaces = faces[first[counts == 1]]
    centers = new_verts[bfaces].mean(axis=1)
    ids = np.full(len(bfaces), Boundary.slip, dtype=np.int32)
    ids[centers[:, 0] < 1e-6] = Boundary.dirichlet
    ids[centers[:, 0] > length - 1e-6] = Boundary.do_nothing
    on_circle = (
        np.abs(np.linalg.norm(centers - np.array([cx, cy]), axis=1) - r) < 0.3 * r
    )
    ids[on_circle] = Boundary.slip

    mesh = Mesh(
        dim=2, vertices=new_verts, cells=new_cells,
        boundary_faces=bfaces, boundary_ids=ids,
    )

    mesh.manifolds = {1: spherical_manifold([cx, cy])}
    fm = np.zeros(len(bfaces), dtype=np.int32)
    fm[on_circle] = 1
    mesh.face_manifold_ids = fm
    if dim == 3:
        # near-cubic layers: in-plane spacing is ~r/2**refinement
        n_layers = max(1, int(round(height / (r / 2**refinement))))
        return extrude(
            mesh, -height / 2.0, height / 2.0, n_layers,
            bc_minus=Boundary.slip, bc_plus=Boundary.slip,
        )
    return mesh


# ---------------------------------------------------------------------------
# Unstructured construction helpers
# ---------------------------------------------------------------------------


def _finalize_quads(
    verts: np.ndarray, cells: np.ndarray, scale: float = 1.0
) -> Mesh:
    """Dedupe coincident vertices, fix cell orientation, extract boundary.

    The analog of dealii::GridGenerator::merge_triangulations +
    flatten_triangulation for a quad soup in [v0 v1; v2 v3] (deal.II)
    vertex ordering.
    """
    key = np.round(verts / (1e-9 * max(scale, 1e-30))).astype(np.int64)
    _, uniq_idx, inv = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    new_verts = verts[uniq_idx]
    new_cells = inv[cells]

    # drop vertices not referenced by any cell (cell-removal generators like
    # the annulus sector cut leave orphans; an orphan node would get zero
    # lumped mass and poison 1/m_i):
    used = np.unique(new_cells)
    if len(used) < len(new_verts):
        remap = np.full(len(new_verts), -1, np.int64)
        remap[used] = np.arange(len(used))
        new_verts = new_verts[used]
        new_cells = remap[new_cells]

    p = new_verts[new_cells]
    det = (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1]) - (
        p[:, 1, 1] - p[:, 0, 1]
    ) * (p[:, 2, 0] - p[:, 0, 0])
    flip = det < 0
    new_cells[flip] = new_cells[flip][:, [1, 0, 3, 2]]

    face_local = [
        np.array([0, 2]), np.array([1, 3]), np.array([0, 1]), np.array([2, 3]),
    ]
    faces = np.concatenate([new_cells[:, fl] for fl in face_local], axis=0)
    fsrt = np.sort(faces, axis=1)
    fkey = fsrt[:, 0].astype(np.int64) * (len(new_verts) + 1) + fsrt[:, 1]
    _, first, counts = np.unique(fkey, return_index=True, return_counts=True)
    bfaces = faces[first[counts == 1]]

    return Mesh(
        dim=2, vertices=new_verts, cells=new_cells,
        boundary_faces=bfaces,
        boundary_ids=np.zeros(len(bfaces), dtype=np.int32),
    )


def _ball_coarse(radius: float) -> Tuple[np.ndarray, np.ndarray]:
    """O-grid disk coarse mesh: 2x2 core square + 8 ring cells.

    Same topology as dealii::GridGenerator::hyper_ball_balanced (the
    generator used by geometry_disk.h:49).  Returns (verts, cells).
    """
    s = 0.5 * radius
    xs = np.array([-s, 0.0, s])
    core = np.array([[x, y] for y in xs for x in xs])  # 9 pts, idx ix+3*iy
    cells = [[0, 1, 3, 4], [1, 2, 4, 5], [3, 4, 6, 7], [4, 5, 7, 8]]
    # core-square boundary vertices in angular order starting at angle 0:
    sq = [5, 8, 7, 6, 3, 0, 1, 2]
    ang = np.arange(8) * (np.pi / 4)
    circ = radius * np.stack([np.cos(ang), np.sin(ang)], axis=1)
    verts = np.concatenate([core, circ], axis=0)
    for k in range(8):
        cells.append([sq[k], sq[(k + 1) % 8], 9 + k, 9 + (k + 1) % 8])
    return verts, np.array(cells, dtype=np.int64)


def disk(
    radius: float = 1.2,
    boundary: int = Boundary.dirichlet,
    refinement: int = 0,
) -> Mesh:
    """2D disk (geometry_disk.h:22-75, hyper_ball_balanced construction).

    All boundary faces carry the `boundary` id (default dirichlet,
    geometry_disk.h:38) and a spherical manifold so refinement converges to
    the circle.
    """
    verts, cells = _ball_coarse(radius)
    mesh = _finalize_quads(verts, cells, radius)
    mesh.boundary_ids[:] = boundary
    mesh.manifolds = {1: spherical_manifold([0.0, 0.0])}
    mesh.face_manifold_ids = np.ones(len(mesh.boundary_faces), np.int32)
    return mesh.refine_global(refinement)


def wall(
    length: float = 3.2,
    height: float = 1.0,
    wall_position: float = 1.0 / 6.0,
    refinement: int = 0,
) -> Mesh:
    """Double Mach reflection wall domain (geometry_wall.h:39-92).

    An 18x6 lattice on [wall_position, length] x [0, height] merged with a
    1x6 column on [0, wall_position]: slip on the bottom right of the wall
    position, do_nothing outflow on the right, dirichlet elsewhere.
    """
    x = np.concatenate([[0.0], np.linspace(wall_position, length, 19)])
    y = np.linspace(0.0, height, 7)
    mesh = _lattice_mesh_2d(x, y)
    centers = mesh.vertices[mesh.boundary_faces].mean(axis=1)
    ids = mesh.boundary_ids
    ids[:] = Boundary.dirichlet
    ids[(centers[:, 0] > wall_position) & (centers[:, 1] < 1e-6)] = (
        Boundary.slip
    )
    ids[centers[:, 0] > length - 1e-6] = Boundary.do_nothing
    return mesh.refine_global(refinement)


def wave_tank(
    reservoir_length: float = 1.57,
    reservoir_width: float = 0.81,
    flume_length: float = 6.0078,
    flume_width: float = 0.24,
    refinement: int = 0,
) -> Mesh:
    """Wave flume with a wider reservoir (geometry_tank.h:40-119).

    Union of a reservoir [-Lr, 0] x [-Wr/2, Wr/2] and a flume
    [0, Lf] x [-Wf/2, Wf/2], built as a masked lattice with ~1 cm cells
    (the reference subdivides by round(length*100)).  Slip everywhere except
    dynamic outflow at the end of the flume.
    """
    half_f = flume_width / 2.0
    y_bands = [np.linspace(-half_f, half_f,
                           max(1, round(flume_width * 100.0)) + 1)]
    if reservoir_width > flume_width + 1e-8:
        diff = (reservoir_width - flume_width) / 2.0
        n = max(1, round(diff * 100.0))
        y_bands.insert(0, np.linspace(-reservoir_width / 2.0, -half_f, n + 1))
        y_bands.append(np.linspace(half_f, reservoir_width / 2.0, n + 1))
    y = np.unique(np.concatenate(y_bands))
    x = np.unique(np.concatenate([
        np.linspace(-reservoir_length, 0.0,
                    max(1, round(reservoir_length * 100.0)) + 1),
        np.linspace(0.0, flume_length,
                    max(1, round(flume_length * 100.0)) + 1),
    ]))
    xc = 0.5 * (x[:-1] + x[1:])
    yc = 0.5 * (y[:-1] + y[1:])
    XC, YC = np.meshgrid(xc, yc, indexing="xy")
    cmask = ~((XC > 0.0) & (np.abs(YC) > half_f + 1e-12))
    mesh = _lattice_mesh_2d(x, y, cmask)
    centers = mesh.vertices[mesh.boundary_faces].mean(axis=1)
    mesh.boundary_ids[:] = Boundary.slip
    mesh.boundary_ids[centers[:, 0] > flume_length - 1e-8] = Boundary.dynamic
    return mesh.refine_global(refinement)


def annulus(
    length: float = 2.0,
    inner_radius: float = 0.6,
    outer_radius: float = 0.7,
    angle: float = 45.0,
    refinement: int = 0,
) -> Mesh:
    """Partial annulus obstacle in a square box (geometry_annulus.h:36-214).

    Construction mirrors the reference: an inner ball (radius r_i), a thin
    32-cell shell [r_i, r_o], and an 8-cell outer shell whose outermost
    vertices are snapped onto the square [-L/2, L/2]^2; everything is merged,
    refined twice with a spherical manifold active on the [r_i, r_o] band,
    and then the shell cells with |y| < |x| tan(angle) are removed
    (geometry_annulus.h:154-183).  Slip boundary conditions everywhere.
    """
    eps = 1e-10
    r_i, r_o = inner_radius, outer_radius

    # inner ball, refined twice so the r_i circle has 32 segments:
    bverts, bcells = _ball_coarse(r_i)
    ball = _finalize_quads(bverts, bcells, r_i)
    ball.manifolds = {1: spherical_manifold([0.0, 0.0])}
    ball.face_manifold_ids = np.ones(len(ball.boundary_faces), np.int32)
    ball = ball.refine_global(2)

    # 32-cell shell [r_i, r_o]:
    th = np.arange(32) * (2 * np.pi / 32)
    ring_pts = np.concatenate([
        r_i * np.stack([np.cos(th), np.sin(th)], axis=1),
        r_o * np.stack([np.cos(th), np.sin(th)], axis=1),
    ])
    ring_cells = np.array(
        [[k, (k + 1) % 32, 32 + k, 32 + (k + 1) % 32] for k in range(32)]
    )

    # 8-cell outer shell r_o -> square boundary, pre-refined twice:
    ang8 = np.arange(8) * (np.pi / 4)
    inner8 = r_o * np.stack([np.cos(ang8), np.sin(ang8)], axis=1)
    outer8 = (length / 2.0 * np.sqrt(2.0)) * np.stack(
        [np.cos(ang8), np.sin(ang8)], axis=1
    )
    # snap onto the square (geometry_annulus.h:122-131):
    for v in outer8:
        if abs(v[0]) < eps and abs(v[1]) > length / 2.0:
            v[1] = np.copysign(length / 2.0, v[1])
        if abs(v[1]) < eps and abs(v[0]) > length / 2.0:
            v[0] = np.copysign(length / 2.0, v[0])
    out_pts = np.concatenate([inner8, outer8])
    out_cells = np.array(
        [[k, (k + 1) % 8, 8 + k, 8 + (k + 1) % 8] for k in range(8)]
    )
    outer = _finalize_quads(out_pts, out_cells, length)
    outer.manifolds = {1: spherical_manifold([0.0, 0.0])}
    fc = outer.vertices[outer.boundary_faces].mean(axis=1)
    outer.face_manifold_ids = (
        np.linalg.norm(fc, axis=1) < r_o + 0.1 * (length - r_o)
    ).astype(np.int32)
    outer = outer.refine_global(2)

    # merge all three:
    verts = np.concatenate(
        [ball.vertices, ring_pts, outer.vertices], axis=0
    )
    cells = np.concatenate([
        ball.cells,
        ring_cells + ball.n_vertices,
        outer.cells + ball.n_vertices + len(ring_pts),
    ])
    mesh = _finalize_quads(verts, cells, length)

    def in_band(edge_pts: np.ndarray) -> np.ndarray:
        r = np.linalg.norm(edge_pts, axis=2)
        return np.all((r >= r_i - 1e-8) & (r <= r_o + 1e-8), axis=1)

    def attach(m: Mesh) -> None:
        m.manifolds = {1: spherical_manifold([0.0, 0.0])}
        m.edge_manifold_selectors = {1: in_band}
        fpts = m.vertices[m.boundary_faces]
        m.face_manifold_ids = in_band(fpts).astype(np.int32)

    attach(mesh)
    mesh = mesh.refine_global(2)

    # remove shell cells within the coverage angle of the x-axis
    # (geometry_annulus.h:159-180: a cell goes if any face center is inside
    # the annulus band and below the sector line):
    tan_a = np.tan(np.pi / 180.0 * angle)
    edge_local = np.array([[0, 1], [2, 3], [0, 2], [1, 3]])
    fctr = mesh.vertices[mesh.cells[:, edge_local]].mean(axis=2)  # [nc,4,2]
    rad = np.linalg.norm(fctr, axis=2)
    in_annulus = (rad - r_i > 1e-8) & (r_o - rad > 1e-3)
    partial = (
        np.abs(fctr[:, :, 1]) - np.abs(fctr[:, :, 0]) * tan_a < 1e-8
    )
    remove = np.any(in_annulus & partial, axis=1)

    mesh = _finalize_quads(mesh.vertices, mesh.cells[~remove], length)
    mesh.boundary_ids[:] = Boundary.slip
    attach(mesh)
    return mesh.refine_global(refinement)
