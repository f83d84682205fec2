"""Mesh file import: Gmsh ``.msh`` (ASCII v2.2 and v4.1).

The analog of the reference's ``reader`` geometry
(geometry_reader.h:26-49), which delegates to
dealii::GridIn.  We parse the two common Gmsh ASCII formats directly:
quad (type 3) / hex (type 5) elements become cells; line (type 1) / quad
surface elements become boundary faces whose boundary id is taken from
the first (physical) tag — the same convention deal.II uses when
importing ``.msh`` files.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .mesh import Mesh

# gmsh node ordering -> deal.II lexicographic vertex ordering
_GMSH_TO_DEALII = {
    1: [0, 1],            # 2-node line
    3: [0, 1, 3, 2],      # 4-node quad
    5: [0, 1, 3, 2, 4, 5, 7, 6],  # 8-node hex
}


def _read_sections(path: str) -> Dict[str, List[str]]:
    sections: Dict[str, List[str]] = {}
    name = None
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line:
                continue
            if line.startswith("$End"):
                name = None
            elif line.startswith("$"):
                name = line[1:]
                sections[name] = []
            elif name is not None:
                sections[name].append(line)
    return sections


def _parse_nodes_v2(lines: List[str]) -> Dict[int, np.ndarray]:
    n = int(lines[0])
    nodes = {}
    for ln in lines[1 : 1 + n]:
        parts = ln.split()
        nodes[int(parts[0])] = np.array([float(v) for v in parts[1:4]])
    return nodes


def _parse_elements_v2(lines: List[str]):
    n = int(lines[0])
    elems = []
    for ln in lines[1 : 1 + n]:
        parts = [int(v) for v in ln.split()]
        etype, ntags = parts[1], parts[2]
        tags = parts[3 : 3 + ntags]
        conn = parts[3 + ntags :]
        elems.append((etype, tags[0] if tags else 0, conn))
    return elems


def _parse_nodes_v4(lines: List[str]) -> Dict[int, np.ndarray]:
    header = lines[0].split()
    n_blocks = int(header[0])
    nodes = {}
    i = 1
    for _ in range(n_blocks):
        _, _, _, num = (int(v) for v in lines[i].split())
        i += 1
        tags = [int(lines[i + k]) for k in range(num)]
        i += num
        for k in range(num):
            parts = lines[i + k].split()
            nodes[tags[k]] = np.array([float(v) for v in parts[:3]])
        i += num
    return nodes


def _parse_elements_v4(lines: List[str], physical_of_entity):
    header = lines[0].split()
    n_blocks = int(header[0])
    elems = []
    i = 1
    for _ in range(n_blocks):
        ent_dim, ent_tag, etype, num = (int(v) for v in lines[i].split())
        i += 1
        bid = physical_of_entity.get((ent_dim, ent_tag), ent_tag)
        for k in range(num):
            parts = [int(v) for v in lines[i + k].split()]
            elems.append((etype, bid, parts[1:]))
        i += num
    return elems


def _parse_entities_v4(lines: List[str]) -> Dict:
    """Map (dim, entityTag) -> first physical tag."""
    counts = [int(v) for v in lines[0].split()]  # points, curves, surfs, vols
    out = {}
    i = 1
    for dim, cnt in enumerate(counts):
        for _ in range(cnt):
            parts = lines[i].split()
            i += 1
            tag = int(parts[0])
            # points have 3 coords + numPhysical; higher dims 6 bounds:
            off = 4 if dim == 0 else 7
            n_phys = int(parts[off])
            if n_phys:
                out[(dim, tag)] = int(parts[off + 1])
    return out


def read_msh(path: str) -> Mesh:
    """Read a Gmsh ``.msh`` file into a :class:`Mesh`."""
    sec = _read_sections(path)
    if "MeshFormat" not in sec:
        raise ValueError(f"{path}: not a Gmsh .msh file")
    version = float(sec["MeshFormat"][0].split()[0])

    if version < 3.0:
        nodes = _parse_nodes_v2(sec["Nodes"])
        elems = _parse_elements_v2(sec["Elements"])
    else:
        phys = (
            _parse_entities_v4(sec["Entities"]) if "Entities" in sec else {}
        )
        nodes = _parse_nodes_v4(sec["Nodes"])
        elems = _parse_elements_v4(sec["Elements"], phys)

    cell_type = 5 if any(e[0] == 5 for e in elems) else 3
    face_type = 3 if cell_type == 5 else 1
    dim = 3 if cell_type == 5 else 2

    tag_list = sorted(nodes)
    remap = {t: i for i, t in enumerate(tag_list)}
    verts = np.array([nodes[t][:dim] for t in tag_list])

    cells, faces, ids = [], [], []
    for etype, bid, conn in elems:
        if etype == cell_type:
            cells.append([remap[c] for c in conn])
        elif etype == face_type:
            faces.append([remap[c] for c in conn])
            ids.append(bid)
    if not cells:
        raise ValueError(f"{path}: no volume elements found")

    cells = np.array(cells, np.int64)[:, _GMSH_TO_DEALII[cell_type]]
    perm = _GMSH_TO_DEALII[face_type]
    bfaces = (
        np.array(faces, np.int64)[:, perm]
        if faces
        else np.zeros((0, 2 ** (dim - 1)), np.int64)
    )

    if dim == 2:
        # fix orientation like the generators do:
        p = verts[cells]
        det = (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1]) - (
            p[:, 1, 1] - p[:, 0, 1]
        ) * (p[:, 2, 0] - p[:, 0, 0])
        flip = det < 0
        cells[flip] = cells[flip][:, [1, 0, 3, 2]]

    return Mesh(
        dim=dim,
        vertices=verts,
        cells=cells,
        boundary_faces=bfaces,
        boundary_ids=np.array(ids, np.int32),
    )
