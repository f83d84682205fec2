"""The port's own offline layer (ryujin_tpu_torch/offline, native) against
the JAX package's (ryujin_tpu/offline): the Mach-3 step at refinement 0
assembled with cG Q1 and cG Q2 and packed onto the canvas gives the same
StructuredData, array for array and exactly."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ryujin_tpu.offline import geometry, structured  # noqa: E402
from ryujin_tpu.offline.mesh import Boundary  # noqa: E402

from ryujin_tpu_torch.offline import (  # noqa: E402
    geometry as t_geometry,
    mesh as t_mesh,
    structured as t_structured,
)

from test_torch_fixture import port_sd, step_case  # noqa: E402


def assert_same(a, b, path):
    """a and b hold the same data: dataclasses field by field, containers
    item by item, arrays exactly."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        names = [f.name for f in dataclasses.fields(a)]
        assert names == [f.name for f in dataclasses.fields(b)], path
        for name in names:
            assert_same(getattr(a, name), getattr(b, name), f"{path}.{name}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for key in a:
            assert_same(a[key], b[key], f"{path}[{key!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("ansatz,K,reach", [("cG Q1", 8, 1), ("cG Q2", 24, 2)])
def test_structured_data_equal(ansatz, K, reach):
    ref = step_case(ansatz)[0]
    got = port_sd(ansatz)
    assert isinstance(got, t_structured.StructuredData)
    assert not isinstance(got, structured.StructuredData)
    assert got.max_degree == K and got.reach == reach
    assert got.incidence is None and got.n_nodes > 16000
    assert_same(got, ref, "sd")


def test_boundary_ids_and_lattice_offsets_equal():
    assert [(b.name, int(b)) for b in t_mesh.Boundary] == [
        (b.name, int(b)) for b in Boundary
    ]
    for dim, reach in ((2, 1), (2, 2), (2, 3), (3, 1)):
        assert t_structured.lattice_offsets(dim, reach) == (
            structured.lattice_offsets(dim, reach)
        )


def test_rectangular_domain_equal():
    kw = dict(boundary_conditions=[Boundary.dirichlet] * 4)
    ref = geometry.rectangular_domain([0, 0], [2, 1], [2, 1], 2, **kw)
    got = t_geometry.rectangular_domain(
        [0, 0], [2, 1], [2, 1], 2,
        boundary_conditions=[t_mesh.Boundary.dirichlet] * 4,
    )
    np.testing.assert_array_equal(got.vertices, ref.vertices)
    np.testing.assert_array_equal(got.cells, ref.cells)
    np.testing.assert_array_equal(got.boundary_ids, ref.boundary_ids)
    # the airfoil is ported since the ELL slice (its mesh is held against
    # the JAX package's in tests/test_torch_ell_offline.py)
    assert hasattr(t_geometry, "airfoil")
