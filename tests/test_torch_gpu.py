"""The CUDA kernels against their plain-torch references on the card.

Marked `gpu`: each test skips without a CUDA device (decided inside the
test, never at import).  On the card, where jax is not installed (so
tests/conftest.py is skipped):

    python -m pytest --noconftest tests/test_torch_gpu.py -q -m gpu

builds the kernels (nvcc, sm_90a) and holds three ERK33 steps through
them at refinement 0 in float64 against the plain path on the CPU, for
both slices: step2d (cG Q1, K = 8: pk1, pk2, pk3, pk_up) and q2step2d
(cG Q2, K = 24: pk1_stream, pk2_stream, pk3_stream, pk_up; bang-bang).
"""

import pytest

torch = pytest.importorskip("torch")


def _three_steps_card_vs_cpu(build_case, fns, per_step):
    """Three ERK33 steps from a bumped inflow state: the kernels on the
    card against the plain path on the CPU, with the launch counts."""
    _, sd, _, ti_g, _ = build_case(0, torch.float64, "cuda")
    _, _, _, ti_c, U0 = build_case(0, torch.float64, "cpu")
    pos = torch.as_tensor(sd.positions.T)
    bump = 1.0 + 0.25 * torch.exp(
        -8.0 * torch.sum((pos - torch.tensor([[1.0], [0.5]],
                                             dtype=torch.float64)) ** 2, 0)
    )
    U0 = U0.clone()
    U0[0] *= bump
    U0[3] *= bump
    counts = [f.launches for f in fns]
    out_g = ti_g.advance(U0.cuda(), 0.0, 3)
    torch.cuda.synchronize()
    out_c = ti_c.advance(U0, 0.0, 3)
    new = [f.launches for f in fns]
    assert int(out_g[4]) == int(out_c[4]) == 0
    assert [b - a for a, b in zip(counts, new)] == [3 * n for n in per_step]
    real = torch.as_tensor(sd.node_mask > 0)
    torch.testing.assert_close(out_g[0].cpu()[:, real], out_c[0][:, real],
                               rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(out_g[3].cpu(), out_c[3], rtol=1e-10, atol=0)


@pytest.mark.gpu
def test_kernels_on_card_match_plain_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ryujin_tpu_torch.bench import build_step2d
    from ryujin_tpu_torch.kernels import pk1, pk2, pk3, pk_up

    _three_steps_card_vs_cpu(
        build_step2d, (pk1.pk1, pk2.pk2, pk3.pk3, pk_up.pk_up), [3, 3, 3, 6]
    )


@pytest.mark.gpu
def test_q2_stream_kernels_on_card_match_plain_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ryujin_tpu_torch.bench import build_q2step2d
    from ryujin_tpu_torch.kernels import (
        pk1_stream, pk2_stream, pk3_stream, pk_up,
    )

    _three_steps_card_vs_cpu(
        build_q2step2d,
        (pk1_stream.pk1_stream, pk2_stream.pk2_stream, pk3_stream.pk3_stream,
         pk_up.pk_up),
        [3, 3, 3, 6],
    )
