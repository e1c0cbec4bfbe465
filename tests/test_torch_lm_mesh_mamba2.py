"""mamba2-130m (smoke config) over four gloo ranks: the sharded train,
prefill and decode steps on meshes 2 x 2, 4 x 1 and 1 x 4, and with
``fsdp`` on 2 x 2, held against the reference's jitted steps on four
forced host devices (``tests/test_torch_lm_mesh_specs.py``); and K5's
``local_map`` (``models.blocks._ssd_chunk``) with its heads split over
``model``, forward and gradient, against the kernel's plain version on
the whole tensors."""
import sys

import numpy as np
import pytest
import torch

from test_torch_lm_mesh_specs import assert_case, rank_main, run_cases

NAMES = ("mamba2 2x2", "mamba2 4x1", "mamba2 1x4", "mamba2 2x2 fsdp")


def k5_heads_split(rank):
    """K5 through ``_ssd_chunk`` on (chunks over data, heads over model)
    DTensor blocks of a 2 x 2 mesh: outputs and the gradients of all four
    operands, gathered, beside the whole-tensor call's."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels.ssd_chunk import ssd_chunk
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.blocks import _ssd_chunk

    mesh = make_host_mesh(2)
    g = torch.Generator().manual_seed(7)
    x, b, c = (torch.randn(s, generator=g) for s in ((4, 8, 4, 4), (4, 8, 1, 6), (4, 8, 1, 6)))
    la = -torch.rand((4, 8, 4), generator=g)
    gy, gs = torch.randn((4, 8, 4, 4), generator=g), torch.randn((4, 4, 6, 4), generator=g)
    whole = [t.clone().requires_grad_() for t in (x, b, c, la)]
    y, st = ssd_chunk(*whole)
    torch.autograd.backward((y, st), (gy, gs))
    lay = {x: [Shard(0), Shard(2)], b: [Shard(0), Replicate()],
           c: [Shard(0), Replicate()], la: [Shard(0), Shard(2)]}
    dts = [DTensor.from_local(t, mesh, [Replicate(), Replicate()]).redistribute(mesh, lay[t])
           .detach().requires_grad_() for t in (x, b, c, la)]
    dy, dst = _ssd_chunk(*dts)
    assert dy.placements == (Shard(0), Shard(2)) and dst.placements == (Shard(0), Shard(1))
    rep = [Replicate(), Replicate()]
    torch.autograd.backward(
        (dy, dst), (DTensor.from_local(gy, mesh, rep).redistribute(mesh, dy.placements),
                    DTensor.from_local(gs, mesh, rep).redistribute(mesh, dst.placements)))
    got = [dy.full_tensor(), dst.full_tensor()] + [t.grad.full_tensor() for t in dts]
    want = [y, st] + [t.grad for t in whole]
    return {"k5": [(a.detach().numpy(), w.detach().numpy()) for a, w in zip(got, want)]}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("lm_mamba2"), __file__, NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_steps_match_the_reference(results, name):
    ranks, ref = results
    for got in ranks:
        assert_case(got[name], ref[name])


def test_k5_on_heads_split_over_model(results):
    """The blocks' outputs and the gradients (B's and C's summed over the
    ranks that split the heads) equal the whole call's on every rank."""
    for got in results[0]:
        for a, w in got["k5"]:
            np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-6)


if __name__ == "__main__":
    rank_main(sys.argv[1:], NAMES, k5_heads_split)
