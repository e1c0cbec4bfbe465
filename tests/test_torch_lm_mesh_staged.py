"""The host-staged backend (``repro_torch.distributed.staged``), which
carries the collectives of several ranks that share one card, on four CPU
ranks: the backend registered for the CPU stages host tensors to the host
(a copy), so every collective of DTensor's and of ``exchange`` runs
through it.  mamba2-130m's smoke steps on mesh 2 x 2 over it must match
the reference's jitted steps on four forced host devices
(``tests/test_torch_lm_mesh_specs.py``), the int8 ring of the
compressed step must shift every rank's payload to the next, and
DTensor's all-to-all op (which a CUDA mesh runs through the backend's
override) must move a row split to a column split."""
import datetime
import pickle
import sys

import numpy as np
import pytest
import torch

from test_torch_lm_mesh_specs import assert_case, port_case, run_cases

NAMES = ("mamba2 2x2",)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("lm_staged"), __file__, NAMES)


def test_sharded_steps_over_the_staged_backend_match_the_reference(results):
    ranks, ref = results
    for got in ranks:
        assert got["backend"] == "cpu:staged"
        assert_case(got[NAMES[0]], ref[NAMES[0]])
        # DTensor's collectives went through the backend
        assert got["calls"].get("allgather", [0])[0] > 0
        assert got["calls"].get("allreduce", [0])[0] > 0
        assert got["ring"] and got["alltoall"]


if __name__ == "__main__":
    import argparse
    from pathlib import Path

    import torch.distributed as dist

    from repro_torch.distributed import exchange, staged

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
    torch.set_num_threads(1)
    staged.register(devices=("cpu",))
    dist.init_process_group("cpu:staged", store=dist.FileStore(str(a.out / "store"), a.world),
                            rank=a.rank, world_size=a.world,
                            timeout=datetime.timedelta(seconds=120))
    res = {n: port_case(n) for n in NAMES}
    res["calls"] = dict(staged.CALLS)
    res["backend"] = dist.get_backend()
    got = exchange.ring_shift(torch.full((3,), float(a.rank)), None)
    res["ring"] = bool((got == (a.rank - 1) % a.world).all())
    # DTensor's all-to-all op over the Python group: rank r's (4, 8) block
    # of a (16, 8) tensor split on rows becomes its (16, 2) column block
    full = torch.arange(128.).reshape(16, 8)
    block = full[4 * a.rank:4 * a.rank + 4]
    moved = torch.ops._dtensor.shard_dim_alltoall(block, 0, 1, dist.group.WORLD.group_name)
    res["alltoall"] = bool(torch.equal(moved, torch.chunk(full, a.world, dim=1)[a.rank]))
    with open(a.out / f"rank{a.rank}.pkl", "wb") as fh:
        pickle.dump(res, fh)
    dist.barrier()
    dist.destroy_process_group()
