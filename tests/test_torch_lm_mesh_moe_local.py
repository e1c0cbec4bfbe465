"""olmoe-1b-7b (smoke config, capacity 8: nothing dropped) over four gloo
ranks with the local dispatch (``moe_forward_local``: each batch shard
routes its own tokens, each ``model`` shard runs its own experts, the
outputs summed over ``model``) on meshes 2 x 2, 4 x 1 and 1 x 4, held
against the reference's ``shard_map`` dispatch in its jitted steps on four
forced host devices (``tests/test_torch_lm_mesh_specs.py``)."""
import sys

import pytest

from test_torch_lm_mesh_specs import assert_case, rank_main, run_cases

NAMES = ("olmoe local 2x2", "olmoe local 4x1", "olmoe local 1x4")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("lm_moe_local"), __file__, NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_steps_match_the_reference(results, name):
    ranks, ref = results
    for got in ranks:
        assert_case(got[name], ref[name])


if __name__ == "__main__":
    rank_main(sys.argv[1:], NAMES)
