"""olmoe-1b-7b (smoke config, capacity 8: nothing dropped) over four gloo
ranks, the global sort's dispatch on mesh 2 x 2, with and without the
expert pins of ``moe_shard_constraints``, held against the reference's
jitted steps on four forced host devices
(``tests/test_torch_lm_mesh_specs.py``).  The local dispatch is in
``tests/test_torch_lm_mesh_moe_local.py``."""
import sys

import pytest

from test_torch_lm_mesh_specs import assert_case, rank_main, run_cases

NAMES = ("olmoe sort 2x2", "olmoe sort 2x2 constraints")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("lm_moe"), __file__, NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_steps_match_the_reference(results, name):
    ranks, ref = results
    for got in ranks:
        assert_case(got[name], ref[name])


if __name__ == "__main__":
    rank_main(sys.argv[1:], NAMES)
