"""The sharded train, prefill and decode steps of recurrentgemma-2b and
qwen3-8b (smoke configs) on four gloo ranks, held against the reference's
``jax.jit(step, in_shardings, out_shardings)`` under ``sharding_ctx`` on
four forced host devices (``tests/test_torch_lm_mesh_specs.py`` has the
cases, the harness and the tolerances): mesh 2 x 2, and qwen3-8b with the
decode caches' positions split over ``model`` (``kv_seq_shard``) and with
the sequence split over ``model`` (``seq_axis``).  Every rank's gathered
outputs are checked."""
import sys

import pytest

from test_torch_lm_mesh_specs import assert_case, rank_main, run_cases

NAMES = ("recurrentgemma 2x2", "qwen3 2x2", "qwen3 2x2 kv_seq_shard",
         "qwen3 2x2 seq_axis")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("lm_dense"), __file__, NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_steps_match_the_reference(results, name):
    ranks, ref = results
    for got in ranks:
        assert_case(got[name], ref[name])


if __name__ == "__main__":
    rank_main(sys.argv[1:], NAMES)
