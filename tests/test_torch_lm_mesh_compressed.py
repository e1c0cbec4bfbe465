"""The compressed cross-pod train step and the dry run's fake world, on
four gloo ranks.

* ``make_train_step_compressed`` (mamba2-130m smoke config) over a
  ``(pod 2, data 1, model 2)`` mesh against the reference's on four forced
  host devices (a ``jax.sharding.Mesh`` with Auto axes, jitted with the
  reference dry run's shardings under ``make_rules(multi_pod=True)``).
  The loss within ``rtol 1e-5``.  Each gradient crosses pods as int8
  against the pods' shared scale, the largest of the two pods' ``amax /
  127`` (taken here from the reference's per-pod gradients): a gradient
  summed in another order may round to the neighbouring int8, so after
  one step every element of AdamW's ``m`` lies within ``(1 - b1)`` times
  one quantum of its leaf's scale of the reference's.
* A smoke train step of qwen3-8b traced on a fake 2 x 2 world on the meta
  device (``dryrun.count_cell``) issues the collectives (type, count and
  bytes) that the same step issues on the four real ranks, and counts the
  same local FLOPs and bytes.
"""
import pickle
import sys

import numpy as np
import pytest
import torch

from test_torch_lm_mesh_specs import case_inputs, case_config
from test_torch_mesh_rules import WORLD, finish, init_rank, start_ranks, start_reference

NAME = "mamba2 2x2"      # its config, weights and batch; the mesh is (2, 1, 2)
POD_MESH = (2, 1, 2)
FAKE_ARCH, FAKE_B, FAKE_S = "qwen3-8b", 4, 40


def reference_main(out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    import repro.distributed.sharding as RS
    from repro.configs import smoke_config as jax_smoke_config
    from repro.launch import steps as jax_steps
    from repro.models import model as JM
    from repro.optim import AdamWConfig, init_state
    from repro_torch.launch.steps import BATCH_AXES

    jcfg = case_config(NAME, jax_smoke_config)
    params, batch, _ = case_inputs(NAME)
    params = jax.tree.map(jnp.asarray, params)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    mesh = Mesh(np.array(jax.devices()).reshape(POD_MESH), ("pod", "data", "model"))
    rules = RS.make_rules(multi_pod=True)
    p_sh = jax_steps.param_shardings(jcfg, mesh, rules)
    o_sh = jax_steps.opt_shardings(jcfg, mesh, rules)
    b_sh = {k: NamedSharding(mesh, RS.spec_for_shape(BATCH_AXES[k], rules, v.shape, mesh))
            for k, v in batch.items()}
    step = jax.jit(jax_steps.make_train_step_compressed(jcfg, AdamWConfig(), mesh, 2),
                   in_shardings=(p_sh, o_sh, b_sh), out_shardings=(p_sh, o_sh, None))
    p2, o2, met = step(params, init_state(params), batch)
    half = batch["tokens"].shape[0] // 2
    pod_grads = [jax.grad(JM.train_loss)(params, jcfg, {"tokens": batch["tokens"][sl]})
                 for sl in (slice(0, half), slice(half, None))]
    scales = [max(max(float(jnp.abs(g).max()) for g in gs) / 127.0, 1e-12)
              for gs in zip(*(jax.tree.leaves(g) for g in pod_grads))]
    with open(f"{out}/ref.pkl", "wb") as fh:
        pickle.dump({"loss": float(met["loss"]),
                     "m": [np.asarray(x) for x in jax.tree.leaves(o2.m)],
                     "scales": scales}, fh)


def compressed(rank):
    import repro_torch.distributed.sharding as PS
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.tree import leaves, tree_map

    cfg = case_config(NAME, __import__("repro_torch.configs", fromlist=["x"]).smoke_config)
    mesh = make_mesh(POD_MESH, ("pod", "data", "model"))
    rules = PS.make_rules(multi_pod=True)
    params, batch, _ = case_inputs(NAME)
    params = tree_map(torch.from_numpy, params)
    b_sh = {k: PS.NamedSharding(mesh, PS.spec_for_shape(steps.BATCH_AXES[k], rules,
                                                        v.shape, mesh))
            for k, v in batch.items()}
    dp = PS.shard_tree(params, steps.param_shardings(cfg, mesh, rules))
    ds = PS.shard_tree(init_state(params), steps.opt_shardings(cfg, mesh, rules))
    db = PS.shard_tree({k: torch.from_numpy(v) for k, v in batch.items()}, b_sh)
    step = steps.make_train_step_compressed(cfg, AdamWConfig(), mesh, n_pods=2)
    p2, o2, met = step(dp, ds, db)
    return {"loss": float(met["loss"]),
            "m": [t.numpy() for t in leaves(PS.gather_tree(o2.m))]}


def fake_world_count(rank):
    """The qwen3-8b smoke train step's count on this real rank."""
    from test_torch_dryrun import on_cpu

    import repro_torch.distributed.sharding as PS
    from repro_torch.configs import smoke_config
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_host_mesh

    cfg = smoke_config(FAKE_ARCH)
    mesh, rules = make_host_mesh(2), PS.make_rules()
    step, args = dryrun.cell_step(cfg, "train", FAKE_B, FAKE_S)
    dargs = dryrun.shard_cell_args(cfg, "train", on_cpu(args), mesh, rules)
    with PS.sharding_ctx(mesh, rules):
        _, count = roofline.count_step(step, *dargs)
    return count_record(count)


def count_record(count):
    c = count.collectives
    return {"flops": dict(count.flops_by_dtype), "bytes": count.hbm_bytes,
            "coll_bytes": dict(c.bytes_by_type), "coll_counts": dict(c.count_by_type),
            "ring_time_s": c.ring_time_s}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_compressed")
    started = start_ranks(__file__, tmp)
    started.append(start_reference("test_torch_lm_mesh_compressed", "reference_main", tmp))
    finish(started)
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            ranks.append(pickle.load(fh))
    with open(tmp / "ref.pkl", "rb") as fh:
        return ranks, pickle.load(fh)


def test_compressed_step_matches_the_reference_within_a_quantum(results):
    from repro_torch.optim import AdamWConfig

    b1 = AdamWConfig().b1
    ranks, ref = results
    for got in ranks:
        got = got["compressed"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        assert len(got["m"]) == len(ref["m"]) == len(ref["scales"])
        for m, want, scale in zip(got["m"], ref["m"], ref["scales"]):
            assert np.abs(m - want).max() <= (1 - b1) * scale * (1 + 1e-5), \
                (np.abs(m - want).max(), scale)


def test_fake_world_counts_what_the_real_ranks_run(results):
    from repro_torch.configs import smoke_config
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_host_mesh

    cfg = smoke_config(FAKE_ARCH)
    with fake_world(4):
        count = dryrun.count_cell(cfg, "train", FAKE_B, FAKE_S, make_host_mesh(2),
                                  make_rules())
    fake = count_record(count)
    assert sum(fake["coll_counts"].values()) > 0 and fake["ring_time_s"] > 0
    for got in results[0]:
        assert got["fake"] == fake


if __name__ == "__main__":
    rank, _world, out = init_rank(sys.argv[1:])
    res = {"compressed": compressed(rank), "fake": fake_world_count(rank)}
    with open(out / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(res, fh)
