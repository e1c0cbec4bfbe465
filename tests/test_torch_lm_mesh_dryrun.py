"""The dry run's mesh flags on smoke cells over small fake worlds: each of
``--mesh multi``, ``--seq-axis``, ``--fsdp 1``, ``--kv-seq-shard`` and
``--grad-compress`` reaches the reference's ``make_rules`` and the step,
and moves the cell's collectives against the same cell without it.  The
production meshes (256 and 512 ranks) are swapped for 2 x 2 and 2 x 2 x 2
and the shapes for small ones, so each trace takes seconds."""
import pytest

import repro.distributed.sharding as RS
from repro_torch.configs import smoke_config
from repro_torch.launch import dryrun

#: flag -> (the smoke cell it moves, the arch, the reference's rules with it)
MESH_FLAGS = {
    "--mesh multi": ("train_4k", "olmoe-1b-7b", dict(multi_pod=True)),
    "--seq-axis model": ("prefill_32k", "qwen3-8b", dict(seq_axis="model")),
    "--fsdp 1": ("train_4k", "qwen3-8b", dict(fsdp=True)),
    "--kv-seq-shard": ("decode_32k", "qwen3-8b", dict(kv_seq_shard=True)),
    "--grad-compress": ("train_4k", "mamba2-130m", dict(multi_pod=True)),
}
#: the smoke cells: small shapes on 2 x 2 and 2 x 2 x 2 fake worlds
SMOKE_SHAPES = {"train_4k": dict(seq_len=32, global_batch=8, kind="train"),
                "prefill_32k": dict(seq_len=32, global_batch=4, kind="prefill"),
                "decode_32k": dict(seq_len=32, global_batch=4, kind="decode")}
SMOKE_MESHES = {"single": ((2, 2), ("data", "model")),
                "multi": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.mark.parametrize("flag", MESH_FLAGS)
def test_mesh_flags_reach_the_rules_and_move_the_collectives(flag, monkeypatch, capsys):
    """Each flag of the reference's CLI on a smoke cell: the cell traces
    (``status == "ok"``) over a fake world of the mesh's size, the rules
    that reach the step are the reference's ``make_rules`` with the flag,
    and the collective term moves against the same cell without it
    (``--grad-compress`` against the multi mesh without it: the int8 ring
    across pods replaces the all-reduce over them)."""
    from repro_torch.launch import mesh as lmesh

    shape, arch, kw = MESH_FLAGS[flag]
    monkeypatch.setattr(dryrun, "get_config", smoke_config)
    monkeypatch.setattr(dryrun, "SHAPES", SMOKE_SHAPES)
    monkeypatch.setattr(dryrun, "MESHES", SMOKE_MESHES)
    monkeypatch.setattr(dryrun, "make_production_mesh", lambda multi_pod=False:
                        lmesh.make_mesh(*SMOKE_MESHES["multi" if multi_pod else "single"]))
    seen = []
    real = dryrun.count_cell

    def count(cfg, kind, b, seq, mesh, rules, grad_compress):
        seen.append((rules, grad_compress))
        return real(cfg, kind, b, seq, mesh, rules, grad_compress)

    monkeypatch.setattr(dryrun, "count_cell", count)
    argv = flag.split()
    base = ["--mesh", "multi"] if flag == "--grad-compress" else []
    recs = []
    for extra in (base, base + argv):
        rec = dryrun.run_cell(arch, shape, *(
            ["multi"] if "multi" in extra else ["single"]),
            seq_axis="model" if "--seq-axis" in extra else None,
            fsdp=True if "--fsdp" in extra else None,
            kv_seq_shard="--kv-seq-shard" in extra,
            grad_compress="--grad-compress" in extra, verbose=False)
        assert rec["status"] == "ok", rec.get("trace")
        recs.append(rec)
    assert recs[1]["chips"] == (8 if kw.get("multi_pod") else 4)
    rules, compress = seen[-1]
    assert rules == RS.make_rules(**kw) and compress == (flag == "--grad-compress")
    assert seen[0][0] != rules or flag == "--grad-compress"
    assert recs[1]["collective_bytes"] != recs[0]["collective_bytes"]
    if flag == "--grad-compress":
        assert recs[1]["collective_counts"]["collective-permute"] > 0
        assert recs[0]["collective_counts"]["collective-permute"] == 0
    dryrun.main(["--arch", arch, "--shape", shape, *base, *argv])
    assert "dry-run: 1 ok, 0 skipped, 0 errors" in capsys.readouterr().out
