"""Dry run: trace every (arch x shape) cell on the meta device (the port of
``repro.launch.dryrun``).

For each cell this script

1. builds the production mesh over a fake world in this process
   (:func:`.mesh.fake_world`: 16 x 16 = 256 ranks for ``--mesh single``,
   2 x 16 x 16 = 512 for ``--mesh multi``; the reference forces as many
   host devices),
2. builds the parameters, optimizer state, batch and caches as meta
   tensors (shapes and dtypes, no storage: zero allocation, no card) and
   gives rank 0 its DTensor blocks of them under the reference's sharding
   trees (``launch/steps.py``, ``make_rules(fsdp, multi_pod, seq_axis,
   kv_seq_shard)``),
3. runs the cell's step once on them (train, prefill or serve, inside
   ``sharding_ctx``; ``--grad-compress`` runs the compressed cross-pod
   train step) under the counters of :func:`.roofline.count_step`, which
   see rank 0's local ops and the collectives DTensor inserts,
4. records the step's argument, output and peak bytes a device (the
   fits-in-memory proof: peak <= 80 GB), its FLOPs and bytes a device and
   its collectives,
5. derives the three roofline terms (launch/roofline.py) at one H100's
   constants and its links', and appends the cell record to a JSON
   results file.

The records are predictions from a trace, not measurements.
:func:`count_cell` without a mesh is the one-card trace (``chips`` 1, no
collective), which ``chip_smoke.py`` holds against measured steps.  The
port's layer loop is Python, so the trace counts every layer: no depth
extrapolation is needed (``--no-extrapolate`` changes nothing).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh multi --out results.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback

from ..configs import ARCH_NAMES, get_config
from ..distributed.sharding import (
    NamedSharding, make_rules, shard_tree, sharding_ctx, spec_for_shape,
    tree_shardings,
)
from ..models import init as minit, model as M
from ..models.config import ModelConfig
from ..optim import AdamWConfig, init_state
from .hardware import H100
from .mesh import fake_world, make_production_mesh
from .roofline import CollectiveStats, RooflineTerms, analyze, count_step
from .shapes import SHAPES, shape_applicable, step_batch_specs, tokens_per_step
from . import steps as S


def cell_step(cfg: ModelConfig, kind: str, batch: int, seq: int):
    """(step, its arguments on the meta device) of one ``kind`` step of
    ``cfg`` over ``batch`` sequences of ``seq`` positions.  Decode is one
    new token against a ``seq``-long cache at position ``seq - 1``, a
    Python int (a tensor position would be read back to the host)."""
    params = minit.param_shapes(cfg)
    b_specs = step_batch_specs(cfg, kind, batch, seq)
    if kind == "train":
        return (S.make_train_step(cfg, AdamWConfig()),
                (params, init_state(params), b_specs))
    if kind == "prefill":
        return S.make_prefill_step(cfg, seq), (params, b_specs)
    caches = M.init_caches(cfg, batch, seq, device="meta")
    return (S.make_serve_step(cfg, seq),
            (params, caches, b_specs["tokens"], seq - 1))


def shard_cell_args(cfg: ModelConfig, kind: str, args, mesh, rules: dict):
    """This rank's DTensor blocks of :func:`cell_step`'s ``args`` (meta or
    real tensors) over ``mesh`` under ``rules``: the reference's
    ``jax.jit(step, in_shardings=...)`` arguments, one rank's share."""
    p_sh = S.param_shardings(cfg, mesh, rules)

    def batch(tree):
        return shard_tree(tree, {
            k: NamedSharding(mesh, spec_for_shape(S.BATCH_AXES[k], rules,
                                                  v.shape, mesh))
            for k, v in tree.items()})

    params = shard_tree(args[0], p_sh)
    if kind == "train":
        return (params, shard_tree(args[1], S.opt_shardings(cfg, mesh, rules)),
                batch(args[2]))
    if kind == "prefill":
        return params, batch(args[1])
    caches, tokens, pos = args[1:]
    c_sh = tree_shardings(S.cache_logical_specs(cfg), caches, mesh, rules)
    return (params, shard_tree(caches, c_sh), batch({"tokens": tokens})["tokens"],
            pos)


def mesh_cell_step(cfg: ModelConfig, kind: str, batch: int, seq: int, mesh,
                   rules: dict, grad_compress: bool = False):
    """(step, this rank's meta DTensor arguments) of :func:`cell_step` over
    ``mesh``; a compressed train step where ``grad_compress``; over a mesh
    with a ``pod`` axis, the steps over pods (``launch.steps``:
    ``make_train_step_pods``, ``on_pods``)."""
    step, args = cell_step(cfg, kind, batch, seq)
    pods = "pod" in mesh.mesh_dim_names
    if grad_compress and kind == "train":
        step = S.make_train_step_compressed(
            cfg, AdamWConfig(), mesh,
            n_pods=dict(zip(mesh.mesh_dim_names, mesh.shape)).get("pod", 1))
    elif pods and kind == "train":
        step = S.make_train_step_pods(cfg, AdamWConfig(), mesh, rules)
    elif pods:
        step = S.on_pods(step, mesh, rules)
    return step, shard_cell_args(cfg, kind, args, mesh, rules)


def count_cell(cfg: ModelConfig, kind: str, batch: int, seq: int, mesh=None,
               rules=None, grad_compress: bool = False):
    """Trace :func:`cell_step` on the meta device; returns its
    :class:`~.roofline.StepCount`, or raises if the trace touched any
    other device.  With a ``mesh`` (of a :func:`.mesh.fake_world`) the
    count is one rank's of the step over the mesh under ``rules``, inside
    ``sharding_ctx`` (the compressed step opens none, as the
    reference's)."""
    if mesh is None:
        step, args = cell_step(cfg, kind, batch, seq)
        ctx = contextlib.nullcontext()
    else:
        step, args = mesh_cell_step(cfg, kind, batch, seq, mesh, rules,
                                    grad_compress and kind == "train")
        # the steps over pods open their own context within a pod
        ctx = (contextlib.nullcontext()
               if grad_compress or "pod" in mesh.mesh_dim_names
               else sharding_ctx(mesh, rules))
    with ctx:
        _, count = count_step(step, *args)
    if count.devices != {"meta"}:
        raise RuntimeError(f"the trace touched {sorted(count.devices)}, not "
                           "only the meta device")
    return count


def extrapolated_terms(cfg: ModelConfig, kind: str, batch: int, seq: int,
                       chips: int = 1) -> RooflineTerms:
    """Affine-in-depth roofline terms (the reference's DESIGN.md §7).

    The reference fits cost(L) = a + b*L through 1- and 2-period unrolled
    programs because XLA counts a while-loop body once.  The port's trace
    counts every layer, so the records use the direct count.  At a depth
    of whole periods the fit gives the direct FLOPs, and the direct bytes
    of prefill and decode; a train step's bytes grow faster than the
    depth (each layer's gradient of its slice of the stacked parameters,
    ``select_backward``, writes a tensor of the whole stack), which the fit
    misses.
    """
    period = len(cfg.block_pattern)
    t1, t2 = [
        analyze(count_cell(dataclasses.replace(cfg, n_layers=k * period),
                           kind, batch, seq), chips=chips)
        for k in (1, 2)
    ]
    n_periods = cfg.n_layers / period

    def affine(v1, v2):
        b = v2 - v1
        a = v1 - b
        return a + b * n_periods

    coll = CollectiveStats(
        bytes_by_type={k: max(0, int(affine(t1.collectives.bytes_by_type[k],
                                            t2.collectives.bytes_by_type[k])))
                       for k in t1.collectives.bytes_by_type},
        count_by_type={k: max(0, int(affine(t1.collectives.count_by_type[k],
                                            t2.collectives.count_by_type[k])))
                       for k in t1.collectives.count_by_type},
        ring_time_s=max(0.0, affine(t1.collectives.ring_time_s,
                                    t2.collectives.ring_time_s)),
    )
    return RooflineTerms(
        flops=max(0.0, affine(t1.flops, t2.flops)),
        hbm_bytes=max(0.0, affine(t1.hbm_bytes, t2.hbm_bytes)),
        collectives=coll, chips=chips,
        flops_by_dtype={k: max(0.0, affine(t1.flops_by_dtype.get(k, 0.0),
                                           t2.flops_by_dtype.get(k, 0.0)))
                        for k in {**t1.flops_by_dtype, **t2.flops_by_dtype}},
    )


#: the reference's production meshes: (shape, axes) by --mesh
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def run_cell(arch: str, shape: str, mesh_kind: str = "single", *, seq_axis=None,
             dispatch=None, loss_chunk=None, opt=False, fsdp=None,
             kv_seq_shard=False, grad_compress=False, no_extrapolate=False,
             tag=None, verbose=True) -> dict:
    cfg = get_config(arch)
    if opt:
        # the beyond-paper optimized bundle (§Perf): chunked CE, bf16
        # attention traffic, EP-constrained MoE dispatch
        cfg = dataclasses.replace(
            cfg, loss_chunk=512, attn_f32=False, moe_shard_constraints=True,
            norm_f32=False, grad_bf16=True)
    if dispatch and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch)
        )
    if loss_chunk is not None:
        cfg = dataclasses.replace(cfg, loss_chunk=loss_chunk)
    if fsdp is not None:
        cfg = dataclasses.replace(cfg, fsdp=fsdp)
    info = SHAPES[shape]
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_kind,
        "kind": info["kind"],
        "variant": tag or ("opt" if (opt or kv_seq_shard or dispatch or
                                     fsdp is not None or loss_chunk)
                           else "baseline"),
    }
    skip = shape_applicable(cfg, shape)
    if skip:
        rec.update(status="skipped", reason=skip)
        return rec

    multi = mesh_kind == "multi"
    chips = math.prod(MESHES[mesh_kind][0])
    rules = make_rules(fsdp=cfg.fsdp, multi_pod=multi, seq_axis=seq_axis,
                       kv_seq_shard=kv_seq_shard)
    t0 = time.time()
    try:
        with fake_world(chips):
            mesh = make_production_mesh(multi_pod=multi)
            count = count_cell(cfg, info["kind"], info["global_batch"],
                               info["seq_len"], mesh, rules, grad_compress)
        t_trace = time.time() - t0
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        return rec

    # argument + output + temp = peak, as in XLA's memory_analysis()
    mem = {
        "argument_size_in_bytes": count.argument_bytes,
        "output_size_in_bytes": count.output_bytes,
        "temp_size_in_bytes": max(0, count.peak_bytes - count.argument_bytes
                                  - count.output_bytes),
        "peak_bytes": count.peak_bytes,
        "fits_one_card": count.peak_bytes <= H100.hbm_bytes,
    }
    terms = analyze(count, chips=chips)
    rec["terms_source"] = "counted_every_layer"
    rec["raw_scan_flops"] = terms.flops
    toks = tokens_per_step(cfg, shape)
    n_active = cfg.active_param_count()
    mf_mult = 6.0 if info["kind"] == "train" else 2.0
    model_flops = mf_mult * n_active * toks
    flops_ratio = (
        model_flops / chips / terms.flops if terms.flops else 0.0
    )
    rec.update(
        status="ok",
        chips=chips,
        compile_s=round(t_trace, 1),
        memory_analysis=mem,
        fits_one_card=mem["fits_one_card"],
        tokens_per_step=toks,
        active_params=n_active,
        model_flops=model_flops,
        model_flops_ratio=flops_ratio,
        **terms.to_dict(),
    )
    if verbose:
        print(f"[{arch} x {shape} x {mesh_kind}] trace ok "
              f"({rec['compile_s']}s); dominant={rec['dominant']}; "
              f"compute={rec['compute_s']:.3e}s memory={rec['memory_s']:.3e}s "
              f"collective={rec['collective_s']:.3e}s; "
              f"useful-flops-ratio={flops_ratio:.2f}")
        print("  memory_analysis:", mem)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--all", action="store_true", help="sweep all cells")
    ap.add_argument("--out", default=None, help="append JSON records here")
    ap.add_argument("--seq-axis", default=None,
                    help="shard seq dim of activations over this mesh axis (SP)")
    ap.add_argument("--dispatch", default=None, choices=("sort", "onehot", "local"),
                    help="override MoE dispatch path")
    ap.add_argument("--opt", action="store_true",
                    help="apply the beyond-paper optimized bundle (§Perf)")
    ap.add_argument("--fsdp", type=int, default=None, choices=(0, 1),
                    help="override the arch's FSDP setting")
    ap.add_argument("--no-extrapolate", action="store_true",
                    help="accepted for the reference's CLI; every layer is "
                         "counted anyway")
    ap.add_argument("--kv-seq-shard", action="store_true",
                    help="shard decode KV caches over model on the seq dim "
                         "(flash-decoding split-K layout, §Perf H6)")
    ap.add_argument("--loss-chunk", type=int, default=None,
                    help="chunked cross-entropy block size (§Perf H1)")
    ap.add_argument("--tag", default=None, help="variant label in the record")
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8 ppermute-ring gradient sync across pods "
                         "(multi mesh; §Perf H9)")
    args = ap.parse_args(argv)

    cells = (
        [(a, s) for a in ARCH_NAMES for s in SHAPES]
        if args.all else [(args.arch, args.shape)]
    )
    records = []
    for arch, shape in cells:
        rec = run_cell(arch, shape, args.mesh, seq_axis=args.seq_axis,
                       dispatch=args.dispatch, opt=args.opt,
                       fsdp=None if args.fsdp is None else bool(args.fsdp),
                       kv_seq_shard=args.kv_seq_shard,
                       loss_chunk=args.loss_chunk, tag=args.tag,
                       grad_compress=args.grad_compress,
                       no_extrapolate=args.no_extrapolate)
        records.append(rec)
        if rec["status"] == "error":
            print(f"[{arch} x {shape} x {args.mesh}] ERROR: {rec['error']}")
        elif rec["status"] == "skipped":
            print(f"[{arch} x {shape} x {args.mesh}] SKIP: {rec['reason'][:70]}")
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"dry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
