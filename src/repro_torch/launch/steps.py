"""Step functions (train / prefill / serve) and their sharding trees: the
port of ``repro.launch.steps``.

``make_train_step`` is the reference's: the loss and its gradients
(:func:`repro_torch.models.model.value_and_grad`), then one AdamW update,
all on the parameters' device.  The same three step functions run a model
over a mesh of ranks: give them DTensor trees
(:func:`repro_torch.distributed.sharding.shard_tree` under the trees of
:func:`param_shardings`, :func:`opt_shardings`, :func:`batch_shardings`
and :func:`cache_shardings`) and call them inside
``sharding_ctx(mesh, rules)``; DTensor inserts the collectives that GSPMD
inserts for the reference's ``jax.jit(step, in_shardings, ...)``.

:func:`make_train_step_compressed` is the reference's hierarchical
gradient sync: the ranks of a pod run the step over their ``(data,
model)`` sub-mesh, and each gradient crosses pods as int8 on a ring.
"""
from __future__ import annotations

import torch

from ..distributed import exchange
from ..distributed.sharding import (
    NamedSharding, PartitionSpec as P, map_blocks, sharding_ctx, spec_for_shape,
    tree_shardings,
)
from ..models import init as minit, model as M
from ..models.config import ModelConfig
from ..models.init import group_layers
from ..optim import AdamWConfig, AdamWState, apply_updates
from ..tree import leaves, tree_map, unflatten_like


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    def train_step(params, opt_state, batch):
        loss, grads = M.value_and_grad(params, cfg, batch)
        params, opt_state, metrics = apply_updates(params, grads, opt_state, opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch, cache_len)

    return prefill_step


def make_serve_step(cfg: ModelConfig, cache_len: int):
    def serve_step(params, caches, tokens, pos):
        return M.decode_step(params, cfg, tokens, pos, caches, cache_len)

    return serve_step


# ---------------------------------------------------------------------------
# sharding trees
# ---------------------------------------------------------------------------

def param_shardings(cfg: ModelConfig, mesh, rules: dict):
    return tree_shardings(minit.param_specs(cfg), minit.param_shapes(cfg),
                          mesh, rules)


def opt_shardings(cfg: ModelConfig, mesh, rules: dict) -> AdamWState:
    p = param_shardings(cfg, mesh, rules)
    return AdamWState(step=NamedSharding(mesh, P()), m=p, v=p)


#: logical axes of the batch's leaves
BATCH_AXES = {
    "tokens": ("batch", None),
    "labels": ("batch", None),
    "embeds": ("batch", "seq", None),
    "patch_embeds": ("batch", None, None),
}


def batch_shardings(cfg: ModelConfig, mesh, rules: dict, shape: str):
    from .shapes import batch_specs
    return {
        k: NamedSharding(mesh, spec_for_shape(BATCH_AXES[k], rules, v.shape,
                                              mesh))
        for k, v in batch_specs(cfg, shape).items()
    }


def cache_logical_specs(cfg: ModelConfig):
    """Logical axes mirroring models.model.init_caches structure."""
    groups = []
    for types, _repeat in group_layers(cfg):
        per_type = []
        for bt in types:
            if bt == "attn":
                per_type.append({
                    "k": ("layers", "batch", "kv_seq", "heads", None),
                    "v": ("layers", "batch", "kv_seq", "heads", None),
                })
            elif bt == "mamba2":
                per_type.append({
                    "conv": ("layers", "batch", "heads", None),
                    "ssd": ("layers", "batch", "heads", None, None),
                })
            elif bt == "rglru":
                per_type.append({
                    "conv": ("layers", "batch", "heads", None),
                    "h": ("layers", "batch", "heads"),
                })
        groups.append(per_type)
    return groups


def cache_shardings(cfg: ModelConfig, mesh, rules: dict, shape: str):
    from .shapes import cache_specs
    return tree_shardings(cache_logical_specs(cfg), cache_specs(cfg, shape),
                          mesh, rules)


# ---------------------------------------------------------------------------
# the steps over pods: a (pod, data, model) mesh
# ---------------------------------------------------------------------------

def _to_mesh(t, mesh, placements):
    """The DTensor ``t``'s local block as a DTensor on ``mesh`` (a sub-mesh
    of ``t``'s) with ``placements``: the global shape is what they give."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t.to_local(), mesh, placements, run_check=False)


def _tree_to_mesh(tree, mesh, placements_of):
    from torch.distributed.tensor import DTensor

    return unflatten_like(tree, [
        _to_mesh(t, mesh, placements_of(t)) if isinstance(t, DTensor) else t
        for t in leaves(tree)])


def pod_mesh(mesh, n_pods: int | None = None):
    """(the ``pod`` group, this rank's pod's ``(data, model)`` sub-mesh) of
    a ``("pod", "data", "model")`` mesh; raises on any other mesh."""
    names = tuple(mesh.mesh_dim_names)
    if names[0] != "pod" or (n_pods is not None and mesh.shape[0] != n_pods):
        raise ValueError(f"a step over pods needs a mesh whose first axis is "
                         f"pod{'' if n_pods is None else f' of size {n_pods}'}; "
                         f"got {names} {tuple(mesh.shape)}")
    return mesh.get_group("pod"), mesh[names[1:]]


def pod_rules(rules: dict) -> dict:
    """``rules`` within one pod: every mapping onto ``pod`` dropped."""
    return {k: tuple(a for a in v if a != "pod") for k, v in rules.items()}


def to_pod(tree, mesh):
    """DTensor leaves on a ``(pod, ...)`` mesh as DTensors on this rank's
    pod's sub-mesh: a leaf whole over ``pod`` is the same tensor there, a
    leaf split over it (the batch) the pod's share."""
    _, sub = pod_mesh(mesh)
    return _tree_to_mesh(tree, sub, lambda t: tuple(t.placements[1:]))


def _from_pod(tree, mesh):
    """Pod sub-mesh DTensors that every pod holds alike, back on ``mesh``."""
    from torch.distributed.tensor import Replicate

    return _tree_to_mesh(tree, mesh, lambda t: (Replicate(),) + tuple(t.placements))


def _pod_ctx(sub, rules):
    """``sharding_ctx`` on a pod's sub-mesh under the pod's rules; with no
    rules (the compressed step, as the reference's) only DTensor's
    implicit replication of the plain tensors a step makes."""
    from torch.distributed.tensor.experimental import implicit_replication

    return (implicit_replication() if rules is None
            else sharding_ctx(sub, pod_rules(rules)))


def on_pods(step, mesh, rules: dict):
    """``step`` (prefill or serve) over a ``("pod", "data", "model")`` mesh
    as each pod's step on its ``(data, model)`` sub-mesh, inside
    ``sharding_ctx`` under the pod's rules: batch rows are independent, so
    no pod needs another's.  Takes DTensor arguments on ``mesh``; returns
    the pod's outputs (its rows) on its sub-mesh."""
    _, sub = pod_mesh(mesh)

    def run(*args):
        with _pod_ctx(sub, rules):
            return step(*to_pod(list(args), mesh))

    return run


def _pods_train_step(cfg, opt_cfg, mesh, n_pods, sync, rules=None):
    """The train step of each pod on its ``(data, model)`` sub-mesh, its
    gradients and loss combined across pods by ``sync(loss, count, grads,
    pod_group) -> (loss, grads)``, then AdamW on every rank.  Takes and
    returns DTensor trees on ``mesh`` (parameters and moments whole over
    ``pod``, the batch split over it)."""
    pod_group, sub = pod_mesh(mesh, n_pods)

    def step(params, opt_state, batch):
        for t in leaves((params, opt_state)):
            if not t.placements[0].is_replicate():
                raise ValueError("a step over pods needs parameters and moments "
                                 f"whole over pod; got {t.placements}")
        p_sub, o_sub, b_sub = (to_pod(tree, mesh)
                               for tree in (params, opt_state, batch))
        with _pod_ctx(sub, rules):
            loss, grads = M.value_and_grad(p_sub, cfg, b_sub)
            loss, grads = sync(loss, M.label_count(cfg, b_sub), grads, pod_group)
            params2, opt2, metrics = apply_updates(p_sub, grads, o_sub, opt_cfg)
        metrics["loss"] = loss
        return _from_pod(params2, mesh), _from_pod(opt2, mesh), metrics

    return step


def _whole(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def make_train_step_pods(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh,
                         rules: dict):
    """``make_train_step`` over a ``("pod", "data", "model")`` mesh, as the
    pods' steps: within a pod, the step over its ``(data, model)`` ranks on
    the pod's share of the batch (DTensor's collectives); across pods, every
    gradient block and the loss all-reduced over ``pod`` (dense), weighted
    by the pods' label counts, which gives the whole batch's mean loss and
    its gradient, the reference's GSPMD step; then AdamW on every rank.
    The pods' steps run inside ``sharding_ctx`` under ``rules`` within a
    pod (:func:`pod_rules`).

    Not ``make_train_step`` on the three-axis mesh itself: DTensor's search
    over sharding strategies grows with the mesh's axes, and on three it
    takes about 20 times as long to trace a step as on two."""
    def dense(loss, count, grads, group):
        count = _whole(count).to(torch.float32)
        total = exchange.all_reduce(count, group)
        share = count / total
        loss = exchange.all_reduce(_whole(loss) * share, group)
        return loss, _blockwise_sum(grads, share, group)

    return _pods_train_step(cfg, opt_cfg, mesh, None, dense, rules)


def _blockwise_sum(grads, share, group):
    """Each gradient leaf's local block times ``share``, summed over
    ``group`` (whose ranks hold the same block)."""
    return tree_map(lambda g: map_blocks(
        lambda b: exchange.all_reduce(b * share.to(b.dtype), group), g), grads)


def make_train_step_compressed(cfg: ModelConfig, opt_cfg: AdamWConfig,
                               mesh, n_pods: int = 2):
    """Hierarchical gradient sync over a ``("pod", "data", "model")`` mesh:
    within a pod, the step over the pod's ``(data, model)`` sub-mesh on the
    pod's share of the batch (DTensor's all-reduces); across pods, each
    gradient leaf as int8 on a ring of the ranks that hold the same block
    (:func:`repro_torch.optim.compression.ring_psum_int8`: a sum, not a
    mean, as in the reference), and the loss averaged over pods; then AdamW
    on every rank.  The step takes and returns DTensor trees on ``mesh``
    (parameters and moments replicated over ``pod``, the batch split over
    it, as :func:`param_shardings` and :func:`batch_shardings` give them
    under ``make_rules(multi_pod=True)``).  Like the reference, it opens no
    ``sharding_ctx``: the pods' steps run on their arguments' layouts."""
    from ..optim.compression import ring_psum_int8

    def int8_ring(loss, _count, grads, group):
        loss = exchange.all_reduce(_whole(loss), group) / n_pods
        return loss, ring_psum_int8(grads, group, n_pods)

    return _pods_train_step(cfg, opt_cfg, mesh, n_pods, int8_ring)


def make_opt_cfg(**kw) -> AdamWConfig:
    return AdamWConfig(**kw)
