"""A process-group backend that carries CUDA tensors through host buffers.

NCCL refuses two ranks on one card, and gloo does not carry every
collective for a CUDA tensor.  Several ranks that share one card (the
port's multi-rank checks on a one-card host) therefore run their
collectives here: every collective copies its CUDA operands to the host,
runs gloo there, and copies the result back.  DTensor reaches it through
``torch.ops._c10d_functional`` like any backend; :mod:`.exchange` stages
its own collectives the same way.  Nothing about the result changes: the
same values cross the same ranks.

Usage: :func:`register` once a process, then
``init_process_group("cpu:gloo,cuda:staged", ...)``; a mesh over it is a
CUDA mesh to DTensor (``distributed.sharding._device_mesh``), so the
blocks stay on the card.  :data:`CALLS`
counts its collectives by name (calls and bytes each way through the
host), so a run shows what crossed it.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

#: collective -> [calls, bytes staged to the host and back] since the reset
CALLS: Dict[str, List[int]] = {}
NAME = "staged"


def reset_calls() -> None:
    CALLS.clear()


def _count(name: str, tensors) -> None:
    c = CALLS.setdefault(name, [0, 0])
    c[0] += 1
    c[1] += sum(t.numel() * t.element_size() for t in tensors)


def _done(result):
    from torch._C._distributed_c10d import _create_work_from_future

    fut = torch.futures.Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


def _host(ts):
    return [t.detach().cpu() for t in ts]


def _back(dst, src) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


class HostStagedGroup(dist.ProcessGroup):
    """The collectives DTensor and the port issue, each on host copies over
    a gloo group of the same ranks; a reduce-scatter is an all-reduce of
    the whole input, of which each rank keeps its block."""

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(dist.PrefixStore(NAME, store), rank,
                                           size, timeout)

    def getBackendName(self) -> str:
        return NAME

    @property
    def group_name(self) -> str:
        # c10d names a group it made from a Python backend in its registry
        return dist.distributed_c10d._world.pg_names[self]

    def allreduce(self, tensors, opts=None):
        _count("allreduce", tensors)
        host = _host(tensors)
        self._gloo.allreduce(host, opts or dist.AllreduceOptions()).wait()
        _back(tensors, host)
        return _done(tensors)

    def allreduce_coalesced(self, tensors, opts=None):
        return self.allreduce(tensors, opts)

    def broadcast(self, tensors, opts=None):
        _count("broadcast", tensors)
        host = _host(tensors)
        self._gloo.broadcast(host, opts or dist.BroadcastOptions()).wait()
        _back(tensors, host)
        return _done(tensors)

    def barrier(self, opts=None):
        self._gloo.barrier(opts or dist.BarrierOptions()).wait()
        return _done(None)

    def allgather(self, output_lists, inputs, opts=None):
        _count("allgather", inputs)
        host_out = [[torch.empty_like(t, device="cpu") for t in outs]
                    for outs in output_lists]
        self._gloo.allgather(host_out, _host(inputs),
                             opts or dist.AllgatherOptions()).wait()
        for outs, host in zip(output_lists, host_out):
            _back(outs, host)
        return _done(output_lists)

    def all_gather_single(self, output, input, opts=None):
        parts = list(torch.chunk(output, self.size()))
        return self.allgather([parts], [input], opts)

    def all_gather_single_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self.all_gather_single(o, i, opts)
        return _done(outputs)

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        return self.all_gather_single_coalesced(outputs, inputs, opts)

    def reduce_scatter_single(self, output, input, opts=None):
        _count("reduce_scatter", [input])
        whole = input.detach().to("cpu", copy=True)    # the input stays as it is
        ar = dist.AllreduceOptions()
        if opts is not None:
            ar.reduceOp = opts.reduceOp
        self._gloo.allreduce([whole], ar).wait()
        output.copy_(torch.chunk(whole, self.size())[self.rank()])
        return _done([output])

    def reduce_scatter(self, outputs, input_lists, opts=None):
        for out, parts in zip(outputs, input_lists):
            self.reduce_scatter_single(out, torch.cat(parts), opts)
        return _done(outputs)

    def reduce_scatter_single_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self.reduce_scatter_single(o, i, opts)
        return _done(outputs)

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        return self.reduce_scatter_single_coalesced(outputs, inputs, opts)

    def all_to_all_single(self, output, input, output_split_sizes=None,
                          input_split_sizes=None, opts=None):
        _count("all_to_all", [input])
        host_out = torch.empty_like(output, device="cpu")
        self._gloo.alltoall_base(host_out, input.detach().cpu(),
                                 list(output_split_sizes or []),
                                 list(input_split_sizes or []),
                                 opts or dist.AllToAllOptions()).wait()
        output.copy_(host_out)
        return _done([output])

    # point to point: posted, not waited on (a ring posts every send before
    # any receive); a receive copies to the card when it is waited on
    def send(self, tensors, dst: int, tag: int = 0):
        _count("send", tensors)
        return _Then(self._gloo.send(_host(tensors), dst, tag), lambda: None)

    def recv(self, tensors, src: int, tag: int = 0):
        host = [torch.empty_like(t, device="cpu") for t in tensors]
        _count("recv", tensors)
        return _Then(self._gloo.recv(host, src, tag), lambda: _back(tensors, host))


class _Then(dist.Work):
    """A gloo work, and what to do once it has completed."""

    def __init__(self, work, then):
        super().__init__()
        self._work, self._then = work, then

    def wait(self, timeout=None):
        self._work.wait()
        self._then()
        return True

    def is_completed(self):
        return self._work.is_completed()


def _create(store, rank, size, timeout):
    return HostStagedGroup(store, rank, size, timeout)


def shard_dim_alltoall(input, gather_dim: int, shard_dim: int, group_name):
    """DTensor's all-to-all between two split axes, over the group's Python
    collectives: every rank's block gathered along ``gather_dim``, then
    this rank's chunk along ``shard_dim`` (DTensor's own rule for a host
    mesh)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    group = (_resolve_process_group(group_name) if isinstance(group_name, str)
             else group_name)
    n = group.size()
    parts = [torch.empty_like(input) for _ in range(n)]
    dist.all_gather(parts, input.contiguous(), group=group)
    whole = torch.cat(parts, dim=gather_dim)
    me = dist.get_group_rank(group, dist.get_rank())
    # DTensor's split: torch.chunk's blocks, ranks past the last one empty
    chunks = torch.chunk(whole, n, dim=shard_dim)
    if me < len(chunks):
        return chunks[me].contiguous()
    return whole.narrow(shard_dim, 0, 0).contiguous()


_libs = []


def register(devices=("cuda",)) -> None:
    """Register the ``staged`` backend for ``devices`` (once a process).

    DTensor's all-to-all op (``_dtensor::shard_dim_alltoall``, which it
    runs on a CUDA mesh to move a split from one axis to another) looks
    its group's backend up in C++, where a group written in Python has
    none; so its kernels for ``devices`` become :func:`shard_dim_alltoall`
    in this process."""
    if NAME in dist.Backend.backend_list:
        return
    dist.Backend.register_backend(NAME, _create, devices=list(devices))
    lib = torch.library.Library("_dtensor", "IMPL")
    for dev in devices:
        lib.impl("shard_dim_alltoall", shard_dim_alltoall,
                 {"cuda": "CUDA", "cpu": "CPU"}[dev])
    _libs.append(lib)
