"""Wrappers of the int8 WDM matmul and of the parallel projection's current
(the ring gather folded into the matmul): plain versions on CPU, K2 on
CUDA.  The projection has two designs in ``csrc/spike_wdm_matmul.cu``, one
algorithm at two operating points, chosen by the map's shape
(:func:`wdm_design`)."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _common
from .ref import spike_wdm_matmul_ref, spike_wdm_project_ref

#: Launches of the CUDA kernels by entry point (the plain versions count none).
LAUNCHES = {"spike_wdm_matmul": 0, "spike_wdm_project": 0}

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_PROJECT_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.c_int64, ctypes.c_void_p,
]
_STREAM_ARGTYPES = _PROJECT_ARGTYPES[:-1] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_fn = None
_project_fn = None
_stream_fn = None

#: The streamed design takes a map of at least STREAM_MIN_BYTES (M K) at 1
#: to STREAM_MAX_LANES lanes, and at one lane already a map of at least
#: STREAM_MIN_BYTES_ONE_LANE whose rows are longer than the latency design's
#: 1,024-column tile (past it the latency design walks K tile by tile).
#: Below, the latency design's shorter launch wins.  Set from chip_smoke.py's
#: K2 sweep of both designs.
STREAM_MIN_BYTES = 4 << 20
STREAM_MIN_BYTES_ONE_LANE = 1 << 20
STREAM_MAX_LANES = 8
LATENCY_TILE = 1024
#: the streamed kernel's limits (csrc: kMaxRows, kSpikeBytes, kUnroll; the
#: largest portable cluster)
STREAM_MAX_ROWS, STREAM_SPIKE_BYTES, STREAM_UNROLL, STREAM_MAX_SPLIT = 64, 2048, 4, 8


def wdm_design(m: int, k: int, lanes: int) -> str:
    """The K2 design that :func:`spike_wdm_project` runs on the card for an
    (m, k) map at ``lanes``: ``"streamed"`` (the map read once a call for
    every lane) for a map of at least :data:`STREAM_MIN_BYTES`, or at one
    lane of at least :data:`STREAM_MIN_BYTES_ONE_LANE` with rows longer than
    :data:`LATENCY_TILE`; else ``"latency"`` (a warp a row and lane, the
    short launch small maps want)."""
    if not 1 <= lanes <= STREAM_MAX_LANES:
        return "latency"
    if m * k >= STREAM_MIN_BYTES or (
            lanes == 1 and k > LATENCY_TILE and m * k >= STREAM_MIN_BYTES_ONE_LANE):
        return "streamed"
    return "latency"


def stream_tiling(m: int, k: int, lanes: int, sms: int):
    """The streamed design's grid for an (m, k) map at ``lanes`` (1 to 8) on
    a card of ``sms`` multiprocessors: ``(rows, split, width, slice, lpr)``.

    A block streams ``rows`` rows over ``width`` columns, and the ``split``
    blocks of a cluster (1 to 8, a slice never below 512 columns) cover K
    between them: as few splits as give a call two blocks an SM, with 64
    rows a block, or 32 or 16 where the map has too few rows for that.  A
    block stages ``slice`` columns at a time (the passes over one width
    equal; at most 2,032 at a lane, 2,048 bytes a lane less a chunk, fewer
    the more lanes), and ``lpr`` lanes stream a row: enough for a slice's
    chunks in one turn of four a lane, from 4 to 32."""
    target, most = 2 * sms, 1
    while most < STREAM_MAX_SPLIT and k >= 1024 * most:
        most *= 2
    rows = next((r for r in (64, 32) if -(-m // r) * most >= target), 16)
    tiles, split = -(-m // rows), 1
    while split < most and tiles * split < target:
        split *= 2
    width = 16 * -(-k // (16 * split))
    widest = STREAM_SPIKE_BYTES // (1 << (lanes - 1).bit_length()) - 16
    passes = -(-width // widest)
    slice_ = 16 * -(-width // (16 * passes))
    lpr = 4
    while lpr < 32 and lpr * STREAM_UNROLL < slice_ // 16 + 1:
        lpr *= 2
    return rows, split, width, slice_, lpr


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def spike_wdm_matmul(wdm: torch.Tensor, stacked: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) WDM x int8 (N, K) stacked spikes -> int32 (N, M).

    ``out[n, m] = sum_k wdm[m, k] * stacked[n, k]``, with no saturation.
    CPU tensors run :func:`spike_wdm_matmul_ref`; CUDA tensors run the
    CUDA kernel ``csrc/spike_wdm_matmul.cu`` or raise.  ``K == 0`` returns
    zeros without a launch.
    """
    if _common.on_cpu(wdm, stacked):
        return spike_wdm_matmul_ref(wdm, stacked)
    dev = _common.check_cuda("spike_wdm_matmul", wdm=wdm, stacked=stacked)
    _common.check_dtype("spike_wdm_matmul", torch.int8, wdm=wdm, stacked=stacked)
    if wdm.ndim != 2 or stacked.ndim != 2 or wdm.shape[1] != stacked.shape[1]:
        raise ValueError(
            f"spike_wdm_matmul: need (M, K) and (N, K); got "
            f"{tuple(wdm.shape)} and {tuple(stacked.shape)}"
        )
    (m, k), n = wdm.shape, stacked.shape[0]
    if k == 0 or m * n == 0:
        return torch.zeros((n, m), dtype=torch.int32, device=dev)
    out = torch.empty((n, m), dtype=torch.int32, device=dev)
    global _fn
    if _fn is None:
        _fn = _common.load("spike_wdm_matmul", "spike_wdm_matmul_s8", _ARGTYPES)
    status = _fn(
        wdm.data_ptr(), stacked.data_ptr(), out.data_ptr(), m, k, n,
        _common.stream(dev),
    )
    _common.check(status, "spike_wdm_matmul")
    LAUNCHES["spike_wdm_matmul"] += 1
    return out


def spike_wdm_project(
    wdm: torch.Tensor,
    col_source: torch.Tensor,
    col_delay: torch.Tensor,
    x_hist: torch.Tensor,
    t: int,
) -> torch.Tensor:
    """The parallel projection's (B, M) f32 current at step ``t``.

    ``wdm`` (M, K) int8, ``col_source``/``col_delay`` (K,) int32 (the input
    merging table), ``x_hist`` the ``(B, d, S)`` int8 spike-history ring.
    CPU tensors run :func:`spike_wdm_project_ref` (column gather, product,
    cast); CUDA tensors run one launch of ``csrc/spike_wdm_matmul.cu`` that
    gathers each lane's stacked row from the ring itself, or raise.
    Bitwise equal to the plain version.  ``K == 0`` returns zeros without a
    launch.
    """
    if _common.on_cpu(wdm, col_source, col_delay, x_hist):
        return spike_wdm_project_ref(wdm, col_source, col_delay, x_hist, t)
    dev = _common.check_cuda("spike_wdm_project", wdm=wdm, col_source=col_source,
                             col_delay=col_delay, x_hist=x_hist)
    _common.check_dtype("spike_wdm_project", torch.int8, wdm=wdm, x_hist=x_hist)
    _common.check_dtype("spike_wdm_project", torch.int32, col_source=col_source,
                        col_delay=col_delay)
    if (wdm.ndim != 2 or x_hist.ndim != 3
            or col_source.shape != (wdm.shape[1],)
            or col_delay.shape != (wdm.shape[1],)):
        raise ValueError(
            f"spike_wdm_project: need wdm (M, K), col_source and col_delay "
            f"(K,), x_hist (B, d, S); got {tuple(wdm.shape)}, "
            f"{tuple(col_source.shape)}, {tuple(col_delay.shape)}, "
            f"{tuple(x_hist.shape)}"
        )
    (m, k), (n, depth, n_source) = wdm.shape, x_hist.shape
    if depth < 1:
        raise ValueError("spike_wdm_project: the ring needs depth >= 1")
    if k == 0 or m * n == 0:
        return torch.zeros((n, m), dtype=torch.float32, device=dev)
    return _project(wdm_design(m, k, n), wdm, col_source, col_delay, x_hist, t)


def _project(design, wdm, col_source, col_delay, x_hist, t) -> torch.Tensor:
    """One launch of K2's ``design`` on checked, non-empty operands (the
    tests and ``chip_smoke.py`` name the design to hold both to the plain
    version at any shape)."""
    (m, k), (n, depth, n_source) = wdm.shape, x_hist.shape
    dev = wdm.device
    out = torch.empty((n, m), dtype=torch.float32, device=dev)
    global _project_fn, _stream_fn
    args = (wdm.data_ptr(), x_hist.data_ptr(), col_source.data_ptr(),
            col_delay.data_ptr(), out.data_ptr(), m, k, n, depth, n_source,
            int(t))
    if design == "streamed":
        if not 1 <= n <= STREAM_MAX_LANES:
            raise ValueError(f"spike_wdm_project: the streamed design takes 1 "
                             f"to {STREAM_MAX_LANES} lanes; got {n}")
        if _stream_fn is None:
            _stream_fn = _common.load("spike_wdm_matmul", "spike_wdm_stream_s8",
                                      _STREAM_ARGTYPES)
        tiling = stream_tiling(m, k, n, _sm_count(dev.index))
        status = _stream_fn(*args, *tiling, _common.stream(dev))
    elif design == "latency":
        if _project_fn is None:
            _project_fn = _common.load("spike_wdm_matmul", "spike_wdm_project_s8",
                                       _PROJECT_ARGTYPES)
        status = _project_fn(*args, _common.stream(dev))
    else:
        raise ValueError(f"spike_wdm_project: no design {design!r}")
    _common.check(status, "spike_wdm_project")
    LAUNCHES["spike_wdm_project"] += 1
    return out


__all__ = [
    "spike_wdm_matmul", "spike_wdm_matmul_ref", "spike_wdm_project",
    "spike_wdm_project_ref", "stream_tiling", "wdm_design", "LAUNCHES",
]
