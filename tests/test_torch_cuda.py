"""The port's CUDA kernels on the card, each held to its plain version.

Every test here is marked ``cuda`` and skips on a host without a CUDA
card.  The file imports neither JAX nor the reference package, so it runs
on a GPU host that has only PyTorch::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The operand generators are shared with ``tests/test_torch_kernels.py``,
which holds the plain versions to the reference package on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import SwitchingCompiler, feedforward_network
from repro_torch.core.layer import LIFParams
from repro_torch.core.runtime import network_executable, source_major_index
from repro_torch.kernels import add_launch_counts, launch_counts, reset_launch_counts
from repro_torch.kernels.event_scatter import event_scatter, event_scatter_ref
from repro_torch.kernels.lif_parallel_scan import (
    lif_fixed_point,
    lif_fixed_point_launch,
    lif_fixed_point_ref,
    lif_parallel_scan,
    lif_parallel_scan_ref,
    shared_words_limit,
    staged_steps_limit,
)
from repro_torch.kernels.lif_update import (
    MAX_EDGES,
    CurrentEdge,
    RingEdge,
    lif_step,
    lif_step_ref,
    lif_update,
    lif_update_ref,
)
from repro_torch.kernels.sparse_gather import sparse_gather, sparse_gather_ref
from repro_torch.core.runtime.parallel_runtime import parallel_project
from repro_torch.kernels.spike_wdm_matmul import (
    spike_wdm_matmul,
    spike_wdm_matmul_ref,
    spike_wdm_project,
    spike_wdm_project_ref,
)
from repro_torch.kernels.ssd_chunk import SSDChunk, ssd_chunk, ssd_chunk_ref
from test_torch_event_scatter import CASES as EVENT_CASES
from test_torch_event_scatter import projection as event_projection
from test_torch_event_scatter import slabs as event_slabs
from test_torch_event_scatter import spikes as event_spikes


def wdm_operands(m, k, n, seed, p=0.3):
    """Reference layout: wdm (M, K) int8, stacked spikes (K, N) int8."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    x = (rng.random((k, n)) < p).astype(np.int8)
    return a, x


def lif_operands(n, b, seed):
    rng = np.random.default_rng(seed)
    i = (rng.normal(size=(n, b)) * 10).astype(np.float32)
    v = rng.normal(size=(n, b)).astype(np.float32)
    z = rng.integers(0, 2, (n, b)).astype(np.float32)
    return i, v, z


def ell_operands(r, lanes, s, b, seed, ragged=True):
    """ELL rows with int8-magnitude integer weights; ragged rows keep a
    random number of live lanes, the rest padding (weight 0, index 0)."""
    rng = np.random.default_rng(seed)
    val = rng.integers(-127, 128, (r, lanes)).astype(np.float32)
    idx = rng.integers(0, s, (r, lanes)).astype(np.int32)
    if ragged:
        keep = np.arange(lanes)[None, :] < rng.integers(0, lanes + 1, (r, 1))
        val = np.where(keep, val, 0).astype(np.float32)
        idx = np.where(keep, idx, 0).astype(np.int32)
    x = (rng.random((s, b)) < 0.3).astype(np.float32)
    return val, idx, x


def scan_operands(shape, seed, kind="int"):
    """A (T, F) f32 current train: integers in [-5, 5] (the reference's
    scan-kernel fixture) or standard normal floats."""
    rng = np.random.default_rng(seed)
    if kind == "int":
        return rng.integers(-5, 6, size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


#: The gesture path's (T, F) of both populations, the reference's padded
#: and chunked test shape, a square benchmark shape and the smallest.
SCAN_SHAPES = [(75, 160), (75, 32), (300, 130), (512, 512), (1, 1)]
SCAN_ALPHAS = [0.0, 0.5, 0.9, 1.0]

#: The reference's kernel-test shapes, the gesture path's and the
#: reference benchmark's (M, K, N).
WDM_SHAPES = [
    (4, 16, 1), (128, 128, 128), (128, 512, 128), (300, 700, 36),
    (1, 1, 1), (257, 1025, 129), (20, 965, 8),
]


@pytest.fixture
def card():
    """The CUDA card; skips the test on a host without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA (an H100 host)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 20), (1024, 128), (300, 36), (1, 1)])
@pytest.mark.parametrize("alpha,v_th", [(0.5, 64.0), (0.9, 1.0)])
def test_lif_kernel_on_card(card, shape, alpha, v_th):
    """Bitwise on v too: alpha = 0.9 is not dyadic, so an FMA would show."""
    i, v, z = (torch.from_numpy(a).to(card) for a in lif_operands(*shape, seed=1))
    before = launch_counts()["lif_update"]
    vk, zk = lif_update(i, v, z, alpha=alpha, v_th=v_th)
    vp, zp = lif_update_ref(i, v, z, alpha=alpha, v_th=v_th)
    torch.cuda.synchronize()
    assert launch_counts()["lif_update"] == before + 1
    assert torch.equal(vk.view(torch.int32), vp.view(torch.int32))
    assert torch.equal(zk, zp)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", WDM_SHAPES + [(512, 2048, 128), (33, 3, 5),
                                                (33, 9000, 5)])
def test_wdm_kernel_on_card(card, m, k, n):
    a, x = wdm_operands(m, k, n, seed=2)
    a, xt = torch.from_numpy(a).to(card), torch.from_numpy(x.T.copy()).to(card)
    out, ref = spike_wdm_matmul(a, xt), spike_wdm_matmul_ref(a, xt)
    torch.cuda.synchronize()
    assert out.dtype == torch.int32 and torch.equal(out, ref)


@pytest.mark.cuda
def test_wdm_kernel_does_not_saturate(card):
    full = torch.full((128, 512), 127, dtype=torch.int8, device=card)
    ones = torch.ones((8, 512), dtype=torch.int8, device=card)
    assert (spike_wdm_matmul(full, ones) == 127 * 512).all()
    neg = torch.full((4, 16), -128, dtype=torch.int8, device=card)
    ones = torch.ones((2, 16), dtype=torch.int8, device=card)
    assert (spike_wdm_matmul(neg, ones) == -128 * 16).all()
    empty = spike_wdm_matmul(torch.zeros((32, 0), dtype=torch.int8, device=card),
                             torch.zeros((4, 0), dtype=torch.int8, device=card))
    assert empty.shape == (4, 32) and not empty.any()


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    f32 = torch.zeros((6, 4), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        lif_update(f32.T, f32.T, f32.T, alpha=0.5, v_th=1.0)
    with pytest.raises(TypeError, match="float32"):
        lif_update(f32.double(), f32, f32, alpha=0.5, v_th=1.0)
    with pytest.raises(ValueError, match="shapes differ"):
        lif_update(f32, f32[:3], f32, alpha=0.5, v_th=1.0)
    i8 = torch.zeros((4, 8), dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        spike_wdm_matmul(i8, torch.zeros((8, 2), dtype=torch.int8, device=card).T)
    with pytest.raises(ValueError, match=r"\(M, K\) and \(N, K\)"):
        spike_wdm_matmul(i8, i8[:, :5].contiguous())
    with pytest.raises(ValueError, match="CUDA device"):
        spike_wdm_matmul(i8, i8.cpu())
    idx = torch.zeros((6, 4), dtype=torch.int32, device=card)
    with pytest.raises(TypeError, match="int32"):
        sparse_gather(f32, idx.long(), f32)
    with pytest.raises(ValueError, match=r"\(R, L\)"):
        sparse_gather(f32, idx[:3].contiguous(), f32)
    with pytest.raises(ValueError, match="ell_val must be contiguous"):
        sparse_gather(f32.T.contiguous().T, idx, f32)
    with pytest.raises(ValueError, match="ell_idx must be contiguous"):
        sparse_gather(f32, idx.T.contiguous().T, f32)


@pytest.mark.cuda
@pytest.mark.parametrize("r,lanes,s,b", [(4096, 32, 2048, 8), (40, 78, 2048, 8),
                                         (3000, 17, 500, 3), (1, 1, 1, 1)])
def test_gather_kernel_on_card(card, r, lanes, s, b):
    val, idx, x = (torch.from_numpy(a).to(card)
                   for a in ell_operands(r, lanes, s, b, seed=3))
    out, ref = sparse_gather(val, idx, x), sparse_gather_ref(val, idx, x)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "transposed", "sliced"])
@pytest.mark.parametrize("lanes", [1, 78])
@pytest.mark.parametrize("b", [1, 3, 8, 32, 33, 600])
def test_gather_kernel_strided_on_card(card, b, lanes, layout):
    """Both designs (B <= 32 lanes-per-row, B > 32 columns-per-thread) on
    ragged rows, with x source-major, as the view ``x_t.t()`` of a (B, S)
    spike matrix (the fused step's call) and as a column slice of a wider
    one: bitwise equal to the plain version, one launch each."""
    r, s = 40, 2048
    val, idx, x = (torch.from_numpy(a).to(card)
                   for a in ell_operands(r, lanes, s, b, seed=b + lanes))
    if layout == "transposed":
        x = x.t().contiguous().t()
    elif layout == "sliced":
        wide = torch.zeros((s, b + 5), device=card)
        wide[:, 2:2 + b] = x
        x = wide[:, 2:2 + b]
    before = launch_counts()["sparse_gather"]
    out = sparse_gather(val, idx, x)
    torch.cuda.synchronize()
    assert launch_counts()["sparse_gather"] == before + 1
    assert torch.equal(out, sparse_gather_ref(val, idx, x))
    assert torch.equal(out, sparse_gather_ref(val, idx, x.contiguous()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int", "randn"])
@pytest.mark.parametrize("alpha", SCAN_ALPHAS)
@pytest.mark.parametrize("shape", SCAN_SHAPES)
def test_scan_kernel_on_card(card, shape, alpha, kind):
    """Bitwise at any alpha: kernel and plain version both walk T in order
    with separately rounded f32 ops."""
    c = torch.from_numpy(scan_operands(shape, seed=shape[0], kind=kind)).to(card)
    before = launch_counts()["lif_parallel_scan"]
    vk = lif_parallel_scan(c, alpha=alpha)
    vp = lif_parallel_scan_ref(c, alpha=alpha)
    torch.cuda.synchronize()
    assert launch_counts()["lif_parallel_scan"] == before + 1
    assert torch.equal(vk.view(torch.int32), vp.view(torch.int32))


@pytest.mark.cuda
def test_scan_wrapper_edges_and_refusals(card):
    before = launch_counts()["lif_parallel_scan"]
    for shape in ((0, 5), (4, 0)):
        out = lif_parallel_scan(torch.zeros(shape, device=card), alpha=0.5)
        assert out.shape == shape and out.device.type == "cuda"
    assert launch_counts()["lif_parallel_scan"] == before
    f32 = torch.zeros((6, 4), device=card)
    with pytest.raises(TypeError, match="float32"):
        lif_parallel_scan(f32.double(), alpha=0.5)
    with pytest.raises(ValueError, match="contiguous"):
        lif_parallel_scan(f32.T, alpha=0.5)
    with pytest.raises(ValueError, match=r"\(T, F\)"):
        lif_parallel_scan(f32[None], alpha=0.5)


def fixed_point_operands(shape, seed):
    """(T, F) integer currents in [-40, 120): reset cascades that take the
    columns different numbers of passes (tests/test_torch_fused.py)."""
    rng = np.random.default_rng(seed)
    return rng.integers(-40, 120, size=shape).astype(np.float32)


def sync_count(fn):
    """How many times ``fn`` makes the host wait for the card (CUDA's sync
    debug mode warns once per synchronising call)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


#: (T, F) of the fused fixed point: the gesture path's two populations, a
#: longer train, and (None) a train longer than the shared-memory staging
#: limit, sized on the card
FIXED_POINT_SHAPES = [(75, 160), (75, 32), (512, 64), (None, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [0.5, 0.9])
@pytest.mark.parametrize("cap", ["1", "T+1"])
@pytest.mark.parametrize("shape", FIXED_POINT_SHAPES)
def test_fixed_point_kernel_on_card(card, shape, cap, alpha):
    """One launch, bitwise equal to the plain per-pass loop in spikes,
    passes and residual: staged in shared memory and, above the staging
    limit, read from device memory on each pass."""
    steps, feat = shape
    if steps is None:
        steps = staged_steps_limit(card) + 48
    i = torch.from_numpy(fixed_point_operands((steps, feat), seed=feat)).to(card)
    cap = 1 if cap == "1" else steps + 1
    before = launch_counts()["lif_fixed_point"]
    z, iters, residual = lif_fixed_point(i, alpha=alpha, v_th=64.0, cap=cap)
    assert launch_counts()["lif_fixed_point"] == before + 1
    zr, iters_r, residual_r = lif_fixed_point_ref(i, alpha=alpha, v_th=64.0, cap=cap)
    assert torch.equal(z, zr)
    assert (iters, residual) == (iters_r, residual_r)
    # one pass from silence flips every spike it fires
    assert residual == (int(z.sum()) if cap == 1 else 0)
    assert 0 < float(z.mean()) < 1


@pytest.mark.cuda
def test_fixed_point_edges_and_refusals(card):
    before = launch_counts()["lif_fixed_point"]
    for shape in ((0, 5), (4, 0)):
        z, iters, residual = lif_fixed_point(torch.zeros(shape, device=card),
                                             alpha=0.5, v_th=64.0, cap=3)
        assert z.shape == shape and z.device.type == "cuda"
        assert (iters, residual) == (1, 0)
    assert launch_counts()["lif_fixed_point"] == before
    f32 = torch.zeros((6, 4), device=card)
    with pytest.raises(TypeError, match="float32"):
        lif_fixed_point(f32.double(), alpha=0.5, v_th=64.0, cap=3)
    with pytest.raises(ValueError, match="contiguous"):
        lif_fixed_point(f32.T, alpha=0.5, v_th=64.0, cap=3)
    with pytest.raises(ValueError, match="cap"):
        lif_fixed_point(f32, alpha=0.5, v_th=64.0, cap=0)
    # one step past the spike words' shared-memory limit runs (its words in
    # device memory), as the plain version does
    longest = shared_words_limit(card)
    silent = torch.zeros((longest + 1, 2), device=card)
    z, iters, residual = lif_fixed_point(silent, alpha=0.5, v_th=64.0, cap=2)
    assert (iters, residual) == (1, 0) and not z.any()
    # the launch form reads nothing back: it makes the host wait for nothing
    i = torch.from_numpy(fixed_point_operands((75, 160), seed=0)).to(card)
    assert sync_count(lambda: lif_fixed_point_launch(i, alpha=0.5, v_th=64.0,
                                                     cap=76)) == 0
    assert sync_count(lambda: lif_fixed_point(i, alpha=0.5, v_th=64.0, cap=76)) == 1


def project_operands(m, k, batch, depth, n_source, seed):
    rng = np.random.default_rng(seed)
    wdm = rng.integers(-128, 128, (m, k)).astype(np.int8)
    col_source = rng.integers(0, n_source, k).astype(np.int32)
    col_delay = rng.integers(1, depth + 1, k).astype(np.int32)
    ring = (rng.random((batch, depth, n_source)) < 0.3).astype(np.int8)
    return wdm, col_source, col_delay, ring


#: (M, K, B, d, S): the gesture path's parallel edge (d 1), a ring of depth
#: 4, and a K above the kernel's 1 KB staging tile
PROJECT_SHAPES = [(20, 965, 8, 1, 2048), (4, 20, 1, 1, 20), (20, 965, 8, 4, 2048),
                  (33, 9000, 5, 4, 3000), (300, 700, 36, 3, 500)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,batch,depth,n_source", PROJECT_SHAPES)
def test_project_kernel_on_card(card, m, k, batch, depth, n_source):
    """The ring gather inside the kernel, bitwise equal to the plain
    version (gather, int8 product, cast) at t from 0 past three ring
    depths, so the slots wrap around and t - delay goes negative."""
    ops = [torch.from_numpy(a).to(card)
           for a in project_operands(m, k, batch, depth, n_source, seed=k)]
    for t in range(3 * depth + 1):
        before = launch_counts()["spike_wdm_project"]
        out = spike_wdm_project(*ops, t)
        assert launch_counts()["spike_wdm_project"] == before + 1
        ref = spike_wdm_project_ref(*ops, t)
        assert out.dtype == torch.float32 and torch.equal(out, ref), f"t={t}"
    assert float(out.abs().sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_wdm_kernels_take_a_wdm_at_any_byte(card, offset):
    """A contiguous WDM view that starts off a 4-byte boundary (the kernel
    reads it as aligned words) gives the same currents."""
    wdm, src, dly, ring = project_operands(20, 965, 8, 4, 2048, seed=offset)
    base = torch.zeros(wdm.size + 8, dtype=torch.int8, device=card)
    view = base[offset:offset + wdm.size].view(wdm.shape)
    view.copy_(torch.from_numpy(wdm))
    assert view.is_contiguous() and view.data_ptr() % 4 == offset
    src, dly, ring = (torch.from_numpy(a).to(card) for a in (src, dly, ring))
    assert torch.equal(spike_wdm_project(view, src, dly, ring, 3),
                       spike_wdm_project_ref(view, src, dly, ring, 3))
    stacked = ring[:, 0, :965].contiguous()
    assert torch.equal(spike_wdm_matmul(view, stacked),
                       spike_wdm_matmul_ref(view, stacked))


@pytest.mark.cuda
def test_project_edges_and_refusals(card):
    wdm, src, dly, ring = (torch.from_numpy(a).to(card)
                           for a in project_operands(20, 965, 8, 4, 2048, seed=0))
    before = launch_counts()["spike_wdm_project"]
    empty = spike_wdm_project(wdm[:, :0].contiguous(), src[:0], dly[:0], ring, 3)
    assert empty.shape == (8, 20) and not empty.any()
    assert launch_counts()["spike_wdm_project"] == before
    with pytest.raises(TypeError, match="int32"):
        spike_wdm_project(wdm, src.long(), dly, ring, 3)
    with pytest.raises(TypeError, match="int8"):
        spike_wdm_project(wdm, src, dly, ring.float(), 3)
    with pytest.raises(ValueError, match="x_hist must be contiguous"):
        spike_wdm_project(wdm, src, dly, ring.transpose(0, 1), 3)
    with pytest.raises(ValueError, match="wdm must be contiguous"):
        spike_wdm_project(wdm.T.contiguous().T, src, dly, ring, 3)
    with pytest.raises(ValueError, match=r"\(K,\)"):
        spike_wdm_project(wdm, src[:5], dly, ring, 3)


@pytest.mark.cuda
def test_parallel_project_is_one_kernel_and_one_copy(card):
    """On the card a parallel edge's step is the fused K2 and the ring
    write, two device operations and no host wait."""
    from torch.profiler import ProfilerActivity, profile

    wdm, src, dly, ring = (torch.from_numpy(a).to(card)
                           for a in project_operands(20, 965, 8, 1, 2048, seed=1))
    x_t = (torch.rand((8, 2048), device=card) < 0.2).float()
    parallel_project(wdm, src, dly, ring, x_t, 4)            # warm up
    want = spike_wdm_project_ref(wdm, src, dly, ring, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, i_t = parallel_project(wdm, src, dly, ring, x_t, 5)
        torch.cuda.synchronize()
    device_ops = sum(e.count for e in prof.key_averages()
                     if e.self_cpu_time_total == 0 and e.self_device_time_total > 0)
    assert device_ops == 2
    assert torch.equal(i_t, want)
    assert torch.equal(ring[:, 0], x_t.to(torch.int8))
    assert sync_count(lambda: parallel_project(wdm, src, dly, ring, x_t, 6)) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["serial", "parallel", "ideal"])
def test_gesture_temporal_on_card_equals_cpu(card, policy):
    """run_temporal on the card (K4 for the fixed-point passes, K3 for the
    sparse whole-train projections) equals the port on the CPU bit for
    bit, with the same passes and residuals."""
    net = feedforward_network([2048, 20, 4], density=0.0316, delay_range=1,
                              seed=0)
    for layer in net.layers:
        layer.lif = LIFParams(alpha=0.5, v_th=64.0)
    report = SwitchingCompiler(policy).compile_network(net)
    rng = np.random.default_rng(0)
    x = (rng.random((75, 8, 2048)) < 0.2).astype(np.float32)
    valid = rng.integers(25, 76, 8).astype(np.int32)
    reset_launch_counts()
    exe = network_executable(net, report, device=card)
    got = exe.run(x, valid_steps=valid, temporal=True)
    assert bool(exe.last_check)
    counts = launch_counts()
    rec = report.temporal[(8, 75)]
    # one fused fixed-point launch per iterative population, whatever its
    # pass count, and no standalone scan
    assert counts["lif_fixed_point"] == list(rec.modes.values()).count("iterative") > 0
    assert counts["lif_parallel_scan"] == 0
    assert sum(rec.iterations.values()) > counts["lif_fixed_point"]
    forms = report.serial_forms[("temporal", 8)]
    assert counts["sparse_gather"] == forms.count("temporal_sparse")
    assert all(r == 0 for r in rec.residual.values())
    cpu = network_executable(net, report, device="cpu")
    want = cpu.run(x, valid_steps=valid, temporal=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert report.temporal[(8, 75)] == rec
    xs = torch.as_tensor(x, device=card)
    vs = torch.as_tensor(valid, device=card)
    assert sync_count(lambda: exe.run_temporal(xs, valid_steps=vs)) == \
        counts["lif_fixed_point"]
    for a, b in zip(got, cpu.run(x, valid_steps=valid)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["serial", "parallel", "ideal"])
def test_gesture_on_card_equals_cpu(card, policy):
    """The gesture net's micro-batch of 8 on the card, through all three
    kernels, equals the port on the CPU bit for bit."""
    net = feedforward_network([2048, 20, 4], density=0.0316, delay_range=1,
                              seed=0)
    for layer in net.layers:
        layer.lif = LIFParams(alpha=0.5, v_th=64.0)
    report = SwitchingCompiler(policy).compile_network(net)
    rng = np.random.default_rng(0)
    x = (rng.random((30, 8, 2048)) < 0.2).astype(np.float32)
    valid = rng.integers(1, 31, 8).astype(np.int32)
    reset_launch_counts()
    exe = network_executable(net, report, device=card)
    got = exe.run(x, valid_steps=valid)
    assert bool(exe.last_check)
    counts = launch_counts()
    # one population step a population and step, and no standalone update
    assert counts["lif_step"] == 30 * 2
    assert counts["lif_update"] == 0
    paradigms = [layer.paradigm for layer in report.layers]
    assert counts["spike_wdm_project"] == 30 * paradigms.count("parallel")
    assert counts["spike_wdm_matmul"] == 0
    assert counts["sparse_gather"] == 30 * paradigms.count("serial")
    cpu = network_executable(net, report, device="cpu").run(x, valid_steps=valid)
    for a, b in zip(got, cpu):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["serial", "parallel", "ideal"])
def test_gesture_batched_on_card_equals_run_device(card, policy):
    """``run_batched`` is the fused loop: on the card it gives run_device's
    bits, launches the same kernels and waits for the card nowhere."""
    net = feedforward_network([2048, 20, 4], density=0.0316, delay_range=1,
                              seed=0)
    for layer in net.layers:
        layer.lif = LIFParams(alpha=0.5, v_th=64.0)
    report = SwitchingCompiler(policy).compile_network(net)
    rng = np.random.default_rng(1)
    x = torch.as_tensor((rng.random((30, 8, 2048)) < 0.2).astype(np.float32),
                        device=card)
    valid = torch.as_tensor([30, 0, 7, 30, 1, 12, 29, 0], device=card,
                            dtype=torch.int32)
    exe = network_executable(net, report, device=card)
    counts = {}
    for path in ("run_device", "run_batched"):
        reset_launch_counts()
        outs = getattr(exe, path)(x, valid_steps=valid)
        assert bool(exe.last_check)
        counts[path] = (launch_counts(), [z.clone() for z in outs])
    assert counts["run_device"][0] == counts["run_batched"][0]
    for a, b in zip(counts["run_device"][1], counts["run_batched"][1]):
        assert torch.equal(a, b)
        assert not b[:, 1].any() and not b[:, 7].any()
    assert report.serial_forms[("vmap", 8)] == report.serial_forms[("fused", 8)]
    assert sync_count(lambda: exe.run_batched(x, valid_steps=valid)) == 0


def _engine_models():
    """Two models of the gesture net (ideal-switched and all-parallel),
    compiled afresh, so each device keeps its own executables."""
    net = feedforward_network([2048, 20, 4], density=0.0316, delay_range=1,
                              seed=0, name="gesture")
    for layer in net.layers:
        layer.lif = LIFParams(alpha=0.5, v_th=64.0)
    return net, {p: SwitchingCompiler(p).compile_network(net)
                 for p in ("ideal", "parallel")}


def _engine_run(device, reqs):
    from repro_torch.serving import ServingEngine

    net, reports = _engine_models()
    engine = ServingEngine(net, reports["ideal"], micro_batch=8,
                           min_bucket_steps=8, device=device)
    engine.warmup([5, 9, 17])             # buckets of 8, 16 and 32 steps
    engine.register_model(net, reports["parallel"], "parallel-all",
                          warm_steps=[5, 9, 17])
    replies = {}
    for i, (model, prio, x) in enumerate(reqs):
        engine.submit(x, model=model, priority=prio)
        if i % 5 == 4:
            replies.update(engine.step_continuous())
    replies.update(engine.drain())
    return engine, replies


@pytest.mark.cuda
def test_engine_on_card_equals_engine_on_cpu(card):
    """The serving engine on the card and on the CPU, same traffic: equal
    replies and counters, and a fault-free run records no fault."""
    rng = np.random.default_rng(2)
    reqs = []
    for _ in range(30):
        width = int(rng.choice([2048, 1536, 1024]))
        x = (rng.random((int(rng.integers(5, 33)), width)) < 0.2)
        reqs.append(("parallel-all" if rng.random() < 0.3 else "default",
                     int(rng.integers(0, 3)), x.astype(np.float32)))
    reset_launch_counts()
    gpu, on_card = _engine_run(card, reqs)
    counts = launch_counts()
    st = gpu.stats()             # before the CPU engine lowers its own
    cpu, on_cpu = _engine_run("cpu", reqs)
    assert on_card.keys() == on_cpu.keys() == set(range(len(reqs)))
    for rid in on_cpu:
        for a, b in zip(on_card[rid], on_cpu[rid]):
            np.testing.assert_array_equal(a, b)
    # the card captured each warmed shape and every launch replayed one;
    # the CPU captures nothing
    on_card_by, on_cpu_by = (
        e.pool.counters_by_model() for e in (gpu, cpu))
    for name, c in on_card_by.items():
        assert c.pop("graph_captures") == 3, name       # 8, 16 and 32 steps
        assert c.pop("graph_replays") == (
            c["batched_launches"] + c["fused_launches"]), name
        assert on_cpu_by[name].pop("graph_captures") == 0
        assert on_cpu_by[name].pop("graph_replays") == 0
    assert on_card_by == on_cpu_by
    assert st["relowerings"] == 0 and st["bucket_misses"] == 0
    assert st["failed"] == 0 and st["shed"] == 0
    by = st["by_model"]
    assert sum(c["batched_launches"] for c in by.values()) > 0
    assert sum(c["fused_launches"] for c in by.values()) > 0
    sup = st["supervisor"]
    for k in ("retries", "degraded_launches", "validation_failures",
              "quarantined", "watchdog_stalls", "bisections"):
        assert sup[k] == 0, k
    for k in ("lif_step", "spike_wdm_project", "sparse_gather"):
        assert counts[k] > 0, k


def _gesture(policy):
    net = feedforward_network([2048, 20, 4], density=0.0316, delay_range=1,
                              seed=0)
    for layer in net.layers:
        layer.lif = LIFParams(alpha=0.5, v_th=64.0)
    return net, SwitchingCompiler(policy).compile_network(net)


#: a micro-batch of 8 lanes of a 32-step graph: full, empty and cut lanes
GRAPH_VALID = [32, 0, 7, 32, 1, 12, 31, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["event", "sparse", "dense"])
@pytest.mark.parametrize("policy", ["serial", "parallel", "ideal"])
def test_replayed_launch_equals_eager_launch(card, policy, form):
    """A launch captured as a CUDA graph replays the eager launch's bits,
    kernel launches and flag, through run_device and run_batched alike
    (one graph for both), from host inputs; a later replay leaves the
    tensors an earlier one returned as they were."""
    from repro_torch.core.runtime import NetworkExecutable

    net, report = _gesture(policy)
    exe = network_executable(net, report, device=card)
    eager = NetworkExecutable.build(net, report, device=card)   # no graphs
    rng = np.random.default_rng(3)
    xs = [(rng.random((32, 8, 2048)) < 0.2).astype(np.float32) for _ in range(2)]
    vs = np.asarray(GRAPH_VALID, np.int32)
    assert exe.capture_graph(32, 8) == 0        # no launch of it has run
    reset_launch_counts()
    first = [z.clone() for z in exe.run_device(xs[0], valid_steps=vs,
                                               serial_form=form)]
    counts = launch_counts()
    assert exe.capture_graph(32, 8) == 1
    assert exe.capture_graph(32, 8) == 0        # captured once
    assert launch_counts() == counts        # the capture launched nothing
    got = {}
    for i, path in enumerate(("run_device", "run_batched")):
        reset_launch_counts()
        got[path] = getattr(exe, path)(xs[i], valid_steps=vs, serial_form=form)
        assert launch_counts() == counts
        assert exe.last_check.dtype == torch.bool and bool(exe.last_check)
        assert exe.graph_replays == i + 1
    assert len(exe._graphs) == 1 and eager.graph_replays == 0
    for i, path in enumerate(("run_device", "run_batched")):
        want = eager.run_device(xs[i], valid_steps=vs, serial_form=form)
        for a, b in zip(got[path], want):
            assert torch.equal(a, b)
            assert not a[:, 1].any() and not a[7:, 2].any()
    for a, b in zip(got["run_device"], first):
        assert torch.equal(a, b)
    assert report.serial_forms[("vmap", 8)] == report.serial_forms[("fused", 8)]
    cpu = NetworkExecutable.build(net, report, device="cpu").run_device(
        xs[1], valid_steps=vs, serial_form=form)
    for a, b in zip(got["run_batched"], cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False])
def test_a_replay_waits_for_the_card_nowhere(card, masked):
    """A replay from device inputs makes the host wait nowhere; the scan
    span says what each launch did, and counts the replay's kernels."""
    from repro_torch import trace

    net, report = _gesture("ideal")
    exe = network_executable(net, report, device=card)
    rng = np.random.default_rng(4)
    x = torch.as_tensor((rng.random((32, 8, 2048)) < 0.2).astype(np.float32),
                        device=card)
    vs = torch.as_tensor(GRAPH_VALID, dtype=torch.int32,
                         device=card) if masked else None
    was = trace.enabled()
    trace.enable()
    trace.clear()
    try:
        want = [z.clone() for z in exe.run_batched(x, valid_steps=vs)]
        assert exe.capture_graph(32, 8) == 1
        assert sync_count(lambda: exe.run_batched(x, valid_steps=vs)) == 0
        got = exe.run_device(x, valid_steps=vs)
        scans = [r for r in trace.records() if r.name == "executor.scan"]
    finally:
        trace.clear()
        if not was:
            trace.disable()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert exe.graph_replays == 2
    assert [r.attrs["graph"] for r in scans] == ["eager", "capture", "replay",
                                                 "replay"]
    # the capture and each replay count the eager loop's kernel launches
    n = {r.counts["kernel_launches"] for r in scans}
    assert len(n) == 1 and n.pop() > 0


@pytest.mark.cuda
def test_the_pool_drops_graphs_on_eviction_and_recaptures_on_revival(card):
    """The pool's warm-up captures the shape; an eviction drops the graphs
    of the evicted executable, and the revived model's first launch (a
    miss) runs eagerly and is captured, so the next one replays."""
    from repro_torch.serving import (
        BucketKey, ExecutablePool, SNNRequest, pad_microbatch,
    )

    net, reports = _engine_models()
    pool = ExecutablePool(device=card, max_models=1)
    pool.register(net, reports["ideal"], "a")
    key = BucketKey(steps=16, n_in=2048, batch=8)
    pool.warmup([key], name="a")
    exe = pool.peek("a").report.executable
    assert len(exe._graphs) == 1
    rng = np.random.default_rng(6)
    reqs = [SNNRequest(i, (rng.random((int(s), 2048)) < 0.2).astype(np.float32),
                       0.0, model="a") for i, s in enumerate([16, 9, 3, 16, 12])]
    mb = pad_microbatch(key, reqs, "a")
    want = [z.cpu() for z in pool.run_microbatch(mb)]
    assert pool.counters_by_model()["a"]["graph_replays"] == 1
    pool.register(net, reports["parallel"], "b")      # evicts "a"
    assert exe._graphs == {} and pool.peek("a").report.executable is None
    pool.warmup([key], name="b")
    for replays in (0, 1):
        got = pool.run_microbatch(mb)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
        c = pool.counters_by_model()["a"]
        assert (c["graph_captures"], c["graph_replays"]) == (2, 1 + replays)
        assert c["bucket_misses"] == 1
    revived = pool.peek("a").report.executable
    assert revived is not exe and len(revived._graphs) == 1
    assert pool.counters_by_model()["b"]["graph_captures"] == 1


@pytest.mark.cuda
def test_a_capture_survives_a_dead_graph_in_the_heap(card):
    """No collection runs inside a capture: one that freed a dead
    executable's graph there (a destruction a capturing thread may not
    call) would void the capture."""
    import gc
    import weakref

    from repro_torch.core.runtime import NetworkExecutable

    net, report = _gesture("ideal")
    rng = np.random.default_rng(8)
    x = (rng.random((16, 8, 2048)) < 0.2).astype(np.float32)
    vs = np.asarray(GRAPH_VALID, np.int32).clip(max=16)

    def captured():
        exe = NetworkExecutable.build(net, report, device=card)
        exe.run_device(x, valid_steps=vs)
        assert exe.capture_graph(16, 8) == 1
        exe.cycle = exe               # only the collector can free it
        return weakref.ref(exe)

    dead = captured()
    live = NetworkExecutable.build(net, report, device=card)
    want = [z.clone() for z in live.run_device(x, valid_steps=vs)]
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)        # collect at every chance
    try:
        assert dead() is not None
        assert live.capture_graph(16, 8) == 1
    finally:
        gc.set_threshold(*threshold)
    gc.collect()
    assert dead() is None
    for a, b in zip(live.run_device(x, valid_steps=vs), want):
        assert torch.equal(a, b)
    assert live.graph_replays == 1


@pytest.mark.cuda
def test_a_placed_executable_never_captures(card, tmp_path):
    """Under ``shard(mesh=)`` (a world of one rank with a mesh given) the
    executable keeps to the eager loop and captures nothing; placing it
    drops the graphs it had, and placing it back whole needs an eager
    launch again before a capture."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as shardlib

    net, report = _gesture("ideal")
    exe = network_executable(net, report, device=card)
    rng = np.random.default_rng(7)
    x = (rng.random((16, 8, 2048)) < 0.2).astype(np.float32)
    vs = np.asarray(GRAPH_VALID, np.int32).clip(max=16)
    want = [z.clone() for z in exe.run_device(x, valid_steps=vs)]
    assert exe.capture_graph(16, 8) == 1
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1),
                            rank=0, world_size=1)
    try:
        exe.shard(mesh=shardlib._device_mesh([0], (1, 1), ("data", "model")))
        assert exe._graphs == {}
        got = exe.run_device(x, valid_steps=vs)
        assert exe.capture_graph(16, 8) == 0
        assert exe.run_batched(x, valid_steps=vs) is not None
        assert exe._graphs == {} and exe.graph_replays == 0
        exe.shard(mesh=None)                      # whole again
        assert exe.capture_graph(16, 8) == 0
        exe.run_device(x, valid_steps=vs)
        assert exe.capture_graph(16, 8) == 1
    finally:
        dist.destroy_process_group()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


#: (G, Q, H, P, N): the reference's four TestSSDChunk shapes (G = 1), the
#: batched path shape of a mamba2-130m prefill at batch 4 x 1024 tokens,
#: and ragged edges (Q not a multiple of 64, P and N above one tile).
SSD_SHAPES = [(1, 256, 24, 64, 128), (1, 64, 3, 16, 32), (1, 16, 1, 8, 8),
              (1, 128, 5, 32, 64), (16, 256, 24, 64, 128), (3, 100, 2, 80, 130)]


def ssd_operands(g, q, h, p, n, seed, decay="test", groups=None):
    """TestSSDChunk's draws; ``decay="mamba2"`` gives a mamba2 layer's log
    decays (dt ~ 0.69 times A in [-16, -1]) instead of -|N(0, 0.1)|;
    ``groups`` draws B and C once per group (default: per head)."""
    rng = np.random.default_rng(seed)
    hg = h if groups is None else groups
    x = rng.normal(size=(g, q, h, p)).astype(np.float32)
    b = rng.normal(size=(g, q, hg, n)).astype(np.float32)
    c = rng.normal(size=(g, q, hg, n)).astype(np.float32)
    if decay == "test":
        la = -np.abs(rng.normal(size=(g, q, h)) * 0.1)
    else:
        la = -0.69 * np.linspace(1.0, 16.0, h) * rng.uniform(0.8, 1.2, (g, q, h))
    return x, b, c, la.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("decay", ["test", "mamba2"])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_kernel_on_card(card, shape, decay):
    """K5 against its plain version on the card at the reference's
    tolerance, rtol = atol = 1e-4 (the plain version in full f32)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    ops = [torch.from_numpy(a).to(card) for a in ssd_operands(*shape, seed=7, decay=decay)]
    if shape[0] == 1:                       # the reference's own layout
        ops = [a[0] for a in ops]
    before = launch_counts()["ssd_chunk"]
    y, s = ssd_chunk(*ops)
    torch.cuda.synchronize()
    assert launch_counts()["ssd_chunk"] == before + 1
    yr, sr = ssd_chunk_ref(*ops)
    assert y.shape == yr.shape and s.shape == sr.shape
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, sr, rtol=1e-4, atol=1e-4)


#: (G, Q, H, P, N, Hg): mamba2-130m's prefill (one group for 24 heads) at
#: batch 4 x 1024 tokens and at one chunk, and ragged shapes with groups
SSD_GROUPED = [(16, 256, 24, 64, 128, 1), (1, 256, 24, 64, 128, 1),
               (3, 100, 6, 80, 130, 2), (2, 64, 4, 16, 32, 2), (1, 16, 3, 8, 8, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("decay", ["test", "mamba2"])
@pytest.mark.parametrize("shape", SSD_GROUPED)
def test_ssd_kernel_grouped_on_card(card, shape, decay):
    """K5 with B and C shared by groups of heads against its plain version
    (rtol = atol = 1e-4), and against the per-head call on the same B and C
    repeated for every head."""
    *dims, hg = shape
    ops = [torch.from_numpy(a).to(card)
           for a in ssd_operands(*dims, seed=9, decay=decay, groups=hg)]
    before = launch_counts()["ssd_chunk"]
    y, s = ssd_chunk(*ops)
    torch.cuda.synchronize()
    assert launch_counts()["ssd_chunk"] == before + 1
    yr, sr = ssd_chunk_ref(*ops)
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, sr, rtol=1e-4, atol=1e-4)
    x, b, c, la = ops
    per_head = [t.repeat_interleave(dims[2] // hg, dim=2) for t in (b, c)]
    yh, sh = ssd_chunk(x, *per_head, la)
    torch.testing.assert_close(yh, yr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(sh, sr, rtol=1e-4, atol=1e-4)


def card_close(got, want, what):
    """|got - want| <= 1e-4 |want| + 1e-4 max|want| (f32 sums in other
    orders on each side), as chip_smoke.py's ``lm_close``."""
    got, want = got.double().cpu(), want.double().cpu()
    diff = (got - want).abs()
    assert torch.isfinite(got).all(), what
    assert bool((diff <= 1e-4 * want.abs() + 1e-4 * want.abs().max()).all()), (
        what, float(diff.max()), float(want.abs().max()))


#: (G, Q, H, P, N, Hg): mamba2-130m's train step at batch 8 x 1024 (32
#: chunks, one group), its smoke config at batch 2 x 40, two groups
SSD_GRAD = [(32, 256, 24, 64, 128, 1), (6, 16, 8, 16, 16, 1), (3, 64, 6, 16, 32, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_GRAD)
def test_ssd_gradient_on_card(card, shape):
    """SSDChunk on the card (the kernel forward, the plain backward)
    against autograd through the plain version on the same inputs and
    cotangents; one launch for the forward, none in the backward."""
    *dims, hg = shape
    ops = [torch.from_numpy(a).to(card).requires_grad_()
           for a in ssd_operands(*dims, seed=11, decay="mamba2", groups=hg)]
    before = launch_counts()["ssd_chunk"]
    y, s = ssd_chunk(*ops)
    assert type(y.grad_fn) is SSDChunk._backward_cls
    rng = np.random.default_rng(12)
    gy, gs = (torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)).to(card)
              for t in (y, s))
    got = torch.autograd.grad([y, s], ops, [gy, gs])
    torch.cuda.synchronize()
    assert launch_counts()["ssd_chunk"] == before + 1
    ref = [t.detach().clone().requires_grad_() for t in ops]
    want = torch.autograd.grad(list(ssd_chunk_ref(*ref)), ref, [gy, gs])
    for name, a, b in zip(("x", "b", "c", "la"), got, want):
        card_close(a, b, name)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-130m", "llama3.2-3b", "olmoe-1b-7b"])
def test_smoke_train_step_on_card_equals_cpu(card, arch):
    """One train step of the smoke config in f32 on the card against the
    same step on the CPU, same weights and batch: the loss, grad norm and
    every gradient within ``card_close``; then one AdamW update of the
    card's gradients, on the card and on a CPU copy."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import init as minit, model as M
    from repro_torch.optim import AdamWConfig, apply_updates, init_state
    from repro_torch.tree import leaves

    cfg = smoke_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    host = minit.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=40, global_batch=2)).batch_at(0)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    before = launch_counts()["ssd_chunk"]
    loss, grads = M.value_and_grad(minit.tree_to(host, card), cfg, batch)
    torch.cuda.synchronize()
    k5 = cfg.n_layers if "mamba2" in cfg.block_pattern else 0
    assert launch_counts()["ssd_chunk"] == before + k5
    c_loss, c_grads = M.value_and_grad(host, cfg, batch)
    card_close(loss, c_loss, "loss")
    for a, b in zip(leaves(grads), leaves(c_grads)):
        card_close(a, b, "gradient")
    opt = AdamWConfig(warmup_steps=1, total_steps=3)
    on_card = apply_updates(minit.tree_to(host, card), grads,
                            init_state(minit.tree_to(host, card)), opt)
    on_cpu = apply_updates(host, minit.tree_to(grads, "cpu"), init_state(host), opt)
    card_close(on_card[2]["grad_norm"], on_cpu[2]["grad_norm"], "grad_norm")
    for a, b in zip(leaves(on_card[:2]), leaves(on_cpu[:2])):
        card_close(a, b, "update")


@pytest.mark.cuda
def test_ssd_wrapper_edges_and_refusals(card):
    before = launch_counts()["ssd_chunk"]
    for g, q, h, p, n in ((0, 4, 2, 3, 5), (2, 0, 2, 3, 5), (2, 4, 2, 3, 0)):
        y, s = ssd_chunk(torch.ones((g, q, h, p), device=card),
                         torch.ones((g, q, h, n), device=card),
                         torch.ones((g, q, h, n), device=card),
                         torch.ones((g, q, h), device=card))
        assert y.shape == (g, q, h, p) and s.shape == (g, h, n, p)
        assert not y.any() and not s.any()
    assert launch_counts()["ssd_chunk"] == before
    x, b, c, la = (torch.from_numpy(a[0]).to(card)
                   for a in ssd_operands(1, 16, 2, 8, 8, seed=1))
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_chunk(x, b.cpu(), c, la)
    with pytest.raises(TypeError, match="float32"):
        ssd_chunk(x.double(), b, c, la)
    with pytest.raises(TypeError, match="float32"):
        ssd_chunk(x, b.bfloat16(), c, la)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunk(x, b.transpose(0, 1).contiguous().transpose(0, 1), c, la)
    with pytest.raises(ValueError, match="b and c"):
        ssd_chunk(x, b[..., :4].contiguous(), c, la)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunk(x, b, c.transpose(0, 1).contiguous().transpose(0, 1), la)
    x3, b3, c3, la3 = (torch.from_numpy(a[0]).to(card)
                       for a in ssd_operands(1, 16, 3, 8, 8, seed=1, groups=2))
    with pytest.raises(ValueError, match="multiple"):
        ssd_chunk(x3, b3, c3, la3)
    assert launch_counts()["ssd_chunk"] == before


@pytest.mark.cuda
def test_mamba2_smoke_on_card_equals_cpu(card):
    """The smoke mamba2 model in f32 on the card (K5 once per layer in the
    prefill, none in decode) against the port on the CPU."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import init as minit, model as lm

    cfg = smoke_config("mamba2-130m")
    cpu = minit.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = minit.tree_to(cpu, card)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 40)))
    reset_launch_counts()
    got, gc = lm.prefill(gpu, cfg, {"tokens": toks}, 48)
    torch.cuda.synchronize()
    assert launch_counts()["ssd_chunk"] == cfg.n_layers
    want, wc = lm.prefill(cpu, cfg, {"tokens": toks}, 48)
    for step in range(3):
        # rtol 1e-4 and an atol of 1e-4 of each tensor's scale: the CPU's
        # cumsum accumulates in double, the card's in f32, and the SSD
        # state (values near 1e-4) inherits that rounding
        for a, b in [(got, want)] + [(gc[0][0][k], wc[0][0][k]) for k in ("conv", "ssd")]:
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4,
                                       atol=1e-4 * float(b.abs().max()))
        tok = want[:, -1].argmax(-1)[:, None]
        assert torch.equal(got[:, -1].argmax(-1).cpu(), tok[:, 0])
        reset_launch_counts()
        got, gc = lm.decode_step(gpu, cfg, tok.to(card), 40 + step, gc, 48)
        assert launch_counts()["ssd_chunk"] == 0
        want, wc = lm.decode_step(cpu, cfg, tok, 40 + step, wc, 48)


ARCHS = ("mamba2-130m", "musicgen-large", "kimi-k2-1t-a32b", "olmoe-1b-7b",
         "phi3-medium-14b", "llama3.2-3b", "qwen1.5-4b", "qwen3-8b",
         "recurrentgemma-2b", "phi-3-vision-4.2b")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_smoke_on_card_equals_cpu(card, arch):
    """Each arch's smoke model in f32 (MoE capacity 8.0) on the card
    against the port on the CPU, same weights: b 2, s 12, cache 16, then
    three greedy decode steps; logits and every cache within rtol 1e-4 and
    an atol of 1e-4 of each tensor's scale, greedy tokens equal."""
    import dataclasses

    from repro_torch.configs import ARCH_NAMES, smoke_config
    from repro_torch.models import init as minit, model as lm

    assert ARCHS == ARCH_NAMES
    cfg = smoke_config(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    cpu = minit.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gpu = minit.tree_to(cpu, card)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)))}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = torch.from_numpy(rng.normal(
            size=(2, cfg.n_frontend_tokens, cfg.d_model)) * 0.02).float()
    if cfg.frontend == "audio":
        batch = {"embeds": torch.from_numpy(rng.normal(
            size=(2, 12, cfg.d_model)) * 0.02).float()}
    got, gc = lm.prefill(gpu, cfg, batch, 16)
    want, wc = lm.prefill(cpu, cfg, batch, 16)
    pos = 12 + cfg.n_frontend_tokens
    for step in range(4):
        pairs = [(got, want)] + [
            (g[name], w[name]) for gg, ww in zip(gc, wc) for g, w in zip(gg, ww)
            for name in w]
        for a, b in pairs:
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4,
                                       atol=1e-4 * float(b.abs().max()))
        tok = want[:, -1].argmax(-1)[:, None]
        assert torch.equal(got[:, -1].argmax(-1).cpu(), tok[:, 0])
        if step == 3:
            break
        got, gc = lm.decode_step(gpu, cfg, tok.to(card), pos + step, gc, 16)
        want, wc = lm.decode_step(cpu, cfg, tok, pos + step, wc, 16)


#: In-edge kinds of the population step: a parallel edge's current, and a
#: serial edge's ring with its form's update layout (K3's (d*N, B) output
#: viewed (d, B, N); the dense einsum's contiguous (d, B, N); the event
#: form's (B, d, N) scatter viewed (d, B, N), landing unshifted).
EDGE_KINDS = ("current", "sparse", "dense", "event")


def lif_step_operands(kinds, batch, n, d_slots, seed, alpha=0.5):
    """NumPy operands of one population step: per edge ``(kind, current)``
    or ``(kind, ring, update)`` with int8-magnitude integer values (as the
    path's currents are), a real-valued membrane ``v`` near the threshold
    and int8 spikes ``z``.  The updates are in their form's own layout."""
    rng = np.random.default_rng(seed)
    v_th = 64.0 if alpha == 0.5 else 1.0
    scale = 40 if alpha == 0.5 else 1
    edges = []
    for kind in kinds:
        ints = lambda shape: (rng.integers(-3, 4, shape) * scale).astype(np.float32)
        if kind == "current":
            edges.append((kind, ints((batch, n))))
            continue
        ring = ints((d_slots, batch, n))
        upd = {"sparse": (d_slots * n, batch), "dense": (d_slots, batch, n),
               "event": (batch, d_slots, n)}[kind]
        edges.append((kind, ring, ints(upd)))
    v = (rng.normal(size=(batch, n)) * v_th).astype(np.float32)
    z = rng.integers(0, 2, (batch, n)).astype(np.int8)
    return edges, v, z, v_th


def lif_step_tensors(operands, t, device):
    """Torch edges (updates as the strided views the executor hands over)
    and carry from :func:`lif_step_operands`, on ``device``."""
    edges_np, v, z, _ = operands
    edges = []
    for kind, *arrays in edges_np:
        ts = [torch.from_numpy(a.copy()).to(device) for a in arrays]
        if kind == "current":
            edges.append(CurrentEdge(ts[0]))
            continue
        ring, upd = ts
        d_slots, batch, n = ring.shape
        if kind == "sparse":
            upd = upd.view(d_slots, n, batch).permute(0, 2, 1)
        elif kind == "event":
            upd = upd.transpose(0, 1)
        edges.append(RingEdge(ring, upd, 0 if kind == "event" else t))
    v, z = (torch.from_numpy(a.copy()).to(device) for a in (v, z))
    out = torch.full(v.shape, -1.0, device=device)
    return edges, v, z, out


def assert_steps_equal(a, b):
    """Two population steps' outputs, carries and rings bitwise equal."""
    (ea, va, za, oa), (eb, vb, zb, ob) = a, b
    assert torch.equal(va.view(torch.int32).cpu(), vb.view(torch.int32).cpu())
    assert torch.equal(za.cpu(), zb.cpu()) and torch.equal(oa.cpu(), ob.cpu())
    for x, y in zip(ea, eb):
        if isinstance(x, RingEdge):
            assert torch.equal(x.ring.view(torch.int32).cpu(),
                               y.ring.view(torch.int32).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("d_slots", [3, 20])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("alpha", [0.5, 0.9])
@pytest.mark.parametrize("kinds", [(k,) for k in EDGE_KINDS] + [
    ("current", "sparse", "event"), ("dense", "current", "sparse"),
    ("sparse", "event", "dense", "current", "sparse", "current", "event", "dense"),
    ("sparse",) * 9,
    ("event", "current", "dense", "sparse") * 4 + ("current",),
])
def test_lif_step_kernel_on_card(card, kinds, alpha, batch, d_slots):
    """One launch up to eight in-edges (two for 9, three for 17), bitwise
    equal to the plain version on v, z, the spike row and every ring, for
    every edge kind, at t before and past the ring depth (the sparse and
    dense updates land t slots on), with the ring in registers (3 slots)
    and slot by slot (20)."""
    n_launches = 1 + -(-max(0, len(kinds) - MAX_EDGES) // (MAX_EDGES - 1))
    for t in (0, 2 * d_slots + 1):
        ops = lif_step_operands(kinds, batch, 20, d_slots, seed=t + len(kinds),
                                alpha=alpha)
        got = lif_step_tensors(ops, t, card)
        want = lif_step_tensors(ops, t, card)
        before = launch_counts()["lif_step"]
        out = lif_step(*got, t, alpha=alpha, v_th=ops[3])
        assert launch_counts()["lif_step"] == before + n_launches
        assert out is got[3]
        lif_step_ref(*want, t, alpha=alpha, v_th=ops[3])
        torch.cuda.synchronize()
        assert_steps_equal(got, want)
        assert 0 < float(got[3].mean()) < 1


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 64])
def test_lif_step_kernel_at_scaffold_width(card, batch):
    """80,000 neurons and 3 in-edges (the cerebellum's Purkinje in-degree):
    bitwise against the plain version, the sparse update read strided."""
    kinds = ("current", "sparse", "event")
    ops = lif_step_operands(kinds, batch, 80_000, 2, seed=batch)
    got, want = (lif_step_tensors(ops, 5, card) for _ in range(2))
    lif_step(*got, 5, alpha=0.5, v_th=ops[3])
    lif_step_ref(*want, 5, alpha=0.5, v_th=ops[3])
    torch.cuda.synchronize()
    assert_steps_equal(got, want)


@pytest.mark.cuda
def test_lif_step_edges_and_refusals(card):
    ops = lif_step_operands(("current", "sparse"), 4, 6, 2, seed=0)
    edges, v, z, out = lif_step_tensors(ops, 1, card)
    before = launch_counts()["lif_step"]
    # a population with no in-edge fires on a zero current
    want = lif_step_tensors(ops, 1, card)
    lif_step([], v, z, out, 1, alpha=0.5, v_th=64.0)
    lif_step_ref([], *want[1:], 1, alpha=0.5, v_th=64.0)
    assert_steps_equal(([], v, z, out), ([], *want[1:]))
    empty = torch.empty((0, 6), device=card)
    lif_step([], empty, empty.to(torch.int8), empty, 0, alpha=0.5, v_th=64.0)
    assert launch_counts()["lif_step"] == before + 1
    # past eight in-edges the launches chain, and a bad edge in a later
    # launch refuses before the first one runs
    many = [edges[0]] * (MAX_EDGES + 1)
    lif_step(many, v, z, out, 1, alpha=0.5, v_th=64.0)
    lif_step_ref(many, *want[1:], 1, alpha=0.5, v_th=64.0)
    assert_steps_equal(([], v, z, out), ([], *want[1:]))
    assert launch_counts()["lif_step"] == before + 3
    with pytest.raises(ValueError, match="shape"):
        lif_step(many + [CurrentEdge(v[:2])], v, z, out, 1, alpha=0.5, v_th=1.0)
    assert launch_counts()["lif_step"] == before + 3
    with pytest.raises(TypeError, match="int8 z"):
        lif_step(edges, v, z.float(), out, 1, alpha=0.5, v_th=1.0)
    with pytest.raises(ValueError, match="ring must be contiguous"):
        ring = edges[1].ring.transpose(1, 2).contiguous().transpose(1, 2)
        lif_step([RingEdge(ring, edges[1].upd, 1)], v, z, out, 1,
                 alpha=0.5, v_th=1.0)
    with pytest.raises(ValueError, match="shape"):
        lif_step([CurrentEdge(v[:2])], v, z, out, 1, alpha=0.5, v_th=1.0)
    with pytest.raises(ValueError, match="one CUDA device"):
        lif_step([CurrentEdge(v.cpu())], v, z, out, 1, alpha=0.5, v_th=1.0)
    # no host wait: the step can be captured in a CUDA graph
    assert sync_count(lambda: lif_step(edges, v, z, out, 2, alpha=0.5,
                                       v_th=64.0)) == 0


def long_train(steps, feat, seed):
    """A (T, F) current train whose fixed point settles in a few passes:
    integer currents far below the threshold of 64, with rare pulses that
    fire once or twice (at alpha 0.9) whatever came before."""
    rng = np.random.default_rng(seed)
    c = rng.integers(-12, 1, (steps, feat)).astype(np.float32)
    pulse = rng.random((steps, feat)) < 0.002
    return np.where(pulse, np.float32(100.0), c)


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [0.5, 0.9])
@pytest.mark.parametrize("cap", ["2", "T+1"])
@pytest.mark.parametrize("feat", [32, 40])
def test_fixed_point_spike_words_in_device_memory(card, feat, cap, alpha):
    """T = 60,000, past the spike words' shared-memory limit: the third
    branch keeps them in device memory and equals the plain version (run
    on a CPU copy) in spikes, passes and residual."""
    steps = 60_000
    assert steps > shared_words_limit(card)
    host = torch.from_numpy(long_train(steps, feat, seed=feat))
    cap = 2 if cap == "2" else steps + 1
    before = launch_counts()["lif_fixed_point"]
    z, iters, residual = lif_fixed_point(host.to(card), alpha=alpha, v_th=64.0,
                                         cap=cap)
    assert launch_counts()["lif_fixed_point"] == before + 1
    zr, iters_r, residual_r = lif_fixed_point_ref(host, alpha=alpha, v_th=64.0,
                                                  cap=cap)
    assert iters_r <= 4
    assert torch.equal(z.cpu(), zr) and (iters, residual) == (iters_r, residual_r)
    assert 0 < float(zr.mean()) < 1


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [65_536, 70_000])
def test_wdm_kernels_past_65535_lanes(card, batch):
    """The batch is no longer a grid dimension's size: both WDM entry points
    are exact past 65,535 lanes."""
    a, x = wdm_operands(5, 40, batch, seed=batch)
    a, xt = torch.from_numpy(a).to(card), torch.from_numpy(x.T.copy()).to(card)
    assert torch.equal(spike_wdm_matmul(a, xt), spike_wdm_matmul_ref(a, xt))
    ops = [torch.from_numpy(o).to(card)
           for o in project_operands(5, 40, batch, 2, 30, seed=batch)]
    for t in (0, 3):
        out = spike_wdm_project(*ops, t)
        assert out.shape == (batch, 5)
        assert torch.equal(out, spike_wdm_project_ref(*ops, t))


# -- the cerebellum scaffold ----------------------------------------------------
_SCAFFOLD = {}


def _scaffold(device):
    """The 1.2k cerebellum of ``tests/test_scaffold_equivalence.py``, compiled
    afresh for each device so each keeps its own executables."""
    key = str(device)
    if key not in _SCAFFOLD:
        from repro_torch.scaffold import build_cerebellum, compile_scaffold

        sc = build_cerebellum(1200, seed=90)
        report = compile_scaffold(sc)
        _SCAFFOLD[key] = (sc, report,
                          network_executable(sc.network, report, device=device))
    return _SCAFFOLD[key]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["solo", "fused", "vmap", "sharded", "temporal"])
def test_scaffold_on_card_equals_cpu(card, path):
    """Two inputs, CSR projections and the recurrent Golgi loop on every
    path: the card equals the port on the CPU bit for bit, the temporal
    path with the same passes and residuals."""
    sc, report, exe = _scaffold(card)
    _, cpu_report, cpu = _scaffold("cpu")
    x = sc.stimulus(10, 3, seed=91)
    valid = np.asarray([10, 6, 0], np.int32)
    if path == "solo":
        runs = [(exe.run(x[:, b:b + 1]), cpu.run(x[:, b:b + 1]))
                for b in range(3)]
    else:
        if path == "sharded":
            exe.shard()
        kw = dict(valid_steps=valid, batched=path == "vmap",
                  temporal=path == "temporal")
        runs = [(exe.run(x, **kw), cpu.run(x, **kw))]
    for got, want in runs:
        assert len(got) == len(want) == 8
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    if path == "temporal":
        assert report.temporal[(3, 10)] == cpu_report.temporal[(3, 10)]
        assert report.temporal[(3, 10)].split == (0, 2, 2)
    assert sum(float(z.sum()) for z in runs[0][0]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,depth,n_source", [(800, 8000, 4, 8000),
                                                (2000, 6489, 3, 6500)])
def test_wdm_kernels_at_scaffold_widths(card, m, k, depth, n_source):
    """K2 at the cerebellum's parallel edges (granule->basket_stellate at
    10k, mossy->golgi at 100k), batch 8: exact against the plain versions."""
    ops = [torch.from_numpy(o).to(card)
           for o in project_operands(m, k, 8, depth, n_source, seed=m)]
    for t in (0, depth + 1):
        assert torch.equal(spike_wdm_project(*ops, t),
                           spike_wdm_project_ref(*ops, t))
    a, x = wdm_operands(m, k, 8, seed=k)
    a, xt = torch.from_numpy(a).to(card), torch.from_numpy(x.T.copy()).to(card)
    assert torch.equal(spike_wdm_matmul(a, xt), spike_wdm_matmul_ref(a, xt))


@pytest.mark.cuda
@pytest.mark.parametrize("r,lanes", [(240_000, 11), (32_000, 62)])
@pytest.mark.parametrize("cols", [8, 512])
def test_gather_kernel_at_scaffold_widths(card, r, lanes, cols):
    """K3 at the 100k cerebellum's ELL shapes over an 80,000-neuron source:
    a micro-batch of 8 read through the transposed view, and the temporal
    path's 64 x 8 columns; exact against the plain version."""
    val, idx, x = ell_operands(r, lanes, 80_000, cols, seed=r + cols)
    val, idx = torch.from_numpy(val).to(card), torch.from_numpy(idx).to(card)
    x = torch.from_numpy(x).to(card)
    if cols == 8:
        x = x.t().contiguous().t()           # the fused step's (B, S) view
    assert torch.equal(sparse_gather(val, idx, x), sparse_gather_ref(val, idx, x))


@pytest.mark.cuda
def test_microcircuit_served_by_graph_replay_equals_the_plain_reference(card):
    """The Potjans-Diesmann microcircuit at scale 0.05 (3,859 neurons,
    1.1 M synapses, eight recurrent populations) compiled by the
    benchmark's classifier tenant and served through the engine on the card
    at micro-batch 1: the 32- and 64-step buckets captured as CUDA graphs
    and every launch replayed; each reply bit for bit the benchmark's plain
    reference (``snnbench/reference``) on the same input."""
    import json
    import sys
    from pathlib import Path

    from repro_torch.serving import ServingEngine

    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from snnbench import system
    from snnbench.configs import microcircuit
    from snnbench.reference import Simulator

    cfg = json.loads((root / "snnbench/configs/microcircuit-pd14.json").read_text())
    cfg["scale"] = 0.05
    graph = microcircuit.generate(cfg)
    net = system.port_network(graph)
    reports, _ = system.compile_tenants(cfg, net)
    assert reports["default"].cap_fallbacks == 0       # nothing over the cap here
    engine = ServingEngine(net, reports["default"], micro_batch=1,
                           min_bucket_steps=8, device=card)
    engine.warmup(list(range(32, 65)))
    rng = np.random.default_rng(28)
    sim = Simulator(graph, device=card)
    posts = Simulator.posts(graph)
    fired = 0
    for steps in (32, 33, 47, 64, 40, 64):
        x = (rng.random((steps, sim.n_input)) < cfg["ext_rate"]).astype(np.float32)
        rid = engine.submit(x)
        reply = {}
        while rid not in reply:
            reply.update(engine.step_continuous())
        want = [t.cpu().numpy() for t in sim.run(torch.as_tensor(x[:, None, :]).to(card))]
        for j, z in enumerate(reply[rid]):
            np.testing.assert_array_equal(np.asarray(z), want[posts[j]][:, 0])
            fired += int(np.asarray(z).sum())
    assert fired > 0
    c = engine.pool.counters_by_model()["default"]
    assert c["graph_captures"] == 2
    assert c["graph_replays"] == c["batched_launches"] + c["fused_launches"] == 6
    st = engine.stats()
    assert st["relowerings"] == 0 and st["bucket_misses"] == 0 and st["failed"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "batch,n_source,n_target,n_rows,delay_range,fired,silent", EVENT_CASES)
def test_event_kernel_on_card(card, batch, n_source, n_target, n_rows, delay_range,
                              fired, silent):
    """The event-driven scatter walks only the fired sources' rows and
    equals the plain sweep bitwise, on the card and on the CPU, at every t
    across the ring's wrap: B 1 and 3, delays 1-4, no source or every
    source fired, sources with no rows."""
    rows = [a.to(card) for a in event_projection(n_source, n_target, n_rows,
                                                 delay_range, seed=n_rows, silent=silent)]
    cpu = [a.cpu() for a in rows]
    row_ptr = source_major_index(*rows, n_source=n_source)
    x = event_spikes(batch, n_source, fired, seed=batch).to(card)
    d_slots = delay_range + 1
    for t in range(2 * d_slots + 1):
        got = event_scatter(*rows, row_ptr, x, t, d_slots=d_slots, n_target=n_target)
        want = event_scatter_ref(*cpu, x.cpu(), t, d_slots=d_slots, n_target=n_target)
        assert torch.equal(got.cpu(), want)
        assert torch.equal(got, event_scatter_ref(*rows, x, t, d_slots=d_slots,
                                                  n_target=n_target))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3])
def test_event_kernel_reads_a_strided_column_slice(card, batch):
    """An input edge's spikes go in as a column slice of the step's train,
    read through its strides."""
    rows = [a.to(card) for a in event_projection(60, 25, 700, 4, seed=5)]
    row_ptr = source_major_index(*rows, n_source=60)
    train = event_spikes(batch, 200, 0.3, seed=6).to(card)
    x = train[:, 70:130]
    for t in (0, 3, 9):
        assert torch.equal(
            event_scatter(*rows, row_ptr, x, t, d_slots=5, n_target=25),
            event_scatter_ref(*rows, x.contiguous(), t, d_slots=5, n_target=25))


@pytest.mark.cuda
@pytest.mark.parametrize("n_slabs", [2, 3])
def test_event_kernel_over_row_slabs_sums_to_the_sweep(card, n_slabs):
    """A rank's slab of rows, indexed alone over all the sources, gives the
    kernel a partial update; the slabs' partials sum to the whole rows'
    sweep bitwise, as the launch's all-reduce sums them."""
    rows = [a.to(card) for a in event_projection(50, 20, 800, 3, seed=11,
                                                 silent=(3, 4))]
    x = event_spikes(3, 50, 0.3, seed=12).to(card)
    parts = event_slabs(rows, n_slabs)
    ptrs = [source_major_index(*part, n_source=50) for part in parts]
    for t in (0, 2, 5):
        want = event_scatter_ref(*rows, x, t, d_slots=4, n_target=20)
        got = sum(event_scatter(*part, ptr, x, t, d_slots=4, n_target=20)
                  for part, ptr in zip(parts, ptrs))
        assert torch.equal(got, want) and bool(want.any())


@pytest.mark.cuda
def test_a_placed_executable_walks_its_rows_with_the_kernel(card, tmp_path):
    """Under ``shard(mesh=)`` (a world of one rank, 1 x 1) the event form's
    operands on the card carry their index: every event-form
    projection-step launches the kernel, and the trains are bitwise the
    unplaced launch's."""
    import torch.distributed as dist
    from repro_torch.core import CompileReport, SNNNetwork, random_layer
    from repro_torch.core.runtime import NetworkExecutable
    from repro_torch.distributed import sharding as shardlib

    layers = []
    for i, (a, b) in enumerate([(40, 30), (30, 20), (20, 12)]):
        layer = random_layer(a, b, density=0.4, delay_range=2 + i, seed=60 + i)
        layer.lif = LIFParams(alpha=0.5, v_th=16.0)
        layers.append(layer)
    net = SNNNetwork(layers=layers)
    report = CompileReport(layers=[SwitchingCompiler("serial").compile_layer(l)
                                   for l in net.layers])
    x = (np.random.default_rng(3).random((6, 2, 40)) < 0.4).astype(np.float32)
    base = NetworkExecutable.build(net, report, device=card)
    want = [z.clone() for z in base.run_device(x, serial_form="event")]
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1),
                            rank=0, world_size=1)
    try:
        exe = NetworkExecutable.build(net, report, device=card).shard(
            mesh=shardlib._device_mesh([0], (1, 1), ("data", "model")))
        assert exe.mesh is not None
        reset_launch_counts()
        got = exe.run_device(x, serial_form="event")
        assert launch_counts()["event_scatter"] == 6 * len(layers)
        params = exe._params_for(exe.serial_forms(2, "event"))
        assert all(p[4] is not None and p[4].is_cuda for p in params)
    finally:
        dist.destroy_process_group()
    assert sum(float(z.sum()) for z in want) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_event_kernel_at_the_microcircuit_l23e_shape(card):
    """One projection shaped like the microcircuit's L2/3E -> L2/3E (20,683
    sources and targets, p 0.1009: 43.2 M rows, delays 1-4) at B 1 and
    1.5 % of the sources firing: the kernel equals the sweep bitwise, and a
    CUDA graph of it replays the eager result and counts its launch."""
    n, p, d_slots = 20683, 0.1009, 5
    gen = torch.Generator(device=card).manual_seed(23)
    n_rows = int(n * n * p)
    src = torch.randint(0, n, (n_rows,), generator=gen, device=card, dtype=torch.int32)
    tgt = torch.randint(0, n, (n_rows,), generator=gen, device=card, dtype=torch.int32)
    dly = torch.randint(1, d_slots, (n_rows,), generator=gen, device=card,
                        dtype=torch.int32)
    w = torch.randint(-127, 128, (n_rows,), generator=gen, device=card).float()
    row_ptr = source_major_index(w, dly, src, tgt, n_source=n)
    assert int(row_ptr[-1]) == n_rows
    x = (torch.rand((1, n), generator=gen, device=card) < 0.015).float()
    want = event_scatter_ref(w, dly, src, tgt, x, 7, d_slots=d_slots, n_target=n)
    got = event_scatter(w, dly, src, tgt, row_ptr, x, 7, d_slots=d_slots, n_target=n)
    assert torch.equal(got, want) and bool(want.any())
    del want
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        graph.capture_begin()
        captured = event_scatter(w, dly, src, tgt, row_ptr, x, 7, d_slots=d_slots,
                                 n_target=n)
        graph.capture_end()
    torch.cuda.current_stream(card).wait_stream(side)
    reset_launch_counts()
    add_launch_counts({"event_scatter": 1})     # what the pool adds a replay
    graph.replay()
    assert torch.equal(captured, got)
    assert launch_counts()["event_scatter"] == 1


@pytest.mark.cuda
def test_event_kernel_refuses_what_it_does_not_take(card):
    rows = [a.to(card) for a in event_projection(10, 4, 30, 2, seed=1)]
    row_ptr = source_major_index(*rows, n_source=10)
    x = torch.ones((2, 10), device=card)
    with pytest.raises(ValueError):          # a row array left on the CPU
        event_scatter(rows[0].cpu(), *rows[1:], row_ptr, x, 0, d_slots=3, n_target=4)
    with pytest.raises(TypeError):           # int64 delays
        event_scatter(rows[0], rows[1].long(), *rows[2:], row_ptr, x, 0, d_slots=3,
                      n_target=4)
    with pytest.raises(ValueError):          # an index of another width
        event_scatter(*rows, row_ptr[:-1], x, 0, d_slots=3, n_target=4)
