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
from repro_torch.core.runtime import network_executable
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.lif_update import lif_update, lif_update_ref
from repro_torch.kernels.sparse_gather import sparse_gather, sparse_gather_ref
from repro_torch.kernels.spike_wdm_matmul import (
    spike_wdm_matmul,
    spike_wdm_matmul_ref,
)


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
@pytest.mark.parametrize("m,k,n", WDM_SHAPES + [(512, 2048, 128), (33, 3, 5)])
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
    assert counts["lif_update"] == 30 * 2
    paradigms = [layer.paradigm for layer in report.layers]
    assert counts["spike_wdm_matmul"] == 30 * paradigms.count("parallel")
    assert counts["sparse_gather"] == 30 * paradigms.count("serial")
    cpu = network_executable(net, report, device="cpu").run(x, valid_steps=valid)
    for a, b in zip(got, cpu):
        np.testing.assert_array_equal(a, b)
