"""The port's kernel wrappers against the reference package's kernels.

On the CPU every wrapper runs its plain PyTorch version; these tests hold
that version to the JAX ``ops`` function on the reference's own kernel
fixtures (auto mode, and ``interpret=True`` on a few small shapes, which
runs the Pallas kernel body).  Integer results are exact; the LIF membrane
is bit-exact against the NumPy expression and within the reference test's
``atol=1e-5`` of the JAX function; the affine scan is bit-exact where every
partial sum is representable and within ``atol=1e-4`` elsewhere.

The kernels themselves run only on the card: ``tests/test_torch_cuda.py``
holds each against its plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lif_parallel_scan import affine_scan_ref
from repro.kernels.lif_parallel_scan import lif_parallel_scan as jax_scan
from repro.kernels.lif_update import lif_update as jax_lif_update
from repro.kernels.sparse_gather import sparse_gather as jax_sparse_gather
from repro.kernels.spike_wdm_matmul import spike_wdm_matmul as jax_wdm_matmul
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.lif_parallel_scan import (
    lif_fixed_point,
    lif_parallel_scan,
)
from repro_torch.kernels.lif_update import CurrentEdge, lif_step, lif_update
from repro_torch.kernels.sparse_gather import sparse_gather
from repro_torch.kernels.spike_wdm_matmul import (
    spike_wdm_matmul,
    spike_wdm_matmul_ref,
    spike_wdm_project,
)
from repro_torch.kernels.ssd_chunk import ssd_chunk
from test_torch_cuda import (
    WDM_SHAPES,
    ell_operands,
    lif_operands,
    scan_operands,
    wdm_operands,
)


# -- K2: int8 WDM matmul ------------------------------------------------------
def port_wdm(a, x):
    """The port's batch-major call: (M, K) x (N, K) -> (N, M), transposed
    back to the reference's (M, N)."""
    out = spike_wdm_matmul(torch.from_numpy(a), torch.from_numpy(x.T.copy()))
    assert out.dtype == torch.int32
    return out.numpy().T


@pytest.mark.parametrize("m,k,n", WDM_SHAPES)
def test_wdm_matmul_matches_jax(m, k, n):
    a, x = wdm_operands(m, k, n, seed=m + k + n)
    want = np.asarray(jax_wdm_matmul(jnp.asarray(a), jnp.asarray(x)))
    assert want.dtype == np.int32
    np.testing.assert_array_equal(port_wdm(a, x), want)


@pytest.mark.parametrize("m,k,n", [(4, 16, 1), (1, 1, 1), (20, 70, 3)])
def test_wdm_matmul_matches_pallas_body(m, k, n):
    a, x = wdm_operands(m, k, n, seed=7)
    want = np.asarray(
        jax_wdm_matmul(jnp.asarray(a), jnp.asarray(x), interpret=True)
    )
    np.testing.assert_array_equal(port_wdm(a, x), want)


@pytest.mark.parametrize("m,k,n,w,want", [
    (128, 512, 8, 127, 127 * 512),
    (4, 16, 2, -128, -128 * 16),
])
def test_wdm_matmul_no_saturation(m, k, n, w, want):
    a = np.full((m, k), w, np.int8)
    x = np.ones((k, n), np.int8)
    out = port_wdm(a, x)
    assert (out == want).all()
    assert (np.asarray(jax_wdm_matmul(jnp.asarray(a), jnp.asarray(x))) == want).all()


def test_wdm_matmul_zero_columns():
    a, x = wdm_operands(32, 0, 4, seed=0)
    out = port_wdm(a, x)
    assert out.shape == (32, 4) and not out.any()
    want = np.asarray(jax_wdm_matmul(jnp.asarray(a), jnp.asarray(x)))
    np.testing.assert_array_equal(out, want)


def test_wdm_matmul_rejects_non_int8():
    with pytest.raises(TypeError):
        spike_wdm_matmul_ref(torch.ones((4, 4)), torch.ones((4, 4), dtype=torch.int8))
    with pytest.raises(TypeError):
        spike_wdm_matmul(torch.ones((4, 4), dtype=torch.int8), torch.ones((4, 4)))


# -- K1: LIF update -------------------------------------------------------------
def numpy_lif(i, v, z, alpha, v_th):
    """Eq. (1) as separately rounded f32 NumPy operations."""
    v_new = (i + np.float32(alpha) * v) - z * np.float32(v_th)
    return v_new, (v_new >= np.float32(v_th)).astype(np.float32)


@pytest.mark.parametrize("n,b", [(256, 128), (300, 36), (1, 1), (1000, 3)])
@pytest.mark.parametrize("alpha,v_th", [(0.5, 64.0), (0.9, 1.0)])
def test_lif_update_matches_jax(n, b, alpha, v_th):
    i, v, z = lif_operands(n, b, seed=n * b)
    vn, zn = lif_update(*map(torch.from_numpy, (i, v, z)), alpha=alpha, v_th=v_th)
    vn, zn = vn.numpy(), zn.numpy()
    want_v, want_z = numpy_lif(i, v, z, alpha, v_th)
    np.testing.assert_array_equal(vn.view(np.int32), want_v.view(np.int32))
    np.testing.assert_array_equal(zn, want_z)
    jv, jz = jax_lif_update(*map(jnp.asarray, (i, v, z)), alpha=alpha, v_th=v_th)
    np.testing.assert_allclose(vn, np.asarray(jv), atol=1e-5)
    np.testing.assert_array_equal(zn, np.asarray(jz))


@pytest.mark.parametrize("alpha,v_th", [(0.5, 64.0), (0.9, 1.0)])
def test_lif_update_matches_pallas_body(alpha, v_th):
    i, v, z = lif_operands(300, 36, seed=3)
    vn, zn = lif_update(*map(torch.from_numpy, (i, v, z)), alpha=alpha, v_th=v_th)
    jv, jz = jax_lif_update(
        *map(jnp.asarray, (i, v, z)), alpha=alpha, v_th=v_th, interpret=True
    )
    np.testing.assert_allclose(vn.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_array_equal(zn.numpy(), np.asarray(jz))


def test_lif_threshold_fire_and_reset():
    i = torch.tensor([[100.0], [0.0]])
    v = torch.tensor([[0.0], [128.0]])
    z = torch.tensor([[0.0], [1.0]])
    vn, zn = lif_update(i, v, z, alpha=0.5, v_th=64.0)
    assert vn.tolist() == [[100.0], [0.0]] and zn.tolist() == [[1.0], [0.0]]


# -- K3: ELL gather-accumulate ----------------------------------------------------
@pytest.mark.parametrize("r,lanes,s,b,ragged", [
    (4096, 32, 2048, 8, True),
    (40, 78, 2048, 8, True),        # the gesture net's serial input layer
    (300, 17, 500, 3, True),
    (257, 5, 64, 1, False),
    (1, 1, 1, 1, False),
])
def test_sparse_gather_matches_jax(r, lanes, s, b, ragged):
    val, idx, x = ell_operands(r, lanes, s, b, seed=r + lanes, ragged=ragged)
    out = sparse_gather(*map(torch.from_numpy, (val, idx, x))).numpy()
    want = np.asarray(jax_sparse_gather(*map(jnp.asarray, (val, idx, x))))
    np.testing.assert_array_equal(out, want)
    # exact integers: also equal to a float64 product of the same ELL
    dense = (val[..., None].astype(np.float64) * x[idx]).sum(1)
    np.testing.assert_array_equal(out, dense.astype(np.float32))


@pytest.mark.parametrize("r,lanes,s,b", [(300, 17, 500, 3), (8, 2, 20, 8)])
def test_sparse_gather_matches_pallas_body(r, lanes, s, b):
    val, idx, x = ell_operands(r, lanes, s, b, seed=11)
    out = sparse_gather(*map(torch.from_numpy, (val, idx, x))).numpy()
    want = np.asarray(
        jax_sparse_gather(*map(jnp.asarray, (val, idx, x)), interpret=True)
    )
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("layout", ["transposed", "sliced"])
@pytest.mark.parametrize("r,lanes,s,b", [(40, 78, 2048, 8), (300, 17, 500, 3),
                                         (40, 78, 500, 600)])
def test_sparse_gather_strided_x_matches_jax(r, lanes, s, b, layout):
    """x as a strided view (the fused step's ``x_t.t()`` of a (B, S) spike
    matrix, or a column slice of a wider train), bitwise against the JAX
    kernel on the same values made contiguous."""
    val, idx, x = ell_operands(r, lanes, s, b, seed=r + b)
    if layout == "transposed":
        xt = torch.from_numpy(np.ascontiguousarray(x.T)).t()
    else:
        wide = np.zeros((s, b + 3), np.float32)
        wide[:, 1:1 + b] = x
        xt = torch.from_numpy(wide)[:, 1:1 + b]
    assert not xt.is_contiguous()
    out = sparse_gather(torch.from_numpy(val), torch.from_numpy(idx), xt).numpy()
    want = np.asarray(jax_sparse_gather(*map(jnp.asarray, (val, idx, x))))
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("name", ["ell_val", "ell_idx"])
def test_sparse_gather_refuses_strided_ell(name):
    """Only x may be strided: the ELL operands must be contiguous on either
    device (the kernel reads them row by row)."""
    ops = dict(zip(("ell_val", "ell_idx", "x"),
                   map(torch.from_numpy, ell_operands(8, 3, 10, 2, 0))))
    ops[name] = ops[name].t().contiguous().t()
    with pytest.raises(ValueError, match=f"{name} must be contiguous"):
        sparse_gather(**ops)


# -- K4: affine membrane scan -----------------------------------------------------
@pytest.mark.parametrize("alpha,shape", [
    (0.0, (12, 40)), (1.0, (12, 40)), (0.5, (12, 40)),
    (1.0, (300, 130)),            # the reference's padded + chunked grid
])
def test_scan_matches_jax_and_pallas_body(alpha, shape):
    """The reference's own scan-kernel cases and currents: the plain
    version equals the associative-scan reference and the Pallas kernel
    body (interpret mode) bit for bit; every partial sum is exact here."""
    rng = np.random.default_rng(int(alpha * 10) + shape[0])
    c = rng.integers(-5, 6, size=shape).astype(np.float32)
    got = lif_parallel_scan(torch.from_numpy(c), alpha=alpha).numpy()
    np.testing.assert_array_equal(got, np.asarray(affine_scan_ref(c, alpha=alpha)))
    np.testing.assert_array_equal(
        got, np.asarray(jax_scan(jnp.asarray(c), alpha=alpha, interpret=True)))


def test_scan_near_jax_outside_the_exact_window():
    """alpha = 0.9 is not dyadic: the reference sums as a tree, the port in
    sequence, so the two differ by summation-order rounding only."""
    c = scan_operands((128, 64), seed=128)
    got = lif_parallel_scan(torch.from_numpy(c), alpha=0.9).numpy()
    want = np.asarray(affine_scan_ref(c, alpha=0.9))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the sequence itself, step by step in f32
    v, alpha = np.zeros(64, np.float32), np.float32(0.9)
    for t in range(128):
        v = alpha * v + c[t]
        np.testing.assert_array_equal(got[t], v)


def test_scan_empty_train():
    out = lif_parallel_scan(torch.zeros((0, 7)), alpha=0.5)
    assert out.shape == (0, 7)
    with pytest.raises(ValueError, match=r"\(T, F\)"):
        lif_parallel_scan(torch.zeros((2, 3, 4)), alpha=0.5)


def test_ptxas_report_reads_the_build_log(tmp_path, monkeypatch):
    """What ptxas printed beside a built library, one row a kernel: its
    name, then its spills, registers and shared memory."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "library_path", lambda name: tmp_path / "libk_01.so")
    assert _build.ptxas_report("k") == []
    (tmp_path / "libk_01.ptxas.txt").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooPf\n"
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 1024 bytes smem\n"
        "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'\n"
        "ptxas info    : Used 8 registers\n")
    assert _build.ptxas_report("k") == [
        ("_Z3fooPf", "8 bytes stack frame, 8 bytes spill stores, 8 bytes spill "
                     "loads; Used 40 registers, used 1 barriers, 1024 bytes smem"),
        ("_Z3barv", "Used 8 registers"),
    ]


def test_plain_versions_count_no_launches():
    reset_launch_counts()
    lif_update(*map(torch.from_numpy, lif_operands(8, 4, 0)), alpha=0.9, v_th=1.0)
    a, x = wdm_operands(4, 16, 2, 0)
    port_wdm(a, x)
    sparse_gather(*map(torch.from_numpy, ell_operands(8, 3, 10, 2, 0)))
    lif_parallel_scan(torch.from_numpy(scan_operands((6, 5), 0)), alpha=0.5)
    lif_fixed_point(torch.from_numpy(scan_operands((6, 5), 0)), alpha=0.5,
                    v_th=2.0, cap=7)
    spike_wdm_project(torch.from_numpy(a), torch.zeros(16, dtype=torch.int32),
                      torch.ones(16, dtype=torch.int32),
                      torch.zeros((2, 1, 3), dtype=torch.int8), 0)
    ssd_chunk(torch.zeros((4, 2, 3)), torch.zeros((4, 2, 5)),
              torch.zeros((4, 2, 5)), torch.zeros((4, 2)))
    lif_step([CurrentEdge(torch.ones((2, 3)))], torch.zeros((2, 3)),
             torch.zeros((2, 3), dtype=torch.int8), torch.empty((2, 3)), 0,
             alpha=0.5, v_th=1.0)
    assert launch_counts() == {
        "lif_update": 0, "lif_step": 0, "spike_wdm_matmul": 0, "spike_wdm_project": 0,
        "sparse_gather": 0, "lif_parallel_scan": 0, "lif_fixed_point": 0,
        "ssd_chunk": 0,
    }
