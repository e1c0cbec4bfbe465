"""The port's kernel wrappers against the reference package's kernels.

On the CPU every wrapper runs its plain PyTorch version; these tests hold
that version to the JAX ``ops`` function on the reference's own kernel
fixtures (auto mode, and ``interpret=True`` on a few small shapes, which
runs the Pallas kernel body).  Integer results are exact; the LIF membrane
is bit-exact against the NumPy expression and within the reference test's
``atol=1e-5`` of the JAX function.

The kernels themselves run only on the card: ``tests/test_torch_cuda.py``
holds each against its plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lif_update import lif_update as jax_lif_update
from repro.kernels.sparse_gather import sparse_gather as jax_sparse_gather
from repro.kernels.spike_wdm_matmul import spike_wdm_matmul as jax_wdm_matmul
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.lif_update import lif_update
from repro_torch.kernels.sparse_gather import sparse_gather
from repro_torch.kernels.spike_wdm_matmul import (
    spike_wdm_matmul,
    spike_wdm_matmul_ref,
)
from test_torch_cuda import WDM_SHAPES, ell_operands, lif_operands, wdm_operands


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


def test_plain_versions_count_no_launches():
    reset_launch_counts()
    lif_update(*map(torch.from_numpy, lif_operands(8, 4, 0)), alpha=0.9, v_th=1.0)
    a, x = wdm_operands(4, 16, 2, 0)
    port_wdm(a, x)
    sparse_gather(*map(torch.from_numpy, ell_operands(8, 3, 10, 2, 0)))
    assert launch_counts() == {
        "lif_update": 0, "spike_wdm_matmul": 0, "sparse_gather": 0
    }
