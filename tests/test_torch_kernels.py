"""Parity of ``photon_ml_torch.ops.kernels`` with the JAX package.

The same numpy inputs go through ``photon_ml_tpu.ops.kernels`` (its XLA
formulation, and the Pallas kernel in interpret mode) and through the
port's ``gather_rowsum`` on CPU tensors (its plain version).  Tolerance
``rtol=1e-5, atol=1e-6``: float32 sums taken in another order.

The CUDA kernel itself runs only on the GPU: ``test_cuda_kernel_matches_
plain`` is marked ``cuda`` and skips without a card.  The JAX package is
imported inside the tests that use it, so that the ``cuda`` tests also
run where only PyTorch is installed::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from photon_ml_torch.kernels import _build
from photon_ml_torch.ops import kernels as tk

RTOL, ATOL = 1e-5, 1e-6


def _jax():
    """(jax.numpy, photon_ml_tpu.ops.kernels), imported on use."""
    import jax.numpy as jnp

    from photon_ml_tpu.ops import kernels as jk

    return jnp, jk


def _inputs(seed: int, L: int, n: int, k: int, pad_frac: float = 0.3,
            model_scale: bool = False):
    """ELL inputs with padding slots (id 0, val 0) and ids at both ends
    of the table.  ``model_scale``: a served model's scales (weights
    N(0, 0.1), feature values U(0, 1)) instead of N(0, 1) for both."""
    rng = np.random.default_rng(seed)
    if model_scale:
        table = rng.normal(0, 0.1, L).astype(np.float32)
        vals = rng.random((n, k)).astype(np.float32)
    else:
        table = rng.normal(0, 1, L).astype(np.float32)
        vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    ids = rng.integers(0, L, (n, k)).astype(np.int32)
    if n and k:
        ids[0, 0] = 0
        ids[-1, -1] = L - 1
        ids.flat[n * k // 2] = L - 1
        pad = rng.random((n, k)) < pad_frac
        ids[pad] = 0
        vals[pad] = 0.0
    return table, vals, ids


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("L,n,k", [
    (500, 64, 16), (100, 67, 5), (7, 1, 1), (50, 13, 33), (3, 9, 2),
    (1000, 0, 4),
])
def test_gather_rowsum_matches_xla(L, n, k):
    jnp, jk = _jax()
    table, vals, ids = _inputs(n * 31 + k, L, n, k)
    want = np.asarray(jk._xla_gather_rowsum(
        jnp.asarray(table), jnp.asarray(vals), jnp.asarray(ids)))
    got = tk.gather_rowsum(*_torch(table, vals, ids))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("L,n,k", [(500, 64, 16), (40, 8, 5),
                                   (100_001, 24, 33)])
def test_gather_rowsum_matches_pallas_interpret(L, n, k):
    """The Pallas kernel asserts n % 8 == 0, so only such n here."""
    jnp, jk = _jax()
    table, vals, ids = _inputs(n + k, L, n, k)
    want = np.asarray(jk._pallas_gather_rowsum(
        jnp.asarray(table), jnp.asarray(vals), jnp.asarray(ids),
        interpret=True))
    got = tk.gather_rowsum(*_torch(table, vals, ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_padding_slots_are_multiplied_like_jax():
    """0 · inf = NaN in both packages: padding is not skipped."""
    jnp, jk = _jax()
    table = np.array([np.inf, 1.0, 2.0], np.float32)
    vals = np.array([[0.0, 1.0], [2.0, 0.0]], np.float32)
    ids = np.array([[0, 1], [2, 1]], np.int32)
    want = np.asarray(jk._xla_gather_rowsum(
        jnp.asarray(table), jnp.asarray(vals), jnp.asarray(ids)))
    got = tk.gather_rowsum(*_torch(table, vals, ids)).numpy()
    assert np.isnan(want[0]) and np.isnan(got[0])
    assert got[1] == want[1] == 4.0


def test_cpu_calls_launch_nothing():
    before = tk.gather_rowsum.launches
    table, vals, ids = _inputs(0, 20, 4, 3)
    tk.gather_rowsum(*_torch(table, vals, ids))
    assert tk.gather_rowsum.launches == before


@pytest.mark.parametrize("bad,match", [
    ({"table": torch.float64}, "float32 table"),
    ({"vals": torch.float16}, "float32 table"),
    ({"ids": torch.int64}, "int32 ids"),
])
def test_wrapper_rejects_dtypes(bad, match):
    table, vals, ids = _torch(*_inputs(1, 20, 4, 3))
    args = {"table": table, "vals": vals, "ids": ids}
    for name, dt in bad.items():
        args[name] = args[name].to(dt)
    with pytest.raises(TypeError, match=match):
        tk.gather_rowsum(args["table"], args["vals"], args["ids"])


@pytest.mark.parametrize("shapes,match", [
    (((20, 1), (4, 3), (4, 3)), "table must be 1-D"),
    (((20,), (4, 3), (4, 2)), r"\[n, k\]"),
    (((20,), (12,), (12,)), r"\[n, k\]"),
])
def test_wrapper_rejects_shapes(shapes, match):
    ts, vs, is_ = shapes
    with pytest.raises(ValueError, match=match):
        tk.gather_rowsum(torch.zeros(ts), torch.zeros(vs),
                         torch.zeros(is_, dtype=torch.int32))


def test_wrapper_rejects_devices():
    table, vals, ids = _torch(*_inputs(2, 20, 4, 3))
    with pytest.raises(ValueError, match="share one device"):
        tk.gather_rowsum(table.to("meta"), vals, ids)
    with pytest.raises(ValueError, match="unsupported device"):
        tk.gather_rowsum(table.to("meta"), vals.to("meta"), ids.to("meta"))


def test_vrow_pad_matches_jax():
    _jnp, jk = _jax()
    for v in (0, 1, 7, 8, 9, 100, 1023):
        for mult in (None, 8, 16, 128):
            assert tk.vrow_pad(v, mult) == jk.vrow_pad(v, mult)


def test_kernel_library_is_keyed_by_source_hash():
    p = _build.library_path("gather_rowsum")
    assert p.parent == _build.BUILD_DIR
    assert p.parent.parts[-2:] == ("build", "kernels")
    assert p.name.startswith("gather_rowsum-") and p.suffix == ".so"
    assert _build.library_path("gather_rowsum") == p


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(64, 32), (67, 5), (4096, 32)])
def test_cuda_kernel_matches_plain(n, k):
    """At a model's scales: with N(0, 1) weights and values, float32
    rounding in two summation orders reaches ~2e-6 on a near-zero sum,
    beyond ``atol`` (simulated over 2**20 rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    table, vals, ids = _torch(*_inputs(3, 100_001, n, k, model_scale=True))
    t, v, i = (x.cuda() for x in (table, vals, ids))
    before = tk.gather_rowsum.launches
    got = tk.gather_rowsum(t, v, i)
    torch.cuda.synchronize()
    assert tk.gather_rowsum.launches == before + 1
    want = tk.gather_rowsum_reference(t, v, i)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
