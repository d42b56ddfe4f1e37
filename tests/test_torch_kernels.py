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

import dataclasses

import numpy as np
import pytest
import torch

from photon_ml_torch.kernels import _build
from photon_ml_torch.ops import kernels as tk
from test_torch_training import jax_fresh_caches  # noqa: F401  (C5)

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


def _power_law_inputs(seed: int, L: int, n: int, k: int,
                      model_scale: bool = False):
    """ELL inputs whose ids follow the training data's power law (head
    columns in most rows, as ``chip_smoke.make_training_data`` draws
    them), 30% padding."""
    table, vals, ids = _inputs(seed, L, n, k, model_scale=model_scale)
    rng = np.random.default_rng(seed + 1)
    ids = ((L - 1) * rng.random((n, k)) ** 2.2).astype(np.int32)
    ids[vals == 0.0] = 0
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


@pytest.mark.parametrize("L,n,k", [(1000, 40, 8), (5000, 24, 128),
                                   (100_001, 9, 512)])
@pytest.mark.parametrize("ids", ["uniform", "power_law"])
def test_gather_rowsum_matches_xla_at_virtual_row_widths(L, n, k, ids):
    """The widths of the transposed-ELL virtual rows (capacities 8-512)
    and the training data's power-law ids."""
    jnp, jk = _jax()
    make = _inputs if ids == "uniform" else _power_law_inputs
    table, vals, idx = make(n * 7 + k, L, n, k)
    want = np.asarray(jk._xla_gather_rowsum(
        jnp.asarray(table), jnp.asarray(vals), jnp.asarray(idx)))
    got = tk.gather_rowsum(*_torch(table, vals, idx))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("L,n,k", [(1000, 16, 8), (5000, 8, 128),
                                   (100_001, 8, 512)])
def test_gather_rowsum_matches_pallas_interpret_at_wide_rows(L, n, k):
    jnp, jk = _jax()
    table, vals, ids = _power_law_inputs(n + k, L, n, k)
    want = np.asarray(jk._pallas_gather_rowsum(
        jnp.asarray(table), jnp.asarray(vals), jnp.asarray(ids),
        interpret=True))
    got = tk.gather_rowsum(*_torch(table, vals, ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# Threads a row on each path, by k: the fewest (a power of two up to 32)
# whose 4 slots each (the 16-byte path) or 1 slot each cover the row.
_TPR_VEC4 = {8: 2, 32: 8, 128: 32, 512: 32}
_TPR_SCALAR = {1: 1, 5: 8, 8: 8, 32: 32, 33: 32, 128: 32, 512: 32}
_RESIDENT = 132          # one 512-thread block an SM
_L = 100_001             # the served model's w


@pytest.mark.parametrize("k", [1, 5, 8, 32, 33, 128, 512])
@pytest.mark.parametrize("n", [0, 1, 3, 64, 67, 1 << 20])
def test_launch_shape(n, k):
    shape = tk._launch_shape(n, k, True, _RESIDENT, _L)
    if k % 4 == 0:
        assert (shape.path, shape.vec) == ("vec4", 4)
        assert shape.threads_a_row == _TPR_VEC4[k]
    else:
        assert (shape.path, shape.vec) == ("scalar", 1)
        assert shape.threads_a_row == _TPR_SCALAR[k]
    assert shape.rows_a_warp * shape.threads_a_row == 32
    groups = -(-n // shape.rows_a_warp)
    assert shape.blocks == min(-(-groups // 16), _RESIDENT)
    # A thread's slots a step reach the row's end, or a warp walks it.
    assert (shape.threads_a_row * shape.vec >= k
            or shape.threads_a_row == 32)
    # The table's head goes to shared memory only where n·k pays for it.
    assert shape.head == (56 * 1024 if n * k >= 1 << 21 else 0)
    unaligned = tk._launch_shape(n, k, False, _RESIDENT, _L)
    assert unaligned.path == "scalar"
    assert unaligned.threads_a_row == _TPR_SCALAR[k]
    assert unaligned.head == shape.head


def test_launch_shape_fills_the_card_at_most_once():
    shape = tk._launch_shape(1 << 20, 32, True, _RESIDENT, _L)
    assert shape.blocks == _RESIDENT          # persistent: one wave
    assert tk._launch_shape(64, 32, True, _RESIDENT, _L).blocks == 1


@pytest.mark.parametrize("n,k,L,head", [
    (65_537, 32, 100_001, 56 * 1024),   # just past the threshold
    (65_535, 32, 100_001, 0),           # just below it
    (70_000, 32, 1000, 1000),           # the whole table fits
    (1 << 20, 5, 7, 7),
])
def test_launch_shape_table_head(n, k, L, head):
    assert tk._launch_shape(n, k, True, _RESIDENT, L).head == head


def test_alignment_picks_the_path():
    """A contiguous view 4 bytes into its storage is not 16-byte
    aligned, so it takes the scalar path."""
    base = torch.zeros(4 * 8 + 4)
    aligned = base[:32].view(4, 8)
    shifted = base[1:33].view(4, 8)
    assert shifted.is_contiguous() and shifted.data_ptr() % 4 == 0
    assert tk._aligned(aligned, aligned)
    assert not tk._aligned(aligned, shifted)


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


def _cuda(*arrays):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return [torch.from_numpy(a).cuda() for a in arrays]


def _launch_twice(t, v, i):
    """The kernel's result, after checking that it launched once a call
    and that two launches agree bit for bit."""
    before = tk.gather_rowsum.launches
    got = tk.gather_rowsum(t, v, i)
    again = tk.gather_rowsum(t, v, i)
    torch.cuda.synchronize()
    assert tk.gather_rowsum.launches == before + 2
    assert torch.equal(got, again) or (
        torch.equal(got.isnan(), again.isnan())
        and torch.equal(got.nan_to_num(), again.nan_to_num()))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [
    (1, 32), (3, 32), (64, 32), (67, 5), (4096, 32), (65_537, 32),
    (1000, 1), (1000, 8), (999, 128), (257, 512),
])
@pytest.mark.parametrize("ids", ["uniform", "power_law"])
def test_cuda_kernel_matches_plain(n, k, ids):
    """At a model's scales: with N(0, 1) weights and values, float32
    rounding in two summation orders reaches ~2e-6 on a near-zero sum,
    beyond ``atol`` (simulated over 2**20 rows).  Ids at 0 and L-1 are
    among the slots; two launches are bitwise equal."""
    make = _inputs if ids == "uniform" else _power_law_inputs
    table, vals, idx = make(3, 100_001, n, k, model_scale=True)
    idx[0, 0], idx[-1, -1] = 0, 100_000
    t, v, i = _cuda(table, vals, idx)
    got = _launch_twice(t, v, i)
    want = tk.gather_rowsum_reference(t, v, i)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(64, 32), (1000, 8), (70_000, 32)])
def test_cuda_unaligned_input_takes_the_scalar_path(n, k):
    table, vals, ids = _inputs(5, 100_001, n, k, model_scale=True)
    t, v, i = _cuda(table, vals, ids)
    # Contiguous copies that start 4 bytes into their storage.
    v_off = torch.empty(n * k + 1, device="cuda")[1:].view(n, k)
    i_off = torch.empty(n * k + 1, dtype=torch.int32,
                        device="cuda")[1:].view(n, k)
    v_off.copy_(v)
    i_off.copy_(i)
    assert v_off.is_contiguous() and not tk._aligned(v_off, i_off)
    assert tk._launch_shape(n, k, tk._aligned(v_off, i_off), 132,
                            100_001).path == "scalar"
    got = _launch_twice(t, v_off, i_off)
    want = tk.gather_rowsum_reference(t, v, i)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(5, 2), (5, 32), (70_000, 32)])
def test_cuda_padding_under_inf_gives_nan(n, k):
    """0 · inf = NaN on every path, as in the plain version (the last
    case copies the table into shared memory)."""
    table = np.arange(10, dtype=np.float32)
    table[0] = np.inf
    vals = np.ones((n, k), np.float32)
    ids = np.full((n, k), 3, np.int32)
    vals[1, -1], ids[1, -1] = 0.0, 0           # a padding slot
    t, v, i = _cuda(table, vals, ids)
    got = _launch_twice(t, v, i).cpu().numpy()
    want = tk.gather_rowsum_reference(t, v, i).cpu().numpy()
    assert np.isnan(got[1]) and np.isnan(want[1])
    mask = np.arange(n) != 1
    np.testing.assert_allclose(got[mask], want[mask], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,L,offset", [
    (70_000, 32, 100_001, 0),    # head in shared memory, tail through L1
    (70_000, 32, 100_001, 1),    # a table view not 16-byte aligned
    (70_000, 33, 100_001, 0),    # the scalar path with the head
    (70_000, 32, 1000, 0),       # every gather from shared memory
    (30_000, 128, 58_000, 3),
])
def test_cuda_table_head_in_shared_memory(n, k, L, offset):
    table, vals, ids = _power_law_inputs(7, L, n, k, model_scale=True)
    ids[0, 0], ids[-1, -1] = 0, L - 1
    ids[n // 2, 0] = min(L - 1, 56 * 1024)      # the first id past the head
    t, v, i = _cuda(table, vals, ids)
    t = torch.cat([torch.zeros(offset, device="cuda"), t])[offset:]
    assert tk._launch_shape(n, k, True, 132, L).head == min(L, 56 * 1024)
    got = _launch_twice(t, v, i)
    want = tk.gather_rowsum_reference(t, v, i)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


def _transposed_ell(seed: int, n: int, d: int, capacity: int | None):
    """B1's inputs at the transposed-ELL shapes: the virtual rows of a
    power-law [n, 32] ELL (``data.colmajor``) over ``d`` columns, and a
    residual table over the n rows."""
    from photon_ml_torch.data.colmajor import build_colmajor_arrays

    rng = np.random.default_rng(seed)
    cols = np.sort(((d - 32) * rng.random((n, 32)) ** 2.2).astype(np.int64),
                   axis=1)
    for j in range(1, 32):
        bump = cols[:, j] <= cols[:, j - 1]
        cols[bump, j] = cols[bump, j - 1] + 1
    vals = rng.random((n, 32)).astype(np.float32)
    vals[:, 30:] = 0.0                               # padding slots
    tvals, trows, _ = build_colmajor_arrays(cols.astype(np.int32), vals, d,
                                            capacity=capacity)
    r = rng.normal(0, 1, n).astype(np.float32)
    return r, tvals, trows


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [8, 16, 64, 128, 512, None])
def test_cuda_kernel_at_transposed_ell_capacities(capacity):
    """Virtual rows of capacity 8-512 (thousands of them), ids sorted
    row indices within a column, a table (r over 100,000 rows) larger
    than the shared-memory head; bitwise across launches and within
    tolerance of the plain version."""
    r, tvals, trows = _transposed_ell(11, 100_000, 20_000, capacity)
    assert tvals.shape[0] >= 1000
    t, v, i = _cuda(r, tvals, trows)
    got = _launch_twice(t, v, i)
    want = tk.gather_rowsum_reference(t, v, i)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=1e-5)


@pytest.mark.cuda
def test_cuda_colmajor_xt_dot_matches_index_add():
    """``ColMajorSlice.xt_dot`` on the card (B1 + the float64 fold)
    against the plain ELL scatter ``index_add_`` of the same rows."""
    from photon_ml_torch.data.batch import make_sparse_batch
    from photon_ml_torch.data.sparse_rows import SparseRows

    rng = np.random.default_rng(12)
    n, d, k = 50_000, 5_000, 32
    cols = np.sort(((d - k) * rng.random((n, k)) ** 2.2).astype(np.int64),
                   axis=1)
    for j in range(1, k):
        bump = cols[:, j] <= cols[:, j - 1]
        cols[bump, j] = cols[bump, j - 1] + 1
    rows = SparseRows.from_flat(np.arange(n + 1) * k, cols.reshape(-1),
                                rng.random(n * k).astype(np.float32))
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    cm = make_sparse_batch(rows, d, np.zeros(n), col_major=True,
                           device="cuda")
    plain = dataclasses.replace(cm, colmajor=None)
    r = torch.randn(n, device="cuda")
    before = tk.gather_rowsum.launches
    got = cm.xt_dot(r)
    assert tk.gather_rowsum.launches == before + 1
    want = plain.xt_dot(r)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * float(want.abs().max()))


# -- the lane kernel: gather_rowsum_lanes -------------------------------------


def _lane_table(seed: int, L: int, T: int) -> np.ndarray:
    """Coefficient lanes W [L, T] at a model's scale."""
    return np.random.default_rng(seed).normal(0, 0.1, (L, T)).astype(
        np.float32)


@pytest.mark.parametrize("L", [1, 3, 4, 8])
@pytest.mark.parametrize("k", [8, 31, 264])
def test_gather_rowsum_lanes_matches_pallas_vmap(L, k):
    """The plain lane version against ``jax.vmap`` of the Pallas kernel
    (interpret mode) over the lanes of W [L, T], the counterpart the
    swept objective traces: rtol 1e-5, atol 1e-6."""
    import jax

    jnp, jk = _jax()
    T, n = 5000, 64
    _, vals, ids = _power_law_inputs(L * 10 + k, T, n, k)
    W = _lane_table(k + L, L, T)
    want = np.asarray(jax.vmap(lambda t: jk._pallas_gather_rowsum(
        t, jnp.asarray(vals), jnp.asarray(ids), interpret=True))(
            jnp.asarray(W)))                                    # [L, n]
    got = tk.gather_rowsum_lanes_reference(*_torch(
        np.ascontiguousarray(W.T), vals, ids))                  # [n, L]
    assert got.shape == (n, L)
    np.testing.assert_allclose(got.numpy().T, want, rtol=RTOL, atol=ATOL)


_SMS = 132                   # an H100's SMs


@pytest.mark.parametrize("k", [1, 5, 31, 32, 264])
@pytest.mark.parametrize("L", [2, 4, 8, 16])
@pytest.mark.parametrize("n", [3, 4097, 900_000])
def test_lane_launch_shape(n, k, L):
    """The lane kernel's launch: a slot's lanes over L/4 threads (one at
    L = 2), the fewest slot threads that keep a run within 8 slots (at
    most a warp a row), tiles of whole passes of a block's 512 threads
    and a multiple of 4 rows, about 16 KB of streams, 2 stages, one block
    an SM holding the ring and, from 2**21 slots on at up to 8 lanes,
    the table's head in the room left where that holds 1/32 of the
    table; 16-byte stage reads where k and the run are multiples of 4; a
    persistent grid.  Unaligned streams take the direct path with the
    same threads and tiles."""
    T = 100_001
    shape = tk._lane_launch_shape(n, k, L, True, T, _SMS)
    assert shape.path == "staged" and shape.staged
    assert shape.threads_a_slot == max(1, L // 4)
    tpr = shape.threads_a_row
    assert tpr <= 32 and tpr & (tpr - 1) == 0
    assert shape.slot_threads * shape.run >= k
    assert shape.run <= 8 or tpr == 32
    if shape.slot_threads > 1:       # the fewest such threads
        assert -(-k // (shape.slot_threads // 2)) > 8
    rows_a_pass = tk._LANE_CONSUMERS // tpr
    assert tk._LANE_CONSUMERS == 512
    assert shape.tile_rows % 4 == 0 and shape.tile_rows % rows_a_pass == 0
    assert shape.tile_rows * k * 8 <= max(16 << 10, rows_a_pass * k * 8)
    assert shape.stages == 2
    assert shape.vec == (4 if k % 4 == 0 and shape.run % 4 == 0 else 1)
    ring = shape.stages * shape.tile_rows * k * 8
    head_bytes = -(-shape.head * L * 4 // 16) * 16
    smem = tk._lane_smem(L, k, shape.tile_rows, shape.head)
    assert smem == tk._LANE_BARRIER_BYTES + head_bytes + ring
    assert smem <= tk._LANE_SMEM_BLOCK == 227 * 1024
    most = min(T, (tk._LANE_SMEM_BLOCK - tk._LANE_BARRIER_BYTES - ring)
               // 16 * 16 // (4 * L))
    assert shape.head == (most if n * k >= 1 << 21 and L <= 8
                          and most >= T / 32 else 0)
    assert shape.blocks == min(-(-n // shape.tile_rows), _SMS)
    direct = tk._lane_launch_shape(n, k, L, False, T, _SMS)
    assert direct.path == "direct"
    assert (direct.stages, direct.head, direct.vec) == (0, 0, 1)
    assert direct._replace(staged=True, head=shape.head,
                           vec=shape.vec) == shape


@pytest.mark.parametrize("L", [2, 4, 8, 16])
def test_lane_launch_shape_head_and_wide_rows(L):
    """A table shorter than the room gets a head of the whole table (at
    up to 8 lanes); at k = 264 a 100,001-row table keeps one, the
    transposed ELL's millions of rows do not (the head would hold under
    1/32 of them); too few slots keep none; rows too wide for two stages
    in a block take the direct path even when aligned."""
    n, k = 900_000, 31
    short = tk._lane_launch_shape(n, k, L, True, 500, _SMS)
    assert short.head == (500 if L <= 8 else 0)
    assert tk._lane_smem(L, k, short.tile_rows, short.head) == (
        tk._LANE_BARRIER_BYTES + -(-short.head * L * 4 // 16) * 16
        + 2 * short.tile_rows * k * 8)
    model = tk._lane_launch_shape(8191, 264, L, True, 100_001, _SMS)
    assert (model.head > 100_001 / 32) == (L <= 8)
    wide_table = tk._lane_launch_shape(148_520, 264, L, True, 1 << 22, _SMS)
    assert wide_table.head == 0
    small = tk._lane_launch_shape(1000, k, L, True, 100_001, _SMS)
    assert small.head == 0
    wide = tk._lane_launch_shape(4096, 8192, L, True, 100_001, _SMS)
    assert wide.path == "direct" and wide.stages == 0


def test_gather_rowsum_lanes_cpu_runs_the_plain_version():
    """On CPU tensors the wrapper is the plain version, counts nothing,
    and every lane equals ``gather_rowsum`` of that lane's column."""
    table, vals, ids = _inputs(5, 300, 40, 7)
    W = _lane_table(6, 5, 300)
    t, v, i = _torch(np.ascontiguousarray(W.T), vals, ids)
    before = tk.gather_rowsum_lanes.launches
    got = tk.gather_rowsum_lanes(t, v, i)
    assert tk.gather_rowsum_lanes.launches == before
    for lane in range(5):
        np.testing.assert_allclose(
            got[:, lane].numpy(),
            tk.gather_rowsum(t[:, lane].contiguous(), v, i).numpy(),
            rtol=RTOL, atol=ATOL)


def test_lane_gather_rowsum_keeps_one_lane_on_gather_rowsum(monkeypatch):
    """One lane is the single-λ path bit for bit; more go to the lane
    kernel, whose [n, L] output comes back as [L, n]."""
    table, vals, ids = _inputs(9, 200, 30, 6)
    t, v, i = _torch(table, vals, ids)
    one = tk.lane_gather_rowsum(t[None], v, i)
    assert one.shape == (1, 30)
    assert torch.equal(one[0], tk.gather_rowsum(t, v, i))
    called = []
    monkeypatch.setattr(tk, "gather_rowsum_lanes",
                        lambda *a: called.append(1)
                        or tk.gather_rowsum_lanes_reference(*a))
    W = torch.from_numpy(_lane_table(3, 4, 200))
    out = tk.lane_gather_rowsum(W, v, i)
    assert called == [1] and out.shape == (4, 30)


@pytest.mark.parametrize("shape,match", [
    ((300,), r"\[T, L\]"), ((300, 0), r"\[T, L\]"), ((300, 17), r"\[T, L\]"),
])
def test_gather_rowsum_lanes_rejects_shapes(shape, match):
    _, vals, ids = _inputs(1, 300, 4, 3)
    with pytest.raises(ValueError, match=match):
        tk.gather_rowsum_lanes(torch.zeros(shape), *_torch(vals, ids))


def test_gather_rowsum_lanes_rejects_dtypes():
    _, vals, ids = _inputs(1, 300, 4, 3)
    v, i = _torch(vals, ids)
    with pytest.raises(TypeError, match="gather_rowsum_lanes takes float32"):
        tk.gather_rowsum_lanes(torch.zeros((300, 2), dtype=torch.float64),
                               v, i)
    with pytest.raises(TypeError, match="int32 ids"):
        tk.gather_rowsum_lanes(torch.zeros((300, 2)), v, i.long())


def _launch_lanes_twice(t, v, i):
    """The lane kernel's result, after checking that it launched once a
    call and that two launches agree bit for bit."""
    before = tk.gather_rowsum_lanes.launches
    got = tk.gather_rowsum_lanes(t, v, i)
    again = tk.gather_rowsum_lanes(t, v, i)
    torch.cuda.synchronize()
    assert tk.gather_rowsum_lanes.launches == before + 2
    assert torch.equal(got, again)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,rows", [
    (1, 32, 100_001), (3, 31, 100_001), (67, 5, 100_001),
    (4096, 31, 100_001), (4097, 31, 100_001),
    (65_537, 32, 100_001), (1000, 1, 100_001),
    (999, 128, 100_001), (257, 264, 100_001),
    (2049, 264, 100_001), (129, 512, 100_001),
    # The table's head in shared memory (at up to 8 lanes, from 2**21
    # slots): ids on both sides of its end, and a table shorter than the
    # room for it.
    (70_001, 31, 100_001), (100_003, 31, 100_001),
    (8191, 264, 100_001),
    (70_001, 31, 500), (8191, 264, 900),
])
@pytest.mark.parametrize("lanes", [2, 3, 4, 8, 16])
def test_cuda_lane_kernel_matches_plain(n, k, rows, lanes):
    """Power-law ids over a table of ``rows`` rows at a model's scales:
    the 16-byte and the 4-byte stage reads (k % 4 == 0 and not), n not a
    multiple of a tile's rows and n < 4, the estimator's 31 slots and
    the transposed ELL's 264, the head in shared memory (ids just below
    and at its end), lane counts on the built widths and one padded (3 →
    4); bitwise across launches, within rtol 1e-5, atol 1e-6 of the
    plain version, as B1."""
    _, vals, idx = _power_law_inputs(5, rows, n, k, model_scale=True)
    width = 4 if lanes == 3 else lanes
    shape = tk._lane_launch_shape(n, k, width, True, rows, _SMS)
    if shape.head:
        idx[0, 0], idx[-1, -1] = shape.head - 1, min(shape.head, rows - 1)
    else:
        idx[0, 0], idx[-1, -1] = 0, rows - 1
    W = _lane_table(n + lanes, lanes, rows)
    t, v, i = _cuda(np.ascontiguousarray(W.T), vals, idx)
    got = _launch_lanes_twice(t, v, i)
    assert got.shape == (n, lanes)
    want = tk.gather_rowsum_lanes_reference(t, v, i)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_cuda_lane_kernel_unaligned_streams_and_table():
    """Streams that start off a 16-byte boundary take the scalar path; a
    table view off the boundary is copied aligned; results unchanged."""
    n, k, lanes = 1000, 32, 8
    _, vals, ids = _power_law_inputs(7, 5000, n, k, model_scale=True)
    W = _lane_table(8, lanes, 5000)
    t, v, i = _cuda(np.ascontiguousarray(W.T), vals, ids)
    want = tk.gather_rowsum_lanes(t, v, i)
    v_off = torch.empty(n * k + 1, device="cuda")[1:].view(n, k)
    i_off = torch.empty(n * k + 1, dtype=torch.int32,
                        device="cuda")[1:].view(n, k)
    v_off.copy_(v)
    i_off.copy_(i)
    t_off = torch.empty(5000 * lanes + 1, device="cuda")[1:].view(5000, lanes)
    t_off.copy_(t)
    got = _launch_lanes_twice(t_off, v_off, i_off)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("col_major", [False, True])
def test_cuda_batch_lane_products_match_single_lanes(col_major):
    """``SparseBatch.x_dot`` over W [L, d] (one lane-kernel launch) and
    ``xt_dot`` over R [L, n] (one float64 ``index_add_``, or one lane
    launch and one fold on the transposed ELL) against the single-λ
    products lane by lane."""
    from photon_ml_torch.data.batch import make_sparse_batch
    from photon_ml_torch.data.sparse_rows import SparseRows

    rng = np.random.default_rng(13)
    n, d, k, lanes = 40_000, 4_000, 31, 8
    cols = np.sort(rng.choice(d, (n, k)), axis=1)
    for j in range(1, k):
        bump = cols[:, j] <= cols[:, j - 1]
        cols[bump, j] = cols[bump, j - 1] + 1
    cols = np.minimum(cols, d - 1)
    keep = np.concatenate([np.ones((n, 1), bool), np.diff(cols, axis=1) > 0],
                          axis=1)
    rows = SparseRows.from_flat(
        np.concatenate([[0], np.cumsum(keep.sum(1))]), cols[keep],
        rng.random(int(keep.sum())).astype(np.float32))
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    batch = make_sparse_batch(rows, d, np.zeros(n), col_major=col_major,
                              device="cuda")
    W = torch.from_numpy(_lane_table(1, lanes, d)).cuda()
    R = torch.randn(lanes, n, device="cuda")
    before = tk.gather_rowsum_lanes.launches
    xw = batch.x_dot(W)
    xtr = batch.xt_dot(R)
    torch.cuda.synchronize()
    assert tk.gather_rowsum_lanes.launches == before + 1 + int(col_major)
    for lane in range(lanes):
        np.testing.assert_allclose(xw[lane].cpu().numpy(),
                                   batch.x_dot(W[lane]).cpu().numpy(),
                                   rtol=RTOL, atol=ATOL)
        want = batch.xt_dot(R[lane].contiguous())
        np.testing.assert_allclose(
            xtr[lane].cpu().numpy(), want.cpu().numpy(), rtol=1e-5,
            atol=1e-5 * float(want.abs().max()))
