"""The port's environment registry against the JAX package's (ROADMAP C7).

Both packages read their environment only through ``config.read_env``,
which raises on a name not registered in ``config.SANCTIONED_ENV``.  The
port registers the names it honours, a subset of the reference's.  For
each, the variable is set with ``monkeypatch.setenv`` for both packages
and both act alike: the plan cache lands in (and is read back from) that
directory across packages, the spill dir resolves to it, the fleet
trio builds equal contexts, and the training driver's
``distributed_init_from_env`` reads the reference's
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
into a ``torch.distributed`` group (gloo on the CPU).  The reference's two opt-outs,
``PHOTON_ML_TPU_NATIVE=0`` and ``PHOTON_ML_TPU_GRR=0``, are not the
port's: its numpy ETL (taken without the native library) equals the
reference's under ``NATIVE=0``, and its ``contract`` keeps going through
the GRR kernel wrappers under ``GRR=0`` (on a CUDA table a wrapper
launches its kernel; on the CPU it runs its plain version) with the
reference's plain result.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from photon_ml_torch import config as tconfig
from test_torch_training import jax_fresh_caches  # noqa: F401  (C5)


def _ell(seed: int, n: int = 1500, d: int = 900, k: int = 6):
    rng = np.random.default_rng(seed)
    cols = np.stack([np.sort(rng.choice(d, k, replace=False))
                     for _ in range(n)]).astype(np.int32)
    vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    return cols, vals, d


def test_read_env_raises_on_unregistered_name():
    from photon_ml_tpu import config as jconfig

    for mod in (tconfig, jconfig):
        with pytest.raises(KeyError, match="SANCTIONED_ENV"):
            mod.read_env("PHOTON_NOT_A_KNOB")
    name = "PHOTON_ML_TPU_SPILL_DIR"
    assert tconfig.read_env(name, "dflt") == os.environ.get(name, "dflt")
    for name in ("PHOTON_ML_TPU_NATIVE", "PHOTON_ML_TPU_GRR"):
        assert jconfig.read_env(name, "dflt") == os.environ.get(name, "dflt")
        with pytest.raises(KeyError, match="SANCTIONED_ENV"):
            tconfig.read_env(name)


def test_registry_is_a_subset_of_the_reference():
    from photon_ml_tpu import config as jconfig

    port = set(tconfig.SANCTIONED_ENV)
    assert port <= set(jconfig.SANCTIONED_ENV)
    assert port == {
        "PHOTON_ML_TPU_PLAN_CACHE", "PHOTON_ML_TPU_SPILL_DIR",
        "PHOTON_ML_TPU_COMPILE_CACHE",
        "PHOTON_FLEET_NUM_HOSTS", "PHOTON_FLEET_HOST_ID",
        "PHOTON_FLEET_COORDINATOR", "JAX_COORDINATOR_ADDRESS",
        "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"}


def test_port_reads_registered_names_only_through_read_env():
    """No module of the port reads a registered name from
    ``os.environ`` directly."""
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "photon_ml_torch")
    offenders = []
    for dirpath, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            text = open(path).read()
            for line in text.splitlines():
                if "os.environ" in line and any(
                        k in line for k in tconfig.SANCTIONED_ENV):
                    offenders.append((path, line.strip()))
    assert not offenders, offenders


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_plan_cache_env_shared_both_ways(writer, tmp_path, monkeypatch):
    """``cache_dir=None`` resolves through ``$PHOTON_ML_TPU_PLAN_CACHE``
    in both packages: the plan lands there and the other package hits
    it."""
    from photon_ml_tpu.data import grr as jgrr

    from photon_ml_torch.data import grr as tgrr

    cols, vals, d = _ell(3)
    monkeypatch.setenv("PHOTON_ML_TPU_PLAN_CACHE", str(tmp_path))
    first, second = ((jgrr, lambda: jgrr.build_grr_pair(cols, vals, d)),
                     (tgrr, lambda: tgrr.build_grr_pair(cols, vals, d,
                                                        device="cpu")))
    if writer == "torch":
        first, second = second, first
    first[1]()
    assert first[0].last_build_phases.get("cache_hit", 0.0) == 0.0
    path = tgrr.pair_cache_path_for(cols, vals, d, str(tmp_path))
    assert path == jgrr.pair_cache_path_for(cols, vals, d, str(tmp_path))
    assert os.path.exists(path)
    second[1]()
    assert second[0].last_build_phases["cache_hit"] == 1.0


def test_spill_dir_env_resolves_alike(tmp_path, monkeypatch):
    from photon_ml_tpu.data import chunk_store as jstore

    from photon_ml_torch.data import chunk_store as tstore

    monkeypatch.setenv("PHOTON_ML_TPU_SPILL_DIR", str(tmp_path))
    assert tstore.resolve_spill_dir(None) == str(tmp_path)
    assert jstore.resolve_spill_dir(None) == str(tmp_path)
    assert tstore.resolve_spill_dir("x") == jstore.resolve_spill_dir("x")
    monkeypatch.delenv("PHOTON_ML_TPU_SPILL_DIR")
    assert tstore.resolve_spill_dir(None) is None
    assert jstore.resolve_spill_dir(None) is None


def test_native_off_takes_numpy_etl_alike(monkeypatch):
    """The reference under ``PHOTON_ML_TPU_NATIVE=0`` and the port
    without its native library both take the numpy ETL (here the
    transposed-ELL build), with outputs equal to each other and to the
    native build's."""
    from photon_ml_tpu import native as jnative
    from photon_ml_tpu.data import colmajor as jcol

    from photon_ml_torch import native as tnative
    from photon_ml_torch.data import colmajor as tcol

    cols, vals, d = _ell(5, n=800, d=300)
    with_native = tcol.build_colmajor_arrays(cols, vals, d, capacity=8)
    monkeypatch.setenv("PHOTON_ML_TPU_NATIVE", "0")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(jnative, "_lib", False)
    assert tnative.lib() is None and jnative.lib() is None
    assert not tnative.native_available()
    assert not jnative.native_available()
    port = tcol.build_colmajor_arrays(cols, vals, d, capacity=8)
    r = jcol.build_colmajor(cols, vals, d, capacity=8)
    ref = (r.tvals, r.trows, r.vcol)
    for a, b, c in zip(port, ref, with_native):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))


def test_grr_off_routes_contract_to_plain(monkeypatch):
    """Under ``PHOTON_ML_TPU_GRR=0`` the reference takes its plain
    contraction.  The port has no such opt-out: ``contract`` still goes
    through the kernel wrappers (asserted by the route), and on these
    CPU tensors each wrapper runs its plain version, with the
    reference's plain result."""
    import jax.numpy as jnp
    from photon_ml_tpu.data import grr as jgrr

    from photon_ml_torch.data import grr as tgrr

    monkeypatch.delenv("PHOTON_ML_TPU_GRR", raising=False)
    cols, vals, d = _ell(7)
    pair = tgrr.build_grr_pair(cols, vals, d, device="cpu")
    ref = jgrr.build_grr_pair(cols, vals, d)
    calls = {"kernel": 0}

    def wrap(fn):
        def inner(*a, **kw):
            calls["kernel"] += 1
            return fn(*a, **kw)
        return inner

    for name in ("grr_contract_dense", "grr_contract"):
        monkeypatch.setattr(tgrr, name, wrap(getattr(tgrr, name)))
    rng = np.random.default_rng(1)
    w = rng.normal(0, 1, d).astype(np.float32)
    unset = pair.dot(torch.from_numpy(w)).numpy()
    assert calls["kernel"] > 0
    calls["kernel"] = 0
    monkeypatch.setenv("PHOTON_ML_TPU_GRR", "0")
    off = pair.dot(torch.from_numpy(w)).numpy()
    assert calls["kernel"] > 0
    np.testing.assert_array_equal(unset, off)
    np.testing.assert_allclose(off, np.asarray(ref.dot(jnp.asarray(w))),
                               rtol=1e-5, atol=1e-5)


def test_fleet_trio_builds_equal_contexts(monkeypatch):
    from photon_ml_tpu.parallel import fleet as jfleet

    from photon_ml_torch.parallel import fleet as tfleet

    monkeypatch.setenv("PHOTON_FLEET_NUM_HOSTS", "3")
    monkeypatch.setenv("PHOTON_FLEET_HOST_ID", "2")
    monkeypatch.setenv("PHOTON_FLEET_COORDINATOR", "127.0.0.1:9")
    monkeypatch.setattr(tfleet, "_ACTIVE", None)
    monkeypatch.setattr(jfleet, "_ACTIVE", None)
    t = tfleet.initialize_from_env()
    j = jfleet.initialize_from_env()
    assert (t.host_id, t.n_hosts, t.transport, t.coordinator) == (
        j.host_id, j.n_hosts, j.transport, j.coordinator) == (
        2, 3, "tcp", "127.0.0.1:9")
    monkeypatch.setattr(tfleet, "_ACTIVE", None)
    monkeypatch.setattr(jfleet, "_ACTIVE", None)
    monkeypatch.setenv("PHOTON_FLEET_NUM_HOSTS", "1")
    assert tfleet.initialize_from_env() is None
    assert jfleet.initialize_from_env() is None


def test_distributed_init_reads_the_reference_trio(monkeypatch):
    """The training drivers of both packages read the same three names
    (the reference hands them to ``jax.distributed.initialize``); the
    port joins a world of one gloo process on the given address, returns
    at once once a group exists, and refuses a larger world without an
    address rather than guessing one."""
    import ast
    import inspect
    import socket

    import torch.distributed as dist
    from photon_ml_tpu.cli import game_training_driver as jdrv

    from photon_ml_torch.cli import game_training_driver as tdrv

    def names(fn):
        return {n.args[0].value for n in ast.walk(ast.parse(
            inspect.getsource(fn))) if isinstance(n, ast.Call)
            and getattr(n.func, "id", None) == "read_env"}

    trio = {"JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"}
    assert names(jdrv.distributed_init_from_env) == trio
    assert names(tdrv.distributed_init_from_env) == trio
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", f"127.0.0.1:{port}")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    assert not dist.is_initialized()
    try:
        assert tdrv.distributed_init_from_env("cpu") is True
        assert dist.get_backend() == "gloo"
        assert (dist.get_world_size(), dist.get_rank()) == (1, 0)
        assert tdrv.distributed_init_from_env("cpu") is False
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="JAX_COORDINATOR_ADDRESS"):
        tdrv.distributed_init_from_env("cpu")
    assert not dist.is_initialized()
