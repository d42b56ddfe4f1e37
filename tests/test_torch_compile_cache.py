"""The kernel build cache (``photon_ml_torch.cache.compile_cache``).

The counterpart of the reference's persistent XLA compilation cache is
the directory the CUDA kernel libraries are built into and loaded from
(``kernels._build``).  ``enable_compilation_cache`` behaves as the
reference's: the ``PHOTON_ML_TPU_COMPILE_CACHE`` default (registered
with the reference's description), a no-op when neither is set,
idempotence, and a warning that keeps the default where the directory
cannot be made.  The drivers, the estimator and the server call it with
their config's ``compilation_cache_dir`` where the reference's do.
Building into the directory needs ``nvcc``: that case is marked
``cuda``.
"""

from __future__ import annotations

import logging

import pytest
import torch

from photon_ml_torch.cache import compile_cache
from photon_ml_torch.config import (
    CoordinateConfig,
    CoordinateKind,
    OptimizerSettings,
    ScoringConfig,
    ServingConfig,
    TaskType,
    TrainingConfig,
)
from photon_ml_torch.kernels import _build
from test_torch_training import jax_fresh_caches  # noqa: F401  (C5)

ENV = "PHOTON_ML_TPU_COMPILE_CACHE"


@pytest.fixture(autouse=True)
def fresh_cache_state(monkeypatch):
    """Each case starts from the default build directory, with the
    environment variable unset, and leaves the process as it was."""
    monkeypatch.setattr(_build, "_build_dir", None)
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    monkeypatch.delenv(ENV, raising=False)


def test_env_var_matches_reference_registry():
    from photon_ml_tpu import config as jconfig
    from photon_ml_tpu.cache import compile_cache as jcache

    from photon_ml_torch import config as tconfig

    assert compile_cache.ENV_VAR == jcache.ENV_VAR == ENV
    assert tconfig.SANCTIONED_ENV[ENV] == jconfig.SANCTIONED_ENV[ENV]


def test_noop_when_unset():
    assert compile_cache.enable_compilation_cache() is None
    assert compile_cache.enable_compilation_cache(None) is None
    assert _build.build_dir() == _build.BUILD_DIR
    assert _build.library_path("gather_rowsum").parent == _build.BUILD_DIR


def test_env_default_and_explicit_dir(tmp_path, monkeypatch):
    monkeypatch.setenv(ENV, str(tmp_path / "from_env"))
    got = compile_cache.enable_compilation_cache()
    assert got == str(tmp_path / "from_env" / "kernels")
    assert _build.build_dir() == tmp_path / "from_env" / "kernels"
    assert (tmp_path / "from_env" / "kernels").is_dir()
    # An explicit directory wins over the environment.
    got = compile_cache.enable_compilation_cache(str(tmp_path / "cfg"))
    assert got == str(tmp_path / "cfg" / "kernels")
    assert _build.build_dir() == tmp_path / "cfg" / "kernels"


def test_idempotent(tmp_path, caplog):
    with caplog.at_level(logging.INFO, logger=compile_cache.__name__):
        first = compile_cache.enable_compilation_cache(str(tmp_path))
        second = compile_cache.enable_compilation_cache(str(tmp_path))
    assert first == second == str(tmp_path / "kernels")
    assert [r.getMessage() for r in caplog.records].count(
        f"kernel build cache at {first}") == 1
    assert _build.build_dir() == tmp_path / "kernels"


def test_unusable_dir_warns_and_keeps_the_default(tmp_path, caplog):
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    with caplog.at_level(logging.WARNING, logger=compile_cache.__name__):
        got = compile_cache.enable_compilation_cache(str(blocker / "c"))
    assert got is None
    assert _build.build_dir() == _build.BUILD_DIR
    assert any("kernel build cache unavailable" in r.getMessage()
               for r in caplog.records)
    # An earlier good directory stays in effect too.
    good = compile_cache.enable_compilation_cache(str(tmp_path / "ok"))
    assert compile_cache.enable_compilation_cache(str(blocker / "c")) is None
    assert str(_build.build_dir()) == good


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_library_path_under_configured_dir(name, tmp_path):
    default = _build.library_path(name)
    kdir = compile_cache.enable_compilation_cache(str(tmp_path))
    path = _build.library_path(name)
    assert str(path.parent) == kdir and path.name == default.name
    # A library already in the directory is not built again: nothing
    # is started and no build is reported.
    path.write_bytes(b"")
    builds = []
    _build.add_build_listener(builds.append)
    try:
        assert _build._start_build(name) is None
        assert _build.build_all([name]) == [path]
    finally:
        _build.remove_build_listener(builds.append)
    assert builds == []


def _training_config(**kw) -> TrainingConfig:
    return TrainingConfig(
        task_type=TaskType.LOGISTIC_REGRESSION,
        coordinates=[CoordinateConfig(
            name="g", kind=CoordinateKind.FIXED_EFFECT, feature_shard="f",
            optimizer=OptimizerSettings())],
        update_sequence=["g"], device="cpu", **kw)


class _Called(Exception):
    pass


def _recorder(calls):
    def enable(*args):
        calls.append(args)
        raise _Called
    return enable


def test_drivers_enable_the_cache(tmp_path, monkeypatch):
    """Each driver calls ``enable_compilation_cache`` first, with its
    config's ``compilation_cache_dir`` (the indexing driver, which has
    no config, with none: the environment's default)."""
    from photon_ml_torch.cli import (
        feature_indexing_driver,
        game_scoring_driver,
        game_training_driver,
    )

    cache = str(tmp_path / "cache")
    calls: list = []
    for mod in (game_training_driver, game_scoring_driver,
                feature_indexing_driver):
        monkeypatch.setattr(mod, "enable_compilation_cache",
                            _recorder(calls))
    with pytest.raises(_Called):
        game_training_driver.run(_training_config(
            compilation_cache_dir=cache))
    with pytest.raises(_Called):
        game_scoring_driver.run(ScoringConfig(
            input_path="in.jsonl", model_dir="m",
            output_path=str(tmp_path / "s.npz"),
            compilation_cache_dir=cache, device="cpu"))
    with pytest.raises(_Called):
        feature_indexing_driver.run("in.jsonl", str(tmp_path / "maps"))
    assert calls == [(cache,), (cache,), ()]


def test_estimator_and_server_enable_the_cache(tmp_path, monkeypatch):
    import photon_ml_torch.cache as cache_pkg
    from photon_ml_torch.estimators import game_estimator
    from photon_ml_torch.serving.server import ModelServer

    cache = str(tmp_path / "cache")
    calls: list = []
    monkeypatch.setattr(game_estimator, "enable_compilation_cache",
                        _recorder(calls))
    with pytest.raises(_Called):
        game_estimator.GameEstimator(_training_config(
            compilation_cache_dir=cache)).fit(None)
    monkeypatch.setattr(cache_pkg, "enable_compilation_cache",
                        _recorder(calls))
    server = ModelServer(ServingConfig(
        model_dir=str(tmp_path / "m"), port=0, device="cpu",
        compilation_cache_dir=cache))
    try:
        with pytest.raises(_Called):
            server.start()
    finally:
        server.stop()
    assert calls == [(cache,), (cache,)]


@pytest.mark.cuda
def test_kernels_build_into_and_load_from_the_cache(tmp_path):
    """On the card: a kernel builds into the configured directory once,
    and a second build of it builds nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs nvcc and a CUDA device")
    from photon_ml_torch.analysis.guards import count_compiles

    kdir = compile_cache.enable_compilation_cache(str(tmp_path))
    with count_compiles() as first:
        paths = _build.build_all(["gather_rowsum"])
    with count_compiles() as again:
        _build.build_all(["gather_rowsum"])
    assert [str(p.parent) for p in paths] == [kdir] and paths[0].is_file()
    assert first.count == 1 and again.count == 0
