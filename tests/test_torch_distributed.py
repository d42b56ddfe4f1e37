"""The port's multi-process reduction over ``torch.distributed`` (gloo)
against the JAX package.

The reference's own two-process test cannot run on this box (its jaxlib
has no multi-process CPU collectives), so the port's two gloo ranks are
held against the reference's single-process 8-device mesh:

- **The objective**: two ranks of a world of 2 each build 4 of the 8
  shards of the global grid (``shard_sparse_batch`` over the
  transposed ELL and GRR), and the ``DistributedGLMObjective``'s value,
  gradient, Hessian-vector product, Hessian diagonal and gathered
  scores equal across ranks bitwise and the reference's 8-device
  objective (value 1e-5 relative, vectors 1e-5·max).
- **The psum fleet**: ``distributed_init_from_env`` from the JAX
  package's three environment names, then ``fleet.initialize_from_env``
  gives the psum transport; a streamed L-BFGS fit on the 2 ranks is
  bitwise equal across ranks, within 5e-4 of the port's tcp fleet on
  the same workload and of the JAX package's single-process fit (the
  reference's own fleet-against-solo tolerance; its tcp fleet cannot run
  here: a reference worker process lacks the C1 alias).
- **The driver**: ``distributed_init: true`` with ``n_devices: 8`` on 2
  ranks (the fixed effect's 8 shards split 4 and 4 across the ranks):
  models bitwise equal across ranks and within 1e-3 of the
  single-process 8-shard fit.  With ``chunk_rows`` as well, each rank
  holds all 8 shards of its own chunks (3 chunks: rank 1 takes a
  sentinel step) and the psum fleet joins the chunk partials once:
  bitwise across ranks, within 1e-3 of the one-process chunked 8-shard
  fit and of the JAX package's.

Every worker is a port-only process (no jax) with a 120 s limit; the
test kills what it started.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np

from test_torch_fleet import (
    _LBFGS_D,
    _LBFGS_K,
    _LBFGS_N,
    _STREAM_WORKER,
    _jax_solo_stream,
    _run_fleet,
    _workload_src,
)
from test_torch_training import (  # noqa: F401  (C1, C5)
    jax_c1,
    jax_fresh_caches,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_world(script: str, world: int = 2, extra: dict | None = None
               ) -> list[dict]:
    """``world`` ranks of ``script`` joined through the JAX package's
    environment names; each prints one ``RESULT`` JSON line."""
    port = _free_port()
    procs = []
    try:
        for rank in range(world):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith(("PHOTON_FLEET_", "JAX_"))}
            env.update({"PML_REPO": _REPO,
                        "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                        "JAX_NUM_PROCESSES": str(world),
                        "JAX_PROCESS_ID": str(rank)})
            env.update(extra or {})
            procs.append(subprocess.Popen(
                [sys.executable, script], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        results = []
        for rank, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out, err = p.communicate()
                raise AssertionError(f"rank {rank} timed out:\n{err[-3000:]}")
            assert p.returncode == 0, (
                f"rank {rank} rc={p.returncode}\n{out[-2000:]}\n"
                f"{err[-3000:]}")
            lines = [ln for ln in out.splitlines()
                     if ln.startswith("RESULT ")]
            assert lines, f"rank {rank} printed no RESULT:\n{err[-2000:]}"
            results.append(json.loads(lines[-1][len("RESULT "):]))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _objective_data(n=803, d=300, k=6, seed=9):
    rng = np.random.default_rng(seed)
    cols = np.stack([np.sort(rng.choice(d, k, replace=False))
                     for _ in range(n)]).astype(np.int32)
    vals = rng.normal(0, 1, (n, k)).astype(np.float32)
    y = (rng.random(n) < 0.4).astype(np.float32)
    w = rng.normal(0, 0.3, d).astype(np.float32)
    v = rng.normal(0, 1, d).astype(np.float32)
    return [(c, x) for c, x in zip(cols, vals)], y, d, w, v


_OBJECTIVE_WORKER = r'''
import json, os, sys
sys.path.insert(0, os.environ["PML_REPO"])
sys.path.insert(0, os.path.join(os.environ["PML_REPO"], "tests"))
import numpy as np
import torch
import torch.distributed as dist

from photon_ml_torch.cli.game_training_driver import distributed_init_from_env
from photon_ml_torch.data.normalization import NormalizationContext
from photon_ml_torch.ops import losses
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.regularization import RegularizationContext
from photon_ml_torch.parallel import (
    DistributedGLMObjective, data_parallel_mesh, shard_sparse_batch)

assert distributed_init_from_env("cpu")
assert dist.get_backend() == "gloo" and dist.get_world_size() == 2
exec(open(os.environ["PML_DATA"]).read())
rows, y, d, w, v = _objective_data()
out = {"jax_loaded": any(m == "jax" or m.startswith(("jax.", "photon_ml_tpu"))
                         for m in sys.modules)}
for layout in ("colmajor", "grr"):
    mesh = data_parallel_mesh(8, device="cpu")
    assert mesh.local_size == 4 and mesh.size == 8
    b = shard_sparse_batch(rows, d, y, mesh, layout=layout)
    o = DistributedGLMObjective(GLMObjective(
        loss=losses.LOGISTIC, reg=RegularizationContext.l2(0.7),
        norm=NormalizationContext.identity()), mesh)
    tw, tv = torch.from_numpy(w), torch.from_numpy(v)
    f, g = o.value_and_gradient(tw, b)
    out[layout] = {
        "value": float(o.value(tw, b)), "vg_value": float(f),
        "grad": g.tolist(), "hvp": o.hessian_vector(tw, tv, b).tolist(),
        "hdiag": o.hessian_diagonal(tw, b).tolist(),
        "x_dot": b.gather_rows(o.x_dot(tv, b)).tolist()}
dist.destroy_process_group()
print("RESULT " + json.dumps(out), flush=True)
'''


def test_two_rank_objective_matches_reference_8_device_mesh(jax_c1,
                                                             tmp_path):
    """Two gloo ranks × 4 local shards == the reference's one-process
    8-device objective; the ranks agree bitwise."""
    import inspect

    import jax.numpy as jnp

    from photon_ml_tpu.data.normalization import NormalizationContext as JN
    from photon_ml_tpu.ops import losses as jl
    from photon_ml_tpu.ops.objective import GLMObjective as JO
    from photon_ml_tpu.ops.regularization import RegularizationContext as JR
    from photon_ml_tpu.parallel import DistributedGLMObjective as JDO
    from photon_ml_tpu.parallel.mesh import data_parallel_mesh as jmesh
    from photon_ml_tpu.parallel.mesh import shard_sparse_batch as jshard

    data = tmp_path / "data.py"
    data.write_text("import numpy as np\n"
                    + inspect.getsource(_objective_data))
    script = tmp_path / "objective_worker.py"
    script.write_text(_OBJECTIVE_WORKER)
    r0, r1 = _run_world(str(script), extra={"PML_DATA": str(data)})
    assert not r0["jax_loaded"] and not r1["jax_loaded"]
    rows, y, d, w, v = _objective_data()
    for layout in ("colmajor", "grr"):
        assert r0[layout] == r1[layout], layout       # bitwise across ranks
        jb = jshard(rows, d, y, jmesh(8), layout=layout)
        jo = JDO(objective=JO(loss=jl.LOGISTIC, reg=JR.l2(0.7),
                              norm=JN.identity()), mesh=jmesh(8))
        ref = jax_c1.jit(lambda w_, v_, b_: (
            jo.value(w_, b_), jo.value_and_gradient(w_, b_)[1],
            jo.hessian_vector(w_, v_, b_), jo.hessian_diagonal(w_, b_),
            jo.x_dot(v_, b_)))(jnp.asarray(w), jnp.asarray(v), jb)
        got = r0[layout]
        np.testing.assert_allclose(got["value"], float(ref[0]), rtol=1e-5)
        np.testing.assert_allclose(got["vg_value"], float(ref[0]),
                                   rtol=1e-5)
        for key, want in zip(("grad", "hvp", "hdiag", "x_dot"), ref[1:]):
            want = np.asarray(want)
            np.testing.assert_allclose(
                np.asarray(got[key]), want, rtol=1e-5,
                atol=1e-5 * float(np.abs(want).max()), err_msg=key)


def test_probe_cpu_multiprocess_collectives_verdict():
    """The probe's two gloo workers all-reduce here, its verdict is
    cached, and its marker is the JAX package's jaxlib text."""
    from photon_ml_tpu.parallel import fleet as jfleet

    from photon_ml_torch.parallel import fleet

    assert fleet.probe_cpu_multiprocess_collectives(timeout_s=TIMEOUT_S)
    assert fleet._PROBE_RESULT is True
    assert fleet.probe_cpu_multiprocess_collectives()
    assert fleet.MULTIPROC_UNSUPPORTED_MARKER == \
        jfleet.MULTIPROC_UNSUPPORTED_MARKER


_PSUM_PREAMBLE = r'''
from photon_ml_torch.cli.game_training_driver import distributed_init_from_env
assert distributed_init_from_env("cpu")
'''


def test_psum_fleet_bitwise_across_ranks_and_matches_tcp_fleet(tmp_path):
    """The streamed L-BFGS drill of ``tests/test_torch_fleet.py`` as a
    psum fleet of 2 gloo ranks: bitwise across ranks, the reduce count
    of the tcp fleet, and within 5e-4 of the tcp fleet and of the JAX
    package's single-process fit."""
    src = _workload_src(
        _STREAM_WORKER, N_D_K=repr((_LBFGS_N, _LBFGS_D, _LBFGS_K)),
        N_CHUNKS="3")
    src = src.replace("    fleet.initialize_from_env()\n",
                      _PSUM_PREAMBLE.replace("\n", "\n    ")
                      + "ctx = fleet.initialize_from_env()\n"
                      "    assert ctx.transport == 'psum'\n", 1)
    psum = tmp_path / "psum_worker.py"
    psum.write_text(src)
    results = _run_world(str(psum))
    assert [r["host"] for r in results] == [0, 1]
    assert [r["owned"] for r in results] == [[0, 1], [2]]
    assert not any(r["jax_loaded"] for r in results)
    w = [np.asarray(r["w"], np.float32) for r in results]
    np.testing.assert_array_equal(w[0], w[1])
    assert results[0]["seq"] == results[1]["seq"] > 0

    tcp = tmp_path / "tcp_worker.py"
    tcp.write_text(_workload_src(
        _STREAM_WORKER, N_D_K=repr((_LBFGS_N, _LBFGS_D, _LBFGS_K)),
        N_CHUNKS="3"))
    tcp_results, coord = _run_fleet(str(tcp), 2)
    assert results[0]["seq"] == coord.reduces
    np.testing.assert_allclose(
        w[0], np.asarray(tcp_results[0]["w"], np.float32), atol=5e-4,
        rtol=0)
    np.testing.assert_allclose(w[0], _jax_solo_stream(3), atol=5e-4, rtol=0)


_DRIVER_WORKER = r'''
import json, os, sys
sys.path.insert(0, os.environ["PML_REPO"])
import numpy as np
import torch.distributed as dist
from photon_ml_torch.cli import game_training_driver as drv

cfg = json.load(open(os.environ["PML_CFG"]))
drv.main(["--config", os.environ["PML_CFG"], "--device", "cpu"])
rank = int(os.environ["JAX_PROCESS_ID"])
assert not dist.is_initialized()        # the driver's group is gone
print("RESULT " + json.dumps({"rank": rank, "out": cfg["output_dir"]}),
      flush=True)
'''


def _driver_dataset(path, n=400, d=12, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, d)).astype(np.float32)
    y = (x @ rng.normal(0, 1, d) + rng.normal(0, 0.3, n) > 0)
    with open(path, "w") as f:
        for i in range(n):
            feats = " ".join(f"{j + 1}:{x[i, j]:.6f}" for j in range(d))
            f.write(f"{int(y[i])} {feats}\n")


def _driver_base(data) -> dict:
    return {
        "input_path": str(data), "input_format": "libsvm",
        "task_type": "LOGISTIC_REGRESSION",
        "coordinates": [{"name": "global", "kind": "FIXED_EFFECT",
                         "feature_shard": "global",
                         "optimizer": {"max_iters": 40, "reg_weight": 1.0}}],
        "update_sequence": ["global"], "n_devices": 8,
        "sparse_layout": "COLMAJOR"}


def _global_means(out_dir) -> np.ndarray:
    from photon_ml_torch.io.model_io import load_game_model

    model = load_game_model(str(out_dir))[0]
    return model.models["global"].coefficients.means.numpy()


def _driver_world(tmp_path, cfg: dict) -> list[np.ndarray]:
    """``cfg`` with ``distributed_init`` on 2 gloo ranks → each rank's
    fixed-effect coefficients (from its ``host_NNN`` tree)."""
    dist_cfg = {**cfg, "output_dir": str(tmp_path / "dist"),
                "distributed_init": True}
    (tmp_path / "dist.json").write_text(json.dumps(dist_cfg))
    script = tmp_path / "driver_worker.py"
    script.write_text(_DRIVER_WORKER)
    results = _run_world(str(script), extra={
        "PML_CFG": str(tmp_path / "dist.json")})
    assert [r["rank"] for r in results] == [0, 1]
    return [_global_means(tmp_path / "dist" / f"host_{r:03d}" / "model")
            for r in (0, 1)]


def _solo_driver(tmp_path, cfg: dict) -> np.ndarray:
    from photon_ml_torch.cli import game_training_driver as drv

    solo_cfg = {**cfg, "output_dir": str(tmp_path / "solo")}
    (tmp_path / "solo.json").write_text(json.dumps(solo_cfg))
    drv.main(["--config", str(tmp_path / "solo.json"), "--device", "cpu"])
    return _global_means(tmp_path / "solo" / "model")


def test_driver_distributed_init_two_ranks(tmp_path):
    """The training driver with ``distributed_init`` and ``n_devices: 8``
    on 2 gloo ranks: each writes its host tree, the ranks' models are
    bitwise equal and within 1e-3 of the one-process 8-shard fit."""
    data = tmp_path / "train.libsvm"
    _driver_dataset(data)
    base = _driver_base(data)
    solo = _solo_driver(tmp_path, base)
    w0, w1 = _driver_world(tmp_path, base)
    np.testing.assert_array_equal(w0, w1)
    np.testing.assert_allclose(w0, solo, atol=1e-3, rtol=1e-3)


def test_driver_distributed_init_chunked_mesh_two_ranks(jax_c1, tmp_path):
    """``chunk_rows`` with ``n_devices: 8`` and ``distributed_init`` on 2
    gloo ranks: 400 rows in 3 chunks of 136 (the device grid), rank 0
    streams chunks 0-1 and rank 1 chunk 2 and a sentinel step; each
    chunk's 8 pieces are summed within the rank and the psum fleet sums
    the ranks once.  The ranks' models are bitwise equal and within
    1e-3 of the one-process chunked 8-shard fit and of the JAX
    package's chunked 8-device fit."""
    from photon_ml_tpu.cli import game_training_driver as jdrv

    data = tmp_path / "train.libsvm"
    _driver_dataset(data)
    cfg = {**_driver_base(data), "chunk_rows": 136}
    solo = _solo_driver(tmp_path, cfg)
    jax_cfg = {**cfg, "output_dir": str(tmp_path / "jax")}
    (tmp_path / "jax.json").write_text(json.dumps(jax_cfg))
    jdrv.main(["--config", str(tmp_path / "jax.json")])
    ref = _global_means(tmp_path / "jax" / "model")
    w0, w1 = _driver_world(tmp_path, cfg)
    np.testing.assert_array_equal(w0, w1)
    np.testing.assert_allclose(w0, solo, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(w0, ref, atol=1e-3, rtol=1e-3)
