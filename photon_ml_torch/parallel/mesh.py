"""Device meshes: the example-sharded and entity-sharded layouts.

Counterpart of ``photon_ml_tpu/parallel/mesh.py``.  The reference's
mesh is one SPMD program over devices whose partials meet in a
``lax.psum``.  Here a mesh is a plain list of shard devices:

- a sharded batch (``ShardedBatch``) is the ordered tuple of per-shard
  ``SparseBatch`` (or ``DenseBatch``) objects, each on its own device
  and each indexing only its own rows;
- the reduction is ``reduce_partials``: the shard partials added one
  after another, in shard order, on the mesh's first device (so a run
  repeats bitwise), then one ``torch.distributed.all_reduce`` (SUM)
  when an initialized world has more than one process;
- replicated values are one copy a distinct device (``replicate``).

Shards may share a device.  The reference raises when ``n_devices``
exceeds the devices present; PyTorch has no switch that splits one card
into several, so the port places shards round-robin over the visible
devices of the run's kind (all on ``cuda:0`` on a one-card host, all on
the CPU off the card, one card a shard on an eight-card host) and logs
one warning when shards share a device (ROADMAP C11).

Under an initialized ``torch.distributed`` world of W processes, a mesh
of ``n_devices`` shards gives each process ``n_devices / W`` of them:
process r holds shards r·L … r·L + L − 1 of the global grid, builds
only those, and the all-reduce joins the processes' partials.  A mesh
built with ``span_processes=False`` stays within its process (all
``n_devices`` shards local) and runs no collective of its own: the
chunk-streamed fit under a psum fleet splits its chunks across the
processes instead, and the fleet's reducer joins them.  Whether a
reduction or a gather crosses processes is the mesh's to say
(``spans_world``), never the world's alone.

Axis names: ``DATA_AXIS`` for example parallelism (the fixed effect),
``ENTITY_AXIS`` for entity-sharded random effects.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from photon_ml_torch.data.batch import DenseBatch, SparseBatch
from photon_ml_torch.data.colsorted import build_column_sorted
from photon_ml_torch.device import resolve_device

logger = logging.getLogger(__name__)

Tensor = torch.Tensor

DATA_AXIS = "data"
ENTITY_AXIS = "entity"

_warned_shared = False


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: this process's shard devices, in shard order.

    ``size`` is the global shard count (the local devices times the
    processes of the world); ``process_index`` places this process's
    shards in the global grid."""

    devices: tuple
    axis: str
    process_index: int = 0
    process_count: int = 1

    @property
    def size(self) -> int:
        return len(self.devices) * self.process_count

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def first_shard(self) -> int:
        """Global id of this process's first shard."""
        return self.process_index * len(self.devices)

    @property
    def device(self) -> torch.device:
        """Where the shard partials meet."""
        return self.devices[0]


def _world() -> tuple[int, int]:
    """(rank, world size) of an initialized ``torch.distributed`` group,
    else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _make_mesh(axis: str, n_devices: int | None, device=None,
               span_processes: bool = True) -> Mesh:
    global _warned_shared
    kind = resolve_device(device)
    rank, world = _world()
    offset = rank
    if not span_processes:
        rank, world = 0, 1
    visible = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if kind.type == "cuda" else [torch.device("cpu")])
    if n_devices is None:
        n_devices = len(visible) * world
    if n_devices <= 0:
        raise ValueError("n_devices must be positive")
    if n_devices % world:
        raise ValueError(
            f"n_devices {n_devices} is not divisible by the "
            f"{world}-process world")
    local = n_devices // world
    devices = tuple(visible[(offset * local + j) % len(visible)]
                    for j in range(local))
    if len(set(devices)) < len(devices) and not _warned_shared:
        _warned_shared = True
        logger.warning(
            "mesh: %d shards on %d %s device(s); shards share a device "
            "and run one after another", len(devices), len(set(devices)),
            kind.type)
    return Mesh(devices=devices, axis=axis, process_index=rank,
                process_count=world)


def data_parallel_mesh(n_devices: int | None = None, device=None,
                       span_processes: bool = True) -> Mesh:
    """1-D mesh of ``n_devices`` example shards (default: one a visible
    device of the run's kind, ``device``: default CUDA), across the
    processes of an initialized world unless ``span_processes`` is
    False."""
    return _make_mesh(DATA_AXIS, n_devices, device, span_processes)


def entity_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """1-D mesh for entity sharding: the random-effect blocks [E_b, cap,
    p] split their leading (entity) axis over it."""
    return _make_mesh(ENTITY_AXIS, n_devices, device)


def batch_spec() -> tuple:
    """The example axis is sharded (every batch leaf leads with it)."""
    return (DATA_AXIS,)


def replicated_spec() -> tuple:
    return ()


def padded_rows(n: int, n_devices: int) -> int:
    """Smallest multiple of ``n_devices`` ≥ n."""
    return ((n + n_devices - 1) // n_devices) * n_devices


def replicate(x: Tensor, mesh: Mesh) -> list:
    """``x`` for each local shard: one copy a distinct device (shards on
    one device share it)."""
    copies: dict = {}
    return [copies.setdefault(d, x.to(d)) for d in mesh.devices]


# -- collectives -----------------------------------------------------------


def all_reduce_sum(leaves: list, op=None) -> list:
    """Sum tensors across the processes of an initialized world (NCCL on
    CUDA, gloo on the CPU: the group's own backend), one call for all
    leaves of one dtype; a one-process world returns them unchanged.
    ``op`` (a ``torch.distributed.ReduceOp``) replaces the sum."""
    _, world = _world()
    if world == 1 or not leaves:
        return leaves
    out = list(leaves)
    by_dtype: dict = {}
    for i, t in enumerate(leaves):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        torch.distributed.all_reduce(
            flat, op=torch.distributed.ReduceOp.SUM if op is None else op)
        at = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[at:at + n].reshape(leaves[i].shape)
            at += n
    return out


def all_reduce_max(leaves: list) -> list:
    """``all_reduce_sum`` with the elementwise maximum."""
    return all_reduce_sum(leaves, op=torch.distributed.ReduceOp.MAX)


def all_gather_rows(t: Tensor) -> Tensor:
    """This process's rows → every process's rows, concatenated in rank
    order (the leading axis); a one-process world returns ``t``."""
    _, world = _world()
    if world == 1:
        return t
    src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(world)]
    torch.distributed.all_gather(parts, src)
    out = torch.cat(parts)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def spans_world(mesh: Mesh) -> bool:
    """Whether ``mesh``'s shards span the processes of the world, so its
    partials meet in a collective.  A mesh within one process
    (``span_processes=False``, or no world) runs none; a spanning mesh
    must match the world it was built in."""
    if mesh.process_count == 1:
        return False
    rank, world = _world()
    if (world, rank) != (mesh.process_count, mesh.process_index):
        raise RuntimeError(
            f"mesh spans {mesh.process_count} processes as rank "
            f"{mesh.process_index}, but the world has {world} with this "
            f"process as rank {rank}")
    return True


def reduce_partials(parts: list, mesh: Mesh):
    """Per-shard partial trees (a tensor or a tuple of tensors each) →
    their sum: added one after another in shard order on the mesh's
    first device, then summed across the world's processes when the
    mesh spans them."""
    dev = mesh.device

    def leaves_of(p):
        return list(p) if isinstance(p, tuple) else [p]

    total = [t.to(dev) for t in leaves_of(parts[0])]
    for p in parts[1:]:
        total = [a + b.to(dev) for a, b in zip(total, leaves_of(p))]
    if spans_world(mesh):
        total = all_reduce_sum(total)
    return tuple(total) if isinstance(parts[0], tuple) else total[0]


# -- sharded batches ---------------------------------------------------------


def _batch_to(batch, device: torch.device):
    """A batch with every tensor (and its layout) on ``device``."""
    if isinstance(batch, DenseBatch):
        return DenseBatch(**{f.name: getattr(batch, f.name).to(device)
                             for f in dataclasses.fields(batch)})
    cm = batch.colmajor
    if cm is not None:
        cm = dataclasses.replace(cm, tvals=cm.tvals.to(device),
                                 trows=cm.trows.to(device),
                                 vcol=cm.vcol.to(device))
    cs = batch.colsorted
    if cs is not None:
        cs = dataclasses.replace(cs, rows=cs.rows.to(device),
                                 vals=cs.vals.to(device),
                                 col_ptr=cs.col_ptr.to(device),
                                 tiles=cs.tiles.to(device))
    return dataclasses.replace(
        batch, values=batch.values.to(device),
        col_ids=batch.col_ids.to(device), labels=batch.labels.to(device),
        weights=batch.weights.to(device), offsets=batch.offsets.to(device),
        mask=batch.mask.to(device),
        grr=None if batch.grr is None else batch.grr.to(device),
        colmajor=cm, colsorted=cs)


@dataclasses.dataclass(frozen=True)
class ShardedBatch:
    """This process's shards of an example-sharded batch, in shard order:
    equal row counts, padding rows masked."""

    shards: tuple
    mesh: Mesh

    @property
    def dim(self) -> int:
        return self.shards[0].dim

    @property
    def rows_per_shard(self) -> int:
        return self.shards[0].n_padded

    @property
    def n_padded(self) -> int:
        """Rows over the whole mesh (every process's shards)."""
        return self.rows_per_shard * self.mesh.size

    def with_offsets(self, offsets) -> "ShardedBatch":
        """Global per-example offsets ([n] or [n_padded]) installed in
        each shard: zero-padded to the mesh's rows, this process's rows
        split a shard."""
        off = torch.as_tensor(offsets, dtype=torch.float32)
        if off.shape[0] < self.n_padded:
            off = torch.nn.functional.pad(
                off, (0, self.n_padded - off.shape[0]))
        per = self.rows_per_shard
        lo = self.mesh.first_shard * per
        return dataclasses.replace(self, shards=tuple(
            dataclasses.replace(
                b, offsets=off[lo + j * per: lo + (j + 1) * per].to(
                    b.labels.device))
            for j, b in enumerate(self.shards)))

    def gather_rows(self, local: Tensor) -> Tensor:
        """Per-example values of this process's rows → every row of the
        mesh ([n_padded]), on the mesh's first device: gathered from the
        world's processes when the mesh spans them."""
        local = local.to(self.mesh.device)
        return all_gather_rows(local) if spans_world(self.mesh) else local


def _local_ids(mesh: Mesh) -> range:
    return range(mesh.first_shard, mesh.first_shard + mesh.local_size)


def shard_batch(batch, mesh: Mesh) -> ShardedBatch:
    """Split a built batch into this process's example shards, each on
    its shard device.

    The batch must be padded so its rows divide the mesh size
    (``make_*_batch(pad_to=...)``); padding rows are masked.  A sparse
    batch with a transposed-ELL or GRR layout built over the whole batch
    is refused: its index arrays reference every row, and a shard sees
    only its own residuals (``shard_sparse_batch`` builds per-shard
    layouts)."""
    if isinstance(batch, SparseBatch) and (
            batch.colmajor is not None or batch.grr is not None):
        raise ValueError(
            "cannot shard a SparseBatch whose colmajor/GRR layout was "
            "built globally: its index arrays reference the whole "
            "batch, but each device shard sees only its local "
            "residuals.  Build with shard_sparse_batch(...) instead, "
            "which constructs per-shard layouts.")
    n = batch.n_padded
    n_dev = mesh.size
    if n % n_dev != 0:
        raise ValueError(
            f"batch rows {n} not divisible by mesh size {n_dev}; "
            f"build the batch with pad_to=ceil(n/{n_dev})*{n_dev}")
    per = n // n_dev

    def rows(b, lo, hi):
        if isinstance(b, DenseBatch):
            return DenseBatch(**{f.name: getattr(b, f.name)[lo:hi]
                                 for f in dataclasses.fields(b)})
        # A shard's rows are a slice of the batch's: its column-sorted
        # copy is built from them.
        return dataclasses.replace(
            b, values=b.values[lo:hi], col_ids=b.col_ids[lo:hi],
            labels=b.labels[lo:hi], weights=b.weights[lo:hi],
            offsets=b.offsets[lo:hi], mask=b.mask[lo:hi],
            colsorted=(None if b.colsorted is None else build_column_sorted(
                b.col_ids[lo:hi], b.values[lo:hi], b.dim)))

    shards = tuple(
        _batch_to(rows(batch, i * per, (i + 1) * per), d)
        for i, d in zip(_local_ids(mesh), mesh.devices))
    return ShardedBatch(shards=shards, mesh=mesh)


def _vrow_common(shard_cols: list, shard_vals: list, dim: int,
                col_capacity: int) -> int:
    """The common padded virtual-row count of per-shard transposed ELLs:
    the largest shard's count, ``vrow_pad``-ed (reference
    ``parallel/mesh.py:240-251``)."""
    from photon_ml_torch.ops.kernels import vrow_pad

    v_max = max(
        int((-(-np.bincount(
            np.asarray(c).reshape(-1)[np.asarray(v).reshape(-1) != 0],
            minlength=dim) // col_capacity)).sum())
        for c, v in zip(shard_cols, shard_vals))
    return vrow_pad(v_max, None)


def shard_sparse_batch(
    rows,
    dim: int,
    labels: np.ndarray,
    mesh: Mesh,
    weights: np.ndarray | None = None,
    offsets: np.ndarray | None = None,
    row_capacity: int | None = None,
    col_major: bool = True,
    col_capacity: int | None = None,
    layout: str | None = None,
    cache_dir: str | None = None,
) -> ShardedBatch:
    """Host ETL: split the examples into the mesh's contiguous row
    shards and build one ``SparseBatch`` a local shard, each with the
    contraction layout of its own rows, on its shard device.

    ``layout``: ``"grr"`` (congruent per-shard GRR plans,
    ``data.grr.build_sharded_grr_pairs``: B2/B3 on every shard),
    ``"colmajor"`` (default, = ``col_major=True``: per-shard transposed
    ELLs padded to a common virtual-row count, B1 on both sides) or
    ``"ell"`` (= ``col_major=False``).  ``cache_dir``: the GRR plan
    cache for the shard set.  This is the reference's one-time shuffle:
    after it every evaluation is per-shard compute and one reduction.
    """
    from photon_ml_torch.data.batch import make_sparse_batch
    from photon_ml_torch.data.colmajor import build_colmajor, choose_capacity
    from photon_ml_torch.data.grr import (
        build_sharded_grr_pairs,
        collect_spill_warnings,
    )
    from photon_ml_torch.data.sparse_rows import SparseRows

    if layout is None:
        layout = "colmajor" if col_major else "ell"
    if layout not in ("grr", "colmajor", "ell"):
        raise ValueError(f"unknown layout {layout!r}")
    n = len(labels)
    per = padded_rows(n, mesh.size) // mesh.size
    if row_capacity is not None:
        k = row_capacity
    elif isinstance(rows, SparseRows):
        k = max(rows.max_nnz, 1)
    else:
        k = max((len(c) for c, _ in rows), default=1)
    labels = np.asarray(labels)
    weights = np.ones(n) if weights is None else np.asarray(weights)
    offsets = np.zeros(n) if offsets is None else np.asarray(offsets)

    # One spill-warning scope over the shard builds and the plan set.
    with collect_spill_warnings():
        shards = []
        for i in _local_ids(mesh):
            lo, hi = i * per, min((i + 1) * per, n)
            lo = min(lo, hi)
            shards.append(make_sparse_batch(
                rows[lo:hi], dim, labels[lo:hi], weights=weights[lo:hi],
                offsets=offsets[lo:hi], row_capacity=k, pad_to=per,
                device="cpu"))
        cols = [b.col_ids.numpy() for b in shards]
        vals = [b.values.numpy() for b in shards]
        if layout == "colmajor":
            if col_capacity is None:
                all_cols = (rows.cols if isinstance(rows, SparseRows)
                            else np.concatenate(
                                [np.asarray(c) for c, _ in rows])
                            if len(rows) else np.zeros(0, np.int64))
                col_capacity = choose_capacity(
                    np.bincount(all_cols, minlength=dim))
            v_max = _vrow_common(cols, vals, dim, col_capacity)
            shards = [dataclasses.replace(b, colmajor=build_colmajor(
                c, v, dim, capacity=col_capacity, pad_vrows_to=v_max,
                device="cpu"), colsorted=None)
                for b, c, v in zip(shards, cols, vals)]
        elif layout == "grr":
            pairs = build_sharded_grr_pairs(cols, vals, dim,
                                            cache_dir=cache_dir)
            shards = [dataclasses.replace(b, grr=p, colsorted=None)
                      for b, p in zip(shards, pairs)]
    return ShardedBatch(
        shards=tuple(_batch_to(b, d) for b, d in zip(shards, mesh.devices)),
        mesh=mesh)


# -- entity sharding ---------------------------------------------------------


def shard_entity_blocks(blocks: list, mesh: Mesh) -> list:
    """Each bucket block's entity axis padded to a multiple of the mesh
    size with zero entities (zero data and mask: their solves converge
    at once and their coefficients are never gathered), so every shard
    holds an equal slice (``entity_slices``)."""
    out = []
    for b in blocks:
        e = b.shape[0]
        e_pad = padded_rows(max(e, 1), mesh.size)
        if e_pad != e:
            b = torch.cat([b, b.new_zeros((e_pad - e,) + tuple(b.shape[1:]))])
        out.append(b)
    return out


def entity_slices(t: Tensor, mesh: Mesh) -> list:
    """This process's entity shards of a padded block, each on its shard
    device (a view where the device is the block's)."""
    per = t.shape[0] // mesh.size
    return [t[i * per:(i + 1) * per].to(d)
            for i, d in zip(_local_ids(mesh), mesh.devices)]


def check_entity_chunk(arrays: dict, mesh: Mesh) -> None:
    """Every leaf of an entity chunk must split evenly over the mesh's
    shards (the streamed builder rounds its chunk sizes up to the grid)."""
    for k, a in arrays.items():
        if a.shape[0] % mesh.size != 0:
            raise ValueError(
                f"entity chunk leaf '{k}' has {a.shape[0]} entities, "
                f"not divisible by mesh size {mesh.size}; round the chunk "
                "size up to the mesh grid")


def place_entity_chunk(arrays: dict, mesh: Mesh | None, device=None) -> dict:
    """Host entity-chunk leaves (name → [C, ...]) → tensors: on
    ``device`` without a mesh, else on the mesh's first device after
    ``check_entity_chunk``; the chunk's solve splits its lanes over the
    shards (``entity_slices``).  The streamed random effect places its
    chunks through its pinned pipeline after the same check."""
    if mesh is not None:
        check_entity_chunk(arrays, mesh)
    dev = resolve_device(device) if mesh is None else mesh.device
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for k, a in arrays.items()}
