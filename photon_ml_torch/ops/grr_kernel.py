"""The GRR contraction kernels: execute a compiled gather-route-reduce plan.

Counterpart of ``photon_ml_tpu/ops/grr_kernel.py``.  There two Pallas
kernels ran the plan on the TPU and two jnp functions were the semantic
reference.  Here:

- ``grr_contract_dense`` (B2, counterpart of ``grr_contract_kernel_dense``)
  runs a dense-grid plan: tiles gw-major over the full (gw × ow_p) grid,
  the ow reduction a sum over gw.  Returns ``[n_ow_p, 128/cap, 128]``.
- ``grr_contract`` (B3, counterpart of ``grr_contract_kernel``) runs a
  plan whose supertiles are sorted by (ow, gw).  Returns
  ``[n_ow, 128/cap, 128]``.

On CUDA tensors each dispatcher launches its hand-written kernel from
``csrc/grr_contract.cu`` (built with nvcc for ``sm_90a``, loaded with
ctypes, see ``kernels/_build.py``) and counts the launch in its
``launches`` attribute; a CUDA tensor never falls back to the plain
version.  On CPU tensors it runs the plain PyTorch version
(``grr_contract_dense_reference`` / ``grr_contract_reference``, mirrors
of ``grr_contract_jnp_dense`` / ``grr_contract_jnp``), which the tests
use and ``chip_smoke.py`` holds the kernels against on the card.

For output slot (r, l) of a supertile the three lane gathers compose to

    a = g3[r,l];  b = g2[a,r];  x3 = window[b, g1[b,a]];  c = x3 · vals[r,l]

and the tile's partial is ``partial[j,l] = Σ_{q<cap} c[q·(128/cap)+j, l]``.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

TILE = 128
SLOTS = TILE * TILE
DENSE_B = 4   # tiles per window id in a dense plan's ``gwg``
CAPS = (1, 2, 4, 8, 16, 32, 64, 128)


def tile_partials(table_t: Tensor, gw_of_st: Tensor, g1: Tensor,
                  g2: Tensor, g3: Tensor, vals: Tensor, cap: int) -> Tensor:
    """Per-supertile partials [n_st, 128/cap, 128] (``gw_of_st`` one
    window id a tile) — the three lane gathers with transposes between
    them, then the cap-plane sum."""
    group = TILE // cap
    wt = table_t[gw_of_st.long()]
    x1 = torch.gather(wt, 2, g1.long())
    x2t = torch.gather(x1.transpose(1, 2), 2, g2.long())
    x3 = torch.gather(x2t.transpose(1, 2), 2, g3.long())
    c = x3 * vals
    return c.reshape(-1, cap, group, TILE).sum(1)


def grr_contract_dense_reference(table_t: Tensor, g1: Tensor, g2: Tensor,
                                 g3: Tensor, vals: Tensor, n_ow_p: int,
                                 cap: int) -> Tensor:
    """Plain PyTorch version of B2 (``grr_contract_jnp_dense``)."""
    n_st_p = vals.shape[0]
    n_gw = n_st_p // n_ow_p
    gw_of_st = torch.arange(n_gw, device=vals.device).repeat_interleave(
        n_ow_p)
    partial = tile_partials(table_t, gw_of_st, g1, g2, g3, vals, cap)
    return partial.reshape(n_gw, n_ow_p, TILE // cap, TILE).sum(0)


def grr_contract_reference(table_t: Tensor, g1: Tensor, g2: Tensor,
                           g3: Tensor, vals: Tensor, gw_of_st: Tensor,
                           ow_of_st: Tensor, n_ow: int, cap: int) -> Tensor:
    """Plain PyTorch version of B3 (``grr_contract_jnp``)."""
    partial = tile_partials(table_t, gw_of_st, g1, g2, g3, vals, cap)
    out = torch.zeros((n_ow, TILE // cap, TILE), dtype=partial.dtype,
                      device=partial.device)
    return out.index_add_(0, ow_of_st.long(), partial)


def _check(name: str, table_t: Tensor, planes, vals: Tensor, maps,
           cap: int) -> None:
    if table_t.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 table_t and vals, got "
                        f"{table_t.dtype} and {vals.dtype}")
    if any(g.dtype != torch.int8 for g in planes):
        raise TypeError(f"{name} takes int8 route planes, got "
                        f"{[g.dtype for g in planes]}")
    if any(m.dtype != torch.int32 for m in maps):
        raise TypeError(f"{name} takes int32 tile maps, got "
                        f"{[m.dtype for m in maps]}")
    if table_t.dim() != 3 or tuple(table_t.shape[1:]) != (TILE, TILE):
        raise ValueError(f"table_t must be [n_gw, {TILE}, {TILE}], got "
                         f"{tuple(table_t.shape)}")
    n_st = vals.shape[0]
    shape = (n_st, TILE, TILE)
    if tuple(vals.shape) != shape or any(
            tuple(g.shape) != shape for g in planes):
        raise ValueError(f"{name}: vals and g1/g2/g3 must all be "
                         f"[n_st, {TILE}, {TILE}], got {tuple(vals.shape)} "
                         f"and {[tuple(g.shape) for g in planes]}")
    if cap not in CAPS:
        raise ValueError(f"cap must be a power of two ≤ 128, got {cap}")
    devices = {t.device for t in (table_t, vals, *planes, *maps)}
    if len(devices) != 1:
        raise ValueError(f"{name} inputs must share one device, got "
                         f"{sorted(map(str, devices))}")
    if table_t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table_t.device}")
    if table_t.device.type == "cuda":
        _check_layout(name, (table_t, vals, *planes, *maps))


def _check_layout(name: str, tensors) -> None:
    """What the CUDA kernel needs of its inputs' memory: contiguous, and
    16-byte aligned (its bulk copies and vector loads)."""
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}'s CUDA kernel takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}'s CUDA kernel takes 16-byte aligned "
                         f"tensors")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


_SM_COUNT: dict = {}


def _launch_shape(device: torch.device, n_tiles: int, cap: int
                  ) -> tuple[int, Tensor]:
    """(n_blocks, scratch) for a launch over ``n_tiles`` tiles: one tile
    range a block, at most one block an SM, and the scratch that holds
    the pieces of the windows whose runs two ranges share."""
    if device not in _SM_COUNT:
        _SM_COUNT[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    n_blocks = max(1, min(n_tiles, _SM_COUNT[device]))
    scratch = torch.empty(
        (n_blocks if n_blocks > 1 else 0, 2, TILE // cap, TILE),
        dtype=torch.float32, device=device)
    return n_blocks, scratch


def grr_contract_dense(table_t: Tensor, g1: Tensor, g2: Tensor, g3: Tensor,
                       vals: Tensor, gwg: Tensor, n_ow_p: int,
                       cap: int) -> Tensor:
    """B2: run a dense-grid plan → ``[n_ow_p, 128/cap, 128]``.

    Args:
      table_t: [n_gw, 128, 128] f32 — the zero-padded table as windows.
      g1, g2, g3: [n_st_p, 128, 128] i8 — route planes, tile
        ``gw·n_ow_p + ow``.
      vals: [n_st_p, 128, 128] f32 — values in final slot order.
      gwg: [n_st_p / 4] i32 — the window id of each group of 4 tiles.
    """
    _check("grr_contract_dense", table_t, (g1, g2, g3), vals, (gwg,), cap)
    n_st_p = vals.shape[0]
    if n_ow_p <= 0 or n_st_p % n_ow_p or n_ow_p % DENSE_B:
        raise ValueError(f"dense grid: n_st_p {n_st_p} must be n_gw x "
                         f"n_ow_p with n_ow_p {n_ow_p} a multiple of "
                         f"{DENSE_B}")
    if tuple(gwg.shape) != (n_st_p // DENSE_B,):
        raise ValueError(f"gwg must be [{n_st_p // DENSE_B}], got "
                         f"{tuple(gwg.shape)}")
    if table_t.device.type == "cpu":
        return grr_contract_dense_reference(table_t, g1, g2, g3, vals,
                                            n_ow_p, cap)
    out = torch.empty((n_ow_p, TILE // cap, TILE), dtype=torch.float32,
                      device=vals.device)
    from photon_ml_torch.kernels import _build

    lib = _build.load("grr_contract")
    n_gw = n_st_p // n_ow_p
    n_blocks, scratch = _launch_shape(vals.device, n_st_p, cap)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.grr_contract_dense_launch(
            table_t.data_ptr(), g1.data_ptr(), g2.data_ptr(), g3.data_ptr(),
            vals.data_ptr(), gwg.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n_gw, n_ow_p, cap, n_blocks, stream)
    _raise_on(err, "grr_contract_dense")
    grr_contract_dense.launches += 1
    return out


grr_contract_dense.launches = 0


def grr_contract(table_t: Tensor, g1: Tensor, g2: Tensor, g3: Tensor,
                 vals: Tensor, gw_of_st: Tensor, ow_of_st: Tensor,
                 first_of_ow: Tensor, n_ow: int, cap: int) -> Tensor:
    """B3: run a plan whose supertiles are sorted by (ow, gw) →
    ``[n_ow, 128/cap, 128]``.

    ``gw_of_st``/``ow_of_st`` [n_st] i32 pick each supertile's table and
    output window; ``first_of_ow`` [n_st] i32 marks where each ow run
    starts (the plan's invariant; the CUDA kernel reads the runs off the
    sorted ``ow_of_st``, and a window with no supertile comes out as zeros
    in both versions).
    """
    _check("grr_contract", table_t, (g1, g2, g3), vals,
           (gw_of_st, ow_of_st, first_of_ow), cap)
    n_st = vals.shape[0]
    if any(tuple(m.shape) != (n_st,)
           for m in (gw_of_st, ow_of_st, first_of_ow)):
        raise ValueError(f"gw_of_st, ow_of_st and first_of_ow must be "
                         f"[{n_st}]")
    if n_ow <= 0:
        raise ValueError(f"n_ow must be positive, got {n_ow}")
    if table_t.device.type == "cpu":
        return grr_contract_reference(table_t, g1, g2, g3, vals, gw_of_st,
                                      ow_of_st, n_ow, cap)
    out = torch.empty((n_ow, TILE // cap, TILE), dtype=torch.float32,
                      device=vals.device)
    from photon_ml_torch.kernels import _build

    lib = _build.load("grr_contract")
    n_blocks, scratch = _launch_shape(vals.device, n_st, cap)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = lib.grr_contract_launch(
            table_t.data_ptr(), g1.data_ptr(), g2.data_ptr(), g3.data_ptr(),
            vals.data_ptr(), gw_of_st.data_ptr(), ow_of_st.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), n_st, n_ow, cap, n_blocks,
            stream)
    _raise_on(err, "grr_contract")
    grr_contract.launches += 1
    return out


grr_contract.launches = 0
