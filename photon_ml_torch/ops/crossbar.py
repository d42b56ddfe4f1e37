"""In-tile crossbar: a static permutation of a [128,128] tile as three
lane gathers with two transposes between them.

Counterpart of ``photon_ml_tpu/ops/crossbar.py`` (numpy only, copied):
``route_tile`` decomposes a permutation into the three-stage Clos form

    out = L3 ∘ T ∘ L2 ∘ T ∘ L1

(L_i lane permutations, T the tile transpose) from a proper 128-edge
coloring of the (src_row, dst_row) bipartite multigraph (König), computed
by Euler splitting in C++ (``native.pml_edge_color``) with a Python
fallback.  The GRR plan builder (``data.grr``) routes every supertile
with it; the kernels (``ops.grr_kernel``) replay the routes.
"""

from __future__ import annotations

import numpy as np

TILE = 128


def _edge_color_python(src: np.ndarray, dst: np.ndarray, n_left: int,
                       n_right: int, n_colors: int) -> np.ndarray:
    """Euler-split coloring, pure Python (small inputs / no toolchain)."""
    m = src.size
    color = np.zeros(m, np.int32)

    def split(edge_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        # Walk Euler circuits, alternating edges between two halves.
        # Bipartite ⇒ circuits have even length ⇒ both halves see every
        # vertex equally often, keeping degrees even for recursion.
        adj: dict[int, list[int]] = {}
        other = {}
        for e in edge_ids:
            u, w = int(src[e]), n_left + int(dst[e])
            adj.setdefault(u, []).append(e)
            adj.setdefault(w, []).append(e)
            other[e] = (u, w)
        used = set()
        side = {}
        for e0 in edge_ids:
            if int(e0) in used:
                continue
            v = int(src[e0])
            s = 0
            while adj.get(v):
                e = adj[v].pop()
                if e in used:
                    continue
                used.add(e)
                side[e] = s
                s ^= 1
                u, w = other[e]
                v = w if v == u else u
        a = np.array([e for e in edge_ids if side[int(e)] == 0],
                     dtype=edge_ids.dtype)
        b = np.array([e for e in edge_ids if side[int(e)] == 1],
                     dtype=edge_ids.dtype)
        return a, b

    levels = int(n_colors).bit_length() - 1
    ranges = [np.arange(m, dtype=np.int64)]
    for level in range(levels):
        nxt = []
        bit = 1 << (levels - 1 - level)
        for ids in ranges:
            if ids.size == 0:
                continue
            a, b = split(ids)
            color[b] |= bit
            nxt.extend((a, b))
        ranges = nxt
    return color


def edge_color(src: np.ndarray, dst: np.ndarray, n_left: int,
               n_right: int, n_colors: int) -> np.ndarray:
    """Proper n_colors-edge-coloring of a bipartite multigraph whose
    vertex degrees are all divisible by n_colors (a power of two)."""
    from photon_ml_torch.native import edge_color_native

    native = edge_color_native(src, dst, n_left, n_right, n_colors)
    if native is not None:
        return native
    return _edge_color_python(np.asarray(src, np.int64),
                              np.asarray(dst, np.int64),
                              n_left, n_right, n_colors)


def route_tile(dst_slot: np.ndarray) -> tuple[np.ndarray, np.ndarray,
                                              np.ndarray]:
    """Route one [128,128] tile permutation into (g1, g2, g3).

    Args:
      dst_slot: int array [128,128]; ``dst_slot[r, l]`` is the flat
        destination slot (dr*128+dl) of the element at source (r, l).
        Must be a bijection on 0..16383.

    Returns:
      (g1, g2, g3) int32 [128,128] lane-gather index arrays such that

        x1  = take_along_axis(x,    g1, axis=1)
        x2t = take_along_axis(x1.T, g2, axis=1)
        out = take_along_axis(x2t.T, g3, axis=1)

      applies the permutation: out[dr, dl] == x[r, l].
    """
    d = np.asarray(dst_slot, np.int64)
    if d.shape != (TILE, TILE):
        raise ValueError(f"expected [{TILE},{TILE}], got {d.shape}")
    flat = d.reshape(-1)
    if not np.array_equal(np.sort(flat), np.arange(TILE * TILE)):
        raise ValueError("dst_slot is not a bijection on the tile")

    src_row = np.repeat(np.arange(TILE, dtype=np.int32), TILE)
    src_lane = np.tile(np.arange(TILE, dtype=np.int32), TILE)
    dst_row = (flat // TILE).astype(np.int32)
    dst_lane = (flat % TILE).astype(np.int32)

    color = edge_color(src_row, dst_row, TILE, TILE, TILE)

    # Stage 1: x1[r, c] = x[r, lane of the edge with color c at row r].
    g1 = np.empty((TILE, TILE), np.int32)
    g1[src_row, color] = src_lane
    # Stage 2 (on x1.T): x2t[c, r2] = x1t[c, src row of the color-c edge
    # into dst row r2] — within color c the src→dst row map is a
    # perfect matching, so this is a true lane permutation.
    g2 = np.empty((TILE, TILE), np.int32)
    g2[color, dst_row] = src_row
    # Stage 3: out[r2, l2] = x2[r2, color of the edge landing at l2].
    g3 = np.empty((TILE, TILE), np.int32)
    g3[dst_row, dst_lane] = color
    return g1, g2, g3


def apply_route_numpy(x: np.ndarray, g1: np.ndarray, g2: np.ndarray,
                      g3: np.ndarray) -> np.ndarray:
    """Reference executor for tests (mirrors the kernel's micro-stages)."""
    x1 = np.take_along_axis(x, g1, axis=1)
    x2t = np.take_along_axis(x1.T, g2, axis=1)
    return np.take_along_axis(x2t.T, g3, axis=1)
