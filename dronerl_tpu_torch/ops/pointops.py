"""Batched point gathers and scatters with jnp indexing semantics.

Every function takes a leading env axis E. jnp gathers wrap negative
indices once and clamp the rest into range; torch raises on both, so the
wrap-and-clamp is explicit (:func:`wrap_clamp`). jnp boolean scatters
drop out-of-bounds writers and let the last writer win; torch's
``index_put_`` leaves the winner of repeated indices undefined on CUDA,
so :func:`flag_mask_scatter_order` writes the drones in order instead.
"""

import torch


def wrap_clamp(idx: torch.Tensor, size: int) -> torch.Tensor:
    """jnp gather index normalisation: negatives wrap, then clamp."""
    idx = torch.where(idx < 0, idx + size, idx)
    return idx.clamp(0, size - 1)


def point_lookup(grid: torch.Tensor, rows: torch.Tensor,
                 cols: torch.Tensor) -> torch.Tensor:
    """``grid[e, rows[e], cols[e]]`` for in-range (E, M) indices → (E, M)."""
    e, _, w = grid.shape
    flat = (rows.long() * w + cols.long())
    return grid.reshape(e, -1).gather(1, flat)


def _cells(h: int, w: int, device) -> torch.Tensor:
    return torch.arange(h * w, device=device)


def flag_mask(rows: torch.Tensor, cols: torch.Tensor, flags: torch.Tensor,
              h: int, w: int) -> torch.Tensor:
    """(E, h, w) bool: True at (rows[i], cols[i]) where flags[i] (OR).

    Writers outside the board match no cell and are dropped.
    """
    e = rows.shape[0]
    inside = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    flat = rows.long() * w + cols.long()
    hit = (flat[:, :, None] == _cells(h, w, rows.device)) & (
        flags & inside)[:, :, None]
    return hit.any(dim=1).reshape(e, h, w)


def flag_mask_scatter_order(rows: torch.Tensor, cols: torch.Tensor,
                            flags: torch.Tensor, h: int,
                            w: int) -> torch.Tensor:
    """Exact ``zeros.at[rows, cols].set(flags)``: negatives wrap once,
    out-of-bounds writers drop, and the LAST writer to a cell wins."""
    e, n = rows.shape
    rows = torch.where(rows < 0, rows + h, rows)
    cols = torch.where(cols < 0, cols + w, cols)
    valid = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    flat = rows.long() * w + cols.long()
    cells = _cells(h, w, rows.device)
    mask = torch.zeros((e, h * w), dtype=torch.bool, device=rows.device)
    for i in range(n):
        writes = (flat[:, i:i + 1] == cells) & valid[:, i:i + 1]
        mask = torch.where(writes, flags[:, i:i + 1], mask)
    return mask.reshape(e, h, w)


def place_values(grid: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """``grid.at[rows, cols].set(values)`` for DISTINCT in-range cells.

    Distinctness holds for spawn targets and for drone cells in every
    reachable state, so the scatter has no repeated index.
    """
    e, _, w = grid.shape
    flat = rows.long() * w + cols.long()
    out = grid.reshape(e, -1).clone()
    out.scatter_(1, flat, values.to(grid.dtype).expand_as(flat))
    return out.reshape(grid.shape)
