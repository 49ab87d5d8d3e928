"""Per-drone window cropping (batched gather)."""

import torch


def crop_windows(padded: torch.Tensor, center_x: torch.Tensor,
                 center_y: torch.Tensor, radius: int) -> torch.Tensor:
    """(E, M, 2r+1, 2r+1) windows of a pre-padded (E, P, P) grid.

    Centres are in padded coordinates; every window index must be in
    bounds (true for on-board drone coordinates).
    """
    e, _, side = padded.shape
    span = torch.arange(-radius, radius + 1, device=padded.device)
    rows = center_y.long()[:, :, None] + span                    # (E, M, w)
    cols = center_x.long()[:, :, None] + span                    # (E, M, w)
    flat = rows[:, :, :, None] * side + cols[:, :, None, :]      # (E, M, w, w)
    m, w = flat.shape[1], flat.shape[2]
    return padded.reshape(e, -1).gather(1, flat.reshape(e, -1)).reshape(
        e, m, w, w)
