"""Link channel order shared by the decode and the CC kernel.

Port of ``tensorflow_ocr_tpu/ops/labels.py:35-44``, plus the shift that
reads each pixel's neighbour in a link direction. Training labels are
not ported yet (ROADMAP.md, Queue 1).
"""

import torch

# (dx, dy) per link channel, matching the reference channel order:
# 0=left, 1=left_down, 2=left_up, 3=right, 4=right_down, 5=right_up,
# 6=up, 7=down. csrc/cc.cu hard-codes the same table.
LINK_OFFSETS = (
    (-1, 0),   # 0 left
    (-1, 1),   # 1 left_down
    (-1, -1),  # 2 left_up
    (1, 0),    # 3 right
    (1, 1),    # 4 right_down
    (1, -1),   # 5 right_up
    (0, -1),   # 6 up
    (0, 1),    # 7 down
)


def shift_map(x: torch.Tensor, dx: int, dy: int, fill) -> torch.Tensor:
    """out[..., y, x] = in[..., y + dy, x + dx], ``fill`` outside."""
    h, w = x.shape[-2:]
    out = torch.full_like(x, fill)
    out[..., max(0, -dy):h - max(0, dy), max(0, -dx):w - max(0, dx)] = \
        x[..., max(0, dy):h - max(0, -dy), max(0, dx):w - max(0, -dx)]
    return out
