"""window_bounds: the partition and peer-group bounds of a window's sorted rows.

Replaces the boundary part of exon_tpu/plan/window_exec.py ``_window_column``
(:123-149): the ``seg_new``/``peer_new`` flags, their ``cumsum`` ids and
the four scatter-min/max passes (``seg_start``, ``seg_end``,
``peer_first``, ``peer_last``). Kernel source: ``csrc/window_bounds.cu``.

``window_bounds(keys, n_part)`` takes the sorted int64 key matrix ``[C, n]``
of a window (the rows ``sort_keys`` writes for its PARTITION BY keys, then
for its ORDER BY keys, gathered into sorted order), whose first ``n_part``
rows belong to the partition keys. A row starts a partition where any
partition row differs from the row before it, and a peer group where any
row differs. It returns int32 ``[n]`` for every sorted row: its partition's
first and last row and its peer group's first and last row. The JAX package
compares 64-bit hashes of the partition keys and 8-byte prefixes of string
order keys here (ROADMAP Queue 3, F19 and F20); the matrix holds every
byte of every key, so the bounds are exact.

On the card a call is two launches from one ctypes call and no host read:
a pass over tiles taken from the left writes the starts and a flags byte
a row, and a pass over tiles taken from the right writes the ends from
those flags, each completing its tiles on a look-back over the status
words of ``_lookback`` (two epochs of one workspace call). The four
outputs and the flags are one allocation.
"""

from __future__ import annotations

import torch

from . import _build, _lookback

launches = 0

# rows a tile of csrc/window_bounds.cu takes (kThreads * kItems)
TILE_ROWS = 128 * 8


def window_bounds_plain(keys: torch.Tensor, n_part: int
                        ) -> tuple[torch.Tensor, ...]:
    """The plain PyTorch twin: flags by comparing neighbours, starts by a
    ``cummax``, ends by a ``cummin`` of the flipped arrays."""
    n = keys.shape[1]
    dev = keys.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    if n == 0:
        empty = torch.empty(0, dtype=torch.int32, device=dev)
        return empty, empty, empty, empty
    diff = keys[:, 1:] != keys[:, :-1]
    first = torch.ones(1, dtype=torch.bool, device=dev)
    seg_new = torch.cat([first, diff[:n_part].any(0)])
    peer_new = torch.cat([first, diff.any(0)])

    def starts(flag):
        return torch.cummax(torch.where(flag, idx, 0), 0).values

    def ends(flag):
        last = torch.cat([flag[1:], first])
        cand = torch.where(last, idx, n).flip(0)
        return torch.cummin(cand, 0).values.flip(0)

    return tuple(t.to(torch.int32) for t in (
        starts(seg_new), ends(seg_new), starts(peer_new), ends(peer_new)))


def window_bounds(keys: torch.Tensor, n_part: int
                  ) -> tuple[torch.Tensor, ...]:
    global launches
    if keys.dtype != torch.int64 or keys.dim() != 2:
        raise TypeError(f"window_bounds: keys must be 2-d int64, got "
                        f"{keys.dtype} {tuple(keys.shape)}")
    rows, n = keys.shape
    if not 0 <= n_part <= rows:
        raise ValueError(f"window_bounds: {n_part} partition rows of {rows}")
    if n >= 1 << 31:
        raise ValueError(f"window_bounds: {n} rows exceed int32 bounds")
    if not _build.on_cuda(keys, "window_bounds"):
        return window_bounds_plain(keys, n_part)
    if not keys.is_contiguous():
        keys = keys.contiguous()
    dev = keys.device
    # the four outputs, then a flags byte a row (16-byte aligned after them)
    buf = torch.empty(4 * n + -(-n // 4), dtype=torch.int32, device=dev)
    out = buf[:4 * n].view(4, n)
    if n:
        flags = buf[4 * n:].view(torch.uint8)
        lib, stream = _build.library(), _build.stream_of(keys)
        tiles = -(-n // TILE_ROWS)

        def both(status, ticket, base, epoch):
            _build.check(lib.exon_window_bounds(
                keys.data_ptr(), rows, n_part, n, status, ticket, base,
                epoch, buf.data_ptr(), flags.data_ptr(), stream),
                "window_bounds")

        # two passes on the same words: two epochs, tiles taken twice
        _lookback.scan(dev, stream, 2 * tiles, 2 * tiles, both, epochs=2)
        launches += 1
    return out[0], out[1], out[2], out[3]
