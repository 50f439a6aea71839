"""The workspace of the single-pass scans (``csrc/lookback.cuh``).

compact_mask, bucket_pack, gather_var, line_index, format_int and
expand_segments each scan in one pass with a decoupled look-back: a tile
publishes its sum in a status word and reads its predecessors' words.
text_records keeps two counters in words 0 and 1 (a call of no tiles),
where a word of an older epoch counts 0.
This module keeps the words per (device, stream), with the ticket counter
after them, the number of tiles launched on them so far and the number of
the last call (the epoch). Calls on one stream run in order, so each finds
the words of the calls before it finished, tagged with an older epoch: no
call clears them. They are cleared when the workspace grows and when the
epoch reaches the 30 bits a status word holds.
"""

from __future__ import annotations

import threading

import torch

EPOCH_LIMIT = (1 << 30) - 1  # the status word's 30 epoch bits


class Workspace:
    """Status words [capacity] and the ticket counter after them, in one
    int64 tensor."""

    def __init__(self, words: int, device: torch.device):
        self.capacity = words
        self.words = torch.zeros(words + 1, dtype=torch.int64, device=device)
        self.status = self.words.data_ptr()
        self.ticket = self.status + 8 * words
        self.tickets = 0  # tiles launched on the words so far
        self.epoch = 0


_workspaces: dict = {}
_lock = threading.Lock()


def workspace(device: torch.device, stream: int, words: int,
              epochs: int = 1) -> Workspace:
    """The workspace of (device, stream), with at least ``words`` status
    words, grown (doubled at least) and cleared when it has fewer, and
    cleared when fewer than ``epochs`` epochs are left."""
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.capacity < words:
        grown = words if ws is None else max(words, 2 * ws.capacity)
        ws = _workspaces[key] = Workspace(grown, device)
    if ws.epoch + epochs > EPOCH_LIMIT:
        ws.words.zero_()  # the ticket counter too
        ws.epoch = ws.tickets = 0
    return ws


def scan(device: torch.device, stream: int, words: int, tiles: int,
         launch, epochs: int = 1) -> None:
    """Make single-pass launches of ``tiles`` tiles in all that read and
    write ``words`` status words: ``launch(status, ticket, ticket_base,
    epoch)`` launches them and returns their status code (``_build.check``
    raises). A call of several passes (``epochs``) numbers them epoch,
    epoch + 1, ..., each taking its tickets after the one before."""
    with _lock:
        ws = workspace(device, stream, max(words, 1), epochs)
        ws.epoch += 1
        launch(ws.status, ws.ticket, ws.tickets, ws.epoch)
        ws.epoch += epochs - 1
        ws.tickets += tiles
