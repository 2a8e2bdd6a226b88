"""Decode a cycle's bind decisions into (task uid, node name) pairs (the
bind side of the reference's cache/decode.decode_batch_compact,
kube_arbitrator_tpu/cache/decode.py:196-244).

The compact lists (``bind_idx`` / ``bind_node`` / ``bind_count``) are
used when they hold every bind.  When ``bind_count`` exceeds the list cap
— the normal case on a first cycle over a large backlog, since the cap is
T/2 — the dense ``bind_mask`` is decoded instead, in the same ascending
task-ordinal order.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class BindColumn:
    """Bind decisions as ordinal columns, identities on demand."""

    index: object          # ordinal lookup (cache/synth.SynthIndex)
    rows: np.ndarray       # i64[B] task ordinals, ascending
    node_ords: np.ndarray  # i64[B] node ordinal per bind
    overflowed: bool       # decoded from the dense mask

    def __len__(self) -> int:
        return int(self.rows.shape[0])

    def pairs(self) -> List[Tuple[str, str]]:
        uid, name = self.index.task_uid, self.index.node_name
        return [(uid(t), name(n)) for t, n in zip(self.rows.tolist(), self.node_ords.tolist())]


def decode_binds(index, decisions) -> BindColumn:
    """Bind decisions of one cycle, from the compact lists when they fit,
    else from the dense mask."""
    n_bind = int(decisions.bind_count)
    if n_bind <= decisions.bind_idx.shape[0]:
        rows = decisions.bind_idx[:n_bind].cpu().numpy()
        nodes = decisions.bind_node[:n_bind].cpu().numpy()
        overflowed = False
    else:
        rows = np.nonzero(decisions.bind_mask.cpu().numpy())[0]
        nodes = decisions.task_node.cpu().numpy()[rows]
        overflowed = True
    return BindColumn(index, rows.astype(np.int64), nodes.astype(np.int64), overflowed)
