"""The device-resident pack of the serving path (the port of the device
plane of kube_arbitrator_tpu/cache/arena.py).

A scheduler's arena hands each cycle a host pack, its epoch key, the key
of the pack it was diffed against and the fields that changed since
(:class:`PackMeta`, the reference's :102-119).  :class:`DeviceResident`
(the reference's ``_DeviceResident``, :182-250) keeps one buffer per
pack field on the device across epochs:

* **reuse** — the same key on the same device uploads 0 bytes;
* **full** — no resident yet, another device, other statics, no base,
  or a base that is not the resident's key: every field is placed anew;
* **delta** — an unchanged field keeps its buffer; a field whose diff is
  ``"full"`` (its shape or dtype moved) or whose changed rows are more
  than half its rows is placed whole; the other changed fields' rows are
  written in place, all of them in one K18 launch on the card, from the
  resident's own :class:`RowScatterPlan` (its staging buffers reused
  epoch after epoch, each field's buffer bound when it is placed whole).

Two deliberate departures from the reference: on the CPU the rows are
scattered too (through K18's plain version), where the reference
re-places whole fields to spare a JAX compile per scatter shape; and the
rows are not padded to compile buckets (``_pad_rows``), which only JAX
needs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.kernels.row_scatter import RowScatterPlan
from .snapshot import SCHEMA, SnapshotTensors


@dataclasses.dataclass(frozen=True)
class PackMeta:
    """An epoch's pack key, the key it was diffed against (None: no
    usable base, ship everything), the fields changed since that base,
    and the tenant's own (bind_cap, evict_cap) decode-list caps (None:
    the global ``ops.cycle.decode_caps`` formula)."""

    key: str
    base_key: Optional[str]
    changed_fields: Tuple[str, ...]
    decode_caps: Optional[Tuple[int, int]] = None


# the pack's array fields (statics such as ``rv_window`` ride apart)
ARRAY_FIELDS: Tuple[str, ...] = tuple(SCHEMA)

Rows = Union[None, str, np.ndarray]


def changed_rows(a: np.ndarray, b: np.ndarray) -> Rows:
    """Row indices where ``a`` differs from ``b`` (same shape and dtype),
    ``"full"`` when they are not comparable row by row, or None when
    they are identical (the reference's ``_changed_rows``, :127-144)."""
    if (
        getattr(a, "shape", None) != getattr(b, "shape", None)
        or getattr(a, "dtype", None) != getattr(b, "dtype", None)
    ):
        return "full"
    if a.ndim == 0:
        return None if a == b else "full"
    d = a != b
    if d.ndim > 1:
        d = d.any(axis=tuple(range(1, d.ndim)))
    rows = np.nonzero(d)[0]
    if rows.size == 0:
        return None
    return rows


def changed_fields(prev: Mapping[str, object], new: Mapping[str, object]) -> Tuple[str, ...]:
    """The fields of pack ``new`` that differ from pack ``prev``'s: the
    array fields (one held by both packs is skipped unread) and the
    ``rv_window`` static, as a reference arena's PackMeta lists them."""
    out = [name for name in ARRAY_FIELDS
           if new[name] is not prev[name] and changed_rows(np.asarray(new[name]),
                                                           np.asarray(prev[name])) is not None]
    if int(new.get("rv_window", 0)) != int(prev.get("rv_window", 0)):
        out.append("rv_window")
    return tuple(sorted(out))


class DeviceResident:
    """The pack's fields resident on one device, updated by epoch.  It
    owns its buffers: nothing aliases the caller's numpy arrays."""

    def __init__(self):
        self.device: Optional[torch.device] = None
        self.key: Optional[str] = None
        self.arrays: Optional[Dict[str, torch.Tensor]] = None
        self.statics: Dict[str, object] = {}
        self.plan: Optional[RowScatterPlan] = None  # K18's, for self.device
        # the most recent update: "none" / "full" / "delta" / "reuse", and
        # the bytes it sent (whole fields, or changed rows plus their i32
        # indices)
        self.last_upload_bytes = 0
        self.last_mode = "none"

    def update(
        self,
        host: Mapping[str, np.ndarray],
        statics: Mapping[str, object],
        key: str,
        base_key: Optional[str],
        changed: Mapping[str, Rows],
        device: torch.device,
    ) -> SnapshotTensors:
        """The resident pack after epoch ``key``: ``host`` holds every
        array field, ``changed`` the rows of each field changed since
        ``base_key`` (absent or None: unchanged; ``"full"``: re-place)."""
        device = torch.device(device)
        if self.arrays is not None and self.key == key and self.device == device:
            self.last_upload_bytes, self.last_mode = 0, "reuse"
            return SnapshotTensors(**self.arrays, **self.statics)
        full = (
            self.arrays is None
            or self.device != device
            or self.statics != dict(statics)
            or base_key is None
            or self.key != base_key
        )
        arrays: Dict[str, torch.Tensor] = {} if full else dict(self.arrays)
        if self.plan is None or self.device != device:
            self.plan = RowScatterPlan(device)
        uploaded = 0
        changes = []
        for name in ARRAY_FIELDS:
            arr = np.asarray(host[name])
            rows = None if full else changed.get(name)
            if rows is None and not full:
                continue  # the resident buffer is current
            if full or isinstance(rows, str) or 2 * len(rows) > max(arr.shape[0], 1):
                arrays[name] = torch.from_numpy(np.array(arr)).to(device)
                uploaded += arr.nbytes
                if arr.ndim in (1, 2):
                    self.plan.place(name, arrays[name])
            else:
                changes.append((name, arr, rows))
        uploaded += self.plan(changes)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.device, self.key, self.arrays, self.statics = device, key, arrays, dict(statics)
        self.last_upload_bytes = uploaded
        self.last_mode = "full" if full else "delta"
        return SnapshotTensors(**arrays, **self.statics)

    def first_difference(self, host: Mapping[str, np.ndarray]) -> Optional[str]:
        """The first array field whose resident buffer differs from
        ``host``'s bit for bit (shape and dtype included), or None."""
        for name in ARRAY_FIELDS:
            got = (self.arrays or {}).get(name)
            want = np.asarray(host[name])
            if got is None:
                return name
            g = got.cpu().numpy()
            if g.dtype != want.dtype or g.shape != want.shape or g.tobytes() != want.tobytes():
                return name
        return None
