"""The decider a scheduler's session calls each cycle (the port of
kube_arbitrator_tpu/framework/decider.py's ``LocalDecider`` interface).

:class:`TorchDecider` declares ``wants_device_pack = False``, so a
``Session`` (the port's, or the reference's) hands it the arena's host
pack and its :class:`~..cache.arena.PackMeta` (epoch key, base key,
changed fields), as it does a remote decider.  The decider keeps the pack resident on its
device across epochs: when the epoch's base is the resident's key it
diffs only the changed fields against a host shadow of the last pack and
writes the changed rows in place (K18); otherwise it uploads every field.
It then runs the port's ``schedule_cycle`` and returns host numpy
decisions with the reference's field names.
"""
from __future__ import annotations

import time
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..cache.arena import ARRAY_FIELDS, DeviceResident, changed_rows
from ..cache.snapshot import SnapshotTensors
from ..device import DeviceLike, resolve_device
from ..ops.cycle import CycleDecisions, decisions_to_host, schedule_cycle
from .conf import from_config


def _field(st, name: str, default=None):
    if isinstance(st, Mapping):
        return st.get(name, default)
    return getattr(st, name, default)


def host_fields(st) -> Dict[str, np.ndarray]:
    """The pack's array fields by name from ``st`` (the reference's
    SnapshotTensors, or a mapping of numpy arrays)."""
    raw = {name: _field(st, name) for name in ARRAY_FIELDS}
    missing = [name for name, a in raw.items() if a is None]
    if missing:
        raise ValueError(f"pack fields missing: {missing}")
    return {name: np.asarray(a) for name, a in raw.items()}


class TorchDecider:
    """Decide a scheduler's cycles on ``device`` (the card unless the
    caller passes ``"cpu"``; without CUDA and without ``"cpu"`` the
    constructor raises).  ``decide`` returns (CycleDecisions of host
    numpy arrays, ms), ms the synchronised wall time of the whole call;
    ``last_mode``, ``last_upload_bytes``, ``last_upload_ms`` and
    ``last_cycle_ms`` describe the last call.  One decide at a time."""

    # the session hands over the host pack and its PackMeta
    wants_device_pack = False
    # PackMeta.decode_caps are honoured
    supports_decode_caps = True

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.resident = DeviceResident()
        # the last pack's array fields as uploaded (the diff base)
        self._shadow: Dict[str, np.ndarray] = {}
        self._unkeyed = 0
        # per-stage times and rounds: empty, as the reference's are with
        # observability off
        self.last_action_ms: Dict[str, float] = {}
        self.last_action_rounds: Dict[str, int] = {}
        self.last_upload_ms = 0.0
        self.last_cycle_ms = 0.0

    @property
    def last_mode(self) -> str:
        return self.resident.last_mode

    @property
    def last_upload_bytes(self) -> int:
        return self.resident.last_upload_bytes

    def upload(self, st, pack_meta=None) -> SnapshotTensors:
        """The resident pack after this epoch.  ``st`` holds the pack's
        fields by name (the reference's SnapshotTensors, or a mapping of
        numpy arrays); ``pack_meta`` its epoch (None: a pack of its own,
        uploaded in full)."""
        host = host_fields(st)
        statics = {"rv_window": int(_field(st, "rv_window", 0))}
        key = getattr(pack_meta, "key", None)
        base = getattr(pack_meta, "base_key", None)
        if key is None:
            self._unkeyed += 1
            key, base = f"unkeyed:{self._unkeyed}", None
        changed = {}
        if base is not None and base == self.resident.key and self._shadow:
            for name in pack_meta.changed_fields:
                if name in self._shadow:
                    rows = changed_rows(host[name], self._shadow[name])
                    if rows is not None:
                        changed[name] = rows
        else:
            base = None
        t0 = time.perf_counter()
        out = self.resident.update(host, statics, key, base, changed, self.device)
        self.last_upload_ms = (time.perf_counter() - t0) * 1e3
        if self.resident.last_mode == "full":
            self._shadow = {name: np.array(a) for name, a in host.items()}
        elif self.resident.last_mode == "delta":
            self._shadow.update({name: np.array(host[name]) for name in changed})
        return out

    def decide(self, st, config, pack_meta=None) -> Tuple[CycleDecisions, float]:
        """One cycle of ``config`` (the port's SchedulerConfig or any
        object with ``.actions`` and ``.tiers``) on the pack ``st``."""
        conf = from_config(config)
        t0 = time.perf_counter()
        pack = self.upload(st, pack_meta)
        t1 = time.perf_counter()
        dec = schedule_cycle(pack, tiers=conf.tiers, actions=conf.actions,
                             decode_caps=getattr(pack_meta, "decode_caps", None))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_cycle_ms = (time.perf_counter() - t1) * 1e3
        out = decisions_to_host(dec)
        return out, (time.perf_counter() - t0) * 1e3
