"""The decider a scheduler's session calls each cycle (the port of
kube_arbitrator_tpu/framework/decider.py's ``LocalDecider`` interface).

:class:`TorchDecider` declares ``wants_device_pack = False``, so a
``Session`` (the port's, or the reference's) hands it the arena's host
pack and its :class:`~..cache.arena.PackMeta` (epoch key, base key,
changed fields), as it does a remote decider.  The decider keeps the pack resident on its
device across epochs: when the epoch's base is the resident's key it
diffs only the changed fields against a host shadow of the last pack and
writes the changed rows in place (K18); otherwise it uploads every field
(:class:`ResidentPack`, which the decision pool's replicas hold too).
It then runs the port's ``schedule_cycle`` and returns host numpy
decisions with the reference's field names.

When the tracer samples the cycle (utils/tracing.py) or the kernel
profiler is on (utils/profiling.py), the cycle runs through the staged
runner (``ops/cycle.schedule_cycle_staged``) instead, as the reference's
``LocalDecider`` does (its framework/decider.py:66-100): each stage
becomes a ``kernel.<stage>`` span, its wall ms lands in
``last_action_ms`` and each action's rounds in ``last_action_rounds``
(with ``<action>:gated`` and ``<action>:conflicts`` entries where they
are not zero), each dict published in one assignment.  Otherwise both
are left empty.  Its device work comes from one thread
(ops/kernels/build.check_launch_thread).
"""
from __future__ import annotations

import time
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..cache.arena import ARRAY_FIELDS, DeviceResident, changed_rows
from ..cache.snapshot import SnapshotTensors
from ..device import DeviceLike, resolve_device
from ..ops.cycle import CycleDecisions, decisions_to_host, schedule_cycle, schedule_cycle_staged
from ..ops.kernels.build import check_launch_thread
from ..utils.metrics import metrics
from ..utils.profiling import profiler
from ..utils.tracing import tracer
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


class ResidentPack:
    """One pack resident on a device across epochs: its
    :class:`DeviceResident` and the host shadow of the last pack as
    uploaded (the diff base).  ``upload`` diffs an epoch whose base is the
    resident's key field by field against the shadow (only the fields its
    PackMeta names) and writes the changed rows in place (K18); any other
    epoch is uploaded whole.  ``pack`` is the resident SnapshotTensors
    after the last upload.  A :class:`TorchDecider` holds one; a pool
    replica (rpc/pool.PoolReplica) holds one a tenant."""

    def __init__(self):
        self.resident = DeviceResident()
        self.pack: Optional[SnapshotTensors] = None
        self._shadow: Dict[str, np.ndarray] = {}
        self._unkeyed = 0

    @property
    def key(self) -> Optional[str]:
        return self.resident.key

    def upload(self, st, pack_meta, device: torch.device) -> SnapshotTensors:
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
        self.pack = self.resident.update(host, statics, key, base, changed, device)
        if self.resident.last_mode == "full":
            self._shadow = {name: np.array(a) for name, a in host.items()}
        elif self.resident.last_mode == "delta":
            self._shadow.update({name: np.array(host[name]) for name in changed})
        return self.pack


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
        self.pack = ResidentPack()
        # per-stage times and rounds of the last staged decide (empty
        # otherwise, as the reference's are with observability off)
        self.last_action_ms: Dict[str, float] = {}
        self.last_action_rounds: Dict[str, int] = {}
        self.last_upload_ms = 0.0
        self.last_cycle_ms = 0.0

    @property
    def resident(self) -> DeviceResident:
        return self.pack.resident

    @property
    def last_mode(self) -> str:
        return self.resident.last_mode

    @property
    def last_upload_bytes(self) -> int:
        return self.resident.last_upload_bytes

    def upload(self, st, pack_meta=None) -> SnapshotTensors:
        """The resident pack after this epoch (:meth:`ResidentPack.upload`)."""
        check_launch_thread("TorchDecider.upload")
        t0 = time.perf_counter()
        out = self.pack.upload(st, pack_meta, self.device)
        self.last_upload_ms = (time.perf_counter() - t0) * 1e3
        if self.last_mode != "reuse":
            metrics().counter_add("device_upload_bytes_total", self.last_upload_bytes,
                                  labels={"mode": self.last_mode})
        return out

    def decide(self, st, config, pack_meta=None) -> Tuple[CycleDecisions, float]:
        """One cycle of ``config`` (the port's SchedulerConfig or any
        object with ``.actions`` and ``.tiers``) on the pack ``st``."""
        conf = from_config(config)
        check_launch_thread("TorchDecider.decide")
        caps = getattr(pack_meta, "decode_caps", None)
        tr = tracer()
        t0 = time.perf_counter()
        pack = self.upload(st, pack_meta)
        t1 = time.perf_counter()
        if (tr.enabled and tr.current_corr_id() is not None) or profiler().enabled:
            dec, stages = schedule_cycle_staged(pack, tiers=conf.tiers, actions=conf.actions,
                                                decode_caps=caps)
            # built locally, published in one assignment each: a reader on
            # another thread sees the previous dict or this one, whole
            action_ms: Dict[str, float] = {}
            action_rounds: Dict[str, int] = {}
            for stage, ts, ms, rounds, rounds_gated, conflicts in stages:
                action_ms[stage] = ms
                if rounds is not None:
                    action_rounds[stage] = rounds
                    if rounds_gated:
                        action_rounds[f"{stage}:gated"] = rounds_gated
                    if conflicts:
                        action_rounds[f"{stage}:conflicts"] = conflicts
                tr.record_span(f"kernel.{stage}", ts, ms / 1000)
            self.last_action_ms = action_ms
            self.last_action_rounds = action_rounds
        else:
            self.last_action_ms = {}
            self.last_action_rounds = {}
            dec = schedule_cycle(pack, tiers=conf.tiers, actions=conf.actions, decode_caps=caps)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_cycle_ms = (time.perf_counter() - t1) * 1e3
        out = decisions_to_host(dec)
        return out, (time.perf_counter() - t0) * 1e3
