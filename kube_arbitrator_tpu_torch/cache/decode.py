"""Decode a cycle's decisions back into host-side actuation columns (the
port of kube_arbitrator_tpu/cache/decode.py).

Two paths produce the SAME decision stream:

* :func:`decode_batch_compact` — the fast path: the kernel's commit
  tail (ops/cycle.commit_cycle) ships compact, length-prefixed bind/evict
  index lists (``bind_idx``/``bind_node``/``evict_idx`` + counts)
  compacted in-graph, so the host pays one bounded gather over
  O(decisions) elements — never an O(T) mask transfer or a
  ``np.nonzero`` scan.  Counts exceeding the list caps mean the cycle
  overflowed (``None`` return; the caller falls back dense and counts
  ``decode_overflow_total``).
* :func:`decode_batch` — the dense-mask path, kept as the PARITY
  ORACLE: batched gathers over ``np.nonzero`` of the [T] masks.  The
  compact path's entries are emitted in the same ascending task-ordinal
  order, so the two paths are decision-identical whenever the lists fit
  (pinned by tests/test_decode_parity.py).

Both return a :class:`DecisionBatch` of COLUMNS (ordinal ndarrays plus
the snapshot index that resolves them), not intent objects: the
pipeline — revalidation, the leader fence, batched actuation, the audit
record — consumes the columns directly, and ``BindIntent``/
``EvictIntent`` objects are materialized only at the apiserver wire (or
lazily, for callers that still iterate).  The legacy
:func:`decode_decisions` / :func:`decode_decisions_compact` wrappers
keep returning intent lists for oracle checks and old callers.

Decisions may be host numpy (a scheduler's session, from
``framework.TorchDecider``) or device tensors (``ops/cycle.schedule_cycle``
called directly): each field read is copied to the host once.
:func:`decode_binds` is the bind side alone, compact lists when they fit
and the dense mask otherwise, for the synthetic worlds' command line.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .sim import BindIntent, EvictIntent
from .snapshot import Snapshot

_I64 = np.int64


def _host(x) -> np.ndarray:
    """``x`` as a host numpy array (a device tensor is copied)."""
    if hasattr(x, "cpu") and hasattr(x, "numpy"):
        return x.cpu().numpy()
    return np.asarray(x)


def _uid_lookup(index):
    """uid/name accessors for both index flavors: the object-model
    SnapshotIndex (``.tasks``/``.nodes`` lists) and the native cache's
    ordinal-lookup index (``.task_uid()``/``.node_name()`` methods)."""
    if hasattr(index, "tasks"):
        tasks, nodes = index.tasks, index.nodes
        return (lambda i: tasks[i].uid), (lambda n: nodes[n].name)
    return index.task_uid, index.node_name


class _Column:
    """Shared plumbing for the bind/evict columns: a row-ordinal ndarray
    plus the snapshot index that resolves ordinals to identities.  The
    column is Sequence-compatible (len/iter/getitem/==) by lazily
    materializing the intent objects ONCE — the single assembly point
    that replaced ``_build_intents``, so legacy iterators and the
    columnar consumers cannot diverge in anything but cost."""

    __slots__ = ("index", "rows", "_uids", "_intents")

    def __init__(self, index, rows) -> None:
        self.index = index
        self.rows = np.asarray(rows, dtype=_I64)
        self._uids: Optional[List[str]] = None
        self._intents = None

    def __len__(self) -> int:
        return int(self.rows.shape[0])

    def __bool__(self) -> bool:
        return self.rows.shape[0] > 0

    def __iter__(self):
        return iter(self.to_intents())

    def __getitem__(self, i):
        return self.to_intents()[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, _Column):
            other = other.to_intents()
        if isinstance(other, (list, tuple)):
            return self.to_intents() == list(other)
        return NotImplemented

    def __repr__(self) -> str:  # assertion-message friendliness
        return f"{type(self).__name__}({self.to_intents()!r})"

    @property
    def uids(self) -> List[str]:
        """Task uids for every row — ONE batched ``.tolist()`` then an
        O(decisions) resolve; cached (the wire needs the strings anyway)."""
        if self._uids is None:
            task_uid, _ = _uid_lookup(self.index)
            self._uids = [task_uid(i) for i in self.rows.tolist()]
        return self._uids


class BindColumn(_Column):
    """Columnar bind decisions: task-row + node ordinals, identities on
    demand.  ``overflowed``: decoded from the dense mask because the
    compact list could not hold every bind (:func:`decode_binds`)."""

    __slots__ = ("node_ords", "_node_names", "overflowed")

    def __init__(self, index, rows, node_ords, overflowed: bool = False) -> None:
        super().__init__(index, rows)
        self.node_ords = np.asarray(node_ords, dtype=_I64)
        self._node_names: Optional[List[str]] = None
        self.overflowed = overflowed

    def pairs(self) -> List[Tuple[str, str]]:
        """(task uid, node name) per bind, in row order."""
        return list(zip(self.uids, self.node_names))

    @property
    def node_names(self) -> List[str]:
        if self._node_names is None:
            _, node_name = _uid_lookup(self.index)
            self._node_names = [node_name(n) for n in self.node_ords.tolist()]
        return self._node_names

    def to_intents(self) -> List[BindIntent]:
        if self._intents is None:
            self._intents = [
                BindIntent(task_uid=u, node_name=n)
                for u, n in zip(self.uids, self.node_names)
            ]
        return self._intents

    def select(self, keep: Sequence[int]) -> "BindColumn":
        """A new column of the kept row positions (revalidation's
        surviving subset), in order."""
        keep = np.asarray(keep, dtype=_I64)
        return BindColumn(self.index, self.rows[keep], self.node_ords[keep])

    @classmethod
    def empty(cls, index) -> "BindColumn":
        return cls(index, np.empty(0, _I64), np.empty(0, _I64))


class EvictColumn(_Column):
    """Columnar evict decisions: task-row ordinals, identities on
    demand."""

    __slots__ = ()

    def to_intents(self) -> List[EvictIntent]:
        if self._intents is None:
            self._intents = [EvictIntent(task_uid=u) for u in self.uids]
        return self._intents

    def select(self, keep: Sequence[int]) -> "EvictColumn":
        keep = np.asarray(keep, dtype=_I64)
        return EvictColumn(self.index, self.rows[keep])

    @classmethod
    def empty(cls, index) -> "EvictColumn":
        return cls(index, np.empty(0, _I64))


class DecisionBatch:
    """One cycle's decoded decisions as columns — what flows from decode
    through revalidation and the fence into batched actuation."""

    __slots__ = ("binds", "evicts")

    def __init__(self, binds: BindColumn, evicts: EvictColumn) -> None:
        self.binds = binds
        self.evicts = evicts


def decode_batch(snap: Snapshot, decisions) -> DecisionBatch:
    """CycleDecisions tensors -> decision columns — the dense-mask
    parity oracle.  Vectorized: ``np.nonzero`` over each mask, then
    batched gathers; NO per-decision python objects are built here."""
    bind_mask = _host(decisions.bind_mask)
    evict_mask = _host(decisions.evict_mask)
    bind_rows = np.nonzero(bind_mask)[0]
    bind_nodes = _host(decisions.task_node)[bind_rows]
    evict_rows = np.nonzero(evict_mask)[0]
    return DecisionBatch(
        BindColumn(snap.index, bind_rows, bind_nodes),
        EvictColumn(snap.index, evict_rows),
    )


DECODE_LIST_FIELDS = (
    "bind_idx", "bind_node", "evict_idx", "bind_count", "evict_count",
)


def decode_lists_present(decisions) -> bool:
    """True iff the compact decode lists are ALL present.  They are
    optional on the wire as a unit: a partial set (a skewed or buggy
    peer omitting only some) is treated exactly like full absence —
    dense fallback, never a crash on a None count mid-decode."""
    return all(
        getattr(decisions, n, None) is not None for n in DECODE_LIST_FIELDS
    )


def decode_batch_compact(snap: Snapshot, decisions) -> Optional[DecisionBatch]:
    """Decision columns from the kernel's compact index lists, or
    ``None`` when the path is unavailable for this decisions pack:

    * any of the lists is absent (a pre-ints-out peer across the RPC
      boundary omitted them — :func:`decode_lists_present`), or
    * either count exceeds its list cap — the overflow case; the caller
      must decode the dense masks instead (and count the overflow).

    Cost: two scalar reads + three bounded [count] gathers; the [T]
    masks are never touched, and no per-decision objects are built.
    """
    if not decode_lists_present(decisions):
        return None
    bind_idx = decisions.bind_idx
    evict_idx = decisions.evict_idx
    n_bind = int(decisions.bind_count)
    n_evict = int(decisions.evict_count)
    if n_bind > bind_idx.shape[0] or n_evict > evict_idx.shape[0]:
        return None  # overflowed the caps: dense fallback decodes it
    bind_rows = _host(bind_idx[:n_bind])
    bind_nodes = _host(decisions.bind_node[:n_bind])
    evict_rows = _host(evict_idx[:n_evict])
    return DecisionBatch(
        BindColumn(snap.index, bind_rows, bind_nodes),
        EvictColumn(snap.index, evict_rows),
    )


def decode_decisions(
    snap: Snapshot, decisions
) -> Tuple[List[BindIntent], List[EvictIntent]]:
    """Legacy intent-list decode (dense oracle) — a thin wrapper that
    materializes :func:`decode_batch`'s columns.  Kept for parity
    assertions and object-path callers; the scheduling loop itself ships
    the columns."""
    batch = decode_batch(snap, decisions)
    return batch.binds.to_intents(), batch.evicts.to_intents()


def decode_decisions_compact(
    snap: Snapshot, decisions
) -> Optional[Tuple[List[BindIntent], List[EvictIntent]]]:
    """Legacy intent-list decode (compact path), ``None`` on absence or
    overflow — the materialized twin of :func:`decode_batch_compact`."""
    batch = decode_batch_compact(snap, decisions)
    if batch is None:
        return None
    return batch.binds.to_intents(), batch.evicts.to_intents()


def decode_binds(index, decisions) -> BindColumn:
    """Bind decisions of one cycle, from the compact lists when they fit,
    else from the dense mask (``overflowed`` set), in ascending task
    ordinal order either way."""
    snap = Snapshot(tensors=None, index=index)
    batch = decode_batch_compact(snap, decisions)
    if batch is not None:
        return batch.binds
    binds = decode_batch(snap, decisions).binds
    binds.overflowed = True
    return binds
