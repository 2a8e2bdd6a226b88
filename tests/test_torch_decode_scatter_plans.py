"""K3's ``DecodePlan`` and K18's ``RowScatterPlan`` on the CPU.

K3: the plan (in place, gated on ``any_a`` / ``any_p``) and the mirror
of the kernel's lookup (``decode_two_level_plain``: block and chunk
sums, the block and chunk search, the walk inside one chunk) against
``decode_deferred_plain`` and the reference's ``_decode_deferred`` under
its gate (ops/allocate.py:1254-1257), on the edges: N not a multiple of
the chunk and N below it, all-zero rows, a rank at a chunk boundary and
at exactly ``total_a``, ``task_group`` -1, invalid tasks, negative
ranks, G = 1, T = 0, the four flag settings and backfill's missing
``gn_p``; then one whole batched allocate action at 5k x 500 against
the reference's ``allocate_action`` in every AllocState field.

K18: the plan on every field dtype and rank with duplicate rows, an
empty epoch and a field re-placed whole between two deltas; the staging
buffer's growth rule; ``DeviceResident``'s ``last_upload_bytes`` against
the arithmetic it has always reported.  Both plans' ctypes structs (and
K18's return codes) against csrc's.
Integer data: every comparison is exact.
"""
import ctypes
import dataclasses
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.cache.synth import build_synthetic_snapshot as ref_synth
from kube_arbitrator_tpu.ops import allocate as ref_alloc
from kube_arbitrator_tpu.ops import cycle as ref_cycle
from kube_arbitrator_tpu.ops import ordering as ref_ord
from kube_arbitrator_tpu_torch.cache.arena import ARRAY_FIELDS, DeviceResident, changed_rows
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays, epoch_stream
from kube_arbitrator_tpu_torch.ops import allocate as port_alloc
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import ordering as port_ord
from kube_arbitrator_tpu_torch.ops.kernels import build
from kube_arbitrator_tpu_torch.ops.kernels import decode_deferred as k3
from kube_arbitrator_tpu_torch.ops.kernels import row_scatter as k18

C = k3.CHUNK


# ---------------------------------------------------------------- K3


@dataclasses.dataclass
class _RefState:
    task_status: object
    task_node: object


def _ref_decode(case, any_a, any_p, with_p):
    """The reference's decode under its gate: nothing unless any_a |
    any_p; backfill's gn_p is its static dummy (no pipelining)."""
    gn_a, gn_p, tg, rank, valid, entry, status, node = case
    if not (any_a or any_p):
        return status, node
    G, N = gn_a.shape
    st = types.SimpleNamespace(num_nodes=N, num_groups=G, task_group=jnp.asarray(tg),
                               task_group_rank=jnp.asarray(rank), task_valid=jnp.asarray(valid))
    out = ref_alloc._decode_deferred(
        st, _RefState(jnp.asarray(status), jnp.asarray(node)), jnp.asarray(entry),
        jnp.asarray(gn_a), jnp.asarray(gn_p) if with_p else jnp.zeros((0, N), jnp.int32),
        jnp.asarray(any_p))
    return np.asarray(out.task_status), np.asarray(out.task_node)


def _case(G, N, per, seed, T=None):
    """Counts of ``per`` tasks a group: sparse random rows, every third
    row all zero; row 0 holds a rank that falls exactly on a chunk
    boundary of gn_a (its first chunk's prefix); ranks start below
    ``entry_placed`` for some groups; some tasks have no group or are
    invalid."""
    rng = np.random.default_rng(seed)
    gn = []
    for lim in (per, per // 3):
        c = np.zeros((G, N), np.int32)
        tot = rng.integers(0, lim + 1, G)
        rows = np.repeat(np.arange(G), tot)
        np.add.at(c, (rows, rng.integers(0, N, rows.shape[0])), 1)
        c[::3] = 0
        gn.append(c)
    if N > C:
        gn[0][0] = 0
        gn[0][0, [1, C - 1, C, N - 1]] = (2, 1, 1, 3)  # prefix 3 ends chunk 0
    T = G * per if T is None else T
    tg = (np.arange(T) // per).astype(np.int32)
    tg[rng.random(T) < 0.1] = -1
    rank = (np.arange(T) % per).astype(np.int32)
    valid = rng.random(T) < 0.9
    valid[:per] = True
    tg[:per] = 0
    entry = rng.integers(0, 3, G).astype(np.int32)
    entry[0] = 0
    status = rng.integers(0, 3, T).astype(np.int32)
    node = rng.integers(-1, N, T).astype(np.int32)
    return gn[0], gn[1], tg, rank, valid, entry, status, node


# (G, N, tasks a group, T or None for G * tasks, any_a, any_p, gn_p given)
DECODE_CASES = {
    "N % C != 0, both flags": (6, 3 * C + 5, 12, None, True, True, True),
    "any_a only (the north star's form)": (6, 3 * C + 5, 12, None, True, False, True),
    "any_p only": (6, 3 * C + 5, 12, None, False, True, True),
    "no flag": (6, 3 * C + 5, 12, None, False, False, True),
    "backfill, no gn_p": (6, 3 * C + 5, 12, None, True, False, False),
    "backfill, no gn_p, any_p set": (6, 3 * C + 5, 12, None, True, True, False),
    "N < C": (5, C // 2 + 3, 8, None, True, True, True),
    "N a multiple of C": (4, 4 * C, 12, None, True, True, True),
    "several blocks": (3, 2 * k3.BLOCK * C + 3 * C + 7, 400, None, True, True, True),
    "G = 1": (1, 2 * C + 1, 20, None, True, True, True),
    "T = 0": (3, C + 1, 5, 0, True, True, True),
}


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_plan_and_two_level_mirror_match_reference(name):
    G, N, per, T, any_a, any_p, with_p = DECODE_CASES[name]
    case = _case(G, N, per, seed=len(name), T=T)
    gn_a, gn_p, tg, rank, valid, entry, status, node = case
    want = _ref_decode(case, any_a, any_p, with_p)
    t = torch.from_numpy
    args = [t(tg), t(rank), t(valid), t(entry)]
    got_s, got_n = t(status.copy()), t(node.copy())
    plan = k3.DecodePlan(t(gn_a), t(gn_p) if with_p else None, *args, got_s, got_n)
    before = k3.DecodePlan.launches
    plan(torch.tensor(any_a), torch.tensor(any_p))
    assert k3.DecodePlan.launches == before  # the CPU launches nothing
    assert np.array_equal(got_s.numpy(), want[0]) and np.array_equal(got_n.numpy(), want[1])
    if any_a or any_p:
        p = t(gn_p) if with_p and any_p else None
        for fn in (k3.decode_deferred_plain, k3.decode_two_level_plain):
            s, n = fn(t(gn_a), p, *args, t(status), t(node))
            assert np.array_equal(s.numpy(), want[0]), fn.__name__
            assert np.array_equal(n.numpy(), want[1]), fn.__name__
        for chunk, block in ((1, 1), (3, 2), (C // 2, 3)):  # nor on the cut
            s, n = k3.decode_two_level_plain(t(gn_a), p, *args, t(status), t(node), chunk=chunk,
                                             block=block)
            assert np.array_equal(n.numpy(), want[1]), (chunk, block)
    if name == "N % C != 0, both flags":
        # the edges are present: a rank on chunk 0's boundary of row 0,
        # ranks at exactly total_a, negative ranks, no group, invalid
        in_g = (tg >= 0) & valid
        r0 = rank - entry[np.clip(tg, 0, None)]
        total_a = gn_a.sum(axis=1)[np.clip(tg, 0, None)]
        assert (in_g & (tg == 0) & (r0 == gn_a[0, :C].sum())).any()
        assert (in_g & (r0 == total_a) & (total_a > 0)).any()
        assert (in_g & (r0 < 0)).any() and (tg < 0).any() and (~valid).any()
        assert (gn_a.sum(axis=1) == 0).any()
        assert (want[0] == k3.ALLOCATED).sum() > 10 and (want[0] == k3.PIPELINED).sum() > 0
        assert (want[0] != status).any()


@pytest.fixture(scope="module")
def allocate_world():
    """The 5k x 500 pack (integral capacity), both packages' sessions."""
    snap = ref_synth(num_tasks=5_000, num_nodes=500, num_queues=8, tasks_per_job=100, seed=7,
                     fit_fraction=1.25)
    st = snap.tensors
    sess, state = jax.jit(lambda s: ref_cycle.open_session(s, ref_ord.DEFAULT_TIERS))(st)
    pst = from_numpy({f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)},
                     "cpu")
    psess, pstate = port_cycle.open_session(pst, port_ord.DEFAULT_TIERS)
    return st, sess, state, pst, psess, pstate


def test_batched_allocate_action_matches_reference(allocate_world, monkeypatch):
    """One whole batched allocate action: every AllocState field of the
    port's equals the reference's, the decode made by one plan bound for
    the action, and the caller's state left as it was."""
    st, sess, state, pst, psess, pstate = allocate_world
    assert port_alloc._use_deferred_decode(pst, port_ord.DEFAULT_TIERS)
    decodes = []
    call = k3.DecodePlan.__call__

    def counted(self, any_a, any_p):
        decodes.append((bool(any_a), bool(any_p)))
        return call(self, any_a, any_p)

    monkeypatch.setattr(k3.DecodePlan, "__call__", counted)
    status_in = pstate.task_status.clone()
    ref = jax.jit(lambda a, b, c: ref_alloc.allocate_action(a, b, c, ref_ord.DEFAULT_TIERS))(
        st, sess, state)
    port = port_alloc.allocate_action(pst, psess, pstate, port_ord.DEFAULT_TIERS)
    assert decodes == [(True, False)]
    assert torch.equal(pstate.task_status, status_in)
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        b = b.numpy() if isinstance(b, torch.Tensor) else b
        assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
    assert (port.task_status.numpy() != status_in.numpy()).sum() > 1_000


# ---------------------------------------------------------------- K18

K18_FIELDS = ((np.bool_, (97,)), (np.int32, (97,)), (np.float32, (97,)), (np.bool_, (97, 3)),
              (np.bool_, (97, 8)), (np.int32, (97, 2)), (np.float32, (97, 4)))


def _fields(seed):
    """(base, host after the epoch, rows with the last three repeated)
    of every K18 field dtype and rank."""
    rng = np.random.default_rng(seed)
    out = []
    for dtype, shape in K18_FIELDS:
        base = (rng.random(shape) * 100).astype(dtype)
        i = np.sort(rng.choice(97, 20, replace=False))
        i = np.concatenate([i, i[-3:]])
        new = base.copy()
        new[i] = (rng.random((len(i),) + shape[1:]) * 100).astype(dtype)
        out.append((base, new, i))
    return out


def test_row_scatter_plan_fields_refresh_and_empty_epoch():
    fields = _fields(18)
    plan = k18.RowScatterPlan("cpu")
    bufs = [torch.from_numpy(b.copy()) for b, _, _ in fields]
    for f, buf in enumerate(bufs):
        plan.place(f"f{f}", buf)
    sent = plan([(f"f{f}", new, i) for f, (_, new, i) in enumerate(fields)])
    assert sent == sum(new[i].nbytes + 4 * len(i) for _, new, i in fields)
    for buf, (_, new, _) in zip(bufs, fields):
        assert np.array_equal(buf.numpy(), new)
    assert plan([(f"f{f}", new, i[:0]) for f, (_, new, i) in enumerate(fields)]) == 0
    for buf, (_, new, _) in zip(bufs, fields):
        assert np.array_equal(buf.numpy(), new)
    # f6 placed whole between two deltas: its request slot names the new
    # buffer, and the next delta lands there, not in the old one
    old = bufs[6]
    before = old.clone()
    bufs[6] = torch.from_numpy(fields[6][1].copy())
    plan.place("f6", bufs[6])
    assert plan.fields["f6"][0] is bufs[6] and plan.fields["f6"][4] == 6  # same slot
    host = fields[6][1].copy()
    host[[5, 50]] = -7.0
    plan([("f6", host, np.array([5, 50]))])
    assert np.array_equal(bufs[6].numpy(), host) and torch.equal(old, before)


def test_row_scatter_staging_growth():
    """The staging capacity: kept while an epoch fits, doubled when it
    does not (or set to the epoch's bytes, if more)."""
    need = 33_728
    assert k18.grown(0, need) == need
    assert k18.grown(need, need) == need and k18.grown(need, need - 1) == need
    assert k18.grown(need, need + 1) == 2 * need
    assert k18.grown(need, 3 * need) == 3 * need


def test_device_resident_upload_bytes_as_before():
    """``last_upload_bytes`` of full and delta epochs equals what the
    resident has always reported: whole fields' bytes, plus each
    scattered field's rows and its i32 indices; the resident equals the
    host after each epoch."""
    arrays, _ = build_synthetic_arrays(2_000, 200, 4, 100, 3, running_fraction=0.5,
                                       fit_fraction=1.2)
    res = DeviceResident()
    prev, modes = None, []
    for e, host, meta in epoch_stream(arrays, 4, 0.04, 0.05, 3):
        changed = {}
        if prev is not None:
            for name in meta.changed_fields:
                if name in ARRAY_FIELDS:
                    rows = changed_rows(np.asarray(host[name]), np.asarray(prev[name]))
                    if rows is not None:
                        changed[name] = rows
        res.update(host, {"rv_window": int(host["rv_window"])}, meta.key,
                   meta.base_key if prev is not None else None, changed, torch.device("cpu"))
        if res.last_mode == "full":
            want = sum(np.asarray(host[n]).nbytes for n in ARRAY_FIELDS)
        else:
            want = 0
            for name, rows in changed.items():
                arr = np.asarray(host[name])
                if isinstance(rows, str) or 2 * len(rows) > max(arr.shape[0], 1):
                    want += arr.nbytes
                else:
                    want += arr[rows].nbytes + rows.astype(np.int32).nbytes
        assert res.last_upload_bytes == want, e
        assert res.first_difference(host) is None, e
        modes.append(res.last_mode)
        prev = host
    assert modes[0] == "full" and modes[1:] == ["delta"] * 3


# ---------------------------------------------------------------- structs


def _c_struct(source: str, struct: str):
    """[(name, C type, is_pointer)] of ``struct <struct>`` in csrc/<source>.cu."""
    text = (build.CSRC / f"{source}.cu").read_text()
    body = re.search(rf"struct {struct} \{{(.*?)\n\}};", text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            m = re.match(r"([\w\s]+?)(\**)\s*(\w+(?:\s*,\s*\w+)*)$", decl)
            fields += [(n.strip(), m.group(1).strip(), bool(m.group(2)))
                       for n in m.group(3).split(",")]
    return fields


@pytest.mark.parametrize("struct", ["Static", "Call"])
def test_decode_plan_structs_mirror_the_c_structs(struct):
    got = [(name, typ is ctypes.c_void_p) for name, typ in getattr(k3, f"_{struct}")._fields_]
    assert got == [(n, p) for n, _, p in _c_struct("decode_deferred", struct)]


def test_row_scatter_request_mirrors_the_c_struct():
    size = {"unsigned long long": 8, "int": 4}
    want = [(n, 8 if p else size[t]) for n, t, p in _c_struct("row_scatter", "Req")]
    assert [(n, ctypes.sizeof(t)) for n, t in k18._Req._fields_] == want
    text = (build.CSRC / "row_scatter.cu").read_text()
    assert f"KAT_INDEX_ERROR = {k18.INDEX_ERROR};" in text
    assert f"KAT_NEED_BYTES = {k18.NEED_BYTES};" in text
