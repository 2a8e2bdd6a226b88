"""K3's ``DecodePlan`` and K18's ``RowScatterPlan`` on the card, each
held bit for bit against its plain version on the same inputs (the CPU
tests against the JAX package are in
tests/test_torch_decode_scatter_plans.py).  Every test here needs a CUDA
card and skips without one.

* K3: the gate's four settings, backfill's missing ``gn_p``, N not a
  multiple of the chunk and below it, N % 4 != 0 (the scalar route), G =
  1, T = 0 and a 20,480-node row, each one launch writing status and
  node in place; a whole batched allocate action (and backfill) on the
  card against the same action on the CPU in every AllocState field,
  its decode one launch with no host read.
* K18: every field dtype and rank with duplicate rows in one launch, an
  empty epoch with none, a field re-placed whole between two deltas, the
  staging grown once and then reused; epochs enqueued back to back with
  no synchronisation (each waits for the last one's kernel before it
  rewrites the pinned buffer), and a call from another stream refused;
  ``DeviceResident`` on the card against the CPU over a served stream
  (modes, bytes, the resident).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from kube_arbitrator_tpu_torch.cache.arena import ARRAY_FIELDS, DeviceResident, changed_rows
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays, epoch_stream
from kube_arbitrator_tpu_torch.ops import allocate as port_alloc
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import ordering as port_ord
from kube_arbitrator_tpu_torch.ops.kernels import decode_deferred as k3
from kube_arbitrator_tpu_torch.ops.kernels import row_scatter as k18

C = k3.CHUNK
TIERS = port_ord.DEFAULT_TIERS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(G, N, per, seed, T=None):
    """Sparse counts (every third row zero), ``per`` tasks a group, some
    without a group, invalid or with a negative rank."""
    rng = np.random.default_rng(seed)
    gn = []
    for lim in (per, per // 3):
        c = np.zeros((G, N), np.int32)
        rows = np.repeat(np.arange(G), rng.integers(0, lim + 1, G))
        np.add.at(c, (rows, rng.integers(0, N, rows.shape[0])), 1)
        c[::3] = 0
        gn.append(c)
    T = G * per if T is None else T
    tg = (np.arange(T) // per).astype(np.int32)
    tg[rng.random(T) < 0.1] = -1
    rank = (np.arange(T) % per).astype(np.int32)
    valid = rng.random(T) < 0.9
    entry = rng.integers(0, 3, G).astype(np.int32)
    status = rng.integers(0, 3, T).astype(np.int32)
    node = rng.integers(-1, N, T).astype(np.int32)
    return gn[0], gn[1], tg, rank, valid, entry, status, node


# (G, N, tasks a group, T or None, any_a, any_p, gn_p given)
CASES = {
    "both flags": (64, 3 * C + 8, 40, None, True, True, True),
    "any_a only": (64, 3 * C + 8, 40, None, True, False, True),
    "any_p only": (64, 3 * C + 8, 40, None, False, True, True),
    "no flag": (64, 3 * C + 8, 40, None, False, False, True),
    "backfill": (64, 3 * C + 8, 40, None, True, True, False),
    "N % 4 != 0": (64, 3 * C + 5, 40, None, True, True, True),
    "N < C": (16, C // 2 + 2, 12, None, True, True, True),
    "G = 1": (1, 2 * C + 4, 50, None, True, True, True),
    "T = 0": (8, C + 4, 5, 0, True, True, True),
    "N = 20,480": (256, 20_480, 100, None, True, True, True),
    "N = 20,477 (scalar)": (64, 20_477, 100, None, True, True, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_decode_plan_on_card_matches_plain(cuda_device, name):
    G, N, per, T, any_a, any_p, with_p = CASES[name]
    gn_a, gn_p, tg, rank, valid, entry, status, node = _case(G, N, per, len(name), T)
    t = torch.from_numpy
    args = [t(tg), t(rank), t(valid), t(entry)]
    want = (t(status), t(node))
    if any_a or any_p:
        want = k3.decode_deferred_plain(t(gn_a), t(gn_p) if with_p and any_p else None, *args,
                                        t(status), t(node))
    s, n = t(status).to(cuda_device), t(node).to(cuda_device)
    plan = k3.DecodePlan(t(gn_a).to(cuda_device), t(gn_p).to(cuda_device) if with_p else None,
                         *[a.to(cuda_device) for a in args], s, n)
    before = k3.DecodePlan.launches
    plan(torch.tensor(any_a, device=cuda_device), torch.tensor(any_p, device=cuda_device))
    assert k3.DecodePlan.launches == before + 1
    assert torch.equal(s.cpu(), want[0]) and torch.equal(n.cpu(), want[1])


def _allocate_states(device, best_effort):
    arrays, _ = build_synthetic_arrays(5_000, 500, 8, 100, 7, fit_fraction=1.25)
    st = from_numpy(arrays, device)
    sess, state = port_cycle.open_session(st, TIERS)
    fn = port_alloc.backfill_action if best_effort else port_alloc.allocate_action
    return state, fn(st, sess, state, TIERS)


@pytest.mark.cuda
@pytest.mark.parametrize("best_effort", [False, True])
def test_batched_allocate_on_card_equals_cpu(cuda_device, best_effort, monkeypatch):
    """The whole batched action on the card equals the CPU's in every
    AllocState field; its decode is one launch and reads nothing on the
    host (sync debug mode 'error' around the plan's call)."""
    call = k3.DecodePlan.__call__

    def strict(self, *a):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return call(self, *a)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    monkeypatch.setattr(k3.DecodePlan, "__call__", strict)
    before = k3.DecodePlan.launches
    entry, card = _allocate_states(cuda_device, best_effort)
    assert k3.DecodePlan.launches == before + 1
    _, cpu = _allocate_states(torch.device("cpu"), best_effort)
    for f in dataclasses.fields(cpu):
        a, b = getattr(card, f.name), getattr(cpu, f.name)
        if isinstance(b, torch.Tensor):
            assert torch.equal(a.cpu(), b), f.name
        else:
            assert a == b, f.name
    if not best_effort:
        assert (cpu.task_status != entry.task_status.cpu()).sum() > 1_000


def _k18_fields(seed):
    rng = np.random.default_rng(seed)
    out = []
    for dtype, shape in ((np.bool_, (97,)), (np.int32, (97,)), (np.float32, (97,)),
                         (np.bool_, (97, 3)), (np.bool_, (97, 8)), (np.int32, (97, 2)),
                         (np.float32, (97, 4))):
        base = (rng.random(shape) * 100).astype(dtype)
        i = np.sort(rng.choice(97, 20, replace=False))
        i = np.concatenate([i, i[-3:]])
        new = base.copy()
        new[i] = (rng.random((len(i),) + shape[1:]) * 100).astype(dtype)
        out.append((base, new, i))
    return out


@pytest.mark.cuda
def test_row_scatter_plan_on_card_matches_plain(cuda_device):
    fields = _k18_fields(18)
    plan = k18.RowScatterPlan(cuda_device)
    card = [torch.from_numpy(b.copy()).to(cuda_device) for b, _, _ in fields]
    host = [torch.from_numpy(b.copy()) for b, _, _ in fields]
    for f, c in enumerate(card):
        plan.place(f"f{f}", c)

    def epoch(changes, launched):
        before = k18.RowScatterPlan.launches
        plan(changes)
        k18.row_scatter_plain(host, [i for _, _, i in changes], [h[i] for _, h, i in changes])
        assert k18.RowScatterPlan.launches == before + launched
        torch.cuda.synchronize()
        for a, b in zip(card, host):
            assert torch.equal(a.cpu(), b)

    changes = [(f"f{f}", new, i) for f, (_, new, i) in enumerate(fields)]
    epoch(changes, 1)
    epoch([(name, h, i[:0]) for name, h, i in changes], 0)
    # f6 re-placed whole: the next delta lands in the new buffer only
    old = card[6]
    kept = old.clone()
    card[6] = torch.from_numpy(fields[6][1].copy()).to(cuda_device)
    host[6] = torch.from_numpy(fields[6][1].copy())
    plan.place("f6", card[6])
    new6 = fields[6][1].copy()
    new6[[5, 50]] = -7.0
    changes[6] = ("f6", new6, np.array([5, 50]))
    epoch(changes, 1)
    assert torch.equal(old, kept)
    # a bigger epoch grows the staging once; repeating it reuses it
    cap = plan.cap
    changes = [(name, h, np.arange(97)) for name, h, _ in changes]
    epoch(changes, 1)
    grown = (plan.cap, plan.pinned.data_ptr(), plan.staging.data_ptr())
    assert grown[0] > cap
    epoch(changes, 1)
    assert (plan.cap, plan.pinned.data_ptr(), plan.staging.data_ptr()) == grown


@pytest.mark.cuda
def test_row_scatter_plan_back_to_back_and_one_stream(cuda_device):
    fields = _k18_fields(19)
    plan = k18.RowScatterPlan(cuda_device)
    card = [torch.from_numpy(b.copy()).to(cuda_device) for b, _, _ in fields]
    host = [torch.from_numpy(b.copy()) for b, _, _ in fields]
    for f, c in enumerate(card):
        plan.place(f"f{f}", c)
    rng = np.random.default_rng(20)
    for _ in range(40):  # each epoch rewrites the pinned buffer the last one copied from
        changes = []
        for f, (_, new, _) in enumerate(fields):
            i = rng.choice(97, 10, replace=False)
            new = new.copy()
            new[i] = (rng.random((10,) + new.shape[1:]) * 100).astype(new.dtype)
            changes.append((f"f{f}", new, i))
        torch.cuda._sleep(100_000)  # the kernels start late: the next call's wait is real
        plan(changes)
        k18.row_scatter_plain(host, [i for _, _, i in changes], [h[i] for _, h, i in changes])
    torch.cuda.synchronize()
    for a, b in zip(card, host):
        assert torch.equal(a.cpu(), b)
    with torch.cuda.stream(torch.cuda.Stream(cuda_device)):
        with pytest.raises(RuntimeError, match="another stream"):
            plan(changes)


@pytest.mark.cuda
def test_device_resident_on_card_equals_cpu(cuda_device):
    arrays, _ = build_synthetic_arrays(2_000, 200, 4, 100, 3, running_fraction=0.5,
                                       fit_fraction=1.2)
    card, cpu = DeviceResident(), DeviceResident()
    prev = None
    for e, host, meta in epoch_stream(arrays, 4, 0.04, 0.05, 3):
        changed = {}
        if prev is not None:
            for name in meta.changed_fields:
                if name in ARRAY_FIELDS:
                    rows = changed_rows(np.asarray(host[name]), np.asarray(prev[name]))
                    if rows is not None:
                        changed[name] = rows
        base = meta.base_key if prev is not None else None
        statics = {"rv_window": int(host["rv_window"])}
        card.update(host, statics, meta.key, base, changed, cuda_device)
        cpu.update(host, statics, meta.key, base, changed, torch.device("cpu"))
        assert (card.last_mode, card.last_upload_bytes) == (cpu.last_mode, cpu.last_upload_bytes)
        assert card.first_difference(host) is None, e
        prev = host
    assert card.last_mode == "delta" and card.plan.cap > 0
