"""K19 (stable_sort) and K20 (ordered_scan): their plain versions against
the JAX package, exactly.

* K19's sort against ``jnp.lexsort`` (1-6 keys, ties, negatives, INT_MAX,
  0 to 51,200 items), its lookup against ``jnp.searchsorted``, and its
  callers against the reference's: the victim layouts of ``_build_view``
  and ``_reclaim_fast`` (``SortLayout.build``: order, segment starts,
  resreq in order) and ``_replay_claim_log``, on the evictive, the
  claim-dense (512 queues) and the priority-mix worlds; ``segment_order``
  against numpy's stable argsort and ``searchsorted``.
* K20 (``ops/common.mm_cumsum``) against the reference's ``mm_cumsum`` on
  the CPU at the 16-row block edges, for [V] and [V, C].

Twins marked ``cuda`` hold the kernels against these plain versions on
the card and skip without one."""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.cache.synth import build_synthetic_snapshot as ref_synth
from kube_arbitrator_tpu.ops import common as ref_common
from kube_arbitrator_tpu.ops import cycle as ref_cycle
from kube_arbitrator_tpu.ops import preempt as ref_pre
from kube_arbitrator_tpu.ops.ordering import DEFAULT_TIERS as REF_TIERS
from kube_arbitrator_tpu_torch.api.types import TaskStatus
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
from kube_arbitrator_tpu_torch.ops import common as port_common
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops import preempt as port_pre
from kube_arbitrator_tpu_torch.ops.kernels import ordered_scan as k20
from kube_arbitrator_tpu_torch.ops.kernels import segment_sum as k4
from kube_arbitrator_tpu_torch.ops.kernels import stable_sort as k19
from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS as PORT_TIERS

INT_MAX, INT_MIN = 2**31 - 1, -(2**31)
SIZES = (0, 1, 17, 4096, 51_200)


def _keys(rng, n, nk):
    """``nk`` i32 keys of ``n`` items: heavy ties, negatives, INT_MAX
    padding and INT_MIN, and one wide key."""
    keys = [rng.integers(-3, 4, n).astype(np.int32) for _ in range(nk)]
    if n:
        keys[0][rng.random(n) < 0.2] = INT_MAX
        keys[-1][rng.random(n) < 0.05] = INT_MIN
        keys[nk // 2] = np.where(rng.random(n) < 0.5, rng.integers(-n, n + 1, n),
                                 keys[nk // 2]).astype(np.int32)
    return keys


@pytest.mark.parametrize("nk", range(1, k19.MAX_KEYS + 1))
@pytest.mark.parametrize("n", SIZES)
def test_stable_sort_plain_equals_jnp_lexsort(n, nk):
    keys = _keys(np.random.default_rng(10 * n + nk), n, nk)
    want = np.asarray(jnp.lexsort([jnp.asarray(k) for k in keys]))
    perm, primary = k19.stable_sort([torch.from_numpy(k) for k in keys], want_sorted=True)
    assert perm.dtype == torch.int32 and np.array_equal(perm.numpy(), want)
    assert np.array_equal(primary.numpy(), keys[-1][want])
    assert np.array_equal(port_common.lexsort([torch.from_numpy(k) for k in keys]).numpy(), want)


def test_stable_sort_bounds_and_refusals():
    assert [k19.digit_passes(b) for b in (None, 0, 1, 255, 256, 65_535, 65_536, 2**31 - 1)] \
        == [4, 0, 1, 1, 2, 2, 3, 4]
    key = torch.tensor([3, 0, 5, 2], dtype=torch.int32)
    assert k19.stable_sort((key,), bounds=(5,))[0].tolist() == [1, 3, 0, 2]
    with pytest.raises(ValueError, match="leaves its bound"):
        k19.stable_sort((key,), bounds=(4,))
    with pytest.raises(ValueError, match="leaves its bound"):
        k19.stable_sort((key - 1,), bounds=(10,))
    with pytest.raises(ValueError, match="keys"):
        k19.stable_sort((key.long(),))
    with pytest.raises(ValueError, match="1 to 6"):
        k19.stable_sort((key,) * 7)
    with pytest.raises(ValueError, match="one bound"):
        k19.stable_sort((key, key), bounds=(5,))


@pytest.mark.parametrize("n", SIZES)
def test_sorted_lookup_plain_equals_jnp_searchsorted(n):
    rng = np.random.default_rng(n)
    sk = np.sort(np.concatenate([rng.choice(4 * n + 8, n // 2, replace=False),
                                 np.full(n - n // 2, INT_MAX)])).astype(np.int32)
    q = rng.integers(-2, 4 * n + 10, n + 5).astype(np.int32)
    q[: n // 4] = sk[: n // 4]
    pos, found = k19.sorted_lookup(torch.from_numpy(sk), torch.from_numpy(q))
    want = np.asarray(jnp.searchsorted(jnp.asarray(sk), jnp.asarray(q)))
    assert np.array_equal(pos.numpy(), want)
    hit = np.array([p < n and sk[p] == x for p, x in zip(want, q)], bool)
    assert np.array_equal(found.numpy(), hit)


@pytest.mark.parametrize("T,S", [(0, 4), (1, 1), (17, 3), (4096, 40), (102_400, 1024),
                                 (102_400, 1)])
def test_segment_order_equals_numpy(T, S):
    """Slots stably sorted by segment, out-of-range slots last and outside
    every run; run starts = searchsorted of 0..S."""
    rng = np.random.default_rng(T + S)
    idx = rng.integers(-2, S + 3, T).astype(np.int32)
    if S == 1:
        idx[:] = 0  # ordered_sum's one segment
    key = np.where((idx >= 0) & (idx < S), idx, S)
    perm, seg_start = k4.segment_order(torch.from_numpy(idx), S)
    want = np.argsort(key, kind="stable")
    assert perm.dtype == seg_start.dtype == torch.int32
    assert np.array_equal(perm.numpy(), want)
    assert np.array_equal(seg_start.numpy(), np.searchsorted(key[want], np.arange(S + 1)))
    if T:
        val = torch.from_numpy(rng.standard_normal((T, 3)).astype(np.float32) * 1000)
        assert torch.equal(k4.ordered_sum(val), k4.segment_sum(val, torch.zeros(T, dtype=torch.int32), 1)[0])


# ---------------------------------------------------------------- the callers

WORLDS = {
    "evictive": (dict(num_tasks=5000, num_nodes=500, num_queues=8, tasks_per_job=100, seed=42,
                      running_fraction=0.5, fit_fraction=1.25), False),
    "claim_dense": (dict(num_tasks=5000, num_nodes=500, num_queues=512, tasks_per_job=100,
                         seed=42, running_fraction=0.5, fit_fraction=1.25), False),
    "priority_mix": (dict(num_tasks=5000, num_nodes=500, num_queues=16, tasks_per_job=100,
                          seed=44, running_fraction=0.5, fit_fraction=0.75), True),
}


@functools.lru_cache(maxsize=None)
def _world(name):
    """(reference pack, its session state, port pack, port state): the
    reference carries the port synth's arrays."""
    kw, mix = WORLDS[name]
    arrays, _ = build_synthetic_arrays(**kw, priority_mix=mix)
    st = dataclasses.replace(ref_synth(**kw).tensors, **arrays)
    _, state = jax.jit(lambda s: ref_cycle.open_session(s, REF_TIERS))(st)
    pst = from_numpy(arrays, "cpu")
    _, pstate = port_cycle.open_session(pst, PORT_TIERS)
    return st, state, pst, pstate


def _same_layout(ref, port, ctx):
    assert np.array_equal(np.asarray(ref.order), port.order.numpy()), f"{ctx} order"
    assert np.array_equal(np.asarray(ref.seg_start), port.seg_start.numpy()), f"{ctx} seg_start"
    assert np.array_equal(np.asarray(ref.res_sorted), port.res_sorted.numpy()), f"{ctx} res_sorted"


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_build_view_layouts_equal_reference(world):
    """The three victim layouts of preempt's full-width panel."""
    st, state, pst, pstate = _world(world)
    running0 = (np.asarray(st.task_status) == int(TaskStatus.RUNNING)) & np.asarray(st.task_valid) \
        & (np.asarray(st.task_node) >= 0)
    T = pst.num_tasks
    ref = ref_pre._build_view(st, state, jnp.asarray(running0), T)
    port = port_pre._build_view(pst, pstate, torch.from_numpy(running0), T)
    for name in ("by_job", "by_queue", "by_node_queue"):
        _same_layout(getattr(ref.layouts, name), getattr(port.layouts, name), f"{world} {name}")


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_reclaim_fast_layouts_equal_reference(world):
    """``_reclaim_fast``'s three whole-task-axis layouts (``_task_layout``):
    order, segment starts, resreq in order, inverse and segment bases."""
    st, state, pst, pstate = _world(world)
    vj, vq = np.asarray(st.task_job), np.asarray(st.job_queue)[np.asarray(st.task_job)]
    node = np.maximum(np.asarray(state.task_node), 0)
    pr, uid, rr = (np.asarray(st.task_priority), np.asarray(st.task_uid_rank),
                   np.asarray(st.task_resreq))
    t = torch.from_numpy
    for seg, extra in (((node,), (vj, vq)), ((vj, node), ()), ((vq, node), (vj,))):
        segs = seg if len(seg) > 1 else seg[0]
        ref = ref_pre.SortLayout.build(
            tuple(jnp.asarray(s) for s in seg) if len(seg) > 1 else jnp.asarray(segs),
            jnp.asarray(pr), jnp.asarray(uid), jnp.asarray(rr),
            extra_keys=tuple(jnp.asarray(e) for e in extra))
        lay, inv, base = port_pre._task_layout(
            tuple(t(s) for s in seg) if len(seg) > 1 else t(segs), t(pr), t(uid), t(rr),
            extra_keys=tuple(t(e) for e in extra))
        _same_layout(ref, lay, f"{world} {len(seg)}+{len(extra)}")
        assert np.array_equal(np.asarray(ref.inv), inv.numpy())
        assert np.array_equal(np.asarray(ref.base_idx), base.numpy())


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_replay_claim_log_equals_reference(world):
    """The deferred claimant decode on a claim log with one claim per job
    (distinct groups), unused rows -1."""
    st, state, pst, pstate = _world(world)
    rng = np.random.default_rng(5)
    J, G = pst.num_jobs, int(np.asarray(st.group_valid).sum())
    size = np.asarray(st.group_size)
    n = min(J, G) * 3 // 4
    log_g = np.full(J, -1, np.int32)
    log_g[:n] = rng.permutation(G)[:n]
    log_r = np.zeros(J, np.int32)
    log_r[:n] = rng.integers(0, np.maximum(size[log_g[:n]], 1))
    log_n = rng.integers(0, pst.num_nodes, J).astype(np.int32)
    perm = rng.permutation(J)  # claims in no particular order
    log_g, log_r, log_n = log_g[perm], log_r[perm], log_n[perm]
    ref = ref_pre._replay_claim_log(st, state.task_status, state.task_node, jnp.asarray(log_g),
                                    jnp.asarray(log_n), jnp.asarray(log_r))
    port = port_pre._replay_claim_log(pst, pstate.task_status, pstate.task_node,
                                      torch.from_numpy(log_g), torch.from_numpy(log_n),
                                      torch.from_numpy(log_r))
    for a, b in zip(ref, port):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert int((port[0] != pstate.task_status).sum()) > 0


# ---------------------------------------------------------------- K20


@pytest.mark.parametrize("two_d", (False, True))
@pytest.mark.parametrize("V", (15, 16, 17, 255, 256, 257, 51_200))
def test_mm_cumsum_at_block_edges(V, two_d):
    """Bit for bit the reference's ``mm_cumsum`` on the CPU (``jnp.cumsum``)
    on fractional values with -0.0 among them; at 51,200 rows the totals
    pass 2^24, where the order of the adds shows."""
    rng = np.random.default_rng(V)
    x = (rng.integers(1, 64_000, size=(V, 3)) * rng.random((V, 3))).astype(np.float32)
    x[rng.random((V, 3)) < 0.05] = -0.0
    a = x if two_d else np.ascontiguousarray(x[:, 0])
    want = np.asarray(ref_common.mm_cumsum(jnp.asarray(a)))
    got = port_common.mm_cumsum(torch.from_numpy(a)).numpy()
    assert got.dtype == np.float32 and np.array_equal(want.view(np.int32), got.view(np.int32))
    if V == 51_200:
        assert float(want[-1] if not two_d else want[-1, 0]) > 2**24


def test_ordered_scan_refusals():
    with pytest.raises(TypeError):
        k20.ordered_scan(torch.zeros(4))
    with pytest.raises(TypeError):
        k20.ordered_scan(torch.zeros((4, 2), dtype=torch.float64))
    assert k20.smem_bytes(16) == 0 and k20.smem_bytes(51_200) == 4 * (3200 + 200 + 13)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k19_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(19)
    for n in SIZES:
        for nk in (1, 4, 6):
            keys = [torch.from_numpy(k) for k in _keys(rng, n, nk)]
            want = k19.stable_sort_plain(keys, want_sorted=True)
            got = k19.stable_sort([k.to(cuda_device) for k in keys], want_sorted=True)
            assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])
        idx = torch.from_numpy(rng.integers(-2, 40, n).astype(np.int32))
        for a, b in zip(k4.segment_order(idx.to(cuda_device), 37), k4.segment_order(idx, 37)):
            assert torch.equal(a.cpu(), b)
        sk = torch.sort(torch.from_numpy(rng.integers(0, 4 * n + 8, n // 2 + 1).astype(np.int32))).values
        q = torch.from_numpy(rng.integers(-1, 4 * n + 9, n).astype(np.int32))
        for a, b in zip(k19.sorted_lookup(sk.to(cuda_device), q.to(cuda_device)),
                        k19.sorted_lookup_plain(sk, q)):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_k20_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(20)
    for V in (1, 15, 16, 17, 255, 256, 257, 51_200, 102_400):
        x = torch.from_numpy((rng.integers(1, 64_000, (V, 3)) * rng.random((V, 3))).astype(np.float32))
        got = k20.ordered_scan(x.to(cuda_device)).cpu()
        assert torch.equal(got.view(torch.int32), k20.ordered_scan_plain(x).view(torch.int32))
