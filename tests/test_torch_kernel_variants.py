"""K1's and K19's launch variants, and what changed around them.

* The pure functions that pick a variant on the card: K19's sort by n
  (one CTA or tiles) and segment order by n and S (one CTA, counting
  pass, tiles); K1's launch shape by the positions a slot scans (one CTA
  on the panel or a short axis, a cluster over a long one) and the
  variant's name.
* K19's ``sorted_lookup`` on both sides: its plain version against
  ``np.searchsorted`` and ``jnp.searchsorted`` (hypothesis), i64 and i32.
* K1's ``AdmitPlan`` on the CPU equals the plain slot body per launch.
* ``open_session`` sorts ``task_job`` and ``job_queue`` once each and
  hands the order to every segment sum over them.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hs

from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops.kernels import admit_chunk as k1
from kube_arbitrator_tpu_torch.ops.kernels import segment_sum as k4
from kube_arbitrator_tpu_torch.ops.kernels import stable_sort as k19
from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS

INT_MIN, INT_MAX = -(2**31), 2**31 - 1


@pytest.mark.parametrize("n,want", [
    (0, "one_cta"), (1, "one_cta"), (k19.ONE_CTA_MAX_N, "one_cta"),
    (k19.ONE_CTA_MAX_N + 1, "tiles"), (51_200, "tiles"), (1_048_576, "tiles"),
])
def test_sort_variant_by_n(n, want):
    assert k19.sort_variant(n) == want


@pytest.mark.parametrize("n,S,want", [
    (512, 1024, "one_cta"), (k19.ONE_CTA_MAX_N, 5000, "one_cta"),
    (102_400, 1024, "count"), (102_400, k19.COUNT_MAX_BINS - 1, "count"),
    (102_400, k19.COUNT_MAX_BINS, "tiles"), (51_200, 5000, "tiles"),
])
def test_segment_order_variant_by_n_and_segments(n, S, want):
    assert k19.segment_order_variant(n, S) == want


def test_workspace_covers_every_look_back_word():
    # control words, histograms and info words, one word per (pass, tile, bin)
    n, npass, bins = 3 * k19.TILE + 1, 5, 256
    assert k19.workspace_words(n, npass, bins) == 4 + npass * bins + npass + npass * 4 * bins


@pytest.mark.parametrize("positions,ctas", [
    (1, 1), (1250, 1), (k1.ONE_CTA_MAX_POSITIONS, 1), (k1.ONE_CTA_MAX_POSITIONS + 1, 8),
    (10_240, 8), (100_000, 8),
])
def test_k1_launch_shape(positions, ctas):
    got, threads = k1.launch_shape(positions)
    assert got == ctas <= k1.MAX_CLUSTER
    assert threads % 32 == 0 and 32 <= threads <= 1024
    # about two positions a lane, unless the CTA is at 1024 threads
    per_cta = -(-positions // ctas)
    assert threads == 1024 or threads >= per_cta / 2


@pytest.mark.parametrize("panel,ctas,want", [
    (True, 1, "panel"), (True, 8, "panel_cluster"), (False, 1, "full"), (False, 4, "full_cluster"),
])
def test_k1_variant_names(panel, ctas, want):
    assert k1.variant_name(panel, ctas) == want
    assert want in k1.VARIANTS


_sorted_keys = hs.lists(hs.integers(INT_MIN, INT_MAX), max_size=60).map(sorted)
_queries = hs.lists(hs.integers(INT_MIN, INT_MAX), min_size=1, max_size=40)


@settings(max_examples=60, deadline=None)
@given(keys=_sorted_keys, queries=_queries, side=hs.sampled_from(["left", "right"]),
       out_int32=hs.booleans(), dup=hs.integers(0, 3))
def test_sorted_lookup_plain_matches_numpy_and_jnp(keys, queries, side, out_int32, dup):
    keys = sorted(keys + keys[:dup])  # duplicates in the sorted key
    queries = queries + keys[:2]      # queries that hit
    sk = np.asarray(keys, np.int32)
    q = np.asarray(queries, np.int32)
    pos, found = k19.sorted_lookup(torch.from_numpy(sk), torch.from_numpy(q), side, out_int32)
    want = np.searchsorted(sk, q, side=side)
    assert pos.dtype == (torch.int32 if out_int32 else torch.int64)
    assert np.array_equal(pos.numpy(), want)
    assert np.array_equal(pos.numpy(), np.asarray(jnp.searchsorted(jnp.asarray(sk), jnp.asarray(q),
                                                                     side=side)))
    assert np.array_equal(found.numpy(), np.isin(q, sk))


def test_sorted_lookup_right_needs_no_key_past_int_max():
    sk = torch.tensor([INT_MIN, 0, INT_MAX, INT_MAX], dtype=torch.int32)
    q = torch.tensor([INT_MAX, INT_MIN, 5], dtype=torch.int32)
    pos, found = k19.sorted_lookup(sk, q, side="right")
    assert pos.tolist() == [4, 1, 2] and found.tolist() == [True, True, False]
    with pytest.raises(ValueError):
        k19.sorted_lookup(sk, q, side="middle")


def test_segment_order_takes_any_integer_ids():
    rng = np.random.default_rng(3)
    idx = rng.integers(-3, 40, 500)
    a = k19.segment_order(torch.from_numpy(idx), 37)
    b = k19.segment_order(torch.from_numpy(idx.astype(np.int32)), 37)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert k4.segment_order is k19.segment_order


def test_admit_plan_on_the_cpu_equals_the_plain_slot_body():
    arrays, _ = build_synthetic_arrays(2000, 200, 4, 50, 5, running_fraction=0.2,
                                       fit_fraction=1.2)
    st = from_numpy(arrays, "cpu")
    sess, state = port_cycle.open_session(st, DEFAULT_TIERS)
    G, N = st.num_groups, st.num_nodes
    S = 8
    g_sel = torch.arange(S, dtype=torch.int32) * (G // S)
    req = st.group_resreq[g_sel.long()].contiguous()
    budget = torch.full((S,), 30, dtype=torch.int32)
    ports = torch.zeros((S, st.group_ports.shape[1]), dtype=torch.int32)
    has_ports = torch.zeros(S, dtype=torch.bool)
    runs = []
    for use_plan in (True, False):
        idle, rel = state.node_idle.clone(), state.node_releasing.clone()
        np_, nt = state.node_ports.clone(), state.node_num_tasks.clone()
        gn_a, gn_p = torch.zeros((G, N), dtype=torch.int32), torch.zeros((G, N), dtype=torch.int32)
        outs = []
        if use_plan:
            plan = k1.AdmitPlan(st, idle, rel, np_, nt, gn_a, gn_p, None, 4096, False, True, S)
            for n in (S, 3):
                outs.append([x.clone() for x in plan(n, g_sel, req, budget, ports, has_ports)])
        else:
            for n in (S, 3):
                outs.append([x.clone() for x in k1.admit_chunk_plain(
                    st, idle, rel, np_, nt, gn_a, gn_p, torch.tensor([n], dtype=torch.int32),
                    g_sel, req, budget, ports, has_ports, None, 4096, False, True)])
        runs.append((outs, [idle, rel, np_, nt, gn_a, gn_p]))
    (o1, s1), (o2, s2) = runs
    assert all(torch.equal(a, b) for x, y in zip(o1, o2) for a, b in zip(x, y))
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))
    assert int(o1[0][0].sum()) > 0


def test_open_session_sorts_each_segment_key_once(monkeypatch):
    arrays, _ = build_synthetic_arrays(2000, 200, 4, 50, 7, running_fraction=0.3,
                                       fit_fraction=1.5)
    st = from_numpy(arrays, "cpu")
    want = port_cycle.open_session(st, DEFAULT_TIERS)
    sorted_keys = []
    real = port_cycle.segment_order

    def counting(idx, num_segments, *a, **kw):
        sorted_keys.append(num_segments)
        return real(idx, num_segments, *a, **kw)

    monkeypatch.setattr(port_cycle, "segment_order", counting)
    got = port_cycle.open_session(st, DEFAULT_TIERS)
    assert sorted(sorted_keys) == sorted([st.num_jobs, st.num_queues])
    for a, b in zip(want, got):
        for f in a.__dataclass_fields__:
            x, y = getattr(a, f), getattr(b, f)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), f
