"""K9's and K11's plans and K9's radix order, held against the JAX package.

* K9's sort key: the order-preserving int32 image of the canonical f32
  key (``radix_key``) and the LSD digit sort the kernel runs over it
  (``lsd_sort_plain``) equal the reference's
  ``jnp.lexsort((jnp.arange(N), key))`` at N = 1 to 20,480, with ties,
  -0.0 beside +0.0, BIG for invalid nodes and binpack's negative keys.
* K9's route by policy and N (``turn_caps_variant``): one CTA up to
  ``ONE_CTA_MAX_N``, tiles above, never a raise (no node limit).
* ``TurnCapsPlan`` on the CPU equals ``turn_caps_plain`` turn after turn
  through one plan, under every policy, best effort and with the
  predicates on and off; its order equals the radix sort of its key.
* ``PaFitPlan`` on the CPU equals ``pa_fit_plain`` and the reference's
  ``pod_affinity_fit`` group after group through one plan, at the cycle's
  entry and after allocate rounds (pods placed this cycle).
* The plans' ctypes structs (K1's, K9's, K11's, K12's, K13's and K17's)
  mirror the C structs field for field.
* On a card (``cuda``-marked, skipped here): every K9 variant and K11
  back to back through one plan equal their plain versions.

Everything compared is integer or bool: equal (tolerance: none).
"""
from __future__ import annotations

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.ops import podaffinity as ref_pa
from kube_arbitrator_tpu.cache import snapshot as ref_snapshot
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
from kube_arbitrator_tpu_torch.ops import allocate as port_alloc
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops.kernels import admit_chunk as k1
from kube_arbitrator_tpu_torch.ops.kernels import build
from kube_arbitrator_tpu_torch.ops.kernels import canon_pick as k7
from kube_arbitrator_tpu_torch.ops.kernels import pa_fit as k11
from kube_arbitrator_tpu_torch.ops.kernels import pa_shape as k12
from kube_arbitrator_tpu_torch.ops.kernels import queue_order as k17
from kube_arbitrator_tpu_torch.ops.kernels import round_products as k13
from kube_arbitrator_tpu_torch.ops.kernels import turn_caps as k9
from kube_arbitrator_tpu_torch.ops.kernels import turn_fill as k10
from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS, with_node_order

BIG = np.float32(3.0e38)


def _keys(rng, n, policy):
    """f32 keys as the reference builds them: -/+ a used share in [0, 1]
    (many ties: shares on a grid of 1/8, some exact zeros, binpack's
    idle nodes at -0.0), invalid nodes at BIG."""
    share = np.where(rng.random(n) < 0.5, rng.integers(0, 9, n) / 8.0, rng.random(n))
    share = np.where(rng.random(n) < 0.2, 0.0, share).astype(np.float32)
    score = -share if policy == "binpack" else share
    valid = rng.random(n) < 0.9
    return np.where(valid, score, BIG).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 33, 1000, 10_003, 16_385, 20_480])
@pytest.mark.parametrize("policy", ["binpack", "spread"])
def test_radix_order_equals_reference_lexsort(n, policy):
    rng = np.random.default_rng(n)
    key = _keys(rng, n, policy)
    if policy == "binpack":
        assert n < 10 or np.signbit(key[key == 0]).all()  # -0.0 keys
    want = np.asarray(jnp.lexsort((jnp.arange(n), jnp.asarray(key))))
    img = k9.radix_key(torch.from_numpy(key) + 0.0)
    assert img.dtype == torch.int32
    assert np.array_equal(k9.lsd_sort_plain(img).numpy(), want)
    # the image orders as the float does, -0.0 only once canonicalised
    assert np.array_equal(torch.sort(img, stable=True).indices.numpy(), want)
    raw = k9.radix_key(torch.tensor([-0.0, 0.0], dtype=torch.float32))
    assert int(raw[0]) < int(raw[1])


def test_lsd_sort_skips_uniform_digits_and_keeps_ties():
    keys = torch.tensor([5, 5, -1, 5, -1, 2**31 - 1, -(2**31)], dtype=torch.int32)
    assert k9.lsd_sort_plain(keys).tolist() == [6, 2, 4, 0, 1, 3, 5]
    assert k9.lsd_sort_plain(torch.zeros(0, dtype=torch.int32)).tolist() == []
    assert k9.lsd_sort_plain(torch.full((4,), 7, dtype=torch.int32)).tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("policy,n,want", [
    ("first_fit", 20_480, "first_fit"), ("binpack", 1, "one_cta"),
    ("binpack", 10_240, "one_cta"), ("spread", k9.ONE_CTA_MAX_N, "one_cta"),
    ("spread", k9.ONE_CTA_MAX_N + 1, "tiles"), ("binpack", 16_385, "tiles"),
    ("binpack", 20_480, "tiles"), ("spread", 1_000_000, "tiles"),
])
def test_turn_caps_variant_by_policy_and_n(policy, n, want):
    assert k9.turn_caps_variant(policy, n) == want
    assert want in k9.VARIANTS


def test_turn_caps_plan_takes_any_node_count():
    """No node limit: a plan over 20,480 nodes builds (the tiled route)
    and a forced one-CTA route past its limit is refused."""
    N, R = 20_480, 4
    st = _node_pack(N, R)
    nodes = (torch.zeros((N, R)), torch.zeros((N, R)), torch.zeros((N, 1), dtype=torch.int32),
             torch.zeros(N, dtype=torch.int32))
    assert k9.TurnCapsPlan(st, *nodes, 4096, False, True, "binpack").variant == "tiles"
    with pytest.raises(ValueError):
        k9.TurnCapsPlan(st, *nodes, 4096, False, True, "binpack", variant="one_cta")
    with pytest.raises(ValueError):
        k9.TurnCapsPlan(st, *nodes, 4096, False, True, "first_fit", variant="tiles")


def _node_pack(N, R):
    class St:
        node_alloc = torch.ones((N, R))
        node_valid = torch.ones(N, dtype=torch.bool)
    return St()


def _world(pod_affinity, policy="first_fit", seed=5):
    arrays, _ = build_synthetic_arrays(2000, 200, num_queues=8, tasks_per_job=50, seed=seed,
                                       running_fraction=0.3, fit_fraction=1.0,
                                       pod_affinity=pod_affinity)
    st = from_numpy(arrays, "cpu")
    tiers = with_node_order(policy)
    sess, state = port_cycle.open_session(st, tiers)
    mid = port_alloc.allocate_action(st, sess, state, tiers, max_rounds=2, turn_batch=False)
    return arrays, st, state, mid


@pytest.mark.parametrize("policy", ["first_fit", "binpack", "spread"])
@pytest.mark.parametrize("best_effort,preds_on", [(False, True), (True, True), (False, False)])
def test_turn_caps_plan_equals_plain_turn_after_turn(policy, best_effort, preds_on):
    _, st, entry, mid = _world(False, policy)
    for state in (entry, mid):
        nodes = (state.node_idle, state.node_releasing, state.node_ports, state.node_num_tasks)
        plan = k9.TurnCapsPlan(st, *nodes, 4096, best_effort, preds_on, policy)
        for g in (0, 7, 19, 30):
            gt = torch.tensor([g], dtype=torch.int32 if g % 2 else torch.int64)
            req = st.group_resreq[g].contiguous()
            pa_ok = torch.rand(st.num_nodes, generator=torch.Generator().manual_seed(g)) < 0.8
            for ok in (None, pa_ok):
                k, nperm = plan(gt, req, ok)
                kp, pp = k9.turn_caps_plain(st, *nodes, gt, req, ok, 4096, best_effort,
                                            preds_on, policy)
                assert torch.equal(k, kp), f"group {g}"
                if policy == "first_fit":
                    assert nperm is None and pp is None
                else:
                    assert torch.equal(nperm, pp)
                    radix = k9.lsd_sort_plain(k9.radix_key(k9.packing_key_f32(st, state.node_idle, policy)))
                    assert torch.equal(radix.to(torch.int32), nperm)


def test_pa_fit_plan_equals_plain_and_reference_group_after_group():
    arrays, st, entry, mid = _world(True, "binpack")
    ref_st = ref_snapshot.SnapshotTensors(
        **{k: jnp.asarray(v) for k, v in arrays.items() if k != "rv_window"},
        rv_window=arrays["rv_window"])
    plan = k11.PaFitPlan(st)
    groups = [g for g in range(int(st.group_valid.sum()))
              if (arrays["group_aff_terms"][g] >= 0).any() or (arrays["group_anti_terms"][g] >= 0).any()]
    assert len(groups) > 10
    placed = int(k11._placed(st, mid.task_status, mid.task_node).sum())
    assert placed > 50, "the mid-cycle state must hold pods placed this cycle"
    flags = 0
    for state in (entry, mid):
        for i, g in enumerate(groups[:24]):
            gt = torch.tensor([g], dtype=torch.int64 if i % 2 else torch.int32)
            got = plan(gt, state.task_status, state.task_node)
            want = k11.pa_fit_plain(st, gt, state.task_status, state.task_node)
            ref = ref_pa.pod_affinity_fit(ref_st, jnp.int32(g), jnp.asarray(state.task_status.numpy()),
                                          jnp.asarray(state.task_node.numpy()))
            for name in want._fields:
                assert torch.equal(getattr(got, name), getattr(want, name)), f"group {g}: {name}"
                assert np.array_equal(np.asarray(getattr(ref, name)), getattr(got, name).numpy()), \
                    f"group {g}: {name} vs the reference"
            flags += int(got.seed_flags.sum()) + int(got.cap_flags.sum()) + int((~got.ok).sum())
    assert flags > 0


def _c_struct(source: str, struct: str = "Static"):
    """[(name, is_pointer)] of ``struct <struct>`` in csrc/<source>.cu."""
    text = (build.CSRC / f"{source}.cu").read_text()
    body = re.search(rf"struct {struct} \{{(.*?)\n\}};", text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        m = re.match(r"([\w\s]+?)(\**)\s*(\w+(?:\s*,\s*\w+)*)$", decl)
        ptr = bool(m.group(2))
        fields += [(n.strip(), ptr) for n in m.group(3).split(",")]
    return fields


@pytest.mark.parametrize("mod,source", [(k1, "admit_chunk"), (k9, "turn_caps"), (k11, "pa_fit"),
                                        (k12, "pa_shape"), (k13, "round_products"),
                                        (k17, "queue_order"), (k7, "canon_pick"),
                                        (k10, "turn_fill")])
def test_plan_structs_mirror_the_c_structs(mod, source):
    want = _c_struct(source)
    got = [(name, typ is ctypes.c_void_p) for name, typ in mod._Static._fields_]
    assert got == want


def test_canon_pick_turn_mirrors_the_c_struct():
    """K7's per-launch Turn, set in place by CanonPickPlan."""
    want = _c_struct("canon_pick", "Turn")
    got = [(name, typ is ctypes.c_void_p) for name, typ in k7._Turn._fields_]
    assert got == want


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["one_cta", "tiles"])
def test_turn_caps_variants_match_plain_on_card(cuda_device, variant):
    arrays, st, entry, mid = _world(False, "binpack")
    dst = from_numpy(arrays, cuda_device)
    for state in (entry, mid):
        nodes = (state.node_idle, state.node_releasing, state.node_ports, state.node_num_tasks)
        dnodes = tuple(x.to(cuda_device) for x in nodes)
        for policy in ("binpack", "spread", "first_fit"):
            v = "first_fit" if policy == "first_fit" else variant
            plan = k9.TurnCapsPlan(dst, *dnodes, 4096, False, True, policy, v)
            for g in (0, 7, 31):
                req = st.group_resreq[g].contiguous()
                k, nperm = plan(torch.tensor([g], device=cuda_device), req.to(cuda_device))
                kp, pp = k9.turn_caps_plain(st, *nodes, torch.tensor([g]), req, None, 4096,
                                            False, True, policy)
                assert torch.equal(k.cpu(), kp)
                assert (nperm is None) == (pp is None)
                assert pp is None or torch.equal(nperm.cpu(), pp)


@pytest.mark.cuda
def test_pa_fit_plan_back_to_back_on_card(cuda_device):
    arrays, st, entry, mid = _world(True, "binpack")
    dst = from_numpy(arrays, cuda_device)
    plan = k11.PaFitPlan(dst)
    n0 = k11.pa_fit.launches
    calls = 0
    for state in (entry, mid, entry):
        ts, tn = state.task_status.to(cuda_device), state.task_node.to(cuda_device)
        for g in range(0, st.num_groups, 3):  # every third group of the pack
            got = plan(torch.tensor([g], device=cuda_device), ts, tn)
            want = k11.pa_fit_plain(st, torch.tensor([g]), state.task_status, state.task_node)
            calls += 1
            for name in want._fields:
                assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), f"group {g}: {name}"
    assert k11.pa_fit.launches == n0 + calls
