"""chip_smoke.py phase 11's legs at a small size: the live worlds (a) and
(b) (``live_world``: apiserver objects, LiveCache, arena, a leader lease,
the apiserver-side kubelet step and burst), the commit fence
(``fence_leg``: a usurped lease discards the leader's cycle with no
apiserver write, the standby binds) and the REST shim (``rest_leg``: one
cycle over ``serve_api`` binds as the in-process run does).  On the CPU
here; the cuda-marked twins run the same legs on the card and hold the
card's records to the CPU's.  Imports no JAX, so it runs on the card's
machine: ``python -m pytest --noconftest -m cuda tests/test_torch_live_card.py``.
"""
from __future__ import annotations

import pytest
import torch

import chip_smoke as smoke

EVICT = ("reclaim", "allocate", "backfill", "preempt")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def live_recipe(device, which, lock_dir):
    """Phase 11's world ``which`` cut to 200 nodes x 20 jobs x 100 tasks:
    each cycle's (binds, evicts by phase, digest, upload mode)."""
    if which == "a":
        world, actions, churn, burst = (dict(smoke.SCHED_A, num_nodes=200, num_jobs=20),
                                        ("allocate", "backfill"), smoke.SCHED_CHURN, None)
    else:
        world, actions, churn, burst = (dict(smoke.SCHED_B, num_nodes=200, num_jobs=20), EVICT,
                                        0.0, smoke.SCHED_B_BURST_AFTER)
    _, rows = smoke.live_world(device, [], which, world, actions, smoke.LIVE_CYCLES, churn,
                               None, (), str(lock_dir), burst)
    return [(r["binds"], r["evicts_by_phase"], r["digest"], r["upload"]) for r in rows]


@pytest.mark.parametrize("which", ["a", "b"])
def test_live_recipe_on_cpu(which, tmp_path):
    rows = live_recipe("cpu", which, tmp_path)
    assert [r[3] for r in rows] == ["full", "delta", "delta"]
    assert rows[0][0] > 0
    if which == "b":
        assert sum(sum(r[1]) for r in rows) > 0


def test_fence_and_rest_legs_on_cpu(tmp_path):
    fence = smoke.fence_leg("cpu", smoke.LIVE_C, str(tmp_path))
    assert all("not actuated" in f["a_lost"] and f["b_binds"] > 0 for f in fence.values())
    # again in the same directory: each call takes a lock of its own
    assert smoke.fence_leg("cpu", smoke.LIVE_C, str(tmp_path)) == fence
    rest = smoke.rest_leg("cpu", dict(smoke.LIVE_D, num_nodes=100, num_jobs=10), timeout_s=10.0)
    assert rest["binds"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["a", "b"])
def test_live_recipe_card_equals_cpu(which, tmp_path):
    card = live_recipe(_card(), which, tmp_path / "card")
    assert card == live_recipe("cpu", which, tmp_path / "cpu")


@pytest.mark.cuda
def test_fence_and_rest_legs_on_card(tmp_path):
    dev = _card()
    fence = smoke.fence_leg(dev, smoke.LIVE_C, str(tmp_path))
    assert fence == smoke.fence_leg("cpu", smoke.LIVE_C, str(tmp_path))  # the same lock dir
    world = dict(smoke.LIVE_D, num_nodes=100, num_jobs=10)
    assert smoke.rest_leg(dev, world, timeout_s=10.0)["binds"] == \
        smoke.rest_leg("cpu", world, timeout_s=10.0)["binds"]
