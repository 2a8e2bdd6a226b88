"""K17 ``queue_order`` (B3, a round's queue order) held against the JAX
package.

The kernel's plain sort (stable sorts, least significant key first)
must give ``jnp.lexsort``'s permutation on key stacks with ties, -0.0
beside +0.0, NaN and BIG, and the port's ``queue_perm`` the reference's
round order (ops/preempt.py:_queue_perm) on the same queue state.
Permutations are integers: tolerance none.  The kernel itself runs only
on the card (a ``cuda``-marked test, and chip_smoke.py's ``k17_case``);
tests/test_torch_order_plans.py holds ``QueueOrderPlan`` against the
reference's key build.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.ops import ordering as ref_ord
from kube_arbitrator_tpu.ops import preempt as ref_pre
from kube_arbitrator_tpu_torch.ops import allocate as port_alloc
from kube_arbitrator_tpu_torch.ops import ordering as port_ord
from kube_arbitrator_tpu_torch.ops.kernels import queue_order as k17

BIG = np.float32(3.0e38)


def key_stack(rng, K, Q):
    """f32[K, Q] keys drawn from a small pool (ties are common) holding
    -0.0, +0.0, NaN and BIG; row 0 is an inactive flag."""
    pool = np.array([0.0, -0.0, 1.0, 0.5, -2.0, np.nan, BIG, 3.0], np.float32)
    keys = pool[rng.integers(0, len(pool), (K, Q))]
    keys[0] = rng.random(Q) < 0.3
    return keys


def jnp_order(keys):
    return np.asarray(jnp.lexsort(tuple(jnp.asarray(k) for k in keys[::-1])))


def test_signed_zero_and_nan_order():
    keys = np.array([[0.0, -0.0, np.nan, 1.0, -0.0, 0.0]], np.float32)
    perm, nq = k17.queue_order_plain(torch.from_numpy(keys), torch.ones(6, dtype=torch.bool))
    assert perm.tolist() == [0, 1, 4, 5, 3, 2] == jnp_order(keys).tolist()
    assert perm.dtype == torch.int64 and nq.dtype == torch.int32 and int(nq) == 6


@pytest.mark.parametrize("Q", [1, 8, 64, 512])
@pytest.mark.parametrize("K", [1, 3])
def test_plain_order_equals_jnp_lexsort(Q, K):
    rng = np.random.default_rng(Q * 10 + K)
    for _ in range(3):
        keys = key_stack(rng, K, Q)
        active = torch.from_numpy(keys[0] == 0)
        perm, nq = k17.queue_order_plain(torch.from_numpy(keys), active)
        assert np.array_equal(perm.numpy(), jnp_order(keys))
        assert int(nq) == int(active.sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("Q", [8, 64])
def test_queue_perm_equals_reference_round_order(seed, Q):
    """The port's queue_perm against the reference's _queue_perm on one
    queue state: shares that tie and that sit on +-0.0, BIG deserved
    (proportion off for a queue), inactive queues."""
    rng = np.random.default_rng(seed)
    R = 4
    alloc = rng.integers(0, 4, (Q, R)).astype(np.float32) * 1000
    deserved = rng.integers(0, 4, (Q, R)).astype(np.float32) * 1000
    deserved[rng.random(Q) < 0.2] = BIG
    uid_rank = rng.permutation(Q).astype(np.int32)
    active = rng.random(Q) < 0.6
    ref_nq, ref_perm = ref_pre._queue_perm(
        types.SimpleNamespace(queue_uid_rank=jnp.asarray(uid_rank)),
        types.SimpleNamespace(deserved=jnp.asarray(deserved)),
        types.SimpleNamespace(queue_alloc=jnp.asarray(alloc)),
        ref_ord.DEFAULT_TIERS, jnp.asarray(active))
    nq, perm = port_alloc.queue_perm(port_ord.DEFAULT_TIERS, torch.from_numpy(active),
                                     torch.from_numpy(alloc), torch.from_numpy(deserved),
                                     torch.from_numpy(uid_rank))
    assert int(nq) == int(ref_nq)
    assert np.array_equal(perm.numpy(), np.asarray(ref_perm))


def test_queue_order_refusals():
    uid = torch.arange(4, dtype=torch.int32)
    tier = port_ord.Tier(plugins=(port_ord.PluginOption.of("proportion"),) * (k17.MAX_KEYS - 1))
    with pytest.raises(ValueError):  # K = MAX_KEYS + 1
        k17.QueueOrderPlan((tier,), torch.zeros((4, 4)), uid)
    with pytest.raises(ValueError):  # fewer columns than the fair resources
        k17.QueueOrderPlan(port_ord.DEFAULT_TIERS, torch.zeros((4, 2)), uid)
    with pytest.raises(ValueError):  # uid rank of another Q
        k17.QueueOrderPlan(port_ord.DEFAULT_TIERS, torch.zeros((4, 4)), uid[:3])
    with pytest.raises(ValueError):
        k17.QueueOrderPlan(port_ord.DEFAULT_TIERS, torch.zeros((4, 4)), uid, variant="tiles")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [8, 512, 4096])
def test_kernel_matches_plain_on_card(cuda_device, Q):
    rng = np.random.default_rng(Q)
    pool = np.array([0.0, -0.0, 1000.0, 500.0, np.nan, 1e-31, 3.0e38], np.float32)
    alloc = pool[rng.integers(0, len(pool), (Q, 4))]
    deserved = pool[rng.integers(0, len(pool), (Q, 4))]
    uid = (rng.integers(0, 3, Q) * (rng.random(Q) < 0.5)).astype(np.int32)
    active = torch.from_numpy(rng.random(Q) < 0.7)
    args = [torch.from_numpy(a) for a in (alloc, deserved, uid)]
    want, want_nq = k17.queue_order_plain(
        k17.queue_keys_plain(port_ord.DEFAULT_TIERS, active, args[0], args[1], args[2]), active)
    for variant in k17.VARIANTS:
        plan = k17.QueueOrderPlan(port_ord.DEFAULT_TIERS, args[1].to(cuda_device),
                                  args[2].to(cuda_device), variant)
        before = k17.queue_order.launches
        perm, nq = plan(active.to(cuda_device), args[0].to(cuda_device))
        assert k17.queue_order.launches == before + 1
        assert torch.equal(perm.cpu(), want) and int(nq) == int(want_nq), variant
