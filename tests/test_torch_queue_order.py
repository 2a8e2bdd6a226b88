"""K17 ``queue_order`` (B3, a round's queue order) held against the JAX
package.

The kernel's plain version (stable sorts, least significant key first)
must give ``jnp.lexsort``'s permutation on key stacks with ties, -0.0
beside +0.0, NaN and BIG, and the port's ``queue_perm`` the reference's
round order (ops/preempt.py:_queue_perm) on the same queue state.
Permutations are integers: tolerance none.  The kernel itself runs only
on the card (a ``cuda``-marked test, and chip_smoke.py's ``k17_case``).
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
    perm, nq = k17.queue_order(torch.from_numpy(keys), torch.ones(6, dtype=torch.bool))
    assert perm.tolist() == [0, 1, 4, 5, 3, 2] == jnp_order(keys).tolist()
    assert perm.dtype == torch.int64 and nq.dtype == torch.int32 and int(nq) == 6


@pytest.mark.parametrize("Q", [1, 8, 64, 512])
@pytest.mark.parametrize("K", [1, 3])
def test_plain_order_equals_jnp_lexsort(Q, K):
    rng = np.random.default_rng(Q * 10 + K)
    for _ in range(3):
        keys = key_stack(rng, K, Q)
        active = torch.from_numpy(keys[0] == 0)
        perm, nq = k17.queue_order(torch.from_numpy(keys), active)
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
    with pytest.raises(TypeError):
        k17.queue_order(torch.zeros((2, 4), dtype=torch.float64), torch.ones(4, dtype=torch.bool))
    with pytest.raises(TypeError):
        k17.queue_order(torch.zeros((k17.MAX_KEYS + 1, 4)), torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        k17.queue_order(torch.zeros((2, 4)), torch.ones(5, dtype=torch.bool))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [8, 512, 4096])
def test_kernel_matches_plain_on_card(cuda_device, Q):
    rng = np.random.default_rng(Q)
    keys = key_stack(rng, 3, Q)
    active = torch.from_numpy(keys[0] == 0)
    want, want_nq = k17.queue_order_plain(torch.from_numpy(keys), active)
    before = k17.queue_order.launches
    perm, nq = k17.queue_order(torch.from_numpy(keys).to(cuda_device), active.to(cuda_device))
    assert k17.queue_order.launches == before + 1
    assert torch.equal(perm.cpu(), want) and int(nq) == int(want_nq)
