"""Subnormal floats in the port's shares, held against the JAX package.

XLA:CPU (and the TPU, which has no subnormals) flushes them: a subnormal
f32 input of an operation reads as a zero of its sign, and a result that
would be subnormal is a zero of its sign.  The first tests pin what the
reference's ``safe_share`` does with them on the CPU:

* a subnormal numerator reads as zero: the share is a zero of its sign;
* a subnormal denominator reads as a zero total: the share is 1 when the
  allocation is positive, else 0;
* a quotient that comes out subnormal (2e-38 / 2,000) is zero;
* -0.0 keeps its sign through the division (-0.0 / 1 = -0.0), and a
  -0.0 total is a zero total;
* a NaN allocation gives NaN over a positive total; a NaN total is not
  positive, so the share takes the zero-total convention.

The port's ``common.safe_share`` flushes in the same places (its ``ftz``
helper), so ``safe_share``, ``dominant_share``, ``fairness.queue_shares``,
``fairness.drf_shares``, ``fairness.overused`` and K9's packing key
equal the reference's bit for bit, sign and NaN included, on those rows
and on seeded random states drawn from a pool of subnormal, signed-zero,
NaN, zero and normal values (tolerance: none).  One sign is not held: a
max over shares that are zeros of both signs is +0.0 in XLA (its max
orders -0.0 below +0.0) and -0.0 in torch when a -0.0 comes first
(``amax`` keeps the first of equal values).  Every consumer of a
dominant share compares or subtracts it, and K17's and K9's keys fold
-0.0 into +0.0, so no decision sees that sign (ROADMAP queue C).
"""
from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.ops import common as ref_common
from kube_arbitrator_tpu.ops import fairness as ref_fair
from kube_arbitrator_tpu_torch.ops import common as port_common
from kube_arbitrator_tpu_torch.ops import fairness as port_fair
from kube_arbitrator_tpu_torch.ops.kernels import turn_caps as k9

f32 = np.float32
SUB = f32(1e-39)  # subnormal: below FLT_MIN = 1.1754944e-38

# (alloc, total, the reference's share on the CPU)
PINNED = {
    "subnormal_numerator": (SUB, f32(1.0), f32(0.0)),
    "negative_subnormal_numerator": (-SUB, f32(1.0), f32(-0.0)),
    "subnormal_denominator": (f32(1.0), SUB, f32(1.0)),
    "negative_subnormal_denominator": (f32(1.0), -SUB, f32(1.0)),
    "subnormal_over_subnormal": (SUB, SUB, f32(0.0)),
    "subnormal_over_zero": (SUB, f32(0.0), f32(0.0)),
    "subnormal_quotient": (f32(2e-38), f32(2000.0), f32(0.0)),
    "negative_subnormal_quotient": (f32(-2e-38), f32(2000.0), f32(-0.0)),
    "least_normal_kept": (f32(1.17549435e-38), f32(1.0), f32(1.17549435e-38)),
    "negative_zero_numerator": (f32(-0.0), f32(1.0), f32(-0.0)),
    "negative_zero_total": (f32(1.0), f32(-0.0), f32(1.0)),
    "nan_numerator": (f32(np.nan), f32(1.0), f32(np.nan)),
    "nan_total": (f32(1.0), f32(np.nan), f32(1.0)),
    "zero_total_zero_alloc": (f32(0.0), f32(0.0), f32(0.0)),
    "zero_total_positive_alloc": (f32(1.0), f32(0.0), f32(1.0)),
    "zero_total_negative_alloc": (f32(-1.0), f32(0.0), f32(0.0)),
}

POOL = np.array([0.0, -0.0, 1e-39, -1e-39, 5e-45, 2e-38, -2e-38, 1.17549435e-38, 1.0, -1.0,
                 1000.0, 2000.0, 1e-31, np.nan, np.inf, 3.0e38], f32)


def same_bits(a: np.ndarray, b: np.ndarray, zero_sign: bool = True) -> bool:
    """Equal bit for bit, any NaN equal to any NaN; without ``zero_sign``
    -0.0 equals +0.0 (a max over zeros of both signs: see below)."""
    a, b = np.asarray(a, f32), np.asarray(b, f32)
    if not zero_sign:
        a, b = a + f32(0.0), b + f32(0.0)
    nan = np.isnan(a) & np.isnan(b)
    return bool(np.all(nan | (a.view(np.int32) == b.view(np.int32))))


@pytest.mark.parametrize("case", sorted(PINNED))
def test_reference_share_flushes_and_port_equals_it(case):
    alloc, total, want = PINNED[case]
    a, t = np.array([alloc], f32), np.array([total], f32)
    ref = np.asarray(ref_common.safe_share(jnp.asarray(a), jnp.asarray(t)))
    assert same_bits(ref, [want]), f"XLA:CPU's share of {alloc!r} / {total!r} is {ref[0]!r}"
    got = port_common.safe_share(torch.from_numpy(a), torch.from_numpy(t)).numpy()
    assert same_bits(got, ref)


def test_ftz_flushes_only_subnormals():
    x = np.array([1e-39, -1e-39, 5e-45, 1.17549435e-38, -1.17549435e-38, 0.0, -0.0, 1.0,
                  np.nan, np.inf, -np.inf], f32)
    want = np.array([0.0, -0.0, 0.0, 1.17549435e-38, -1.17549435e-38, 0.0, -0.0, 1.0,
                     np.nan, np.inf, -np.inf], f32)
    assert same_bits(port_common.ftz(torch.from_numpy(x)).numpy(), want)
    assert port_common.FLT_MIN == float(np.finfo(f32).tiny)


def test_table_rows_queue_shares_and_overused():
    """ROADMAP C4's three rows (R = 5, three queues): the share column."""
    alloc = np.zeros((3, 5), f32)
    deserved = np.ones((3, 5), f32)
    alloc[:, 0] = [1e-39, 2e-38, 1.0]
    deserved[:, 0] = [1.0, 2000.0, 1e-39]
    ref = np.asarray(ref_fair.queue_shares(jnp.asarray(alloc), jnp.asarray(deserved)))
    assert same_bits(ref, [0.0, 0.0, 1.0])
    got = port_fair.queue_shares(torch.from_numpy(alloc), torch.from_numpy(deserved)).numpy()
    assert same_bits(got, ref)
    ref_o = np.asarray(ref_fair.overused(jnp.asarray(alloc), jnp.asarray(deserved)))
    got_o = port_fair.overused(torch.from_numpy(alloc), torch.from_numpy(deserved)).numpy()
    assert np.array_equal(got_o, ref_o)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_shares_equal_reference_on_random_states(seed):
    rng = np.random.default_rng(seed)
    Q, R = 256, 5
    alloc = POOL[rng.integers(0, len(POOL), (Q, R))]
    total = POOL[rng.integers(0, len(POOL), (Q, R))]
    a_t, t_t = torch.from_numpy(alloc), torch.from_numpy(total)
    a_j, t_j = jnp.asarray(alloc), jnp.asarray(total)
    assert same_bits(port_common.safe_share(a_t, t_t).numpy(),
                     np.asarray(ref_common.safe_share(a_j, t_j)))
    assert same_bits(port_common.dominant_share(a_t, t_t).numpy(),
                     np.asarray(ref_common.dominant_share(a_j, t_j)), zero_sign=False)
    assert same_bits(port_fair.queue_shares(a_t, t_t).numpy(),
                     np.asarray(ref_fair.queue_shares(a_j, t_j)), zero_sign=False)
    assert np.array_equal(port_fair.overused(a_t, t_t).numpy(),
                          np.asarray(ref_fair.overused(a_j, t_j)))
    # DRF: one cluster total row for every job
    assert same_bits(port_fair.drf_shares(a_t, t_t[0]).numpy(),
                     np.asarray(ref_fair.drf_shares(a_j, t_j[0])), zero_sign=False)
    # the subnormal rows really were drawn
    assert (np.abs(alloc[alloc != 0]) < np.finfo(f32).tiny).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_packing_key_equals_reference_used_share(seed):
    """K9's binpack / spread key over node rows whose used capacity or
    total is subnormal: the reference's ``dominant_share(max(alloc -
    idle, 0), alloc)`` (ops/allocate.py:638), negated for binpack."""
    rng = np.random.default_rng(seed)
    N, R = 128, 5
    node_alloc = np.where(rng.random((N, R)) < 0.3, SUB,
                          f32(4000.0) * rng.integers(0, 3, (N, R))).astype(f32)
    used = np.where(rng.random((N, R)) < 0.4, f32(2e-38), f32(0.0))
    node_idle = (node_alloc - used).astype(f32)
    st = types.SimpleNamespace(node_alloc=torch.from_numpy(node_alloc),
                               node_valid=torch.ones(N, dtype=torch.bool))
    ref_used = np.asarray(ref_common.dominant_share(
        jnp.maximum(jnp.asarray(node_alloc) - jnp.asarray(node_idle), 0.0),
        jnp.asarray(node_alloc)))
    for policy, sign in (("binpack", -1), ("spread", 1)):
        got = k9.packing_key_f32(st, torch.from_numpy(node_idle), policy).numpy()
        want = (sign * ref_used).astype(f32) + f32(0.0)
        assert same_bits(got, want), policy
