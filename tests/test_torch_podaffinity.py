"""The port's pod (anti-)affinity held against the JAX package.

* K11 / K12's plain versions (``pod_affinity_fit``, ``apply_seed``,
  ``apply_domain_cap``) against the reference's functions on a seeded
  pack with several terms per key and over several keys, nodes without
  some topology labels, existing pods with anti terms, and a mid-cycle
  state of placed pods; with and without a packing order.
* The 13 scenarios of tests/test_pod_affinity.py, built through the
  reference's ``build_snapshot`` and decided by both packages under the
  default conf and under the evictive conf (reclaim, allocate, backfill,
  preempt).
* The port generator's pa tables against the reference's
  ``_build_pod_affinity`` on the same labels and terms, at 2k x 200.

Everything compared is integer or bool, or an f32 sum of integer device
units under 2^24: every field must be equal (tolerance: none).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_arbitrator_tpu.api import PodAffinityTerm, TaskStatus
from kube_arbitrator_tpu.api.info import NodeInfo, TaskInfo
from kube_arbitrator_tpu.cache import SimCluster, build_snapshot
from kube_arbitrator_tpu.cache import snapshot as ref_snapshot
from kube_arbitrator_tpu.ops import cycle as ref_cycle
from kube_arbitrator_tpu.ops import podaffinity as ref_pa
from kube_arbitrator_tpu_torch.cache import synth as port_synth
from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
from kube_arbitrator_tpu_torch.ops import cycle as port_cycle
from kube_arbitrator_tpu_torch.ops.kernels import pa_fit as k11
from kube_arbitrator_tpu_torch.ops.kernels import pa_shape as k12

GB = 1024**3
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
RACK = "topology.kubernetes.io/rack"
FULL = ("reclaim", "allocate", "backfill", "preempt")
PA_FIELDS = (
    "task_pa_class", "group_pa_class", "group_aff_terms", "group_anti_terms", "node_dom",
    "aff_key", "anti_key", "aff_static", "anti_static", "aff_static_total", "aff_match",
    "anti_match", "symm_ok",
)


def pack_arrays(st):
    return {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)}


def jnp_pack(st):
    """The reference pack with its arrays as jax arrays."""
    return dataclasses.replace(st, **{
        f.name: jnp.asarray(getattr(st, f.name)) for f in dataclasses.fields(st)
        if isinstance(getattr(st, f.name), np.ndarray)
    })


def assert_decisions_equal(ref, port, ctx=""):
    for f in dataclasses.fields(port):
        a = np.asarray(getattr(ref, f.name))
        b = getattr(port, f.name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f"{ctx}{f.name}: {a.shape} vs {b.shape}"
        assert np.array_equal(a, b), f"{ctx}{f.name} diverged"


# ---------------------------------------------------------------- the kernels


def _random_pa_world(seed):
    """A pack exercising every branch of the fit: three topology keys with
    nodes lacking some labels, tasks with several terms per key and over
    several keys (self and cross, affinity and anti), a namespace apart,
    and RUNNING pods with labels and anti terms of their own."""
    rng = np.random.default_rng(seed)
    sim = SimCluster()
    sim.add_queue("q")
    for n in range(12):
        labels = {HOST: f"n{n}"}
        if n % 5 != 4:
            labels[ZONE] = "abc"[n % 3]
        if n % 4 != 3:
            labels[RACK] = f"r{n // 3}"
        sim.add_node(f"n{n:02d}", cpu_milli=16000, memory=32 * GB, labels=labels)
    apps = ["a", "b", "c", "d"]
    keys = [ZONE, RACK, HOST]
    for j in range(3):  # running pods, some with anti terms
        job = sim.add_job(f"run{j}", queue="q", namespace="other" if j == 2 else "default")
        for i in range(3):
            terms = []
            if rng.random() < 0.5:
                terms = [PodAffinityTerm(match_labels=(("app", apps[int(rng.integers(4))]),),
                                         topology_key=keys[int(rng.integers(3))], anti=True)]
            sim.add_task(job, 500, GB, status=TaskStatus.RUNNING,
                         node=f"n{int(rng.integers(12)):02d}", name=f"run{j}-{i}",
                         labels={"app": apps[int(rng.integers(4))], "tier": "x"}, affinity=terms)
    for j in range(7):
        job = sim.add_job(f"p{j}", queue="q")
        app = apps[j % 4]
        terms = []
        for _ in range(int(rng.integers(0, 4))):
            target = app if rng.random() < 0.5 else apps[int(rng.integers(4))]
            terms.append(PodAffinityTerm(match_labels=(("app", target),),
                                         topology_key=keys[int(rng.integers(3))],
                                         anti=bool(rng.random() < 0.5)))
        for i in range(int(rng.integers(2, 5))):
            sim.add_task(job, 500, GB, name=f"p{j}-{i}", labels={"app": app}, affinity=terms)
    return sim


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pa_kernels_match_reference(seed):
    st = build_snapshot(_random_pa_world(seed).cluster).tensors
    assert st.node_dom.shape[0] == 3 and (st.node_dom[:, :12] < 0).any(), "domain-less nodes"
    assert max(st.group_aff_terms.shape[1], st.group_anti_terms.shape[1]) >= 2
    jst = jnp_pack(st)
    pst = from_numpy(pack_arrays(st), "cpu")
    rng = np.random.default_rng(100 + seed)
    T, N = st.num_tasks, st.num_nodes
    # a mid-cycle state: some pending tasks placed (ALLOCATED or PIPELINED)
    status = np.asarray(st.task_status).copy()
    node = np.asarray(st.task_node).copy()
    pend = np.nonzero((status == int(TaskStatus.PENDING)) & np.asarray(st.task_valid))[0]
    chosen = pend[rng.random(len(pend)) < 0.4]
    status[chosen] = rng.choice([int(TaskStatus.ALLOCATED), int(TaskStatus.PIPELINED)], len(chosen))
    node[chosen] = rng.integers(0, 12, len(chosen))
    flags = 0
    for g in range(int(np.asarray(st.group_valid).sum())):
        for s_, n_ in ((np.asarray(st.task_status), np.asarray(st.task_node)), (status, node)):
            ref = ref_pa.pod_affinity_fit(jst, jnp.int32(g), jnp.asarray(s_), jnp.asarray(n_))
            got = k11.pa_fit(pst, torch.tensor([g]), torch.from_numpy(s_), torch.from_numpy(n_))
            for name in ref._fields:
                assert np.array_equal(np.asarray(getattr(ref, name)), getattr(got, name).numpy()), \
                    f"group {g}: {name}"
            flags += int(got.seed_flags.sum()) + int(got.cap_flags.sum())
    assert flags > 0
    # seed, then cap: several terms over several keys (flags drawn), on
    # random capacity, in node order and in a packing order
    K = st.node_dom.shape[0]
    for trial in range(12):
        MA, MB = int(rng.integers(1, 4)), int(rng.integers(1, 4))
        sf, sk = rng.random(MA) < 0.7, rng.integers(0, K, MA).astype(np.int32)
        cf, ck = rng.random(MB) < 0.7, rng.integers(0, K, MB).astype(np.int32)
        ok = np.ones(N, bool)
        ref = ref_pa.PodAffinityFit(jnp.asarray(ok), jnp.asarray(sf), jnp.asarray(sk),
                                    jnp.asarray(cf), jnp.asarray(ck))
        got = k11.PodAffinityFit(*(torch.from_numpy(a) for a in (ok, sf, sk, cf, ck)))
        k = (rng.integers(0, 4, N) * (rng.random(N) < 0.7)).astype(np.int32)
        nperm = None if trial % 2 else rng.permutation(N).astype(np.int32)
        ks = np.asarray(ref_pa.apply_seed(jst, ref, jnp.asarray(k)))
        kp = ks if nperm is None else ks[nperm]
        want = np.asarray(ref_pa.apply_domain_cap(
            jst, ref, jnp.asarray(kp), None if nperm is None else jnp.asarray(nperm)))
        kt = torch.from_numpy(k if nperm is None else k[nperm])
        pt = None if nperm is None else torch.from_numpy(nperm)
        assert np.array_equal(k12.apply_seed(pst, got, kt, pt).numpy(), kp), f"trial {trial}: seed"
        shaped = k12.pa_shape(pst, got, torch.stack([kt, kt.flip(0)]), pt)
        assert np.array_equal(shaped[0].numpy(), want), f"trial {trial}: seed + cap"


# ---------------------------------------------------------------- the scenarios


def zone_cluster(n_per_zone=2, zones=("a", "b", "c"), cpu=4000):
    sim = SimCluster()
    sim.add_queue("q")
    for z in zones:
        for i in range(n_per_zone):
            sim.add_node(f"{z}{i}", cpu_milli=cpu, labels={ZONE: z, HOST: f"{z}{i}"})
    return sim


def _term(app, key=ZONE, anti=False, namespaces=()):
    return PodAffinityTerm(match_labels=(("app", app),), topology_key=key, anti=anti,
                           namespaces=namespaces)


def _affinity_to_existing_pod():
    sim = zone_cluster()
    j0 = sim.add_job("leader", queue="q")
    sim.add_task(j0, 100, 0, name="lead", status=TaskStatus.RUNNING, node="b0",
                 labels={"app": "store"})
    j1 = sim.add_job("follower", queue="q")
    sim.add_task(j1, 100, 0, name="f1", affinity=[_term("store")])
    return sim


def _affinity_unsatisfiable_blocks():
    sim = zone_cluster()
    j = sim.add_job("j", queue="q")
    sim.add_task(j, 100, 0, name="t", affinity=[_term("ghost")])
    return sim


def _self_affinity_gang_colocates():
    sim = zone_cluster(n_per_zone=2, cpu=4000)
    j = sim.add_job("gang", queue="q", min_available=4)
    for i in range(4):
        sim.add_task(j, 1500, 0, name=f"g{i}", labels={"app": "ring"}, affinity=[_term("ring")])
    return sim


def _anti_spread(replicas):
    sim = zone_cluster(n_per_zone=2)
    j = sim.add_job("spread", queue="q")
    for i in range(replicas):
        sim.add_task(j, 100, 0, name=f"s{i}", labels={"app": "web"},
                     affinity=[_term("web", anti=True)])
    return sim


def _anti_affinity_against_existing():
    sim = zone_cluster()
    j0 = sim.add_job("old", queue="q")
    sim.add_task(j0, 100, 0, name="old1", status=TaskStatus.RUNNING, node="b1",
                 labels={"app": "db"})
    j1 = sim.add_job("new", queue="q")
    sim.add_task(j1, 100, 0, name="n1", affinity=[_term("db", anti=True)])
    return sim


def _anti_affinity_symmetry_existing_pod():
    sim = zone_cluster()
    j0 = sim.add_job("guard", queue="q")
    sim.add_task(j0, 100, 0, name="guard1", status=TaskStatus.RUNNING, node="a0",
                 labels={"app": "guard"},
                 affinity=[PodAffinityTerm(match_labels=(("role", "intruder"),),
                                           topology_key=ZONE, anti=True)])
    j1 = sim.add_job("new", queue="q")
    sim.add_task(j1, 100, 0, name="i1", labels={"role": "intruder"})
    return sim


def _anti_affinity_dynamic_symmetry():
    sim = zone_cluster(n_per_zone=1, zones=("a", "b"))
    j0 = sim.add_job("first", queue="q", creation_ts=0.0)
    sim.add_task(j0, 100, 0, name="f1", labels={"app": "guard"},
                 affinity=[PodAffinityTerm(match_labels=(("role", "intruder"),),
                                           topology_key=ZONE, anti=True)])
    j1 = sim.add_job("second", queue="q", creation_ts=1.0)
    sim.add_task(j1, 100, 0, name="i1", labels={"role": "intruder"})
    return sim


def _hostname_affinity_same_node():
    sim = zone_cluster()
    j0 = sim.add_job("lead", queue="q")
    sim.add_task(j0, 100, 0, name="lead1", status=TaskStatus.RUNNING, node="c1",
                 labels={"app": "cache"})
    j1 = sim.add_job("f", queue="q")
    sim.add_task(j1, 100, 0, name="f1", affinity=[_term("cache", key=HOST)])
    return sim


def _namespace_scoping(namespaces):
    sim = zone_cluster()
    j0 = sim.add_job("other-ns", queue="q", namespace="other")
    sim.add_task(j0, 100, 0, name="o1", status=TaskStatus.RUNNING, node="a0",
                 labels={"app": "store"})
    j1 = sim.add_job("mine", queue="q", namespace="default")
    sim.add_task(j1, 100, 0, name="m1", affinity=[_term("store", namespaces=namespaces)])
    return sim


def _oracle_agreement_mixed():
    rng = np.random.default_rng(7)
    sim = zone_cluster(n_per_zone=2, cpu=3000)
    apps = ["a", "b", "c"]
    for ji in range(4):
        j = sim.add_job(f"j{ji}", queue="q", creation_ts=float(ji))
        for ti in range(3):
            app = apps[int(rng.integers(0, len(apps)))]
            r = rng.random()
            terms = [_term(app)] if r < 0.4 else ([_term(app, anti=True)] if r < 0.7 else [])
            sim.add_task(j, 500, 0, name=f"j{ji}t{ti}", labels={"app": app}, affinity=terms)
    return sim


def _self_anti_affinity_two_keys_spreads_both():
    sim = zone_cluster(n_per_zone=2, zones=("a", "b"), cpu=8000)
    j = sim.add_job("spread", queue="q", min_available=2)
    terms = [_term("x", key=HOST, anti=True), _term("x", key=ZONE, anti=True)]
    for i in range(2):
        sim.add_task(j, 500, 0, name=f"s{i}", labels={"app": "x"}, affinity=terms)
    return sim


def _self_affinity_two_keys_colocates_both():
    sim = SimCluster()
    sim.add_queue("q")
    for z in ("a", "b"):
        for r in ("r1", "r2"):
            sim.add_node(f"{z}-{r}", cpu_milli=8000, labels={ZONE: z, RACK: r, HOST: f"{z}-{r}"})
    j = sim.add_job("cell", queue="q", min_available=2)
    terms = [_term("c", key=ZONE), _term("c", key=RACK)]
    for i in range(2):
        sim.add_task(j, 500, 0, name=f"c{i}", labels={"app": "c"}, affinity=terms)
    return sim


SCENARIOS = {
    "affinity_to_existing_pod": _affinity_to_existing_pod,
    "affinity_unsatisfiable_blocks": _affinity_unsatisfiable_blocks,
    "self_affinity_gang_colocates": _self_affinity_gang_colocates,
    "anti_affinity_spreads_one_per_zone": lambda: _anti_spread(3),
    "anti_affinity_overflow_stays_pending": lambda: _anti_spread(4),
    "anti_affinity_against_existing": _anti_affinity_against_existing,
    "anti_affinity_symmetry_existing_pod": _anti_affinity_symmetry_existing_pod,
    "anti_affinity_dynamic_symmetry": _anti_affinity_dynamic_symmetry,
    "hostname_affinity_same_node": _hostname_affinity_same_node,
    "namespace_scoping": lambda: _namespace_scoping(()),
    "namespace_scoping_explicit": lambda: _namespace_scoping(("other",)),
    "oracle_agreement_mixed": _oracle_agreement_mixed,
    "self_anti_affinity_two_keys_spreads_both": _self_anti_affinity_two_keys_spreads_both,
    "self_affinity_two_keys_colocates_both": _self_affinity_two_keys_colocates_both,
}


@pytest.mark.parametrize("actions", [("allocate", "backfill"), FULL], ids=["default", "evictive"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pa_scenarios_match_reference(name, actions):
    st = build_snapshot(SCENARIOS[name]().cluster).tensors
    ref = ref_cycle.schedule_cycle(st, actions=actions)
    port = port_cycle.schedule_cycle(from_numpy(pack_arrays(st), "cpu"), actions=actions)
    assert_decisions_equal(ref, port, f"{name}: ")


# ---------------------------------------------------------------- the generator


def test_pa_tables_match_reference_builder():
    """The port generator's pa tables equal the reference's
    ``_build_pod_affinity`` (and its group columns) on the same labels
    and terms; the other arrays equal the world without affinity."""
    kw = dict(num_tasks=2000, num_nodes=200, num_queues=4, tasks_per_job=20, seed=5,
              running_fraction=0.5)
    arrays, _ = port_synth.build_synthetic_arrays(**kw, pod_affinity=True)
    plain, _ = port_synth.build_synthetic_arrays(**kw)
    for name, a in plain.items():
        if name not in PA_FIELDS:
            assert np.array_equal(arrays[name], a), f"{name} changed with pod_affinity"
    T, N = arrays["task_resreq"].shape[0], arrays["node_idle"].shape[0]
    N_real, T_real = kw["num_nodes"], kw["num_tasks"]
    J_real = T_real // kw["tasks_per_job"]
    task_job, status = arrays["task_job"], arrays["task_status"]
    running_job = np.zeros(J_real, bool)
    running_job[task_job[:T_real][status[:T_real] == int(TaskStatus.RUNNING)]] = True
    tier, pending_terms, running_terms = port_synth.pa_world_labels(kw["seed"], J_real, running_job)
    assert pending_terms and running_terms and (tier == "latency").any()

    def ref_terms(terms):
        return tuple(PodAffinityTerm(match_labels=(t.label,), topology_key=t.key, anti=t.anti)
                     for t in terms)

    nodes = []
    for n in range(N_real):
        rack = n // port_synth.NODES_PER_RACK
        nodes.append(NodeInfo(name=f"n{n:05d}", ordinal=n, labels={
            port_synth.HOSTNAME_KEY: f"h{n}", port_synth.RACK_KEY: f"r{rack}",
            port_synth.ZONE_KEY: f"z{rack % port_synth.NUM_ZONES}"}))
    tasks = []
    for t in range(T_real):
        k = int(task_job[t])
        labels = {"app": f"job-{k}"}
        if tier[k]:
            labels["tier"] = tier[k]
        terms = running_terms.get(k, ()) if running_job[k] else pending_terms.get(k, ())
        task = TaskInfo(uid=f"t{t:06d}", job_uid=f"j{k}", status=TaskStatus(int(status[t])),
                        labels=labels, affinity_terms=ref_terms(terms), ordinal=t)
        tasks.append(task)
        if arrays["task_node"][t] >= 0:
            nodes[int(arrays["task_node"][t])].tasks[task.uid] = task
    ref = ref_snapshot._build_pod_affinity(tasks, nodes, T, N)
    for name in PA_FIELDS:
        if name in ref:
            assert np.array_equal(ref[name], arrays[name]), name
            assert ref[name].dtype == arrays[name].dtype, name
    assert arrays["symm_ok"].shape[0] > 0 and arrays["node_dom"].shape[0] == 3
    # group columns: the sorted term set of each group's first task
    group_job = arrays["group_job"]
    for g in range(int(arrays["group_valid"].sum())):
        rep = int(np.nonzero(arrays["task_group"] == g)[0][0])
        assert arrays["group_pa_class"][g] == ref["task_pa_class"][rep]
        for col, per in (("group_aff_terms", ref["task_aff"]), ("group_anti_terms", ref["task_anti"])):
            want = sorted(set(per.get(rep, ())))
            row = arrays[col][g]
            assert list(row[row >= 0]) == want, (col, g, int(group_job[g]))
