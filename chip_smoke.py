#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--kernels-only]

Needs a CUDA card and nvcc; imports nothing of JAX.  Phases (any failure
exits non-zero; ``--kernels-only`` runs phase 1 alone and prints its
rows):

1. kernels — builds K1-K20 from kube_arbitrator_tpu_torch/ops/kernels/csrc
   (one nvcc per source, in parallel) and holds each against its plain
   PyTorch version, requiring equality: K1 in every variant (full width
   and the pruned panel, one CTA and clusters of 2-8, N not a multiple of
   the tile, the backfill pass; a releasing fallback in a middle slot,
   ports, budget 0, slots landing on the same nodes) and on the main
   path's own recorded launches (the allocate world, seed 42: each launch
   shape timed, and the same slots on N // 8 and N // 4 panels), K2
   through TurnPickPlan at the allocate chunk's shape (5 job keys, 1,024
   jobs and groups, 8 rows; a NaN row, a row past BIG, ties, +-0.0, an
   empty row; the select and pop forms; the unstaged route at 20,480
   jobs and groups), K3-K4 on seeded inputs at the
   allocate path's shapes (100k tasks, 10k nodes, 1k groups), K5 through
   each victim layout's SegScanPlan (by_job, by_queue, by_node_queue,
   each timed with its segments, padding tail and longest masked run;
   the seg_cumsum form; one segment, no masked row, every row masked),
   K6-K8 on the inputs the evictive path gives them in the 50k-task x
   5k-node world (its preempt victim panel, its first preempt turn, its
   first claiming reclaim turn; K6 through ClaimNodesPlan — i64 and i32
   g, preempt and preempt_intra, no victim, the statement gate dropping
   the claim, its folded aggregates against K4's slot-order sums and the
   scatter max / min, and, in the pod-affinity world, its two launches
   around K12; K8 through CanonCommitPlan in each canon
   engine's form — i64 and i32 ordinals, claimed_out, active clear — a
   covering prefix over two jobs and two queues, a failing turn, a window
   longer than its block), K9-K10 on the binpack world's
   turns (100k x 10k: the all-idle entry, where the binpack keys tie at
   -0.0, and a turn after two rounds, binpack and spread; K9 through its
   plans in every variant — one CTA and tiles, first fit, best effort,
   three groups back to back through one plan, N = 10,003, and the
   binpack world at N = 20,480 under binpack and spread, past the
   one-CTA sort — each variant timed), K11-K12 on the pod-affinity
   world's groups after reclaim and three allocate rounds (50k x 5k;
   K11 through one plan, the groups back to back, one launch a call;
   K12 through PaShapePlan at both callers' shapes — the immediate
   turn's two rows shaped in place, preempt's one-row claim — in both
   scratch routes, and a row past the register tile at N = 20,480),
   K13-K15 on the optimistic reclaim engine's first
   speculation window of the q512_evict world (50k x 5k, 512 queues;
   K13 through RoundProductsPlan, the engines' form: a clear dirty flag,
   three launches back to back over in-place changes of the carry, and
   two more packs — one whose padding is its longest run, one with node
   blocks past 32 slots; K14 through UnionFitPlan with and without the
   window's ctl, a window partly and wholly past the trip, no claim, a
   claim only at the last row, every pick at the last schedulable node,
   the batched engine's one-row form, i32 and i64 q, and packs of N =
   1,536 and 128, not multiples of its 1,024-node tile; K15 through
   WindowGatePlan: a claim at row 0 with conflicts, i64 and i32 q_panel,
   no claim, a claim only at the last row, a window before the trip),
   K4 in its callers' forms (ordered and
   unordered at open_session's 102,400 -> 1,024 and
   the evictive world's per-node 51,200 -> 5,120 shapes, _reclaim_fast's
   jstat with 24 slots in range, ordered_sum at 10,240 and 500 rows;
   each route with out= accumulation, i32, every slot dropped, T = 0 and
   one launch a call), K2, K5, K12 and K17: one device event and no
   allocation a launch (K6, K8, K14, K15, K16 and K20 too),
   K16, one launch a call, on its three callers' shapes (a commit list at
   T = 102,400 whose count passes the cap, the commit's bind and evict
   lists as one two-row launch, allocate's feasibility cells at [K,
   10,240] and at K = 3, preempt's full-width victim panel at 51,200 and
   a 102,400 -> 51,200 panel; an empty mask, a cap of one, L not a
   multiple of the chunk), K17 through
   QueueOrderPlan (the keys' build and the order in one launch) on the
   q512_evict world's first reclaim round (Q = 512), the allocate world's
   round (Q = 8) and raw queue states of ties, -0.0, NaN, BIG, zero, tiny
   and subnormal totals at Q = 8 / 512 / 4,096 in both routes (K12 and
   K17: one device event a launch, no allocation), K18 on every field dtype and rank
   with duplicate rows, an empty epoch, and phase 7's first delta epoch of
   the 50k x 5k pack, K19 on preempt's (node, queue) victim lexsort at
   P = 51,200 (negative priorities, INT_MAX padding, ties), the claim-log
   join (J = 512, T = 51,200) and segment_order (102,400 slots -> 1,024
   segments with out-of-range slots, and one segment) and every variant
   (the one-CTA and the tiled sort at n from 1 to 1,048,576 on 1-6 keys
   with and without bounds, keys all equal, descending, INT_MIN /
   INT_MAX, heavy duplicates; the segment order's one-CTA, counting and
   tiled routes; the lookup on both sides), K20 through OrderedScanPlan,
   plain and masked, and ``mm_cumsum`` at every edge of its 16-row blocks
   and 4,096-row tiles (V 1 to 65,537, 200,000 and 1,048,576; C 1 / 3 / 4
   / 9; -0.0; totals past 2^24), timed at _reclaim_fast's shapes.  K17,
   K19 and K20 are held against their plain versions run on the CPU.
   Times the kernel, the plain version and, where one PyTorch call
   computes the same function (K4's, K7's, K11's, K12's and K13's
   sums: ``Tensor.index_add_``; K9's order, K17's and K19's:
   ``torch.sort(stable=True)``; K16: ``torch.nonzero`` plus padding; K18:
   the upload of each field's rows and indices and one ``index_copy_``
   per field; K20: ``torch.cumsum``), that call.  Each
   row has three times: ``ms``, one wrapper call between CUDA events;
   ``device_us``, the kernels' own device time per call (torch.profiler);
   ``host_us``, the wrapper's host time per call with the stream busy.
2. parity — worlds decided on the card and on the CPU by the port's
   ``schedule_cycle``, every CycleDecisions field equal: 1000 x 100
   (allocate, backfill), 5k x 500 and 20k x 2k under the evictive conf
   (reclaim, allocate, backfill, preempt), at 5k x 500 a pod-affinity
   evictive world, an evictive world without the reclaim canon pack
   (``_reclaim_fast`` with its claim log) and a binpack world, and the
   reference's sequential-vs-batched soak shape at q = 64 under
   ``reclaim_optimistic`` (and its ``reclaim_action(turn_batch=True)``,
   every AllocState field equal).
3. allocate at full width — the ``python -m kube_arbitrator_tpu_torch``
   path on four 100k-task x 10k-node worlds (seeds 42, 43, 44 and one
   capacity-tight world): invariants hold and the integer decisions equal
   the port's CPU run of the same world; K2 launches once a turn
   selection (seed 42).
4. the evictive cycle at full width — 50k tasks x 5k nodes, 8 queues,
   half the jobs running, seeds 42 and 43, on the card only: stage times,
   rounds, binds and evictions by phase; invariants; seed 42's counts and
   decision digest equal the JAX package's (EVICT_WORLD_42).
5. the immediate path at full width — the pod-affinity evictive world
   (50k x 5k, seeds 42 and 43: hostname / rack / zone domains and the
   affinity mix of cache/synth.py) and the binpack (seed 42) and spread
   (seed 43) allocate worlds (100k x 10k) on the card: invariants (no
   over-commit, at most one pod of a self-anti-affinity job per node,
   each self-affinity job's pods in one rack); card == CPU on the
   integer fields (the allocate worlds at full width, the pod-affinity
   world at 20k x 2k); seed 42's counts and digests equal the JAX
   package's (PA_WORLD_42, BINPACK_WORLD_42); K9-K12, K19 and K20
   launched (K9 by variant: one CTA on binpack, first fit on the
   pod-affinity path); binpack at 40k x 20k (N = 20,480) decides equal on
   the card and on the CPU through K9's tiled route; K20 once per
   ``mm_cumsum`` of each ``_reclaim_fast`` turn
   (one a turn under the default tiers, whose reclaim verdict is gang's;
   two where proportion is a reclaim verdict).
6. the opt-in reclaim engines at full width — q512_evict (50k x 5k, 512
   queues, half the jobs running; seeds 42 and 43) and rounds_q4 (20k x
   2k, 4 queues, 70% running; seed 42): the canon walk, the round-batched
   and the optimistic engine from one open_session state leave the same
   AllocState and round count (stage times, counters and, for seed 42,
   host syncs printed); the cycle under ``reclaim_optimistic, allocate,
   backfill, preempt`` keeps the invariants of phase 4 and counts claim
   conflicts; seed 42's counts, digest and reclaim counters equal the
   JAX package's (Q512_WORLD_42, ROUNDS_Q4_WORLD_42); card == CPU on the
   integer fields (rounds_q4 at full width, the q512 shape at 20k x 2k);
   K13-K16 launched.  Then one optimistic reclaim action of q512_evict
   (seed 42) under torch.profiler with ``Tensor.to`` watched: its device
   events a window, no cast from ``_reclaim_canon_optimistic``'s own
   frame, K14, K15 and K8 each launched once a window.
7. the serving path at full width — the evictive world (50k x 5k, seed
   42) served for five epochs through ``framework.TorchDecider`` on the
   card: epoch 1 uploads in full and decides like the JAX package
   (EVICT_WORLD_42); before each later epoch 4% of the running tasks
   complete and 1% of the nodes flip their cordon, and the epoch uploads
   only the changed rows (K18).  After every epoch: the resident pack
   equals the host pack bit for bit, the decisions equal a fresh
   upload's, a repeated key reuses with 0 bytes, a delta uploads fewer
   bytes than the full epoch and K18 ran.  The same epochs at 20k x 2k
   decide equal on the card and on the CPU.  Prints each epoch's mode,
   bytes, upload, decide and cycle ms.
8. the evictive cycle under the priority mix at full width — 50k x 5k,
   64 queues, capacity equal to the demand, job / group / task
   priorities 1-3 and pending tails on half the running jobs
   (cache/synth.py ``priority_mix``), seed 45: preempt evicts in phase 2
   and gates at least one round; invariants; the counts and digest equal
   the JAX package's (MIX_WORLD_45); card == CPU in every CycleDecisions
   field at 20k x 2k (seed 43; queue_deserved within its standing rtol
   1e-5).
9. no library sort, search or cummax — the evictive and pod-affinity
   evictive cycles (50k x 5k, seed 42) under torch.profiler: no
   ``aten::sort``, ``aten::argsort``, ``aten::searchsorted`` or
   ``aten::cummax`` event; prints those counts and the device kernels of
   each cycle.  Then one claim turn's tail (``_apply_claim``) of each of
   those cycles under the profiler (host_profile.claim_turn_events): its
   device events by name, no ``scatter_reduce`` (K6 folds the per-node
   victim aggregates), K6 once (twice with pod affinity).  Then one canon
   walk of the evictive world with ``Tensor.to`` watched: its turns hand
   K8 their ordinals as they come (no cast from ``_reclaim_canon``'s own
   frame).
10. the scheduler loop at full width through the port's own modules —
   ``cache/sim.generate_cluster`` -> ``framework.Scheduler(sim,
   decider=TorchDecider(), arena=True)`` (snapshot or arena epoch,
   K1-K20 on the card, decode, columnar actuation, PodGroup status
   write-back) on two worlds: (a) the north star, 10k nodes x 1k jobs x
   100 tasks (T 102,400, N 10,240 padded), default conf, 3 cycles with a
   seeded 4% of the running tasks completing between cycles; (b)
   evictive, 5k nodes x 500 jobs x 100 tasks, half running, under
   reclaim, allocate, backfill, preempt for 3 cycles, a job of priority
   1000 arriving in every queue before the third (``priority_burst``).
   Between cycles bound pods start RUNNING and evicted pods come back
   pending (``kubelet_step``).  Each cycle: ``arena.verify()`` passes,
   cycle 1 uploads in full and each later cycle a delta, K18 launched
   once exactly when the two host packs have a field with some but at
   most half its rows changed (those are the fields the resident wrote;
   world (a)'s cycle 2 places task_status whole and its cycle 3 writes
   it in place, world (b)'s cycle 2 writes task_status and task_node in
   place), the resident pack equals the arena's host pack bit for bit,
   no node of the SimCluster is over-committed and every bound gang
   holds min_available; cycle 1's counts and digest equal the JAX
   package's Scheduler's (SCHED_A_42, SCHED_B_42); world (b) evicts, and
   its third cycle evicts through preempt's claims (K6).  Prints each
   cycle's CycleStats phases (snapshot, upload, kernel, decode, close,
   actuate ms), upload mode and bytes.
11. the live plane at full width — phase 10's worlds written to a
   ``cache/fakeapi.FakeApiServer`` as apiserver objects
   (``cluster_objects``: nodes, queues, one PodGroup a job, pods with
   requests, priority, schedulerName and the group annotation, running
   ones bound) and scheduled by the same ``framework.Scheduler`` over a
   ``cache/live.LiveCache`` (list, then watch), a ``SnapshotArena`` and a
   ``framework/leader.LeaderElector`` on a lock file, a cycle a
   ``run(max_cycles=1)``, for 3 cycles: (a) the north star with 4% of
   the running pods completing between cycles (written to the
   apiserver); (b) the evictive world, its evicted pods recreated
   pending and, before the third cycle, ``live_burst``'s priority-1000
   PodGroups.  Each cycle: the watch drain (timed), every bind a POST
   the apiserver shows (nodeName, Running), every evict a DELETE, one
   PodGroup status PUT a job status, no over-commit counted from the
   apiserver's objects, cycle 1 a full upload and each later one a
   delta after a drain, K18 as in phase 10, resident == host pack;
   cycle 1 equals the JAX package's Scheduler over its LiveCache
   (LIVE_A_42, LIVE_B_42).  (c) the commit fence at 64 x 16 x 8: a
   standby takes the lease (the lock file on a fake clock, and the
   apiserver ConfigMap lock through ``usurp_lease``) at the leader's
   commit hook; the leader's cycle raises LeaderLost with no apiserver
   write, then the standby binds.  (d) ``serve_api`` on 127.0.0.1 at 1k
   nodes x 100 jobs x 20 tasks: one cycle through
   ``LiveCache(HttpApiClient(url))`` binds as the in-process run does,
   and the server shuts down.  Prints each cycle's CycleStats phases,
   sync ms, events drained, bind POSTs, evict DELETEs, status PUTs.
12. the decision pool (``rpc/pool.DecisionPool``) and its batched launch
   (B15, ``ops/cycle.batched_schedule_cycle``: the tenants' cycles in
   lockstep on one stream, one host read a step for all of them).  (a)
   four north-star tenant packs (100k x 10k, 8 queues, allocate +
   backfill; seeds sharing a shape key) in one ``decide_many`` on one
   replica: one batch of 4, each tenant's decisions equal to its own
   unbatched ``TorchDecider`` decide on the card in every CycleDecisions
   field; the batch's host reads against the four cycles' sum and their
   longest, the batch's ms against the four cycles' sum.  (b) the same
   for two tenants of the evictive world (50k x 5k, EVICT_ACTIONS,
   seeds 42 and 43), then a north-star and an evictive pack submitted
   together split into two launches.  (c) the pool behind the port's
   ``Scheduler`` at a small depth (POOL_TENANT worlds): 2 replicas,
   threaded, ``min_fill=4``, four tenants, 3 cycles, bound maps equal to
   independent ``Scheduler(arena=True)`` runs and a launch of 2 or more;
   a replica killed between cycles (inline) costs no decision and
   re-seeds its tenants in full; a partitioned tenant re-seeds in full
   when the partition heals; a tenant burning its budget is shed with
   ``PoolShed`` on a fake clock, then recovers.
13. the pipelined executor and the Scheduler's observability planes.
   (a) phase 10's world (a) twice, default conf, no churn: 3 cycles of
   ``Scheduler(arena=True).run`` on one and ``.run_pipelined`` on the
   other commit the same binds and evicts cycle for cycle with nothing
   discarded, the sequential cycle 1 equals SCHED_A_42; prints each
   cycle's ms, the pipelined commit-to-commit period and the stages'
   occupancy.  (b) phase 10's world (b) in a FakeApiServer under a
   LiveCache, 2 pipelined steps whose ``ingest_fn`` deletes pods, cordons
   a node and shrinks a node's pod capacity inside each speculation
   window (aimed at the window's binds): task_gone, node_unsched and
   capacity_shrunk are counted, and after every commit no node is over
   capacity in the apiserver, no pod is bound twice, none to a cordoned
   node; backpressure fires at an ingest cap of 1.  (c) one evictive
   cycle (world (b)) with the tracer at sample rate 1, the kernel
   profiler, a flight recorder with a 1 ms cycle SLO and ``serve_obs`` on
   127.0.0.1: the chrome export holds the cycle, session, arena and
   ``kernel.<stage>`` spans, ``/debug/kernels`` every stage measured with
   its profiled device ms and launches and ``preempt:phase_a``,
   ``/metrics`` the pipeline families, ``/readyz`` 200, one flight dump
   with the cycle's ``action_ms``, the staged rounds equal the unstaged
   cycle's, and every synchronising CUDA call of the staged cycle is a
   seam read.  (d) one pipelined step of a 1k x 100 x 20 world under
   ``profile_dir``: its trace holds K1's device events.

Each path's launch counts are taken over its first world (seed 42; the
priority-mix path's over seed 45; the scheduler loop's and the live
plane's over every cycle of each world, the counts set to 0 before each
cycle; the pool's over each batch of phase 12 (a) and (b); phase 13's
over the pipelined run of (a), the churned run of (b) and the cycle of
(c)), with every count
set to 0 just before it; K1's, K9's and K19's are also taken by variant (phases 3-5 require
K19's counting segment order on the allocate path and its tiled sort on
the evictive paths).  The kernels line counts K19's launches over the
evictive and the pod-affinity evictive cycles, and K20's over the
latter; its rows carry ``device_us``, ``host_us``, the variants' own
timed cases, the launches by variant in each world and every kernel's
launches in each path's first world (``path_launches``).

Prints each phase's wall time, the card's name and power limit, a JSON
line of per-kernel numbers, and as its last line ``{"ok": true, "device": {...}}``; the
compiler's register and spill report goes to stderr.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

MEM_BW = 3.35e12       # H100 SXM HBM3, bytes/s
F32_PEAK = 67e12       # H100 SXM f32 (non-tensor-core) op/s
INT_MAX = 2**31 - 1
INT_FIELDS = (
    "task_node", "task_status", "bind_mask", "evict_mask", "job_ready",
    "unready_alloc", "node_num_tasks", "node_ports", "evict_claimant",
    "evict_phase", "evict_round", "bind_idx", "bind_node", "evict_idx",
    "bind_count", "evict_count",
)
FULL = dict(tasks=100_000, nodes=10_000, queues=8, tasks_per_job=100)
# binpack past K9's one-CTA sort: N = 20,480 (K9's tiled route)
WIDE_BINPACK = dict(tasks=40_000, nodes=20_000, queues=8, tasks_per_job=100)
WORLDS = (
    dict(seed=42, running_fraction=0.0, fit_fraction=1.2),
    dict(seed=43, running_fraction=0.0, fit_fraction=1.2),
    dict(seed=44, running_fraction=0.0, fit_fraction=1.2),
    dict(seed=45, running_fraction=0.3, fit_fraction=0.9),
)
EVICT_ACTIONS = ("reclaim", "allocate", "backfill", "preempt")
EVICT_FULL = dict(tasks=50_000, nodes=5_000, queues=8, tasks_per_job=100,
                  running_fraction=0.5, fit_fraction=1.2)
EVICT_PARITY = (
    dict(tasks=5_000, nodes=500, queues=8, tasks_per_job=100, seed=42, running_fraction=0.5),
    dict(tasks=20_000, nodes=2_000, queues=4, tasks_per_job=100, seed=42, running_fraction=0.7),
)
# The 50k x 5k seed-42 world under EVICT_ACTIONS as the JAX package
# decides it, from tests/test_torch_evict_fullwidth.py (the port's CPU run
# equals it in every CycleDecisions field); the digest is decision_digest's.
EVICT_WORLD_42 = dict(binds=23_937, evicts_by_phase=[0, 1139, 0, 426], digest="ef1edee61d169ef5")
# The priority-mix evictive world (cache/synth.py ``priority_mix``: job,
# group and task priorities 1-3, a pending tail on half the running jobs),
# 64 queues at capacity equal to the demand, so preempt evicts in phase 2
# and gates a round; seed 45 under EVICT_ACTIONS as the JAX package
# decides it, from tests/test_torch_evict_fullwidth.py (the port's CPU
# run equals it in every integer CycleDecisions field).
MIX_FULL = dict(tasks=50_000, nodes=5_000, queues=64, tasks_per_job=100,
                running_fraction=0.5, fit_fraction=1.0, priority_mix=True)
MIX_WORLD_45 = dict(binds=26_933, evicts_by_phase=[0, 1524, 24, 549], digest="85cf57ccd87b81bf")
# card vs CPU on the priority-mix world at a size the CPU decides quickly
# (seed 43: both preempt phases evict and a round is gated there too)
MIX_CPU_CHECK = dict(MIX_FULL, tasks=20_000, nodes=2_000, seed=43)
SLICE2_KERNELS = ("admit_chunk", "lex_argmin", "decode_deferred", "segment_sum", "seg_scan",
                  "claim_nodes", "canon_pick", "canon_commit")
# The immediate path's full-width worlds as the JAX package decides them,
# from tests/test_torch_immediate_fullwidth.py (the port's CPU run equals
# them in every integer CycleDecisions field): the pod-affinity evictive
# world (EVICT_FULL with pod_affinity, seed 42) and the binpack allocate
# world (FULL, nodeorder binpack, seed 42).
PA_WORLD_42 = dict(binds=19_899, evicts_by_phase=[0, 21, 0, 426], digest="17c5f008e808b91e")
BINPACK_WORLD_42 = dict(binds=96_725, digest="290aa02eea62a7b5")
# card vs CPU on the pod-affinity world at a size the CPU decides quickly
PA_CPU_CHECK = dict(tasks=20_000, nodes=2_000, queues=8, tasks_per_job=100,
                    running_fraction=0.5, fit_fraction=1.2)
# The opt-in reclaim engines' worlds (the reference bench's
# full_actions_q512@50000x5000 and full_actions_rounds_q4@20000x2000) under
# OPT_ACTIONS; seed 42 as the JAX package decides it, from
# tests/test_torch_reclaim_fullwidth.py (the port's CPU run equals it in
# every integer CycleDecisions field and every stage counter).
OPT_ACTIONS = ("reclaim_optimistic", "allocate", "backfill", "preempt")
Q512_EVICT = dict(tasks=50_000, nodes=5_000, queues=512, tasks_per_job=100,
                  running_fraction=0.5, fit_fraction=1.2)
ROUNDS_Q4 = dict(tasks=20_000, nodes=2_000, queues=4, tasks_per_job=100,
                 running_fraction=0.7, fit_fraction=1.2)
Q512_WORLD_42 = dict(binds=24_695, evicts_by_phase=[0, 0, 0, 408], digest="608633b7eb81a733",
                     reclaim_counters=[2, 1, 31_626])
ROUNDS_Q4_WORLD_42 = dict(binds=5_427, evicts_by_phase=[0, 778, 0, 105],
                          digest="9db04e52b1d1becb", reclaim_counters=[19, 1, 84])
# K13's extra packs: a few running tasks on many nodes (the padding past
# the last block is the longest run), and many running tasks a node
# (blocks of more than 32 slots)
K13_PADDING_WORLD = dict(tasks=4_000, nodes=2_000, queues=8, tasks_per_job=100,
                         running_fraction=0.05, fit_fraction=1.2)
K13_LONG_BLOCKS_WORLD = dict(tasks=8_000, nodes=60, queues=8, tasks_per_job=100,
                             running_fraction=0.5, fit_fraction=1.2)
# K14's packs whose N (padded to 128) is not a multiple of its 1,024-node
# tile: 1,536 nodes (a tile and a half), and 128 (less than one)
K14_TILE_EDGE_WORLDS = (
    ("N = 1,536", dict(tasks=12_000, nodes=1_500, queues=64, tasks_per_job=100,
                       running_fraction=0.5, fit_fraction=1.2), 9),
    ("N = 128", K13_LONG_BLOCKS_WORLD, 8),
)
# card vs CPU for the q512 shape at a size the CPU decides quickly
Q512_CPU_CHECK = dict(tasks=20_000, nodes=2_000, queues=512, tasks_per_job=100,
                      running_fraction=0.5, fit_fraction=1.2)
# phase 7: the serving path — the evictive world served epoch by epoch
# through the TorchDecider; before each epoch after the first, 4% of the
# running tasks complete (the reference bench's BENCH_PIPE_CHURN default)
# and 1% of the nodes flip their cordon
SERVE_EPOCHS = 5
SERVE_CHURN = 0.04
SERVE_CORDON = 0.01
# card vs CPU for the serving stream at a size the CPU decides quickly
SERVE_CPU_CHECK = dict(tasks=20_000, nodes=2_000, queues=8, tasks_per_job=100,
                       running_fraction=0.5, fit_fraction=1.2)
# phase 10: the scheduler loop through the port's own modules.  World (a),
# the north star: cache/sim.generate_cluster at 10k nodes x 1k jobs x 100
# tasks (T 102,400 and N 10,240 once padded) under the default conf for
# SCHED_A_CYCLES cycles, with SCHED_CHURN of the running tasks completing
# between cycles; world (b), evictive: 5k nodes x 500 jobs x 100 tasks,
# half of them running, under EVICT_ACTIONS for SCHED_B_CYCLES cycles.
# Between cycles (kubelet_step) bound pods start RUNNING and evicted pods
# come back pending; after world (b)'s cycle SCHED_B_BURST_AFTER a
# high-priority job arrives in every queue (priority_burst), more than the
# cluster holds free, so the next cycle's preempt claims nodes through K6.
SCHED_A = dict(num_nodes=10_000, num_jobs=1_000, tasks_per_job=100, num_queues=8, seed=42)
SCHED_B = dict(num_nodes=5_000, num_jobs=500, tasks_per_job=100, num_queues=8, seed=42,
               running_fraction=0.5)
SCHED_A_CYCLES = 3
SCHED_B_CYCLES = 3
SCHED_B_BURST_AFTER = 2
SCHED_CHURN = 0.04
# Phase 10's delta epochs whose K18 work is known from the recipe:
# (world, cycle) -> (fields whose rows K18 must write in place, fields
# that must be placed whole).  World (a)'s cycle 2 starts nearly every
# task (more than half of task_status's rows change), its cycle 3 only
# the 4% churn; world (b)'s cycle 2 restarts the 24,851 pods bound in
# cycle 1 and 723 evicted ones, just under half of T = 51,200.
SCHED_K18 = {("a", 2): ((), ("task_status",)), ("a", 3): (("task_status",), ()),
             ("b", 2): (("task_status", "task_node"), ())}
# Cycle 1 of each world as the JAX package's Scheduler decides it, from
# tests/test_torch_scheduler.py's slow test (its digest is decision_digest's)
SCHED_A_42 = dict(binds=99_989, evicts=0, evicts_by_phase=[0, 0, 0, 0], digest="dc30e64370254104")
SCHED_B_42 = dict(binds=24_851, evicts=723, evicts_by_phase=[0, 0, 0, 723], digest="4f54be0880803e8d")
# phase 12: the decision pool.  (a) four north-star tenants: the first
# four seeds from POOL_SEEDS whose packs share a shape key; (b) the
# evictive world's seeds 42 and 43; (c) small worlds behind the port's
# Scheduler (generate_cluster, seeds 100-103), 3 cycles
POOL_SEEDS = tuple(range(42, 50))
POOL_NORTH_STAR = dict(FULL, running_fraction=0.0, fit_fraction=1.2)
POOL_EVICT_SEEDS = (42, 43)
POOL_TENANT = dict(num_nodes=500, num_jobs=50, tasks_per_job=20, num_queues=4)
POOL_CYCLES = 3
POOL_A_KERNELS = ("admit_chunk", "lex_argmin", "decode_deferred", "segment_sum", "stable_compact",
                  "queue_order", "stable_sort")
POOL_B_KERNELS = POOL_A_KERNELS + ("seg_scan", "claim_nodes", "canon_pick", "canon_commit")
# the host-read seam's module: every host read of a cycle is made there
SEAM_FILE = "kube_arbitrator_tpu_torch/ops/steps.py"
# phase 2's world of the reference's sequential-vs-batched soak shape at
# q = 64 (few tasks per job, more jobs than queues, oversubscribed)
SOAK_Q64 = dict(tasks=4_000, nodes=400, queues=64, tasks_per_job=20, seed=1,
                running_fraction=0.5, fit_fraction=1.25)
RECLAIM_ENGINES = (None, True, "optimistic")
# phase 2's slice-3 parity worlds: (name, world, canon pack stripped)
PARITY_SLICE3 = (
    ("pod-affinity evictive 5k x 500", dict(tasks=5_000, nodes=500, queues=8, tasks_per_job=100,
                                            seed=42, running_fraction=0.5, fit_fraction=1.25,
                                            pod_affinity=True, actions=EVICT_ACTIONS), False),
    ("no canon pack (_reclaim_fast, claim log) 5k x 500",
     dict(tasks=5_000, nodes=500, queues=8, tasks_per_job=100, seed=42, running_fraction=0.5,
          fit_fraction=1.25, actions=EVICT_ACTIONS), True),
    ("binpack 5k x 500", dict(tasks=5_000, nodes=500, queues=8, tasks_per_job=100, seed=42,
                              node_order="binpack"), False),
)


class SmokeFailure(Exception):
    pass


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int = 20, warmup: int = 2, setup=None) -> float:
    """Mean device time of ``fn`` between CUDA events; ``setup`` runs
    before each call, outside the timed window."""
    for _ in range(warmup):
        if setup:
            setup()
        fn()
    torch.cuda.synchronize()
    total = 0.0
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(reps):
        if setup:
            setup()
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


SPIN = "spin_kernel"  # torch.cuda._sleep's kernel, launched by no wrapper


def profiled_device_events(run) -> list:
    """The device events (kernels, memsets, copies) of ``run()`` under
    torch.profiler.  The profile can lose the record of the first launch
    after it starts (on an H100, 1 profile in 100 of 20 one-kernel
    calls, always the first launch; never one after it): so a spin
    kernel is launched and waited for first, inside the profile, and its
    own event left out."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(2000)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    return [e for e in prof.events()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and SPIN not in e.name]


def device_us(fn, setup=None, calls: int = 50) -> tuple:
    """(device us per call of ``fn``, device kernels per call, source):
    the summed time of the port's own kernels (torch.profiler's CUDA
    kernel events whose names lie in the sources' top-level anonymous
    namespace;
    ``setup``'s kernels and the wrapper's torch kernels excluded) over
    ``calls`` calls.  If the profiler shows no device time, one event
    pair around ``calls`` back-to-back calls with no synchronisation
    between them (that time includes the wrapper's host work wherever
    the host is the slower)."""
    if setup:
        setup()
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            if setup:
                setup()
            fn()

    # two tries: a profile of a kernel that showed on the card in a fresh
    # process once came back without its events late in a phase-1 run
    for _ in range(2):
        own = [e for e in profiled_device_events(run)
               if e.name.startswith(("(anonymous namespace)::", "void (anonymous namespace)::"))]
        if own:
            return (sum(e.time_range.elapsed_us() for e in own) / calls, len(own) / calls,
                    "profiler")
    if setup:
        setup()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(calls):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) * 1e3 / calls, None, "events"


def host_us(fn, setup=None, reps: int = 30) -> float:
    """Least host time of one call of ``fn`` over ``reps`` calls
    (time.perf_counter) with the stream already busy, so that the call
    only enqueues: a wrapper that waits for the device shows the rest of
    the ~10 ms sleep.  The least, because the card's host is shared and
    a call's median moved 2x between calls of the same code."""
    times = []
    for _ in range(reps):
        if setup:
            setup()
        torch.cuda._sleep(20_000_000)
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return min(times) * 1e6


def kernel_times(fn, setup=None) -> dict:
    """A kernel row's three times: ``ms`` one wrapper call between CUDA
    events (device and host work, mean of 20), ``device_us`` the kernels'
    own device time per call, ``host_us`` the wrapper's host time per
    call."""
    d_us, per_call, src = device_us(fn, setup)
    return dict(ms=cuda_ms(fn, setup=setup), device_us=d_us, kernels_per_call=per_call,
                device_by=src, host_us=host_us(fn, setup))


def bound_ms(nbytes: float, nops: float) -> tuple:
    tb, to = nbytes / MEM_BW * 1e3, nops / F32_PEAK * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def decision_digest(bind_mask, evict_mask) -> str:
    """sha256[:16] of the bound and evicted task ordinals (the same
    function as tests/test_torch_evict_fullwidth.py's)."""
    h = hashlib.sha256(np.nonzero(bind_mask)[0].astype(np.int32).tobytes())
    h.update(b"|")
    h.update(np.nonzero(evict_mask)[0].astype(np.int32).tobytes())
    return h.hexdigest()[:16]


def to_cpu(x):
    """A copy of ``x`` on the CPU: tensors, tuples and dataclasses of them."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple):
        vals = [to_cpu(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: to_cpu(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double().cpu() - b.double().cpu()).abs().max())


# ---------------------------------------------------------------- phase 1


def _dt(t) -> str:
    return {torch.float32: "f32", torch.int32: "i32"}.get(t.dtype, str(t.dtype))


def launch_counts(*fns) -> int:
    return sum(f.launches for f in fns)


def sum_form(form, fn, lib_fn, nbytes, nops, counted, shape, note=None) -> dict:
    """One timed form of a sum kernel: its launches a call (the wrappers'
    counts over one call), the three times of :func:`kernel_times`, the
    bound and the library call's time at the same shape."""
    n0 = launch_counts(*counted)
    fn()
    torch.cuda.synchronize()
    per_call = launch_counts(*counted) - n0
    t = kernel_times(fn)
    b, by = bound_ms(nbytes, nops)
    return dict(form=form, launches_per_call=per_call, **t, bound_ms=b, bound_by=by,
                library_ms=cuda_ms(lib_fn) if lib_fn else None, shape=shape, note=note)


def k4_case(dev, fx):
    """K4 in its callers' forms: ordered (``order=`` given), unordered
    (the order computed in the call) and ``ordered_sum`` (one segment),
    each timed at the shapes its callers give it."""
    from kube_arbitrator_tpu_torch.api.types import TaskStatus
    from kube_arbitrator_tpu_torch.ops.kernels import segment_sum as k4
    from kube_arbitrator_tpu_torch.ops.kernels import stable_sort as k19

    rng = np.random.default_rng(4)
    T, J, C = 102_400, 1024, 4
    val = torch.from_numpy((rng.standard_normal((T, C)) * 1000).astype(np.float32)).to(dev)
    idx = torch.from_numpy((np.arange(T) // 100).astype(np.int32)).to(dev)
    out = k4.segment_sum(val, idx, J)
    ref_cpu = k4.segment_sum_plain(val.cpu(), idx.cpu(), J)
    err = max_err(out, ref_cpu)
    expect(torch.equal(out.cpu(), ref_cpu), "K4 f32 differs from its plain version")
    # out-of-range indices dropped, i32 variant, one long segment
    bad = idx.clone()
    bad[::7] = -1
    bad[3::11] = J + 5
    ival = torch.from_numpy(rng.integers(-50, 50, (T, C)).astype(np.int32)).to(dev)
    expect(torch.equal(k4.segment_sum(val, bad, J).cpu(), k4.segment_sum_plain(val.cpu(), bad.cpu(), J)),
           "K4 out-of-range drop differs")
    expect(torch.equal(k4.segment_sum(ival, bad, J).cpu(), k4.segment_sum_plain(ival.cpu(), bad.cpu(), J)),
           "K4 i32 differs")
    long_v = val[:10_240]
    expect(torch.equal(k4.ordered_sum(long_v).cpu(), k4.segment_sum_plain(
        long_v.cpu(), torch.zeros(10_240, dtype=torch.int32), 1)[0]), "K4 ordered_sum differs")
    # both routes (unordered: one launch; ordered): out= accumulation from
    # a base, i32, every slot dropped, T = 0, and the launches a call
    base = torch.from_numpy((rng.standard_normal((J, C)) * 1e6).astype(np.float32)).to(dev)
    order = k19.segment_order(bad, J)
    dropped = torch.full_like(idx, J)
    none_v, none_i = val[:0], idx[:0]
    for route, call in (
            ("unordered", lambda v, i, out=None: k4.segment_sum(v, i, J, out=out)),
            ("ordered", lambda v, i, out=None: k4.segment_sum(
                v, i, J, out=out, order=order if i is bad else k19.segment_order(i, J)))):
        out = base.clone()
        call(val, bad, out)
        expect(torch.equal(out.cpu(), k4.segment_sum_plain(val.cpu(), bad.cpu(), J, out=base.cpu())),
               f"K4 {route}: out= accumulation differs")
        expect(torch.equal(call(ival, bad).cpu(), k4.segment_sum_plain(ival.cpu(), bad.cpu(), J)),
               f"K4 {route}: i32 differs")
        expect(torch.equal(call(val, dropped).cpu(), torch.zeros((J, C))),
               f"K4 {route}: every slot dropped, not zeros")
        expect(torch.equal(call(none_v, none_i).cpu(), torch.zeros((J, C))), f"K4 {route}: T = 0")
        out = base.clone()
        call(none_v, none_i, out)
        expect(torch.equal(out, base), f"K4 {route}: T = 0 changed out")
        n0 = launch_counts(k4.segment_sum, k19.stable_sort)
        call(val, bad)
        expect(launch_counts(k4.segment_sum, k19.stable_sort) - n0 == 1,
               f"K4 {route}: not one launch a call")

    # ---- the callers' forms, each timed
    counted = (k4.segment_sum, k19.stable_sort)
    forms = []

    def lib_index_add(v, i, S):
        keep = (i >= 0) & (i < S)
        ii = torch.where(keep, i, S).long()
        acc = torch.zeros((S + 1, v.shape[1]), dtype=v.dtype, device=dev)
        return lambda: acc.zero_().index_add_(0, ii, v)

    def in_range(i, S) -> int:
        """M: the slots a sum reads and adds; the rest are dropped."""
        return int(((i >= 0) & (i < S)).sum())

    def ordered(name, v, i, S, note=None):
        # reads the M in-range slots' perm entries and rows, seg_start, writes out
        order = k19.segment_order(i, S)
        n, c = v.shape
        m = in_range(i, S)
        expect(torch.equal(k4.segment_sum(v, i, S, order=order).cpu(),
                           k4.segment_sum_plain(v.cpu(), i.cpu(), S)), f"K4 {name} differs")
        forms.append(sum_form(
            f"ordered {name}", lambda: k4.segment_sum(v, i, S, order=order), lib_index_add(v, i, S),
            m * 4 + m * c * 4 + (S + 1) * 4 + S * c * 4, m * c, counted,
            f"{_dt(v)} [{n},{c}] -> [{S},{c}], {m} in range", note))

    def unordered(name, v, i, S, note=None):
        # reads every idx and the M in-range rows, writes out
        n, c = v.shape
        m = in_range(i, S)
        expect(torch.equal(k4.segment_sum(v, i, S).cpu(), k4.segment_sum_plain(v.cpu(), i.cpu(), S)),
               f"K4 unordered {name} differs")
        forms.append(sum_form(
            f"unordered {name}", lambda: k4.segment_sum(v, i, S), lib_index_add(v, i, S),
            n * 4 + m * c * 4 + S * c * 4, m * c, counted,
            f"{_dt(v)} [{n},{c}] -> [{S},{c}], {m} in range", note))

    # open_session's job sums: 102,400 slots in runs of 100 -> 1,024 jobs
    ordered("open_session", val, idx, J)
    # the evictive world's per-node sums (claim_aggregates, _reclaim_fast's
    # agg): the running tasks' [count | resreq] by node, the rest dropped
    st, state = fx.st, fx.state0
    N, R = st.num_nodes, st.task_resreq.shape[1]
    running = (state.task_status == int(TaskStatus.RUNNING)) & st.task_valid & (state.task_node >= 0)
    vstat = torch.cat([running.float()[:, None],
                       torch.where(running[:, None], st.task_resreq, 0.0)], 1).contiguous()
    node_idx = torch.where(running, state.task_node, N).to(torch.int32)
    ordered("claim_aggregates", vstat, node_idx, N)
    unordered("open_session", val, idx, J)
    unordered("claim_aggregates", vstat, node_idx, N)
    # _reclaim_fast's jstat: a turn's few evictions by job, every other slot dropped
    Jw = st.num_jobs
    ev = torch.zeros(st.num_tasks, dtype=torch.bool, device=dev)
    ev[torch.from_numpy(rng.choice(np.nonzero(running.cpu().numpy())[0], 24, replace=False)).to(dev)] = True
    jidx = torch.where(ev, st.task_job, Jw).to(torch.int32)
    evstat = torch.cat([ev.float()[:, None], torch.where(ev[:, None], st.task_resreq, 0.0)], 1)
    unordered("jstat", evstat.contiguous(), jidx, Jw, note="24 of the slots in range")
    # ordered_sum: one segment of 10,240 rows x R, and of 500 rows
    for rows_n in (10_240, 500):
        v = vstat[:rows_n].contiguous()
        expect(torch.equal(k4.ordered_sum(v).cpu(), k4.segment_sum_plain(
            v.cpu(), torch.zeros(rows_n, dtype=torch.int32), 1)[0]), f"K4 ordered_sum {rows_n} differs")
        forms.append(sum_form(
            f"ordered_sum {rows_n}", lambda v=v: k4.ordered_sum(v), lambda v=v: v.sum(dim=0),
            rows_n * (R + 1) * 4 + (R + 1) * 4, rows_n * (R + 1), counted,
            f"f32 [{rows_n},{R + 1}] -> [{R + 1}]",
            "library: torch.sum(dim=0), another add order"))

    t = kernel_times(lambda: k4.segment_sum(val, idx, J))
    plain_ms = cuda_ms(lambda: k4.segment_sum_plain(val, idx, J), reps=3)
    lib = torch.zeros((J, C), device=dev)
    lib_ms = cuda_ms(lambda: lib.zero_().index_add_(0, idx, val))
    nbytes = T * C * 4 + T * 4 + J * C * 4
    b, by = bound_ms(nbytes, T * C)
    return dict(name="segment_sum", max_abs_err=err, **t, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=lib_ms, variants=forms,
                shape=f"val f32[{T},{C}] -> [{J},{C}] (unordered)")


def k2_world(dev, J: int = 1024, G: int = 1024, Q: int = 8):
    """A pack view and a round's state at the main path's pick shape (J
    jobs, G groups, Q queues; the default tiers' five job keys and two
    group keys).  Queue 3's best job has a NaN share (the index is then
    0, as in the reference), queue 4's jobs have shares at or past BIG
    (3.2e38, inf), queue 5's jobs tie on every key up to the creation
    rank, queue 6's shares are +0.0 and -0.0, queue 7 has no pending
    job, and group priorities tie within a job."""
    rng = np.random.default_rng(2)
    job_queue = (np.arange(J) % Q).astype(np.int32)
    prio = rng.integers(0, 3, J).astype(np.int32)
    share = rng.random(J).astype(np.float32)
    share[rng.random(J) < 0.5] = 0.25
    ready = rng.random(J) < 0.5
    valid, pending = rng.random(J) < 0.97, rng.random(J) < 0.8
    q3 = np.nonzero(job_queue == 3)[0]
    prio[q3], ready[q3] = 2, True
    share[q3[5]], valid[q3[5]], pending[q3[5]] = np.nan, True, True
    q4 = np.nonzero(job_queue == 4)[0]
    prio[q4], ready[q4] = 1, True
    share[q4] = np.where(np.arange(q4.shape[0]) % 2, np.float32(3.2e38), np.inf)
    q5 = np.nonzero(job_queue == 5)[0]
    prio[q5], ready[q5], share[q5] = 1, True, 0.5
    q6 = np.nonzero(job_queue == 6)[0]
    prio[q6], ready[q6] = 0, True
    share[q6] = np.where(np.arange(q6.shape[0]) % 2, np.float32(-0.0), np.float32(0.0))
    pending[job_queue == 7] = False
    group_job = rng.integers(0, J, G).astype(np.int32)
    group_job[:J] = np.arange(J)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    st = types.SimpleNamespace(
        job_queue=t(job_queue), job_valid=t(valid), group_job=t(group_job),
        job_priority=t(prio), job_creation_rank=t(rng.permutation(J).astype(np.int32)),
        group_priority=t(rng.integers(0, 2, G).astype(np.int32)),
        group_uid_rank=t(rng.permutation(G).astype(np.int32)), queue_valid=t(np.ones(Q, bool)))
    state = dict(job_has_pending=t(pending), job_ready=t(ready), job_share=t(share),
                 grp_elig=t(rng.random(G) < 0.9))
    return st, state


def k2_case(dev):
    """K2 through ``TurnPickPlan`` at the main path's shape (K = 5, J =
    1,024, S = 8: an allocate chunk, with the job mask for the budget)
    and in the pop form (reclaim rows: the OverusedFn row filter), each
    equal to the plain version (the selection as the callers built it,
    run on the CPU) with torch.equal: a NaN row (index 0), a row past
    BIG, ties, +-0.0, an empty row and rows the filter drops; one device
    event and no allocation a call."""
    from kube_arbitrator_tpu_torch.ops.kernels import lex_argmin as k2
    from kube_arbitrator_tpu_torch.ops.ordering import (
        DEFAULT_TIERS, job_order_key_spec, job_order_keys,
    )

    st, s = k2_world(dev)
    J, G, Q, R = st.job_queue.shape[0], st.group_job.shape[0], 8, 4
    rng = np.random.default_rng(3)
    deserved = torch.from_numpy(rng.integers(1, 4, (Q, R)).astype(np.float32) * 1000).to(dev)
    queue_alloc = torch.from_numpy(rng.integers(0, 4, (Q, R)).astype(np.float32) * 1000).to(dev)
    queue_alloc[2] = deserved[2] + 20.0  # queue 2 overused: its pop row burns
    q = torch.arange(Q, dtype=torch.int64, device=dev)
    ok = torch.ones(Q, dtype=torch.bool, device=dev)
    ok[1] = False
    q_entry = torch.tensor([3, 0, 2, 1, 1, 1, 1, 1], dtype=torch.int32, device=dev)
    plan = k2.TurnPickPlan(st, DEFAULT_TIERS, deserved)
    cpu_st = types.SimpleNamespace(**{k: v.cpu() for k, v in vars(st).items()})
    cplan = k2.TurnPickPlan(cpu_st, DEFAULT_TIERS, deserved.cpu())
    sel = (q, ok, s["job_has_pending"], s["job_ready"], s["job_share"], s["grp_elig"])
    pop = (q, q_entry, queue_alloc, s["job_has_pending"], s["job_ready"], s["job_share"],
           s["grp_elig"])
    err, checks = 0.0, 0
    for name, got, want in (
            ("select", plan.select(*sel, jmask=True), cplan.select(*to_cpu(sel), jmask=True)),
            ("pop", plan.pop(*pop), cplan.pop(*to_cpu(pop)))):
        for a, w in zip(got, want):
            err = max(err, max_err(a, w))
            expect(torch.equal(a.cpu(), w), f"K2 {name} differs from its plain version")
            checks += 1
    j = plan.select(*sel)[0].cpu()
    expect(int(j[3]) == 0, f"K2: the NaN row picked job {int(j[3])}, not 0")
    expect(int(j[4]) == 0, f"K2: the row past BIG picked job {int(j[4])}, not 0")
    per_call = device_events_per_call(lambda: plan.select(*sel, jmask=True))
    expect(per_call == 1.0, f"K2: {per_call} device events a selection, not 1")
    allocs = allocations_per_call(lambda: plan.select(*sel, jmask=True))
    expect(allocs == 0, f"K2: {allocs} allocations a selection")
    t = kernel_times(lambda: plan.select(*sel, jmask=True))
    pop_t = kernel_times(lambda: plan.pop(*pop))
    # the unstaged route: 20,480 jobs and groups, whose keys do not fit
    # shared memory (each filter stage reads them from global memory)
    wst, ws = k2_world(dev, J=20_480, G=20_480)
    wide = k2.TurnPickPlan(wst, DEFAULT_TIERS, deserved)
    expect(not wide.static.staged, "K2 at J = 20,480 took the staged route")
    wcpu = k2.TurnPickPlan(types.SimpleNamespace(**{k: v.cpu() for k, v in vars(wst).items()}),
                           DEFAULT_TIERS, deserved.cpu())
    wsel = (q, ok, ws["job_has_pending"], ws["job_ready"], ws["job_share"], ws["grp_elig"])
    wpop = (q, q_entry, queue_alloc) + wsel[2:]
    for name, got, want in (
            ("select", wide.select(*wsel, jmask=True), wcpu.select(*to_cpu(wsel), jmask=True)),
            ("pop", wide.pop(*wpop), wcpu.pop(*to_cpu(wpop)))):
        for a, w in zip(got, want):
            err = max(err, max_err(a, w))
            expect(torch.equal(a.cpu(), w), f"K2 unstaged {name} differs from its plain version")
            checks += 1
    wide_t = kernel_times(lambda: wide.select(*wsel, jmask=True))

    def plain():  # the selection as the callers built it: keys, masks, two filters
        jkeys = torch.stack(job_order_keys(DEFAULT_TIERS, st.job_priority, s["job_ready"],
                                           st.job_creation_rank, s["job_share"]))
        return k2.turn_pick_plain(st.job_queue, st.job_valid, st.group_job, jkeys, plan.gkeys, q,
                                  ok, s["job_has_pending"], s["grp_elig"])

    plain_ms = cuda_ms(plain)
    K = len(job_order_key_spec(DEFAULT_TIERS))

    def k2_bound(J, G, pop=False):
        # the job columns (queue, valid, pending, ready, share, three
        # static rows) and group columns (job, elig, two keys) read once,
        # the job mask (select) and the picks written; a compare and a min
        # a key and entry.  The pop form reads each row's queue entry and
        # the queues' allocated and deserved rows instead of the mask.
        nbytes = J * (4 + 1 + 1 + 1 + 4 + 3 * 4) + G * (4 + 1 + 2 * 4) + Q * 2 * 9
        nbytes += Q * (4 + 2 * R * 4) if pop else Q * J
        return bound_ms(nbytes, Q * (K * J + 2 * G) * 2)

    b, by = k2_bound(J, G)
    pb, pby = k2_bound(J, G, pop=True)
    wJ, wG = wst.job_queue.shape[0], wst.group_job.shape[0]
    wb, wby = k2_bound(wJ, wG)
    return dict(name="lex_argmin", max_abs_err=err, **t, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None, events_per_call=per_call, checks=checks,
                variants=[dict(form="pop (reclaim rows)", **pop_t, bound_ms=pb, bound_by=pby),
                          dict(form=f"unstaged, J = G = {wJ:,} (select, job mask)", **wide_t,
                               bound_ms=wb, bound_by=wby)],
                shape=f"TurnPickPlan: K={K} job keys, J={J}, G={G}, S={Q} rows (select, job mask)")


def k3_case(dev):
    """K3's plan as allocate_action binds it (the state's status / node
    written in place, the gate read on the card) at the north star's
    shape, G 1,024, N 10,240, T 102,400: the gate's four settings,
    backfill's missing gn_p, the scalar route (N % 4 != 0) and a small N
    against the plain version gated on the host; then both timed forms,
    both matrices (any_p set) and gn_a alone (any_p clear: the north
    star's allocate action), each one device event and no allocation a
    launch."""
    from kube_arbitrator_tpu_torch.ops.kernels import decode_deferred as k3

    rng = np.random.default_rng(3)
    G, N, per = 1024, 10_240, 100
    T = G * per
    tot_a = rng.integers(0, per + 1, G)
    tot_p = np.minimum(rng.integers(0, 20, G), per - np.minimum(tot_a, per))
    gn = []
    for tot in (tot_a, tot_p):
        c = np.zeros((G, N), np.int32)
        rows = np.repeat(np.arange(G), tot)
        np.add.at(c, (rows, rng.integers(0, N, rows.shape[0])), 1)
        gn.append(torch.from_numpy(c).to(dev))
    tg = (np.arange(T) // per).astype(np.int32)
    tg[rng.random(T) < 0.05] = -1
    args = [
        torch.from_numpy(tg).to(dev),
        torch.from_numpy((np.arange(T) % per).astype(np.int32)).to(dev),
        torch.from_numpy(rng.random(T) < 0.98).to(dev),
        torch.from_numpy(rng.integers(0, 5, G).astype(np.int32)).to(dev),
    ]
    status0 = torch.zeros(T, dtype=torch.int32, device=dev)
    node0 = torch.full((T,), -1, dtype=torch.int32, device=dev)
    flag = {b: torch.tensor(b, device=dev) for b in (False, True)}
    err, checks = 0.0, []

    def held(gn_a, gn_p, any_a, any_p, what):
        nonlocal err
        s, n = status0.clone(), node0.clone()
        n0 = k3.DecodePlan.launches
        plan = k3.DecodePlan(gn_a, gn_p, *args, s, n)
        plan(flag[any_a], flag[any_p])
        expect(k3.DecodePlan.launches == n0 + 1, f"K3 ({what}): not one launch")
        rs, rn = status0.cpu(), node0.cpu()
        if any_a or any_p:
            rs, rn = k3.decode_deferred_plain(
                gn_a.cpu(), gn_p.cpu() if any_p and gn_p is not None else None,
                *[a.cpu() for a in args], rs, rn)
        err = max(err, max_err(s, rs), max_err(n, rn))
        expect(torch.equal(s.cpu(), rs) and torch.equal(n.cpu(), rn),
               f"K3 differs from its plain version ({what})")
        checks.append(dict(form=what, allocated=int((rs == k3.ALLOCATED).sum()),
                           pipelined=int((rs == k3.PIPELINED).sum())))
        return plan, checks[-1]["allocated"] + checks[-1]["pipelined"]

    for any_a in (True, False):
        for any_p in (True, False):
            held(gn[0], gn[1], any_a, any_p, f"any_a {any_a}, any_p {any_p}")
    held(gn[0], None, True, True, "backfill: no gn_p, any_p set")
    held(gn[0][:, :N - 3].contiguous(), gn[1][:, :N - 3].contiguous(), True, True,
         "scalar route, N = 10,237")
    held(gn[0][:, :20].contiguous(), gn[1][:, :20].contiguous(), True, True, "N = 20 < CHUNK")
    expect(checks[0]["pipelined"] > 0 and checks[1]["allocated"] > 0, f"K3: no placements {checks}")
    both, hits_both = held(gn[0], gn[1], True, True, "timed: both matrices")
    alone, hits_alone = held(gn[0], gn[1], True, False, "timed: gn_a alone")
    forms = []
    for what, plan, any_p, mats, hits in (("both matrices", both, True, 2, hits_both),
                                          ("gn_a alone (any_p clear)", alone, False, 1, hits_alone)):
        fn = lambda plan=plan, any_p=any_p: plan(flag[True], flag[any_p])  # noqa: E731
        t = kernel_times(fn)
        events = device_events_per_call(fn)
        allocs = allocations_per_call(fn)
        expect(events == 1.0, f"K3 ({what}): {events} device events a launch, not 1")
        expect(allocs == 0, f"K3 ({what}): {allocs} allocations a launch")
        # the count matrices read once; each task's group, rank and valid
        # flag read once and each row's entry count; status and node
        # written for the tasks that land (the rest keep theirs, unread)
        b, by = bound_ms(mats * G * N * 4 + T * (4 + 4 + 1) + G * 4 + hits * 8, mats * G * N)
        forms.append(dict(form=what, **t, bound_ms=b, bound_by=by, events_per_call=events,
                          allocations_per_call=allocs))
    plain_ms = cuda_ms(lambda: k3.decode_deferred_plain(gn[0], gn[1], *args, status0, node0),
                       reps=5)
    main_form = forms[0]
    return dict(name="decode_deferred", max_abs_err=err,
                **{k: main_form[k] for k in ("ms", "device_us", "kernels_per_call", "device_by",
                                             "host_us", "bound_ms", "bound_by")},
                plain_ms=plain_ms, library_ms=None, events_per_call=main_form["events_per_call"],
                checks=checks, variants=forms[1:],
                shape=f"DecodePlan: gn i32[{G},{N}] x2, tasks [{T}], both matrices (any_p set)")


def k1_inputs(dev, seed: int, N: int = 10_240):
    rng = np.random.default_rng(seed)
    R, W, G, K, S = 4, 2, 1024, 3, 8
    idle = rng.uniform(0, 8000, (N, R)).astype(np.float32)
    rel = rng.uniform(0, 4000, (N, R)).astype(np.float32)
    rel[rng.random(N) < 0.1, 0] = 20_000.5                 # the releasing fallback's room
    ports = np.zeros((N, W), np.int32)
    ports[rng.random(N) < 0.1, 0] = 1 << 3
    st = types.SimpleNamespace(
        num_nodes=N,
        group_klass=torch.from_numpy(rng.integers(0, K, G).astype(np.int32)).to(dev),
        class_fit=torch.from_numpy(rng.random((K, 4)) < 0.7).to(dev),
        node_klass=torch.from_numpy(rng.integers(0, 4, N).astype(np.int32)).to(dev),
        node_valid=torch.from_numpy(rng.random(N) < 0.98).to(dev),
        node_unsched=torch.from_numpy(rng.random(N) < 0.02).to(dev),
        node_max_tasks=torch.full((N,), 24, dtype=torch.int32, device=dev),
    )
    g_sel = rng.choice(G, S, replace=False).astype(np.int32)
    req = (rng.uniform(100, 3000, (S, R)) * (rng.random((S, R)) < 0.8)).astype(np.float32)
    req[3] = [9000.25, 10.5, 0.0, 0.0]                   # fits no idle, fits releasing
    budget = rng.integers(0, 600, S).astype(np.int32)
    budget[3], budget[6] = 50, 0
    sports = np.zeros((S, W), np.int32)
    sports[5, 0] = 1 << 3
    state = dict(
        node_idle=torch.from_numpy(idle).to(dev),
        node_releasing=torch.from_numpy(rel).to(dev),
        node_ports=torch.from_numpy(ports).to(dev),
        node_num_tasks=torch.from_numpy(rng.integers(0, 20, N).astype(np.int32)).to(dev),
        gn_a=torch.zeros((G, N), dtype=torch.int32, device=dev),
        gn_p=torch.zeros((G, N), dtype=torch.int32, device=dev),
    )
    slots = dict(
        n_slots=torch.tensor([7], dtype=torch.int32, device=dev),
        g_sel=torch.from_numpy(g_sel).to(dev),
        req_s=torch.from_numpy(req).to(dev),
        budget_s=torch.from_numpy(budget).to(dev),
        ports_s=torch.from_numpy(sports).to(dev),
        has_ports_s=torch.from_numpy((sports != 0).any(1)).to(dev),
    )
    # a pruned panel: each class's feasible nodes, stably compacted to
    # N // 4 slots with padding N past the count
    feas = (st.class_fit[:, st.node_klass.long()] & st.node_valid & ~st.node_unsched).cpu().numpy()
    NC = N // 4
    panel = np.full((K, NC), N, np.int32)
    for k in range(K):
        nodes = np.nonzero(feas[k])[0][: NC - 37]
        panel[k, : len(nodes)] = nodes
    return st, state, slots, torch.from_numpy(panel).to(dev)


K1_CHECKS = (
    # (name, flags, pruned panel, node count, forced (CTAs, threads) or None)
    ("allocate, full width", dict(best_effort=False, preds_on=True), False, 10_240, None),
    ("allocate, full width, one CTA", dict(best_effort=False, preds_on=True), False, 10_240,
     (1, 1024)),
    ("allocate, full width, cluster of 2", dict(best_effort=False, preds_on=True), False, 10_240,
     (2, 512)),
    ("allocate, full width, N = 10,003", dict(best_effort=False, preds_on=True), False, 10_003,
     None),
    ("allocate, full width, N = 10,003, cluster of 8", dict(best_effort=False, preds_on=True),
     False, 10_003, (8, 128)),
    ("allocate, pruned panel", dict(best_effort=False, preds_on=True), True, 10_240, None),
    ("allocate, pruned panel, cluster of 4", dict(best_effort=False, preds_on=True), True, 10_240,
     (4, 256)),
    ("allocate, pruned panel, N = 10,003", dict(best_effort=False, preds_on=True), True, 10_003,
     (1, 96)),
    ("allocate, predicates off", dict(best_effort=False, preds_on=False), False, 10_240, None),
    ("backfill, full width", dict(best_effort=True, preds_on=True), False, 10_240, None),
    ("backfill, pruned panel, cluster of 3", dict(best_effort=True, preds_on=True), True, 10_240,
     (3, 1024)),
)


def k1_case(dev):
    """K1 against its plain version on seeded inputs, bit for bit, in
    every variant: full width and the pruned panel, one CTA and clusters
    of 2-8, N a multiple of the tile and not, predicates off, the
    backfill pass; the slots include a releasing fallback in a middle
    slot (slot 3), host ports (slot 5), budget 0 (slot 6), and slots
    that land on the same nodes.  Timed through an AdmitPlan built once."""
    from kube_arbitrator_tpu_torch.ops.kernels import admit_chunk as k1

    names = ("n_slots", "g_sel", "req_s", "budget_s", "ports_s", "has_ports_s")
    err, fallback_seen, shared_seen, timing = 0.0, False, False, None
    for name, flags, use_panel, N, launch in K1_CHECKS:
        st, state, slots, panel = k1_inputs(dev, 11, N)
        pan = panel if use_panel else None
        s = {k: v.clone() for k, v in state.items()}
        c = {k: v.cpu() for k, v in state.items()}
        if flags["best_effort"]:
            s["gn_p"] = c["gn_p"] = None
        cst = types.SimpleNamespace(**{k: to_cpu(v) for k, v in vars(st).items()})
        fields = ("node_idle", "node_releasing", "node_ports", "node_num_tasks", "gn_a", "gn_p")
        pk, uk = k1.admit_chunk(st, *(s[f] for f in fields), *(slots[k] for k in names), pan,
                                4096, flags["best_effort"], flags["preds_on"], launch=launch)
        pp, up = k1.admit_chunk_plain(cst, *(c[f] for f in fields),
                                      *(slots[k].cpu() for k in names),
                                      None if pan is None else pan.cpu(), 4096,
                                      flags["best_effort"], flags["preds_on"])
        for key in s:
            if s[key] is not None:
                err = max(err, max_err(s[key], c[key]))
                expect(torch.equal(s[key].cpu(), c[key]), f"K1 {name}: {key} differs from the plain version")
        expect(torch.equal(pk.cpu(), pp) and torch.equal(uk.cpu(), up), f"K1 {name}: placed/use_rel differ")
        expect(int(pk.sum()) > 0, f"K1 {name}: placed nothing")
        fallback_seen |= bool(uk[3]) and not bool(uk[:3].any())
        shared_seen |= bool(((s["gn_a"] > 0).sum(0) > 1).any())
        if timing is None:
            timing = (st, state, slots, pk.clone(), uk.clone())
    expect(fallback_seen, "K1 inputs never took the releasing fallback in a middle slot")
    expect(shared_seen, "K1 inputs never placed two slots on one node")
    st, state, slots, pk, uk = timing
    work = {k: v.clone() for k, v in state.items()}

    def setup():
        for k, v in state.items():
            work[k].copy_(v)

    plan = k1.AdmitPlan(st, work["node_idle"], work["node_releasing"], work["node_ports"],
                        work["node_num_tasks"], work["gn_a"], work["gn_p"], None, 4096, False,
                        True, slots["g_sel"].shape[0])
    rows = [slots[k] for k in names]
    t = kernel_times(lambda: plan(*rows), setup=setup)
    plain_ms = cuda_ms(lambda: k1.admit_chunk_plain(
        st, work["node_idle"], work["node_releasing"], work["node_ports"], work["node_num_tasks"],
        work["gn_a"], work["gn_p"], *rows, None, 4096, False, True), reps=5, setup=setup)
    N, R = state["node_idle"].shape
    W = state["node_ports"].shape[1]
    # node state read once (idle, ports, counts, limits, class/valid
    # flags; releasing only when a slot fell back), placed cells written
    placed = int(pk.sum())
    nbytes = N * (4 * R + 4 * W + 4 + 4 + 4 + 2) + (N * 4 * R if bool(uk.any()) else 0) \
        + placed * (4 * R + 4 + 4 * W + 4)
    ns = int(slots["n_slots"][0])
    b, by = bound_ms(nbytes, ns * N * (3 * R + 10))
    return dict(name="admit_chunk", max_abs_err=err, **t, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=None, checks=len(K1_CHECKS),
                shape=f"N={N}, R={R}, W={W}, {ns} slots ({plan.variant}, launch "
                      f"{k1.launch_shape(N)})")


def k1_path_case(dev):
    """K1 at the main path's own shapes: the allocate world (100k x 10k,
    seed 42) decided once on the card with the first launch of each
    (pass, width) recorded: the allocate pass at the width that
    allocate_action picks (the pruned panel, or the full node axis when
    the largest class overflows N // 4), and the backfill pass.  Each
    recorded launch is replayed from its recorded node state: equal to
    the plain version in every launch shape, and timed through an
    AdmitPlan built once (as allocate_action builds it) in the default
    launch shape, one CTA and clusters of 2, 4 and 8.  Where the
    recorded width is the full axis, the same slots are also timed on
    panels of N // 8 and N // 4 columns (the first nodes each class may
    use), one CTA against clusters."""
    from kube_arbitrator_tpu_torch.cli import decide_world
    from kube_arbitrator_tpu_torch.ops import allocate
    from kube_arbitrator_tpu_torch.ops.kernels import admit_chunk as k1

    rec = {}
    plan_cls = allocate.AdmitPlan

    class Recording(plan_cls):
        def __call__(self, n_slots, *slot_rows):
            width = self.st.num_nodes if self.panel is None else self.panel.shape[1]
            key = ("backfill" if self.best_effort else "allocate", width)
            if key not in rec:
                rec[key] = (self.st, [None if x is None else x.clone() for x in self.state],
                            n_slots, [x.clone() for x in slot_rows], self.panel, self.s_max,
                            self.best_effort, self.preds_on)
            return super().__call__(n_slots, *slot_rows)

    allocate.AdmitPlan = Recording
    try:
        decide_world(device=dev, seed=42, **FULL)
    finally:
        allocate.AdmitPlan = plan_cls
    out = []
    for (pass_, width), (st, state, ns, slot_rows, panel, s_max, be, preds) in sorted(rec.items()):
        work = [None if x is None else x.clone() for x in state]

        def setup():
            for w, x in zip(work, state):
                if x is not None:
                    w.copy_(x)

        n_t = torch.tensor([ns], dtype=torch.int32, device=dev)
        setup()
        want = [x.clone() for x in k1.admit_chunk_plain(st, *work, n_t, *slot_rows, panel,
                                                        s_max, be, preds)]
        want_state = [None if w is None else w.clone() for w in work]
        N = st.num_nodes
        panels = [(panel, width)]
        if panel is None and not be:
            fit = st.class_fit[:, st.node_klass.long()] & st.node_valid & ~st.node_unsched
            for nc in (N // 8, N // 4):
                p = torch.full((fit.shape[0], nc), N, dtype=torch.int32, device=dev)
                for k in range(fit.shape[0]):
                    nodes = torch.nonzero(fit[k]).reshape(-1)[:nc].to(torch.int32)
                    p[k, :nodes.numel()] = nodes
                panels.append((p, nc))
        R, W = state[0].shape[1], state[2].shape[1]
        classes = len(set(st.group_klass[slot_rows[0][:ns].long()].tolist()))
        for pan, w_ in panels:
            bound = None
            for shape in (None, (1, 1024), (2, 1024), (4, 1024), (8, 1024), (8, 640)):
                plan = k1.AdmitPlan(st, *work, pan, s_max, be, preds, slot_rows[0].shape[0],
                                    launch=shape)
                setup()
                got = [x.clone() for x in plan(ns, *slot_rows)]
                if pan is panel:
                    expect(all(torch.equal(a, b) for a, b in zip(got, want)),
                           f"K1 main path {pass_} {w_} {shape}: placed / use_rel differ")
                    for a, b in zip(work, want_state):
                        expect(a is None or torch.equal(a, b),
                               f"K1 main path {pass_} {w_} {shape}: node state differs")
                if bound is None:
                    # as k1_case's bound over the launch's width: the node
                    # state read once (releasing when a slot fell back),
                    # the used classes' panel rows read, placed cells written
                    placed, fell_back = int(got[0].sum()), bool(got[1].any())
                    nbytes = (w_ * (4 * R + 4 * W + 14) + (w_ * 4 * R if fell_back else 0)
                              + placed * (4 * R + 8 + 4 * W)
                              + (classes * w_ * 4 if pan is not None else 0))
                    bound = bound_ms(nbytes, ns * w_ * (3 * R + 10))[0]
                t = kernel_times(lambda: plan(ns, *slot_rows), setup=setup)
                row = dict(case=f"{pass_} pass, {ns} slots, width {w_}, {plan.variant} "
                                f"{shape or k1.launch_shape(w_)}"
                                f"{' (default)' if shape is None else ''}",
                           recorded=pan is panel, bound_ms=bound, **t)
                if shape is None and pan is panel:
                    row["plain_ms"] = cuda_ms(lambda: k1.admit_chunk_plain(
                        st, *work, n_t, *slot_rows, panel, s_max, be, preds), reps=5, setup=setup)
                out.append(row)
                print(f"kernel admit_chunk main path: {json.dumps(row)}", flush=True)
            if be:
                break
    expect(any(r["case"].startswith("allocate") for r in out), "K1 main path: no allocate launch")
    return out


# ---- K5-K8: the evictive path's own inputs in the 50k x 5k world


def evict_fixture(dev):
    """The 50k x 5k seed-42 world on the card and on the CPU: the reclaim
    entry state (after open_session) and the preempt entry state (after
    reclaim, allocate and backfill), with preempt's victim panel."""
    from kube_arbitrator_tpu_torch.api.types import TaskStatus
    from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
    from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
    from kube_arbitrator_tpu_torch.ops import allocate, cycle, preempt
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS as tiers

    w = EVICT_FULL
    arrays, _ = build_synthetic_arrays(w["tasks"], w["nodes"], w["queues"], w["tasks_per_job"], 42,
                                       running_fraction=w["running_fraction"],
                                       fit_fraction=w["fit_fraction"])
    st = from_numpy(arrays, dev)
    sess, state0 = cycle.open_session(st, tiers)
    state = preempt.reclaim_action(st, sess, state0, tiers)
    state = allocate.allocate_action(st, sess, state, tiers)
    state = allocate.backfill_action(st, sess, state, tiers)
    T = st.num_tasks
    running0 = (state.task_status == int(TaskStatus.RUNNING)) & st.task_valid & (state.task_node >= 0)
    qualify = preempt._entry_qualify(st, sess, state, running0)
    count = int(qualify.sum())
    P = T // 8 if count <= T // 8 else (T // 4 if count <= T // 4 else T)
    view = preempt._build_view(st, state, qualify if P < T else running0, P)
    return types.SimpleNamespace(st=st, st_cpu=from_numpy(arrays, "cpu"), sess=sess, tiers=tiers,
                                 state0=state0, state=state, view=view)


def k5_layout_stats(lay, mask, valid) -> dict:
    """What bounds a K5 launch on one layout: P, the segments, the
    longest segment, the padding tail (the invalid slots, which sort
    last) and the most masked rows in one segment (its add chain)."""
    start = lay.seg_start.cpu().numpy().copy()
    P = start.shape[0]
    start[0] = True
    firsts = np.nonzero(start)[0]
    lens = np.diff(np.append(firsts, P))
    m_s = mask.cpu().numpy()[lay.order.cpu().numpy()]
    masked = np.add.reduceat(m_s.astype(np.int64), firsts) if P else np.zeros(0, np.int64)
    pad = ~valid.cpu().numpy()[lay.order.cpu().numpy()]
    tail = int(P - (np.nonzero(~pad)[0][-1] + 1)) if (~pad).any() else P
    return dict(P=P, segments=int(firsts.shape[0]), longest_segment=int(lens.max(initial=0)),
                padding_tail=tail, longest_masked_run=int(masked.max(initial=0)),
                masked=int(m_s.sum()))


def k5_case(dev, fx):
    """K5 through each layout's ``SegScanPlan`` at the evictive world's
    victim panel (each layout timed, with its segments, longest segment,
    padding tail and longest masked run), the functional ``seg_cumsum``
    form (no order, every row masked), and synthetic layouts: one segment
    of all P, a mask with no row, every row masked; each held with
    torch.equal against the plain version; one device event and no
    allocation a scan."""
    from kube_arbitrator_tpu_torch.ops import common
    from kube_arbitrator_tpu_torch.ops.kernels import seg_scan as k5

    view = fx.view
    P, R = view.resreq.shape
    rng = np.random.default_rng(5)
    mask = view.running(fx.state.task_status) & torch.from_numpy(rng.random(P) < 0.7).to(dev)
    m = int(mask.sum())
    err = 0.0

    def held(what, got, order, seg_start, vals, msk):
        nonlocal err
        want = k5.seg_scan_plain(msk.cpu(), None if order is None else order.cpu(),
                                 seg_start.cpu(), vals.cpu())
        for a, w in zip(got, want):
            err = max(err, max_err(a, w))
            expect(torch.equal(a.cpu(), w), f"K5 {what} differs from its plain version")

    # mask, order, seg_start, the masked rows' values read once; rank and
    # cum written once; one add a masked row and column
    b, by = bound_ms(P * (1 + 4 + 1) + m * 4 * R + P * (4 + 4 * R), m * (R + 1))
    layouts = {}
    for name in ("by_job", "by_queue", "by_node_queue"):
        lay = getattr(view.layouts, name)
        plan = lay.plan
        held(name, lay.rank_and_cum(mask), lay.order, lay.seg_start, lay.res_sorted, mask)
        per_call = device_events_per_call(lambda: plan(mask))
        expect(per_call == 1.0, f"K5 {name}: {per_call} device events a scan, not 1")
        allocs = allocations_per_call(lambda: plan(mask))
        expect(allocs == 0, f"K5 {name}: {allocs} allocations a scan")
        layouts[name] = dict(layout=name, **k5_layout_stats(lay, mask, view.valid),
                             **kernel_times(lambda plan=plan: plan(mask)),
                             events_per_call=per_call, bound_ms=b, bound_by=by)
        print(f"kernel seg_scan layout {json.dumps(layouts[name])}", flush=True)
    lay = view.layouts.by_node_queue
    t0 = time.perf_counter()
    bind = k5.SegScanPlan(lay.order, lay.seg_start, lay.res_sorted)
    torch.cuda.synchronize()
    bind_ms = (time.perf_counter() - t0) * 1e3
    expect(torch.equal(bind.base_pos.cpu(), k5.segment_table_plain(lay.seg_start.cpu())[1]),
           "K5's bound segment bases differ from the plain table")
    # the functional seg_cumsum form (the canon seed's): no order, every row
    # masked, a plan of its own (a bind and a scan)
    x = view.resreq
    got = common.seg_cumsum(x, lay.seg_start)
    want = k5.seg_scan_plain(torch.ones(P, dtype=torch.bool), None, lay.seg_start.cpu(), x.cpu())[1]
    err = max(err, max_err(got, want))
    expect(torch.equal(got.cpu(), want), "K5 seg_cumsum differs from its plain version")
    forms = [dict(form="seg_cumsum (bind + scan)",
                  **kernel_times(lambda: common.seg_cumsum(x, lay.seg_start)))]
    # synthetic layouts: one segment of all P, no masked row, every row
    # masked, fractional values whose serial and tree sums differ
    frac = torch.from_numpy((rng.standard_normal((P, R)) * 1e3).astype(np.float32)).to(dev)
    one_seg = torch.zeros(P, dtype=torch.bool, device=dev)
    order = lay.order
    for what, seg, msk in (("one segment", one_seg, mask),
                           ("no masked row", lay.seg_start, torch.zeros_like(mask)),
                           ("every row masked", lay.seg_start, torch.ones_like(mask))):
        plan = k5.SegScanPlan(order, seg, frac)
        got = plan(msk)
        held(what, got, order, seg, frac, msk)
        if what == "one segment":
            forms.append(dict(form=f"one segment of {P}, {m} masked", **kernel_times(lambda: plan(msk))))
    t = kernel_times(lambda: lay.plan(mask))
    plain_ms = cuda_ms(lambda: k5.seg_scan_plain(mask, lay.order, lay.seg_start, lay.res_sorted), reps=3)
    return dict(name="seg_scan", max_abs_err=err, **t, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None, bind_ms=bind_ms,
                variants=list(layouts.values()) + forms,
                shape=f"panel P={P}, R={R}, {m} masked (by_node_queue; by_job and by_queue "
                      f"timed too)")


# a K6 turn's tensors, in the order of claim_nodes_plain's arguments
K6_TURN = ("victims", "node_rank", "node_cum", "node_ports", "node_num_tasks", "g", "req",
           "budget", "has_grp", "was_ready", "need")


def k6_turn(st, sess, state, view, tiers, qi: int = 0):
    """A preempt turn of ``state``: queue ``qi`` in the round's order (the
    first by default), its claimant and its verdict, as ``_apply_claim``
    receives them (g i64, as the batched round passes it)."""
    from kube_arbitrator_tpu_torch.ops import allocate, preempt

    q_active = preempt._round_gate(st, sess, state, "preempt", view)
    _, perm = preempt._queue_perm(st, sess, state, tiers, q_active)
    q = perm[qi:qi + 1]
    shared = allocate._selection_shared(st, sess, state, tiers, None)
    j, g, has_grp, req, budget = allocate.select_turns(st, sess, state, tiers, 4096, "preempt",
                                                       shared, q, st.queue_valid[q] & q_active[q])
    was_ready = shared[3][j]
    need = (sess.min_avail[j] - state.job_ready_cnt[j]).clamp(min=0)
    budget = preempt._phase_budget("preempt", budget, was_ready, need, has_grp, shared[0][g], 4096)
    P = view.idx.shape[0]
    scope = view.running(state.task_status) & (view.job != j) & (view.queue == q)
    victims = preempt._victim_verdict(st, state, sess, tiers, scope, j.expand(P),
                                      req.expand(P, req.shape[1]), view) & has_grp
    node_rank, node_cum = (x.clone() for x in view.layouts.by_node_queue.rank_and_cum(victims))
    return dict(victims=victims, node_rank=node_rank, node_cum=node_cum,
                node_ports=state.node_ports, node_num_tasks=state.node_num_tasks,
                g=g.to(torch.int64), req=req[0].contiguous(), budget=budget, has_grp=has_grp,
                was_ready=was_ready, need=need)


def k6_bound(st, turn) -> tuple:
    """(bound ms, by): the bytes that one turn's function needs, each read
    once (the node arrays: valid, unschedulable, class, max and current
    task counts, ports; the panel's victim flags; each victim's node,
    resreq, rank and cumulative) and its outputs written once (p, cum,
    placed, evict, freed); its operations (the per-node capacity and the
    victims' sums and rule, ~12 R a node and 4 R a victim).  The panel's
    slot order and the node segments' starts are not counted: a victim's
    node gives its segment, and within a node the view's order is
    ascending slot order."""
    N, (Pn, R) = st.num_nodes, turn["node_cum"].shape
    return bound_ms(*k6_work(st, turn))


def k6_work(st, turn) -> tuple:
    """(bytes, operations) of k6_bound."""
    N, (Pn, R) = st.num_nodes, turn["node_cum"].shape
    W = turn["node_ports"].shape[1]
    V = int(turn["victims"].sum())
    nbytes = N * (1 + 1 + 4 + 4 + 4 + 4 * W) + Pn + V * (4 + 4 * R + 4 + 4 * R) \
        + N * (4 + 4 + 4 * R) + 8 + Pn
    return nbytes, N * 12 * R + V * 4 * R


def k6_case(dev, fx):
    """K6 through ``ClaimNodesPlan`` in every form, each launch equal to
    the plain version on the CPU (p, cum, placed, evict, freed): the
    evictive world's first preempt turn (i64 g, timed; i32 g), the
    statement gate off (preempt_intra), a turn with no victim, the gate
    dropping the claim (keep false), and, in the pod-affinity world, the
    two launches around K12 with K11's fit; the folded aggregates against
    ``claim_aggregates`` (K4's slot-order sums, the scatter max / min) on
    the card; one device event (three with pod affinity: K6, K12, K6) and
    no allocation a call."""
    from kube_arbitrator_tpu_torch.ops import preempt
    from kube_arbitrator_tpu_torch.ops.kernels import claim_nodes as k6
    from kube_arbitrator_tpu_torch.ops.kernels import pa_shape as k12

    st, view, tiers = fx.st, fx.view, fx.tiers
    turn = k6_turn(st, fx.sess, fx.state, view, tiers)
    view_cpu = to_cpu(view)
    cases, err = [], 0.0

    def check(what, plan, turn_, mode):
        nonlocal err
        want = k6.claim_nodes_plain(fx.st_cpu, view_cpu.node, view_cpu.node_order,
                                    view_cpu.resreq, *(to_cpu(turn_[k]) for k in K6_TURN), 4096,
                                    mode == "preempt", True)
        n0 = k6.ClaimNodesPlan.launches
        got = plan(**turn_)
        expect(k6.ClaimNodesPlan.launches == n0 + 1, f"K6 {what}: one launch a call")
        expect(got[0] is plan.p and got[3] is plan.evict, f"K6 {what}: the plan's own outputs")
        for name, a, b in zip(("p", "cum", "placed", "evict", "freed"), got, want):
            err = max(err, max_err(a, b))
            expect(torch.equal(a.cpu(), b), f"K6 {what}: {name} differs from its plain version")
        cases.append(dict(case=what, placed=got[2].tolist(), evicts=int(got[3].sum()),
                          victims=int(turn_["victims"].sum())))
        return got

    plan = preempt._claim_plan(st, tiers, view, 4096, "preempt")
    got = check("preempt, the evictive world's first turn, i64 g", plan, turn, "preempt")
    expect(int(got[3].sum()) > 0 and int(got[2][0]) > 0, "K6 inputs evicted or placed nothing")
    check("preempt, i32 g", plan, dict(turn, g=turn["g"].to(torch.int32)), "preempt")
    intra = preempt._claim_plan(st, tiers, view, 4096, "preempt_intra")
    check("preempt_intra (no statement gate), the same victims", intra, turn, "preempt_intra")
    none = dict(turn, victims=torch.zeros_like(turn["victims"]))
    got = check("a turn with no victim", plan, none, "preempt")
    expect(int(got[2][1]) == 0 and int(got[3].sum()) == 0, "K6: a turn with no victim claimed")
    drop = dict(turn, was_ready=torch.zeros_like(turn["was_ready"]),
                budget=torch.full_like(turn["budget"], 4096), need=torch.full_like(turn["need"], 4096))
    got = check("keep false (a gang short of its need)", plan, drop, "preempt")
    expect(int(got[2][0]) == 0 and int(got[2][1]) > 0 and int(got[3].sum()) == 0,
           f"K6: the statement gate kept {got[2].tolist()}")
    # the folded aggregates against the reference expression on the card
    agg = k6.ClaimNodesPlan(st, view, 4096, True, True, aggregates=True)
    agg(**turn)
    want = k6.claim_aggregates(view.node, view.node_order, view.resreq, turn["victims"],
                               st.num_nodes)
    for name, a, b in zip(("node_victims", "totfree", "vmax", "vmin"), agg.aggs, want):
        err = max(err, max_err(a, b))
        expect(torch.equal(a, b), f"K6: the folded {name} differs from claim_aggregates on the card")
    cases.append(dict(case="folded aggregates == claim_aggregates (K4 slot order, scatter max / "
                           "min) on the card", nodes_with_victims=int((want[0] > 0).sum())))
    t = kernel_times(lambda: plan(**turn))
    per_call = device_events_per_call(lambda: plan(**turn))
    expect(per_call == 1.0, f"K6's plan made {per_call} device events a launch, not 1")
    allocs = allocations_per_call(lambda: plan(**turn))
    expect(allocs == 0, f"K6's plan allocates {allocs} times a launch")
    plain_ms = cuda_ms(lambda: k6.claim_nodes_plain(
        st, view.node, view.node_order, view.resreq, *(turn[k] for k in K6_TURN), 4096, True,
        True), reps=5)
    b, by = k6_bound(st, turn)
    N, R = st.num_nodes, view.resreq.shape[1]
    P = view.idx.shape[0]
    V = int(turn["victims"].sum())
    return dict(name="claim_nodes", max_abs_err=err, **t, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None, events_per_call=per_call, variants=cases,
                shape=f"N={N}, R={R}, panel P={P}, {V} victims (ClaimNodesPlan, the evictive "
                      f"world's first preempt turn); library: none")


def k6_pa_forms(dev, pfx) -> list:
    """K6 with pod affinity through ``ClaimNodesPlan``: the pod-affinity
    world's preempt turns in the round's order (its running tasks'
    panel) up to the first that places, K11 launched first as
    ``_apply_claim`` does, then the plan's two launches around K12's
    shaping, each equal to the plain version (K11's fit and K12 on the
    CPU); three device events (K6, K12, K6) and no allocation a call,
    timed on the placing turn."""
    from kube_arbitrator_tpu_torch.api.types import TaskStatus
    from kube_arbitrator_tpu_torch.ops import preempt
    from kube_arbitrator_tpu_torch.ops.kernels import claim_nodes as k6
    from kube_arbitrator_tpu_torch.ops.kernels import pa_shape as k12

    pst, psess, pstate, tiers = pfx.st, pfx.sess, pfx.state, pfx.tiers
    running0 = (pstate.task_status == int(TaskStatus.RUNNING)) & pst.task_valid \
        & (pstate.task_node >= 0)
    pview = preempt._build_view(pst, pstate, running0, pst.num_tasks)
    pplan = preempt._claim_plan(pst, tiers, pview, 4096, "preempt")
    expect(pplan.pa is not None, "K6: the pod-affinity world bound no K11 / K12 plans")
    fit_plan, _ = pplan.pa
    forms, placing = [], None
    for qi in range(pst.num_queues):  # the round's turns until one places
        turn = k6_turn(pst, psess, pstate, pview, tiers, qi)
        fit_plan(turn["g"], pstate.task_status, pstate.task_node)  # K11, as _apply_claim does
        fit_cpu = to_cpu(fit_plan.fit)
        want = k6.claim_nodes_plain(
            pfx.st_cpu, *(to_cpu(x) for x in (pview.node, pview.node_order, pview.resreq)),
            *(to_cpu(turn[k]) for k in K6_TURN), 4096, True, True,
            (fit_cpu.ok, k12.PaShapePlan(pfx.st_cpu, fit_cpu)))
        n0 = k6.ClaimNodesPlan.launches
        got = pplan(**turn)
        expect(k6.ClaimNodesPlan.launches == n0 + 2, "K6 with pod affinity: two launches a call")
        err = 0.0
        for name, a, b in zip(("p", "cum", "placed", "evict", "freed"), got, want):
            err = max(err, max_err(a, b))
            expect(torch.equal(a.cpu(), b), f"K6 with pod affinity, turn {qi}: {name} differs "
                   f"from its plain version")
        forms.append(dict(case=f"pod affinity: phase 1, K12, phase 2 (the pa world's turn {qi})",
                          max_abs_err=err, placed=got[2].tolist(), evicts=int(got[3].sum()),
                          victims=int(turn["victims"].sum())))
        if int(got[2][1]) > 0:
            placing = turn
            break
    expect(placing is not None, "K6 with pod affinity: no turn of the round placed")
    pturn = placing
    # three launches a call (K6, K12, K6) on the host's records, and no
    # device event beyond them (the profile may lose one record of a run)
    per_call = device_events_per_call(lambda: pplan(**pturn), launches=3)
    host = launch_records_per_call(lambda: pplan(**pturn))
    expect(host == 3.0 and 3.0 - 1 / 20 <= per_call <= 3.0,
           f"K6 with pod affinity: {host} launches and {per_call} device events a call, not 3 "
           f"(K6, K12, K6)")
    allocs = allocations_per_call(lambda: pplan(**pturn))
    expect(allocs == 0, f"K6's plan with pod affinity allocates {allocs} times a call")
    # the bound: K6's function on the turn (k6_work) and K12's shaping of
    # the claim row between its two launches (the row read and written
    # once, the node order and, per active seed / cap fold, the key's
    # node domains read once; three operations a node and fold)
    fit = fit_plan.fit
    N = pst.num_nodes
    folds = int(fit.seed_flags.sum()) + int(fit.cap_flags.sum())
    nbytes, nops = k6_work(pst, pturn)
    b, by = bound_ms(nbytes + N * 8 + N * 4 + folds * N * 4, nops + folds * N * 3)
    forms[-1].update(events_per_call=per_call, launch_records_per_call=host,
                     **kernel_times(lambda: pplan(**pturn)), bound_ms=b, bound_by=by, folds=folds)
    return forms


def canon_inputs(fx):
    """The reclaim entry state and the first turn that claims."""
    from kube_arbitrator_tpu_torch.ops import allocate, preempt
    from kube_arbitrator_tpu_torch.ops.kernels.canon_pick import canon_pick

    st, sess, tiers = fx.st, fx.sess, fx.tiers
    state = allocate._copy(fx.state0)
    state.progress = torch.zeros((), dtype=torch.bool, device=st.device)
    state.rounds = 0
    ctx = preempt._canon_ctx(st, sess)
    carry = preempt._canon_seed(st, state, ctx)
    nq, perm = preempt._canon_round_order(st, sess, tiers, state, carry)
    for qi in range(int(nq)):
        q = perm[qi:qi + 1]
        shared = preempt._reclaim_shared(st, sess, state, tiers, carry.job_consumed)
        j, g, has_grp, req, pop, burn = preempt._reclaim_pop(st, sess, state, tiers, shared, q,
                                                             carry.q_entries[q])
        i32 = torch.int32
        pick_args = (ctx, carry.cand, carry.rank_nj, carry.cum_nq, state.job_ready_cnt,
                     sess.min_avail, state.queue_alloc, state.node_ports, state.node_num_tasks,
                     q.to(i32), g.to(i32), has_grp, pop, req, True, False, True)
        commit_turn = (q.to(i32), j.to(i32), g.to(i32), has_grp, pop, burn, req, True, False)
        if int(canon_pick(st, *pick_args)) < st.num_nodes:
            return ctx, state, carry, pick_args, commit_turn
    raise SmokeFailure("no reclaim turn of the first round claims")


def canon_turn(st, sess, tiers, state, carry, q):
    """Queue ``q``'s reclaim pop on the current state: (j, g, has_grp,
    req, pop, burn_now)."""
    from kube_arbitrator_tpu_torch.ops import preempt

    shared = preempt._reclaim_shared(st, sess, state, tiers, carry.job_consumed)
    return preempt._reclaim_pop(st, sess, state, tiers, shared, q, carry.q_entries[q])


def k7_case(dev, fx):
    """K7 through ``CanonPickPlan`` (the canon walk's form): the evictive
    world's first claiming reclaim turn (timed; the plain version on the
    CPU), the first round's turns back to back through one plan with K8
    committing between them, a turn where no node is feasible, the node
    screens off (predicates off), a pack whose node blocks pass 32 slots;
    each pick equal to ``canon_pick_plain``'s; one device event and no
    allocation a launch; the library call re-taken in the same call."""
    from kube_arbitrator_tpu_torch.ops import allocate, preempt
    from kube_arbitrator_tpu_torch.ops.kernels import canon_pick as k7
    from kube_arbitrator_tpu_torch.ops.kernels.canon_commit import CanonCommitPlan

    st, sess, tiers = fx.st, fx.sess, fx.tiers
    N = st.num_nodes
    cases = []

    def launch(plan, *turn):
        n0 = k7.canon_pick.launches
        pick = plan(*turn)
        expect(k7.canon_pick.launches == n0 + 1, "K7: one launch a call")
        return pick

    def plain(st_, ctx, carry, state, sess_, flags, *turn):
        return k7.canon_pick_plain(st_, ctx, carry.cand, carry.rank_nj, carry.cum_nq,
                                   state.job_ready_cnt, sess_.min_avail, state.queue_alloc,
                                   state.node_ports, state.node_num_tasks, *turn, *flags)

    # the first claiming turn, against the plain version on the CPU
    ctx, state, carry, pick_args, _ = canon_inputs(fx)
    q, g, has_grp, pop, req = (pick_args[9].long(), pick_args[10].long(), *pick_args[11:14])
    flags = pick_args[14:]
    plan = k7.CanonPickPlan(st, ctx, carry.cand, carry.rank_nj, carry.cum_nq,
                            state.job_ready_cnt, sess.min_avail, state.queue_alloc,
                            state.node_ports, state.node_num_tasks, *flags)
    got = launch(plan, q, g, has_grp, pop, req)
    expect(got is plan.pick, "K7: the plan's own pick")
    want = plain(fx.st_cpu, to_cpu(ctx), to_cpu(carry), to_cpu(state), to_cpu(sess), flags,
                 *to_cpu((q, g, has_grp, pop, req)))
    expect(torch.equal(got.cpu(), want) and int(want) < N, f"K7 differs: {int(got)} vs {int(want)}")
    err = float(abs(int(got) - int(want)))
    turn = (q, g, has_grp, pop, req)
    # no feasible node: a request above every node's victims, and a turn that does not pop
    for what, t in (("no node feasible", (q, g, has_grp, pop, torch.full_like(req, 3.0e38))),
                    ("no pop", (q, g, has_grp, torch.zeros_like(pop), req))):
        p_ = launch(plan, *t)
        expect(int(p_) == N and int(plain(st, ctx, carry, state, sess, flags, *t)) == N,
               f"K7 {what}: pick {int(p_)}, want {N}")
        cases.append(dict(case=what, pick=int(p_)))
    expect(torch.equal(launch(plan, *turn).cpu(), want), "K7: the scratch was not re-armed")
    # predicates off: the node screens reduce to node validity
    off = (flags[0], flags[1], False)
    poff = k7.CanonPickPlan(st, ctx, carry.cand, carry.rank_nj, carry.cum_nq,
                            state.job_ready_cnt, sess.min_avail, state.queue_alloc,
                            state.node_ports, state.node_num_tasks, *off)
    expect(torch.equal(launch(poff, *turn), plain(st, ctx, carry, state, sess, off, *turn)),
           "K7 predicates off differs from the plain version")
    cases.append(dict(case="predicates off", pick=int(poff.pick)))
    # the canon walk's first round: one plan, K8 committing between launches
    use_gang, use_prop, preds_on = preempt._reclaim_flags(tiers)
    ws = allocate._copy(fx.state0)
    ws.progress = torch.zeros((), dtype=torch.bool, device=dev)
    ws.rounds = 0
    wctx = preempt._canon_ctx(st, sess)
    wc = preempt._canon_seed(st, ws, wctx)
    wplan = preempt._pick_plan(st, sess, ws, wctx, wc, use_gang, use_prop, preds_on)
    wcommit = CanonCommitPlan(st, wctx, ws, wc, use_gang, use_prop)
    nq, perm = preempt._canon_round_order(st, sess, tiers, ws, wc)
    turns = claims = 0
    for qi in range(min(int(nq), 48)):
        qq = perm[qi:qi + 1]
        j, gg, hg, req_, pop_, burn = canon_turn(st, sess, tiers, ws, wc, qq)
        pk = launch(wplan, qq, gg, hg, pop_, req_)
        wp = plain(st, wctx, wc, ws, sess, (use_gang, use_prop, preds_on), qq, gg, hg, pop_, req_)
        expect(torch.equal(pk, wp), f"K7 turn {qi} of the walk differs from the plain version")
        claims += int(pk) < N
        wcommit(pk, qq, j, gg, hg, pop_, burn, req_)
        turns += 1
    expect(claims > 1, f"K7's walk claimed {claims} times in {turns} turns")
    cases.append(dict(case="first round of the canon walk, K8 between launches", turns=turns,
                      claims=claims))
    # node blocks past 32 slots
    wf = canon_world(dev, K13_LONG_BLOCKS_WORLD, 8)
    bl = int((wf.st.rv_block_start[1:] - wf.st.rv_block_start[:-1]).max())
    expect(bl > 32, f"K7 long blocks: longest block {bl}")
    lplan = preempt._pick_plan(wf.st, wf.sess, wf.state, wf.ctx, wf.carry, *wf.flags)
    lnq, lperm = preempt._canon_round_order(wf.st, wf.sess, tiers, wf.state, wf.carry)
    lclaims = 0
    for qi in range(max(int(lnq), 1)):
        qq = lperm[qi:qi + 1]
        _, gg, hg, req_, pop_, _ = canon_turn(wf.st, wf.sess, tiers, wf.state, wf.carry, qq)
        pk = launch(lplan, qq, gg, hg, pop_, req_)
        lw = plain(wf.st_cpu, to_cpu(wf.ctx), to_cpu(wf.carry), to_cpu(wf.state),
                   to_cpu(wf.sess), wf.flags, *to_cpu((qq, gg, hg, pop_, req_)))
        expect(torch.equal(pk.cpu(), lw), f"K7 long blocks, queue {qi}: {int(pk)} vs {int(lw)}")
        lclaims += int(pk) < wf.st.num_nodes
    cases.append(dict(case="node blocks past 32 slots", longest_block=bl,
                      N=wf.st.num_nodes, feasible_turns=lclaims, **kernel_times(lambda: lplan(
                          qq, gg, hg, pop_, req_))))
    del wf, lplan
    t = kernel_times(lambda: plan(*turn))
    per_call = device_events_per_call(lambda: plan(*turn))
    expect(per_call == 1.0, f"K7's plan made {per_call} device events a launch, not 1")
    allocs = allocations_per_call(lambda: plan(*turn))
    expect(allocs == 0, f"K7's plan allocates {allocs} times a launch")
    functional = kernel_times(lambda: k7.canon_pick(st, *pick_args))
    cases.insert(0, dict(case="functional canon_pick (a throwaway plan a call)",
                         ms=functional["ms"], host_us=functional["host_us"]))
    plain_ms = cuda_ms(lambda: plain(st, ctx, carry, state, sess, flags, *turn), reps=5)
    Vp, R = ctx.cres.shape
    F = carry.cum_nq.shape[1]
    mask_v = carry.cand
    stat = torch.cat([mask_v.float()[:, None], torch.where(mask_v[:, None], ctx.cres, 0.0)], 1)
    idx = ctx.cnode.clamp(max=N - 1).long()
    acc = torch.zeros((N, R + 1), device=dev)
    lib_ms = cuda_ms(lambda: acc.zero_().index_add_(0, idx, stat))
    W = st.node_ports.shape[1]
    nbytes = Vp * (1 + 4 + 4 * F + 4 + 4 + 4 * F + 4 * R) + N * (4 + 4 * W + 4 + 4 + 4 + 3) + 4
    b, by = bound_ms(nbytes, Vp * (2 * F + R + 3) + N * (R + 4))
    return dict(name="canon_pick", max_abs_err=err, **t, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=lib_ms, events_per_call=per_call, variants=cases,
                shape=f"Vp={Vp}, N={N}, R={R} (the evictive world's first claiming reclaim "
                      f"turn, CanonPickPlan)")


def clone_carry(carry):
    return dataclasses.replace(carry, **{f.name: getattr(carry, f.name).clone()
                                         for f in dataclasses.fields(carry)})


def k8_case(dev, fx):
    """K8 through ``CanonCommitPlan`` in every canon engine's form: the
    evictive world's first claiming reclaim turn (the canon walk's i64
    queue and i32 ordinals; timed), the same turn with i64 ordinals and
    with ``claimed_out`` (the batched engine's), a turn whose covering
    prefix evicts several slots over >= 2 jobs and >= 2 queues, a failing
    turn (no node: the claim log's row J), a launch with ``active`` clear
    (nothing changes), a window longer than its node's block (blen < W);
    each launch on copies of the entry state against the plain version
    on CPU copies, every state and carry field and progress equal; one
    launch, one device event and no allocation a call."""
    from kube_arbitrator_tpu_torch.ops import allocate
    from kube_arbitrator_tpu_torch.ops.kernels import canon_commit as k8
    from kube_arbitrator_tpu_torch.ops.kernels.canon_pick import canon_elig, canon_pick

    st, sess = fx.st, fx.sess
    ctx, state, carry, pick_args, turn = canon_inputs(fx)
    pick = canon_pick(st, *pick_args).clone()
    q32, j, g, has_grp, pop, burn, req, use_gang, use_prop = turn
    q = q32.long()
    flags = (use_gang, use_prop)
    N, W, J = st.num_nodes, st.rv_window, st.num_jobs
    R, F = ctx.cres.shape[1], carry.cum_nq.shape[1]
    bstart = st.rv_block_start.cpu()
    cases = []
    err = [0.0]

    def held(what, targs, active=None, claimed_out=None):
        """One plan launch on card copies of the entry state against the
        plain version on CPU copies; -> (card state, card carry)."""
        s_gpu, c_gpu = allocate._copy(state), clone_carry(carry)
        s_cpu, c_cpu = to_cpu(s_gpu), to_cpu(c_gpu)
        plan = k8.CanonCommitPlan(st, ctx, s_gpu, c_gpu, *flags)
        n0 = k8.canon_commit.launches
        plan(*targs, active=active, claimed_out=claimed_out)
        expect(k8.canon_commit.launches == n0 + 1, f"K8 {what}: one launch a call")
        co_cpu = None if claimed_out is None else torch.zeros(1, dtype=torch.bool)
        k8.canon_commit_plain(fx.st_cpu, to_cpu(ctx), s_cpu, c_cpu, *to_cpu(tuple(targs)), *flags,
                              to_cpu(active), co_cpu)
        for obj_g, obj_c in ((s_gpu, s_cpu), (c_gpu, c_cpu)):
            for f in dataclasses.fields(obj_c):
                a, b = getattr(obj_g, f.name), getattr(obj_c, f.name)
                if isinstance(b, torch.Tensor):
                    err[0] = max(err[0], max_err(a, b))
                    expect(torch.equal(a.cpu().reshape(b.shape), b),
                           f"K8 {what}: {f.name} differs from its plain version")
        if claimed_out is not None:
            expect(torch.equal(claimed_out.cpu(), co_cpu), f"K8 {what}: claimed_out differs")
        return s_gpu, c_gpu

    def evicted(c_gpu, n):
        ev = c_gpu.evicted_c.cpu()
        b0 = int(bstart[n])
        return dict(evicted=int(ev.sum()), jobs=len(set(ctx.cj.cpu()[ev].tolist())),
                    queues=len(set(ctx.cq.cpu()[ev].tolist())),
                    blen=int(bstart[n + 1]) - b0, window=W, first_slot=b0)

    n_first = int(pick)
    base = (pick, q, j, g, has_grp, pop, burn, req)
    _, c1 = held("first claiming turn", base)
    first = evicted(c1, n_first)
    expect(first["evicted"] > 0, "K8 inputs evicted nothing")
    cases.append(dict(case="first claiming turn (canon walk: q i64, j / g i32)", q=int(q),
                      j=int(j), g=int(g), node=n_first, **first))
    held("i64 ordinals", (pick, q, j.long(), g.long(), has_grp, pop, burn, req))
    cases.append(dict(case="i64 q / j / g"))
    flag = torch.zeros(1, dtype=torch.bool, device=dev)
    held("claimed_out", base, claimed_out=flag)
    expect(bool(flag), "K8 claimed_out: the claiming turn's bit is clear")
    cases.append(dict(case="claimed_out (the batched engine's form)", claimed=bool(flag)))
    # active clear: nothing moves (the plain version returns at once too)
    s_off, c_off = held("active clear", base, active=torch.zeros(1, dtype=torch.bool, device=dev))
    expect(int(c_off.evicted_c.sum()) == 0 and int(c_off.n_claims) == 0,
           "K8 active clear: the launch changed the carry")
    cases.append(dict(case="active clear"))
    # a failing turn: no node, so the pop burns its entry and the log's row J takes the writes
    s_f, c_f = held("failing turn", (torch.full_like(pick, N), q, j, g, has_grp, pop, burn, req))
    expect(int(c_f.n_claims) == 0 and int(c_f.log_g[J]) == int(g), "K8 failing turn: log row J")
    cases.append(dict(case="failing turn (no node)", q_entries=int(c_f.q_entries[q])))
    # a covering prefix over >= 2 jobs and >= 2 queues: the first node whose
    # window holds victims of two jobs and two queues, one of the two with
    # two victims (a group the sums add up), a request above them all
    ctx_c = to_cpu(ctx)
    elig = canon_elig(ctx_c, carry.cand.cpu(), carry.rank_nj.cpu(), carry.cum_nq.cpu(),
                      state.job_ready_cnt.cpu(), sess.min_avail.cpu(), state.queue_alloc.cpu(),
                      *flags) & (ctx_c.cq != int(q))
    wide = None
    for n in range(N):
        b0, b1 = int(bstart[n]), int(bstart[n + 1])
        m = elig[b0:b1]
        nj, nq = len(set(ctx_c.cj[b0:b1][m].tolist())), len(set(ctx_c.cq[b0:b1][m].tolist()))
        if int(m.sum()) >= 3 and nj >= 2 and nq >= 2 and int(m.sum()) > min(nj, nq):
            wide = (n, ctx_c.cres[b0:b1][m].sum(dim=0))
            break
    expect(wide is not None, "K8: no node holds victims of two jobs and two queues")
    n_w, tot = wide
    big = (tot + 100.0).to(dev)
    _, c_w = held("several jobs and queues",
                  (torch.full_like(pick, n_w), q, j, g, has_grp, pop, burn, big))
    several = evicted(c_w, n_w)
    expect(several["evicted"] >= 3 and several["jobs"] >= 2 and several["queues"] >= 2
           and several["evicted"] > min(several["jobs"], several["queues"]),
           f"K8 several jobs and queues: {several}")
    cases.append(dict(case="covering prefix over several jobs and queues", **several))
    expect(min(first["blen"], several["blen"]) < W, "K8: no window longer than its block")
    cases.append(dict(case="blen < W", blen=first["blen"], window=W))

    # timed: the first claiming turn through one plan, the entry state restored
    work_s, work_c = allocate._copy(state), clone_carry(carry)
    plan = k8.CanonCommitPlan(st, ctx, work_s, work_c, *flags)

    def setup():
        for obj, src in ((work_s, state), (work_c, carry)):
            for f in dataclasses.fields(src):
                v = getattr(src, f.name)
                if isinstance(v, torch.Tensor):
                    getattr(obj, f.name).copy_(v)

    t = kernel_times(lambda: plan(*base), setup=setup)
    setup()
    per_call = device_events_per_call(lambda: plan(*base))
    expect(per_call == 1.0, f"K8's plan made {per_call} device events a launch, not 1")
    allocs = allocations_per_call(lambda: plan(*base))
    expect(allocs == 0, f"K8's plan allocates {allocs} times a launch")
    functional = kernel_times(lambda: k8.canon_commit(st, ctx, work_s, work_c, *base, *flags),
                              setup=setup)
    # the launch floor: the same launch with active clear returns at once
    off = torch.zeros(1, dtype=torch.bool, device=dev)
    floor = kernel_times(lambda: plan(*base, active=off))
    cases.append(dict(case="active clear (the launch floor)", ms=floor["ms"],
                      device_us=floor["device_us"], host_us=floor["host_us"]))
    cases.insert(0, dict(case="functional canon_commit (a throwaway plan a call)",
                         ms=functional["ms"], host_us=functional["host_us"]))
    plain_ms = cuda_ms(lambda: k8.canon_commit_plain(st, ctx, work_s, work_c, *base, *flags),
                       reps=5, setup=setup)
    # the bound at the timed case: the window's canon slots read once
    # (job, queue, task, cand, segment flags, rank, F-wide cumulative and
    # deserved, R-wide resreq), the rows the mask reads (its jobs' ready
    # counts and floors, its queues' allocations), the scans written back,
    # the evicted slots' flags and audit fields, the evicted jobs' and
    # queues' rows and the claimant's job / queue / node rows read and
    # written, the ports and the scalars
    b0 = first["first_slot"]
    win_j = len(set(ctx.cj.cpu()[b0:b0 + W].tolist()))
    win_q = len(set(ctx.cq.cpu()[b0:b0 + W].tolist()))
    PW = state.node_ports.shape[1]
    n_ev = first["evicted"]
    nbytes = (W * (4 + 4 + 4 + 1 + 1 + 1 + 4 + 8 * F + 4 * R) + win_j * 8 + win_q * 4 * R
              + W * 4 * (1 + F) + n_ev * 14 + (first["jobs"] + first["queues"]) * (8 * R + 8)
              + 3 * 8 * R + 12 * PW + 64)
    b, by = bound_ms(nbytes, W * (2 * R + 2 * F + 4) + n_ev * 3 * R)
    return dict(name="canon_commit", max_abs_err=err[0], **t, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None, events_per_call=per_call, variants=cases,
                shape=f"window W={W}, R={R}, {n_ev} evicted over {first['jobs']} jobs "
                      f"(CanonCommitPlan, the first claiming reclaim turn)")


# ---- K9-K12: the immediate path's own inputs (binpack 100k x 10k, the
# pod-affinity evictive world 50k x 5k)


def first_turn(st, sess, tiers, state):
    """The group, request and budget of the next round's first queue turn,
    selected as ops/allocate._process_queue selects them."""
    from kube_arbitrator_tpu_torch.ops import allocate
    from kube_arbitrator_tpu_torch.ops.fairness import overused

    over = overused(state.queue_alloc, sess.deserved)
    grp_live = allocate.group_live_mask(st, sess, state.group_placed, state.group_unfit, False)
    q_active = st.queue_valid & allocate.queue_has_live_job(st, grp_live) & ~over
    _, perm = allocate.queue_perm(tiers, q_active, state.queue_alloc, sess.deserved,
                                  st.queue_uid_rank)
    q = perm[:1]
    shared = allocate._selection_shared(st, sess, state, tiers, False)
    _, g, _, req, budget = allocate.select_turns(st, sess, state, tiers, 4096, "allocate", shared,
                                                 q, st.queue_valid[q] & ~over[q])
    return g, req[0].contiguous(), budget


def turn_fixture(dev):
    """The binpack world at full width, seed 42: its entry state (every
    node idle: the binpack keys tie at -0.0) and the state after two
    allocate rounds; and the same for the binpack world at WIDE_BINPACK
    (N = 20,480, past the one-CTA sort)."""
    from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
    from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
    from kube_arbitrator_tpu_torch.ops import allocate, cycle
    from kube_arbitrator_tpu_torch.ops.ordering import with_node_order

    def world(w):
        arrays, _ = build_synthetic_arrays(w["tasks"], w["nodes"], w["queues"],
                                           w["tasks_per_job"], 42)
        st = from_numpy(arrays, dev)
        tiers = with_node_order("binpack")
        sess, state0 = cycle.open_session(st, tiers)
        mid = allocate.allocate_action(st, sess, state0, tiers, max_rounds=2)
        return types.SimpleNamespace(st=st, st_cpu=from_numpy(arrays, "cpu"), sess=sess,
                                     tiers=tiers, state0=state0, mid=mid)

    fx = world(FULL)
    fx.wide = world(WIDE_BINPACK)
    return fx


def turn_caps_args(fx, state, policy):
    g, req, _ = first_turn(fx.st, fx.sess, fx.tiers, state)
    return (state.node_idle, state.node_releasing, state.node_ports, state.node_num_tasks, g, req,
            None, 4096, False, True, policy)


def node_slice(st, state, n):
    """(a pack view, node arrays) cut to the first ``n`` nodes: K9 at an
    N that is no multiple of a tile or a warp."""
    view = types.SimpleNamespace(
        node_alloc=st.node_alloc[:n].contiguous(), class_fit=st.class_fit,
        node_klass=st.node_klass[:n].contiguous(), node_valid=st.node_valid[:n].contiguous(),
        node_unsched=st.node_unsched[:n].contiguous(),
        node_max_tasks=st.node_max_tasks[:n].contiguous(), group_klass=st.group_klass,
        group_ports=st.group_ports)
    nodes = tuple(getattr(state, f)[:n].contiguous()
                  for f in ("node_idle", "node_releasing", "node_ports", "node_num_tasks"))
    return view, nodes


def k9_bound(state, order: bool) -> tuple:
    """K9's bound at ``state``'s node count: idle, releasing (and, for
    the packing key, allocatable), ports, counts, limits, class and flags
    read once; two capacity rows (and the order) written."""
    N, R = state.node_idle.shape
    W = state.node_ports.shape[1]
    nbytes = N * ((3 if order else 2) * 4 * R + 4 * W + 4 + 4 + 4 + 2) + N * 4 * (3 if order else 2)
    return bound_ms(nbytes, N * ((6 if order else 4) * R + (14 if order else 10)))


def k9_case(dev, fx):
    """K9 through its plans, every variant against turn_caps_plain bit for
    bit: the all-idle entry (binpack keys all -0.0), the state after two
    rounds under binpack and spread (one CTA and tiles), first fit, best
    effort, three groups back to back through one plan, N = 10,003, and
    N = 20,480 under binpack and spread (the tiled route).  Times each
    variant; the row is the main path's (one CTA at N = 10,240)."""
    from kube_arbitrator_tpu_torch.ops.kernels import turn_caps as k9

    err = 0.0

    def check(st, st_cpu, nodes, g, req, policy, variant, best_effort=False, what=""):
        nonlocal err
        plan = k9.TurnCapsPlan(st, *nodes, 4096, best_effort, True, policy, variant)
        expect(plan.variant == (variant or k9.turn_caps_variant(policy, nodes[0].shape[0])),
               f"K9 {what}: variant {plan.variant}")
        n0, v0 = k9.turn_caps.launches, k9.turn_caps.variants[plan.variant]
        k, nperm = plan(g, req, None)
        expect(k9.turn_caps.launches == n0 + plan.per_call
               and k9.turn_caps.variants[plan.variant] == v0 + 1, f"K9 {what}: launch count")
        kp, pp = k9.turn_caps_plain(st_cpu, *to_cpu(nodes), g.cpu(), req.cpu(), None, 4096,
                                    best_effort, True, policy)
        err = max(err, max_err(k, kp))
        expect(torch.equal(k.cpu(), kp), f"K9 {what} {plan.variant}: capacities differ from plain")
        if policy == "first_fit":
            expect(nperm is None and pp is None, f"K9 {what}: first fit gave an order")
        else:
            err = max(err, max_err(nperm, pp))
            expect(torch.equal(nperm.cpu(), pp), f"K9 {what} {plan.variant}: order differs from plain")
        expect(int(kp[0].sum()) > 0 or best_effort, f"K9 {what}: no capacity")
        return plan, k

    def nodes_of(state):
        return (state.node_idle, state.node_releasing, state.node_ports, state.node_num_tasks)

    cases = [(fx, fx.state0, "binpack", "entry"), (fx, fx.mid, "binpack", "2 rounds"),
             (fx, fx.mid, "spread", "2 rounds")]
    for w, state, policy, what in cases:
        g, req, _ = first_turn(w.st, w.sess, w.tiers, state)
        for variant in ("one_cta", "tiles"):
            check(w.st, w.st_cpu, nodes_of(state), g, req, policy, variant, what=f"{policy} {what}")
    g, req, _ = first_turn(fx.st, fx.sess, fx.tiers, fx.mid)
    check(fx.st, fx.st_cpu, nodes_of(fx.mid), g, req, "first_fit", None, what="first fit")
    check(fx.st, fx.st_cpu, nodes_of(fx.mid), g, req, "binpack", None, best_effort=True,
          what="best effort")
    # three groups back to back through one plan (its outputs reused)
    plan = k9.TurnCapsPlan(fx.st, *nodes_of(fx.mid), 4096, False, True, "binpack")
    for gg in (int(g), 3, fx.st.num_groups // 4):
        gt = torch.tensor([gg], dtype=torch.int32 if gg % 2 else torch.int64, device=dev)
        rq = fx.st.group_resreq[gg].contiguous()
        k, nperm = plan(gt, rq, None)
        kp, pp = k9.turn_caps_plain(fx.st_cpu, *to_cpu(nodes_of(fx.mid)), gt.cpu(), rq.cpu(),
                                    None, 4096, False, True, "binpack")
        expect(torch.equal(k.cpu(), kp) and torch.equal(nperm.cpu(), pp),
               f"K9 group {gg} through a reused plan differs from plain")
    view, nodes = node_slice(fx.st, fx.mid, 10_003)
    view_cpu = types.SimpleNamespace(**{k: v.cpu() for k, v in vars(view).items()})
    for policy in ("binpack", "spread"):
        for variant in ("one_cta", "tiles"):
            check(view, view_cpu, nodes, g, req, policy, variant, what=f"{policy} N=10,003")
    w = fx.wide
    for state, what in ((w.state0, "entry"), (w.mid, "2 rounds")):
        gw, reqw, _ = first_turn(w.st, w.sess, w.tiers, state)
        for policy in ("binpack", "spread"):
            check(w.st, w.st_cpu, nodes_of(state), gw, reqw, policy, None,
                  what=f"{policy} N={w.st.num_nodes} {what}")

    # times: each variant at the main path's N, and the tiled route at N = 20,480
    timed = {}
    for label, w, policy, variant in (("first_fit", fx, "first_fit", None),
                                      ("one_cta", fx, "binpack", "one_cta"),
                                      ("tiles", fx, "binpack", "tiles"),
                                      ("tiles_wide", w, "binpack", None)):
        gw, reqw, _ = first_turn(w.st, w.sess, w.tiers, w.mid)
        plan = k9.TurnCapsPlan(w.st, *nodes_of(w.mid), 4096, False, True, policy, variant)
        t = kernel_times(lambda: plan(gw, reqw, None))
        keyf = k9.packing_key_f32(w.st, w.mid.node_idle, "binpack")
        lib = cuda_ms(lambda: torch.sort(keyf, stable=True)) if policy != "first_fit" else None
        timed[label] = dict(variant=plan.variant, n=w.st.num_nodes, policy=policy,
                            launches_per_call=plan.per_call, library_ms=lib,
                            bound_ms=k9_bound(w.mid, policy != "first_fit")[0], **t)
    g, req, _ = first_turn(fx.st, fx.sess, fx.tiers, fx.mid)
    args = turn_caps_args(fx, fx.mid, "binpack")
    plain_ms = cuda_ms(lambda: k9.turn_caps_plain(fx.st, *args), reps=5)
    main = timed["one_cta"]
    N, R = fx.mid.node_idle.shape
    b, by = k9_bound(fx.mid, True)
    return dict(name="turn_caps", max_abs_err=err, ms=main["ms"], device_us=main["device_us"],
                kernels_per_call=main["kernels_per_call"], device_by=main["device_by"],
                host_us=main["host_us"], plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=main["library_ms"], variants=list(timed.values()),
                shape=f"N={N}, R={R}, binpack order, one CTA")


NODE_TASK_FIELDS = ("node_idle", "node_releasing", "node_ports", "node_num_tasks",
                    "task_status", "task_node")


def k10_check(st, st_cpu, k, nperm, g, req, budget, group_placed, state, s_max, best_effort,
              variant, what):
    """K10 through a fresh ``TurnFillPlan`` of route ``variant`` (None: the
    plan's own choice) on copies of ``state``'s node and task tensors,
    against the plain version on the CPU: every tensor it writes equal.
    Returns (plan, copies, placed, the largest difference of any tensor
    it writes)."""
    from kube_arbitrator_tpu_torch.ops.kernels import turn_fill as k10

    work = {n: getattr(state, n).clone() for n in NODE_TASK_FIELDS}
    cpu = {n: getattr(state, n).cpu() for n in NODE_TASK_FIELDS}
    plan = k10.TurnFillPlan(st, k, nperm, group_placed, *work.values(), s_max, best_effort,
                            True, variant)
    n0 = k10.turn_fill.launches
    placed, use_rel = plan(g, req, budget)
    expect(k10.turn_fill.launches == n0 + 1, f"K10 {what}: one launch a call")
    expect(placed is plan.placed and use_rel is plan.use_rel, f"K10 {what}: the plan's own outputs")
    pp, up = k10.turn_fill_plain(st_cpu, k.cpu(), None if nperm is None else nperm.cpu(), g.cpu(),
                                 req.cpu(), budget.cpu(), group_placed.cpu(), *cpu.values(), s_max,
                                 best_effort, True)
    expect(torch.equal(placed.cpu(), pp) and torch.equal(use_rel.cpu(), up),
           f"K10 {what} ({plan.variant}): placed / use_rel differ from the plain version")
    err = max(max_err(placed, pp), max_err(use_rel, up))
    for n in NODE_TASK_FIELDS:
        expect(torch.equal(work[n].cpu(), cpu[n]),
               f"K10 {what} ({plan.variant}): {n} differs from its plain version")
        err = max(err, max_err(work[n], cpu[n]))
    return plan, work, int(pp), err


def k10_case(dev, fx):
    """K10 through ``TurnFillPlan`` in both routes on the binpack world
    (entry state and after two rounds; N = 10,240 and 20,480), plus first
    fit (no order), best effort, the releasing fallback, placed_total past
    s_max, a group with tasks already placed and a pack whose ranks fail
    the index check (it takes ``walk``): every tensor equal to the plain
    version's; one device event and no allocation a launch."""
    from kube_arbitrator_tpu_torch.ops.kernels import turn_caps as k9
    from kube_arbitrator_tpu_torch.ops.kernels import turn_fill as k10

    cases, errs = [], []

    def caps(w, state, policy, best_effort=False):
        g, req, budget = first_turn(w.st, w.sess, w.tiers, state)
        plan = k9.TurnCapsPlan(w.st, state.node_idle, state.node_releasing, state.node_ports,
                               state.node_num_tasks, 4096, best_effort, True, policy)
        plan(g, req, None)
        return g, req, budget, plan.k, plan.nperm

    def both(w, state, k, nperm, g, req, budget, what, gp=None, s_max=4096, best_effort=False,
             st=None, st_cpu=None):
        placed = []
        for variant in k10.VARIANTS:
            plan, _, pl, err = k10_check(st or w.st, st_cpu or w.st_cpu, k, nperm, g, req,
                                         budget, state.group_placed if gp is None else gp, state,
                                         s_max, best_effort, variant, what)
            placed.append(pl)
            errs.append(err)
        cases.append(dict(case=what, placed=placed[0]))
        return placed[0]

    w = fx
    for state, what in ((w.state0, "binpack entry"), (w.mid, "binpack, 2 rounds")):
        g, req, budget, k, nperm = caps(w, state, "binpack")
        expect(both(w, state, k, nperm, g, req, budget, what) > 0, f"K10 {what}: placed nothing")
    state = w.mid
    g, req, budget, k, nperm = caps(w, state, "first_fit")
    both(w, state, k, None, g, req, budget, "first fit, no order")
    g, req, budget, kb, nb = caps(w, state, "binpack", best_effort=True)
    both(w, state, kb, nb, g, req, budget, "best effort", best_effort=True)
    g, req, budget, k, nperm = caps(w, state, "binpack")
    # the releasing fallback: no idle capacity anywhere, a positive budget
    k_rel = torch.stack([torch.zeros_like(k[0]), k[0]]).contiguous()
    both(w, state, k_rel, nperm, g, req, budget, "releasing fallback")
    # placed_total past s_max: the slots past s_max take slot s_max - 1's node
    big = torch.full_like(budget, 40)
    expect(both(w, state, k, nperm, g, req, big, "placed past s_max = 16", s_max=16) > 16,
           "K10: placed_total did not pass s_max")
    # a group whose first tasks are placed already
    gp = state.group_placed.clone()
    gp[g.long()] += 3
    both(w, state, k, nperm, g, req, budget, "3 of the group's tasks placed before", gp=gp)
    # N = 20,480
    for st_w, what in ((w.wide.state0, "N = 20,480 entry"), (w.wide.mid, "N = 20,480, 2 rounds")):
        gw, reqw, bw, kw, pw = caps(w.wide, st_w, "binpack")
        both(w.wide, st_w, kw, pw, gw, reqw, bw, what)
    # a pack whose group ranks fail the index check: one rank duplicated
    rank = w.st.task_group_rank.clone()
    members = torch.nonzero((w.st.task_group == g.to(torch.int32)) & w.st.task_valid).reshape(-1)
    rank[members[1]] = rank[members[0]]
    dup = dataclasses.replace(w.st, task_group_rank=rank)
    dup_cpu = dataclasses.replace(w.st_cpu, task_group_rank=rank.cpu())
    plan, _, _, err = k10_check(dup, dup_cpu, k, nperm, g, req, budget, state.group_placed, state,
                                4096, False, None, "duplicated rank")
    errs.append(err)
    expect(plan.variant == "walk", f"K10: a duplicated rank took route {plan.variant}")
    cases.append(dict(case="duplicated rank: the index check fails, route walk"))
    try:
        k10.TurnFillPlan(dup, k, nperm, state.group_placed,
                         *[getattr(state, n).clone() for n in NODE_TASK_FIELDS], 4096, False, True,
                         "by_group")
        expect(False, "K10: by_group accepted a pack that fails the index check")
    except ValueError:
        pass

    # times: the main path's turn (binpack after two rounds) in each route
    base = {n: getattr(state, n).clone() for n in NODE_TASK_FIELDS}
    work = {n: v.clone() for n, v in base.items()}

    def setup():
        for n, v in base.items():
            work[n].copy_(v)

    timed = {}
    for variant in k10.VARIANTS:
        plan = k10.TurnFillPlan(w.st, k, nperm, state.group_placed, *work.values(), 4096, False,
                                True, variant)
        timed[variant] = dict(plan=plan, **kernel_times(lambda: plan(g, req, budget), setup=setup))
        timed[variant]["events_per_call"] = device_events_per_call(lambda: plan(g, req, budget))
        setup()
        timed[variant]["allocations_per_call"] = allocations_per_call(lambda: plan(g, req, budget))
        setup()
        expect(timed[variant]["events_per_call"] == 1.0,
               f"K10 {variant}: {timed[variant]['events_per_call']} device events a launch")
        expect(timed[variant]["allocations_per_call"] == 0, f"K10 {variant}: allocates a launch")
    torch.cuda.synchronize()
    t_bind = time.perf_counter()
    for _ in range(5):
        k10.TurnFillPlan(w.st, k, nperm, state.group_placed, *work.values(), 4096, False, True)
    bind_ms = (time.perf_counter() - t_bind) / 5 * 1e3
    functional = kernel_times(lambda: k10.turn_fill(w.st, k, nperm, g, req, budget,
                                                    state.group_placed, *work.values(), 4096,
                                                    False, True), setup=setup)
    main = timed["by_group"]
    plain_ms = cuda_ms(lambda: k10.turn_fill_plain(w.st, k, nperm, g, req, budget,
                                                   state.group_placed, *work.values(), 4096,
                                                   False, True), reps=5, setup=setup)
    setup()
    placed = int(main["plan"](g, req, budget)[0])
    N, R = state.node_idle.shape
    W = state.node_ports.shape[1]
    T = state.task_status.shape[0]
    n_nodes = int((base["node_num_tasks"] != work["node_num_tasks"]).sum())
    setup()

    def bound(walk):
        # two capacity rows and the order read; the touched node rows
        # read and written; the group's placed tasks written (and their
        # index read), or the task axis's group, rank and validity read
        nbytes = 3 * N * 4 + n_nodes * 2 * (4 * R + 4 + 4 * W) + placed * 8 \
            + (T * 9 if walk else placed * 4)
        return bound_ms(nbytes, N * 4 + (T * 3 if walk else placed * 2))

    b, by = bound(False)
    variants = [dict(route=v, **{x: y for x, y in r.items() if x != "plan"},
                     bound_ms=bound(v == "walk")[0]) for v, r in timed.items()]
    variants.append(dict(route="functional turn_fill (a throwaway plan a call, index build "
                               "included)", ms=functional["ms"], host_us=functional["host_us"]))
    variants.append(dict(route="plan bind (index build, one host read)", ms=bind_ms))
    return dict(name="turn_fill", max_abs_err=max(errs),
                **{x: y for x, y in main.items() if x not in ("plan", "events_per_call",
                                                              "allocations_per_call")},
                plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
                events_per_call=main["events_per_call"], variants=variants + cases,
                shape=f"N={N}, T={T}, {placed} placed on {n_nodes} nodes (binpack after two "
                      f"rounds, TurnFillPlan by_group)")


def pa_fixture(dev):
    """The pod-affinity evictive world at full width, seed 42, on the
    card: the cycle's entry state, and the state after reclaim and three
    allocate rounds (pods placed this cycle, so the counts are live)."""
    from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
    from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
    from kube_arbitrator_tpu_torch.ops import allocate, cycle, preempt
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS as tiers

    w = EVICT_FULL
    arrays, _ = build_synthetic_arrays(w["tasks"], w["nodes"], w["queues"], w["tasks_per_job"], 42,
                                       running_fraction=w["running_fraction"],
                                       fit_fraction=w["fit_fraction"], pod_affinity=True)
    st = from_numpy(arrays, dev)
    sess, entry = cycle.open_session(st, tiers)
    state = preempt.reclaim_action(st, sess, entry, tiers)
    state = allocate.allocate_action(st, sess, state, tiers, max_rounds=3)
    groups = [g for g in range(int(st.group_valid.sum()))
              if (arrays["group_aff_terms"][g] >= 0).any() or (arrays["group_anti_terms"][g] >= 0).any()
              or (arrays["symm_ok"].shape[0] and not arrays["symm_ok"][arrays["group_pa_class"][g]].all())]
    aff, cls = arrays["group_aff_terms"], arrays["group_pa_class"]
    # self-affinity groups: at the cycle's entry nothing of theirs is
    # placed, so their fit seeds
    self_aff = [g for g in groups if aff.shape[1] and aff[g, 0] >= 0
                and arrays["aff_match"][aff[g, 0], cls[g]]]
    return types.SimpleNamespace(st=st, st_cpu=from_numpy(arrays, "cpu"), sess=sess, tiers=tiers,
                                 entry=entry, state=state, groups=groups, self_aff=self_aff)


def k11_case(dev, fx):
    """K11 through one plan: the self-affinity groups at the cycle's entry
    and a spread of groups after reclaim and three allocate rounds,
    launched back to back (the group alternately i64 and i32), each equal
    to pa_fit_plain right after its launch (scratch left dirty by one
    launch would show in the next), one launch a call; and the functional
    pa_fit (a plan of its own) once."""
    from kube_arbitrator_tpu_torch.ops.kernels import pa_fit as k11

    st, state = fx.st, fx.state
    err, seeds, caps, blocked, fits = 0.0, [], [], 0, {}
    cases = [(fx.entry, g) for g in fx.self_aff[:4]]
    cases += [(state, g) for g in sorted(set(fx.groups[::4] + fx.groups[1:40:4]))]
    plan = k11.PaFitPlan(st)
    n0 = k11.pa_fit.launches
    for i, (state, g) in enumerate(cases):
        gt = torch.tensor([g], dtype=torch.int64 if i % 2 else torch.int32, device=dev)
        got = plan(gt, state.task_status, state.task_node)
        want = k11.pa_fit_plain(fx.st_cpu, gt.cpu(), state.task_status.cpu(), state.task_node.cpu())
        for name in want._fields:
            a, b = getattr(got, name), getattr(want, name)
            err = max(err, max_err(a, b))
            expect(torch.equal(a.cpu(), b), f"K11 group {g}: {name} differs from its plain version")
        blocked += int((~want.ok).sum())
        if bool(want.seed_flags.any()):
            seeds.append((g, state))
        if bool(want.cap_flags.any()):
            caps.append((g, state))
        fits[g, id(state)] = k11.PodAffinityFit(*[x.clone() for x in got])  # the plan reuses its outputs
    expect(k11.pa_fit.launches == n0 + len(cases),
           f"K11: {k11.pa_fit.launches - n0} launches for {len(cases)} calls")
    expect(blocked > 0 and seeds and caps, f"K11 inputs: blocked {blocked}, seeds {seeds}, caps {caps}")
    g0, s0 = cases[-1][1], cases[-1][0]
    got = k11.pa_fit(st, torch.tensor([g0], device=dev), s0.task_status, s0.task_node)
    expect(all(torch.equal(getattr(got, f), getattr(fits[g0, id(s0)], f)) for f in got._fields),
           "K11: the functional pa_fit differs from the plan's launch")
    state = fx.state
    g = torch.tensor([caps[0][0]], device=dev)
    t = kernel_times(lambda: plan(g, state.task_status, state.task_node))
    plain_ms = cuda_ms(lambda: k11.pa_fit_plain(st, g, state.task_status, state.task_node), reps=5)
    # the library call for the counts: one index_add_ of the placed pods'
    # hostname domains
    placed = k11._placed(st, state.task_status, state.task_node)
    key = int(fits[caps[0][0], id(caps[0][1])].cap_keys[0])
    dom = st.node_dom[key][state.task_node[placed].long()].long()
    ones = torch.ones(dom.shape[0], dtype=torch.int32, device=dev)
    acc = torch.zeros(st.num_domains, dtype=torch.int32, device=dev)
    lib_ms = cuda_ms(lambda: acc.zero_().index_add_(0, dom, ones))
    T, N, K = st.num_tasks, st.num_nodes, st.node_dom.shape[0]
    # per task the snapshot status, status, node, validity, group and
    # class read once; per node its K domains read and ok written
    nbytes = T * (4 * 5 + 1) + N * (4 * K + 1)
    b, by = bound_ms(nbytes, T * 6 + N * 4 * K)
    return dict(name="pa_fit", max_abs_err=err, **t, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=lib_ms, shape=f"T={T}, N={N}, K={K}, D={st.num_domains}"), fits, seeds, caps


def profiled_records(run) -> tuple:
    """(device events, host launch records, spin seen) of ``run()`` in
    one profile with host and device activity.  The device events are
    profiled_device_events' (a spin kernel first, its event left out);
    the host's records are the calls that start device work
    (``cudaLaunch*`` / ``cuLaunch*`` / ``*Memset*`` / ``*Memcpy*``), at
    the runtime's level or the driver's (or both), less the spin's own
    launch; ``spin seen`` says whether the spin kernel's event is there."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(2000)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    runtime = driver = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            continue
        runtime += e.name().startswith(("cudaLaunch", "cudaMemset", "cudaMemcpy"))
        driver += e.name().startswith(("cuLaunch", "cuMemset", "cuMemcpy"))
    spin = sum(SPIN in e.name for e in dev)
    return len(dev) - spin, max(max(runtime, driver) - 1, 0), spin > 0


def device_events_per_call(fn, calls: int = 20, launches: int = 1) -> float:
    """Every device event (kernels, memsets, copies) torch.profiler sees
    per call of ``fn``: a plan's call must launch its ``launches``
    kernels and nothing around them.

    A profile can lose device events: the first launch's (hence the
    spin, see profiled_device_events), and on an H100 once every event
    of three profiles in a row.  A profile is whole when its spin's event
    is there and its device events match the host's launch records.
    Fewer events than ``calls * launches`` in a profile that is not
    whole are profiled again, up to five times; if none is whole, the
    host's launch records (the most a profile saw) count the device's
    events.  More events than launches are never profiled away."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            fn()

    most = 0
    for _ in range(5):
        n, host, spin = profiled_records(run)
        if n >= calls * launches or (spin and n == host):
            return n / calls
        most = max(most, host)
    print(f"device_events_per_call: no whole profile in 5 (the last: {n} device events, "
          f"{host} host launch records, spin {'seen' if spin else 'lost'}); counting the "
          f"host's launch records ({most})", file=sys.stderr, flush=True)
    return most / calls


def launch_records_per_call(fn, calls: int = 20) -> float:
    """The host's records of kernel launches, memsets and copies per call
    of ``fn`` (profiled_records): kept where the profile can lose a
    device event, so they say how many device events a call makes."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            fn()

    return profiled_records(run)[1] / calls


def allocations_per_call(fn, calls: int = 20) -> float:
    """Device allocations (the caching allocator's count) per call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    n0 = torch.cuda.memory_stats()["allocation.all.allocated"]
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (torch.cuda.memory_stats()["allocation.all.allocated"] - n0) / calls


def synthetic_domains(dev, N: int):
    """A pack view of ``N`` nodes under three keys: hostname (a domain a
    node), racks of 40 (every 7th node unlabelled) and zones of 2,048."""
    n = torch.arange(N)
    racks, zones = (N + 39) // 40, (N + 2047) // 2048
    node_dom = torch.stack([n, torch.where(n % 7 == 3, -1, N + n // 40),
                            N + racks + n // 2048]).to(torch.int32)
    return types.SimpleNamespace(node_dom=node_dom.to(dev), num_nodes=N,
                                 num_domains=N + racks + zones)


def k12_case(dev, fx, fits, seeds, caps):
    """K12 through PaShapePlan at its callers' shapes: the immediate turn's
    idle and releasing rows, bound to a TurnCapsPlan's rows and order (a
    seed group and a cap group under first fit, the cap group under
    binpack) and shaped in place after K11's plan wrote the fit, and
    preempt's one-row claim capacity in node order; every launch equal
    to the plain version on the CPU.  Then the routes these shapes do not
    take: the global domain scratch at the pod-affinity world's shape,
    and a row past the register tile (N = 20,480, synthetic domains)
    with either scratch."""
    from kube_arbitrator_tpu_torch.ops.kernels import pa_fit as k11
    from kube_arbitrator_tpu_torch.ops.kernels import pa_shape as k12
    from kube_arbitrator_tpu_torch.ops.kernels import turn_caps as k9

    st = fx.st
    err, changed, variants = 0.0, 0, []
    timed = {}
    for (g, state), policy in ((seeds[0], "first_fit"), (caps[0], "first_fit"),
                               (caps[0], "binpack")):
        gt = torch.tensor([g], device=dev)
        fit_plan = k11.PaFitPlan(st)  # a plan a case: the timed plans keep their fits
        caps_plan = k9.TurnCapsPlan(st, state.node_idle, state.node_releasing, state.node_ports,
                                    state.node_num_tasks, 4096, False, True, policy)
        plans = {r: k12.PaShapePlan(st, fit_plan.fit, caps_plan.k, caps_plan.nperm, scratch=r)
                 for r in k12.SCRATCH}
        for route, plan in plans.items():
            fit = fit_plan(gt, state.task_status, state.task_node)
            k, nperm = caps_plan(gt, st.group_resreq[g].contiguous(), fit.ok)
            before = k.clone()
            n0 = k12.pa_shape.launches
            expect(plan() is k and k12.pa_shape.launches == n0 + 1, "K12: one launch, in place")
            want = k12.pa_shape_plain(fx.st_cpu, to_cpu(fit), before.cpu(),
                                      None if nperm is None else nperm.cpu())
            err = max(err, max_err(k, want))
            expect(torch.equal(k.cpu(), want),
                   f"K12 group {g} {policy} ({route} scratch) differs from its plain version")
            changed += int(not torch.equal(k, before))
            timed.setdefault((policy, route), (plan, k, before, to_cpu(fit), nperm))
        if policy == "first_fit" and "claim" not in timed:
            claim = k12.PaShapePlan(st, fit_plan.fit)
            row = before[0].clone()
            claim(row)
            want = k12.pa_shape_plain(fx.st_cpu, to_cpu(fit), before[:1].cpu())[0]
            expect(torch.equal(row.cpu(), want), "K12's claim row differs from its plain version")
            timed["claim"] = (claim, row, before[0].clone())
    expect(changed > 0, "K12 inputs: no row was shaped")
    # the timed row: the immediate turn's seed group under first fit (as before)
    plan, k, before, fit, nperm = timed["first_fit", "shared"]
    restore = lambda: k.copy_(before)  # noqa: E731 — the launch shapes in place
    t = kernel_times(plan, setup=restore)
    per_call = device_events_per_call(plan)  # shaping is idempotent: no restore needed
    expect(per_call == 1.0, f"one K12 plan launch gave {per_call} device events, not 1")
    allocs = allocations_per_call(plan)
    expect(allocs == 0, f"K12's plan allocates {allocs} times a launch")
    plain_ms = cuda_ms(lambda: k12.pa_shape_plain(st, plan.fit, k, nperm), reps=5, setup=restore)
    # the library call for the seed's sums: one index_add_ of a row by domain
    ndom = st.node_dom[int(fit.seed_keys[0])].long()
    has = ndom >= 0
    idx, row0 = ndom[has], before[0][has]
    acc = torch.zeros(st.num_domains, dtype=torch.int32, device=dev)
    lib_ms = cuda_ms(lambda: acc.zero_().index_add_(0, idx, row0))
    N, D = st.num_nodes, st.num_domains

    def bound(rows, folds, n):
        # each row read and written once; per active fold the key's n
        # domain ordinals (and the order) read once
        return bound_ms(rows * n * 8 + folds * n * 4 + (n * 4 if nperm is not None else 0),
                        rows * folds * n * 3)

    folds = int(fit.seed_flags.sum()) + int(fit.cap_flags.sum())
    b, by = bound(2, folds, N)
    for name, key in (("immediate, 2 rows, global scratch", ("first_fit", "global")),
                      ("immediate, 2 rows, cap group under binpack", ("binpack", "shared"))):
        p_, k_, b_, f_, n_ = timed[key]
        nf = int(f_.seed_flags.sum()) + int(f_.cap_flags.sum())
        variants.append(dict(form=name, **kernel_times(p_, setup=lambda: k_.copy_(b_)),
                             bound_ms=bound(2, nf, N)[0], folds=nf))
    claim, row, row0 = timed["claim"]
    variants.append(dict(form="claim, 1 row, node order",
                         **kernel_times(lambda: claim(row), setup=lambda: row.copy_(row0)),
                         bound_ms=bound(1, folds, N)[0], folds=folds,
                         events_per_call=device_events_per_call(lambda: claim(row)),
                         allocations_per_call=allocations_per_call(lambda: claim(row))))
    # past the register tile: N = 20,480 in tiles, either scratch
    Nw = 20_480
    wst = synthetic_domains(dev, Nw)
    wst_cpu = types.SimpleNamespace(node_dom=wst.node_dom.cpu(), num_nodes=Nw,
                                    num_domains=wst.num_domains)
    rng = np.random.default_rng(12)
    for trial in range(4):
        wfit = k11.PodAffinityFit(
            torch.ones(Nw, dtype=torch.bool), torch.tensor([True, trial % 2 == 0]),
            torch.tensor([1, 2], dtype=torch.int32), torch.tensor([True, trial < 2]),
            torch.tensor([0, 2], dtype=torch.int32))
        wk = torch.from_numpy((rng.integers(0, 4, (2, Nw)) * (rng.random((2, Nw)) < 0.6))
                              .astype(np.int32))
        wperm = None if trial % 2 else torch.from_numpy(rng.permutation(Nw).astype(np.int32))
        want = k12.pa_shape_plain(wst_cpu, wfit, wk, wperm)
        dk0 = wk.to(dev)
        for route in k12.SCRATCH:
            dk = dk0.clone()
            dfit = k11.PodAffinityFit(*(x.to(dev) for x in wfit))
            wplan = k12.PaShapePlan(wst, dfit, dk, None if wperm is None else wperm.to(dev),
                                    scratch=route)
            wplan()
            expect(torch.equal(dk.cpu(), want),
                   f"K12 at N = {Nw} ({route} scratch, trial {trial}) differs from its plain version")
            if trial == 0:
                variants.append(dict(form=f"tiled N = {Nw}, 2 rows, {route} scratch",
                                     **kernel_times(wplan, setup=lambda: dk.copy_(dk0))))
    return dict(name="pa_shape", max_abs_err=err, **t, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=lib_ms, events_per_call=per_call, variants=variants,
                shape=f"2 rows x N={N}, {folds} fold(s), D={D} (the immediate turn's rows, "
                      f"PaShapePlan); library: index_add_ of one row by domain, the seed's sums only")


# ---- K13-K16: the opt-in reclaim engines' first window of q512_evict,
# and the three compactions at their callers' shapes


def window_fixture(dev):
    """The q512_evict seed-42 world on the card and on the CPU: the
    reclaim entry state after open_session and the optimistic engine's
    first speculation window (its pops, products and picks)."""
    from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
    from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
    from kube_arbitrator_tpu_torch.ops import cycle, preempt
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS as tiers

    w = Q512_EVICT
    arrays, _ = build_synthetic_arrays(w["tasks"], w["nodes"], w["queues"], w["tasks_per_job"], 42,
                                       running_fraction=w["running_fraction"],
                                       fit_fraction=w["fit_fraction"])
    st = from_numpy(arrays, dev)
    sess, state = cycle.open_session(st, tiers)
    state.progress = torch.zeros((), dtype=torch.bool, device=dev)
    ctx = preempt._canon_ctx(st, sess)
    carry = preempt._canon_seed(st, state, ctx)
    use_gang, use_prop, preds_on = preempt._reclaim_flags(tiers)
    RP = preempt._reclaim_panel(st)
    nq, perm = preempt._canon_round_order(st, sess, tiers, state, carry)
    trip = int(nq.clamp(min=1))
    q_panel = perm[torch.arange(RP, device=dev).clamp(max=st.num_queues - 1)]
    in_window = torch.arange(RP, device=dev) < trip
    shared = preempt._reclaim_shared(st, sess, state, tiers, carry.job_consumed)
    pops = preempt.reclaim_select_turns(st, sess, state, tiers, shared, q_panel, carry.q_entries)
    products = preempt._products_plan(st, sess, state, ctx, carry, use_gang, use_prop)
    prods = products()
    return types.SimpleNamespace(
        st=st, st_cpu=from_numpy(arrays, "cpu"), sess=sess, state=state, ctx=ctx, carry=carry,
        flags=(use_gang, use_prop, preds_on), RP=RP, trip=trip, q_panel=q_panel,
        in_window=in_window, pops=pops, products=products, prods=prods)


def canon_world(dev, w, seed):
    """A world's reclaim entry state, canon context and carry on ``dev``
    (and its pack on the CPU): K13's inputs at the engines' first round."""
    from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
    from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
    from kube_arbitrator_tpu_torch.ops import cycle, preempt
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS as tiers

    arrays, _ = build_synthetic_arrays(w["tasks"], w["nodes"], w["queues"], w["tasks_per_job"],
                                       seed, running_fraction=w["running_fraction"],
                                       fit_fraction=w["fit_fraction"])
    st = from_numpy(arrays, dev)
    sess, state = cycle.open_session(st, tiers)
    ctx = preempt._canon_ctx(st, sess)
    carry = preempt._canon_seed(st, state, ctx)
    return types.SimpleNamespace(st=st, st_cpu=from_numpy(arrays, "cpu"), sess=sess, state=state,
                                 ctx=ctx, carry=carry, flags=preempt._reclaim_flags(tiers))


def k13_equal(fx, plan, what) -> float:
    """Hold the plan's outputs (just launched) against the plain version
    run on the CPU over the same state; returns the largest difference."""
    from kube_arbitrator_tpu_torch.ops.kernels import round_products as k13

    use_gang, use_prop, _ = fx.flags
    c, s = to_cpu(fx.carry), to_cpu(fx.state)
    Vp, R = fx.ctx.cres.shape
    want = k13.round_products_plain(fx.st_cpu, to_cpu(fx.ctx), c.cand, c.rank_nj, c.cum_nq,
                                    s.job_ready_cnt, fx.sess.min_avail.cpu(), s.queue_alloc,
                                    use_gang, use_prop,
                                    k13.new_products(Vp, fx.st.num_nodes, R, "cpu"))
    err = 0.0
    for name, a, b in zip(("elig", "pn", "segcum"), plan.out, want):
        err = max(err, max_err(a, b))
        expect(torch.equal(a.cpu(), b), f"K13 {what}: {name} differs from its plain version")
    return err


def k13_case(dev, fx):
    """K13 through ``RoundProductsPlan`` (the engines' form): the q512_evict
    first window (timed), a clear dirty flag, back-to-back launches over
    in-place changes of the carry; a pack whose padding is its longest
    run; node blocks longer than a warp."""
    from kube_arbitrator_tpu_torch.ops import preempt
    from kube_arbitrator_tpu_torch.ops.kernels import round_products as k13
    from kube_arbitrator_tpu_torch.ops.kernels.canon_pick import canon_elig

    use_gang, use_prop, _ = fx.flags
    st, ctx, c, s = fx.st, fx.ctx, fx.carry, fx.state
    Vp, R = ctx.cres.shape
    N = st.num_nodes
    plan = preempt._products_plan(st, fx.sess, s, ctx, c, use_gang, use_prop)
    n0 = k13.round_products.launches
    plan()
    torch.cuda.synchronize()
    per_call = k13.round_products.launches - n0
    err = k13_equal(fx, plan, "q512_evict first window")
    got = plan.out
    expect(int(got[0].sum()) > 0, "K13 inputs: no eligible victim")
    cases = []
    # a clear dirty flag leaves the products as they are, whatever the state
    kept = tuple(x.clone() for x in got)
    clear = torch.zeros(1, dtype=torch.bool, device=dev)
    plan(clear)
    c.cand.logical_not_()
    plan(clear)
    c.cand.logical_not_()
    expect(all(torch.equal(a, b) for a, b in zip(kept, got)), "K13 wrote under a clear dirty flag")
    # the batched engine's refreshes: launches back to back through one
    # plan, the carry changed in place between them (claims clear cand)
    cand0 = c.cand.clone()
    rng = np.random.default_rng(13)
    dirty = torch.ones(1, dtype=torch.bool, device=dev)
    for step in range(3):
        drop = torch.from_numpy(rng.random(Vp) < 0.05 * (step + 1)).to(dev)
        c.cand &= ~drop
        plan(dirty)
        err = max(err, k13_equal(fx, plan, f"back-to-back launch {step}"))
    c.cand.copy_(cand0)
    plan()
    cases.append(dict(case="clear dirty flag, 3 back-to-back launches through one plan", equal=True))
    t = kernel_times(lambda: plan())
    plain_ms = cuda_ms(lambda: k13.round_products_plain(st, ctx, c.cand, c.rank_nj, c.cum_nq,
                                                        s.job_ready_cnt, fx.sess.min_avail,
                                                        s.queue_alloc, use_gang, use_prop,
                                                        plan.out), reps=3)
    # the functional form (a throwaway plan a call)
    out = k13.new_products(Vp, N, R, dev)
    functional = kernel_times(lambda: k13.round_products(
        st, ctx, c.cand, c.rank_nj, c.cum_nq, s.job_ready_cnt, fx.sess.min_avail, s.queue_alloc,
        use_gang, use_prop, out))
    # the library call for the per-node sums: one index_add_ (not in slot
    # order); it covers pn only.  Beside it the nearest composition of
    # elig and pn: the plain eligibility expression, then index_add_ (a
    # per-segment torch.cumsum for segcum is not one call: not timed)
    elig = got[0]
    stat = torch.cat([elig.float()[:, None], torch.where(elig[:, None], ctx.cres, 0.0)], 1)
    idx = ctx.cnode.clamp(max=N - 1).long()
    acc = torch.zeros((N, R + 1), device=dev)
    lib_ms = cuda_ms(lambda: acc.zero_().index_add_(0, idx, stat))

    def composed():
        e = canon_elig(ctx, c.cand, c.rank_nj, c.cum_nq, s.job_ready_cnt, fx.sess.min_avail,
                       s.queue_alloc, use_gang, use_prop)
        v = torch.cat([e.float()[:, None], torch.where(e[:, None], ctx.cres, 0.0)], 1)
        return acc.zero_().index_add_(0, idx, v)

    compose_ms = cuda_ms(composed)
    V = int(st.rv_block_start[-1])
    blocks = (st.rv_block_start[1:] - st.rv_block_start[:-1])
    cases.insert(0, dict(case="q512_evict first window", library_elig_pn_ms=compose_ms, Vp=Vp, V=V,
                         padding=Vp - V, longest_block=int(blocks.max()), window=int(st.rv_window),
                         functional_ms=functional["ms"], functional_host_us=functional["host_us"]))
    # packs whose padding is the longest run, and whose node blocks pass 32 slots
    for what, w, seed in (("padding the longest run", K13_PADDING_WORLD, 7),
                          ("node blocks past 32 slots", K13_LONG_BLOCKS_WORLD, 8)):
        wf = canon_world(dev, w, seed)
        Vw = int(wf.st.rv_block_start[-1])
        bl = int((wf.st.rv_block_start[1:] - wf.st.rv_block_start[:-1]).max())
        pad = wf.ctx.cres.shape[0] - Vw
        expect(pad > bl if what.startswith("padding") else bl > 32,
               f"K13 {what}: padding {pad}, longest block {bl}")
        wplan = preempt._products_plan(wf.st, wf.sess, wf.state, wf.ctx, wf.carry, *wf.flags[:2])
        wplan()
        err = max(err, k13_equal(wf, wplan, what))
        expect(int(wplan.out[0].sum()) > 0, f"K13 {what}: no eligible victim")
        cases.append(dict(case=what, Vp=int(wf.ctx.cres.shape[0]), V=Vw, padding=pad,
                          longest_block=bl, **kernel_times(lambda: wplan())))
        del wf, wplan
    F = c.cum_nq.shape[1]
    nbytes = Vp * (1 + 4 + 4 * F + 4 + 4 + 4 * F + 4 * R + 1) + (N + 1) * 4 + st.num_jobs * 8 \
        + st.num_queues * 4 * R + Vp * (1 + 4 * (R + 1)) + N * 4 * (R + 1)
    b, by = bound_ms(nbytes, Vp * (2 * (R + 1) + 2 * F + 3))
    return dict(name="round_products", max_abs_err=err, **t, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=lib_ms, library_note="index_add_ of pn only",
                launches_per_call=per_call, variants=cases,
                shape=f"Vp={Vp}, N={N}, R={R} (q512_evict first window, RoundProductsPlan)")


def k14_plain(fx, st_cpu, pn, segcum, q, g, hg, pp, req):
    """K14's plain version on the CPU over the fixture's state."""
    from kube_arbitrator_tpu_torch.ops.kernels import union_fit as k14

    s = to_cpu(fx.state)
    return k14.union_fit_plain(st_cpu, to_cpu(fx.ctx.skey), segcum.cpu(), pn.cpu(), q.cpu(),
                               g.cpu(), hg.cpu(), pp.cpu(), req.cpu(), s.node_ports,
                               s.node_num_tasks, fx.flags[2])


def k14_bound(fx, segcum, pn, g, live, pick) -> dict:
    """K14's bound from the timed launch's inputs: what the first-fit
    function needs, not what the kernel's tiles touch.  Each live row
    (popped, with a group, below the trip) screens the nodes up to its
    pick (every node where it has none): 8 screen operations a node and,
    on a node that passes the row's node screens, the own-queue search of
    the node's block (ceil(log2(block length + 1)) levels) and the
    subtract-and-compare of the R + 1 sums.  Bytes: the node rows and the
    canon slots of the blocks below the highest node any row needs, each
    read once, the live rows' inputs, every row's flags and pick.  Also
    the dense figure of the earlier design's bound (every row x every
    node x a search of the whole skey), kept so that the old rows
    compare."""
    st, s, ctx = fx.st, fx.state, fx.ctx
    N, RP = st.num_nodes, live.shape[0]
    Vp, R = ctx.cres.shape
    W = s.node_ports.shape[1]
    i64 = torch.int64
    b = st.rv_block_start.to(i64)
    levels = torch.ceil(torch.log2((b[1:] - b[:-1]).double() + 1.0))
    node_ok = (st.node_valid[None, :].expand(RP, N)).clone()
    if fx.flags[2]:
        gg = g.to(i64)
        node_ok &= ~st.node_unsched[None, :]
        node_ok &= st.class_fit[st.group_klass[gg].to(i64)][:, st.node_klass.to(i64)]
        node_ok &= ((st.group_ports[gg][:, None, :] & s.node_ports[None]) == 0).all(dim=-1)
        node_ok &= (st.node_max_tasks - s.node_num_tasks > 0)[None, :]
    nodes = torch.arange(N, device=pick.device)
    need = live[:, None] & (nodes[None, :] <= pick.to(i64)[:, None])
    cost = 8.0 + node_ok.double() * (levels[None, :] + 2 * (R + 1))
    nops = float((cost * need.double()).sum())
    n_hi = int(need.sum(dim=1).max()) if bool(live.any()) else 0
    slots = int(b[n_hi])
    n_live = int(live.sum())
    nbytes = slots * 4 * (R + 2) + n_hi * (4 * (R + 1) + 4 + 4 * W + 4 + 4 + 3 + 4) \
        + n_live * (4 + 4 + 4 * R) + RP * (2 + 4)
    dense_b, dense_by = bound_ms(
        Vp * 4 + Vp * 4 * (R + 1) + N * 4 * (R + 1) + N * (4 + 4 * W + 4 + 4 + 3)
        + RP * (4 + 4 + 2 + 4 * R) + RP * 4,
        RP * N * (int(np.ceil(np.log2(Vp))) + 2 * (R + 1) + 8))
    bnd, by = bound_ms(nbytes, nops)
    return dict(bound_ms=bnd, bound_by=by, bound_ops=nops, bound_bytes=nbytes,
                live_rows=n_live, nodes_needed_max=n_hi, dense_bound_ms=dense_b,
                dense_bound_by=dense_by)


def k14_case(dev, fx):
    """K14 through ``UnionFitPlan`` in every form: the q512_evict first
    window with ``ctl`` (the optimistic engine's form, timed) and with the
    rows masked outside, a window partly and wholly past the trip, no
    claim, a claim only at the last row, a pick at the last node, the
    batched engine's one-row form, i32 and i64 q, and a pack whose N is
    not a multiple of the tile; each pick equal to the plain version's on
    the CPU; one device event and no allocation a launch."""
    from kube_arbitrator_tpu_torch.ops import preempt
    from kube_arbitrator_tpu_torch.ops.kernels import union_fit as k14
    from kube_arbitrator_tpu_torch.ops.kernels import window_gate as k15

    _, _, preds_on = fx.flags
    st, ctx, s = fx.st, fx.ctx, fx.state
    jp, gp, hgp, reqp, popp, burnp = fx.pops
    _, pn, segcum = fx.prods
    N, RP = st.num_nodes, fx.RP
    q = fx.q_panel
    cases = []
    plan = preempt._fit_plan(st, s, ctx, fx.products, preds_on, RP)
    ctl, _ = k15.new_gate(ctx.cres.shape[1], dev)

    def launch(p, *rows, **kw):
        n0 = k14.union_fit.launches
        got = p(*rows, **kw)
        expect(k14.union_fit.launches == n0 + 1, "K14: one launch a call")
        expect(got is p.pick, "K14: the plan's own pick")
        return got.clone()

    def check(what, got, want, **extra):
        expect(torch.equal(got.cpu(), want), f"K14 {what} differs from its plain version")
        claims = int((want < N).sum())
        cases.append(dict(case=what, claims=claims, first=int((want < N).nonzero()[0, 0])
                          if claims else None, **extra))
        return claims

    # the first window, with ctl and with the pop masked outside
    ctl[k15.START], ctl[k15.TRIP] = 0, fx.trip
    want = k14_plain(fx, fx.st_cpu, pn, segcum, q, gp, hgp, popp & fx.in_window, reqp)
    got = launch(plan, q, gp, hgp, popp, reqp, ctl=ctl)
    n_claim = check("q512_evict first window, ctl, i64 q", got, want)
    expect(n_claim > 1 and int((want == N).sum()) > 0 and int(want[0]) < N,
           f"K14 inputs: {n_claim} rows claim, row 0 picks {int(want[0])}")
    check("q512_evict first window, pop masked outside, i32 q",
          launch(plan, q.to(torch.int32), gp, hgp, popp & fx.in_window, reqp), want)
    # a window partly, then wholly, past the trip
    for start in (fx.trip - 5, fx.trip):
        ctl[k15.START] = start
        inw = torch.arange(RP, device=dev) + start < fx.trip
        check(f"START {start}, TRIP {fx.trip}", launch(plan, q, gp, hgp, popp, reqp, ctl=ctl),
              k14_plain(fx, fx.st_cpu, pn, segcum, q, gp, hgp, popp & inw, reqp))
    ctl[k15.START] = 0
    # no claim: requests above every node's victims
    big = torch.full_like(reqp, 3.0e38)
    want_big = k14_plain(fx, fx.st_cpu, pn, segcum, q, gp, hgp, popp & fx.in_window, big)
    nb = k14_bound(fx, segcum, pn, gp, popp & fx.in_window & hgp, want_big.to(dev))
    expect(check("no claim (every live row walks every tile)",
                 launch(plan, q, gp, hgp, popp, big, ctl=ctl), want_big,
                 **kernel_times(lambda: plan(q, gp, hgp, popp, big, ctl=ctl)),
                 bound_ms=nb["bound_ms"], bound_by=nb["bound_by"]) == 0,
           "K14: a request above every node's victims claimed")
    # a claim only at the last row: a claiming row's queue, group and
    # request moved there, every other row not popping
    c = int((want < N).nonzero()[-1, 0])
    q2, g2, h2, r2 = q.clone(), gp.clone(), hgp.clone(), reqp.clone()
    q2[-1], g2[-1], h2[-1], r2[-1] = q[c], gp[c], hgp[c], reqp[c]
    p2 = torch.zeros_like(popp)
    p2[-1] = True
    last = check("a claim only at the last row", launch(plan, q2, g2, h2, p2, r2),
                 k14_plain(fx, fx.st_cpu, pn, segcum, q2, g2, h2, p2, r2))
    expect(last == 1, f"K14: {last} rows claim, not only the last")
    # a pick at the last schedulable node (the pack pads N past it):
    # every other node's union count cleared
    n_last = int((st.node_valid & ~st.node_unsched).nonzero()[-1, 0])
    pn_last = pn.clone()
    pn_last[:, 0] = 0.0
    pn_last[n_last] = 1.0e9
    lplan = k14.UnionFitPlan(st, ctx.skey, segcum, pn_last, s.node_ports, s.node_num_tasks,
                             preds_on, RP)
    lw = k14_plain(fx, fx.st_cpu, pn_last, segcum, q, gp, hgp, popp & fx.in_window, reqp)
    check(f"every pick at the last schedulable node ({n_last} of N = {N})",
          launch(lplan, q, gp, hgp, popp, reqp, ctl=ctl), lw,
          **kernel_times(lambda: lplan(q, gp, hgp, popp, reqp, ctl=ctl)))
    expect(int((lw == n_last).sum()) > 0, f"K14: no row picks node {n_last}")
    # the batched engine's one-row form: the turn's q i64[1], req f32[R]
    one = preempt._fit_plan(st, s, ctx, fx.products, preds_on, 1)
    row = (q[c:c + 1], gp[c:c + 1], hgp[c:c + 1], popp[c:c + 1], reqp[c])
    want_one = k14_plain(fx, fx.st_cpu, pn, segcum, *row[:4], reqp[c:c + 1])
    ob = k14_bound(fx, segcum, pn, row[1], row[3] & row[2], want_one.to(dev))
    check("batched engine's one-row form", launch(one, *row), want_one,
          **kernel_times(lambda: one(*row)), bound_ms=ob["bound_ms"], bound_by=ob["bound_by"])
    # N not a multiple of the tile: every queue's pop on two more packs
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS as tiers
    for what, w, seed in K14_TILE_EDGE_WORLDS:
        wf = canon_world(dev, w, seed)
        wst = wf.st
        qs = torch.arange(wst.num_queues, device=dev)
        shared = preempt._reclaim_shared(wst, wf.sess, wf.state, tiers, wf.carry.job_consumed)
        _, wg, wh, wr, wp, _ = preempt.reclaim_select_turns(wst, wf.sess, wf.state, tiers, shared,
                                                            qs, wf.carry.q_entries)
        wprod = preempt._products_plan(wst, wf.sess, wf.state, wf.ctx, wf.carry, *wf.flags[:2])
        _, wpn, wseg = wprod()
        wplan = preempt._fit_plan(wst, wf.state, wf.ctx, wprod, wf.flags[2], qs.shape[0])
        ww = k14_plain(wf, wf.st_cpu, wpn, wseg, qs, wg, wh, wp, wr)
        expect(wst.num_nodes % 1024 != 0, f"K14 {what}: N is a multiple of the tile")
        wc = check(f"{what} (not a multiple of the tile), every queue",
                   launch(wplan, qs, wg, wh, wp, wr), ww, N=wst.num_nodes)
        expect(wc > 0, f"K14 {what}: no row claims")
        # the picks pushed into the last tile: the union counts of the
        # first three quarters of the schedulable nodes cleared
        cut = int((wst.node_valid & ~wst.node_unsched).sum()) * 3 // 4
        wpn_cut = wpn.clone()
        wpn_cut[:cut, 0] = 0.0
        cplan = k14.UnionFitPlan(wst, wf.ctx.skey, wseg, wpn_cut, wf.state.node_ports,
                                 wf.state.node_num_tasks, wf.flags[2], qs.shape[0])
        cw = k14_plain(wf, wf.st_cpu, wpn_cut, wseg, qs, wg, wh, wp, wr)
        cc = check(f"{what}, nodes below {cut} without victims", launch(cplan, qs, wg, wh, wp, wr),
                   cw, N=wst.num_nodes, least_pick=int(cw.min()))
        expect(cc > 0 and int(cw.min()) >= cut, f"K14 {what}: {cc} rows claim past node {cut}")
        del wf, wplan, wprod, cplan
    t = kernel_times(lambda: plan(q, gp, hgp, popp, reqp, ctl=ctl))
    per_call = device_events_per_call(lambda: plan(q, gp, hgp, popp, reqp, ctl=ctl))
    expect(per_call == 1.0, f"K14's plan made {per_call} device events a launch, not 1")
    allocs = allocations_per_call(lambda: plan(q, gp, hgp, popp, reqp, ctl=ctl))
    expect(allocs == 0, f"K14's plan allocates {allocs} times a launch")
    inw = popp & fx.in_window
    functional = kernel_times(lambda: k14.union_fit(st, ctx.skey, segcum, pn, q, gp, hgp, inw, reqp,
                                                    s.node_ports, s.node_num_tasks, preds_on))
    cases.insert(0, dict(case="functional union_fit (a throwaway plan a call)",
                         ms=functional["ms"], host_us=functional["host_us"]))
    plain_ms = cuda_ms(lambda: k14.union_fit_plain(st, ctx.skey, segcum, pn, q, gp, hgp, inw, reqp,
                                                    s.node_ports, s.node_num_tasks, preds_on),
                       reps=3)
    bnd = k14_bound(fx, segcum, pn, gp, inw & hgp, want.to(dev))
    cases.append(dict(case="bound of the timed launch (first fit's needs) and the earlier "
                           "design's dense figure", **bnd))
    Vp = ctx.cres.shape[0]
    return dict(name="union_fit", max_abs_err=0.0, **t, plain_ms=plain_ms, **bnd,
                library_ms=None, events_per_call=per_call, variants=cases,
                shape=f"RP={RP} rows x N={N}, Vp={Vp}, {n_claim} rows claim (q512_evict first "
                      f"window, UnionFitPlan with ctl); library: none, no PyTorch call searches "
                      f"and screens per cell")


def k15_case(dev, fx):
    """K15 through ``WindowGatePlan``: the q512_evict first window (a
    claim at row 0 and conflicts; timed) with i64 and i32 q_panel, a
    window with no claim, a claim only at the last row, a window partly
    past the trip; ctl, sel, q_entries, job_consumed and progress equal
    to the plain version's on the CPU; one device event and no allocation
    a launch."""
    from kube_arbitrator_tpu_torch.ops.kernels import union_fit as k14
    from kube_arbitrator_tpu_torch.ops.kernels import window_gate as k15

    _, _, preds_on = fx.flags
    st, ctx, s, c = fx.st, fx.ctx, fx.state, fx.carry
    jp, gp, hgp, reqp, popp, burnp = fx.pops
    _, pn, segcum = fx.prods
    N, R, RP = st.num_nodes, ctx.cres.shape[1], fx.RP
    inw = popp & fx.in_window
    pick = k14.union_fit(st, ctx.skey, segcum, pn, fx.q_panel, gp, hgp, inw, reqp, s.node_ports,
                         s.node_num_tasks, preds_on).clone()
    base = dict(q_entries=c.q_entries, job_consumed=c.job_consumed, progress=s.progress)
    cases = []

    def equal(what, pk, q_panel, start):
        """One launch of a plan over ``pk`` against the plain version."""
        g_t = {k: v.clone() for k, v in base.items()}
        plan = k15.WindowGatePlan(pk, N, jp, gp, hgp, popp, burnp, g_t["q_entries"],
                                  g_t["job_consumed"], R)
        plan.ctl[k15.START], plan.ctl[k15.TRIP] = start, fx.trip
        n0 = k15.window_gate.launches
        plan(q_panel, reqp, g_t["progress"])
        expect(k15.window_gate.launches == n0 + 1, "K15: one launch a call")
        c_t = {k: v.cpu() for k, v in base.items()}
        c_ctl, c_sel = k15.new_gate(R, "cpu")
        c_ctl[k15.START], c_ctl[k15.TRIP] = start, fx.trip
        k15.window_gate_plain(pk.cpu(), N, q_panel.cpu(), jp.cpu(), gp.cpu(), hgp.cpu(),
                              reqp.cpu(), popp.cpu(), burnp.cpu(), c_ctl, c_t["q_entries"],
                              c_t["job_consumed"], c_t["progress"], c_sel)
        for name, a, b in [("ctl", plan.ctl, c_ctl)] + list(zip(("sel_i", "sel_b", "sel_req"),
                                                                plan.sel, c_sel)) \
                + [(k, g_t[k], c_t[k]) for k in base]:
            expect(torch.equal(a.cpu(), b), f"K15 {what}: {name} differs from its plain version")
        cases.append(dict(case=what, ctl=c_ctl.tolist(), has_claim=bool(c_sel[1][3])))
        return c_ctl

    got = equal("q512_evict first window, i64 q_panel", pick, fx.q_panel, 0)
    conflicts = int(got[k15.CONFLICTS])
    expect(bool(cases[-1]["has_claim"]) and conflicts > 0 and int(pick[0]) < N,
           f"K15 inputs: no claim at row 0 or no conflict ({conflicts})")
    equal("q512_evict first window, i32 q_panel", pick, fx.q_panel.to(torch.int32), 0)
    none = torch.full_like(pick, N)
    got = equal("no claim", none, fx.q_panel, 0)
    expect(int(got[k15.ROUND_DONE]) == 1 and int(got[k15.GATED]) == 1,
           "K15: a first window with no claim did not end a gated round")
    last = torch.full_like(pick, N)
    last[-1] = 7
    equal("a claim only at the last row", last, fx.q_panel, 0)
    got = equal("START 5 rows before the trip, no claim", none, fx.q_panel, fx.trip - 5)
    expect(int(got[k15.ROUND_DONE]) == 1 and int(got[k15.GATED]) == 0,
           "K15: a window past the trip did not end the round, ungated")
    equal("START 5 rows before the trip, a claim at row 0", pick, fx.q_panel, fx.trip - 5)
    work = {k: v.clone() for k, v in base.items()}
    plan = k15.WindowGatePlan(pick, N, jp, gp, hgp, popp, burnp, work["q_entries"],
                              work["job_consumed"], R)

    def setup():
        for k, v in base.items():
            work[k].copy_(v)
        plan.ctl.zero_()
        plan.ctl[k15.TRIP] = fx.trip

    def gate():
        return plan(fx.q_panel, reqp, work["progress"])

    t = kernel_times(gate, setup=setup)
    setup()
    per_call = device_events_per_call(gate)
    expect(per_call == 1.0, f"K15's plan made {per_call} device events a launch, not 1")
    allocs = allocations_per_call(gate)
    expect(allocs == 0, f"K15's plan allocates {allocs} times a launch")
    ctl, sel = k15.new_gate(R, dev)
    rows = (pick, N, fx.q_panel, jp, gp, hgp, reqp, popp, burnp)

    def functional(fn):
        return lambda: fn(*rows, ctl, work["q_entries"], work["job_consumed"], work["progress"],
                          sel)

    def fsetup():
        setup()
        ctl.zero_()
        ctl[k15.TRIP] = fx.trip

    f = kernel_times(functional(k15.window_gate), setup=fsetup)
    cases.insert(0, dict(case="functional window_gate (a throwaway plan a call)", ms=f["ms"],
                         host_us=f["host_us"]))
    plain_ms = cuda_ms(functional(k15.window_gate_plain), reps=5, setup=fsetup)
    first = int((pick.cpu() < N).nonzero()[0, 0])
    nbytes = RP * (4 * 4 + 3 + 4 * R) + first * (4 + 1) + 64
    b, by = bound_ms(nbytes, RP * 8)
    return dict(name="window_gate", max_abs_err=0.0, **t, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=None, events_per_call=per_call, variants=cases,
                shape=f"RP={RP}, first claim at row {first}, {conflicts} conflicts (q512_evict "
                      f"first window, WindowGatePlan); library: none, the gate is a chain of "
                      f"dependent scalar decisions")


def order_inputs(fx):
    """(q_active, queue_alloc, deserved, uid rank) of the allocate round
    after two rounds of the 100k x 10k world (8 queues): K17's main-path
    shape."""
    from kube_arbitrator_tpu_torch.ops import allocate
    from kube_arbitrator_tpu_torch.ops.fairness import overused

    st, sess, state = fx.st, fx.sess, fx.mid
    grp_live = allocate.group_live_mask(st, sess, state.group_placed, state.group_unfit, False)
    q_active = (st.queue_valid & allocate.queue_has_live_job(st, grp_live)
                & ~overused(state.queue_alloc, sess.deserved))
    return (q_active, state.queue_alloc.clone(), sess.deserved, st.queue_uid_rank)


def k17_case(dev, fx, alloc_round):
    """K17 through QueueOrderPlan: the q512_evict world's first reclaim
    round (Q = 512: timed; ``queue_perm`` card == CPU) and the allocate
    world's round (Q = 8, the main path's shape: timed), and raw queue
    states of ties, -0.0, NaN, BIG, zero, tiny and subnormal totals and
    alloc > 0 over a zero total at Q = 8 / 512 / 4,096 in both routes,
    and ROADMAP C4's three subnormal rows at Q = 8 and 512 (subnormals
    flushed as the JAX package flushes them),
    each equal to the plain version (the key build, then the stable
    sorts) run on the CPU; one device kernel a ``queue_perm`` call and no
    allocation."""
    from kube_arbitrator_tpu_torch.ops import allocate
    from kube_arbitrator_tpu_torch.ops.kernels import queue_order as k17
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS as tiers

    def check(plan, q_active, alloc, what):
        n0 = k17.queue_order.launches
        perm, nq = plan(q_active, alloc)
        keys = k17.queue_keys_plain(tiers, q_active.cpu(), alloc.cpu(), plan.deserved.cpu(),
                                    plan.uid.cpu())
        want = k17.queue_order_plain(keys, q_active.cpu())
        expect(k17.queue_order.launches == n0 + 1, "K17: one launch a call")
        expect(torch.equal(perm.cpu(), want[0]) and int(nq) == int(want[1]),
               f"K17 differs from its plain version at {what}")

    st, s, sess = fx.st, fx.state, fx.sess
    q512 = (st.queue_valid & (fx.carry.q_entries > 0), s.queue_alloc)
    plan512 = k17.QueueOrderPlan(tiers, sess.deserved, st.queue_uid_rank)
    check(plan512, *q512, "the q512_evict round")
    args = (q512[0], s.queue_alloc, sess.deserved, st.queue_uid_rank)
    _, perm = allocate.queue_perm(tiers, *args, plan512)
    _, perm_cpu = allocate.queue_perm(tiers, *[a.cpu() for a in args])
    expect(torch.equal(perm.cpu(), perm_cpu), "K17: the card's queue order differs from the CPU's")
    a_act, a_alloc, a_des, a_uid = alloc_round
    plan8 = k17.QueueOrderPlan(tiers, a_des, a_uid)
    check(plan8, a_act, a_alloc, "the allocate round")
    pool_a = np.array([0.0, -0.0, 1000.0, 2000.0, 500.0, np.nan, 3.0e38, 1e-20, 1e-39, 5e-45],
                      np.float32)
    pool_d = np.array([0.0, -0.0, 1000.0, 2000.0, 4000.0, 1e-31, 1e-35, 1e-40, 5e-45, 3.0e38,
                       np.nan], np.float32)
    rng = np.random.default_rng(17)
    for Q in (8, 512, 4096):
        for trial in range(3):
            alloc = torch.from_numpy(pool_a[rng.integers(0, len(pool_a), (Q, 4))]).to(dev)
            deserved = torch.from_numpy(pool_d[rng.integers(0, len(pool_d), (Q, 4))]).to(dev)
            uid = rng.permutation(Q).astype(np.int32)
            uid[rng.random(Q) < 0.2] = 0
            act = torch.from_numpy(rng.random(Q) < 0.6).to(dev)
            for variant in k17.VARIANTS:
                plan = k17.QueueOrderPlan(tiers, deserved, torch.from_numpy(uid).to(dev), variant)
                check(plan, act, alloc, f"Q = {Q} ({variant}, trial {trial})")
    # ROADMAP C4's rows: a subnormal alloc, a subnormal quotient and a
    # subnormal total read as the JAX package reads them (shares 0, 0, 1)
    for Q in (8, 512):
        alloc = torch.from_numpy(rng.integers(0, 4, (Q, 4)).astype(np.float32) * 500).to(dev)
        deserved = torch.full((Q, 4), 2000.0, device=dev)
        alloc[:3, 0] = torch.tensor([1e-39, 2e-38, 1.0], device=dev)
        deserved[:3, 0] = torch.tensor([1.0, 2000.0, 1e-39], device=dev)
        alloc[:3, 1:] = 0.0
        act = torch.ones(Q, dtype=torch.bool, device=dev)
        uid = torch.from_numpy(rng.permutation(Q).astype(np.int32)).to(dev)
        keys = k17.queue_keys_plain(tiers, act.cpu(), alloc.cpu(), deserved.cpu(), uid.cpu())
        expect(keys[1][:3].tolist() == [0.0, 0.0, 1.0],
               f"C4 rows: the plain chain's shares are {keys[1][:3].tolist()}")
        for variant in k17.VARIANTS:
            plan = k17.QueueOrderPlan(tiers, deserved, uid, variant)
            check(plan, act, alloc, f"C4's subnormal rows, Q = {Q} ({variant})")
    # shares 0, -0, NaN, 1, -0, 0 over tied uids: -0.0 == +0.0, NaN last
    z = torch.tensor([0.0, -0.0, float("nan"), 1.0, -0.0, 0.0], device=dev)
    alloc6 = torch.stack([z, torch.zeros_like(z), torch.zeros_like(z), torch.zeros_like(z)], 1)
    zplan = k17.QueueOrderPlan(tiers, torch.ones((6, 4), device=dev),
                               torch.zeros(6, dtype=torch.int32, device=dev))
    order = zplan(torch.ones(6, dtype=torch.bool, device=dev), alloc6)[0].tolist()
    expect(order == [0, 1, 4, 5, 3, 2], f"K17 orders shares [0, -0, nan, 1, -0, 0] as {order}")
    t = kernel_times(lambda: plan512(*q512))
    per_call = device_events_per_call(lambda: allocate.queue_perm(tiers, *args, plan512))
    expect(per_call == 1.0, f"one queue_perm call launched {per_call} device kernels, not 1")
    allocs = allocations_per_call(lambda: plan512(*q512))
    expect(allocs == 0, f"K17's plan allocates {allocs} times a launch")
    keys = k17.queue_keys_plain(tiers, q512[0], s.queue_alloc, sess.deserved, st.queue_uid_rank)
    plain_ms = cuda_ms(lambda: k17.queue_order_plain(
        k17.queue_keys_plain(tiers, q512[0], s.queue_alloc, sess.deserved, st.queue_uid_rank),
        q512[0]))
    lib_ms = cuda_ms(lambda: torch.sort(keys[1], stable=True))
    F = 3  # NUM_FAIR_RESOURCES

    def bound(Q):
        # the flags, F columns of alloc and deserved, the uid ranks read
        # once; perm and nq written; F divisions and Q compares a queue
        return bound_ms(Q + 2 * Q * F * 4 + Q * 4 + Q * 8 + 4, Q * F + Q * Q)

    b, by = bound(st.num_queues)
    variants = [dict(form=f"allocate round, Q = {a_act.shape[0]}",
                     **kernel_times(lambda: plan8(a_act, a_alloc)), bound_ms=bound(a_act.shape[0])[0],
                     events_per_call=device_events_per_call(
                         lambda: allocate.queue_perm(tiers, a_act, a_alloc, a_des, a_uid, plan8)))]
    gplan = k17.QueueOrderPlan(tiers, sess.deserved, st.queue_uid_rank, "global")
    variants.append(dict(form="q512_evict round, global route", **kernel_times(
        lambda: gplan(*q512)), bound_ms=b))
    variants.append(dict(form="queue_perm, q512_evict round, through a plan of its own",
                         **kernel_times(lambda: allocate.queue_perm(tiers, *args))))
    return dict(name="queue_order", max_abs_err=0.0, **t, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=lib_ms, events_per_call=per_call, variants=variants,
                shape=f"Q = {st.num_queues}, 3 keys (q512_evict's first reclaim round, "
                      f"QueueOrderPlan: the key build and the order); raw states at Q = 8, 512, "
                      f"4096 in both routes; library: torch.sort(stable=True) of one key")


def delta_plan(prev, new):
    """The changes a DeviceResident scatters for the epoch ``prev`` ->
    ``new`` (fields changed in at most half their rows): (name, host
    array, row indices) per field, as RowScatterPlan takes them."""
    from kube_arbitrator_tpu_torch.cache.arena import changed_fields, changed_rows

    changes = []
    for name in changed_fields(prev, new):
        if name == "rv_window":
            continue
        r = changed_rows(new[name], prev[name])
        if isinstance(r, str) or 2 * len(r) > max(new[name].shape[0], 1):
            continue
        changes.append((name, np.asarray(new[name]), r))
    return changes


def link_rate(dev) -> float:
    """Host-to-device bytes/s of one 64 MB copy from pinned memory (CUDA
    events, mean of 5 after a warm-up)."""
    src = torch.empty(64 << 20, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True), reps=5)
    return src.numel() / (ms * 1e-3)


def k18_case(dev):
    """K18's plan as a DeviceResident owns it: every field dtype and rank
    with duplicate rows, an empty epoch, a field re-placed whole between
    two deltas (its descriptor refreshed), the staging grown and then
    reused with no allocation; then the serving path's shapes, the
    changes phase 7's first delta epoch scatters into the 50k x 5k
    evictive pack (4% of the running tasks completed, 1% of the nodes
    cordoned), timed from the host arrays: one pinned gather, one copy
    and one launch (two device events) a call."""
    from kube_arbitrator_tpu_torch.ops.kernels import row_scatter as k18

    rng = np.random.default_rng(18)
    plan = k18.RowScatterPlan(dev)
    card, host, changes = [], [], []
    for f, (dtype, shape) in enumerate(((np.bool_, (97,)), (np.int32, (97,)), (np.float32, (97,)),
                                        (np.bool_, (97, 3)), (np.bool_, (97, 8)),
                                        (np.int32, (97, 2)), (np.float32, (97, 4)))):
        base = (rng.random(shape) * 100).astype(dtype)
        i = np.sort(rng.choice(97, 20, replace=False)).astype(np.int32)
        i = np.concatenate([i, i[-3:]])
        new = base.copy()
        new[i] = (rng.random((len(i),) + shape[1:]) * 100).astype(dtype)
        card.append(torch.from_numpy(base).to(dev))
        host.append(torch.from_numpy(base.copy()))
        plan.place(f"f{f}", card[-1])
        changes.append((f"f{f}", new, i))
    err = 0.0

    def held(what):
        nonlocal err
        torch.cuda.synchronize()
        err = max([err] + [max_err(a, b) for a, b in zip(card, host)])
        expect(all(torch.equal(a.cpu(), b) for a, b in zip(card, host)),
               f"K18 differs from its plain version ({what})")

    n0 = k18.RowScatterPlan.launches
    plan(changes)
    k18.row_scatter_plain(host, [c[2] for c in changes], [c[1][c[2]] for c in changes])
    expect(k18.RowScatterPlan.launches == n0 + 1, "K18: one launch for seven fields")
    held("field dtypes, ranks, duplicate rows")
    plan([(name, h, i[:0]) for name, h, i in changes])
    expect(k18.RowScatterPlan.launches == n0 + 1, "K18: an empty epoch launched")
    held("an empty epoch")
    # f6 placed whole between two deltas: the next delta lands in the new buffer
    old6 = card[6]
    old6_before = old6.clone()
    card[6] = torch.from_numpy(changes[6][1].copy()).to(dev)
    host[6] = torch.from_numpy(changes[6][1].copy())
    plan.place("f6", card[6])
    new6 = changes[6][1].copy()
    new6[[5, 50]] = -7.0
    changes[6] = ("f6", new6, np.array([5, 50]))
    plan(changes)
    k18.row_scatter_plain(host, [c[2] for c in changes], [c[1][c[2]] for c in changes])
    held("a field re-placed whole between two deltas")
    expect(torch.equal(old6, old6_before), "K18 wrote a field's old buffer after it was re-placed")
    # staging growth: a bigger epoch grows it once; the same epoch again allocates nothing
    cap0 = plan.cap
    big = np.arange(97)
    changes = [(name, h, big) for name, h, _ in changes]
    plan(changes)
    grown = (plan.cap, plan.pinned.data_ptr(), plan.staging.data_ptr())
    k18.row_scatter_plain(host, [c[2] for c in changes], [c[1][c[2]] for c in changes])
    held("a grown staging")
    allocs = allocations_per_call(lambda: plan(changes))
    expect(grown[0] > cap0 and allocs == 0 and grown == (plan.cap, plan.pinned.data_ptr(),
                                                          plan.staging.data_ptr()),
           f"K18's staging: {cap0} -> {grown} bytes, {allocs} device allocations a call after")

    prev, new, _ = serve_epoch_pair()
    changes = delta_plan(prev, new)
    plan = k18.RowScatterPlan(dev)
    card = [torch.from_numpy(np.array(prev[name])).to(dev) for name, _, _ in changes]
    for (name, _, _), c in zip(changes, card):
        plan.place(name, c)
    plain = [c.clone() for c in card]
    plan(changes)
    k18.row_scatter_plain(plain, [c[2] for c in changes], [c[1][c[2]] for c in changes])
    torch.cuda.synchronize()
    want = [torch.from_numpy(np.array(h)) for _, h, _ in changes]
    err = max([err] + [max_err(a, w) for a, w in zip(card, want)])
    expect(all(torch.equal(a.cpu(), w) and torch.equal(p.cpu(), w)
               for a, p, w in zip(card, plain, want)), "K18 at the serving epoch differs")
    fn = lambda: plan(changes)  # noqa: E731
    t = kernel_times(fn)
    events = device_events_per_call(fn, launches=2)
    allocs = allocations_per_call(fn)
    expect(events == 2.0, f"K18: {events} device events a call, not 2 (the copy, the kernel)")
    expect(allocs == 0, f"K18: {allocs} device allocations a call")
    # the same fields with one row each: the call's fixed host cost, apart
    # from the gather of the epoch's rows
    one = [(name, h, i[:1]) for name, h, i in changes]
    t_one = kernel_times(lambda: plan(one))
    idxs = [c[2] for c in changes]
    plain_ms = cuda_ms(lambda: k18.row_scatter_plain(plain, idxs, [h[i] for _, h, i in changes]))

    def library():
        # the same function from the same host rows: each field's rows and
        # indices uploaded, then one index_copy_ per field
        for c, (_, h, i) in zip(card, changes):
            c.index_copy_(0, torch.as_tensor(i.astype(np.int64), device=dev),
                          torch.as_tensor(h[i], device=dev))

    lib_ms = cuda_ms(library)
    nrows = sum(len(i) for i in idxs)
    rbytes = sum(len(i) * h[:1].nbytes for _, h, i in changes)
    ibytes = 4 * nrows
    link = link_rate(dev)
    b, by = bound_ms(2 * rbytes + ibytes, 0)
    b_link = (rbytes + ibytes) / link * 1e3
    names = ", ".join(c[0] for c in changes)
    return dict(name="row_scatter", max_abs_err=err, **t, plain_ms=plain_ms,
                bound_ms=max(b, b_link), bound_by=by, library_ms=lib_ms, events_per_call=events,
                allocations_per_call=allocs, link_bytes_per_s=link, device_bound_ms=b,
                link_bound_ms=b_link,
                variants=[dict(form=f"one row a field ({len(one)} rows)", **t_one)],
                shape=f"RowScatterPlan: {len(changes)} fields, {nrows} rows, {rbytes + ibytes} "
                      f"bytes (the 50k x 5k evictive pack's first delta epoch: {names}) from the "
                      f"host arrays; bound: the rows and indices over the host link "
                      f"({link / 1e9:.1f} GB/s, one 64 MB pinned copy) or the device's bytes, "
                      f"the larger; library: per field the rows and indices uploaded, then one "
                      f"index_copy_")


def k19_grid(dev) -> dict:
    """Every K19 variant against its plain version run on the CPU, bit
    for bit: the one-CTA and the tiled sort at n in {1, 31, 32, TILE - 1,
    TILE, TILE + 1, 51,200, 102,400, 1,048,576} on 1-6 keys with bounds
    and without (random full-range keys with INT_MIN / INT_MAX, keys all
    equal (every pass skipped), descending keys, heavy duplicates); the
    segment order's one-CTA, counting and tiled routes with out-of-range
    ids; the sorted lookup on both sides.  Then both sorts timed at n
    around ONE_CTA_MAX_N (one key and four)."""
    from kube_arbitrator_tpu_torch.ops.kernels import stable_sort as k19

    rng = np.random.default_rng(1919)
    T = k19.TILE
    imin, imax = -2**31, 2**31 - 1

    def keysets(n):
        full = rng.integers(imin, imax, n, dtype=np.int64, endpoint=True).astype(np.int32)
        full[rng.random(n) < 0.05] = imin
        full[rng.random(n) < 0.05] = imax
        small = rng.integers(0, 4, n).astype(np.int32)
        return (
            ("1 key, full range", [full], None),
            ("3 keys, bounds", [rng.integers(0, 300, n).astype(np.int32), small,
                                rng.integers(0, 70_000, n).astype(np.int32)], (299, 3, 69_999)),
            ("6 keys, heavy duplicates", [small, full, small[::-1].copy(),
                                          rng.integers(-3, 4, n).astype(np.int32), small,
                                          rng.integers(0, 2, n).astype(np.int32)], None),
            ("2 keys all equal", [np.full(n, 7, np.int32), np.full(n, -5, np.int32)], None),
            ("1 key descending", [np.arange(n, 0, -1).astype(np.int32)], (n,)),
        )

    checked = 0
    for n in (1, 31, 32, T - 1, T, T + 1, 51_200, 102_400, 1_048_576):
        for name, ks, bounds in keysets(n):
            cpu = [torch.from_numpy(k) for k in ks]
            want = k19.stable_sort_plain(cpu, bounds, want_sorted=True)
            card = [k.to(dev) for k in cpu]
            for variant in ("one_cta", "tiles"):
                got = k19.stable_sort(card, bounds, want_sorted=True, variant=variant)
                expect(torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1]),
                       f"K19 {variant} sort differs from its plain version: n={n}, {name}")
                checked += 1
    for n, S in ((1, 1), (31, 7), (T + 1, 1024), (102_400, 1024), (51_200, k19.COUNT_MAX_BINS - 1),
                 (102_400, 5000), (1_048_576, 1024)):
        idx = torch.from_numpy(rng.integers(-3, S + 4, n).astype(np.int32))
        want = k19.segment_order_plain(idx, S)
        routes = ("one_cta", "tiles") + (("count",) if S + 1 <= k19.COUNT_MAX_BINS else ())
        for variant in routes:
            got = k19.segment_order(idx.to(dev), S, variant=variant)
            expect(torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1]),
                   f"K19 segment_order {variant} differs from its plain version: n={n}, S={S}")
            checked += 1
    for n in (1, 512, 5000):
        sk = torch.from_numpy(np.sort(rng.integers(-50, 50, n)).astype(np.int32))
        sk[-1] = imax
        q = torch.from_numpy(np.concatenate([rng.integers(-60, 60, 4000), [imin, imax]])
                             .astype(np.int32))
        for side in ("left", "right"):
            for o32 in (False, True):
                want = k19.sorted_lookup_plain(sk, q, side, o32)
                got = k19.sorted_lookup(sk.to(dev), q.to(dev), side, o32)
                expect(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
                       f"K19 sorted_lookup differs from its plain version: n={n}, side {side}")
                checked += 1
    times = []
    for n in (1024, 2048, 4096, 8192, 16_384):
        for nk in (1, 4):
            ks = [torch.from_numpy(rng.integers(0, 2**31 - 1, n).astype(np.int32)).to(dev)
                  for _ in range(nk)]
            row = dict(n=n, keys=nk)
            for variant in ("one_cta", "tiles"):
                row[variant + "_ms"] = cuda_ms(lambda: k19.stable_sort(ks, variant=variant))
            times.append(row)
    print(f"K19 variants: {checked} cases equal to the plain versions; one CTA vs tiles: "
          f"{json.dumps(times)}", flush=True)
    return dict(cases=checked, threshold_ms=times)


def k19_case(dev, fx):
    """K19 at its three callers' shapes in the 50k x 5k evictive world,
    each against its plain version run on the CPU (never against the
    card's own torch.sort): preempt's (node, queue) victim lexsort over
    the full-width panel, P = 51,200 (uid, priority, queue, node; seeded
    priorities in -3..3 on the real slots, INT_MAX on the padding; the
    case timed); the claim-log join, J = 512 claims sorted and T = 51,200
    task keys looked up; segment_order at 102,400 slots -> 1,024 segments
    with out-of-range slots, and the one-segment case of ordered_sum."""
    from kube_arbitrator_tpu_torch.api.types import TaskStatus
    from kube_arbitrator_tpu_torch.ops import preempt
    from kube_arbitrator_tpu_torch.ops.kernels import stable_sort as k19

    st, s = fx.st, fx.state
    T = st.num_tasks
    rng = np.random.default_rng(19)
    running0 = (s.task_status == int(TaskStatus.RUNNING)) & st.task_valid & (s.task_node >= 0)
    view = preempt._build_view(st, s, running0, T)
    idx = view.idx.clamp(max=T - 1).to(torch.int64)
    uid = torch.where(view.valid, st.task_uid_rank[idx], INT_MAX).to(torch.int32)
    prio = torch.from_numpy(rng.integers(-3, 4, T).astype(np.int32)).to(dev)
    prio = torch.where(view.valid, prio, INT_MAX).to(torch.int32)
    keys = (uid, prio, view.queue, view.node)
    got = k19.stable_sort(keys, want_sorted=True)
    want = k19.stable_sort_plain([k.cpu() for k in keys], want_sorted=True)
    expect(torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1]),
           "K19 victim lexsort differs from its plain version")
    expect(bool((prio < 0).any()) and bool((prio == INT_MAX).any()), "K19 keys lack negatives / padding")
    # the claim-log join: one claim per job, 3/4 of the rows used
    J = 512
    G = int(st.group_valid.sum())
    n = min(J, G) * 3 // 4
    log_g = np.full(J, -1, np.int64)
    log_g[:n] = rng.permutation(G)[:n]
    size = st.group_size.cpu().numpy()
    log_r = np.where(log_g >= 0, rng.integers(0, np.maximum(size[np.maximum(log_g, 0)], 1)), 0)
    claim_key = torch.from_numpy(np.where(log_g >= 0, log_g * (T + 1) + log_r, INT_MAX)
                                 .astype(np.int32)[rng.permutation(J)]).to(dev)
    task_key = (st.task_group.clamp(0, st.num_groups - 1) * (T + 1) + st.task_group_rank).to(torch.int32)

    def join(ck, tk, sort, lookup):
        order, ks = sort((ck,), want_sorted=True)
        return (order, ks) + tuple(lookup(ks, tk))

    gj = join(claim_key, task_key, k19.stable_sort, k19.sorted_lookup)
    wj = join(claim_key.cpu(), task_key.cpu(), k19.stable_sort_plain, k19.sorted_lookup_plain)
    expect(all(torch.equal(a.cpu(), b) for a, b in zip(gj, wj)), "K19 claim join differs from its plain version")
    expect(int(gj[3].sum()) > 0, "K19 claim join found no task")
    # segment_order: out-of-range slots, then one segment (ordered_sum's)
    S, Ts = 1024, 102_400
    sidx = torch.from_numpy(rng.integers(-3, S + 4, Ts).astype(np.int32))
    for ix, nseg in ((sidx, S), (torch.zeros(Ts, dtype=torch.int32), 1)):
        a, b = k19.segment_order(ix.to(dev), nseg), k19.segment_order(ix, nseg)
        expect(torch.equal(a[0].cpu(), b[0]) and torch.equal(a[1].cpu(), b[1]),
               f"K19 segment_order differs from its plain version at S = {nseg}")
    sidx_d = sidx.to(dev)
    seg_key = torch.where((sidx_d >= 0) & (sidx_d < S), sidx_d, S)
    ks_d = join(claim_key, task_key, k19.stable_sort, k19.sorted_lookup)[1]
    t = kernel_times(lambda: k19.stable_sort(keys))
    plain_ms = cuda_ms(lambda: k19.stable_sort_plain(keys), reps=5)
    lib_ms = cuda_ms(lambda: torch.sort(view.node, stable=True))
    b, by = bound_ms(len(keys) * T * 4 + T * 4, 0)
    # the claim join: the J claim keys read, sorted key and order written,
    # the T task keys read, pos (i64) and found written
    jb, jby = bound_ms(J * 4 * 3 + T * (4 + 8 + 1), 0)
    # segment_order: the slot ids read once, perm and seg_start written
    sb, sby = bound_ms(Ts * 4 * 2 + (S + 1) * 4, 0)
    variants = [
        dict(case=f"claim join (J={J} sort + T={T} lookups)",
             **kernel_times(lambda: join(claim_key, task_key, k19.stable_sort, k19.sorted_lookup)),
             plain_ms=cuda_ms(lambda: join(claim_key, task_key, k19.stable_sort_plain,
                                           k19.sorted_lookup_plain), reps=5),
             bound_ms=jb, bound_by=jby,
             library_ms=cuda_ms(lambda: torch.searchsorted(ks_d, task_key)),
             library="torch.searchsorted of the T lookups"),
        dict(case=f"segment_order {Ts} -> {S} ({k19.segment_order_variant(Ts, S)})",
             **kernel_times(lambda: k19.segment_order(sidx_d, S)),
             plain_ms=cuda_ms(lambda: k19.segment_order_plain(sidx_d, S), reps=5), bound_ms=sb,
             bound_by=sby, library_ms=cuda_ms(lambda: torch.sort(seg_key, stable=True)),
             library=f"torch.sort(stable=True) of the segment key at {Ts}"),
    ]
    for v in variants:
        print(f"kernel stable_sort: {v}", flush=True)
    grid = k19_grid(dev)
    return dict(name="stable_sort", max_abs_err=0.0, **t, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=lib_ms, variants=variants, grid=grid,
                shape=f"4 keys i32[{T}] (preempt's by_node_queue victim layout); library: "
                      f"torch.sort(stable=True) of one key")


def k20_case(dev):
    """K20 through ``OrderedScanPlan`` and ``mm_cumsum``'s throwaway plan:
    every edge of the recursion's 16-row blocks and of the 4,096-row tiles
    (V 1 to 65,537, 200,000 and 16^5 = 1,048,576 rows: a chain, one tile,
    up to 16 tiles and more), C 1 / 3 / 4 (and 9: three column chunks),
    fractional values with -0.0 among them, plain and masked (``where(mask,
    rows, 0)``, the masked rows kept), each plan launched twice (its next
    launch number and ticket), bit for bit the plain version run on the
    CPU; one launch, one device event and no allocation a call; timed at
    _reclaim_fast's shapes ([51,200, 3], the case of the row; the masked
    [51,200, 4] of its covering prefix)."""
    from kube_arbitrator_tpu_torch.ops import common
    from kube_arbitrator_tpu_torch.ops.kernels import ordered_scan as k20

    rng = np.random.default_rng(20)
    err, checked = 0.0, 0

    def bits_equal(a, b, what):
        expect(torch.equal(a.cpu().view(torch.int32), b.view(torch.int32)),
               f"K20 differs from its plain version: {what}")

    def launch(plan, **kw):
        n0 = k20.ordered_scan.launches
        out = plan(**kw)
        expect(k20.ordered_scan.launches == n0 + 1, "K20: one launch a call")
        return out

    grid = [(V, C) for V in (1, 15, 16, 17, 255, 256, 257, 4095, 4096, 4097, 51_200, 65_536,
                             65_537, 200_000) for C in (1, 3, 4)]
    grid += [(51_200, 9), (k20.MAX_ROWS, 3)]
    for V, C in grid:
        x = (rng.integers(1, 64_000, (V, C)) * rng.random((V, C))).astype(np.float32)
        x[rng.random((V, C)) < 0.02] = -0.0
        xc = torch.from_numpy(x)
        mask = torch.from_numpy(rng.random(V) < 0.7)
        want = k20.ordered_scan_plain(xc)
        want_m = k20.ordered_scan_plain(k20.masked_rows_plain(mask, xc))
        xd, md = xc.to(dev), mask.to(dev)
        plan = k20.OrderedScanPlan(V, C, dev)
        for _ in range(2):
            got = launch(plan, x=xd)
            bits_equal(got, want, f"[{V}, {C}]")
        mplan = k20.OrderedScanPlan(V, C, dev, rows=xd)
        for _ in range(2):
            got = launch(mplan, mask=md)
            bits_equal(got, want_m, f"masked [{V}, {C}]")
            bits_equal(mplan.masked, k20.masked_rows_plain(mask, xc), f"masked rows [{V}, {C}]")
        if C == 1:
            bits_equal(common.mm_cumsum(xd[:, 0])[:, None], want, f"mm_cumsum [{V}]")
        else:
            bits_equal(common.mm_cumsum(xd), want, f"mm_cumsum [{V}, {C}]")
        err = max(err, max_err(got, want_m))
        checked += 1
        if V == 51_200 and C == 3:
            expect(float(want[-1, 0]) > 2**24, "K20 inputs: the total does not pass 2^24")
    V = 51_200
    x = (rng.integers(1, 64_000, (V, 4)) * rng.random((V, 4))).astype(np.float32)
    x = torch.from_numpy(x).to(dev)
    mask = torch.from_numpy(rng.random(V) < 0.3).to(dev)
    x3 = x[:, :3].contiguous()
    plan = k20.OrderedScanPlan(V, 3, dev)
    mplan = k20.OrderedScanPlan(V, 4, dev, rows=x)
    cases = [dict(case="edges", shapes=checked)]
    for p_, kw in ((plan, dict(x=x3)), (mplan, dict(mask=mask))):
        per_call = device_events_per_call(lambda: p_(**kw))
        expect(per_call == 1.0, f"K20's plan made {per_call} device events a launch, not 1")
        allocs = allocations_per_call(lambda: p_(**kw))
        expect(allocs == 0, f"K20's plan allocates {allocs} times a launch")
    t = kernel_times(lambda: plan(x=x3))
    tm = kernel_times(lambda: mplan(mask=mask))
    bm, bym = bound_ms(V * 1 + 3 * V * 4 * 4, 2 * V * 4)
    cases.append(dict(case="masked [51,200, 4] (_reclaim_fast's covering prefix, 30% masked)",
                      ms=tm["ms"], device_us=tm["device_us"], host_us=tm["host_us"],
                      bound_ms=bm, bound_by=bym, library_ms=cuda_ms(lambda: torch.cumsum(
                          torch.where(mask[:, None], x, 0.0), dim=0)),
                      library="torch.where + torch.cumsum (another add order)"))
    # where the device time goes: one chain (V 16), one tile (4,096), two
    # tiles (8,192), at C 3
    for Vs in (16, 4096, 8192):
        ps = k20.OrderedScanPlan(Vs, 3, dev)
        xs = x3[:Vs].contiguous()
        ts = kernel_times(lambda: ps(x=xs))
        cases.append(dict(case=f"[{Vs}, 3] ({k20.layout(Vs, 3)['tiles']} tile(s), levels "
                               f"{k20.layout(Vs, 3)['levels']})", ms=ts["ms"],
                          device_us=ts["device_us"], host_us=ts["host_us"]))
    functional = kernel_times(lambda: common.mm_cumsum(x3))
    cases.append(dict(case="mm_cumsum [51,200, 3] (a throwaway plan a call)",
                      ms=functional["ms"], device_us=functional["device_us"],
                      host_us=functional["host_us"]))
    plain_ms = cuda_ms(lambda: k20.ordered_scan_plain(x3), reps=5)
    lib_ms = cuda_ms(lambda: torch.cumsum(x3, dim=0))
    b, by = bound_ms(2 * V * 3 * 4, V * 3)
    shape = k20.layout(V, 3)
    return dict(name="ordered_scan", max_abs_err=err, **t, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=lib_ms, variants=cases,
                shape=f"f32[{V},3] through OrderedScanPlan ({shape['tiles']} tiles of "
                      f"{k20.TILE} rows); library: torch.cumsum (another add order)")


def nonzero_pad_row(row, cap: int):
    """K16's function through the library for one mask row: the set
    positions (``torch.nonzero``, a host sync), the first ``cap`` of them
    padded with -1, and the count."""
    idx = torch.full((cap,), -1, dtype=torch.int64, device=row.device)
    nz = torch.nonzero(row).reshape(-1)[:cap]
    idx[:nz.numel()] = nz
    return idx, row.sum()


def k16_case(dev, efx, tfx):
    """K16, one launch a call, in every form, each equal to
    ``stable_compact_plain`` on the CPU: B7 at T = 102,400 with more set
    than cap (timed); the commit's bind and evict lists as one two-row
    launch (``stable_compact_pair``; ``commit_cycle``'s caps); B4 on the
    allocate world's feasibility cells at [K, 10,240] (cap N // 4), and
    at K = 3 with a request floor; B11, the evictive world's running tasks
    (P = T = 51,200) and a T = 102,400 -> P = 51,200 panel; an empty mask,
    a cap of one, L not a multiple of the chunk.  One device event and no
    allocation a call (outputs given); the commit's four launches -> one."""
    from kube_arbitrator_tpu_torch.api.types import TaskStatus
    from kube_arbitrator_tpu_torch.ops import allocate
    from kube_arbitrator_tpu_torch.ops.cycle import decode_caps
    from kube_arbitrator_tpu_torch.ops.kernels import stable_compact as k16
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS as tiers

    rng = np.random.default_rng(16)
    T = 102_400
    bcap, ecap = decode_caps(T)
    mask = torch.from_numpy(rng.random(T) < 0.6).to(dev)  # more set than cap
    cells = allocate._prune_cells(tfx.st, tfx.state0, tiers, False)
    N = tfx.st.num_nodes
    K3 = 3
    cells3 = k16.FeasCells(
        cells.class_fit[torch.arange(K3, device=dev) % cells.class_fit.shape[0]], cells.node_klass,
        cells.node_valid,
        cells.node_unsched, cells.preds_on,
        cells.minreq[:1] * torch.tensor([[0.5], [1.0], [4.0]], device=dev), cells.basis)
    st_e = efx.st
    running0 = (efx.state.task_status == int(TaskStatus.RUNNING)) & st_e.task_valid \
        & (efx.state.task_node >= 0)
    Te = st_e.num_tasks
    qual = torch.from_numpy(rng.random(T) < 0.3).to(dev)  # a panel of 51,200 holds them
    odd = torch.from_numpy(rng.random(T - 777) < 0.5).to(dev)
    cases = (("B7: commit list, count past cap", mask[None, :], bcap, -1),
             ("B4: allocate's cells [K, 10,240], cap N // 4", cells, N // 4, N),
             (f"B4: cells at K = {K3} with a request floor", cells3, N // 4, N),
             (f"B11: the evictive world's running tasks, P = T = {Te}", running0[None, :], Te, Te),
             ("B11: T = 102,400 -> P = 51,200", qual[None, :], T // 2, T),
             ("an empty mask", torch.zeros_like(mask)[None, :], 4096, -1),
             ("a cap of one", mask[None, :], 1, -1),
             (f"L = {T - 777}, not a multiple of the {k16.CHUNK}-chunk", odd[None, :], 5000, -7),
             ("[3, L] mask rows", torch.stack([mask, qual, ~mask]), 40_000, -1))
    variants, err = [], 0.0
    for what, m, cp, pad in cases:
        K = m.shape[0]
        out = k16._outputs(((K, cp),), dev)[0]
        n0 = k16.stable_compact.launches
        gi, gc = k16.stable_compact(m, cp, pad, out=out)
        expect(k16.stable_compact.launches == n0 + 1, f"K16 {what}: one launch a call")
        m_cpu = m.mask().cpu() if isinstance(m, k16.FeasCells) else m.cpu()
        pi, pc = k16.stable_compact_plain(m_cpu, cp, pad)
        err = max(err, max_err(gi, pi), max_err(gc, pc))
        expect(torch.equal(gi.cpu(), pi) and torch.equal(gc.cpu(), pc),
               f"K16 {what} differs from its plain version")
        fn = (lambda m=m, cp=cp, pad=pad, out=out: k16.stable_compact(m, cp, pad, out=out))
        plan = k16.plan_for(torch.cuda.current_device(), K, m.shape[1])
        # each form's own bound: its inputs read once (the mask, or the
        # cells' inputs), the lists and counts written once; and the
        # library's nonzero + pad of the same mask rows
        if isinstance(m, k16.FeasCells):
            nbytes = sum(t.numel() * t.element_size() for t in (
                m.class_fit, m.node_klass, m.node_valid, m.node_unsched, m.minreq, m.basis)
                if t is not None)
        else:
            nbytes = m.numel()
        b, by = bound_ms(nbytes + K * cp * 4 + K * 4, K * m.shape[1] * 2)
        rows_dense = m.mask() if isinstance(m, k16.FeasCells) else m
        lib = cuda_ms(lambda r=rows_dense, cp=cp: [nonzero_pad_row(x, cp) for x in r])
        variants.append(dict(case=what, K=K, L=m.shape[1], cap=cp, counts=gc.tolist()[:3],
                             tiles=plan.tiles, span=plan.span, **kernel_times(fn), bound_ms=b,
                             bound_by=by, library_ms=lib))
    expect(int(mask.sum()) > bcap, "K16 B7 inputs: the count does not pass cap")
    # the commit's two lists: one launch, each row against its own plain list
    emask = torch.from_numpy(rng.random(T) < 0.02).to(dev)
    pout = tuple(t for row in k16._outputs(((1, bcap), (1, ecap)), dev) for t in row)
    n0 = k16.stable_compact.launches
    (bi, bc), (ei, ec) = k16.stable_compact_pair(mask, bcap, -1, emask, ecap, -1, out=pout)
    expect(k16.stable_compact.launches == n0 + 1, "K16: the commit's two lists are not one launch")
    for what, (gi, gc), m, cp in (("bind", (bi, bc), mask, bcap), ("evict", (ei, ec), emask, ecap)):
        pi, pc = k16.stable_compact_plain(m.cpu()[None, :], cp, -1)
        err = max(err, max_err(gi, pi[0]), max_err(gc, pc[0]))
        expect(torch.equal(gi.cpu(), pi[0]) and int(gc) == int(pc[0]),
               f"K16 the commit's {what} list differs from its plain version")

    def pair():
        return k16.stable_compact_pair(mask, bcap, -1, emask, ecap, -1, out=pout)

    # both masks read once, both lists and counts written once; the
    # library: nonzero + pad of each mask (two host syncs)
    pb, pby = bound_ms(2 * T + (bcap + ecap) * 4 + 2 * 4, 2 * T * 2)
    plib = cuda_ms(lambda: (nonzero_pad_row(mask, bcap), nonzero_pad_row(emask, ecap)))
    variants.append(dict(case=f"the commit's bind (cap {bcap}) and evict (cap {ecap}) lists, one "
                              f"launch", **kernel_times(pair), bound_ms=pb, bound_by=pby,
                         library_ms=plib, events_per_call=device_events_per_call(pair),
                         allocations_per_call=allocations_per_call(pair)))
    out = k16._outputs(((1, bcap),), dev)[0]

    def one():
        return k16.stable_compact(mask[None, :], bcap, -1, out=out)

    t = kernel_times(one)
    per_call = device_events_per_call(one)
    expect(per_call == 1.0, f"K16 made {per_call} device events a call, not 1")
    expect(variants[-1]["events_per_call"] == 1.0, "K16's two-row launch is not one device event")
    allocs = allocations_per_call(one)
    expect(allocs == 0 and variants[-1]["allocations_per_call"] == 0,
           f"K16 allocates {allocs} times a call")
    plain_ms = cuda_ms(lambda: k16.stable_compact_plain(mask[None, :], bcap, -1), reps=5)

    lib_ms = cuda_ms(lambda: nonzero_pad_row(mask, bcap))
    b, by = bound_ms(T + bcap * 4 + 4, T * 2)
    for v in variants:
        print(f"kernel stable_compact form {json.dumps(v)}", flush=True)
    return dict(name="stable_compact", max_abs_err=err, **t, plain_ms=plain_ms, bound_ms=b,
                bound_by=by, library_ms=lib_ms, events_per_call=per_call, variants=variants,
                shape=f"B7 mask bool[{T}] -> i32[{bcap}] (count past cap), one launch; library: "
                      f"torch.nonzero + pad (a host sync)")


def pa_invariants(st, dec, seed) -> dict:
    """The pod-affinity world's own guarantees: every self-anti-affinity
    job holds at most one placed pod per node (hostname domain), every
    self-affinity job's placed pods lie in one rack; returns counts."""
    from kube_arbitrator_tpu_torch.api.types import TaskStatus
    from kube_arbitrator_tpu_torch.cache import synth

    tj = st.task_job.cpu().numpy()
    valid = st.task_valid.cpu().numpy()
    J = int(tj[valid].max()) + 1
    running_job = np.zeros(J, bool)
    running_job[tj[valid & (st.task_status.cpu().numpy() == int(TaskStatus.RUNNING))]] = True
    _, pending_terms, _ = synth.pa_world_labels(seed, J, running_job)
    status, node = dec.task_status.cpu().numpy(), dec.task_node.cpu().numpy()
    placed = valid & ((status == int(TaskStatus.ALLOCATED)) | (status == int(TaskStatus.PIPELINED))) \
        & (node >= 0)
    n_anti = n_aff = 0
    for k, terms in pending_terms.items():
        term = terms[0]
        if term.label != ("app", f"job-{k}"):
            continue
        nodes = node[placed & (tj == k)]
        if not len(nodes):
            continue
        if term.anti:
            n_anti += 1
            expect(len(np.unique(nodes)) == len(nodes), f"self-anti job {k} shares a node")
        else:
            n_aff += 1
            racks = np.unique(synth.node_label_value(synth.RACK_KEY, nodes))
            expect(len(racks) == 1, f"self-affinity job {k} spans racks {racks.tolist()}")
    expect(n_anti > 0 and n_aff > 0, "no self-(anti-)affinity job placed")
    return dict(self_anti_jobs=n_anti, self_aff_jobs=n_aff)


# ---------------------------------------------------------------- phases 2-4


def decide_pack(device, w, stripped: bool) -> dict:
    """decide_world's cycle on a pack whose reclaim canon pack is
    stripped when ``stripped`` (reclaim then runs _reclaim_fast)."""
    from kube_arbitrator_tpu_torch.cli import decide_world
    from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
    from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
    from kube_arbitrator_tpu_torch.ops.cycle import schedule_cycle

    if not stripped:
        return decide_world(device=device, **w)
    arrays, _ = build_synthetic_arrays(w["tasks"], w["nodes"], w["queues"], w["tasks_per_job"],
                                       w["seed"], running_fraction=w["running_fraction"],
                                       fit_fraction=w["fit_fraction"])
    for k in ("rv_idx", "rv_valid", "rv_nj_start", "rv_nq_start", "rv_block_start"):
        arrays[k] = arrays[k][:0]
    arrays["rv_window"] = 0
    stats = {}
    dec = schedule_cycle(from_numpy(arrays, device), actions=w["actions"], stats=stats)
    return dict(decisions=dec, rounds={k: v for k, v in stats.items() if k.startswith("rounds")})


def compare(a, b, fields) -> dict:
    """Per field of ``fields``: equal in shape, dtype and value (tensor or
    host numpy fields)."""
    out = {}
    for f in fields:
        x, y = torch.as_tensor(getattr(a, f)).cpu(), torch.as_tensor(getattr(b, f)).cpu()
        out[f] = x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
    return out


def invariants(st, dec, binds) -> None:
    from kube_arbitrator_tpu_torch.cache.snapshot import DEVICE_EPSILON

    valid = st.node_valid.cpu()
    idle0, idle = st.node_idle.cpu()[valid], dec.node_idle.cpu()[valid]
    # a world may start over-committed in a dim (running tasks placed
    # round-robin); the cycle must not take any dim it draws on below -EPS
    drawn = idle != idle0
    expect(bool((idle[drawn] >= -DEVICE_EPSILON).all()), "the cycle took a node's idle below -EPS")
    tj = st.task_job.cpu().long()
    bind = dec.bind_mask.cpu()
    expect(bool(dec.job_ready.cpu()[tj][bind].all()), "a bind of a job that is not gang-ready")
    nodes = dec.task_node.cpu()[bind].long()
    expect(bool(((nodes >= 0) & (nodes < st.num_nodes)).all()), "a bind off the node axis")
    expect(bool(valid[nodes].all()), "a bind on an invalid node")
    expect(len(binds) == int(dec.bind_count), "decoded bind count disagrees")


def evict_invariants(st, dec) -> None:
    """Every committed eviction was a RUNNING task at the snapshot, has a
    claimant, and is of another queue (reclaim), another job of the same
    queue (preempt phase 1) or the claimant's own job (phase 2); no node
    holds more pods than its limit."""
    from kube_arbitrator_tpu_torch.api.types import TaskStatus

    ev = dec.evict_mask.cpu()
    running = int(TaskStatus.RUNNING)
    expect(bool((st.task_status.cpu()[ev] == running).all()), "an eviction of a task that was not RUNNING")
    claimant = dec.evict_claimant.cpu()[ev].long()
    phase = dec.evict_phase.cpu()[ev]
    expect(bool((claimant >= 0).all()), "a committed eviction without a claimant")
    tj = st.task_job.cpu()[ev].long()
    jq = st.job_queue.cpu().long()
    expect(bool(((phase >= 1) & (phase <= 3)).all()), "an eviction without a phase")
    rec, pre, intra = phase == 3, phase == 1, phase == 2
    expect(bool((jq[tj][rec] != jq[claimant][rec]).all()), "a reclaim eviction within its own queue")
    expect(bool(((tj[pre] != claimant[pre]) & (jq[tj][pre] == jq[claimant][pre])).all()),
           "a preempt eviction outside the claimant's queue or of its own job")
    expect(bool((tj[intra] == claimant[intra]).all()), "an intra-job eviction of another job")
    valid = st.node_valid.cpu()
    expect(bool((dec.node_num_tasks.cpu()[valid] <= st.node_max_tasks.cpu()[valid]).all()),
           "a node over its pod limit")


def serve_epochs(w, seed: int, n: int):
    """Epochs 1..n of the serving stream on world ``w``: (epoch, host
    pack, PackMeta), from cache/synth.epoch_stream with SERVE_CHURN of the
    running tasks completing and SERVE_CORDON of the nodes flipping their
    cordon before each epoch after the first."""
    from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays, epoch_stream

    arrays, _ = build_synthetic_arrays(w["tasks"], w["nodes"], w["queues"], w["tasks_per_job"], seed,
                                       running_fraction=w["running_fraction"],
                                       fit_fraction=w["fit_fraction"])
    return epoch_stream(arrays, n, SERVE_CHURN, SERVE_CORDON, seed)


def serve_epoch_pair():
    """(epoch 1's pack, epoch 2's pack, epoch 2's PackMeta) of the
    serving stream on the 50k x 5k evictive world, seed 42."""
    g = serve_epochs(EVICT_FULL, 42, 2)
    _, prev, _ = next(g)
    _, new, meta = next(g)
    return prev, new, meta


def differing(a, b) -> list:
    """The CycleDecisions fields where ``a`` and ``b`` differ."""
    return [f for f, ok in compare(a, b, [f.name for f in dataclasses.fields(a)]).items() if not ok]


def reclaim_once(device, w, turn_batch, count_syncs=False):
    """(state, ms, syncs): one reclaim_action of world ``w`` from its
    open_session state on ``device``; syncs counted under the CUDA sync
    debug mode when asked (None otherwise)."""
    import warnings

    from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
    from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays
    from kube_arbitrator_tpu_torch.ops import cycle, preempt
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS as tiers

    arrays, _ = build_synthetic_arrays(w["tasks"], w["nodes"], w["queues"], w["tasks_per_job"],
                                       w["seed"], running_fraction=w["running_fraction"],
                                       fit_fraction=w["fit_fraction"])
    st = from_numpy(arrays, device)
    sess, state = cycle.open_session(st, tiers)
    from kube_arbitrator_tpu_torch.ops.kernels.canon_commit import canon_commit

    out = {}
    for tb in RECLAIM_ENGINES if turn_batch == "all" else (turn_batch,):
        syncs = None
        if str(device) != "cpu":
            torch.cuda.synchronize()
        k8_before = canon_commit.launches
        t0 = time.perf_counter()
        if count_syncs:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    r = preempt.reclaim_action(st, sess, state, tiers, turn_batch=tb)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            syncs = sum(1 for x in caught if "synchroniz" in str(x.message))
        else:
            r = preempt.reclaim_action(st, sess, state, tiers, turn_batch=tb)
        if str(device) != "cpu":
            torch.cuda.synchronize()
        out[tb] = (r, (time.perf_counter() - t0) * 1e3, syncs, canon_commit.launches - k8_before)
    return out if turn_batch == "all" else out[turn_batch][0]


def canon_walk_casts(dev) -> dict:
    """One canon walk (``reclaim_action``'s default engine) of the
    evictive world (50k x 5k, seed 42) on the card with ``Tensor.to``
    watched: the dtype casts issued from ``_reclaim_canon``'s own frame
    (before the K8 plan, ``q`` / ``j`` / ``g`` were cast to i32 there for
    K8 every turn), and K8's launches."""
    from kube_arbitrator_tpu_torch.ops.kernels.canon_commit import canon_commit

    own = {"n": 0}
    to = torch.Tensor.to

    def watched(self, *a, **kw):
        out = to(self, *a, **kw)
        if out.dtype != self.dtype and sys._getframe(1).f_code.co_name == "_reclaim_canon":
            own["n"] += 1
        return out

    k8_before = canon_commit.launches
    shadowed = "to" in torch.Tensor.__dict__
    torch.Tensor.to = watched
    try:
        reclaim_once(dev, dict(EVICT_FULL, seed=42), None)
    finally:
        if shadowed:
            torch.Tensor.to = to
        else:
            del torch.Tensor.to
    return dict(casts=own["n"], k8_launches=canon_commit.launches - k8_before)


def optimistic_window(dev) -> dict:
    """One optimistic reclaim action of the q512_evict world (50k x 5k,
    seed 42) from its open_session state on the card (host_profile.py's
    ``optimistic_events``): the device events a window, the dtype casts
    issued from ``_reclaim_canon_optimistic``'s own frame, and the
    launches of K14, K15 and K8 beside the windows."""
    from kube_arbitrator_tpu_torch.host_profile import optimistic_events

    w = Q512_EVICT
    return optimistic_events(dev, w["tasks"], w["nodes"], w["queues"], 42, w["running_fraction"],
                             w["tasks_per_job"], w["fit_fraction"])


def compare_states(a, b) -> list:
    """The AllocState fields (tensors and counters) where ``a`` and
    ``b`` differ."""
    diff = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        same = torch.equal(x.cpu(), y.cpu()) if isinstance(x, torch.Tensor) else x == y
        if not same:
            diff.append(f.name)
    return diff


def engines_once(dev, w, count_syncs):
    """The three reclaim engines (canon walk, round-batched, optimistic)
    from one open_session state on the card: every AllocState tensor
    field and the round count equal; per engine its stage time, rounds,
    gated rounds, conflicts, windows, K8 launches (turns; windows for the
    optimistic engine) and (when counted, in a second pass) host syncs."""
    runs = reclaim_once(dev, w, "all")
    base = runs[None][0]
    names = {None: "canon", True: "batched", "optimistic": "optimistic"}
    row = dict(ms={}, counters={}, windows=runs["optimistic"][0].windows, k8_launches={})
    for tb, (r, ms, _, k8) in runs.items():
        diff = [f for f in compare_states(base, r)
                if f not in ("rounds_gated", "claim_conflicts", "windows")]
        expect(not diff, f"{w}: reclaim engine {names[tb]} differs from the canon walk in {diff}")
        row["ms"][names[tb]] = ms
        row["counters"][names[tb]] = [r.rounds, r.rounds_gated, r.claim_conflicts]
        # K8 commits every turn of the canon and batched engines, one
        # claim per window of the optimistic one
        row["k8_launches"][names[tb]] = k8
    expect(row["counters"]["optimistic"][2] > 0, f"{w}: the optimistic engine had no conflict")
    if count_syncs:
        synced = reclaim_once(dev, w, "all", count_syncs=True)
        row["syncs"] = {names[tb]: x[2] for tb, x in synced.items()}
    return row


def kubelet_step(sim, status, cycle: int, churn: float, seed: int = 42) -> dict:
    """Between two scheduler cycles on ``sim`` (either package's
    SimCluster; ``status`` its TaskStatus): pods evicted last cycle
    (RELEASING) terminate and come back PENDING under the name
    ``<uid>.r`` (the Job controller), bound pods start RUNNING, and then
    a seeded ``churn`` of the RUNNING tasks complete (SUCCEEDED, off
    their node).  Every change reaches the arena through the sim's
    delta sink.  Returns the counts of each."""
    def publish(uid, node):
        if sim.delta_sink is not None:
            sim.delta_sink.task_dirty(uid, node)

    tasks = sorted((t for j in sim.cluster.jobs.values() for t in j.tasks.values()),
                   key=lambda t: t.uid)
    dying = [t for t in tasks if t.status == status.RELEASING]
    for t in dying:
        if t.node_name:
            sim.cluster.nodes[t.node_name].remove_task(t)
        job = sim.cluster.jobs[t.job_uid]
        del job.tasks[t.uid]
        sim.add_task(job, t.resreq[0], t.resreq[1], t.resreq[2], name=f"{t.uid}.r",
                     priority=t.priority, volumes=t.resreq[3])
    bound = [t for t in tasks if t.status == status.BOUND]
    for t in bound:
        node = sim.cluster.nodes[t.node_name]
        node.remove_task(t)
        t.status = status.RUNNING
        node.add_task(t)
        publish(t.uid, t.node_name)
    running = [t for t in tasks if t.status == status.RUNNING]
    done = []
    if churn > 0 and running:
        rng = np.random.default_rng([seed, cycle])
        k = max(1, int(len(running) * churn))
        done = [running[i] for i in sorted(rng.choice(len(running), k, replace=False))]
    for t in done:
        sim.cluster.nodes[t.node_name].remove_task(t)
        t.status = status.SUCCEEDED
        publish(t.uid, t.node_name)
    return dict(completed=len(done), recreated=len(dying), started=len(bound))


def priority_burst(sim, num_queues: int, num_nodes: int, priority: int = 1000) -> int:
    """One job at ``priority`` in each queue ``queue-000`` ... of ``sim``
    (either package's SimCluster), with ``num_nodes // 36`` pending tasks
    of 16 cores and 32 GiB each: with generate_cluster's worlds, about
    10% more than the cluster has free, so preempt has to claim nodes
    for them.  Returns the tasks added."""
    per_queue = max(1, num_nodes // 36)
    for q in range(num_queues):
        job = sim.add_job(f"urgent-{q:03d}", queue=f"queue-{q:03d}", priority=priority,
                          creation_ts=1e6 + q)
        for _ in range(per_queue):
            sim.add_task(job, 16_000, 32 * 1024**3, 0, priority=priority)
    return per_queue * num_queues


def between_cycles(sim, status, world: dict, cycle: int, churn: float,
                   burst_after=None) -> dict:
    """What happens on ``sim`` after scheduler cycle ``cycle`` of
    ``world``: kubelet_step, and after cycle ``burst_after`` the
    priority_burst too.  Returns kubelet_step's counts (and the burst's)."""
    row = kubelet_step(sim, status, cycle, churn)
    if cycle == burst_after:
        row["burst"] = priority_burst(sim, world["num_queues"], world["num_nodes"])
    return row


def in_place_fields(prev: dict, cur: dict) -> tuple:
    """The array fields a delta upload from host pack ``prev`` to ``cur``
    writes row by row: the same shape and dtype, and some but at most
    half of their rows changed (the others are placed whole or kept)."""
    out = []
    for name, a in cur.items():
        b = prev[name]
        if a.shape != b.shape or a.dtype != b.dtype or a.ndim == 0:
            continue
        d = a != b
        n = int(d.any(axis=tuple(range(1, d.ndim))).sum())
        if 0 < n and 2 * n <= max(a.shape[0], 1):
            out.append(name)
    return tuple(sorted(out))


def sched_invariants(sim, result, status) -> dict:
    """After a cycle's actuation on ``sim``: no node is over-committed (idle
    at least -epsilon and used at most allocatable + epsilon on every
    axis, at most max_tasks pods), and every job bound this cycle holds at
    least min_available tasks placed (bound or running on a node, or
    pipelined by the cycle).  Returns what it checked."""
    from kube_arbitrator_tpu_torch.api import resource as res

    for n in sim.cluster.nodes.values():
        expect(bool(np.all(n.idle > -res.EPSILON)), f"node {n.name} over-committed: idle {n.idle}")
        expect(bool(np.all(n.used < n.allocatable + res.EPSILON)),
               f"node {n.name} over-committed: used {n.used} of {n.allocatable}")
        expect(len(n.tasks) <= n.max_tasks, f"node {n.name} holds {len(n.tasks)} pods")
    index = result.snapshot.index
    pipelined = np.asarray(result.decisions.task_status)[:len(index.tasks)] == int(status.PIPELINED)
    piped = {}
    for o in np.nonzero(pipelined)[0].tolist():
        piped[index.tasks[o].job_uid] = piped.get(index.tasks[o].job_uid, 0) + 1
    bound_jobs = {index.tasks[r].job_uid for r in result.binds.rows.tolist()}
    on_node = (status.BOUND, status.RUNNING)
    for uid in bound_jobs:
        job = sim.cluster.jobs[uid]
        placed = sum(1 for t in job.tasks.values() if t.node_name and t.status in on_node)
        expect(placed + piped.get(uid, 0) >= job.min_available,
               f"gang {uid}: {placed} placed + {piped.get(uid, 0)} pipelined of "
               f"min_available {job.min_available}")
    return dict(nodes=len(sim.cluster.nodes), bound_jobs=len(bound_jobs))


def cycle_record(result) -> dict:
    """A scheduler cycle's binds, evicts (by phase) and decision digest."""
    dec = result.decisions
    evict = np.asarray(dec.evict_mask)
    return dict(binds=len(result.binds), evicts=len(result.evicts),
                evicts_by_phase=np.bincount(np.asarray(dec.evict_phase)[evict],
                                            minlength=4).tolist(),
                digest=decision_digest(np.asarray(dec.bind_mask), evict))


def verify_at_commit(sched, verified: list):
    """A phase_hook for ``sched`` that runs its arena's verify() at the
    commit point (after decode, before actuation: the cluster the cycle
    decided on) and appends the ms it took to ``verified``."""
    def hook(phase: str) -> None:
        if phase == "commit":
            v0 = time.perf_counter()
            sched.arena.verify()
            verified.append((time.perf_counter() - v0) * 1e3)
    return hook


def check_cycle(sched, result, name: str, c: int, launched: dict, prev, verified: list, want,
                burst_after, on_card: bool = True) -> tuple:
    """The checks that phases 10 and 11 make of cycle ``c`` of world
    ``name`` after ``sched`` ran it: the arena was verified at the commit
    point (verify_at_commit), cycle 1 uploaded in full and each later
    cycle a delta; on the card, K18 launched once in a delta epoch exactly
    when some field has rows to write in place (in_place_fields of the
    host packs ``prev`` and this cycle's), those are the fields the
    resident wrote and include SCHED_K18's named ones; the resident pack
    equals the arena's host pack bit for bit; cycle 1's record equals
    ``want`` (None: not checked); the cycle after the burst evicts in
    preempt's phase 1 and, on the card, launches K6.  Returns this
    cycle's host pack, its record and the row printed for it."""
    from kube_arbitrator_tpu_torch.framework.decider import host_fields

    mode, st = sched.decider.last_mode, sched.history[-1]
    expect(len(verified) == c, f"world ({name}) cycle {c}: the arena was not verified")
    expect(mode == ("full" if c == 1 else "delta"), f"world ({name}) cycle {c} uploaded {mode}")
    scattered = sched.decider.resident.last_scattered
    cur = host_fields(result.snapshot.tensors)
    if c > 1 and on_card:
        # K18 writes the rows of every field with some but at most half
        # its rows changed, all in one launch
        rows = in_place_fields(prev, cur)
        expect(launched["row_scatter"] == (1 if rows else 0),
               f"world ({name}) cycle {c}: K18 launched {launched['row_scatter']} times for "
               f"the rows of {rows}")
        expect(tuple(sorted(scattered)) == rows,
               f"world ({name}) cycle {c}: the resident wrote the rows of {scattered}, "
               f"the host packs change those of {rows}")
        must, whole = SCHED_K18.get((name, c), ((), ()))
        expect(set(must) <= set(rows) and not set(whole) & set(rows),
               f"world ({name}) cycle {c}: K18 wrote the rows of {rows}; the recipe "
               f"writes those of {must} in place and places {whole} whole")
    diff = sched.decider.resident.first_difference(cur)
    expect(diff is None, f"world ({name}) cycle {c}: the resident {diff} differs from the "
           "arena's host pack")
    rec = cycle_record(result)
    if c == 1 and want is not None:
        expect(rec == want, f"world ({name}) cycle 1 differs from the JAX package's "
               f"Scheduler: {rec} vs {want}")
    if burst_after is not None and c == burst_after + 1:
        expect(rec["evicts_by_phase"][1] > 0 and (launched["claim_nodes"] > 0 or not on_card),
               f"world ({name}) cycle {c}: preempt claimed nothing after the burst "
               f"({rec['evicts_by_phase']}, K6 launched {launched['claim_nodes']} times)")
    row = dict(world=name, cycle=c, upload=mode, upload_bytes=sched.decider.last_upload_bytes,
               rebuild=sched.arena.last_rebuild_reason, pending_before=st.pending_before, **rec,
               ms={k: round(getattr(st, f"{k}_ms"), 3) for k in (
                   "snapshot", "upload", "kernel", "decode", "close", "actuate", "transport",
                   "cycle")},
               verify_ms_in_actuate=round(verified[-1], 3),
               k18_launches=launched["row_scatter"], k18_fields=list(scattered))
    return cur, rec, row


def add_launches(counts: dict, launched: dict) -> None:
    for k, v in launched.items():
        counts[k] += v


def expect_launched(counts: dict, need, where: str) -> None:
    for k in need:
        expect(counts[k] > 0, f"kernel {k} was not launched on the {where}")


SCHED_A_KERNELS = ("admit_chunk", "lex_argmin", "decode_deferred", "segment_sum", "stable_compact",
                   "queue_order", "stable_sort", "row_scatter")
# world (b) evicts through reclaim's canon walk (K7, K8) every cycle, and
# through preempt's claims (K6) after the burst
SCHED_B_KERNELS = SCHED_A_KERNELS + ("seg_scan", "claim_nodes", "canon_pick", "canon_commit")


def scheduler_world(dev, smi, name, world, actions, cycles, churn, want, need,
                    burst_after=None) -> tuple:
    """Phase 10 on one world: ``generate_cluster(**world)`` served by the
    port's ``Scheduler(sim, decider=TorchDecider(dev), arena=True)`` for
    ``cycles`` cycles under ``actions`` (default tiers), between_cycles
    between them.  Every cycle passes check_cycle (``want``: the JAX
    package's cycle 1) and sched_invariants after actuation.  Returns the
    kernels' launches over the cycles (every count set to 0 just before
    each cycle) and each cycle's record."""
    from kube_arbitrator_tpu_torch.api.types import TaskStatus
    from kube_arbitrator_tpu_torch.cache.sim import generate_cluster
    from kube_arbitrator_tpu_torch.cache.snapshot import set_sticky_buckets
    from kube_arbitrator_tpu_torch.framework import Scheduler, SchedulerConfig, TorchDecider
    from kube_arbitrator_tpu_torch.ops import kernels
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS

    set_sticky_buckets(True)
    t0 = time.perf_counter()
    sim = generate_cluster(**world)
    n_tasks = sum(len(j.tasks) for j in sim.cluster.jobs.values())
    print(f"scheduler world ({name}): generate_cluster({world}) {n_tasks} tasks in "
          f"{time.perf_counter() - t0:.2f} s; {smi[0] if smi else 'nvidia-smi: no output'}",
          flush=True)
    sched = Scheduler(sim, config=SchedulerConfig(actions=tuple(actions), tiers=DEFAULT_TIERS),
                      decider=TorchDecider(dev), arena=True)
    verified: list = []
    sched.phase_hook = verify_at_commit(sched, verified)
    counts = dict.fromkeys(kernels.counts(), 0)
    evicts, prev, recs = 0, None, []
    for c in range(1, cycles + 1):
        torch.cuda.synchronize()
        kernels.reset_counts()
        result = sched.run_once()
        torch.cuda.synchronize()
        launched = kernels.counts()
        add_launches(counts, launched)
        prev, rec, row = check_cycle(sched, result, name, c, launched, prev, verified, want,
                                     burst_after)
        row.update(sched_invariants(sim, result, TaskStatus))
        evicts += rec["evicts"]
        recs.append(rec)
        if c < cycles:
            row["kubelet"] = between_cycles(sim, TaskStatus, world, c, churn, burst_after)
        print(f"scheduler cycle {json.dumps(row)}; verified, resident == host pack, invariants "
              "hold" + ("; equal to the JAX package's" if c == 1 else ""), flush=True)
    print(f"launches on the scheduler path, world ({name}), {cycles} cycles: {counts}", flush=True)
    if "preempt" in actions:
        expect(evicts > 0, f"world ({name}) evicted nothing")
    expect_launched(counts, need, f"scheduler path ({name})")
    return counts, recs



# ---------------------------------------------------------------- phase 11
# The live plane: the port's Scheduler over cache/live.LiveCache fed by
# an apiserver (cache/fakeapi.FakeApiServer in the process, or the REST
# shim), leader election from framework/leader.py.


def recording_scheduler(*args, **kw):
    """The port's ``framework.Scheduler(*args, **kw)`` whose ``run_once``
    keeps its last CycleResult in ``last``, so a cycle driven through
    ``run`` (the lease acquired and renewed, errors classified) can be
    checked."""
    from kube_arbitrator_tpu_torch.framework import Scheduler

    class Recording(Scheduler):
        last = None

        def run_once(self):
            self.last = super().run_once()
            return self.last

    return Recording(*args, **kw)


def pod_object(name: str, group: str, cpu_milli: float, memory: float, gpu_milli: float,
               priority: int, scheduler: str, node: str = "", phase: str = "Pending") -> dict:
    """A pod of PodGroup ``group`` (namespace default, uid = name) with one
    container requesting ``cpu_milli`` millicores, ``memory`` bytes and
    ``gpu_milli`` / 1000 GPUs."""
    req = {"cpu": f"{int(cpu_milli)}m", "memory": int(memory)}
    if gpu_milli:
        req["nvidia.com/gpu"] = int(gpu_milli) // 1000
    return {
        "metadata": {"name": name, "namespace": "default", "uid": name,
                     "annotations": {"scheduling.k8s.io/group-name": group}, "labels": {}},
        "spec": {"schedulerName": scheduler, "nodeName": node, "priority": int(priority),
                 "containers": [{"name": "c", "resources": {"requests": req}}]},
        "status": {"phase": phase},
    }


def cluster_objects(sim, scheduler: str) -> list:
    """A ``generate_cluster`` world (either package's SimCluster) as
    apiserver objects, (resource, object) in creation order: nodes with
    their allocatable (cpu, memory, GPUs, attachable volumes, pods),
    queues with their weight, one PodGroup a job (minMember, spec.queue,
    creationTimestamp) and its pods (requests, priority, schedulerName
    ``scheduler``, the group annotation; a running task's pod carries
    spec.nodeName and phase Running)."""
    out = []
    for n in sim.cluster.nodes.values():
        cpu, mem, gpu, attach = n.allocatable.tolist()
        alloc = {"cpu": f"{int(cpu)}m", "memory": int(mem), "pods": int(n.max_tasks),
                 "attachable-volumes-csi": int(attach)}
        if gpu:
            alloc["nvidia.com/gpu"] = int(gpu) // 1000
        out.append(("nodes", {"metadata": {"name": n.name, "labels": dict(n.labels)},
                              "spec": {}, "status": {"allocatable": alloc}}))
    for q in sim.cluster.queues.values():
        out.append(("queues", {"metadata": {"name": q.name}, "spec": {"weight": int(q.weight)}}))
    for j in sim.cluster.jobs.values():
        out.append(("podgroups", {
            "metadata": {"name": j.name, "namespace": j.namespace,
                         "creationTimestamp": float(j.creation_ts)},
            "spec": {"minMember": int(j.min_available), "queue": j.queue_uid}, "status": {}}))
    for j in sim.cluster.jobs.values():
        for t in j.tasks.values():
            running = bool(t.node_name) and int(t.status) == int(type(t.status).RUNNING)
            cpu, mem, gpu = t.resreq[:3].tolist()
            out.append(("pods", pod_object(t.uid, j.name, cpu, mem, gpu, t.priority, scheduler,
                                           node=t.node_name if running else "",
                                           phase="Running" if running else "Pending")))
    return out


def load_objects(api, objects) -> None:
    for resource, obj in objects:
        api.create(resource, obj)


def api_rv(api) -> int:
    """The apiserver's current resource version (a LIST's)."""
    return int(api.list("configmaps")[1])


def events_since(api, rv: int, resource: str, etype: str) -> list:
    return [obj for r, res, et, obj in api.event_log if r > rv and res == resource and et == etype]


def live_kubelet_step(api, since_rv: int, cycle: int, churn: float, seed: int = 42) -> dict:
    """Between two live cycles, written to the apiserver: every pod
    DELETEd since ``since_rv`` (an eviction) comes back as a new pending
    pod ``<name>.r`` (its Job controller), and a seeded ``churn`` of the
    Running pods complete (phase Succeeded).  Bound pods are Running
    already (the fake apiserver's kubelet).  Returns the counts."""
    from kube_arbitrator_tpu_torch.options import options

    ours = options().scheduler_name
    deleted = events_since(api, since_rv, "pods", "DELETED")
    for old in deleted:
        md, spec = old["metadata"], old["spec"]
        req = spec["containers"][0]["resources"]["requests"]
        pod = pod_object(md["name"] + ".r", md["annotations"]["scheduling.k8s.io/group-name"],
                         0, 0, 0, spec.get("priority", 0), spec["schedulerName"])
        pod["spec"]["containers"][0]["resources"]["requests"] = dict(req)
        api.create("pods", pod)
    running = sorted((p for p in api.list("pods")[0]
                      if p["status"].get("phase") == "Running"
                      and p["spec"].get("schedulerName") == ours),
                     key=lambda p: p["metadata"]["uid"])
    done = []
    if churn > 0 and running:
        rng = np.random.default_rng([seed, cycle])
        k = max(1, int(len(running) * churn))
        done = [running[i] for i in sorted(rng.choice(len(running), k, replace=False))]
    for pod in done:
        pod["status"]["phase"] = "Succeeded"
        api.update("pods", pod)
    return dict(completed=len(done), recreated=len(deleted))


def live_burst(api, num_queues: int, num_nodes: int, scheduler: str, priority: int = 1000) -> int:
    """priority_burst in apiserver form: one PodGroup in each queue
    (creationTimestamp 1e6 + q) with ``num_nodes // 36`` pending pods of
    16 cores and 32 GiB at ``priority``.  Returns the pods created."""
    per_queue = max(1, num_nodes // 36)
    for q in range(num_queues):
        name = f"urgent-{q:03d}"
        api.create("podgroups", {
            "metadata": {"name": name, "namespace": "default", "creationTimestamp": 1e6 + q},
            "spec": {"minMember": 0, "queue": f"queue-{q:03d}"}, "status": {}})
        for i in range(per_queue):
            api.create("pods", pod_object(f"{name}-{i:05d}", name, 16_000, 32 * 1024**3, 0,
                                          priority, scheduler))
    return per_queue * num_queues


def api_invariants(api, pods: list) -> dict:
    """From the apiserver's own objects: on every node the pods placed
    there and not terminated request at most its allocatable (cpu,
    memory, GPUs; within epsilon) and number at most its pods."""
    from kube_arbitrator_tpu_torch.api import resource as res
    from kube_arbitrator_tpu_torch.cache.live import node_to_info, pod_resreq

    nodes = {n["metadata"]["name"]: node_to_info(n) for n in api.list("nodes")[0]}
    used = {name: res.zeros() for name in nodes}
    count = dict.fromkeys(nodes, 0)
    placed = 0
    for p in pods:
        node = p["spec"].get("nodeName")
        if not node or p["status"].get("phase") in ("Succeeded", "Failed"):
            continue
        expect(node in nodes, f"pod {p['metadata']['name']} on unknown node {node}")
        used[node] += pod_resreq(p)
        count[node] += 1
        placed += 1
    for name, n in nodes.items():
        expect(bool(np.all(used[name][:3] < n.allocatable[:3] + res.EPSILON[:3])),
               f"node {name} over-committed in the apiserver: {used[name]} of {n.allocatable}")
        expect(count[name] <= n.max_tasks, f"node {name} holds {count[name]} pods")
    return dict(placed_pods=placed)


LIVE_CYCLES = 3
# Cycle 1 of phase 11's worlds (a) and (b), as the JAX package's
# Scheduler over its LiveCache decides them on the same apiserver objects
# (tests/test_torch_live_scheduler.py's slow test).  They equal phase 10's
# SCHED_A_42 / SCHED_B_42: list order keeps generate_cluster's order of
# nodes, jobs and tasks, so the live pack decides as the sim's does.
LIVE_A_42 = dict(binds=99_989, evicts=0, evicts_by_phase=[0, 0, 0, 0], digest="dc30e64370254104")
LIVE_B_42 = dict(binds=24_851, evicts=723, evicts_by_phase=[0, 0, 0, 723], digest="4f54be0880803e8d")
# legs (c) and (d): the commit fence on a small world, the REST shim at
# 1k nodes x 100 jobs x 20 tasks
LIVE_C = dict(num_nodes=64, num_jobs=16, tasks_per_job=8, num_queues=4, seed=42)
LIVE_D = dict(num_nodes=1_000, num_jobs=100, tasks_per_job=20, num_queues=8, seed=42)
# a lease long enough for a full-width cycle's host work on a real clock
LIVE_LEASE = dict(lease_duration_s=600.0, renew_deadline_s=480.0, retry_period_s=2.0)


def live_world(dev, smi, name, world, actions, cycles, churn, want, need, lock_dir,
               burst_after=None) -> tuple:
    """Phase 11 (a) / (b): ``generate_cluster(**world)`` written to a
    FakeApiServer as apiserver objects (cluster_objects) and scheduled by
    the port's ``Scheduler(LiveCache(api), decider=TorchDecider(dev),
    arena=True, elector=LeaderElector(<lock_dir>/<name>.lock))`` through
    ``run(max_cycles=1)`` a cycle under ``actions``, live_kubelet_step
    (and after cycle ``burst_after`` live_burst) written to the apiserver
    between cycles.  Before each cycle the cache drains the watch
    (``sync``, timed).  Every cycle passes check_cycle (the arena
    verified at the commit point, so each delta epoch that live ingest
    fed is held to a fresh build of the live model; ``want``: the JAX
    package's cycle 1, None: not checked), and besides: the lease is
    held; every bind shows in the apiserver (spec.nodeName, phase
    Running) and no node is over-committed there (api_invariants); each
    job whose PodGroup status changed got one status PUT, and the PUTs
    are the cycle's job statuses; each evicted pod is gone from the
    apiserver with a DELETED event, and the next drain drops it from the
    model; each later cycle follows a drain that applied events.  On the
    CPU (the tests' small worlds) the launch checks are left out: the
    wrappers run their plain versions there.  Returns the kernels'
    launches over the cycles (every count set to 0 just before each
    cycle, the drain included) and the rows printed."""
    from kube_arbitrator_tpu_torch.cache import FakeApiServer, LiveCache
    from kube_arbitrator_tpu_torch.cache.sim import generate_cluster
    from kube_arbitrator_tpu_torch.cache.snapshot import set_sticky_buckets
    from kube_arbitrator_tpu_torch.framework import LeaderElector, SchedulerConfig, TorchDecider
    from kube_arbitrator_tpu_torch.ops import kernels
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS
    from kube_arbitrator_tpu_torch.options import options

    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    set_sticky_buckets(True)
    ours = options().scheduler_name
    t0 = time.perf_counter()
    objects = cluster_objects(generate_cluster(**world), ours)
    api = FakeApiServer()
    load_objects(api, objects)
    n_pods = sum(1 for r, _ in objects if r == "pods")
    print(f"live world ({name}): generate_cluster({world}) as {len(objects)} apiserver objects "
          f"({n_pods} pods) in {time.perf_counter() - t0:.2f} s; "
          f"{smi[0] if smi else 'nvidia-smi: no output'}", flush=True)
    live = LiveCache(api)
    elector = LeaderElector(f"{lock_dir}/{name}.lock", identity=f"live-{name}", **LIVE_LEASE)
    sched = recording_scheduler(live, config=SchedulerConfig(actions=tuple(actions),
                                                            tiers=DEFAULT_TIERS),
                               decider=TorchDecider(dev), arena=True, elector=elector)
    verified: list = []
    sched.phase_hook = verify_at_commit(sched, verified)
    counts = dict.fromkeys(kernels.counts(), 0)
    rows_out = []
    evicted_before: list = []
    prev = None
    evicts = 0
    for c in range(1, cycles + 1):
        since = api_rv(api)
        statuses = {pg["metadata"]["name"]: pg.get("status") for pg in api.list("podgroups")[0]}
        if on_card:
            torch.cuda.synchronize()
        kernels.reset_counts()
        s0 = time.perf_counter()
        drained = live.sync()
        sync_ms = (time.perf_counter() - s0) * 1e3
        for uid in evicted_before:
            expect(uid not in live._task_by_uid,
                   f"world ({name}) cycle {c}: evicted pod {uid} still in the model after the drain")
        n_hist = len(sched.history)
        sched.run(max_cycles=1)
        if on_card:
            torch.cuda.synchronize()
        launched = kernels.counts()
        add_launches(counts, launched)
        expect(len(sched.history) == n_hist + 1, f"world ({name}) cycle {c} failed")
        expect(elector.is_leader, f"world ({name}) cycle {c}: the lease was lost")
        result = sched.last
        if c > 1:
            expect(drained > 0, f"world ({name}) cycle {c}: the watch drain applied nothing")
        prev, rec, row = check_cycle(sched, result, name, c, launched, prev, verified, want,
                                     burst_after, on_card)
        evicts += rec["evicts"]
        # the apiserver's view
        a0 = time.perf_counter()
        pods = api.list("pods")[0]
        by_uid = {p["metadata"]["uid"]: p for p in pods}
        failed = set(result.failed_actuations)
        expect(not failed, f"world ({name}) cycle {c}: {len(failed)} actuations failed")
        for uid, node in zip(result.binds.uids, result.binds.node_names):
            p = by_uid.get(uid)
            expect(p is not None and p["spec"].get("nodeName") == node
                   and p["status"].get("phase") == "Running",
                   f"world ({name}) cycle {c}: bind {uid} -> {node} not in the apiserver")
        deleted = {o["metadata"]["uid"] for o in events_since(api, since, "pods", "DELETED")}
        for uid in result.evicts.uids:
            expect(uid not in by_uid and uid in deleted,
                   f"world ({name}) cycle {c}: evict {uid} was not a DELETE")
        evicted_before = list(result.evicts.uids)
        puts = events_since(api, since, "podgroups", "MODIFIED")
        put_jobs = [f"{o['metadata']['namespace']}/{o['metadata']['name']}" for o in puts]
        expect(len(put_jobs) == len(set(put_jobs)) and set(put_jobs) == set(result.job_status),
               f"world ({name}) cycle {c}: {len(put_jobs)} status PUTs for "
               f"{len(result.job_status)} job statuses")
        for pg in api.list("podgroups")[0]:
            job = f"default/{pg['metadata']['name']}"
            if pg.get("status") != statuses.get(pg["metadata"]["name"]):
                expect(job in set(put_jobs), f"world ({name}) cycle {c}: {job} changed unPUT")
        checked = api_invariants(api, pods)
        row.update(sync_ms=round(sync_ms, 3), events_drained=drained,
                   bind_posts=len(result.binds), evict_deletes=len(result.evicts.uids),
                   status_puts=len(puts), condition_patches=len(result.task_conditions),
                   check_ms=round((time.perf_counter() - a0) * 1e3, 1), **checked)
        if c < cycles:
            k0 = time.perf_counter()
            row["kubelet"] = live_kubelet_step(api, since, c, churn)
            if c == burst_after:
                row["kubelet"]["burst"] = live_burst(api, world["num_queues"], world["num_nodes"],
                                                     ours)
            row["kubelet"]["ms"] = round((time.perf_counter() - k0) * 1e3, 1)
        rows_out.append(row)
        print(f"live cycle {json.dumps(row)}; verified, every bind in the apiserver, evicts "
              "DELETEd, status PUTs match, no over-commit, resident == host pack"
              + ("; equal to the JAX package's" if c == 1 and want is not None else "")
              + f"; {smi[0] if smi else ''}",
              flush=True)
    print(f"launches on the live path, world ({name}), {cycles} cycles: {counts}", flush=True)
    if "preempt" in actions:
        expect(evicts > 0, f"live world ({name}) evicted nothing")
    expect_launched(counts, need if on_card else (), f"live path ({name})")
    return counts, rows_out


def fence_leg(dev, world: dict, lock_dir: str) -> dict:
    """Phase 11 (c): the commit fence.  Two schedulers, A and B, over one
    FakeApiServer holding ``world``, each with its own LiveCache,
    TorchDecider(dev) and elector on one shared lock, on a fake clock.  A
    leads; its ``phase_hook("commit")`` (after the decision, before
    actuation) moves the clock past A's lease and lets B take it: on the
    lock file (``LeaderElector``) B observes A's record and acquires once
    the lease has run out on its own clock; on the apiserver's ConfigMap
    lock (``ApiLeaderElector``) ``usurp_lease`` writes B's record.  A's
    ``run`` must raise LeaderLost with no apiserver write after the
    commit point and no pod bound; then B's ``run`` schedules and binds.
    Returns each form's LeaderLost message and B's binds."""
    from kube_arbitrator_tpu_torch.cache import FakeApiServer, LiveCache
    from kube_arbitrator_tpu_torch.cache.sim import generate_cluster
    from kube_arbitrator_tpu_torch.cache.snapshot import set_sticky_buckets
    from kube_arbitrator_tpu_torch.framework import (
        ApiLeaderElector, LeaderElector, LeaderLost, TorchDecider)
    from kube_arbitrator_tpu_torch.framework.leader import usurp_lease
    from kube_arbitrator_tpu_torch.options import options

    out = {}
    for form in ("file", "api"):
        set_sticky_buckets(True)
        api = FakeApiServer()
        load_objects(api, cluster_objects(generate_cluster(**world), options().scheduler_name))
        clock = [1000.0]

        def now():
            return clock[0]

        if form == "file":
            # a lock of this call's own: a record left by an earlier call
            # would keep A waiting on the fake clock, which never moves
            lock = f"{tempfile.mkdtemp(dir=lock_dir)}/fence.lock"
            ea = LeaderElector(lock, identity="sched-a", now_fn=now)
            eb = LeaderElector(lock, identity="sched-b", now_fn=now)
        else:
            ea = ApiLeaderElector(api, identity="sched-a", now_fn=now)
            eb = ApiLeaderElector(api, identity="sched-b", now_fn=now)
        expect(ea.try_acquire(), f"fence ({form}): A could not take a free lease")
        at_commit = []

        def usurp(phase: str) -> None:
            if phase != "commit":
                return
            clock[0] += 20.0  # the decision outlasted A's 15 s lease
            if form == "file":
                expect(not eb.try_acquire(), "B took a lease it had not seen expire")
                clock[0] += 20.0
                expect(eb.try_acquire(), "B could not take the expired lease")
            else:
                usurp_lease(api, "sched-b", now())
            at_commit.append(api_rv(api))

        sa = recording_scheduler(LiveCache(api), decider=TorchDecider(dev), arena=True,
                                elector=ea, phase_hook=usurp)
        lost = None
        try:
            sa.run(max_cycles=1)
        except LeaderLost as err:
            lost = str(err)
        expect(lost is not None and "not actuated" in lost,
               f"fence ({form}): A's cycle was not discarded: {lost}")
        expect(api_rv(api) == at_commit[0], f"fence ({form}): the apiserver was written after "
               f"the commit point (rv {at_commit[0]} -> {api_rv(api)})")
        bound = [p for p in api.list("pods")[0] if p["spec"].get("nodeName")]
        expect(not bound and not sa.history and not ea.is_leader,
               f"fence ({form}): A actuated ({len(bound)} pods bound)")
        sb = recording_scheduler(LiveCache(api), decider=TorchDecider(dev), arena=True, elector=eb)
        sb.run(max_cycles=1)
        expect(len(sb.history) == 1 and eb.is_leader, f"fence ({form}): B did not schedule")
        binds = len(sb.last.binds)
        bound = sum(1 for p in api.list("pods")[0] if p["spec"].get("nodeName"))
        expect(binds > 0 and bound == binds, f"fence ({form}): B bound {binds}, the apiserver "
               f"holds {bound} bound pods")
        out[form] = dict(a_lost=lost, b_binds=binds)
    return out


def rest_leg(dev, world: dict, timeout_s: float = 60.0) -> dict:
    """Phase 11 (d): ``world`` in two FakeApiServers, one served by
    ``serve_api`` on 127.0.0.1 (a free port) and read through
    ``LiveCache(HttpApiClient(url))``, the other in the process.  One
    cycle of the port's Scheduler on each (TorchDecider(dev)) must give
    the same binds and leave the same pods bound in both; the server must
    shut down and its thread end."""
    from kube_arbitrator_tpu_torch.cache import FakeApiServer, HttpApiClient, LiveCache, serve_api
    from kube_arbitrator_tpu_torch.cache.sim import generate_cluster
    from kube_arbitrator_tpu_torch.cache.snapshot import set_sticky_buckets
    from kube_arbitrator_tpu_torch.framework import Scheduler, TorchDecider
    from kube_arbitrator_tpu_torch.options import options

    objects = cluster_objects(generate_cluster(**world), options().scheduler_name)
    served, local = FakeApiServer(), FakeApiServer()
    load_objects(served, objects)
    load_objects(local, objects)
    server, thread, url = serve_api(served, "127.0.0.1", 0)
    try:
        set_sticky_buckets(True)
        t0 = time.perf_counter()
        remote = Scheduler(LiveCache(HttpApiClient(url, timeout_s=timeout_s)),
                           decider=TorchDecider(dev), arena=True)
        r_http = remote.run_once()
        http_ms = (time.perf_counter() - t0) * 1e3
        set_sticky_buckets(True)
        t0 = time.perf_counter()
        r_mem = Scheduler(LiveCache(local), decider=TorchDecider(dev), arena=True).run_once()
        mem_ms = (time.perf_counter() - t0) * 1e3
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    expect(not thread.is_alive(), "REST: the server thread did not end")
    pairs = r_http.binds.pairs()
    expect(len(pairs) > 0 and pairs == r_mem.binds.pairs(),
           f"REST: {len(pairs)} binds over HTTP, {len(r_mem.binds)} in the process, or they differ")

    def placed(api):
        return {p["metadata"]["uid"]: p["spec"].get("nodeName")
                for p in api.list("pods")[0] if p["spec"].get("nodeName")}

    expect(placed(served) == placed(local), "REST: the two apiservers hold different placements")
    return dict(binds=len(pairs), http_cycle_ms=round(http_ms, 1),
                in_process_cycle_ms=round(mem_ms, 1),
                http_stats=dataclasses.asdict(remote.history[-1]))


# ---------------------------------------------------------------- phase 12
# The decision pool (rpc/pool.py) and its batched launch, B15
# (ops/cycle.batched_schedule_cycle).


def pool_arrays(w: dict, seed: int) -> dict:
    """The host pack (numpy arrays by field) of synthetic world ``w``."""
    from kube_arbitrator_tpu_torch.cache.synth import build_synthetic_arrays

    arrays, _ = build_synthetic_arrays(w["tasks"], w["nodes"], w["queues"], w["tasks_per_job"],
                                       seed, running_fraction=w["running_fraction"],
                                       fit_fraction=w["fit_fraction"])
    return arrays


def pool_tenants(conf, n: int = 4) -> list:
    """The first ``n`` north-star packs of POOL_SEEDS that share a shape
    key, as (seed, arrays)."""
    from kube_arbitrator_tpu_torch.rpc.pool import conf_fingerprint, pack_shape_key

    fp, groups = conf_fingerprint(conf), {}
    for seed in POOL_SEEDS:
        arrays = pool_arrays(POOL_NORTH_STAR, seed)
        group = groups.setdefault(pack_shape_key(arrays, fp, conf.actions), [])
        group.append((seed, arrays))
        if len(group) == n:
            return group
    raise SmokeFailure(f"no {n} north-star seeds of {POOL_SEEDS} share a shape key: "
                       f"{[[s for s, _ in g] for g in groups.values()]}")


def pool_batch(dev, smi, name: str, tenants: list, conf, need) -> tuple:
    """Phase 12 (a) / (b) on one group of tenant packs, in two rounds:
    each tenant's unbatched ``TorchDecider`` decide on the card (its host
    reads through the seam and its cycle ms), then all of them in one
    ``decide_many`` on a one-replica pool: one batch, each tenant's
    decisions equal to its unbatched decide's in every CycleDecisions
    field, as many host reads as its longest tenant.  Round 1's batched
    cycles (``rpc.pool._run_batched``) run under
    ``torch.cuda.set_sync_debug_mode("warn")``: every synchronising CUDA
    call in them must be one of the seam's reads.  Round 2 is the timed
    one.  Returns (round 2's batch launches, every count
    set to 0 just before it; the unbatched decisions by seed; the row)."""
    import warnings

    from kube_arbitrator_tpu_torch.framework import TorchDecider
    from kube_arbitrator_tpu_torch.ops import kernels, steps
    from kube_arbitrator_tpu_torch.rpc import DecisionPool, np_equal_decisions
    from kube_arbitrator_tpu_torch.rpc import pool as pool_mod

    run_batched, caught = pool_mod._run_batched, []

    def audited(*a, **kw):  # the batched cycles alone, every sync recorded
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return run_batched(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                caught.extend(got)

    rounds = []
    for rnd in (1, 2):
        alone = []
        for seed, arrays in tenants:
            decider = TorchDecider(dev)
            torch.cuda.synchronize()
            r0 = steps.host_reads[0]
            dec, decide_ms = decider.decide(arrays, conf)
            alone.append(dict(seed=seed, dec=dec, reads=steps.host_reads[0] - r0,
                              cycle_ms=decider.last_cycle_ms, decide_ms=decide_ms))
        pool = DecisionPool(replicas=1, device=dev)
        torch.cuda.synchronize()
        kernels.reset_counts()
        r0 = steps.host_reads[0]
        t0 = time.perf_counter()
        pool_mod._run_batched = audited if rnd == 1 else run_batched
        try:
            reqs = pool.decide_many([(f"{name}-{seed}", arrays, conf, None)
                                     for seed, arrays in tenants])
        finally:
            pool_mod._run_batched = run_batched
        torch.cuda.synchronize()
        many_ms = (time.perf_counter() - t0) * 1e3
        launched = kernels.counts()
        reads = steps.host_reads[0] - r0
        for r in reqs:
            if r.error is not None:
                raise r.error
        expect({r.batch for r in reqs} == {len(tenants)} and len({r.batch_id for r in reqs}) == 1,
               f"pool ({name}): {len(tenants)} packs of one shape key launched as "
               f"{[(r.batch, r.batch_id) for r in reqs]}")
        for r, a in zip(reqs, alone):
            expect(np_equal_decisions(r.decisions, a["dec"]),
                   f"pool ({name}) tenant {r.tenant}: batched decisions differ from its unbatched "
                   "decide")
        longest = max(a["reads"] for a in alone)
        expect(reads == longest, f"pool ({name}): {reads} host reads for the batch, its longest "
               f"tenant read {longest}")
        expect_launched(launched, need, f"pool path ({name})")
        row = dict(world=name, round=rnd, seeds=[a["seed"] for a in alone], batch=len(reqs),
                   host_reads=reads, host_reads_alone=[a["reads"] for a in alone],
                   host_reads_sum=sum(a["reads"] for a in alone),
                   batch_ms=round(reqs[0].kernel_ms, 1),
                   cycle_ms_alone=[round(a["cycle_ms"], 1) for a in alone],
                   cycle_ms_sum=round(sum(a["cycle_ms"] for a in alone), 1),
                   decide_many_ms=round(many_ms, 1),
                   decide_ms_sum=round(sum(a["decide_ms"] for a in alone), 1),
                   binds=[int(a["dec"].bind_count) for a in alone],
                   evicts=[int(a["dec"].evict_count) for a in alone])
        if rnd == 1:
            syncs = [f"{w.filename}:{w.lineno}" for w in caught
                     if "called a synchronizing" in str(w.message)]
            row["syncs"] = len(syncs)
            expect(len(syncs) == reads and all(f.split(":")[0].endswith(SEAM_FILE) for f in syncs),
                   f"pool ({name}): {len(syncs)} synchronising calls in the batched cycles, "
                   f"{reads} seam reads: {sorted(set(syncs))}")
            rows_1 = row
        rounds.append(row)
        print(f"pool ({name}) {json.dumps(row)}; every tenant's decisions equal its unbatched "
              f"decide's; {smi[0] if smi else ''}", flush=True)
    print(f"launches on the pool path ({name}), one batch: {launched}", flush=True)
    return launched, {a["seed"]: a["dec"] for a in alone}, dict(round1=rows_1, round2=rounds[-1])


def pool_split(dev, ns, ev, ns_conf, ev_conf, want: dict) -> None:
    """A north-star and an evictive pack submitted together: two shape
    keys, two launches, each tenant's decisions its unbatched decide's."""
    from kube_arbitrator_tpu_torch.rpc import DecisionPool, np_equal_decisions

    pool = DecisionPool(replicas=1, device=dev)
    reqs = pool.decide_many([("ns", ns[1], ns_conf, None), ("ev", ev[1], ev_conf, None)])
    for r in reqs:
        if r.error is not None:
            raise r.error
    expect([r.batch for r in reqs] == [1, 1] and reqs[0].batch_id != reqs[1].batch_id,
           f"pool split: {[(r.tenant, r.batch, r.batch_id) for r in reqs]}")
    for r, key in zip(reqs, ("ns", "ev")):
        expect(np_equal_decisions(r.decisions, want[key]),
               f"pool split: tenant {r.tenant} decided otherwise than alone")
    print(f"pool split: a north-star (seed {ns[0]}) and an evictive (seed {ev[0]}) pack -> "
          f"{[(r.tenant, r.batch, r.batch_id) for r in reqs]}, decisions equal", flush=True)


def pool_scheduler_legs(dev, smi) -> dict:
    """Phase 12 (c): the pool behind the port's Scheduler at POOL_TENANT
    (generate_cluster, seeds 100-103).  Returns each leg's row."""
    import threading

    from kube_arbitrator_tpu_torch.cache.sim import generate_cluster
    from kube_arbitrator_tpu_torch.cache.snapshot import set_sticky_buckets
    from kube_arbitrator_tpu_torch.framework import Scheduler, SchedulerConfig, TorchDecider
    from kube_arbitrator_tpu_torch.rpc import DecisionPool, PoolClient, PoolShed, TenantAdmission
    from kube_arbitrator_tpu_torch.utils.metrics import MetricsRegistry

    set_sticky_buckets(True)

    def world(i, running=0.0):
        return generate_cluster(seed=100 + i, running_fraction=running, **POOL_TENANT)

    def bound(sim):
        return {t.uid: t.node_name for j in sim.cluster.jobs.values() for t in j.tasks.values()}

    def independent(n, cycles, running=0.0):
        refs = [world(i, running) for i in range(n)]
        for r in refs:
            Scheduler(r, decider=TorchDecider(dev), arena=True).run(max_cycles=cycles,
                                                                    until_idle=False)
        return [bound(r) for r in refs]

    rows = {}
    # threaded: 2 replicas, 4 tenants on threads, min_fill forcing stacks
    t0 = time.perf_counter()
    pool = DecisionPool(replicas=2, threaded=True, min_fill=4, batch_delay_s=0.25, max_batch=8,
                        device=dev)
    sims = [world(i) for i in range(4)]
    scheds = [Scheduler(s, decider=PoolClient(pool, f"t{i}"), arena=True)
              for i, s in enumerate(sims)]
    errors = []

    def run(sched):
        try:
            sched.run(max_cycles=POOL_CYCLES, until_idle=False)
        except BaseException as err:  # reported below: a thread must not swallow it
            errors.append(repr(err))

    threads = [threading.Thread(target=run, args=(s,)) for s in scheds]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    pool.close()
    expect(not errors, f"pool (c) threaded: tenant loops raised {errors}")
    expect(all(len(s.history) == POOL_CYCLES for s in scheds),
           f"pool (c) threaded: cycles {[len(s.history) for s in scheds]}")
    expect([bound(s) for s in sims] == independent(4, POOL_CYCLES),
           "pool (c) threaded: a pooled tenant's binds differ from its independent run's")
    sizes = [e["batch"] for e in pool.decision_log if e["outcome"] in ("served", "resent")]
    expect(max(sizes) >= 2, f"pool (c) threaded: no launch stacked 2 or more: {sizes}")
    binds = sum(st.binds for s in scheds for st in s.history)
    expect(binds > 0, "pool (c) threaded: nothing bound")
    rows["threaded"] = dict(tenants=4, cycles=POOL_CYCLES, batch_sizes=sizes, binds=binds,
                            modes=[st.upload_mode for st in scheds[0].history],
                            ms=round((time.perf_counter() - t0) * 1e3, 1))
    # a replica killed between cycles (inline): no decision lost, r0
    # re-seeded in full once a tenant
    t0 = time.perf_counter()
    reg = MetricsRegistry()
    pool = DecisionPool(replicas=2, registry=reg, device=dev)
    sims = [world(i, 0.2) for i in range(2)]
    scheds = [Scheduler(s, decider=PoolClient(pool, f"k{i}"), arena=True)
              for i, s in enumerate(sims)]
    for cycle in range(4):
        if cycle == 2:
            pool.kill_replica(0)
        for s in scheds:
            s.run(max_cycles=1, until_idle=False)
    expect([bound(s) for s in sims] == independent(2, 4, 0.2),
           "pool (c) kill: a tenant's binds differ from its independent run's")
    log = [e for e in pool.decision_log if e["outcome"] in ("served", "resent")]
    expect(len(log) == 8 and all(e["epoch"] == e["resident"] for e in log),
           f"pool (c) kill: {len(log)} served cycles of 8, or one decided another epoch: {log}")
    reseeds = {r.id: reg.counter_value("pool_pack_reseeds_total", labels={"replica": r.id})
               for r in pool.replicas}
    expect(reseeds == {"r0": 2.0, "r1": 0.0},
           f"pool (c) kill: re-seeds by replica {reseeds}, not r0 once a tenant")
    rows["kill"] = dict(outcomes=[(e["tenant"], e["replica"], e["outcome"]) for e in log],
                        reseeds=reseeds, ms=round((time.perf_counter() - t0) * 1e3, 1))
    # a partition healed: the stale replica re-seeds in full
    t0 = time.perf_counter()
    pool = DecisionPool(replicas=2, device=dev)
    sched = Scheduler(world(0), decider=PoolClient(pool, "tp"), arena=True)
    sched.run(max_cycles=1, until_idle=False)
    pool.begin_cycle(1)
    pool.partition(1, "tp", cycles=1)
    sched.run(max_cycles=1, until_idle=False)
    expect(pool.log_for("tp")[-1]["replica"] == "r0", "pool (c) partition: served by r1")
    pool.begin_cycle(3)
    expect(not pool.is_partitioned(1, "tp"), "pool (c) partition: not healed")
    pool.partition(0, "tp", cycles=1)
    sched.run(max_cycles=1, until_idle=False)
    last = pool.log_for("tp")[-1]
    expect(last["replica"] == "r1" and last["outcome"] == "resent"
           and last["epoch"] == last["resident"] and sched.decider.last_mode == "full",
           f"pool (c) partition: the healed replica served {last} ({sched.decider.last_mode})")
    rows["partition"] = dict(last=last, ms=round((time.perf_counter() - t0) * 1e3, 1))
    # shedding on a fake clock, then recovery
    t0 = time.perf_counter()
    clock = [0.0]
    adm = TenantAdmission(slo_ms=100.0, budget=0.5, windows=((20.0, 5.0, 1.0),), min_samples=4,
                          now_fn=lambda: clock[0])
    pool = DecisionPool(replicas=1, admission=adm, now_fn=lambda: clock[0], device=dev)
    from kube_arbitrator_tpu_torch.cache.snapshot import build_snapshot

    st = build_snapshot(world(0).cluster).tensors
    conf = SchedulerConfig.default()
    for _ in range(6):
        clock[0] += 1.0
        adm.observe("hot", 500.0)
    try:
        pool.decide("hot", st, conf)
        shed = None
    except PoolShed as err:
        shed = err
    expect(shed is not None and pool.log_for("hot")[-1]["outcome"] == "shed",
           "pool (c) shed: a tenant burning its budget was served")
    dec, _ = pool.decide("cold", st, conf)
    clock[0] += 60.0
    again, _ = pool.decide("hot", st, conf)
    expect(pool.log_for("hot")[-1]["outcome"] == "served" and int(again.bind_count) > 0,
           "pool (c) shed: the tenant did not recover once its burn aged out")
    rows["shed"] = dict(shed=str(shed), recovered=pool.log_for("hot")[-1]["outcome"],
                        ms=round((time.perf_counter() - t0) * 1e3, 1))
    print(f"pool (c) {POOL_TENANT}: {json.dumps(rows)}; {smi[0] if smi else ''}", flush=True)
    return rows


# ---------------------------------------------------------------- phase 13
# The pipelined executor (pipeline/executor.py, Scheduler.run_pipelined)
# and the Scheduler's observability planes (utils/tracing, flightrec,
# timeseries, profiling; obs.py) on the card.

PIPE_CYCLES = 3
# leg (b): the evictive world over a LiveCache; each window's churn
PIPE_B_STEPS = 2
PIPE_CHURN_JOBS = 4
# leg (d): a world small enough for a whole-step trace
PIPE_D = dict(num_nodes=1_000, num_jobs=100, tasks_per_job=20, num_queues=8, seed=42)
# the discard reasons leg (b)'s churn causes: pods deleted, a node
# cordoned, a node's pod capacity shrunk to the pods it holds
PIPE_B_REASONS = ("task_gone", "node_unsched", "capacity_shrunk")
# leg (a)'s quiescent cycles 2-3 write no field's rows in place (cycle 2
# places task_status whole, cycle 3 changes nothing), so K18 need not
# launch; leg (b) runs no priority burst, so preempt need not claim (K6)
PIPE_A_KERNELS = tuple(k for k in SCHED_A_KERNELS if k != "row_scatter")
PIPE_B_KERNELS = tuple(k for k in SCHED_B_KERNELS if k not in ("claim_nodes", "row_scatter"))


def recorded_actuation(sim) -> list:
    """Wrap ``sim``'s columnar actuation so that each call appends
    (sorted (uid, node) binds, sorted evict uids) to the returned list
    (one entry a commit; a sequential cycle and a pipelined step commit
    once)."""
    log: list = []
    apply_b, apply_e = sim.apply_binds_columnar, sim.apply_evicts_columnar

    def binds(col):
        log.append([sorted(zip(col.uids, col.node_names)), None])
        return apply_b(col)

    def evicts(col):
        log[-1][1] = sorted(col.uids)
        return apply_e(col)

    sim.apply_binds_columnar, sim.apply_evicts_columnar = binds, evicts
    return log


def pipeline_equivalence(dev, smi, world, cycles: int, want) -> tuple:
    """Phase 13 (a): ``generate_cluster(**world)`` twice, default conf;
    ``Scheduler(arena=True).run(max_cycles=cycles)`` on one and
    ``.run_pipelined(max_cycles=cycles)`` on the other, nothing between
    the cycles (a quiescent stream).  Every cycle commits the same binds
    and evicts in both, nothing is discarded, the sequential cycle 1
    equals the JAX package's (``want``), and the pipelined run launches
    the scheduler path's kernels (the counts set to 0 just before it).
    Returns (the launches, the row printed)."""
    from kube_arbitrator_tpu_torch.cache.sim import generate_cluster
    from kube_arbitrator_tpu_torch.cache.snapshot import set_sticky_buckets
    from kube_arbitrator_tpu_torch.framework import Scheduler, SchedulerConfig, TorchDecider
    from kube_arbitrator_tpu_torch.ops import kernels
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_ACTIONS, DEFAULT_TIERS

    conf = SchedulerConfig(actions=DEFAULT_ACTIONS, tiers=DEFAULT_TIERS)
    out = {}
    for mode in ("sequential", "pipelined"):
        set_sticky_buckets(True)
        g0 = time.perf_counter()
        sim = generate_cluster(**world)
        gen_s = time.perf_counter() - g0
        log = recorded_actuation(sim)
        sched = recording_scheduler(sim, config=conf, decider=TorchDecider(dev), arena=True)
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        if mode == "sequential":
            recs = []
            run_once = sched.run_once

            def recorded():
                r = run_once()
                recs.append(cycle_record(r))
                return r

            sched.run_once = recorded
            n = sched.run(max_cycles=cycles, until_idle=False)
        else:
            n = sched.run_pipelined(max_cycles=cycles, until_idle=False)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launched = kernels.counts()
        expect(n == cycles and len(log) == cycles,
               f"pipeline (a) {mode}: {n} cycles, {len(log)} commits of {cycles}")
        out[mode] = dict(log=log, hist=list(sched.history), launched=launched, sched=sched,
                         gen_s=gen_s, wall_s=wall_s, recs=recs if mode == "sequential" else None)
    seq, pipe = out["sequential"], out["pipelined"]
    for c in range(cycles):
        expect(seq["log"][c] == pipe["log"][c],
               f"pipeline (a) cycle {c + 1}: the pipelined commit differs from the sequential "
               f"cycle's ({len(pipe['log'][c][0])} / {len(seq['log'][c][0])} binds)")
    expect(seq["recs"][0] == want, f"pipeline (a) cycle 1 differs from the JAX package's "
           f"Scheduler: {seq['recs'][0]} vs {want}")
    ex = pipe["sched"].executor
    expect(ex is not None and not ex.discard_totals,
           f"pipeline (a): a quiescent stream discarded {ex.discard_totals if ex else None}")
    expect_launched(pipe["launched"], PIPE_A_KERNELS, "pipelined path (a)")
    row = dict(world=world, cycles=cycles,
               binds=[len(b) for b, _ in pipe["log"]], evicts=[len(e or ()) for _, e in pipe["log"]],
               sequential_cycle_ms=[round(s.cycle_ms, 1) for s in seq["hist"]],
               pipelined_period_ms=[round(s.cycle_ms, 1) for s in pipe["hist"]],
               pipelined_kernel_ms=[round(s.kernel_ms, 1) for s in pipe["hist"]],
               sequential_wall_s=round(seq["wall_s"], 2), pipelined_wall_s=round(pipe["wall_s"], 2),
               occupancy={k: round(v, 4) for k, v in ex.occupancy().items()},
               stage_ms_total={k: round(v, 1) for k, v in ex.stage_totals.items()},
               last_stage_ms={k: round(v, 1) for k, v in ex.last_stage_ms.items()},
               generate_s=[round(seq["gen_s"], 2), round(pipe["gen_s"], 2)],
               launches={k: v for k, v in pipe["launched"].items() if v})
    print(f"pipeline (a) {json.dumps(row)}; every cycle's commit equal, cycle 1 equal to the JAX "
          f"package's, nothing discarded; {smi[0] if smi else ''}", flush=True)
    return pipe["launched"], row


class PipeChurn:
    """Leg (b)'s ``ingest_fn`` over a LiveCache on a FakeApiServer.  The
    first call of each speculation window waits for the in-flight
    decisions, then writes churn aimed at them to the apiserver: the
    pending pods of ``PIPE_CHURN_JOBS`` jobs the window binds are
    DELETEd, the node with the most binds is cordoned
    (spec.unschedulable) and the next one's pod capacity shrunk to the
    pods it holds; then the watch is drained into the cache (the arena's
    dirty sets and the executor's journal).  Later calls drain the watch.
    Returns the events drained.

    The executor pumps ingest only while the decide is unfinished, and a
    step's decide starts before the previous commit's write-back: on a
    fast card it can finish first, and its window would see no churn.  So
    :meth:`gate` holds each committed window's worker, its result made,
    until this window's churn is written; the epoch after the last
    committed one (``> limit``), which ``close`` discards, is not held."""

    HOLD_S = 600.0

    def __init__(self, api, live):
        self.api, self.live = api, live
        self.sched = None  # the Scheduler whose run_pipelined calls it
        self.limit = 0  # the last epoch seq whose window is churned
        self.windows: set = set()
        self.cordoned: set = set()
        self.deleted: set = set()
        self.shrunk: dict = {}
        self._held: dict = {}  # seq -> (the worker's result, its release)
        self._cv = threading.Condition()

    def gate(self, decide_worker):
        """Wrap ``PipelinedExecutor._decide_worker``: an epoch up to
        ``limit`` of this run posts its result and waits for its churn."""
        def held(ex, ep, st, pack_meta):
            try:
                out = decide_worker(ex, ep, st, pack_meta)
            except BaseException:
                with self._cv:  # the ingest side surfaces the error
                    self._held[ep.seq] = (None, None)
                    self._cv.notify_all()
                raise
            if ex._ingest_fn is self and ep.seq <= self.limit:
                release = threading.Event()
                with self._cv:
                    self._held[ep.seq] = (out, release)
                    self._cv.notify_all()
                release.wait(self.HOLD_S)
            return out
        return held

    def __call__(self) -> int:
        ep = self.sched.executor._inflight
        if ep is not None and ep.seq not in self.windows:
            self.windows.add(ep.seq)
            if ep.seq <= self.limit:
                with self._cv:
                    self._cv.wait_for(lambda: ep.seq in self._held, self.HOLD_S)
                out, release = self._held.get(ep.seq, (None, None))
                if out is None:
                    ep.future.result()  # surfaces the decide's error
                    raise RuntimeError(f"pipeline (b): epoch {ep.seq}'s decide posted "
                                       f"nothing in {self.HOLD_S} s")
                try:
                    self.churn(out[1])
                finally:
                    release.set()
            else:
                self.churn(ep.future.result()[1])
        return self.live.sync()

    def churn(self, binds) -> None:
        by_node: dict = {}
        for node in binds.node_names:
            by_node[node] = by_node.get(node, 0) + 1
        nodes = sorted(by_node, key=lambda n: (-by_node[n], n))
        pods = self.api.list("pods")[0]
        bound = set(binds.uids)
        pending = [p for p in pods if not p["spec"].get("nodeName")
                   and p["metadata"]["uid"] in bound]
        group = lambda p: p["metadata"]["annotations"]["scheduling.k8s.io/group-name"]  # noqa: E731
        jobs = sorted({group(p) for p in pending})[:PIPE_CHURN_JOBS]
        for p in (p for p in pending if group(p) in jobs):
            self.api.delete("pods", "default", p["metadata"]["name"])
            self.deleted.add(p["metadata"]["uid"])
        cordon, shrink = nodes[0], nodes[1]
        for n in self.api.list("nodes")[0]:
            name = n["metadata"]["name"]
            if name == cordon:
                n.setdefault("spec", {})["unschedulable"] = True
                self.api.update("nodes", n)
                self.cordoned.add(name)
            elif name == shrink:
                held = sum(1 for p in pods if p["spec"].get("nodeName") == name
                           and p["status"].get("phase") not in ("Succeeded", "Failed"))
                n["status"]["allocatable"]["pods"] = held
                self.api.update("nodes", n)
                self.shrunk[name] = held


def pipeline_churn(dev, smi, world, steps: int) -> tuple:
    """Phase 13 (b): ``generate_cluster(**world)`` (the evictive world)
    as apiserver objects in a FakeApiServer, scheduled by
    ``Scheduler(LiveCache(api), arena=True)`` through
    ``run_pipelined(max_cycles=steps, ingest_fn=PipeChurn)`` under the
    evictive conf.  Every bind POST of the run is recorded with the
    cordoned nodes at its time.  After each commit the apiserver shows no
    node over capacity (api_invariants), no pod bound twice and no bind
    to a node cordoned before it; the run counts each of
    ``PIPE_B_REASONS`` among its discards and no deleted pod is bound.
    Then backpressure: two steps with ``max_ingest_per_wait=1`` and an
    ``ingest_fn`` that always reports events must block at the cap.
    Returns (the launches of the churned run, the row printed)."""
    from kube_arbitrator_tpu_torch.cache import FakeApiServer, LiveCache
    from kube_arbitrator_tpu_torch.cache.sim import generate_cluster
    from kube_arbitrator_tpu_torch.cache.snapshot import set_sticky_buckets
    from kube_arbitrator_tpu_torch.framework import SchedulerConfig, TorchDecider
    from kube_arbitrator_tpu_torch.ops import kernels
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS
    from kube_arbitrator_tpu_torch.options import options
    from kube_arbitrator_tpu_torch.pipeline import DISCARD_REASONS, PipelinedExecutor
    from kube_arbitrator_tpu_torch.utils.metrics import metrics

    set_sticky_buckets(True)
    t0 = time.perf_counter()
    api = FakeApiServer()
    load_objects(api, cluster_objects(generate_cluster(**world), options().scheduler_name))
    live = LiveCache(api)
    live.sync()
    load_s = time.perf_counter() - t0
    churn = PipeChurn(api, live)
    posts: list = []
    bind_pod = api.bind_pod

    def recorded_bind(namespace, name, node_name):
        posts.append((name, node_name, node_name in churn.cordoned))
        return bind_pod(namespace, name, node_name)

    api.bind_pod = recorded_bind
    sched = recording_scheduler(live, config=SchedulerConfig(actions=EVICT_ACTIONS,
                                                             tiers=DEFAULT_TIERS),
                                decider=TorchDecider(dev), arena=True)
    checks = []
    write_back = sched._write_back

    def checked_write_back(result, **kw):  # after each commit's actuation
        write_back(result, **kw)
        checks.append(api_invariants(api, api.list("pods")[0]))

    sched._write_back = checked_write_back
    churn.sched = sched
    churn.limit = sched._cycle_seq + steps
    discards0 = {r: metrics().counter_value("pipeline_discards_total", labels={"reason": r})
                 for r in DISCARD_REASONS}
    torch.cuda.synchronize()
    kernels.reset_counts()
    decide_worker = PipelinedExecutor._decide_worker
    PipelinedExecutor._decide_worker = churn.gate(decide_worker)
    s0 = time.perf_counter()
    try:
        n = sched.run_pipelined(max_cycles=steps, until_idle=False, ingest_fn=churn)
    finally:
        PipelinedExecutor._decide_worker = decide_worker
    torch.cuda.synchronize()
    run_s = time.perf_counter() - s0
    launched = kernels.counts()
    ex = sched.executor
    occupancy = {k: round(v, 4) for k, v in ex.occupancy().items()}
    periods = [round(s.cycle_ms, 1) for s in sched.history]
    expect(n == steps and len(checks) == steps, f"pipeline (b): {n} steps, {len(checks)} commits")
    counted = {r: metrics().counter_value("pipeline_discards_total", labels={"reason": r})
               - discards0[r] for r in DISCARD_REASONS}
    for r in PIPE_B_REASONS:
        expect(ex.discard_totals.get(r, 0) > 0 and counted[r] == ex.discard_totals[r],
               f"pipeline (b): discard reason {r} counted {counted[r]}, executor "
               f"{ex.discard_totals}")
    names = [p[0] for p in posts]
    expect(len(names) == len(set(names)), "pipeline (b): a pod was bound twice")
    expect(not any(c for _, _, c in posts), "pipeline (b): a bind POST went to a cordoned node")
    expect(not set(names) & churn.deleted, "pipeline (b): a deleted pod was bound")
    expect(len(churn.windows) == steps, f"pipeline (b): churn in {len(churn.windows)} windows")
    expect_launched(launched, PIPE_B_KERNELS, "pipelined live path (b)")

    # backpressure: ingest that always reports events, capped at 1 pump
    b0 = metrics().counter_total("pipeline_backpressure_total")
    bp = PipelinedExecutor(sched, max_ingest_per_wait=1, wait_poll_s=0.001,
                           ingest_fn=lambda: live.sync() or 1)
    try:
        bp.step()
        bp.step()
    finally:
        bp.close()
    fired = metrics().counter_total("pipeline_backpressure_total") - b0
    expect(bp.backpressure_events >= 1 and fired == bp.backpressure_events,
           f"pipeline (b): backpressure at cap 1 fired {bp.backpressure_events} times "
           f"({fired} counted)")
    row = dict(world=world, steps=steps, load_s=round(load_s, 2), run_s=round(run_s, 2),
               discards=dict(ex.discard_totals), bind_posts=len(posts),
               deleted_pods=len(churn.deleted), cordoned=sorted(churn.cordoned),
               shrunk=churn.shrunk, period_ms=periods, invariants=checks,
               backpressure_events=bp.backpressure_events, occupancy=occupancy,
               launches={k: v for k, v in launched.items() if v})
    print(f"pipeline (b) {json.dumps(row)}; no over-commit, no double bind, no bind to a "
          f"cordoned node after every commit; {smi[0] if smi else ''}", flush=True)
    return launched, row


# leg (c): staged runs of the same pack that may take a lost pass again
PROFILE_RETAKES = 5


def obs_planes(dev, smi, world, tmp: str) -> tuple:
    """Phase 13 (c): one evictive cycle of ``generate_cluster(**world)``
    through ``Scheduler(arena=True, flight=FlightRecorder(dump_dir),
    cycle_slo_ms=1.0, timeseries=CycleSampler(...))`` with the tracer on
    (sample rate 1) and the kernel profiler on, ``serve_obs`` on
    127.0.0.1.  Its staged cycle runs under
    ``torch.cuda.set_sync_debug_mode("warn")``: every synchronising CUDA
    call in it must be one of the seam's reads.  Then: the cycle's chrome
    export holds the ``cycle``, Session, arena and ``kernel.<action>``
    spans; ``/debug/kernels`` holds every stage measured with a device
    estimate (device_ms, launches; a pass that lost its records is taken
    again by up to ``PROFILE_RETAKES`` staged runs of the same pack, each
    then counted in every stage's measured count) and ``preempt:phase_a`` with
    ``panel_w``; ``/metrics`` carries the pipeline families (legs (a) and
    (b) ran in this process) and ``/readyz`` answers 200; the SLO breach
    wrote one flight dump whose cycle carries ``action_ms``; the
    decider's ``last_action_rounds`` equal the rounds of the same pack's
    unstaged ``schedule_cycle``.  Returns (the cycle's launches, the row)."""
    import urllib.request
    import warnings

    from kube_arbitrator_tpu_torch import obs
    from kube_arbitrator_tpu_torch.cache.sim import generate_cluster
    from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy, set_sticky_buckets
    from kube_arbitrator_tpu_torch.framework import SchedulerConfig, TorchDecider
    from kube_arbitrator_tpu_torch.framework import decider as decider_mod
    from kube_arbitrator_tpu_torch.ops import kernels
    from kube_arbitrator_tpu_torch.ops.cycle import schedule_cycle
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS
    from kube_arbitrator_tpu_torch.utils.flightrec import FlightRecorder
    from kube_arbitrator_tpu_torch.utils.profiling import profiler
    from kube_arbitrator_tpu_torch.utils.timeseries import CycleSampler
    from kube_arbitrator_tpu_torch.utils.tracing import tracer

    set_sticky_buckets(True)
    sim = generate_cluster(**world)
    flight = FlightRecorder(capacity=8, dump_dir=f"{tmp}/flight")
    sampler = CycleSampler(slo_ms=1.0, flight=flight)
    sched = recording_scheduler(sim, config=SchedulerConfig(actions=EVICT_ACTIONS,
                                                            tiers=DEFAULT_TIERS),
                                decider=TorchDecider(dev), arena=True, flight=flight,
                                cycle_slo_ms=1.0, timeseries=sampler)
    tr, prof = tracer(), profiler()
    tr.enable()
    tr.sample_rate = 1.0
    prof.enable()
    server, _thread, url = obs.serve_obs(host="127.0.0.1", port=0, flight=flight,
                                         status_fn=obs.scheduler_status_fn(sched),
                                         timeseries=sampler)
    staged, caught = decider_mod.schedule_cycle_staged, []

    def audited(*a, **kw):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return staged(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                caught.extend(got)

    try:
        torch.cuda.synchronize()
        kernels.reset_counts()
        decider_mod.schedule_cycle_staged = audited
        try:
            t0 = time.perf_counter()
            result = sched.run_once()
            torch.cuda.synchronize()
            cycle_s = time.perf_counter() - t0
        finally:
            decider_mod.schedule_cycle_staged = staged
        launched = kernels.counts()
        syncs = [f"{w.filename}:{w.lineno}" for w in caught
                 if "called a synchronizing" in str(w.message)]
        expect(syncs and all(f.split(":")[0].endswith(SEAM_FILE) for f in syncs),
               f"obs (c): synchronising calls outside the seam in the staged cycle: "
               f"{sorted(set(syncs))}")
        corr = flight.last()
        expect(corr is not None and corr.corr_id, "obs (c): the cycle left no traced record")
        corr = corr.corr_id
        trace = tr.export_chrome(corr)
        names = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}
        need = {"cycle", "resync", "snapshot", "upload", "decide", "decode", "close", "actuate",
                "arena.rebuild", "arena.diff"} | {f"kernel.{a}" for a in EVICT_ACTIONS} | {
            "kernel.open_session", "kernel.commit"}
        expect(need <= names, f"obs (c): the chrome export lacks {sorted(need - names)}")

        def get(path):
            with urllib.request.urlopen(url + path, timeout=60) as r:
                return r.status, r.read()

        # a profiled pass that lost its records is taken again at the
        # stage's next staged run at the shape: the same pack's staged
        # cycle, at most PROFILE_RETAKES times, until every stage has one
        pack = result.snapshot.tensors
        pack_fields = {f.name: getattr(pack, f.name) for f in dataclasses.fields(pack)}
        stage_names = ("open_session", *EVICT_ACTIONS, "commit")
        retakes = 0
        while retakes < PROFILE_RETAKES and any(
                "launches" not in e for stages in prof.table()["shapes"].values()
                for s, e in stages.items() if s in stage_names):
            staged(from_numpy(pack_fields, dev), DEFAULT_TIERS, EVICT_ACTIONS)
            torch.cuda.synchronize()
            retakes += 1
        code, body = get("/debug/kernels")
        shapes = json.loads(body)["shapes"]
        expect(code == 200 and len(shapes) == 1, f"obs (c): /debug/kernels {code}: {list(shapes)}")
        (key, stages), = shapes.items()
        for s in stage_names:
            e = stages.get(s, {})
            expect(e.get("measured", {}).get("count") == 1 + retakes and e.get("launches", 0) > 0
                   and e.get("device_ms", 0) > 0,
                   f"obs (c): /debug/kernels stage {s} after {retakes} retakes: {e}")
        lost = {s: e["lost_passes"] for s, e in stages.items() if "lost_passes" in e}
        split = stages.get("preempt:phase_a", {}).get("estimate", {})
        expect({"panel_w", "phase_a_full_ms", "phase_a_gated_ms"} <= set(split),
               f"obs (c): /debug/kernels preempt:phase_a {split}")
        code, body = get("/metrics")
        text = body.decode()
        for family in ("pipeline_cycle_period_seconds", "pipeline_stage_busy_seconds",
                       "pipeline_stage_occupancy", "pipeline_discards_total",
                       "pipeline_backpressure_total", "kernel_action_duration_seconds",
                       "flight_anomalies_total"):
            expect(f"kube_arbitrator_tpu_{family}" in text, f"obs (c): /metrics lacks {family}")
        code_ready, _ = get("/readyz")
        expect(code_ready == 200, f"obs (c): /readyz {code_ready}")
        import os

        dumps = sorted(os.listdir(f"{tmp}/flight"))
        expect(len(dumps) == 1 and dumps[0].endswith("slo_breach.json"),
               f"obs (c): flight dumps {dumps}")
        with open(f"{tmp}/flight/{dumps[0]}") as f:
            dumped = json.load(f)["cycles"][-1]
        expect(set(dumped["digests"]["action_ms"]) == {"open_session", *EVICT_ACTIONS, "commit"},
               f"obs (c): the dump's action_ms {dumped['digests']['action_ms']}")
        # the unstaged cycle of the same pack
        decider = sched.decider
        stats: dict = {}
        schedule_cycle(from_numpy(pack_fields, dev), tiers=DEFAULT_TIERS, actions=EVICT_ACTIONS,
                       stats=stats)
        want = {}
        for a in EVICT_ACTIONS:
            want[a] = stats[f"rounds.{a}"]
            for k, suffix in (("rounds_gated", "gated"), ("claim_conflicts", "conflicts")):
                if stats.get(f"{k}.{a}"):
                    want[f"{a}:{suffix}"] = stats[f"{k}.{a}"]
        expect(decider.last_action_rounds == want,
               f"obs (c): staged rounds {decider.last_action_rounds}, unstaged {want}")
    finally:
        server.shutdown()
        server.server_close()
        tr.enable(False)
        prof.enable(False)
    row = dict(world=world, cycle_s=round(cycle_s, 2), spans=len(names), seam_syncs=len(syncs),
               action_ms={k: round(v, 1) for k, v in decider.last_action_ms.items()},
               action_rounds=decider.last_action_rounds,
               kernels={s: dict(measured_ms=round(e["measured"]["mean_ms"], 1),
                                device_ms=round(e["device_ms"], 2), launches=e["launches"],
                                device_share=e.get("device_share"),
                                records_lost=e["estimate"].get("records_lost"))
                        for s, e in stages.items() if "measured" in e},
               spins=[prof.lead_spins, prof.trail_spins],
               phase_a=split, shape=key, flight_dump=dumps[0], lost_passes=lost,
               retakes=retakes)
    print(f"obs (c) {json.dumps(row)}; spans, /debug/kernels, /metrics, /readyz and the flight "
          f"dump hold, staged rounds equal the unstaged cycle's, every sync a seam read; "
          f"{smi[0] if smi else ''}", flush=True)
    return launched, row


def trace_records(path: str) -> tuple:
    """profiled_records' counts from a written Chrome trace: (device
    events, host launch records, K1's device events, spin seen)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    host = sum(1 for e in events if e.get("ph") == "X" and str(e.get("name", "")).startswith(
        ("cudaLaunch", "cuLaunch", "cudaMemset", "cudaMemcpy", "cuMemset", "cuMemcpy")))
    spin = sum(SPIN in str(e.get("name", "")) for e in dev)
    k1 = sum("admit" in str(e.get("name", "")) for e in dev)
    return len(dev) - spin, max(host - spin, 0), k1, spin > 0


def profile_dir_leg(dev, smi, world, tmp: str) -> dict:
    """Phase 13 (d): one pipelined cycle of ``generate_cluster(**world)``
    under ``Scheduler(arena=True, profile_dir=...)``: the step's trace
    file is there and its device events include K1's (trace_records, as
    many as the step launched K1)."""
    import os

    from kube_arbitrator_tpu_torch.cache.sim import generate_cluster
    from kube_arbitrator_tpu_torch.cache.snapshot import set_sticky_buckets
    from kube_arbitrator_tpu_torch.framework import Scheduler, TorchDecider
    from kube_arbitrator_tpu_torch.ops import kernels

    set_sticky_buckets(True)
    sched = Scheduler(generate_cluster(**world), decider=TorchDecider(dev), arena=True,
                      profile_dir=f"{tmp}/profile")
    torch.cuda.synchronize()
    kernels.reset_counts()
    t0 = time.perf_counter()
    sched.run_pipelined(max_cycles=1, until_idle=False)
    step_s = time.perf_counter() - t0
    k1_launched = kernels.counts()["admit_chunk"]
    files = sorted(os.listdir(f"{tmp}/profile"))
    expect(files == ["step-000001.pt.trace.json"], f"profile (d): files {files}")
    path = f"{tmp}/profile/{files[0]}"
    n_dev, n_host, k1, spin = trace_records(path)
    expect(k1_launched > 0 and k1 > 0, f"profile (d): K1 launched {k1_launched}, {k1} K1 events "
           "in the trace")
    row = dict(world=world, step_s=round(step_s, 2), trace_mb=round(os.path.getsize(path) / 2**20, 1),
               device_events=n_dev, host_launch_records=n_host, k1_events=k1,
               k1_launches=k1_launched, spin_seen=spin)
    print(f"profile (d) {json.dumps(row)}; {smi[0] if smi else ''}", flush=True)
    return row


def main(kernels_only: bool = False) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from kube_arbitrator_tpu_torch.cli import decide_world
    from kube_arbitrator_tpu_torch.ops import kernels
    from kube_arbitrator_tpu_torch.ops.cycle import CycleDecisions
    from kube_arbitrator_tpu_torch.ops.kernels import build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()

    # ---- phase 1: kernels against their plain versions
    t0 = time.perf_counter()
    built = build.build_all()
    for k, v in build.BUILD_LOG.items():
        print(f"== ptxas {k}\n{v[1][-2000:]}", file=sys.stderr)
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s", flush=True)
    rows = {}

    def report(r):
        rows[r["name"]] = r
        print(f"kernel {r['name']}: equal to plain; {r['ms']:.4f} ms, device {r['device_us']:.2f} us "
              f"({r['kernels_per_call']} kernels, {r['device_by']}), host {r['host_us']:.1f} us "
              f"(plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.5f} ms by {r['bound_by']}, "
              f"library {r['library_ms']}) at {r['shape']}", flush=True)

    fx = evict_fixture(dev)
    for case in (k1_case, k2_case, k3_case, k4_case, k5_case, k6_case, k7_case, k8_case):
        report(case(dev, fx) if case in (k4_case, k5_case, k6_case, k7_case, k8_case) else case(dev))
    for v in rows["segment_sum"]["variants"]:
        print(f"kernel segment_sum form {json.dumps(v)}", flush=True)
    for v in rows["claim_nodes"]["variants"]:
        print(f"kernel claim_nodes form {json.dumps(v)}", flush=True)
    tfx = turn_fixture(dev)
    report(k9_case(dev, tfx))
    for v in rows["turn_caps"]["variants"]:
        print(f"kernel turn_caps variant {json.dumps(v)}", flush=True)
    report(k10_case(dev, tfx))
    alloc_round = order_inputs(tfx)
    report(k16_case(dev, fx, tfx))
    report(k19_case(dev, fx))
    report(k20_case(dev))
    del fx, tfx
    fx = window_fixture(dev)
    for case in (k13_case, k14_case, k15_case):
        report(case(dev, fx))
    for k in ("round_products", "union_fit", "window_gate"):
        for v in rows[k]["variants"]:
            print(f"kernel {k} case {json.dumps(v)}", flush=True)
    report(k17_case(dev, fx, alloc_round))
    for v in rows["queue_order"]["variants"]:
        print(f"kernel queue_order form {json.dumps(v)}", flush=True)
    del fx
    report(k18_case(dev))
    for v in rows["row_scatter"]["variants"]:
        print(f"kernel row_scatter form {json.dumps(v)}", flush=True)
    fx = pa_fixture(dev)
    for v in k6_pa_forms(dev, fx):
        rows["claim_nodes"]["variants"].append(v)
        print(f"kernel claim_nodes form {json.dumps(v)}", flush=True)
    r, fits, seeds, caps = k11_case(dev, fx)
    report(r)
    report(k12_case(dev, fx, fits, seeds, caps))
    for v in rows["pa_shape"]["variants"]:
        print(f"kernel pa_shape form {json.dumps(v)}", flush=True)
    del fx, fits
    rows["admit_chunk"]["variants"] = k1_path_case(dev)
    print(f"phase 1 (kernels) {time.perf_counter() - t0:.1f} s", flush=True)
    if kernels_only:
        print(smi[0] if smi else "nvidia-smi: no output")
        print(json.dumps({"kernels": list(rows.values())}))
        return 0

    # ---- phase 2: whole-cycle parity, card vs CPU, at a size whose
    # totals stay under 2^24
    t0 = time.perf_counter()
    small = dict(tasks=1000, nodes=100, queues=8, tasks_per_job=50, seed=7,
                 running_fraction=0.2, fit_fraction=1.2)
    gpu = decide_world(device=dev, **small)
    cpu = decide_world(device="cpu", **small)
    st_small = cpu["pack"]
    mem_total = float(st_small.node_alloc[st_small.node_valid][:, 1].double().sum())
    expect(mem_total < 2**24, f"phase 2 memory total {mem_total} MiB is not under 2^24")
    fields = [f.name for f in dataclasses.fields(CycleDecisions)]
    eq = compare(gpu["decisions"], cpu["decisions"], fields)
    expect(all(eq.values()), f"card vs CPU cycle differs: {[f for f, ok in eq.items() if not ok]}")
    print(f"parity 1000x100: all {len(fields)} CycleDecisions fields equal (card vs CPU), "
          f"{len(gpu['binds'])} binds", flush=True)
    for w in EVICT_PARITY:
        gpu = decide_world(device=dev, actions=EVICT_ACTIONS, **w)
        cpu = decide_world(device="cpu", actions=EVICT_ACTIONS, **w)
        eq = compare(gpu["decisions"], cpu["decisions"], fields)
        expect(all(eq.values()),
               f"evictive {w}: card vs CPU differs: {[f for f, ok in eq.items() if not ok]}")
        expect(gpu["rounds"] == cpu["rounds"], f"evictive {w}: rounds {gpu['rounds']} vs {cpu['rounds']}")
        n_ev = int(gpu["decisions"].evict_count)
        expect(n_ev > 0, f"evictive {w}: no evictions")
        print(f"parity evictive {w['tasks']}x{w['nodes']} q{w['queues']} running "
              f"{w['running_fraction']}: all {len(fields)} fields equal (card vs CPU), "
              f"{len(gpu['binds'])} binds, {n_ev} evicts, rounds {gpu['rounds']} "
              f"(card {gpu['cycle_ms']:.0f} ms, CPU {cpu['cycle_ms']:.0f} ms)", flush=True)

    for name, w, stripped in PARITY_SLICE3:
        t1 = time.perf_counter()
        gpu = decide_pack(dev, w, stripped)
        cpu = decide_pack("cpu", w, stripped)
        eq = compare(gpu["decisions"], cpu["decisions"], fields)
        expect(all(eq.values()), f"{name}: card vs CPU differs: {[f for f, ok in eq.items() if not ok]}")
        expect(gpu["rounds"] == cpu["rounds"], f"{name}: rounds {gpu['rounds']} vs {cpu['rounds']}")
        expect(int(gpu["decisions"].bind_count) > 0, f"{name}: no binds")
        print(f"parity {name}: all {len(fields)} fields equal (card vs CPU), "
              f"{int(gpu['decisions'].bind_count)} binds, {int(gpu['decisions'].evict_count)} evicts, "
              f"rounds {gpu['rounds']} ({time.perf_counter() - t1:.1f} s)", flush=True)
    # the opt-in reclaim engines: the soak shape at q = 64 under
    # reclaim_optimistic, and reclaim_action(turn_batch=True) alone
    w = SOAK_Q64
    gpu = decide_world(device=dev, actions=OPT_ACTIONS, **w)
    cpu = decide_world(device="cpu", actions=OPT_ACTIONS, **w)
    eq = compare(gpu["decisions"], cpu["decisions"], fields)
    expect(all(eq.values()), f"soak q64 reclaim_optimistic: card vs CPU differs: "
           f"{[f for f, ok in eq.items() if not ok]}")
    expect(gpu["rounds"] == cpu["rounds"], f"soak q64: counters {gpu['rounds']} vs {cpu['rounds']}")
    expect(int(gpu["decisions"].evict_count) > 0, "soak q64: no evictions")
    print(f"parity soak shape q64 {w['tasks']}x{w['nodes']} {OPT_ACTIONS}: all {len(fields)} "
          f"fields equal (card vs CPU), {int(gpu['decisions'].evict_count)} evicts, counters "
          f"{gpu['rounds']}", flush=True)
    states = {d: reclaim_once(d, w, True) for d in (dev, "cpu")}
    eq = compare_states(states[dev], states["cpu"])
    expect(not eq, f"soak q64 turn_batch=True: card vs CPU differs: {eq}")
    print(f"parity soak shape q64 reclaim_action(turn_batch=True): every AllocState field equal "
          f"(card vs CPU), rounds {states[dev].rounds}, gated {states[dev].rounds_gated}",
          flush=True)
    print(f"phase 2 (parity) {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 3: the main path at full width
    t0 = time.perf_counter()
    counts = peak = None
    by_variant = {}  # world -> launches by variant of K1 and K19
    from kube_arbitrator_tpu_torch.ops import allocate as allocate_mod
    from kube_arbitrator_tpu_torch.ops.kernels.decode_deferred import DecodePlan
    select_turns, selections = allocate_mod.select_turns, [0]
    decode_call, decodes, gates = DecodePlan.__call__, [0], []

    def counting_select(*a, **kw):  # one call per turn selection
        selections[0] += 1
        return select_turns(*a, **kw)

    def strict_decode(self, *a):  # a host read inside the decode raises
        decodes[0] += 1
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = decode_call(self, *a)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        # G, N, gn_p bound, and the flags as this launch read them (read after the cycle)
        gates.append((*self.args[0].shape, self.args[1] is not None, *[f.clone() for f in a]))
        return out

    for i, w in enumerate(WORLDS):
        torch.cuda.synchronize()
        if i == 0:
            kernels.reset_counts()
            torch.cuda.reset_peak_memory_stats()
            allocate_mod.select_turns = counting_select
            DecodePlan.__call__ = strict_decode
        try:
            g = decide_world(device=dev, **FULL, **w)
        finally:
            allocate_mod.select_turns = select_turns
            DecodePlan.__call__ = decode_call
        if i == 0:
            counts = kernels.counts()
            by_variant["allocate"] = kernels.variant_counts()
            peak = torch.cuda.max_memory_allocated()
        c = decide_world(device="cpu", **FULL, **w)
        invariants(g["pack"], g["decisions"], g["binds"])
        eq_int = compare(g["decisions"], c["decisions"], INT_FIELDS)
        expect(all(eq_int.values()),
               f"world {w}: card vs CPU integer decisions differ: {[f for f, ok in eq_int.items() if not ok]}")
        eq_f32 = compare(g["decisions"], c["decisions"], ("node_idle", "queue_alloc", "queue_deserved"))
        expect(g["rounds"] == c["rounds"], f"world {w}: rounds differ {g['rounds']} vs {c['rounds']}")
        stages = {k[3:]: round(v, 1) for k, v in g["stats"].items() if k.startswith("ms.")}
        print(f"full width {FULL['tasks']}x{FULL['nodes']} {w}: {len(g['binds'])} binds "
              f"(dense fallback {g['binds'].overflowed}), rounds {g['rounds']}, card cycle "
              f"{g['cycle_ms']:.1f} ms {stages}, decode {g['decode_ms']:.1f} ms (CPU cycle "
              f"{c['cycle_ms']:.0f} ms); integer decisions equal, f32 {eq_f32}", flush=True)
    print(f"launches on the allocate path (world seed 42): {counts}; peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    for k in ("admit_chunk", "lex_argmin", "decode_deferred", "segment_sum", "queue_order"):
        expect(counts[k] > 0, f"kernel {k} was not launched on the allocate path")
    print(f"K2 on the allocate path (world seed 42): {counts['lex_argmin']} launches over "
          f"{selections[0]} turn selections", flush=True)
    expect(counts["lex_argmin"] == selections[0],
           f"K2: {counts['lex_argmin']} launches over {selections[0]} selections, not one each")
    print(f"K3 on the allocate path (world seed 42): {counts['decode_deferred']} launches over "
          f"{decodes[0]} batched actions, each decode with no host read (sync debug mode "
          f"'error' around the plan's call); (G, N, gn_p bound, any_a, any_p) of each: "
          f"{[(G, N, p, bool(fa), bool(fp)) for G, N, p, fa, fp in gates]}", flush=True)
    expect(counts["decode_deferred"] == decodes[0] > 0,
           f"K3: {counts['decode_deferred']} launches over {decodes[0]} actions, not one each")
    print(f"launches by variant on the allocate path (world seed 42): {by_variant['allocate']}",
          flush=True)
    expect(by_variant["allocate"]["stable_sort"]["count"] > 0,
           "K19's counting segment order was not launched on the allocate path")
    print(f"phase 3 (allocate, full width) {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 4: the evictive cycle at full width, card only
    t0 = time.perf_counter()
    evict_counts = None
    for seed in (42, 43):
        torch.cuda.synchronize()
        if seed == 42:
            kernels.reset_counts()
            torch.cuda.reset_peak_memory_stats()
        g = decide_world(device=dev, actions=EVICT_ACTIONS, seed=seed, **EVICT_FULL)
        if seed == 42:
            evict_counts = kernels.counts()
            by_variant["evictive"] = kernels.variant_counts()
            epeak = torch.cuda.max_memory_allocated()
        dec = g["decisions"]
        invariants(g["pack"], dec, g["binds"])
        evict_invariants(g["pack"], dec)
        bind, ev = dec.bind_mask.cpu().numpy(), dec.evict_mask.cpu().numpy()
        phases = np.bincount(dec.evict_phase.cpu().numpy()[ev], minlength=4).tolist()
        digest = decision_digest(bind, ev)
        stages = {k[3:]: round(v, 1) for k, v in g["stats"].items() if k.startswith("ms.")}
        print(f"evictive full width {EVICT_FULL['tasks']}x{EVICT_FULL['nodes']} seed {seed}: "
              f"{int(bind.sum())} binds, evicts by phase {phases}, digest {digest}, rounds "
              f"{g['rounds']}, card cycle {g['cycle_ms']:.1f} ms {stages}", flush=True)
        expect(phases[1] > 0 and phases[3] > 0, f"seed {seed}: reclaim or preempt evicted nothing")
        if seed == 42:
            want = EVICT_WORLD_42
            got = dict(binds=int(bind.sum()), evicts_by_phase=phases, digest=digest)
            expect(got == want, f"seed 42 differs from the JAX package's decisions: {got} vs {want}")
    print(f"launches on the evictive path (50k x 5k, seed 42): {evict_counts}; peak device "
          f"memory {epeak / 2**30:.2f} GiB", flush=True)
    for k in SLICE2_KERNELS + ("queue_order", "stable_sort"):
        expect(evict_counts[k] > 0, f"kernel {k} was not launched on the evictive path")
    print(f"K5 and K2 on the evictive path (seed 42): seg_scan {evict_counts['seg_scan']} "
          f"{by_variant['evictive']['seg_scan']}, lex_argmin {evict_counts['lex_argmin']}",
          flush=True)
    print(f"launches by variant on the evictive path (seed 42): {by_variant['evictive']}",
          flush=True)
    expect(by_variant["evictive"]["stable_sort"]["tiles"] > 0,
           "K19's tiled sort was not launched on the evictive path")
    print(f"phase 4 (evictive, full width) {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 5: the immediate path at full width — the pod-affinity
    # evictive world and the binpack / spread allocate worlds
    t0 = time.perf_counter()
    pa_counts = order_counts = None
    from kube_arbitrator_tpu_torch.ops import preempt as preempt_mod
    reclaim_pop, fast_turns = preempt_mod._reclaim_pop, [0]

    def counting_pop(*a, **kw):  # one call per _reclaim_fast turn
        fast_turns[0] += 1
        return reclaim_pop(*a, **kw)

    for seed in (42, 43):
        torch.cuda.synchronize()
        if seed == 42:
            kernels.reset_counts()
            preempt_mod._reclaim_pop = counting_pop
        try:
            g = decide_world(device=dev, actions=EVICT_ACTIONS, seed=seed, pod_affinity=True,
                             **EVICT_FULL)
        finally:
            preempt_mod._reclaim_pop = reclaim_pop
        if seed == 42:
            pa_counts = kernels.counts()
            by_variant["pa_evict"] = kernels.variant_counts()
        dec = g["decisions"]
        invariants(g["pack"], dec, g["binds"])
        evict_invariants(g["pack"], dec)
        pa_ok = pa_invariants(g["pack"], dec, seed)
        bind, ev = dec.bind_mask.cpu().numpy(), dec.evict_mask.cpu().numpy()
        phases = np.bincount(dec.evict_phase.cpu().numpy()[ev], minlength=4).tolist()
        digest = decision_digest(bind, ev)
        c = decide_world(device="cpu", actions=EVICT_ACTIONS, seed=seed, pod_affinity=True,
                         **PA_CPU_CHECK)
        gs = decide_world(device=dev, actions=EVICT_ACTIONS, seed=seed, pod_affinity=True,
                          **PA_CPU_CHECK)
        eq_int = compare(gs["decisions"], c["decisions"], INT_FIELDS)
        expect(all(eq_int.values()), f"pa world {PA_CPU_CHECK['tasks']} seed {seed}: card vs CPU "
               f"integer decisions differ: {[f for f, ok in eq_int.items() if not ok]}")
        stages = {k[3:]: round(v, 1) for k, v in g["stats"].items() if k.startswith("ms.")}
        print(f"pod-affinity full width {EVICT_FULL['tasks']}x{EVICT_FULL['nodes']} seed {seed}: "
              f"{int(bind.sum())} binds, evicts by phase {phases}, digest {digest}, rounds "
              f"{g['rounds']}, card cycle {g['cycle_ms']:.1f} ms {stages}; {pa_ok}; card == CPU on "
              f"the integer fields at {PA_CPU_CHECK['tasks']}x{PA_CPU_CHECK['nodes']}", flush=True)
        expect(phases[1] > 0 and phases[3] > 0, f"pa seed {seed}: reclaim or preempt evicted nothing")
        if seed == 42:
            got = dict(binds=int(bind.sum()), evicts_by_phase=phases, digest=digest)
            expect(got == PA_WORLD_42, f"pa seed 42 differs from the JAX package: {got} vs {PA_WORLD_42}")
    for seed, policy in ((42, "binpack"), (43, "spread")):
        torch.cuda.synchronize()
        if seed == 42:
            kernels.reset_counts()
        g = decide_world(device=dev, node_order=policy, seed=seed, **FULL)
        if seed == 42:
            order_counts = kernels.counts()
            by_variant["binpack"] = kernels.variant_counts()
        c = decide_world(device="cpu", node_order=policy, seed=seed, **FULL)
        invariants(g["pack"], g["decisions"], g["binds"])
        eq_int = compare(g["decisions"], c["decisions"], INT_FIELDS)
        expect(all(eq_int.values()), f"{policy} seed {seed}: card vs CPU integer decisions differ: "
               f"{[f for f, ok in eq_int.items() if not ok]}")
        bind = g["decisions"].bind_mask.cpu().numpy()
        digest = decision_digest(bind, g["decisions"].evict_mask.cpu().numpy())
        stages = {k[3:]: round(v, 1) for k, v in g["stats"].items() if k.startswith("ms.")}
        print(f"{policy} full width {FULL['tasks']}x{FULL['nodes']} seed {seed}: {int(bind.sum())} "
              f"binds, digest {digest}, rounds {g['rounds']}, card cycle {g['cycle_ms']:.1f} ms "
              f"{stages} (CPU cycle {c['cycle_ms']:.0f} ms); integer decisions equal", flush=True)
        if seed == 42:
            got = dict(binds=int(bind.sum()), digest=digest)
            expect(got == BINPACK_WORLD_42, f"binpack seed 42 differs from the JAX package: "
                   f"{got} vs {BINPACK_WORLD_42}")
    # the repaired gap: binpack past K9's one-CTA sort, card == CPU
    torch.cuda.synchronize()
    kernels.reset_counts()
    g = decide_world(device=dev, node_order="binpack", seed=42, **WIDE_BINPACK)
    wide_variants = kernels.variant_counts()["turn_caps"]
    c = decide_world(device="cpu", node_order="binpack", seed=42, **WIDE_BINPACK)
    invariants(g["pack"], g["decisions"], g["binds"])
    eq_int = compare(g["decisions"], c["decisions"], INT_FIELDS)
    expect(all(eq_int.values()), f"binpack at {WIDE_BINPACK['nodes']} nodes: card vs CPU integer "
           f"decisions differ: {[f for f, ok in eq_int.items() if not ok]}")
    expect(wide_variants["tiles"] > 0 and wide_variants["one_cta"] == 0,
           f"binpack at N = {g['pack'].num_nodes}: K9 variants {wide_variants}")
    print(f"binpack {WIDE_BINPACK['tasks']}x{WIDE_BINPACK['nodes']} (N = {g['pack'].num_nodes}) "
          f"seed 42: {int(g['decisions'].bind_count)} binds, rounds {g['rounds']}, card cycle "
          f"{g['cycle_ms']:.1f} ms (CPU cycle {c['cycle_ms']:.0f} ms); integer decisions equal; "
          f"K9 by variant {wide_variants}", flush=True)
    print(f"launches on the pod-affinity path (50k x 5k, seed 42): {pa_counts}; "
          f"_reclaim_fast turns {fast_turns[0]}", flush=True)
    print(f"launches on the binpack path (100k x 10k, seed 42): {order_counts}", flush=True)
    print(f"K5 and K2 on the pod-affinity path (seed 42): seg_scan {pa_counts['seg_scan']} "
          f"{by_variant['pa_evict']['seg_scan']}, lex_argmin {pa_counts['lex_argmin']}; on the "
          f"binpack path: lex_argmin {order_counts['lex_argmin']}", flush=True)
    print(f"launches by variant on the pod-affinity path (seed 42): {by_variant['pa_evict']}",
          flush=True)
    expect(by_variant["pa_evict"]["stable_sort"]["tiles"] > 0,
           "K19's tiled sort was not launched on the pod-affinity path")
    for k in ("pa_fit", "pa_shape", "turn_caps", "turn_fill", "claim_nodes", "seg_scan",
              "segment_sum", "lex_argmin", "queue_order", "stable_sort", "ordered_scan"):
        expect(pa_counts[k] > 0, f"kernel {k} was not launched on the pod-affinity path")
    # one cumulative a turn for the covering prefix, and one for
    # proportion's victim check when proportion is a reclaim verdict
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS as tiers
    per_turn = 1 + ("proportion" in preempt_mod._reclaim_verdict_names(tiers))
    expect(pa_counts["ordered_scan"] == per_turn * fast_turns[0],
           f"K20 launched {pa_counts['ordered_scan']} times over {fast_turns[0]} _reclaim_fast "
           f"turns, not {per_turn} a turn")
    for k in ("turn_caps", "turn_fill", "lex_argmin", "queue_order"):
        expect(order_counts[k] > 0, f"kernel {k} was not launched on the binpack path")
    print(f"launches by variant on the binpack path (seed 42): {by_variant['binpack']}", flush=True)
    expect(by_variant["binpack"]["turn_caps"]["one_cta"] > 0,
           "K9's one-CTA sort was not launched on the binpack path")
    expect(by_variant["pa_evict"]["turn_caps"]["first_fit"] > 0,
           "K9's first-fit pass was not launched on the pod-affinity path")
    for world in ("binpack", "pa_evict"):
        tf = by_variant[world]["turn_fill"]
        expect(tf["by_group"] == (order_counts if world == "binpack" else pa_counts)["turn_fill"]
               and tf["walk"] == 0 and tf["index"] > 0,
               f"K10 on the {world} path: routes {tf}, not by_group for every turn")
    print(f"phase 5 (immediate path, full width) {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 6: the opt-in reclaim engines at full width — q512_evict
    # (seeds 42, 43) and rounds_q4 (seed 42)
    t0 = time.perf_counter()
    opt_counts = None
    engine_rows = []
    for name, w, seeds, pins in (("q512_evict", Q512_EVICT, (42, 43), Q512_WORLD_42),
                                 ("rounds_q4", ROUNDS_Q4, (42,), ROUNDS_Q4_WORLD_42)):
        for seed in seeds:
            row = engines_once(dev, dict(w, seed=seed), count_syncs=seed == 42)
            engine_rows.append(dict(world=name, seed=seed, **row))
            print(f"{name} seed {seed}: the three reclaim engines from one state: "
                  f"{json.dumps(row)}", flush=True)
            torch.cuda.synchronize()
            if opt_counts is None:
                kernels.reset_counts()
                g = decide_world(device=dev, actions=OPT_ACTIONS, seed=seed, **w)
                opt_counts = kernels.counts()
                print(f"{name} seed {seed}: queue orders (K17 launches) in the cycle: "
                      f"{opt_counts['queue_order']}", flush=True)
            else:
                g = decide_world(device=dev, actions=OPT_ACTIONS, seed=seed, **w)
            dec = g["decisions"]
            invariants(g["pack"], dec, g["binds"])
            evict_invariants(g["pack"], dec)
            bind, ev = dec.bind_mask.cpu().numpy(), dec.evict_mask.cpu().numpy()
            phases = np.bincount(dec.evict_phase.cpu().numpy()[ev], minlength=4).tolist()
            digest = decision_digest(bind, ev)
            counters = [g["stats"][f"{k}.reclaim_optimistic"]
                        for k in ("rounds", "rounds_gated", "claim_conflicts")]
            stages = {k[3:]: round(v, 1) for k, v in g["stats"].items() if k.startswith("ms.")}
            print(f"{name} full width {w['tasks']}x{w['nodes']} q{w['queues']} seed {seed} "
                  f"{OPT_ACTIONS}: {int(bind.sum())} binds, evicts by phase {phases}, digest "
                  f"{digest}, reclaim (rounds, gated, conflicts) {counters}, rounds {g['rounds']}, "
                  f"card cycle {g['cycle_ms']:.1f} ms {stages}", flush=True)
            expect(phases[3] > 0 and counters[2] > 0,
                   f"{name} seed {seed}: reclaim evicted nothing or no conflict")
            expect(counters == row["counters"]["optimistic"],
                   f"{name} seed {seed}: the cycle's reclaim counters differ from the engine's")
            if seed == 42:
                got = dict(binds=int(bind.sum()), evicts_by_phase=phases, digest=digest,
                           reclaim_counters=counters)
                expect(got == pins, f"{name} seed 42 differs from the JAX package: {got} vs {pins}")
        cw = Q512_CPU_CHECK if name == "q512_evict" else w
        gs = decide_world(device=dev, actions=OPT_ACTIONS, seed=42, **cw)
        c = decide_world(device="cpu", actions=OPT_ACTIONS, seed=42, **cw)
        eq_int = compare(gs["decisions"], c["decisions"], INT_FIELDS)
        expect(all(eq_int.values()), f"{name} at {cw['tasks']}x{cw['nodes']}: card vs CPU "
               f"integer decisions differ: {[f for f, ok in eq_int.items() if not ok]}")
        expect(gs["rounds"] == c["rounds"], f"{name}: counters {gs['rounds']} vs {c['rounds']}")
        print(f"{name} card == CPU on the integer fields and counters at {cw['tasks']}x{cw['nodes']} "
              f"q{cw['queues']} seed 42 (card {gs['cycle_ms']:.0f} ms, CPU {c['cycle_ms']:.0f} ms)",
              flush=True)
    print(f"launches on the optimistic reclaim path (q512_evict, seed 42): {opt_counts}", flush=True)
    win = optimistic_window(dev)
    print(f"optimistic reclaim action (q512_evict, seed 42) under the profiler: {json.dumps(win)}",
          flush=True)
    expect(win["casts"] == 0, f"_reclaim_canon_optimistic casts in its own frame: {win}")
    expect(all(n == win["windows"] > 0 for n in win["launches"].values()),
           f"K14 / K15 / K8 not launched once a window: {win}")
    print(f"K5 and K2 on the optimistic reclaim path (q512_evict, seed 42): seg_scan "
          f"{opt_counts['seg_scan']}, lex_argmin {opt_counts['lex_argmin']}", flush=True)
    for k in ("round_products", "union_fit", "window_gate", "stable_compact", "canon_commit",
              "lex_argmin", "segment_sum", "queue_order"):
        expect(opt_counts[k] > 0, f"kernel {k} was not launched on the optimistic reclaim path")
    print(f"phase 6 (opt-in reclaim engines, full width) {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- phase 7: the serving path at full width — the evictive world
    # (seed 42) served for SERVE_EPOCHS epochs through the TorchDecider
    t0 = time.perf_counter()
    from kube_arbitrator_tpu_torch.cache.snapshot import from_numpy
    from kube_arbitrator_tpu_torch.framework import SchedulerConfig, TorchDecider
    from kube_arbitrator_tpu_torch.ops.cycle import schedule_cycle
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_TIERS

    conf = SchedulerConfig(actions=EVICT_ACTIONS, tiers=DEFAULT_TIERS)
    serve_counts = dict.fromkeys(kernels.counts(), 0)
    decider = TorchDecider(dev)
    full_bytes = None
    staging = []  # K18's staging (bytes, pinned and device pointers) after each epoch
    for e, host, meta in serve_epochs(EVICT_FULL, 42, SERVE_EPOCHS):
        torch.cuda.synchronize()
        kernels.reset_counts()
        dec, decide_ms = decider.decide(host, conf, meta)
        plan = decider.resident.plan
        staging.append((plan.cap, plan.pinned.data_ptr() if plan.cap else 0,
                        plan.staging.data_ptr() if plan.cap else 0))
        c = kernels.counts()
        for k, v in c.items():
            serve_counts[k] += v
        row = dict(epoch=e, mode=decider.last_mode, upload_bytes=decider.last_upload_bytes,
                   upload_ms=decider.last_upload_ms, decide_ms=decide_ms,
                   cycle_ms=decider.last_cycle_ms, k18_launches=c["row_scatter"],
                   k17_launches=c["queue_order"], changed_fields=len(meta.changed_fields),
                   binds=int(dec.bind_mask.sum()), evicts=int(dec.evict_mask.sum()))
        diff = decider.resident.first_difference(host)
        expect(diff is None, f"serving epoch {e}: the resident {diff} differs from the host pack")
        fresh = schedule_cycle(from_numpy(host, dev), tiers=DEFAULT_TIERS, actions=EVICT_ACTIONS)
        bad = differing(dec, fresh)
        expect(not bad, f"serving epoch {e}: decisions differ from a fresh upload's in {bad}")
        again, _ = decider.decide(host, conf, meta)
        expect(decider.last_mode == "reuse" and decider.last_upload_bytes == 0,
               f"serving epoch {e}: a repeated key gave {decider.last_mode}, "
               f"{decider.last_upload_bytes} bytes")
        expect(not differing(dec, again), f"serving epoch {e}: the reused pack decides otherwise")
        if e == 1:
            expect(row["mode"] == "full", f"serving epoch 1 uploaded {row['mode']}")
            full_bytes = row["upload_bytes"]
            phases = np.bincount(dec.evict_phase[dec.evict_mask], minlength=4).tolist()
            got = dict(binds=row["binds"], evicts_by_phase=phases,
                       digest=decision_digest(dec.bind_mask, dec.evict_mask))
            expect(got == EVICT_WORLD_42, f"serving epoch 1 differs from the JAX package: {got} "
                   f"vs {EVICT_WORLD_42}")
        else:
            expect(row["mode"] == "delta", f"serving epoch {e} uploaded {row['mode']}")
            expect(row["upload_bytes"] < full_bytes,
                   f"serving epoch {e}: {row['upload_bytes']} bytes, not fewer than {full_bytes}")
            expect(row["k18_launches"] > 0, f"serving epoch {e}: K18 was not launched")
        print(f"serving 50k x 5k seed 42 epoch {json.dumps(row)}; resident == host, decisions == "
              f"a fresh upload's, a repeated key reuses", flush=True)
    for k in SLICE2_KERNELS + ("queue_order", "row_scatter"):
        expect(serve_counts[k] > 0, f"kernel {k} was not launched on the serving path")
    grew = [e + 1 for e in range(1, len(staging)) if staging[e] != staging[e - 1]]
    print(f"K18's staging after each epoch (bytes): {[c[0] for c in staging]}; reallocated at "
          f"epochs {grew}", flush=True)
    expect(all(staging[e][0] > staging[e - 1][0] for e in range(1, len(staging))
               if staging[e] != staging[e - 1]),
           f"K18's staging was reallocated without growing: {staging}")
    print(f"launches on the serving path (50k x 5k, seed 42, {SERVE_EPOCHS} epochs): {serve_counts}",
          flush=True)
    gpu_d, cpu_d = TorchDecider(dev), TorchDecider("cpu")
    for e, host, meta in serve_epochs(SERVE_CPU_CHECK, 42, SERVE_EPOCHS):
        a, _ = gpu_d.decide(host, conf, meta)
        b, _ = cpu_d.decide(host, conf, meta)
        bad = differing(a, b)
        expect(not bad and gpu_d.last_mode == cpu_d.last_mode,
               f"serving {SERVE_CPU_CHECK['tasks']} epoch {e}: card vs CPU differ in {bad} "
               f"({gpu_d.last_mode} / {cpu_d.last_mode})")
        print(f"serving {SERVE_CPU_CHECK['tasks']}x{SERVE_CPU_CHECK['nodes']} epoch {e}: card == CPU in "
              f"every field ({gpu_d.last_mode}, {gpu_d.last_upload_bytes} bytes; card cycle "
              f"{gpu_d.last_cycle_ms:.1f} ms, CPU {cpu_d.last_cycle_ms:.0f} ms)", flush=True)
    print(f"phase 7 (serving path, full width) {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 8: the evictive cycle under the priority mix at full width
    # — preempt's phase 2 and the gated round on the card
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_counts()
    g = decide_world(device=dev, actions=EVICT_ACTIONS, seed=45, **MIX_FULL)
    mix_counts = kernels.counts()
    dec = g["decisions"]
    invariants(g["pack"], dec, g["binds"])
    evict_invariants(g["pack"], dec)
    bind, ev = dec.bind_mask.cpu().numpy(), dec.evict_mask.cpu().numpy()
    phases = np.bincount(dec.evict_phase.cpu().numpy()[ev], minlength=4).tolist()
    digest = decision_digest(bind, ev)
    stages = {k[3:]: round(v, 1) for k, v in g["stats"].items() if k.startswith("ms.")}
    gated = g["stats"]["rounds_gated.preempt"]
    print(f"priority-mix full width {MIX_FULL['tasks']}x{MIX_FULL['nodes']} q{MIX_FULL['queues']} "
          f"seed 45: {int(bind.sum())} binds, evicts by phase {phases}, digest {digest}, rounds "
          f"{g['rounds']}, card cycle {g['cycle_ms']:.1f} ms {stages}", flush=True)
    expect(phases[1] > 0 and phases[2] > 0 and phases[3] > 0,
           f"priority-mix world: a phase evicted nothing: {phases}")
    expect(gated > 0, "priority-mix world: preempt gated no round")
    got = dict(binds=int(bind.sum()), evicts_by_phase=phases, digest=digest)
    expect(got == MIX_WORLD_45, f"priority-mix seed 45 differs from the JAX package: {got} vs "
           f"{MIX_WORLD_45}")
    print(f"launches on the priority-mix path (50k x 5k, seed 45): {mix_counts}", flush=True)
    for k in SLICE2_KERNELS + ("queue_order", "stable_sort", "stable_compact"):
        expect(mix_counts[k] > 0, f"kernel {k} was not launched on the priority-mix path")
    gs = decide_world(device=dev, actions=EVICT_ACTIONS, **MIX_CPU_CHECK)
    c = decide_world(device="cpu", actions=EVICT_ACTIONS, **MIX_CPU_CHECK)
    fields = [f.name for f in dataclasses.fields(CycleDecisions)]
    eq = compare(gs["decisions"], c["decisions"], fields)
    # the standing tolerance of queue_deserved (ROADMAP queue C): rtol 1e-5
    qd = (gs["decisions"].queue_deserved.cpu(), c["decisions"].queue_deserved.cpu())
    qd_close = torch.allclose(qd[0], qd[1], rtol=1e-5, atol=0.0)
    bad = [f for f, ok in eq.items() if not ok and f != "queue_deserved"]
    expect(not bad and qd_close, f"priority-mix {MIX_CPU_CHECK['tasks']}: card vs CPU differ in "
           f"{bad} (queue_deserved within rtol 1e-5: {qd_close})")
    expect(gs["rounds"] == c["rounds"], f"priority-mix: rounds {gs['rounds']} vs {c['rounds']}")
    cph = np.bincount(c["decisions"].evict_phase.numpy()[c["decisions"].evict_mask.numpy()],
                      minlength=4).tolist()
    print(f"priority-mix {MIX_CPU_CHECK['tasks']}x{MIX_CPU_CHECK['nodes']} seed "
          f"{MIX_CPU_CHECK['seed']}: card == CPU in every field (queue_deserved exactly equal: "
          f"{eq['queue_deserved']}), evicts by phase {cph}, rounds {gs['rounds']} (card "
          f"{gs['cycle_ms']:.0f} ms, CPU {c['cycle_ms']:.0f} ms)", flush=True)
    print(f"phase 8 (priority mix, full width) {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 9: no library sort on the evictive paths — the evictive
    # and pod-affinity evictive cycles (50k x 5k, seed 42) under the profiler
    t0 = time.perf_counter()
    from torch.profiler import ProfilerActivity, profile

    for name, kw in (("evictive", {}), ("pa_evict", dict(pod_affinity=True))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            g = decide_world(device=dev, actions=EVICT_ACTIONS, seed=42, **kw, **EVICT_FULL)
            torch.cuda.synchronize()
        ops = dict.fromkeys(("aten::sort", "aten::argsort", "aten::searchsorted", "aten::cummax"), 0)
        for e in prof.key_averages():
            if e.key in ops:
                ops[e.key] = e.count
        dev_ev = [e for e in prof.events()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        n_kern = sum(1 for e in dev_ev if not e.name.startswith(("Memcpy", "Memset")))
        print(f"profiled {name} cycle (50k x 5k, seed 42): {ops}, {n_kern} device kernels "
              f"({len(dev_ev)} device events), profiled cycle {g['cycle_ms']:.1f} ms", flush=True)
        expect(not any(ops.values()), f"the {name} cycle ran a library sort, search or scan: {ops}")
    # one claim turn's tail (_apply_claim) of each cycle, by name: K6 folds
    # the per-node victim aggregates, so no scatter_reduce is left in it
    from kube_arbitrator_tpu_torch.host_profile import claim_turn_events

    for name, pa in (("evictive", False), ("pa_evict", True)):
        ce = claim_turn_events(dict(EVICT_FULL, actions=EVICT_ACTIONS, pod_affinity=pa), seed=42)
        print(f"claim turn {ce['turn']} of {ce['turns']} ({name} 50k x 5k, seed 42): "
              f"{ce['device_events']} device events ({ce['kernels']} kernels), "
              f"{ce['scatter_reduce']} scatter_reduce, launches {ce['launches']}; by name "
              f"{json.dumps(ce['by_name'])}", flush=True)
        expect(ce["scatter_reduce"] == 0, f"a {name} claim turn ran scatter_reduce "
               f"({ce['scatter_reduce']}): the aggregates are K6's")
        expect(ce["launches"].get("claim_nodes") == (2 if pa else 1),
               f"a {name} claim turn launched K6 {ce['launches'].get('claim_nodes')} times")
    walk = canon_walk_casts(dev)
    print(f"canon walk (evictive 50k x 5k, seed 42): {walk['casts']} casts from _reclaim_canon's "
          f"own frame over {walk['k8_launches']} K8 launches", flush=True)
    expect(walk["k8_launches"] > 0 and walk["casts"] == 0,
           f"the canon walk casts its ordinals for K8: {walk}")
    print(f"phase 9 (profiled, no library sort, search or cummax) {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- phase 10: the scheduler loop at full width through the port's own
    # modules: generate_cluster -> Scheduler(arena=True) -> TorchDecider
    t0 = time.perf_counter()
    sched_a, sched_recs_a = scheduler_world(dev, smi, "a", SCHED_A, ("allocate", "backfill"),
                                            SCHED_A_CYCLES, SCHED_CHURN, SCHED_A_42,
                                            SCHED_A_KERNELS)
    sched_b, sched_recs_b = scheduler_world(dev, smi, "b", SCHED_B, EVICT_ACTIONS, SCHED_B_CYCLES,
                                            0.0, SCHED_B_42, SCHED_B_KERNELS, SCHED_B_BURST_AFTER)
    print(f"phase 10 (scheduler loop, full width) {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 11: the live plane — the same Scheduler over a LiveCache
    # fed by an apiserver, under a leader lease
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as lock_dir:
        live_a, live_rows_a = live_world(dev, smi, "a", SCHED_A, ("allocate", "backfill"),
                                         LIVE_CYCLES, SCHED_CHURN, LIVE_A_42, SCHED_A_KERNELS,
                                         lock_dir)
        live_b, live_rows_b = live_world(dev, smi, "b", SCHED_B, EVICT_ACTIONS, LIVE_CYCLES, 0.0,
                                         LIVE_B_42, SCHED_B_KERNELS, lock_dir, SCHED_B_BURST_AFTER)
        # the live cycles decide as phase 10's sim cycles do: the same
        # world, and a kubelet step and burst written to the apiserver
        # that mirror between_cycles
        for name, live_rows, recs in (("a", live_rows_a, sched_recs_a),
                                      ("b", live_rows_b, sched_recs_b)):
            got = [{k: r[k] for k in recs[0]} for r in live_rows]
            expect(got == recs[:len(got)], f"live world ({name}) decided {got}, phase 10's "
                   f"scheduler {recs[:len(got)]}")
        print("live cycles 1-3 of (a) and (b) equal phase 10's sim cycles", flush=True)
        t1 = time.perf_counter()
        fence = fence_leg(dev, LIVE_C, lock_dir)
    print(f"live commit fence {LIVE_C}: {json.dumps(fence)}; A discarded with no apiserver write, "
          f"B bound; {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    rest = rest_leg(dev, LIVE_D)
    print(f"live REST {LIVE_D}: {json.dumps(rest)}; binds equal to the in-process run, server "
          f"shut down; {time.perf_counter() - t1:.1f} s; {smi[0] if smi else ''}", flush=True)
    print(f"phase 11 (live plane, full width) {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 12: the decision pool and its batched launch (B15)
    t0 = time.perf_counter()
    from kube_arbitrator_tpu_torch.framework import SchedulerConfig
    from kube_arbitrator_tpu_torch.ops.ordering import DEFAULT_ACTIONS, DEFAULT_TIERS

    ns_conf = SchedulerConfig(actions=DEFAULT_ACTIONS, tiers=DEFAULT_TIERS)
    ev_conf = SchedulerConfig(actions=EVICT_ACTIONS, tiers=DEFAULT_TIERS)
    ns_tenants = pool_tenants(ns_conf)
    pool_a, ns_alone, pool_row_a = pool_batch(dev, smi, "north-star", ns_tenants, ns_conf,
                                              POOL_A_KERNELS)
    ev_tenants = [(seed, pool_arrays(EVICT_FULL, seed)) for seed in POOL_EVICT_SEEDS]
    pool_b, ev_alone, pool_row_b = pool_batch(dev, smi, "evictive", ev_tenants, ev_conf,
                                              POOL_B_KERNELS)
    dec = ev_alone[42]
    phases = np.bincount(dec.evict_phase[dec.evict_mask], minlength=4).tolist()
    got = dict(binds=int(dec.bind_mask.sum()), evicts_by_phase=phases,
               digest=decision_digest(dec.bind_mask, dec.evict_mask))
    expect(got == EVICT_WORLD_42, f"pool (evictive) seed 42 differs from the JAX package: {got}")
    pool_split(dev, ns_tenants[0], ev_tenants[0], ns_conf, ev_conf,
               dict(ns=ns_alone[ns_tenants[0][0]], ev=ev_alone[ev_tenants[0][0]]))
    del ns_tenants, ev_tenants, ns_alone, ev_alone
    t1 = time.perf_counter()
    pool_scheduler_legs(dev, smi)
    print(f"pool (c) {time.perf_counter() - t1:.1f} s", flush=True)
    print(f"phase 12 (decision pool, B15) {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phase 13: the pipelined executor and the observability planes
    t0 = time.perf_counter()
    pipe_a, _ = pipeline_equivalence(dev, smi, SCHED_A, PIPE_CYCLES, SCHED_A_42)
    t1 = time.perf_counter()
    pipe_b, _ = pipeline_churn(dev, smi, SCHED_B, PIPE_B_STEPS)
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        obs_c, _ = obs_planes(dev, smi, SCHED_B, tmp)
        t3 = time.perf_counter()
        profile_dir_leg(dev, smi, PIPE_D, tmp)
    print(f"phase 13 legs: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) {t3 - t2:.1f} s, "
          f"(d) {time.perf_counter() - t3:.1f} s", flush=True)
    print(f"phase 13 (pipelined executor, observability planes) {time.perf_counter() - t0:.1f} s",
          flush=True)

    replaces = {
        "admit_chunk": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/admit_chunk.cu",
                        "kube_arbitrator_tpu/ops/allocate.py:793"),
        "lex_argmin": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/lex_argmin.cu",
                       "kube_arbitrator_tpu/ops/common.py:49"),
        "decode_deferred": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/decode_deferred.cu",
                            "kube_arbitrator_tpu/ops/allocate.py:1059"),
        "segment_sum": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/segment_sum.cu",
                        "kube_arbitrator_tpu/ops/cycle.py:233"),
        "seg_scan": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/seg_scan.cu",
                     "kube_arbitrator_tpu/ops/preempt.py:129"),
        "claim_nodes": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/claim_nodes.cu",
                        "kube_arbitrator_tpu/ops/preempt.py:439"),
        "canon_pick": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/canon_pick.cu",
                       "kube_arbitrator_tpu/ops/preempt.py:2035"),
        "canon_commit": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/canon_commit.cu",
                         "kube_arbitrator_tpu/ops/preempt.py:2080"),
        "turn_caps": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/turn_caps.cu",
                      "kube_arbitrator_tpu/ops/allocate.py:585"),
        "turn_fill": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/turn_fill.cu",
                      "kube_arbitrator_tpu/ops/allocate.py:645"),
        "pa_fit": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/pa_fit.cu",
                   "kube_arbitrator_tpu/ops/podaffinity.py:73"),
        "pa_shape": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/pa_shape.cu",
                     "kube_arbitrator_tpu/ops/podaffinity.py:173"),
        "round_products": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/round_products.cu",
                           "kube_arbitrator_tpu/ops/preempt.py:2582"),
        "union_fit": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/union_fit.cu",
                      "kube_arbitrator_tpu/ops/preempt.py:2609"),
        "window_gate": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/window_gate.cu",
                        "kube_arbitrator_tpu/ops/preempt.py:2735"),
        "stable_compact": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/stable_compact.cu",
                           "kube_arbitrator_tpu/ops/cycle.py:181"),
        "queue_order": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/queue_order.cu",
                        "kube_arbitrator_tpu/ops/allocate.py:1043"),
        "row_scatter": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/row_scatter.cu",
                        "kube_arbitrator_tpu/cache/arena.py:156"),
        "stable_sort": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/stable_sort.cu",
                        "kube_arbitrator_tpu/ops/preempt.py:118"),
        "ordered_scan": ("kube_arbitrator_tpu_torch/ops/kernels/csrc/ordered_scan.cu",
                         "kube_arbitrator_tpu/ops/common.py:102"),
    }
    paths = dict(allocate=counts, evictive=evict_counts, pa_evict=pa_counts, binpack=order_counts,
                 q512_evict=opt_counts, serving_5_epochs=serve_counts, priority_mix=mix_counts,
                 scheduler_a=sched_a, scheduler_b=sched_b, live_a=live_a, live_b=live_b,
                 pool_north_star=pool_a, pool_evictive=pool_b, pipelined_a=pipe_a,
                 pipelined_live_b=pipe_b, observed_c=obs_c)
    kline = []
    for k, r in rows.items():
        if k in ("admit_chunk", "lex_argmin", "decode_deferred", "segment_sum"):
            n = counts[k]
        elif k in ("turn_caps", "turn_fill"):
            n = order_counts[k]
        elif k in ("pa_fit", "pa_shape"):
            n = pa_counts[k]
        elif k in ("round_products", "union_fit", "window_gate", "stable_compact"):
            n = opt_counts[k]
        elif k in ("queue_order", "row_scatter"):
            n = serve_counts[k]
        elif k == "stable_sort":
            n = evict_counts[k] + pa_counts[k]
        elif k == "ordered_scan":
            n = pa_counts[k]
        else:
            n = evict_counts[k]
        kline.append(dict(name=k, route="cuda", source=replaces[k][0], replaces=replaces[k][1],
                          launches=n, max_abs_err=r["max_abs_err"], ms=r["ms"],
                          plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                          library_ms=r["library_ms"], device_us=r["device_us"],
                          host_us=r["host_us"], variants=r.get("variants", []),
                          variant_launches={w: v[k] for w, v in by_variant.items() if k in v},
                          path_launches={w: c[k] for w, c in paths.items()}))
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({"kernels": kline}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(kernels_only="--kernels-only" in sys.argv[1:]))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
