"""The Kubernetes backend of `cook_tpu_torch` (`cluster/k8s.py`) against
`cook_tpu` on the CPU, over each package's in-memory `FakeKubeApi`.

- The 9 cases of tests/test_k8s_cluster.py (synthesized offers, the
  controller's state machine, autoscaling, anti-entropy, failover
  recovery, the whole scheduler on the backend), each on both packages
  (`P` over `ref` / `port`) with the reference's assertions.
- tests/test_sim_k8s.py::test_k8s_trace_replay on both, with run traces
  (per cycle: the jobs placed, on which node, and the pods finished)
  equal across the packages.
- tests/test_monitors.py::TestAutoscaleWiring on both.
- Across the packages: the synthesized offers of one fleet with pods
  (host ports among them) are equal.
- A restarted leader's autoscale against the pods of the one before: the
  reference re-creates `synthetic-1` and its create raises; the port
  skips the names in use (ROADMAP Queue C, reference item 18).
- The anti-entropy scan before the watch has streamed a new pod: the
  reference fails the task as lost; the port waits STARTING_GRACE_MS
  (reference item 22).
"""
from types import SimpleNamespace

import pytest
import torch

from cook_tpu.cluster import base as ref_base
from cook_tpu.cluster import k8s as ref_k8s
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import store as ref_store
from cook_tpu.scheduler import core as ref_core
from cook_tpu.sim import simulator as ref_sim
from cook_tpu_torch.cluster import base as port_base
from cook_tpu_torch.cluster import k8s as port_k8s
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.scheduler import core as port_core
from tests.conftest import FakeClock

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

REF = SimpleNamespace(name="ref", k8s=ref_k8s, base=ref_base, ent=ref_ent,
                      store=ref_store, core=ref_core, kw={})
PORT = SimpleNamespace(name="port", k8s=port_k8s, base=port_base,
                       ent=port_ent, store=port_store, core=port_core,
                       kw={"device": "cpu"})
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])


def make_cluster(P, n_nodes=2, mem=4000.0, cpus=8.0):
    clock = FakeClock()
    api = P.k8s.FakeKubeApi([
        P.k8s.KubeNode(name=f"node{i}", mem=mem, cpus=cpus)
        for i in range(n_nodes)
    ])
    cluster = P.k8s.KubeCluster("k8s", api, clock)
    return clock, api, cluster


def spec(P, task_id, node, mem=100.0, cpus=1.0, **kw):
    return P.base.TaskSpec(task_id=task_id, job_uuid="j", user="u",
                           command="c", mem=mem, cpus=cpus, gpus=0.0,
                           node_id=node, hostname=node, **kw)


def make_job(P, mem=100.0, cpus=1.0, **kw):
    return P.ent.Job(uuid=P.ent.new_uuid(), user="alice", pool="default",
                     priority=50, max_retries=1, command="true",
                     resources=P.ent.Resources(mem=mem, cpus=cpus, gpus=0.0),
                     **kw)


def scheduler_rig(P, nodes):
    clock = FakeClock()
    api = P.k8s.FakeKubeApi(nodes)
    cluster = P.k8s.KubeCluster("k8s", api, clock)
    store = P.store.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="default"))
    scheduler = P.core.Scheduler(store, [cluster], **P.kw)
    return clock, api, cluster, store, scheduler


def recorder(cluster):
    events = []
    cluster.status_callback = lambda t, s, r: events.append((t, s.value, r))
    return events


# ------------------------------------------- tests/test_k8s_cluster.py


@PKGS
def test_synthesized_offers_subtract_consumption(P):
    clock, api, cluster = make_cluster(P)
    offers = {o.node_id: o for o in cluster.pending_offers("default")}
    assert offers["node0"].mem == 4000.0
    cluster.launch_tasks("default", [spec(P, "t1", "node0", mem=1000,
                                          cpus=2)])
    offers = {o.node_id: o for o in cluster.pending_offers("default")}
    assert offers["node0"].mem == 3000.0
    assert offers["node0"].cpus == 6.0
    assert offers["node0"].total_mem == 4000.0
    assert offers["node1"].mem == 4000.0


@PKGS
def test_controller_lifecycle_success(P):
    clock, api, cluster = make_cluster(P)
    events = recorder(cluster)
    cluster.launch_tasks("default", [spec(P, "t1", "node0")])
    assert cluster.expected["t1"] == P.k8s.ExpectedState.STARTING
    api.tick()  # pod starts running
    assert ("t1", "running", None) in events
    assert cluster.expected["t1"] == P.k8s.ExpectedState.RUNNING
    api.finish_pod("t1")
    assert ("t1", "success", "normal-exit") in events
    # terminal pod is deleted
    assert api.pods.get("t1") is None


@PKGS
def test_controller_kill_deletes_pod(P):
    clock, api, cluster = make_cluster(P)
    events = recorder(cluster)
    cluster.launch_tasks("default", [spec(P, "t1", "node0")])
    api.tick()
    cluster.kill_task("t1")
    assert api.pods.get("t1") is None
    assert ("t1", "failed", "killed-by-user") in events


@PKGS
def test_controller_pod_failure_reports_reason(P):
    clock, api, cluster = make_cluster(P)
    events = recorder(cluster)
    cluster.launch_tasks("default", [spec(P, "t1", "node0")])
    api.tick()
    api.finish_pod("t1", failed=True, reason="container-limitation-memory")
    assert ("t1", "failed", "container-limitation-memory") in events


@PKGS
def test_node_loss_is_mea_culpa_failure(P):
    clock, api, cluster = make_cluster(P)
    events = recorder(cluster)
    cluster.launch_tasks("default", [spec(P, "t1", "node0")])
    api.tick()
    api.remove_node("node0")
    assert ("t1", "failed", "node-removed") in events


@PKGS
def test_orphan_pod_killed_by_scan(P):
    clock, api, cluster = make_cluster(P)
    api.create_pod(P.k8s.KubePod(name="orphan", node_name="node0", mem=1,
                                 cpus=1, phase=P.k8s.PodPhase.RUNNING))
    cluster.scan_all()
    assert api.pods.get("orphan") is None


@PKGS
def test_failover_recovery(P):
    # a pod from the previous leader exists BEFORE this leader's cluster
    # object attaches its watches (the real failover ordering:
    # initialize-cluster reconstructs expected state, then starts watches)
    clock = FakeClock()
    api = P.k8s.FakeKubeApi([P.k8s.KubeNode(name="node0", mem=4000,
                                            cpus=8)])
    api.create_pod(P.k8s.KubePod(name="t9", node_name="node0", mem=1,
                                 cpus=1, phase=P.k8s.PodPhase.RUNNING))
    cluster = P.k8s.KubeCluster("k8s", api, clock)
    events = recorder(cluster)
    cluster.determine_expected_state_on_startup({"t9"})
    assert cluster.expected["t9"] == P.k8s.ExpectedState.RUNNING
    api.finish_pod("t9")
    assert ("t9", "success", "normal-exit") in events


@PKGS
def test_autoscale_synthetic_pods_bounded(P):
    clock, api, cluster = make_cluster(P)
    demand = [spec(P, f"p{i}", "", mem=100, cpus=1) for i in range(200)]
    cluster.autoscale("default", demand)
    synth = cluster.synthetic_pods()
    assert len(synth) == 128  # max-pods-outstanding cap
    cluster.autoscale("default", demand)
    assert len(cluster.synthetic_pods()) == 128  # still capped


@PKGS
def test_end_to_end_with_scheduler(P):
    """Full stack on the k8s backend: submit -> match -> pod -> success."""
    clock, api, cluster, store, scheduler = scheduler_rig(
        P, [P.k8s.KubeNode(name="node0", mem=4000, cpus=8)])
    job = make_job(P, mem=100, cpus=1)
    store.submit_jobs([job])
    pool = store.pools["default"]
    scheduler.rank_cycle(pool)
    outcome = scheduler.match_cycle(pool)
    assert len(outcome.matched) == 1
    api.tick()
    assert store.jobs[job.uuid].state == P.ent.JobState.RUNNING
    [task_id] = [i.task_id for i in store.job_instances(job.uuid)]
    api.finish_pod(task_id)
    assert store.jobs[job.uuid].state == P.ent.JobState.COMPLETED


# ------------------------------------------------ tests/test_sim_k8s.py


def k8s_trace_replay(P, trace):
    """tests/test_sim_k8s.py's replay on package P: (the run trace, per
    cycle the (job, node) placements and the pods finished; the store's
    final job states; the task pods left; the live expectations left)."""
    clock, api, cluster, store, scheduler = scheduler_rig(P, [
        P.k8s.KubeNode(name=f"n{i}", mem=64000, cpus=32) for i in range(10)
    ])
    pool = store.pools["default"]
    submitted = 0
    ends: dict[str, int] = {}
    run = []
    for cycle in range(300):
        # pod lifecycle: pending pods start; running pods past their
        # job's runtime finish
        api.tick()
        finished = []
        for pod in list(api.list_pods()):
            if pod.phase == P.k8s.PodPhase.RUNNING:
                end = ends.get(pod.name)
                if end is not None and end <= clock():
                    finished.append(pod.node_name)
                    api.finish_pod(pod.name)
        # submissions
        while (submitted < len(trace)
               and trace[submitted].submit_time_ms <= clock()):
            tj = trace[submitted]
            store.submit_jobs([P.ent.Job(
                uuid=tj.uuid, user=tj.user, pool="default",
                resources=P.ent.Resources(mem=tj.mem, cpus=tj.cpus),
                expected_runtime_ms=tj.runtime_ms, command="sim",
                max_retries=5,
            )])
            submitted += 1
        scheduler.rank_cycle(pool)
        outcome = scheduler.match_cycle(pool)
        placed = []
        for job, offer in outcome.matched:
            [tid] = [i.task_id for i in store.job_instances(job.uuid)
                     if not i.status.terminal]
            ends[tid] = clock() + job.expected_runtime_ms
            placed.append((job.uuid, offer.node_id))
        run.append((cycle, sorted(placed), sorted(finished)))
        clock.advance(15_000)
        if submitted == len(trace) and all(
            store.jobs[j.uuid].state == P.ent.JobState.COMPLETED
            for j in trace
        ):
            break
    states = {j.uuid: store.jobs[j.uuid].state.value for j in trace}
    left = [p.name for p in api.list_pods() if not p.synthetic]
    live_expected = {t for t, s in cluster.expected.items()
                     if s.value in ("starting", "running")}
    return run, states, left, live_expected


def test_k8s_trace_replay_run_traces_equal():
    """The replay on both packages (the reference's assertions on each),
    and the two run traces equal, cycle by cycle."""
    jobs, _ = ref_sim.synth_trace(150, 0, n_users=8, seed=3,
                                  mean_runtime_ms=60_000,
                                  submit_span_ms=120_000)
    trace = sorted(jobs, key=lambda j: (j.submit_time_ms, j.uuid))
    runs = {}
    for P in (REF, PORT):
        run, states, left, live_expected = k8s_trace_replay(P, trace)
        assert set(states.values()) == {"completed"}, (P.name, states)
        # the backend is clean: no task pods left
        assert not left, P.name
        # controller agreed with store throughout: no stranded expectations
        assert not live_expected, P.name
        runs[P.name] = run
    assert sum(len(p) for _, p, _ in runs["port"]) == len(trace)
    assert runs["port"] == runs["ref"]


# --------------------------- tests/test_monitors.py::TestAutoscaleWiring


@PKGS
def test_unmatched_demand_reaches_autoscaler(P):
    clock, api, cluster, store, scheduler = scheduler_rig(
        P, [P.k8s.KubeNode(name="n0", mem=100, cpus=1)])
    # demand far beyond capacity
    store.submit_jobs([make_job(P, mem=5000, cpus=4) for _ in range(3)])
    pool = store.pools["default"]
    scheduler.rank_cycle(pool)
    scheduler.match_cycle(pool)
    synth = cluster.synthetic_pods()
    assert len(synth) == 3
    assert all(p.mem == 5000 for p in synth)


# ------------------------------------------------- across the packages


def _offer_view(offers):
    return sorted(
        (o.node_id, o.hostname, o.mem, o.cpus, o.gpus, o.total_mem,
         o.total_cpus, tuple(o.attributes), tuple(o.ports))
        for o in offers)


def test_synthesized_offers_equal_across_packages():
    """One fleet (labels, a cordoned node, two pools, gpus) with pods in
    every phase, host ports among them, through each package's cluster:
    the offers of each pool are equal, their port ranges (what
    `subtract_ports` leaves) too."""
    views = {}
    for P in (REF, PORT):
        k = P.k8s
        api = k.FakeKubeApi([
            k.KubeNode(name="a", mem=8192, cpus=16, labels=(("rack", "r1"),)),
            k.KubeNode(name="b", mem=8192, cpus=16, gpus=2),
            k.KubeNode(name="c", mem=4096, cpus=8, schedulable=False),
            k.KubeNode(name="d", mem=4096, cpus=8, pool="gpu"),
        ])
        cluster = k.KubeCluster("k", api, FakeClock(),
                                host_port_range=(31000, 31010))
        cluster.launch_tasks("default", [
            spec(P, "t1", "a", mem=1024, cpus=2, ports=(31000, 31004)),
            spec(P, "t2", "a", mem=512, cpus=0.5, ports=(31010,)),
            spec(P, "t3", "b", mem=2048, cpus=4),
            spec(P, "t4", "b", mem=100, cpus=1, ports=(31002,)),
        ])
        api.tick()
        cluster.launch_tasks("gpu", [spec(P, "t5", "d", mem=4000,
                                          cpus=7.5)])
        api.finish_pod("t3")   # done: its resources are free again
        api.create_pod(k.KubePod(name="daemon", node_name="b", mem=64,
                                 cpus=0.25, synthetic=True))
        views[P.name] = {pool: _offer_view(cluster.pending_offers(pool))
                         for pool in ("default", "gpu", "none")}
    assert views["port"] == views["ref"]
    assert [o[0] for o in views["port"]["default"]] == ["a", "b"]
    assert views["port"]["default"][0][-1] == ((31001, 31003),
                                               (31005, 31009))


@pytest.mark.parametrize("P,raises", [(REF, True), (PORT, False)],
                         ids=["ref", "port"])
def test_restarted_leader_autoscale_skips_names_in_use(P, raises):
    """A leader restarted against the same apiserver: its new cluster's
    placeholder counter starts again at 0.  The reference creates
    `synthetic-1` again, which the apiserver refuses (here FakeKubeApi's
    ValueError; over HTTP a 409), and the error leaves `autoscale` (and
    the match cycle that called it); the port takes the next free
    names."""
    clock, api, cluster = make_cluster(P)
    demand = [spec(P, f"p{i}", "", mem=100, cpus=1) for i in range(2)]
    cluster.autoscale("default", demand)
    restarted = P.k8s.KubeCluster("k8s", api, clock)
    if raises:
        with pytest.raises(ValueError, match="synthetic-1"):
            restarted.autoscale("default", demand)
        return
    restarted.autoscale("default", demand)
    assert sorted(p.name for p in restarted.synthetic_pods()) == [
        f"synthetic-{i}" for i in range(1, 5)]


@pytest.mark.parametrize("P,lost_at_once", [(REF, True), (PORT, False)],
                         ids=["ref", "port"])
def test_scan_leaves_a_pod_the_watch_has_not_streamed(P, lost_at_once):
    """The anti-entropy scan right after a launch, before the watch has
    streamed the new pod (`HttpKubeApi.list_pods` answers from the
    watch's view): the reference finds the pod missing and fails the
    task as lost (`could-not-reconstruct-state`, so the job runs again
    on a second pod); the port leaves it to the watch for
    STARTING_GRACE_MS, then judges it (ROADMAP Queue C, reference item
    22)."""

    class LaggingWatch(P.k8s.FakeKubeApi):
        """A watch that has not streamed the `held` pods yet."""

        held = ()

        def _notify(self, name):
            if name not in self.held:
                super()._notify(name)

        def list_pods(self):
            return [p for p in super().list_pods()
                    if p.name not in self.held]

        def deliver(self, name):
            self.held.remove(name)
            super()._notify(name)

    clock = FakeClock()
    api = LaggingWatch([P.k8s.KubeNode(name="node0", mem=4000, cpus=8)])
    cluster = P.k8s.KubeCluster("k8s", api, clock)
    events = recorder(cluster)
    api.held = ["t1", "t2"]
    cluster.launch_tasks("default", [spec(P, "t1", "node0"),
                                     spec(P, "t2", "node0")])
    cluster.scan_all()
    if lost_at_once:
        assert events == [("t1", "failed", "could-not-reconstruct-state"),
                          ("t2", "failed", "could-not-reconstruct-state")]
        return
    assert events == [] and set(cluster.expected) == {"t1", "t2"}
    api.deliver("t1")  # t1 streamed; t2's pod never shows
    api.tick()
    clock.advance(cluster.STARTING_GRACE_MS - 1)
    cluster.scan_all()
    assert events == [("t1", "running", None)]
    clock.advance(1)
    cluster.scan_all()
    assert events == [("t1", "running", None),
                      ("t2", "failed", "could-not-reconstruct-state")]
