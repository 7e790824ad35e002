"""A user's kill racing a match cycle's launch, in both packages.

A kill commits through the store, whose event fan-out (under the store's
lock) has the scheduler kill the job's live task on its cluster, which
takes the cluster's kill lock on the write side.  A match cycle launches
holding the read side, and its status report (the launched task
running) takes the store's lock.  In the JAX package the two wait for
each other for ever (ROADMAP Queue C); the port kills at once when no
launch runs and otherwise on a thread once the launch lets go
(`Scheduler._on_event`, `ComputeCluster.safe_kill_task(wait=False)`).

The scenario runs in a fresh interpreter per package, so that the
reference's deadlocked threads end with it: a one-host mock cluster
whose launch is held at a gate; job A running; job B's launch entered
and held; A killed from another thread; the gate opened.  The second
scenario is the same on a `KubeCluster` over `FakeKubeApi`, where the
status report comes through the pod watch's callback.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENARIO = r'''
import importlib, os, sys, threading
pkg = sys.argv[1]
mock = importlib.import_module(pkg + ".cluster.mock")
ent = importlib.import_module(pkg + ".models.entities")
store_mod = importlib.import_module(pkg + ".models.store")
core = importlib.import_module(pkg + ".scheduler.core")
kw = {"device": "cpu"} if pkg == "cook_tpu_torch" else {}

clock = lambda: 1_000_000
store = store_mod.JobStore(clock=clock)
store.set_pool(ent.Pool(name="default"))
gate, entered = threading.Event(), threading.Event()


class HeldLaunch(mock.MockCluster):
    def launch_tasks(self, pool, specs):
        entered.set()
        gate.wait(30)
        return super().launch_tasks(pool, specs)


cluster = HeldLaunch("mock", [mock.MockHost(node_id="h0", hostname="h0",
                                            mem=4000, cpus=8)], clock=clock)
sched = core.Scheduler(store, [cluster], **kw)
pool = store.pools["default"]


def job():
    return ent.Job(uuid=ent.new_uuid(), user="alice", pool="default",
                   priority=50, max_retries=1, command="true",
                   resources=ent.Resources(mem=100.0, cpus=1.0, gpus=0.0))


a, b = job(), job()
store.submit_jobs([a])
gate.set()
sched.rank_cycle(pool)
sched.match_cycle(pool)
assert store.jobs[a.uuid].state.value == "running"
gate.clear()
entered.clear()
store.submit_jobs([b])
sched.rank_cycle(pool)
matcher = threading.Thread(target=sched.match_cycle, args=(pool,),
                           daemon=True)
matcher.start()
assert entered.wait(10)
killer = threading.Thread(target=store.kill_jobs, args=([a.uuid],),
                          daemon=True)
killer.start()
killer.join(0.5)
gate.set()
killer.join(3)
matcher.join(1)
if killer.is_alive() or matcher.is_alive():
    print("deadlocked", flush=True)
    os._exit(0)
# the kill reached the cluster once the launch let go
for _ in range(100):
    if not any(t.startswith("task-" + a.uuid[:8]) for t in cluster.running):
        break
    threading.Event().wait(0.05)
print("killed", store.jobs[a.uuid].state.value,
      store.jobs[b.uuid].state.value,
      sorted(t.split("-")[1] == b.uuid[:8] for t in cluster.running),
      flush=True)
os._exit(0)
'''


@pytest.mark.parametrize("pkg,want", [
    ("cook_tpu_torch", "killed completed running [True]"),
    ("cook_tpu", "deadlocked"),
], ids=["port", "ref"])
def test_kill_during_a_held_launch(pkg, want):
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", SCENARIO, pkg], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == want, proc.stderr[-2000:]


# The same race on the Kubernetes backend: a KubeCluster over each
# package's in-memory FakeKubeApi whose pods start at once (a kubelet with
# nothing to pull), so that creating a pod inside the held launch reports
# it running through the watch callback, which takes the store's lock, as
# the mock cluster's launch does.
K8S_SCENARIO = r'''
import importlib, os, sys, threading
from dataclasses import replace
pkg = sys.argv[1]
k8s = importlib.import_module(pkg + ".cluster.k8s")
ent = importlib.import_module(pkg + ".models.entities")
store_mod = importlib.import_module(pkg + ".models.store")
core = importlib.import_module(pkg + ".scheduler.core")
kw = {"device": "cpu"} if pkg == "cook_tpu_torch" else {}

clock = lambda: 1_000_000
store = store_mod.JobStore(clock=clock)
store.set_pool(ent.Pool(name="default"))
gate, entered = threading.Event(), threading.Event()


class InstantKubelet(k8s.FakeKubeApi):
    def create_pod(self, pod):
        super().create_pod(replace(pod, phase=k8s.PodPhase.RUNNING))


class HeldLaunch(k8s.KubeCluster):
    def launch_tasks(self, pool, specs):
        entered.set()
        gate.wait(30)
        return super().launch_tasks(pool, specs)


api = InstantKubelet([k8s.KubeNode(name="h0", mem=4000, cpus=8)])
cluster = HeldLaunch("k8s", api, clock)
sched = core.Scheduler(store, [cluster], **kw)
pool = store.pools["default"]


def job():
    return ent.Job(uuid=ent.new_uuid(), user="alice", pool="default",
                   priority=50, max_retries=1, command="true",
                   resources=ent.Resources(mem=100.0, cpus=1.0, gpus=0.0))


a, b = job(), job()
store.submit_jobs([a])
gate.set()
sched.rank_cycle(pool)
sched.match_cycle(pool)
assert store.jobs[a.uuid].state.value == "running"
[task_a] = [i.task_id for i in store.job_instances(a.uuid)]
gate.clear()
entered.clear()
store.submit_jobs([b])
sched.rank_cycle(pool)
matcher = threading.Thread(target=sched.match_cycle, args=(pool,),
                           daemon=True)
matcher.start()
assert entered.wait(10)
killer = threading.Thread(target=store.kill_jobs, args=([a.uuid],),
                          daemon=True)
killer.start()
killer.join(0.5)
gate.set()
killer.join(3)
matcher.join(1)
if killer.is_alive() or matcher.is_alive():
    print("deadlocked", flush=True)
    os._exit(0)
# the kill reached the apiserver once the launch let go
for _ in range(100):
    if task_a not in api.pods:
        break
    threading.Event().wait(0.05)
[task_b] = [i.task_id for i in store.job_instances(b.uuid)]
print("killed", store.jobs[a.uuid].state.value,
      store.jobs[b.uuid].state.value, sorted(api.pods) == [task_b],
      flush=True)
os._exit(0)
'''


@pytest.mark.parametrize("pkg,want", [
    ("cook_tpu_torch", "killed completed running True"),
    ("cook_tpu", "deadlocked"),
], ids=["port", "ref"])
def test_kill_during_a_held_k8s_launch(pkg, want):
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", K8S_SCENARIO, pkg],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == want, proc.stderr[-2000:]
