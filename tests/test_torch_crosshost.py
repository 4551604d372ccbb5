"""The port's cross-host serve fabric (neutronstarlite_torch/serve/crosshost)
held against the reference's.

The socket-free rig of tests/test_crosshost.py, over the port's router: fake
processes that publish real port files and an in-memory transport that
serves schema-valid /telemetry payloads and /predict answers keyed by each
fake replica's checkpoint (so "which model answered" shows), while the real
router, hub, dispatch and rollout code runs. Its 23 tests: routing over
scraped state, breach and drain, fleet-level shed, re-route on death,
supervised restart, targets mode, the rollout state machine under races,
recipes and tracing.

Beside them: the rollout preflight's verdicts equal the reference tool's on
either package's checkpoints; both routers derive the same route states
from the same payloads; each package's router serves through the other's
exporter over a real local socket; and two real port replica processes
(``--device cpu``) serve a checkpoint the reference trained, their replay
probes bitwise the in-process port engine's and within 1e-5 of the
reference engine's (sync mode), one of them killed and respawned.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import neutronstarlite_tpu.native as jax_native
from neutronstarlite_tpu.obs import registry as j_registry
from neutronstarlite_tpu.serve import crosshost as j_crosshost
from neutronstarlite_tpu.tools import verify_checkpoint as j_vc
from neutronstarlite_tpu.utils import checkpoint as j_ckpt
from neutronstarlite_torch.obs import registry, schema
from neutronstarlite_torch.obs.httpc import HttpRefused
from neutronstarlite_torch.serve import crosshost
from neutronstarlite_torch.serve.batcher import RequestShedError
from neutronstarlite_torch.tools import verify_checkpoint as t_vc
from neutronstarlite_torch.utils import checkpoint as t_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("NTS_TRACE", "NTS_METRICS_DIR", "NTS_TRACE_STEP", "NTS_METRICS_PORT",
              "NTS_FAULT_SPEC", "NTS_SLO_SPEC", "NTS_LEDGER_DIR", "NTS_FLEET_TARGETS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("NTS_SAMPLE_WORKERS", "0")


# ---- rig: fake processes + in-memory transport -----------------------------


class FakeProc:
    _pids = iter(range(50000, 60000))

    def __init__(self, recipe):
        self.recipe = recipe
        self.pid = next(FakeProc._pids)
        self._rc = None

    def poll(self):
        return self._rc

    def terminate(self):
        self._rc = 0

    def kill(self):
        self._rc = -9

    def wait(self, timeout=None):
        return self._rc


class FakeWorld:
    """The process table + network: port -> fake replica process."""

    def __init__(self, schema_mod=schema, mod=crosshost):
        self.schema = schema_mod
        self.mod = mod
        self.ports = {}
        self.next_port = 41000
        self.spawns = 0
        self.fail_next_spawn = False
        self.breaching = set()  # ports reporting a breaching serve SLO
        self.seq = 0
        self.lock = threading.Lock()

    def spawn(self, recipe):
        with self.lock:
            if self.fail_next_spawn:
                self.fail_next_spawn = False
                raise RuntimeError("injected spawn failure")
            self.spawns += 1
            port = self.next_port
            self.next_port += 1
            proc = FakeProc(recipe)
            self.ports[port] = proc
        self.mod._write_port_file(recipe.port_file, {
            "port": port, "pid": proc.pid, "replica": recipe.replica,
        })
        return proc

    def alive(self):
        return [p for p in self.ports.values() if p.poll() is None]

    def proc_at(self, base_url):
        return self.ports.get(int(base_url.rsplit(":", 1)[1]))

    def _record(self, kind, run_id, **fields):
        with self.lock:
            self.seq += 1
            seq = self.seq
        rec = {"event": kind, "ts": time.time(), "run_id": run_id,
               "schema": self.schema.SCHEMA_VERSION, "seq": seq, **fields}
        self.schema.validate_event(rec)  # the fake must speak real schema
        return json.dumps(rec)

    def telemetry(self, port, proc):
        rid = proc.recipe.replica
        lines = [self._record(
            "telemetry", f"{rid}-run", source="serve", replica=rid,
            counters={}, gauges={"serve.queue_depth": 0,
                                 "serve.max_queue": 64},
            health={"ok": True, "serve": {"beating": True}},
        )]
        if port in self.breaching:
            lines.append(self._record(
                "slo_status", f"{rid}-run",
                objective="serve_p99_ms<=5@1m", metric="serve_p99_ms",
                state="breach", threshold=5.0, window_s=60.0, value=50.0,
                burn_rate=10.0, burn_rate_short=10.0, window_count=10,
            ))
        return "\n".join(lines) + "\n"

    def predict(self, port, proc, payload):
        ids = payload["node_ids"]
        tag = float(abs(hash(proc.recipe.ckpt_dir)) % 97)
        return json.dumps({
            "status": "ok", "dtype": "float32",
            "values": [[tag + float(i)] for i in ids],
            "replica": proc.recipe.replica,
        })

    def fetch(self, url, **kw):
        rest = url.split("://", 1)[1]
        hostport, _, path = rest.partition("/")
        port = int(hostport.rsplit(":", 1)[1])
        proc = self.ports.get(port)
        if proc is None or proc.poll() is not None:
            raise HttpRefused(f"nothing listening on {url}")
        if path.startswith("telemetry"):
            return self.telemetry(port, proc)
        if path.startswith("predict"):
            return self.predict(port, proc, json.loads(kw["data"]))
        raise HttpRefused(f"unknown path {url}")


@pytest.fixture()
def world(monkeypatch):
    w = FakeWorld()
    monkeypatch.setattr(crosshost, "_spawn_child", w.spawn)
    monkeypatch.setattr(crosshost.httpc, "fetch", w.fetch)
    yield w


def _mk_fleet(world, tmp_path, n=2, *, polling=False, **kw):
    cfg = tmp_path / "fake.cfg"
    if not cfg.exists():
        cfg.write_text("ALGORITHM:FAKE\n")
    reg = registry.MetricsRegistry(
        "router-none-0", algorithm="ROUTER", fingerprint="f",
        path=str(tmp_path / "router.jsonl"),
    )
    fleet = crosshost.CrossHostFleet.spawn(
        str(cfg), str(tmp_path / "ckpt_v1"), n,
        spawn_dir=str(tmp_path / "spawn"), registry=reg,
        poll_s=0.05, miss_k=2, predict_timeout_s=5.0,
        spawn_timeout_s=5.0, drain_timeout_s=1.0,
        start_polling=polling, device="cpu", **kw,
    )
    return fleet, reg


def _records(reg, tmp_path, kind=None):
    reg.close()
    out = [json.loads(ln) for ln in open(tmp_path / "router.jsonl")
           if ln.strip()]
    return [e for e in out if kind is None or e["event"] == kind]


def _pass_canary(fleet):
    fleet._canary = lambda ckpt: {
        "disagreement": 0.0, "tolerance": 0.05, "seeds": 8,
        "batches": 2, "mirrored": False, "passed": True,
    }


def _pass_preflight(monkeypatch):
    monkeypatch.setattr(t_vc, "preflight_checkpoint", lambda root: (root, 7))


def _tag(ckpt_dir):
    return float(abs(hash(ckpt_dir)) % 97)


# ---- construction + routing over scraped state -----------------------------


def test_spawn_builds_recipes_and_routes(world, tmp_path):
    fleet, reg = _mk_fleet(world, tmp_path, n=3)
    try:
        assert world.spawns == 3
        assert all(r.recipe is not None for r in fleet.replicas)
        assert all(r.recipe.device == "cpu" for r in fleet.replicas)
        states = fleet.route_states()
        assert [s["beating"] for s in states] == [True] * 3
        v = fleet.predict([1, 2, 3])
        assert v.shape == (3, 1) and v.dtype == np.float32
    finally:
        fleet.close()
    assert world.alive() == []  # close reaps every child
    # ... and leaves no port file behind
    assert not [f for f in os.listdir(tmp_path / "spawn") if f.endswith(".json")]


@pytest.mark.parametrize("metric", ["serve_p99_ms", "queue_p95_ms", "epoch_p99_ms", "latency",
                                    "", "serve_p50_ms", "queue_p99.9_ms", "serve_p99"])
def test_metric_sheddable_rule(metric):
    """The reference's rule (its own test's cases first), on every name."""
    assert crosshost._metric_sheddable(metric) == j_crosshost._metric_sheddable(metric)
    if metric in ("serve_p99_ms", "queue_p95_ms"):
        assert crosshost._metric_sheddable(metric)
    if metric in ("epoch_p99_ms", "latency", ""):
        assert not crosshost._metric_sheddable(metric)


def test_route_state_sees_breach_and_drains(world, tmp_path):
    fleet, reg = _mk_fleet(world, tmp_path, n=2)
    try:
        port0 = int(fleet.replicas[0].base_url.rsplit(":", 1)[1])
        world.breaching.add(port0)
        fleet.hub.poll_once()
        s0, s1 = fleet.route_states()
        assert s0["draining"] and s0["burn"] == 10.0
        assert not s1["draining"]
        # routing avoids the breaching replica
        for _ in range(4):
            v = fleet.predict([5])
            assert v[0, 0] == pytest.approx(_tag(fleet.replicas[1].ckpt_dir) + 5.0)
    finally:
        fleet.close()


def test_route_states_equal_the_reference(tmp_path):
    """The same scraped payloads (one replica breaching, one dead) give
    both routers the same route states and the same routing verdict."""
    states = {}
    for name, mod, reg_mod, sch in (
            ("port", crosshost, registry, schema),
            ("jax", j_crosshost, j_registry, __import__(
                "neutronstarlite_tpu.obs.schema", fromlist=["schema"]))):
        w = FakeWorld(schema_mod=sch, mod=mod)
        recipes = [mod.LaunchRecipe(cfg_path="c", ckpt_dir="k", replica=f"r{i}", seed=i,
                                    port_file=str(tmp_path / f"{name}{i}.port"))
                   for i in range(3)]
        for r in recipes:
            w.spawn(r)
        ports = sorted(w.ports)
        w.breaching.add(ports[1])
        reg = reg_mod.MetricsRegistry(f"router-{name}", algorithm="ROUTER",
                                      fingerprint="f", path=str(tmp_path / f"{name}.jsonl"))
        fleet = mod.CrossHostFleet.from_targets(
            [f"127.0.0.1:{p}" for p in ports], registry=reg, poll_s=0.05, miss_k=1,
            start_polling=False, fetch=w.fetch)
        try:
            w.ports[ports[2]].kill()
            fleet.hub.poll_once()
            states[name] = (fleet.route_states(), fleet._route(fleet.route_states()),
                            [t.lost for t in fleet.hub.targets])
        finally:
            fleet.close()
            reg.close()
    assert states["port"] == states["jax"]
    assert states["port"][1][0] == 0 and states["port"][2] == [False, False, True]


def test_fleet_breach_sheds_only_when_all_live_breach(world, tmp_path):
    fleet, reg = _mk_fleet(world, tmp_path, n=2)
    try:
        for r in fleet.replicas:
            world.breaching.add(int(r.base_url.rsplit(":", 1)[1]))
        fleet.hub.poll_once()
        req = fleet.submit([1])
        with pytest.raises(RequestShedError, match="fleet_breach"):
            req.result(timeout=5.0)
    finally:
        fleet.close()
    events = _records(reg, tmp_path, "shed")
    assert len(events) == 1 and "fleet_breach" in events[0]["reason"]


def test_replica_death_reroutes_owed_requests(world, tmp_path):
    """A dead replica's requests re-route to survivors: zero sheds."""
    fleet, reg = _mk_fleet(world, tmp_path, n=2)
    try:
        for _ in range(3):  # prime sticky routing onto r0, then kill it
            fleet.predict([1])
        world.proc_at(fleet.replicas[0].base_url).kill()
        results = [fleet.submit([i]) for i in range(8)]
        vals = [r.result(timeout=10.0) for r in results]
        assert all(v is not None for v in vals)
        assert fleet.stats()["shed"] == 0
    finally:
        fleet.close()


def test_submit_after_close_sheds_and_close_is_idempotent(world, tmp_path):
    fleet, reg = _mk_fleet(world, tmp_path, n=2)
    fleet.close()
    req = fleet.submit([1])
    with pytest.raises(RequestShedError):
        req.result(timeout=2.0)
    assert fleet.close() is not None  # second close: no-op, still answers
    assert world.alive() == []


# ---- supervised restart ----------------------------------------------------


def test_miss_k_escalates_to_supervised_restart(world, tmp_path):
    fleet, reg = _mk_fleet(world, tmp_path, n=2, polling=True)
    try:
        victim = fleet.replicas[0]
        old_url = victim.base_url
        world.proc_at(old_url).kill()
        deadline = time.monotonic() + 10.0
        while victim.restarts == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert victim.restarts == 1 and victim.restart_s is not None
        assert victim.base_url != old_url  # re-pointed at the new port
        assert world.proc_at(victim.base_url).poll() is None
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if not fleet.hub.targets[0].lost:
                break
            time.sleep(0.05)
        assert fleet.predict([2]) is not None  # the respawned replica answers
    finally:
        fleet.close()
    events = _records(reg, tmp_path)
    losses = [e for e in events if e["event"] == "target_loss"]
    restarts = [e for e in events if e["event"] == "recovery"
                and e["action"] == "restart"]
    assert len(losses) == 1  # one typed loss per death (latched)
    assert len(restarts) == 1 and restarts[0]["replica"] == "r0"
    assert restarts[0]["seconds"] > 0


def test_targets_mode_has_no_recipe_no_restart(world, tmp_path):
    for i in range(2):  # two already-running "processes"
        world.spawn(crosshost.LaunchRecipe(
            cfg_path="c", ckpt_dir="k", replica=f"r{i}",
            seed=i, port_file=str(tmp_path / f"t{i}.port"),
        ))
    ports = sorted(world.ports)
    reg = registry.MetricsRegistry(
        "router-none-0", algorithm="ROUTER", fingerprint="f",
        path=str(tmp_path / "router.jsonl"),
    )
    fleet = crosshost.CrossHostFleet.from_targets(
        [f"127.0.0.1:{p}" for p in ports], registry=reg,
        poll_s=0.05, miss_k=2, start_polling=False,
    )
    try:
        assert all(r.recipe is None for r in fleet.replicas)
        rec = fleet.rollout(str(tmp_path))
        assert rec["verdict"] == "refused"
        assert "recipe" in rec["error"]
        # a death stays a target_loss: no respawn attempted
        world.ports[ports[0]].kill()
        for _ in range(3):
            fleet.hub.poll_once()
        fleet._supervise()
        assert fleet.hub.targets[0].lost
        assert fleet.replicas[0].restarts == 0
        assert world.spawns == 2  # nothing new spawned
    finally:
        fleet.close()
    # from_targets never holds processes: the survivor is left running
    assert world.ports[ports[1]].poll() is None


def test_targets_mode_client_latency_and_the_open_loop_stop(world, tmp_path):
    """serve_bench's load loops over the router: the open loop runs until
    its stop event (or for n requests) and hands back every request; the
    clients' submit -> answer percentiles cover the answered ones only."""
    from neutronstarlite_torch.serve.batcher import ServeRequest
    from neutronstarlite_torch.tools import serve_bench

    fleet, _reg = _mk_fleet(world, tmp_path)
    try:
        stop, done = threading.Event(), []
        timer = threading.Timer(0.3, stop.set)
        timer.start()
        errors = serve_bench.run_open_loop(fleet, 50, 0, 100.0, 1, 0, done=done, stop=stop)
        timer.join()
        assert errors == 0 and 5 <= len(done) <= 60
        bounded = []
        assert serve_bench.run_open_loop(fleet, 50, 7, 500.0, 1, 1, done=bounded) == 0
        assert len(bounded) == 7
        closed = []
        assert serve_bench.run_closed_loop(fleet, 50, 9, 3, 1, 2, done=closed) == 0
        assert len(closed) == 9
    finally:
        fleet.close()
    lat = serve_bench.client_latency_ms(done + bounded + closed)
    want = np.percentile([1e3 * (r.t_done - r.t_submit) for r in done + bounded + closed],
                         [50, 95, 99])
    assert [lat[q] for q in ("p50", "p95", "p99")] == pytest.approx(want.tolist())
    shed = ServeRequest(np.zeros(1, np.int64))
    shed._complete(None, "shed", RequestShedError("full"))
    assert serve_bench.client_latency_ms([shed]) == {"p50": None, "p95": None, "p99": None}


# ---- rollout: preflight + canary gates -------------------------------------


def _corrupt_newest(ckpt):
    arrays = max(
        (os.path.join(r, f) for r, _d, fs in os.walk(ckpt) for f in fs if f == t_ckpt.ARRAYS),
        key=lambda p: int(os.path.basename(os.path.dirname(p)).split("-")[1]),
    )
    size = os.path.getsize(arrays)
    with open(arrays, "r+b") as fh:  # bit-flip a window in the middle
        fh.seek(size // 2)
        window = fh.read(64)
        fh.seek(size // 2)
        fh.write(bytes(b ^ 0xFF for b in window))


def test_corrupt_checkpoint_rollout_refused(world, tmp_path):
    """A digest-corrupt candidate is refused by preflight with ZERO
    replicas restarted."""
    ckpt = tmp_path / "cand"
    t_ckpt.save_checkpoint(str(ckpt), {"params": [{"W": np.arange(8.0)}]}, step=3)
    _corrupt_newest(str(ckpt))
    fleet, reg = _mk_fleet(world, tmp_path, n=2)
    try:
        spawns_before = world.spawns
        rec = fleet.rollout(str(ckpt))
        assert rec["verdict"] == "preflight_reject"
        assert rec["restarted"] == 0 and rec["rolled_back"] == 0
        assert world.spawns == spawns_before  # zero replicas touched
        rec2 = fleet.rollout(str(tmp_path / "nonexistent"))  # a missing one too
        assert rec2["verdict"] == "preflight_reject"
    finally:
        fleet.close()
    rollouts = _records(reg, tmp_path, "rollout")
    assert [e["verdict"] for e in rollouts] == ["preflight_reject", "preflight_reject"]


def _preflight(mod, root):
    try:
        step_dir, step = mod.preflight_checkpoint(root)
        return os.path.relpath(step_dir, root), step
    except mod.PreflightError as e:
        return "PreflightError", str(e), e.problems


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("case", ["sound", "corrupt_newest", "corrupt_older", "empty", "missing"])
def test_preflight_verdicts_equal_the_reference(tmp_path, writer, case):
    """preflight_checkpoint gives the reference tool's verdict on either
    package's checkpoints: the newest step's digests decide; an older
    corrupt step does not."""
    root = str(tmp_path / "ck")
    save = t_ckpt.save_checkpoint if writer == "port" else j_ckpt.save_checkpoint
    if case != "missing":
        os.makedirs(root)
    if case not in ("empty", "missing"):
        for step in (1, 2):
            save(root, {"params": [{"W": np.arange(16.0) * step}]}, step)
    if case == "corrupt_newest":
        _corrupt_newest(root)
    if case == "corrupt_older":
        with open(os.path.join(t_ckpt.list_steps(root)[0][1], t_ckpt.ARRAYS), "r+b") as fh:
            fh.truncate(10)
    got, want = _preflight(t_vc, root), _preflight(j_vc, root)
    assert got == want
    if case in ("sound", "corrupt_older"):
        assert got == (os.path.basename(t_ckpt.list_steps(root)[-1][1]), 2)
    else:
        assert got[0] == "PreflightError"


def test_canary_reject_blocks_rollout(world, tmp_path, monkeypatch):
    _pass_preflight(monkeypatch)
    fleet, reg = _mk_fleet(world, tmp_path, n=2)
    try:
        fleet._canary = lambda ckpt: {
            "disagreement": 0.5, "tolerance": 0.05, "seeds": 8,
            "batches": 2, "mirrored": False, "passed": False,
        }
        spawns_before = world.spawns
        rec = fleet.rollout(str(tmp_path / "cand"))
        assert rec["verdict"] == "canary_reject"
        assert rec["restarted"] == 0
        assert world.spawns == spawns_before
        assert rec["canary"]["disagreement"] == 0.5
    finally:
        fleet.close()


def test_promoted_rollout_restarts_all_and_repins_recipes(world, tmp_path, monkeypatch):
    _pass_preflight(monkeypatch)
    fleet, reg = _mk_fleet(world, tmp_path, n=3)
    try:
        _pass_canary(fleet)
        cand = str(tmp_path / "ckpt_v2")
        before = fleet.predict([4])[0, 0]
        rec = fleet.rollout(cand)
        assert rec["verdict"] == "promoted"
        assert rec["restarted"] == 3 and rec["rolled_back"] == 0
        assert all(r.ckpt_dir == os.path.abspath(cand) for r in fleet.replicas)
        assert all(r.recipe.ckpt_dir == os.path.abspath(cand) for r in fleet.replicas)
        assert all(r.recipe.device == "cpu" for r in fleet.replicas)  # every respawn's
        after = fleet.predict([4])[0, 0]
        assert after != before  # the NEW model answers now
        assert len(world.alive()) == 3  # one process per replica, no leak
    finally:
        fleet.close()
    rollouts = _records(reg, tmp_path, "rollout")
    assert len(rollouts) == 1 and rollouts[0]["verdict"] == "promoted"


# ---- rollout races ---------------------------------------------------------


def _slow_canary(gate, entered):
    def canary(ckpt):
        entered.set()
        gate.wait(10.0)
        return {"disagreement": 0.0, "tolerance": 0.05, "seeds": 8,
                "batches": 2, "mirrored": False, "passed": True}

    return canary


def test_double_rollout_refused(world, tmp_path, monkeypatch):
    """A second concurrent rollout() is refused as its own typed record;
    the first completes untouched."""
    _pass_preflight(monkeypatch)
    fleet, reg = _mk_fleet(world, tmp_path, n=2)
    gate, entered = threading.Event(), threading.Event()
    fleet._canary = _slow_canary(gate, entered)
    out = {}
    t = threading.Thread(
        target=lambda: out.update(first=fleet.rollout(str(tmp_path / "ckpt_v2")))
    )
    t.start()
    try:
        assert entered.wait(10.0)
        second = fleet.rollout(str(tmp_path / "ckpt_v3"))
        assert second["verdict"] == "refused"
        assert "in progress" in second["error"]
        gate.set()
        t.join(timeout=20.0)
        assert out["first"]["verdict"] == "promoted"
        assert len(world.alive()) == 2
    finally:
        gate.set()
        t.join(timeout=5.0)
        fleet.close()
    rollouts = _records(reg, tmp_path, "rollout")
    # exactly one record per rollout() call
    assert sorted(e["verdict"] for e in rollouts) == ["promoted", "refused"]
    assert world.alive() == []


def test_close_during_inflight_rollout(world, tmp_path, monkeypatch):
    """close() mid-rollout: the rollout aborts, every process is reaped,
    and owed requests complete (served before close, shed after)."""
    _pass_preflight(monkeypatch)
    fleet, reg = _mk_fleet(world, tmp_path, n=2)
    gate, entered = threading.Event(), threading.Event()
    fleet._canary = _slow_canary(gate, entered)
    out = {}
    t = threading.Thread(
        target=lambda: out.update(rec=fleet.rollout(str(tmp_path / "ckpt_v2")))
    )
    t.start()
    assert entered.wait(10.0)
    served = fleet.submit([1])  # owed BEFORE close: must be answered
    assert served.result(timeout=10.0) is not None
    fleet.close()
    gate.set()
    t.join(timeout=20.0)
    rec = out["rec"]
    assert rec["verdict"] == "aborted"
    assert "closed" in rec["error"]
    assert rec["restarted"] == 0
    assert world.alive() == []  # nothing respawned after close
    late = fleet.submit([2])
    with pytest.raises(RequestShedError):
        late.result(timeout=2.0)


def test_replica_killed_mid_rollout_aborts_and_rolls_back(world, tmp_path, monkeypatch):
    """A replica killed between one drain/restart and the next aborts the
    rollout and rolls already-updated replicas back to the OLD checkpoint:
    no process leaked, the candidate never half-promoted."""
    _pass_preflight(monkeypatch)
    fleet, reg = _mk_fleet(world, tmp_path, n=3)
    try:
        _pass_canary(fleet)
        old_ckpt = fleet.replicas[0].ckpt_dir
        orig_roll = fleet._roll_one
        rolled = []

        def chaos_roll(r, ckpt):
            ok = orig_roll(r, ckpt)
            rolled.append((r.rid, ckpt))
            if len(rolled) == 1 and ckpt != old_ckpt:
                # between r0's restart and r1's drain: r2 dies for real
                world.proc_at(fleet.replicas[2].base_url).kill()
                fleet.hub.poll_once()
                fleet.hub.poll_once()  # miss_k=2 -> target_loss latched
            return ok

        fleet._roll_one = chaos_roll
        rec = fleet.rollout(str(tmp_path / "ckpt_v2"))
        assert rec["verdict"] == "aborted"
        assert "died mid-rollout" in rec["error"]
        assert rec["rolled_back"] == 1  # r0 returned to the old ckpt
        assert rec["restarted"] == 0  # nothing left on the candidate
        assert fleet.replicas[0].ckpt_dir == old_ckpt
        assert fleet.replicas[0].recipe.ckpt_dir == old_ckpt
        assert len(world.alive()) == 2  # r0 + r1 on the old model, r2 dead
        v = fleet.predict([3])
        assert v[0, 0] == pytest.approx(_tag(old_ckpt) + 3.0)
    finally:
        fleet.close()
    assert world.alive() == []


def test_respawn_failure_mid_rollout_aborts(world, tmp_path, monkeypatch):
    """The replica being rolled dies at respawn: the rollout aborts and
    supervision later heals the victim on the OLD checkpoint."""
    _pass_preflight(monkeypatch)
    fleet, reg = _mk_fleet(world, tmp_path, n=2, polling=True)
    try:
        _pass_canary(fleet)
        old_ckpt = fleet.replicas[0].ckpt_dir
        world.fail_next_spawn = True
        rec = fleet.rollout(str(tmp_path / "ckpt_v2"))
        assert rec["verdict"] == "aborted"
        assert rec["restarted"] == 0 and rec["rolled_back"] == 0
        victim = fleet.replicas[0]
        deadline = time.monotonic() + 10.0
        while victim.restarts == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert victim.restarts == 1
        assert victim.recipe.ckpt_dir == old_ckpt
        assert len(world.alive()) == 2
    finally:
        fleet.close()
    assert world.alive() == []


# ---- plumbing --------------------------------------------------------------


def test_launch_recipe_argv_env(tmp_path):
    r = crosshost.LaunchRecipe(
        cfg_path="/c/a.cfg", ckpt_dir="/k", replica="r1", seed=5,
        port_file="/p/r1.port", extra_env={"NTS_SERVE_BUCKETS": "1-4"},
    )
    argv = r.argv()
    assert "-m" in argv and "neutronstarlite_torch.serve.crosshost" in argv
    assert argv[argv.index("--replica") + 1] == "r1"
    assert argv[argv.index("--seed") + 1] == "5"
    assert "--device" not in argv  # the CUDA card
    env = r.env()
    assert env["NTS_METRICS_PORT"] == "0"  # ephemeral, via port file
    assert env["NTS_SERVE_BUCKETS"] == "1-4"
    assert float(env["NTS_SPAWN_WALL"]) <= time.time()
    # the argv shape is the reference's (its module, and --device after it)
    j = j_crosshost.LaunchRecipe(cfg_path="/c/a.cfg", ckpt_dir="/k", replica="r1", seed=5,
                                 port_file="/p/r1.port").argv()
    assert [a.replace("neutronstarlite_tpu", "neutronstarlite_torch") for a in j] == argv
    cpu = crosshost.LaunchRecipe(cfg_path="/c/a.cfg", ckpt_dir="/k", replica="r1", seed=5,
                                 port_file="/p/r1.port", device="cpu")
    assert cpu.argv()[-2:] == ["--device", "cpu"]


def test_normalize_base_and_targets_env(monkeypatch):
    assert crosshost.normalize_base("h:1") == "http://h:1"
    assert crosshost.normalize_base("http://h:1/") == "http://h:1"
    monkeypatch.setenv("NTS_FLEET_TARGETS", "a:1, b:2 ,")
    assert crosshost.fleet_targets() == ["a:1", "b:2"] == j_crosshost.fleet_targets()
    monkeypatch.setenv("NTS_CANARY_TOL", "0.125")
    assert crosshost.canary_tol() == 0.125
    monkeypatch.setenv("NTS_CANARY_TOL", "junk")
    assert crosshost.canary_tol() == crosshost.DEFAULT_CANARY_TOL


def test_wait_port_file_rejects_dead_child(tmp_path):
    proc = FakeProc(crosshost.LaunchRecipe(
        cfg_path="c", ckpt_dir="k", replica="r0", seed=0,
        port_file=str(tmp_path / "p.json"),
    ))
    proc.kill()
    with pytest.raises(RuntimeError, match="exited"):
        crosshost._wait_port_file(str(tmp_path / "p.json"), proc, time.monotonic() + 5.0)


# ---- distributed request tracing (router-side spans) -----------------------


def test_router_traces_request_with_root_and_route_decision(world, tmp_path):
    fleet, reg = _mk_fleet(world, tmp_path, n=2)
    try:
        fleet.predict([1, 2])
    finally:
        fleet.close()
    spans = _records(reg, tmp_path, "span")
    root = next(s for s in spans if s["name"] == "fleet_request")
    assert root["status"] == "ok" and root["n_seeds"] == 2
    assert root["parent_id"] is None
    # per-request trace id: run_id:req_id, the fleet-merge join key
    assert root["trace_id"] == f"{reg.run_id}:{root['req_id']}"
    route = next(s for s in spans if s["name"] == "route_decision")
    assert route["trace_id"] == root["trace_id"]
    assert route["parent_id"] == root["span_id"]
    assert route["target"] == root["target"]


def test_router_traces_suspect_and_reroute_on_death(world, tmp_path):
    """The owed request's trace shows why it was slow: a suspect span
    (with the error class) and a re_route span, zero sheds, an ok root."""
    fleet, reg = _mk_fleet(world, tmp_path, n=2)
    try:
        for _ in range(3):
            fleet.predict([1])
        world.proc_at(fleet.replicas[0].base_url).kill()
        world.proc_at(fleet.replicas[1].base_url).kill()
        # both dead: revive r1 through the supervision path by hand
        fleet._restart_replica(fleet.replicas[1], "test")
        assert fleet.predict([5]) is not None
    finally:
        fleet.close()
    spans = _records(reg, tmp_path, "span")
    by_trace = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    traced = [v for v in by_trace.values() if any(s["name"] == "suspect" for s in v)]
    assert traced, "no trace carries a suspect span"
    tr = traced[-1]
    suspects = [s for s in tr if s["name"] == "suspect"]
    assert all(s["error"] in ("refused", "timeout") for s in suspects)
    assert all(s["cooldown_s"] > 0 for s in suspects)
    assert any(s["name"] == "re_route" for s in tr)
    root = next(s for s in tr if s["name"] == "fleet_request")
    assert root["status"] == "ok"
    assert not [s for s in tr if s["name"] == "shed"]


def test_shed_verdict_is_traced(world, tmp_path):
    fleet, reg = _mk_fleet(world, tmp_path, n=2)
    try:
        for r in fleet.replicas:
            world.breaching.add(int(r.base_url.rsplit(":", 1)[1]))
        fleet.hub.poll_once()
        req = fleet.submit([1])
        with pytest.raises(RequestShedError):
            req.result(timeout=5.0)
    finally:
        fleet.close()
    spans = _records(reg, tmp_path, "span")
    shed = next(s for s in spans if s["name"] == "shed")
    root = next(s for s in spans if s["name"] == "fleet_request"
                and s["trace_id"] == shed["trace_id"])
    assert root["status"] == "shed"
    assert "fleet_breach" in root["reason"]
    assert shed["parent_id"] == root["span_id"]


def test_trace_off_router_emits_zero_spans(world, tmp_path, monkeypatch):
    monkeypatch.setenv("NTS_TRACE", "0")
    fleet, reg = _mk_fleet(world, tmp_path, n=2)
    try:
        fleet.predict([1])
    finally:
        fleet.close()
    assert _records(reg, tmp_path, "span") == []


def test_spawn_pins_trace_env_and_restart_preserves_it(world, tmp_path, monkeypatch):
    """NTS_TRACE / NTS_METRICS_DIR / NTS_TRACE_STEP are captured into every
    launch recipe at spawn and survive a supervised restart; caller-supplied
    extra_env wins over the snapshot."""
    monkeypatch.setenv("NTS_TRACE", "1")
    monkeypatch.setenv("NTS_METRICS_DIR", str(tmp_path / "obs"))
    monkeypatch.setenv("NTS_TRACE_STEP", "3")
    fleet, reg = _mk_fleet(world, tmp_path, n=2, extra_env={"NTS_TRACE_STEP": "7"})
    try:
        r0 = fleet.replicas[0]
        for r in fleet.replicas:
            ee = r.recipe.extra_env
            assert ee["NTS_TRACE"] == "1"
            assert ee["NTS_METRICS_DIR"] == str(tmp_path / "obs")
            assert ee["NTS_TRACE_STEP"] == "7"  # explicit beats ambient
        monkeypatch.delenv("NTS_METRICS_DIR")  # the ambient env changes
        world.proc_at(r0.base_url).kill()
        assert fleet._restart_replica(r0, "test")
        env = r0.recipe.env()
        assert env["NTS_TRACE"] == "1"
        assert env["NTS_METRICS_DIR"] == str(tmp_path / "obs")
        assert env["NTS_TRACE_STEP"] == "7"
        assert r0.restarts == 1 and r0.recipe.device == "cpu"
    finally:
        fleet.close()


# ---- real processes and real sockets -----------------------------------------


def _fleet_cfg(tmp_path, ckpt):
    with open(os.path.join(REPO, "configs", "serve_fleet_smoke.cfg")) as fh:
        text = fh.read().replace("../tests", os.path.join(REPO, "tests"))
    path = tmp_path / "fleet.cfg"
    path.write_text(text + f"CHECKPOINT_DIR:{ckpt}\n")
    return str(path)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """configs/serve_fleet_smoke.cfg trained 2 epochs by the reference
    (NumPy graph build) into an npz checkpoint."""
    from neutronstarlite_tpu.tools.serve_bench import ensure_checkpoint
    from neutronstarlite_tpu.utils.config import InputInfo as JInfo

    d = tmp_path_factory.mktemp("crosshost")
    ckpt = str(d / "ck")
    cfg_path = _fleet_cfg(d, ckpt)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        mp.setenv("NTS_SAMPLE_WORKERS", "0")
        mp.delenv("NTS_METRICS_DIR", raising=False)
        cfg = JInfo.read_from_cfg_file(cfg_path)
        ensure_checkpoint(cfg, os.path.dirname(cfg_path), ckpt, True)
    return cfg_path, ckpt


def _port_engine(cfg_path, ckpt, seed=0):
    from neutronstarlite_torch.serve.engine import InferenceEngine
    from neutronstarlite_torch.utils.config import InputInfo

    return InferenceEngine.from_config(
        InputInfo.read_from_cfg_file(cfg_path), base_dir=os.path.dirname(cfg_path),
        ckpt_dir=ckpt, rng=np.random.default_rng(seed), device="cpu")


def _pinned(engine, ids, seed):
    gen = engine.sampler.rng
    saved = gen.bit_generator.state
    gen.bit_generator.state = np.random.default_rng(seed).bit_generator.state
    try:
        return engine.predict(np.asarray(ids, dtype=np.int64))
    finally:
        gen.bit_generator.state = saved


def _post(mod_httpc, url, payload):
    return json.loads(mod_httpc.fetch(url, data=json.dumps(payload).encode(), retries=0))


IDS = [0, 5, 1000, 2707]


def _drift(src, dst):
    """A copy of checkpoint ``src`` whose float leaves are x * 1.5 + 0.25,
    with its digests made valid again (it passes preflight)."""
    shutil.copytree(src, dst)
    for _step, d in t_ckpt.list_steps(dst):
        path = os.path.join(d, t_ckpt.ARRAYS)
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(d, t_ckpt.MANIFEST)) as fh:
            manifest = json.load(fh)
        for k, a in arrays.items():
            if a.dtype.kind == "f":
                arrays[k] = (a * 1.5 + 0.25).astype(a.dtype)
                manifest["arrays"][k]["sha256"] = t_ckpt._leaf_digest(arrays[k])
        np.savez(path, **arrays)
        with open(os.path.join(d, t_ckpt.MANIFEST), "w") as fh:
            json.dump(manifest, fh)
    return dst


def test_canary_on_real_engines(world, jax_ckpt, tmp_path):
    """The real canary over the reference's checkpoint on the CPU: a
    byte-identical candidate disagrees by exactly 0.0 and is promoted; a
    drifted one (valid digests) is refused with no replica restarted."""
    cfg_path, ckpt = jax_ckpt
    same = str(tmp_path / "same")
    shutil.copytree(ckpt, same)
    drifted = _drift(ckpt, str(tmp_path / "drift"))
    reg = registry.MetricsRegistry("router-canary", algorithm="ROUTER", fingerprint="f",
                                   path=str(tmp_path / "router.jsonl"))
    fleet = crosshost.CrossHostFleet.spawn(
        cfg_path, ckpt, 2, spawn_dir=str(tmp_path / "spawn"), registry=reg, poll_s=0.05,
        miss_k=2, spawn_timeout_s=5.0, drain_timeout_s=1.0, start_polling=False,
        device="cpu")
    try:
        spawns = world.spawns
        rec = fleet.rollout(drifted)
        assert rec["verdict"] == "canary_reject" and rec["restarted"] == 0
        assert rec["canary"]["disagreement"] > rec["canary"]["tolerance"]
        assert world.spawns == spawns
        rec = fleet.rollout(same)
        assert rec["verdict"] == "promoted" and rec["restarted"] == 2
        assert rec["canary"]["disagreement"] == 0.0 and rec["canary"]["batches"] == 8
    finally:
        fleet.close()
    drift_recs = _records(reg, tmp_path, "model_drift")
    assert [r["source"] for r in drift_recs] == ["canary", "canary"]
    assert drift_recs[1]["observed"] == 0.0


def test_jax_router_serves_through_a_port_exporter(jax_ckpt, monkeypatch):
    """The reference's router (from_targets) routes to a port exporter bound
    with the port's predict handler, reads its /telemetry, and the replay
    probe it posts answers bitwise the port engine's pinned prediction."""
    from neutronstarlite_tpu.obs import httpc as j_httpc
    from neutronstarlite_torch.serve.server import InferenceServer

    cfg_path, ckpt = jax_ckpt
    monkeypatch.setenv("NTS_METRICS_PORT", "0")
    engine = _port_engine(cfg_path, ckpt)
    server = InferenceServer(engine, replica="r0")
    server.graph_seq_source = lambda: 0
    server.exporter.bind_predict(crosshost.predict_handler(server, "r0", 30.0))
    monkeypatch.delenv("NTS_METRICS_PORT")
    fleet = j_crosshost.CrossHostFleet.from_targets(
        [f"127.0.0.1:{server.exporter.port}"], start_polling=False, poll_s=0.05)
    try:
        assert fleet.route_states()[0]["beating"]
        vals = [fleet.predict(IDS[:k + 1], timeout=30) for k in range(len(IDS))]
        assert all(v.dtype == np.float32 and v.shape == (k + 1, 7) and np.isfinite(v).all()
                   for k, v in enumerate(vals))
        fleet.hub.poll_once()
        merged = fleet.hub.merged_hists()
        assert merged["serve.latency_ms"].count == len(IDS)
        out = _post(j_httpc, f"http://127.0.0.1:{server.exporter.port}/predict",
                    {"node_ids": IDS, "replay_seed": 11})
        assert out["replay"] is True and out["dtype"] == "float32" and out["ckpt_step"] == 2
        got = np.asarray(out["values"], dtype=np.float32)
        np.testing.assert_array_equal(got, _pinned(engine, IDS, 11))
    finally:
        fleet.close()
        server.exporter.bind_predict(None)
        server.close()


def test_port_router_serves_through_a_jax_exporter(jax_ckpt, tmp_path, monkeypatch):
    """The port's router routes to the reference's exporter, bound with a
    handler answering from the reference's InferenceServer in the
    reference child's wire format, and merges its /telemetry histograms."""
    from neutronstarlite_tpu.obs.exporter import MetricsExporter as JExporter
    from neutronstarlite_tpu.serve.engine import InferenceEngine as JEngine
    from neutronstarlite_tpu.serve.server import InferenceServer as JServer
    from neutronstarlite_tpu.utils.config import InputInfo as JInfo

    cfg_path, ckpt = jax_ckpt
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        engine = JEngine.from_config(JInfo.read_from_cfg_file(cfg_path),
                                     base_dir=os.path.dirname(cfg_path), ckpt_dir=ckpt,
                                     rng=np.random.default_rng(0))
    server = JServer(engine, replica="r0")
    exp = JExporter(server.metrics, port=0)

    def predict(payload, ctx=None):
        req = server.submit(np.asarray(payload["node_ids"], dtype=np.int64), ctx=ctx)
        vals = req.result(timeout=30)
        return 200, {"status": "ok", "values": vals.tolist(), "dtype": str(vals.dtype),
                     "req_id": req.req_id, "ckpt_step": engine.ckpt_step, "replica": "r0"}

    exp.bind_predict(predict)
    reg = registry.MetricsRegistry("router-x", algorithm="ROUTER", fingerprint="f",
                                   path=str(tmp_path / "router.jsonl"))
    fleet = crosshost.CrossHostFleet.from_targets(
        [f"127.0.0.1:{exp.port}"], registry=reg, start_polling=False, poll_s=0.05)
    try:
        assert fleet.route_states()[0]["beating"]
        for k in range(len(IDS)):
            v = fleet.predict(IDS[:k + 1], timeout=60)
            assert v.dtype == np.float32 and v.shape == (k + 1, 7) and np.isfinite(v).all()
        fleet.hub.poll_once()
        assert fleet.stats()["requests"] == len(IDS)
        assert fleet.hub.merged_hists()["serve.latency_ms"].count == len(IDS)
    finally:
        fleet.close()
        exp.close()
        server.close()


def test_two_real_replicas_replay_bitwise_and_respawn(jax_ckpt, tmp_path):
    """CrossHostFleet.spawn starts 2 port children with --device cpu on
    configs/serve_fleet_smoke.cfg from the reference's checkpoint. Each
    child's replay probe is bitwise the in-process port engine's (each
    process builds its own native graph); the port engine over the NumPy
    graph is within 1e-5 of the reference engine's on the same replay seed
    (sync mode); a
    SIGKILL costs one target_loss and one supervised respawn."""
    from neutronstarlite_torch.obs import httpc as t_httpc
    from neutronstarlite_tpu.serve.engine import InferenceEngine as JEngine
    from neutronstarlite_tpu.utils.config import InputInfo as JInfo

    cfg_path, ckpt = jax_ckpt
    t_limit = time.monotonic() + 120.0
    reg = registry.MetricsRegistry("router-real", algorithm="ROUTER", fingerprint="f",
                                   path=str(tmp_path / "router.jsonl"))
    fleet = crosshost.CrossHostFleet.spawn(
        cfg_path, ckpt, 2, spawn_dir=str(tmp_path / "spawn"), device="cpu",
        extra_env={"OMP_NUM_THREADS": "1"}, registry=reg, poll_s=0.1, miss_k=2,
        spawn_timeout_s=90.0,
    )
    try:
        assert all(set(r.startup) >= {"import_s", "cuda_init_s", "graph_s", "restore_s",
                                      "capture_s"} for r in fleet.replicas)
        engine = _port_engine(cfg_path, ckpt)  # the children's default graph build
        with pytest.MonkeyPatch.context() as mp:
            # the reference side draws over its NumPy graph: so does this one
            mp.setenv("NTS_NO_NATIVE", "1")
            np_engine = _port_engine(cfg_path, ckpt)
            mp.setattr(jax_native, "available", lambda: False)
            j_engine = JEngine.from_config(JInfo.read_from_cfg_file(cfg_path),
                                           base_dir=os.path.dirname(cfg_path),
                                           ckpt_dir=ckpt, rng=np.random.default_rng(0))
        for seed in (3, 4):
            want = _pinned(engine, IDS, seed)
            j_want = np.asarray(_pinned(j_engine, IDS, seed), dtype=np.float32)
            np.testing.assert_allclose(_pinned(np_engine, IDS, seed), j_want, rtol=0,
                                       atol=1e-5)
            for r in fleet.replicas:
                out = _post(t_httpc, r.predict_url, {"node_ids": IDS, "replay_seed": seed})
                np.testing.assert_array_equal(np.asarray(out["values"], np.float32), want)
        assert fleet.predict([1, 2, 3], timeout=30).shape == (3, 7)
        victim = fleet.replicas[1]
        os.kill(victim.proc.pid, signal.SIGKILL)
        while victim.restarts == 0 and time.monotonic() < t_limit:
            time.sleep(0.05)
        assert victim.restarts == 1
        out = _post(t_httpc, victim.predict_url, {"node_ids": IDS, "replay_seed": 3})
        np.testing.assert_array_equal(np.asarray(out["values"], np.float32),
                                      _pinned(engine, IDS, 3))
        pids = [r.proc.pid for r in fleet.replicas]
    finally:
        stats = fleet.close()
    assert stats["shed"] == 0 and stats["restarts"] == 1
    for pid in pids:  # reaped: no child is left
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    assert os.listdir(tmp_path / "spawn") == []
    events = _records(reg, tmp_path)
    assert len([e for e in events if e["event"] == "target_loss"]) == 1
    assert len([e for e in events if e["event"] == "recovery"
                and e["action"] == "restart"]) == 1
    assert time.monotonic() < t_limit


def test_child_without_a_card_exits_with_a_message(jax_ckpt, tmp_path):
    """No --device and no CUDA card: the child exits 2 with a message and
    the router's spawn raises (no child carries on on the CPU)."""
    cfg_path, ckpt = jax_ckpt
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "neutronstarlite_torch.serve.crosshost", cfg_path, ckpt,
         "--port-file", str(tmp_path / "p.json")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 2 and "no CUDA device" in proc.stderr
    assert not (tmp_path / "p.json").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="exited rc=2"):
            crosshost.CrossHostFleet.spawn(cfg_path, ckpt, 1, spawn_dir=str(tmp_path / "s"),
                                           spawn_timeout_s=60.0, start_polling=False)
