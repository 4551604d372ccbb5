"""``spans.py`` and the readers of the program's scopes and counters, on
synthetic traces."""

import importlib.util
import os

import pytest

from conftest import ROOT
from h100bench import profile_window, spans

K_ELL = "void (anonymous namespace)::ell_work_kernel<float, 4>(long long const*)"
K_RED = "void (anonymous namespace)::ell_split_reduce<float>(float const*)"
K_FILL = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>"
K_GATHER = "void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*)"
K_BMM = "void gemv2T_kernel_val<int, int, float, float, float, float, 128>"
K_ADD = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>"
K_ADAM = "void at::native::elementwise_kernel<128, 2, adam>"

# host scopes (s): the forward holds the scores and the aggregate; the
# backward thread's grad_alpha opens inside the main thread's backward
SCOPES = [("nts.step.forward", 0.01, 0.30), ("nts.gat.scores", 0.05, 0.10),
          ("nts.ell.aggregate", 0.15, 0.20), ("nts.step.backward", 0.35, 0.70),
          ("nts.gat.grad_alpha", 0.40, 0.50), ("nts.step.optim", 0.72, 0.80)]
# (launch call, its start, device event, device start, device duration,
#  category, the scope it belongs to)
WORK = [
    ("cudaLaunchKernel", 0.06, K_GATHER, 0.07, 0.02, "kernel", "nts.gat.scores"),
    ("cudaMemcpyAsync", 0.155, "Memcpy HtoD (Pinned -> Device)", 0.160, 0.001, "gpu_memcpy",
     "nts.ell.aggregate"),
    ("cudaLaunchKernel", 0.16, K_FILL, 0.165, 0.004, "kernel", "nts.ell.aggregate"),
    ("cuLaunchKernel", 0.17, K_ELL, 0.17, 0.05, "kernel", "nts.ell.aggregate"),
    ("cudaLaunchKernel", 0.18, K_RED, 0.22, 0.01, "kernel", "nts.ell.aggregate"),
    ("cudaLaunchKernel", 0.25, K_ADD, 0.25, 0.04, "kernel", "nts.step.forward"),
    ("cudaLaunchKernel", 0.41, K_BMM, 0.41, 0.08, "kernel", "nts.gat.grad_alpha"),
    ("cudaLaunchKernel", 0.55, K_ADD, 0.56, 0.10, "kernel", "nts.step.backward"),
    ("cudaLaunchKernel", 0.75, K_ADAM, 0.75, 0.04, "kernel", "nts.step.optim"),
    ("cudaMemcpyAsync", 0.85, "Memcpy DtoH (Device -> Pageable)", 0.85, 0.001, "gpu_memcpy",
     None),
]
EPOCHS = 2


def events(scopes=SCOPES, work=WORK, extra_host=(("cudaStreamSynchronize", 0.8505, 0.852),)):
    us = 1e6
    ev = [{"ph": "X", "name": profile_window.WINDOW, "cat": "user_annotation", "ts": 0,
           "dur": 1.0 * us}]
    for name, a, b in scopes:
        ev.append({"ph": "X", "name": name, "cat": "user_annotation", "ts": a * us,
                   "dur": (b - a) * us})
    for call, t, dev, dt, dd, cat, _ in work:
        ev.append({"ph": "X", "name": call, "cat": "cuda_runtime", "ts": t * us, "dur": 5.0})
        ev.append({"ph": "X", "name": dev, "cat": cat, "ts": dt * us, "dur": dd * us})
    for name, a, b in extra_host:
        ev.append({"ph": "X", "name": name, "cat": "cpu_op", "ts": a * us, "dur": (b - a) * us})
    return ev


def trace(**kw):
    tr = profile_window.parse(events(**kw))
    tr["epochs"] = EPOCHS
    return tr


def record(tr=None, counters=None):
    return {"epochs": 10, "counters": counters if counters is not None else {},
            "trace": tr if tr is not None else trace()}


def read(name, rec):
    path = os.path.join(ROOT, "h100bench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"spans_test_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def epochs(n=2, drop=None, lost_in=1):
    """The trace's window n times over, each epoch ended by the harness's
    fetch (its copy back, then its synchronise); ``drop`` names a device
    record CUPTI lost in epoch ``lost_in``."""
    one = events()
    ev = [dict(one[0], dur=n * 1e6)]
    for i in range(n):
        for e in one[1:]:
            if i == lost_in and e["name"] == drop:
                continue
            ev.append(dict(e, ts=e["ts"] + i * 1e6))
    tr = profile_window.parse(ev)
    tr["epochs"] = n
    return tr


def test_launches_map_to_device_work_in_order():
    work, share = spans.attributed(trace())
    assert share == 1.0
    assert [d[0] for _, d in work] == [w[2] for w in WORK]
    assert [name for name, _ in work] == [w[6] for w in WORK]


def test_innermost_scope_across_nesting_and_the_backward_thread():
    s = spans.scopes(trace())
    # the nested scores scope over the forward; the backward thread's
    # grad_alpha over the main thread's backward; then the backward again;
    # a gap between scopes has none
    assert spans.innermost(s, [0.06, 0.12, 0.41, 0.55, 0.71, 0.9]) == [
        "nts.gat.scores", "nts.step.forward", "nts.gat.grad_alpha", "nts.step.backward",
        None, None]


def test_count_mismatch_gives_no_mapping():
    ev = [e for e in events() if e["name"] != K_BMM]  # CUPTI lost one kernel record
    tr = profile_window.parse(ev)
    tr["epochs"] = EPOCHS
    assert len(tr["device"]) == len(WORK) - 1
    assert spans.attributed(tr) is None
    assert read("attention_ms", record(tr)) is None


def test_an_epoch_that_lost_a_record_is_left_out():
    # whole: both epochs map; the second lost grad_alpha's bmm: the first
    # alone gives the per-epoch reading
    work, share = spans.attributed(epochs())
    assert share == 1.0 and len(work) == 2 * len(WORK)
    assert read("attention_ms", record(epochs())) == pytest.approx(1e3 * 0.10)
    work, share = spans.attributed(epochs(drop=K_BMM))
    assert share == 0.5 and [n for n, _ in work] == [w[6] for w in WORK]
    assert read("attention_ms", record(epochs(drop=K_BMM))) == pytest.approx(1e3 * 0.10)


def test_a_lost_copy_back_merges_two_epochs_and_both_are_left_out():
    # the first of three epochs lost its fetch's copy back: on the device
    # it runs into the second, which pairs with the second host epoch and
    # fails the count; the third alone maps
    tr = epochs(n=3, drop="Memcpy DtoH (Device -> Pageable)", lost_in=0)
    work, share = spans.attributed(tr)
    assert share == pytest.approx(1 / 3) and len(work) == len(WORK)
    assert read("attention_ms", record(tr)) == pytest.approx(1e3 * 0.10)


def test_launch_and_device_kinds_must_agree():
    work = list(WORK)
    work[0] = ("cudaMemsetAsync",) + work[0][1:]  # a memset paired with a kernel
    assert spans.attributed(trace(work=work)) is None


@pytest.mark.parametrize("where", ["outside", "other_kernel_inside"])
def test_ell_kernel_outside_the_aggregate_gives_no_mapping(where):
    work = list(WORK)
    if where == "outside":  # the ELL kernel launched from the forward's self time
        work[3] = ("cuLaunchKernel", 0.21) + work[3][2:]
        work[4] = ("cudaLaunchKernel", 0.215) + work[4][2:]
    else:  # an element-wise kernel mapped under the aggregate
        work[2] = work[2][:2] + (K_ADD,) + work[2][3:]
    assert spans.attributed(trace(work=work)) is None


def test_attention_ms_sums_the_gat_scopes_per_epoch():
    # the scores' gather 0.02 s and grad_alpha's bmm 0.08 s over 2 epochs
    assert read("attention_ms", record()) == pytest.approx(1e3 * 0.10 / EPOCHS)
    assert spans.scope_ms(record(), spans.AGGREGATE) == pytest.approx(1e3 * 0.065 / EPOCHS)


def test_step_idle_counts_only_gaps_that_begin_inside_a_step_scope():
    # device busy 0.07-0.09, 0.16-0.161, 0.165-0.169, 0.17-0.23, 0.25-0.29,
    # 0.41-0.49, 0.56-0.66, 0.75-0.79, 0.85-0.851: the gaps that begin
    # inside a step scope are 0.09-0.16, 0.161-0.165, 0.169-0.17, 0.23-0.25,
    # 0.29-0.41 (forward), 0.49-0.56, 0.66-0.75 (backward: a gap runs on
    # past its scope's end) and 0.79-0.85 (optim); 0-0.07 and 0.851-1.0
    # begin outside every one
    inside = [(0.09, 0.16), (0.161, 0.165), (0.169, 0.17), (0.23, 0.25), (0.29, 0.41),
              (0.49, 0.56), (0.66, 0.75), (0.79, 0.85)]
    want = 1e3 * sum(b - a for a, b in inside) / EPOCHS
    assert read("step_idle_ms", record()) == pytest.approx(want)
    total = 1e3 * sum(b - a for a, b in spans.idle_gaps(trace())) / EPOCHS
    assert total - want == pytest.approx(1e3 * (0.07 + 0.149) / EPOCHS)


def test_step_idle_leaves_out_a_gap_begun_in_the_harness_fetch():
    # the same trace with the forward ending before its last kernel's gap:
    # the 0.29-0.41 gap then begins outside every step scope
    scopes = [s if s[0] != "nts.step.forward" else ("nts.step.forward", 0.01, 0.28)
              for s in SCOPES]
    tr = trace(scopes=scopes, extra_host=[("cudaStreamSynchronize", 0.8505, 0.852),
                                          ("aten::item", 0.28, 0.4)])
    inside = [(0.09, 0.16), (0.161, 0.165), (0.169, 0.17), (0.23, 0.25),
              (0.49, 0.56), (0.66, 0.75), (0.79, 0.85)]
    assert read("step_idle_ms", record(tr)) == pytest.approx(
        1e3 * sum(b - a for a, b in inside) / EPOCHS)


def test_step_idle_leaves_out_the_fetch_gap_a_drifted_clock_moves_into_a_step():
    # the device clock reads late: the copy back ends at 0.91 s of the
    # host's clock, inside a later step's forward (0.9-0.99)
    work = [w if w[2] != "Memcpy DtoH (Device -> Pageable)" else w[:3] + (0.85, 0.06) + w[5:]
            for w in WORK]
    scopes = SCOPES + [("nts.step.forward", 0.9, 0.99)]
    base = read("step_idle_ms", record(trace(scopes=scopes)))
    assert read("step_idle_ms", record(trace(scopes=scopes, work=work))) == pytest.approx(base)


def test_counters_become_ms_per_epoch():
    rec = record(counters={"step.forward_s": 0.8, "step.backward_s": 1.25})
    assert read("forward_host_ms", rec) == pytest.approx(80.0)
    assert read("backward_host_ms", rec) == pytest.approx(125.0)


@pytest.mark.parametrize("metric", ["attention_ms", "step_idle_ms", "forward_host_ms",
                                    "backward_host_ms"])
def test_a_program_without_scopes_or_counters_reads_nothing(metric):
    # the parent's program: no nts.* scope in its trace, no step.* counter
    tr = trace(scopes=[])
    assert read(metric, record(tr)) is None
    assert read(metric, {"epochs": 10, "counters": {}, "trace": None}) is None
