"""Each per-layer reader against a canned record and trace."""

import importlib.util
import json
import os

import pytest

from conftest import ROOT
from h100bench import profile_window

HERE = os.path.join(ROOT, "h100bench")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))

K_ELL = "void (anonymous namespace)::ell_work_kernel<__nv_bfloat16, 2>(long long const*)"
K_RED = "void (anonymous namespace)::ell_split_reduce<__nv_bfloat16>(float const*)"
K_GEMM = "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_128x128>(x)"
K_ADD = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>"


def canned_events():
    """A 1.0 s window (ts in us): two epochs; device busy 0.1-0.5 and
    0.6-0.9 s, idle 0.5-0.6 while the host sits in cudaStreamSynchronize."""
    ev = [{"ph": "X", "name": profile_window.WINDOW, "cat": "user_annotation", "ts": 0, "dur": 1e6}]
    dev = [(K_ELL, 0.1, 0.2), (K_RED, 0.3, 0.05), (K_GEMM, 0.35, 0.1), (K_ADD, 0.45, 0.05),
           (K_ELL, 0.6, 0.2), (K_ADD, 0.8, 0.1)]
    for name, t, d in dev:
        ev.append({"ph": "X", "name": name, "cat": "kernel", "ts": t * 1e6, "dur": d * 1e6})
    ev.append({"ph": "X", "name": "aten::item", "cat": "cpu_op", "ts": 0.45e6, "dur": 0.2e6})
    ev.append({"ph": "X", "name": "cudaStreamSynchronize", "cat": "cuda_runtime",
               "ts": 0.46e6, "dur": 0.15e6})
    ev.append({"ph": "X", "name": "outside", "cat": "kernel", "ts": 2e6, "dur": 1.0})
    return ev


def record():
    tr = profile_window.parse(canned_events())
    tr["epochs"] = 2
    return {"spans": {"graph_build_s": 8.5, "model_build_s": 1.25}, "epochs": 100,
            "epoch_ms": 40.0, "dispatch_s": [0.004, 0.006],
            "counters": {"ell_level.launches": 600.0},
            "counts": {"least_ms": 3.4, "aggregation_ms": 2.9}, "trace": tr}


def read(name, rec):
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


EXPECTED = {
    "graph_build_s": 8.5,
    "model_build_s": 1.25,
    "dispatch_ms": 5.0,
    "mfu": 100 * 3.4 / 40.0,
    "ell_launches": 6.0,
    # ell kernels 0.45 s over 2 epochs: 225 ms per epoch
    "agg_roofline": 100 * 2.9 / 225.0,
    # the two adds, 0.15 s over 2 epochs
    "plain_ops_ms": 75.0,
    "idle_share": 100 * (1 - 0.7),
}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_on_canned_record(metric):
    assert read(metric, record()) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", ["agg_roofline", "plain_ops_ms", "idle_share", "ell_launches"])
def test_reader_finds_nothing_and_returns_none(metric):
    rec = record()
    rec["trace"], rec["counters"] = None, {}
    assert read(metric, rec) is None


def test_trace_parse_busy_and_breakdown():
    tr = profile_window.parse(canned_events())
    assert tr["window_s"] == pytest.approx(1.0)
    assert len(tr["device"]) == 6  # the kernel outside the window is dropped
    assert profile_window.busy_s(tr) == pytest.approx(0.7)
    b = profile_window.breakdown(tr)
    assert b["device_ops"][0] == [K_ELL, pytest.approx(0.4)]
    gaps = dict(b["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(0.1)
    assert gaps["nothing traced"] == pytest.approx(0.2)  # 0-0.1 and 0.9-1.0
