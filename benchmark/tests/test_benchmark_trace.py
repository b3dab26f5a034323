"""The trace readers on a small recorded profile, the probe's ranges, and
the per-layer readers."""
from __future__ import annotations

import json

import pytest
import torch

from benchmark import cells, probes, readers
from benchmark import trace as tr


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


@pytest.fixture
def recorded(tmp_path):
    """A window of 100 us: an attention forward range whose launch (corr 1)
    ran a 10 us kernel, a backward range on the autograd thread (corr 2, 3:
    8 + 4 us), and other kernels (corr 4, 5) overlapping in time."""
    ev = [
        _x("user_annotation", probes.WINDOW, 1000, 100),
        _x("cpu_op", "aten::linear", 1000, 20),
        _x("user_annotation", probes.FWD, 1005, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 1006, 1, correlation=1),
        _x("kernel", "flash_fwd_tc_kernel", 1010, 10, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 1012, 1, correlation=4),
        _x("kernel", "vectorized_elementwise_kernel", 1015, 20,
           correlation=4),
        _x("cpu_op", "aten::copy_", 1040, 30),
        _x("user_annotation", probes.BWD, 1050, 10, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 1051, 1, tid=2,
           correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 1055, 1, tid=2,
           correlation=3),
        _x("kernel", "flash_bwd_dkv_kernel", 1060, 8, correlation=2),
        _x("kernel", "flash_bwd_dq_kernel", 1068, 4, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 1062, 1, correlation=5),
        _x("kernel", "sm90_xmma_gemm", 1080, 10, correlation=5),
        _x("kernel", "outside", 1200, 50, correlation=6),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return tr.load(str(path), probes.WINDOW)


def test_busy_is_the_union_of_device_intervals(recorded):
    # [1010, 1035) + [1060, 1072) + [1080, 1090) = 25 + 12 + 10 us.
    assert recorded.window_s == pytest.approx(100e-6)
    assert recorded.busy_s() == pytest.approx(47e-6)
    gaps = recorded.idle_gaps(3)
    assert [g[1] for g in gaps] == pytest.approx([25e-6, 10e-6, 10e-6])
    assert gaps[0][0] == "aten::copy_"          # 1035-1060, host copying


def test_range_time_by_launch(recorded):
    assert recorded.range_device_s(probes.FWD) == (pytest.approx(10e-6), 1)
    assert recorded.range_device_s(probes.BWD) == (pytest.approx(12e-6), 2)
    kinds = recorded.by_kind()
    assert kinds["attention forward"] == pytest.approx(10e-6)
    assert kinds["GEMM / convolution"] == pytest.approx(10e-6)


def test_readers():
    # The traced stretch: 0.25 s busy for 1e12 FLOP; the window: 10 s
    # for 20e12, so 5 s busy.
    run = {"mode": "serve", "busy_s": 0.25, "trace_window_s": 1.0,
           "trace_work": 1e12,
           "attention_bound_s": 0.002, "attention_device_s": 0.01,
           "model_flops": 20e12, "window_s": 10.0}
    assert readers.idle_share(run, "serve") == pytest.approx(50.0)
    assert readers.idle_share(dict(run, trace_work=0), "serve") is None
    assert readers.attn_roofline(run, "serve") == pytest.approx(20.0)
    assert readers.mfu(run, "serve") == pytest.approx(
        100 * 2e12 / 989e12)
    assert readers.mfu(run, "train") is None
    assert readers.attn_roofline(dict(run, attention_device_s=0),
                                 "serve") is None
    cell = cells.load_cell("r101-serve-b8")
    got = cells.read_per_layer(cell, dict(run, trace=None))
    assert set(got) == {"idle_share.serve", "attn_roofline.serve",
                        "mfu.serve"}


def test_probe_ranges_cover_forward_and_backward(tmp_path):
    """On the CPU the program's attention entry runs its plain version;
    the probe's forward and backward ranges show in the exported trace,
    one of each per traced call (the profiler's warm-up calls are not in
    it), and the bound counts every traced call."""
    from toist_tpu_torch.models import layers

    probe = probes.AttentionProbe()
    probe.install()
    try:
        mha = layers.MultiheadAttention(32, 2)
        x = torch.randn(2, 300, 32)
        mask = torch.zeros(2, 300, dtype=torch.bool)
        mask[1, 250:] = True

        def step():
            mha(x, x, x, mask).sum().backward()

        path = str(tmp_path / "p.json")
        probes.profile_calls(step, 2, path, before_window=probe.calls.clear)
    finally:
        probe.uninstall()
    assert layers.flash_attention is not None
    t = tr.load(path, probes.WINDOW)
    assert len(t.ranges[probes.FWD]) == 2
    assert len(t.ranges[probes.BWD]) == 2
    keys = probe.calls[0][4].tolist()
    assert keys == [300, 250]
    want = 2 * (counters_bound("fwd") + counters_bound("bwd"))
    assert probe.bound_s() == pytest.approx(want)


def counters_bound(kind):
    from benchmark import counters

    return counters.attention_bound_s(kind, 2, 2, 300, [300, 250], 32, 4)


def test_a_trace_of_the_device_alone(tmp_path):
    """Without a window range the window is the span of the device's
    events, and busy time is still their union."""
    ev = [
        _x("cuda_runtime", "cudaLaunchKernel", 990, 1, correlation=1),
        _x("kernel", "a", 1000, 10, correlation=1),
        _x("kernel", "b", 1005, 10, correlation=2),
        _x("gpu_memcpy", "Memcpy HtoD", 1030, 5),
    ]
    path = tmp_path / "d.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = tr.load(str(path), None)
    assert t.window_s == pytest.approx(35e-6)
    assert t.busy_s() == pytest.approx(20e-6)
    assert t.by_kind()["copy / memset"] == pytest.approx(5e-6)


def test_a_traced_run_prints_its_per_layer_metrics_and_breakdown():
    """A traced run of a tiny serving cell on the CPU: two profiled
    stretches, the per-layer metrics the readers find, the breakdown."""
    import time

    from benchmark import run, serve
    from benchmark.tests.tiny import tiny_cell

    cell = tiny_cell("r101-serve-b8")
    rec = serve.run(cell, 31, 0.3, True, time.perf_counter(), "cpu")
    assert rec["trace_units"] == cell.traffic["trace_calls"]
    assert rec["trace_window_s"] > 0 and rec["host_trace_window_s"] > 0
    assert rec["trace_work"] > 0
    out, _ = run.result_line(cell, rec, True, {"platform": "cpu"})
    assert set(out["metrics"]) <= {"idle_share.serve", "attn_roofline.serve",
                                   "mfu.serve"}
    assert "mfu.serve" in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] == rec["trace_window_s"]
    assert list(out)[-1] == "check"
