"""The readers of the program's spans (``benchmark/spans.py``) on small
made-up traces, and the per-layer metrics that read them."""
from __future__ import annotations

import json
import os

import pytest

from benchmark import cells, probes, spans
from benchmark import trace as tr

SERVE = ("h2d_ms.serve", "issue_ms.serve", "answer_wait_ms.serve",
         "launches.serve", "idle_in_issue.serve")
TRAIN = ("forward_ms.train", "criterion_ms.train", "backward_ms.train",
         "optimizer_ms.train", "launches.train", "idle_in_issue.train")


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _span(name, ts, end, tid=1):
    return _x("user_annotation", name, ts, end - ts, tid)


def _launch(corr, at, start, end, tid=1, cat="kernel", name="k"):
    return [_x("cuda_runtime", "cudaLaunchKernel", at, 1, tid,
               correlation=corr),
            _x(cat, name, start, end - start, 1, correlation=corr)]


def _load(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tr.load(str(path), probes.WINDOW)


def _train_events(with_spans=True):
    """A window of 1,000 us and one step: the batch's copy, the step (its
    forward, criterion, backward, optimizer), the host's read, and 100 us
    outside every span. The backward's kernel is launched from autograd's
    thread (tid 2)."""
    ev = [_x("user_annotation", probes.WINDOW, 1000, 1000)]
    if with_spans:
        ev += [_span("toist.h2d", 1000, 1050),
               _span("toist.train_step", 1060, 1800),
               _span("toist.encode", 1070, 1200),
               _span("toist.decode", 1200, 1300),
               _span("toist.criterion", 1300, 1400),
               _span("toist.backward", 1400, 1600),
               _span("toist.optimizer", 1600, 1750),
               _span("Optimizer.step#AdamW.step", 1610, 1740),
               _span("toist.host_read", 1800, 1900)]
    ev += [_span(probes.BWD, 1440, 1520, tid=2)]
    ev += _launch(1, 1010, 1020, 1040, cat="gpu_memcpy", name="Memcpy HtoD")
    ev += _launch(2, 1100, 1110, 1150)
    ev += _launch(3, 1450, 1460, 1500, tid=2)
    ev += _launch(4, 1650, 1700, 1790)
    ev += _launch(5, 1950, 1960, 1970)          # outside every span
    # A launch inside the optimizer whose device record the profiler
    # dropped.
    ev += _launch(6, 1720, 0, 0)[:1]
    return ev


def _serve_events(with_spans=True):
    """A window of 600 us and one call: the copy in starts with the call,
    100 us follow it outside every span (a kernel runs in 10 of them)."""
    ev = [_x("user_annotation", probes.WINDOW, 1000, 600)]
    if with_spans:
        ev += [_span("toist.predict", 1000, 1500),
               _span("toist.h2d", 1000, 1050),
               _span("toist.encode", 1100, 1200),
               _span("toist.decode", 1200, 1300),
               _span("toist.postprocess", 1300, 1320),
               _span("toist.d2h", 1320, 1480)]
    ev += _launch(1, 1310, 1330, 1470)
    ev += _launch(2, 1550, 1560, 1570)          # after the call
    return ev


@pytest.fixture
def train_run(tmp_path):
    return {"mode": "train", "trace_units": 1,
            "host_trace": _load(tmp_path, _train_events())}


@pytest.fixture
def serve_run(tmp_path):
    return {"mode": "serve", "trace_units": 1,
            "host_trace": _load(tmp_path, _serve_events())}


def test_span_ms_per_unit(train_run):
    assert spans.span_ms(train_run, "train", ("toist.encode",
                                              "toist.decode")) == \
        pytest.approx(0.23)
    assert spans.span_ms(train_run, "train", ("toist.backward",)) == \
        pytest.approx(0.2)
    two = dict(train_run, trace_units=2)
    assert spans.span_ms(two, "train", ("toist.optimizer",)) == \
        pytest.approx(0.075)
    # Nested spans count their common time once.
    assert spans.span_ms(train_run, "train", ("toist.train_step",
                                              "toist.encode")) == \
        pytest.approx(0.74)


def test_launches_from_another_thread_count_by_time(train_run):
    """The backward's kernel, launched on tid 2 inside the main thread's
    ``toist.backward``, counts; the one launched outside every span does
    not; a launch whose device record is missing counts, since launches
    are the host's calls."""
    tops = ("toist.h2d", "toist.train_step", "toist.host_read")
    assert spans.launches(train_run, "train", tops) == 5
    assert spans.launches(dict(train_run, trace_units=2), "train",
                          tops) == 2.5
    assert spans.launches(train_run, "train", ("toist.backward",)) == 1
    assert spans.launches(train_run, "train", ("toist.optimizer",)) == 2


def test_idle_goes_to_the_innermost_span(train_run, serve_run):
    by_span = spans.idle_by_span(train_run, "train")
    want = {"toist.h2d": 30, "toist.encode": 90, "toist.decode": 100,
            "toist.criterion": 100, "toist.backward": 160,
            "toist.optimizer": 100, "toist.train_step": 20,
            "toist.host_read": 100, "outside": 100}
    assert by_span == pytest.approx({k: v / 1e6 for k, v in want.items()})
    assert spans.idle_by_class(train_run, "train") == pytest.approx(
        {"issue": 580e-6, "wait": 100e-6, "self": 20e-6,
         "outside": 100e-6})
    assert spans.idle_in_issue(train_run, "train") == pytest.approx(72.5)
    # A child that opens with its parent holds the idle time, not the
    # parent; the parent holds the time between its children.
    by_span = spans.idle_by_span(serve_run, "serve")
    want = {"toist.h2d": 50, "toist.predict": 70, "toist.encode": 100,
            "toist.decode": 100, "toist.postprocess": 20, "toist.d2h": 20,
            "outside": 90}
    assert by_span == pytest.approx({k: v / 1e6 for k, v in want.items()})
    assert spans.idle_by_class(serve_run, "serve") == pytest.approx(
        {"issue": 270e-6, "wait": 20e-6, "self": 70e-6, "outside": 90e-6})
    assert spans.launches(serve_run, "serve", ("toist.predict",)) == 1


def test_readers_find_nothing_without_spans_device_or_mode(tmp_path,
                                                         train_run,
                                                         serve_run):
    bare_train = {"mode": "train", "trace_units": 1,
                  "host_trace": _load(tmp_path, _train_events(False))}
    bare_serve = {"mode": "serve", "trace_units": 1,
                  "host_trace": _load(tmp_path, _serve_events(False))}
    no_device = _load(tmp_path, [e for e in _serve_events()
                                 if e["cat"] == "user_annotation"])
    nothing = [bare_train, bare_serve, dict(serve_run, host_trace=no_device),
               {"mode": "serve"}, {"mode": "train"}]
    for names, other in ((SERVE, train_run), (TRAIN, serve_run)):
        for name in names:
            read = cells.metric_reader(name)
            for run in nothing + [other]:
                assert read(run) is None, (name, run)
    assert spans.idle_by_class(bare_train, "train") is None
    assert spans.idle_by_class(bare_serve, "serve") is None


def test_cells_report_the_span_metrics(train_run, serve_run):
    got = cells.read_per_layer(cells.load_cell("r101-train-b6"), train_run)
    assert set(TRAIN) <= set(got)
    assert got["criterion_ms.train"] == {"value": pytest.approx(0.1),
                                         "unit": "ms"}
    got = cells.read_per_layer(cells.load_cell("r101-serve-b8"), serve_run)
    assert set(SERVE) <= set(got)
    assert got["answer_wait_ms.serve"]["value"] == pytest.approx(0.16)


def test_each_entry_has_its_file_and_each_file_its_entry():
    bench = cells.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(cells.HERE, "metrics"))
             if f.endswith(".py")}
    assert files == set(entries)
    for name in SERVE + TRAIN:
        m = entries[name]
        assert m["source"] == "device_trace" and m["better"] == "lower"
        assert m["workloads"] == (["r101-serve-b8"]
                                  if name.endswith(".serve")
                                  else ["r101-train-b6"])
        assert callable(cells.metric_reader(name))
