"""The byte count and roofline share of B1, the trace reduction and the
end-to-end readers, on synthetic inputs."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
from torch.autograd import DeviceType

from knnbench import roofline, trace
from knnbench.harness import Run

METRICS = Path(__file__).resolve().parent / "metrics"


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"t_{name}",
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_knn_tick_bytes_counts_each_byte_once():
    # 1M objects and 1M queries of 12 B each, 1M lists of 32 x 8 B
    assert roofline.knn_tick_bytes(1_000_000, 1_000_000, 32) == 280_000_000
    assert roofline.knn_tick_bytes(10, 4, 2) == 12 * 14 + 8 * 2 * 4


def test_roofline_pct():
    # 3.35 GB in 1 ms is 3.35 TB/s: the whole peak
    assert roofline.roofline_pct(3.35e9, 1e-3) == pytest.approx(100.0)
    assert roofline.roofline_pct(1.0, 0.0) is None


class _Ev:
    def __init__(self, name, dev, start, end, annotation=False):
        self._n, self._d, self._s, self._e = name, dev, start, end
        self._a = annotation

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def is_user_annotation(self):
        return self._a


def _events():
    C, G = DeviceType.CPU, DeviceType.CUDA
    return [
        _Ev(trace.TICK_SPAN, C, 1000, 2000, annotation=True),
        _Ev("knnbench.submit", C, 1000, 1800, annotation=True),
        _Ev("aten::nonzero", C, 1500, 1700),
        _Ev("knnbench.submit", G, 1100, 1900, annotation=True),
        _Ev("fused_scan_queue_kernel<2>", G, 1100, 1300),
        _Ev("fused_scan_queue_kernel<2>", G, 1250, 1400),  # overlaps
        _Ev("Memcpy DtoH", G, 1900, 2100),  # runs past the window
        _Ev("outside", G, 5000, 6000),
    ]


def test_trace_reduce_unions_names_and_gaps():
    device_alone = [e for e in _events() if e.device_type() != DeviceType.CPU
                    and not e.is_user_annotation() and e.name() != "outside"]
    t = trace.reduce(device_alone, 1000e-9, _events())
    assert t.window_s == 1000e-9
    # busy: [1100, 1400] and [1900, 2100], every interval of the device trace
    assert t.busy_s == pytest.approx(500e-9)
    assert t.device_seconds(("fused_scan_",)) == pytest.approx(350e-9)
    assert "knnbench.submit" not in t.kernels
    # the gaps: inside the named trace's tick span, the device's intervals
    # clipped to it, named by the host's innermost operation
    assert t.gaps[0] == ("submit: aten::nonzero", pytest.approx(500e-9))
    bd = t.breakdown()
    assert bd["device_ops"][0][0].startswith("fused_scan_")


def _run(**kw):
    ticks = [{"rows": 1000, "tick_s": s, "hand_in_s": 0.01, "submit_s": 0.5,
              "collect_s": 0.1, "iterations": 850, "candidates": 2.0e5,
              "rebuilt": i == 3, "counters": {"b1_launches": 8}}
             for i, s in enumerate([0.6, 0.7, 0.8, 0.9, 1.0, 0.65, 0.75,
                                    0.85, 0.95, 0.62])]
    return Run(n_objects=1000, k=32, setup_s=12.5, window_s=8.0,
               memory_peak_bytes=2**31, ticks=ticks, **kw)


def test_end_to_end_and_counter_readers():
    run = _run()
    assert _reader("queries_per_s")(run) == pytest.approx(10_000 / 8.0)
    assert _reader("peak_mem_gib")(run) == 2.0
    assert _reader("setup_s")(run) == 12.5
    assert _reader("ingest_ms")(run) == pytest.approx(10.0)
    assert _reader("sweep_trips")(run) == 850
    assert _reader("cand_per_query")(run) == pytest.approx(200.0)
    assert _reader("rebuild_pct")(run) == pytest.approx(10.0)
    assert _reader("b1_launches")(run) == 8
    assert _reader("b1_roofline")(run) is None


def test_b1_roofline_reads_the_traced_ticks():
    run = _run(traced=[{"rows": 1000}] * 2)
    run.trace = trace.Trace(window_s=1.0, busy_s=0.5, gaps=[],
                            kernels={"fused_scan_queue_kernel": 1e-3,
                                     "other": 5.0})
    nbytes = 2 * roofline.knn_tick_bytes(1000, 1000, 32)
    want = 100 * nbytes / roofline.H100_HBM_BYTES_PER_S / 1e-3
    assert _reader("b1_roofline")(run) == pytest.approx(want)
    # 0.25 s busy a traced tick against 0.8 s of the window's wall a tick
    assert _reader("device_idle_pct")(run) == pytest.approx(68.75)
