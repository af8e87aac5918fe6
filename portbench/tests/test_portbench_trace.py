"""The traced window's reading: the union of device intervals, its gaps, and
the rule that a trace which lost launches of the program's kernels gives no
device share."""

import types

import torch

from portbench import groups, trace
from portbench.metrics import conv_ms, conv_roofline, copy_ms, glue_ms, idle_pct, step_mfu

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
K5 = "void conv_up_sm90_kernel<64, 4, 0, 3>(Params)"


def _ev(name, a, b, dev=CUDA):
    return types.SimpleNamespace(name=name, device_type=dev,
                                 time_range=types.SimpleNamespace(start=a, end=b))


def _prof(events):
    return types.SimpleNamespace(events=lambda: events)


def _reading(launches):
    ev = [_ev(trace.WINDOW_SPAN, 0, 1000, CPU), _ev(trace.STEP_SPAN, 0, 100, CPU),
          _ev(trace.WINDOW_SPAN, 0, 1000),  # the device's copy of the span: no work
          _ev("Memcpy HtoD (Pageable -> Device)", 100, 200),
          _ev(K5, 200, 500), _ev(K5, 450, 600),
          _ev("void at::native::elementwise_kernel<128, 2>(int)", 700, 800),
          _ev(trace.FETCH_SPAN, 800, 1000, CPU),
          _ev("Memcpy DtoH (Device -> Pageable)", 850, 900)]
    totals = {"bound_s": 100e-6, "ops_s": 50e-6}
    return trace.read(_prof(ev), launches, 1, [1e-4], totals, plain=False)


def test_union_and_gaps():
    busy, gaps = trace.union_s([(0, 1), (0.5, 2), (3, 4)])
    assert busy == 3 and gaps == [(2, 3)]


def test_complete_trace_reads():
    r = _reading({"conv_packed": 2, "conv_packed_int8": 0})
    assert r.complete and not r.lost
    assert abs(r.window_s - 1e-3) < 1e-12 and abs(r.busy_s - 650e-6) < 1e-12
    assert abs(conv_ms.read(r) - 0.45) < 1e-9          # 300 + 150 us
    assert abs(copy_ms.read(r) - 0.15) < 1e-9
    assert abs(glue_ms.read(r) - 0.1) < 1e-9
    assert abs(conv_roofline.read(r) - 100 * 100 / 450) < 1e-9
    assert abs(idle_pct.read(r) - 35.0) < 1e-9
    assert abs(step_mfu.read(r) - 5.0) < 1e-9
    assert r.gaps[0][0] == "host in the benchmark loop"
    labels = {label for label, _ in r.gaps}
    assert "host in the result fetch" in labels


def test_lost_launches_give_no_device_share():
    r = _reading({"conv_packed": 3})
    assert not r.complete and r.lost == {"conv_packed (K5)": (3, 2)}
    for m in (conv_ms, conv_roofline, copy_ms, glue_ms, idle_pct, step_mfu):
        assert m.read(r) is None


def test_counter_buckets_match_trace_groups():
    assert groups.counter_bucket("conv_up_f_packed_int8") == groups.bucket(
        groups.group("void conv_up_sm90_kernel<32, 1, 1, 3>(P)"))
    assert groups.counter_bucket("conv_up_packed_f32") == groups.bucket(
        groups.group("conv_up_sm90_kernel<64, (int)3, (int)2, 5>"))
    assert groups.counter_bucket("warp_u8") == groups.bucket(groups.group("rrin_warp_kernel<2>"))
    assert groups.counter_bucket("conv_phase") == groups.bucket(
        groups.group("conv_stream_sm90_kernel<32>"))
    assert groups.counter_bucket("conv_up_prep") == groups.bucket(
        groups.group("conv_up_prep_kernel"))
