"""``icikit_torch.utils.trace.summarize`` on hand-made Chrome trace events:
copies by direction, kernels by name, and a trace that lost its device
events."""

import pytest

from icikit_torch.utils.trace import copy_direction, summarize


def _ev(cat, name, ts, dur, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


@pytest.mark.parametrize("name, want", [
    ("Memcpy HtoD (Pageable -> Device)", "HtoD"),
    ("Memcpy DtoD (Device -> Device)", "DtoD"),
    ("Memcpy DtoH (Device -> Pinned)", "DtoH"),
    ("Memset (Device)", "Memset (Device)"),
])
def test_copy_direction(name, want):
    assert copy_direction(name) == want


def test_summarize_counts_copies_by_direction_and_kernels_by_name():
    events = [
        _ev("cuda_runtime", "cudaLaunchKernel", 0, 1),
        _ev("cuda_runtime", "cudaMemcpyAsync", 1, 1),
        _ev("kernel", "void (anonymous namespace)::net_kernel<int>(int*)",
            10, 4),
        _ev("kernel", "void net_kernel<float>(float*)", 20, 2),
        _ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 12, 2),
        _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 30, 1),
        _ev("gpu_memset", "Memset (Device)", 40, 1),
    ]
    got = summarize(events, wall_us=100.0)
    assert got["device_events"] == 5
    assert got["host_enqueue_calls"] == 2
    assert got["copies"] == {"DtoD": 1, "HtoD": 1}
    assert got["by_name"]["net_kernel"]["count"] == 2
    # union of [10, 14], [12, 14], [20, 22], [30, 31], [40, 41]
    assert got["busy_ms"] == pytest.approx(8e-3)
    assert got["device_span_ms"] == pytest.approx(31e-3)


@pytest.mark.parametrize("call", ["cudaLaunchKernel", "cudaLaunchKernelExC",
                                  "cuLaunchKernel", "cudaMemcpyAsync",
                                  "cudaMemsetAsync"])
def test_summarize_raises_when_enqueued_work_left_no_device_event(call):
    events = [_ev("cpu_op", "aten::add", 0, 5),
              _ev("cuda_runtime", call, 1, 1),
              _ev("cuda_runtime", "cudaDeviceSynchronize", 3, 1)]
    with pytest.raises(RuntimeError, match="no device event"):
        summarize(events, wall_us=10.0)


def test_summarize_accepts_a_trace_without_device_work():
    events = [_ev("cpu_op", "aten::add", 0, 5),
              _ev("cuda_runtime", "cudaDeviceSynchronize", 6, 1)]
    got = summarize(events, wall_us=10.0)
    assert got["device_events"] == 0 and got["copies"] == {}
    assert got["idle_share_of_span"] is None


def test_summarize_counts_launches_whose_device_record_was_lost():
    events = [_ev("cuda_runtime", "cudaLaunchKernel", 0, 1, corr=1),
              _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, corr=2),
              _ev("cuda_runtime", "cudaMemcpyAsync", 4, 1, corr=3),
              _ev("cuda_runtime", "cudaStreamSynchronize", 6, 1, corr=4),
              _ev("kernel", "void k(int)", 10, 2, corr=2)]
    got = summarize(events, wall_us=20.0)
    assert got["host_enqueue_calls"] == 3
    assert got["lost_device_events"] == 2
    events.append(_ev("kernel", "void k(int)", 13, 2, corr=1))
    events.append(_ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 16, 1,
                      corr=3))
    assert summarize(events, wall_us=20.0)["lost_device_events"] == 0


def test_summarize_names_the_host_calls_whose_record_was_lost():
    """``lost_by_call`` counts the lost records by the host call that
    enqueued them, so a caller can tell a lost kernel (its launch still
    counted on the host) from a lost copy (whose direction is then
    unknown)."""
    events = [_ev("cuda_runtime", "cudaLaunchKernel", 0, 1, corr=1),
              _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, corr=2),
              _ev("cuda_runtime", "cudaLaunchKernelExC", 3, 1, corr=3),
              _ev("cuda_runtime", "cudaMemcpyAsync", 4, 1, corr=4),
              _ev("cuda_runtime", "cudaMemsetAsync", 5, 1, corr=5),
              _ev("kernel", "void k(int)", 10, 2, corr=2),
              _ev("gpu_memset", "Memset (Device)", 13, 1, corr=5)]
    got = summarize(events, wall_us=20.0)
    assert got["lost_by_call"] == {"cudaLaunchKernel": 1,
                                   "cudaLaunchKernelExC": 1,
                                   "cudaMemcpyAsync": 1}
    assert got["lost_device_events"] == 3
    events.append(_ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 16,
                      1, corr=4))
    assert summarize(events, wall_us=20.0)["lost_by_call"] == {
        "cudaLaunchKernel": 1, "cudaLaunchKernelExC": 1}
