"""The reduction of a Chrome trace: the window, busy time, kernels under
convolution operators, idle gaps named by the host's span."""
from benchmark.trace import reduce_events


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def test_reduce_events():
    ev = [
        _x("user_annotation", "bench.window", 100, 1000),
        _x("user_annotation", "bench.dispatch", 100, 300),
        _x("user_annotation", "bench.fetch", 400, 700),
        _x("cpu_op", "aten::convolution", 110, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 120, 5, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 200, 5, correlation=2),
        # the backward's convolution on another thread
        _x("cpu_op", "aten::convolution_backward", 300, 40, tid=2),
        _x("cuda_driver", "cuLaunchKernel", 310, 5, tid=2, correlation=3),
        _x("kernel", "cudnn_gemm", 150, 100, tid=7, correlation=1),
        _x("kernel", "bilinear_gather_kernel<2, float>", 250, 50, tid=7,
           correlation=2),
        _x("kernel", "wgrad", 320, 30, tid=7, correlation=3),
        # a second stream's convolution kernel overlapping the first
        _x("kernel", "fft", 200, 100, tid=9, correlation=1),
        _x("gpu_memcpy", "Memcpy DtoH", 600, 100, tid=8),
        # partly outside the window: clipped
        _x("kernel", "late", 1050, 100, tid=7, correlation=9),
    ]
    tr = reduce_events(ev)
    assert tr.window_s == 1000e-6
    assert abs(tr.busy_s - (150 + 30 + 100 + 50) * 1e-6) < 1e-12
    # 150-300 and 320-350: the overlap counts once
    assert abs(tr.conv_s - 180e-6) < 1e-12
    assert abs(tr.kernel_seconds("bilinear_gather_kernel") - 50e-6) < 1e-12
    # gaps: 100-150 (dispatch), 300-320 (dispatch), 350-600 (fetch),
    # 700-1050 (fetch)
    assert tr.gaps[0][0] == "fetch" and abs(tr.gaps[0][1] - 350e-6) < 1e-12
    assert [g[0] for g in tr.gaps] == ["fetch", "fetch", "dispatch",
                                       "dispatch"]
    b = tr.breakdown()
    assert b["device_ops"][0][0] == "cudnn_gemm"
    assert len(b["idle_gaps"]) == 4
