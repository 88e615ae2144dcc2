"""The trace reading on a small synthetic chrome trace."""

from benchmark.harness import trace as tr


def _trace():
    X = lambda name, cat, ts, dur: {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    return {"traceEvents": [
        X(tr.SPAN, "user_annotation", 1000, 100),
        X("void banded_bwd_kernel<float>(Args)", "kernel", 1010, 20),
        X("void banded_bwd_train_kernel<float>(Args)", "kernel", 1020, 20),
        X("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 1060, 10),
        X("void banded_fwd_vit_kernel<float>(Args)", "kernel", 1095, 20),
        X("bench.dispatch", "user_annotation", 1040, 25),
        X("aten::copy_", "cpu_op", 1041, 18),
        X("cudaStreamSynchronize", "cuda_runtime", 1071, 22),
        {"ph": "M", "name": "process_name"},
    ]}


def test_trace_summary_busy_and_gaps():
    s = tr.trace_summary(_trace(), 10)
    # busy [1010, 1040) + [1060, 1070) + [1095, 1100) = 45 us of 100
    assert s["wall_ms"] == 0.1
    assert abs(s["busy_ms"] - 0.045) < 1e-12 and abs(s["busy_share"] - 0.45) < 1e-12
    gaps = [(g["start_ms"], g["ms"]) for g in s["longest_gaps"]]
    assert [round(m * 1e3) for _, m in gaps] == [25, 20, 10]
    # the 1070-1095 gap: the runtime call covers it, the copy op does not
    assert s["longest_gaps"][0]["host"][0][0] == "cudaStreamSynchronize"
    assert s["longest_gaps"][1]["host"][0][0] == "aten::copy_"


def test_kernel_seconds_clip_and_match_whole_names():
    ks = tr.kernel_seconds(_trace())
    assert abs(ks["void banded_fwd_vit_kernel<float>(Args)"] - 5e-6) < 1e-15
    assert abs(tr.matching(ks, ["banded_bwd_kernel"]) - 20e-6) < 1e-15
    assert abs(tr.matching(ks, ["banded_bwd_kernel", "banded_bwd_train_kernel"]) - 40e-6) < 1e-15
    b = tr.breakdown(_trace(), tr.trace_summary(_trace(), 10))
    assert [n for n, _ in b["device_ops"]][:2] == ["banded_bwd_kernel<float>",
                                                   "banded_bwd_train_kernel<float>"]
    assert b["idle_gaps"][0][0].startswith("cudaStreamSynchronize")
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_host_reader_leaves_out_cuda_calls():
    """The engine's host time: the dispatch and collect spans, less the
    union of the CUDA runtime and driver calls inside them (nested or
    reaching past a span's end); a call outside the spans changes nothing."""
    import os

    from conftest import ROOT

    from benchmark.harness.main import load_file

    reader = load_file(os.path.join(ROOT, "benchmark", "metrics",
                                    "engine.host_ms_per_read.basic.py"), "host_reader")
    X = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name,
                                    "ts": ts, "dur": dur}
    events = [X("user_annotation", "bench.dispatch", 0, 100),
              X("user_annotation", "bench.collect", 200, 100),
              X("user_annotation", "bench.format", 300, 50),
              X("cuda_runtime", "cudaLaunchKernel", 10, 20),
              X("cuda_driver", "cuLaunchKernel", 15, 10),
              X("cuda_runtime", "cudaEventSynchronize", 250, 150),
              X("cuda_runtime", "cudaMemcpyAsync", 150, 10),
              X("cpu_op", "aten::copy_", 40, 30)]
    assert reader.read({"events": events, "reads": 2}) == (200 - 20 - 50) / 1e3 / 2
    assert reader.read({"events": events, "reads": 0}) is None
    assert reader.read({"events": events[2:], "reads": 2}) is None
