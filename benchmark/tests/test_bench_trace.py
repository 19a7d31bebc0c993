"""The trace's reduction and the per-layer readers on traces made by hand."""
from benchmark import harness, trace

AGG = ("bench.stretch", "bench.step", "bench.agg")
BWD = ("bench.stretch", "bench.step", trace.BACKWARD_PREFIX + "ReverseSpmmBackward")
STEP = ("bench.stretch", "bench.step")


def _trace():
    return {"window": (0.0, 100.0), "epochs": 2,
            "device": [("strip_kernel", 10.0, 30.0, AGG), ("copy", 20.0, 40.0, AGG),
                       ("strip_kernel", 50.0, 60.0, BWD), ("gemm", 70.0, 75.0, STEP)],
            "host": [("aten::mm", 40.0, 50.0), ("aten::add", 76.0, 99.0), ("outer", 0.0, 100.0)],
            "strip_calls": [({"edges": 10, "src_rows": 5, "out_rows": 8}, 4, 2)] * 2}


def test_busy_and_gaps():
    tr = _trace()
    assert trace.busy_intervals(tr["device"], tr["window"]) == [(10, 40), (50, 60), (70, 75)]
    assert trace.busy_us(tr) == 45.0
    gaps = trace.idle_gaps(tr)
    # 75..100, the innermost op at 87.5; then 0..10, 40..50, 60..70
    assert [g[0] for g in gaps] == ["aten::add", "outer", "aten::mm", "outer"]
    assert [round(g[1] * 1e6, 9) for g in gaps] == [25.0, 10.0, 10.0, 10.0]
    assert trace.device_ops(tr)[0][0] == "strip_kernel"


def test_readers():
    tr = _trace()
    rec = {"chips": 1, "epoch_s": 0.5, "flops_per_epoch": 989e12 * 0.5 * 0.01,
           "trainer_init_s": 3.0, "ranks": [{"trainer_init_s": 3.0, "trace": tr}]}
    assert harness.read_metric("agg_ms", rec) == (20 + 20 + 10) / 2 * 1e-3
    assert abs(harness.read_metric("idle_pct", rec) - 55.0) < 1e-9
    nbytes = 2 * (4 * 10 + (5 + 8) * 4 * 2)
    want = 100 * nbytes / 3.35e12 / 30e-6
    assert abs(harness.read_metric("strip_roofline_pct", rec) - want) < 1e-9
    assert abs(harness.read_metric("mfu_pct", rec) - 1.0) < 1e-12
    assert harness.read_metric("trainer_init_s", rec) == 3.0


def test_readers_find_nothing_without_a_trace():
    rec = {"chips": 1, "epoch_s": 0.5, "flops_per_epoch": 1.0, "trainer_init_s": 3.0,
           "ranks": [{"trainer_init_s": 3.0}]}
    for name in ("agg_ms", "idle_pct", "strip_roofline_pct"):
        assert harness.read_metric(name, rec) is None


def test_wrapped_restores_and_carries_counters():
    import types

    mod = types.SimpleNamespace()

    def f(x):
        return x + 1
    f.launches = 3
    mod.f = f

    def counting(fn):
        def call(x):
            call.launches += 1
            return fn(x)
        return call
    with trace.wrapped(mod, "f", counting):
        assert mod.f(1) == 2 and mod.f.launches == 4
    assert mod.f is f and f.launches == 4
