"""The yardstick's arithmetic against hand counts on toy shapes, and the
trace reduction on a synthetic trace."""

import pytest


def test_kernel_counts_by_hand():
    from port_bench import roofline as r
    assert r.compact_live(10) == (600, 0)
    assert r.expand(5, 100) == (1360, 0)
    # (160 rows' floats + 20 ids + 2 x 4 ranges + 4 x 5 x 256 out) x 4 B;
    # 100 composited pairs x (20 + 2 x 4), 40 evaluated gated pairs x 12
    assert r.composite_fwd(160, 20, 4, 4, 100, 50, 10) == (21232, 3280)
    # gc = round8(6 + 8) = 16; (160 + 40 + 2 x 9216 + 320) x 4 B;
    # 100 x (50 + 24 + 14) + 50 x 12
    assert r.composite_bwd(160, 20, 9216, 8, 100, 50) == (75808, 9400)
    assert r.segment_sum(30, 16, 5) == (2264, 480)
    assert r.grid_sample(100, 3, 50) == (2600, 3600)
    assert r.grid_sample_bwd(100, 3, 300) == (3200, 10400)
    assert r.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert r.bound_s(0, 67e12) == pytest.approx(1.0)


def test_step_and_frame_counts_by_hand():
    from port_bench import roofline as r
    # scene: 3 + 48 + 3 + 4 + 1 + 36 = 95 floats; object: 95 + 87 + 68
    # + 2 = 252; 2 scene, 1 object, 3 x 29 background, 12 sky
    assert r.trainable_floats(2, 1, 16, 12, 29, 17, 29, 12) == 541
    nb, fl = r.train_step_bound(2, 1, 16, 12, 29, 17, 29, 12, 10, 10,
                                100, 50, 10, 8)
    # 541 x 24 + (6 x 10 + 3 x 10) x 4 + 3 x 3 x 8
    assert nb == 13416
    # deform 216 + 310 + 522 + 10; preprocess 3 x (226 + 96); pairs
    # 100 x 36 + 40 x 12; sky and blend 10 x 62; losses 10 x 759; x 3
    assert fl == 3 * (1058 + 966 + 3600 + 480 + 620 + 7590)
    nb, fl = r.render_frame_bound(2, 1, 16, 12, 29, 17, 29, 10, 7, 100, 50,
                                  10, 4, 3)
    assert nb == (541 - 12) * 4 + 7 * 12 + 10 * 3 * 4
    assert fl == 1058 + 966 + 100 * 28 + 40 * 12 + 620


def test_trace_reduction():
    from port_bench import tracing
    ev = [
        dict(ph="X", name=tracing.WINDOW_ANNOTATION, cat="user_annotation",
             ts=0, dur=100),
        dict(ph="X", name="void (anonymous namespace)::composite_fwd_kernel"
             "<4>(float const*)", cat="kernel", ts=10, dur=10),
        dict(ph="X", name="at::native::vectorized_elementwise_kernel",
             cat="kernel", ts=15, dur=15),
        dict(ph="X", name="Memcpy HtoD", cat="gpu_memcpy", ts=50, dur=10),
        dict(ph="X", name="aten::item", cat="cpu_op", ts=28, dur=25),
        dict(ph="X", name="aten::copy_", cat="cpu_op", ts=29, dur=5),
    ]
    out = tracing.reduce(ev)
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["busy_s"] == pytest.approx(30e-6)
    assert out["kernel_s"] == {"B3": pytest.approx(10e-6)}
    # the innermost host op at the gap's start names it
    assert [g[0] for g in out["idle_gaps"]] == ["host idle", "aten::copy_",
                                                "host idle"]
    assert out["idle_gaps"][0][1] == pytest.approx(40e-6)
    assert tracing.hand_kernel("tiles_kernel(int)") == "B5"
    assert tracing.hand_kernel("DeviceScanKernel<int>(int)") is None
