"""The metric arithmetic against hand counts at small shapes."""

import pytest

from portbench import devtime, harness, work


def test_attention_and_dense_work_by_hand():
    # BH=2, S=4, Dh=8: 4*2*16*8 = 1024 ops; q, k, v, O = 4*2*4*8 floats, LSE 2*4.
    assert work.attention_work(2, 4, 8) == (1024.0, 4 * (4 * 64) + 4 * 8)
    assert work.dense_work(3, 4, 5) == (120.0, 4.0 * (12 + 20 + 5 + 15))
    assert work.bound_seconds(989e12, 0.0) == pytest.approx(1.0)
    assert work.bound_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert work.roofline_percent(1.0, 4.0) == 25.0
    assert work.roofline_percent(1.0, 0.0) is None


def test_sequence_score_flops_by_hand():
    cfg = {"d_model": 4, "n_heads": 2, "n_layers": 1, "d_ff": 8, "in_dim": 3}
    b, s = 2, 5
    n = b * s
    dense = 2 * n * 3 * 4 + 2 * n * (4 * 12 + 4 * 4 + 4 * 8 + 8 * 4) + 2 * b * 4 * 1
    att = 4 * (b * 2) * s * s * 2
    assert work.sequence_score_flops(cfg, b, s) == dense + att
    # Config 3's extra-long point is 146.1 GFLOP a call, attention 137.4 of it.
    big = {"d_model": 128, "n_heads": 2, "n_layers": 2, "d_ff": 256, "in_dim": 12}
    assert work.sequence_score_flops(big, 2, 8192) == pytest.approx(146.1e9, rel=0.001)
    assert 2 * work.attention_work(4, 8192, 64)[0] == pytest.approx(137.4e9, rel=0.001)


def _events():
    m = devtime.MARKER
    # name, on_device, start_ns, end_ns, thread: a 1 s window, kernels busy
    # 0.1-0.3 and 0.25-0.5 (overlapping) and 0.7-0.8 s; the host in
    # "launch" over 0.5-0.7 s.
    return [(m, False, 0, 10**9, 1),
            ("k1", True, 10**8, 3 * 10**8, 0), ("k2", True, 25 * 10**7, 5 * 10**8, 0),
            ("k1", True, 7 * 10**8, 8 * 10**8, 0),
            ("launch", False, 5 * 10**8, 7 * 10**8, 7)]


def test_trace_reduction_by_hand():
    s = devtime.reduce_events(_events())
    assert s["window_s"] == pytest.approx(1.0)
    assert s["busy_s"] == pytest.approx(0.5)
    assert s["kernels"]["k1"] == {"seconds": pytest.approx(0.3), "count": 2}
    assert devtime.kernel_seconds(s, "k2") == (pytest.approx(0.25), 1)
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps["thread_7: launch"] == pytest.approx(0.2)
    assert gaps["unattributed"] == pytest.approx(0.1 + 0.2)


def test_trace_without_device_work_is_refused():
    with pytest.raises(RuntimeError):
        devtime.reduce_events([(devtime.MARKER, False, 0, 10, 1)])


def test_readers_by_hand():
    s = devtime.reduce_events(_events())
    idle = harness.metric_reader("device_idle.score")({"trace": s})
    assert idle == pytest.approx(50.0)
    run = {"trace": {"window_s": 2.0}, "steps": 3, "batch": 2, "seq_len": 5,
           "config": {"d_model": 4, "n_heads": 2, "n_layers": 1, "d_ff": 8, "in_dim": 3}}
    mfu = harness.metric_reader("mfu.score")(run)
    flops = 3 * work.sequence_score_flops(run["config"], 2, 5)
    assert mfu == pytest.approx(100.0 * flops / 2.0 / 989e12)


def test_kernel_readers_by_hand():
    cfg = {"d_model": 128, "n_heads": 2, "n_layers": 2, "d_ff": 256, "in_dim": 12}
    att = work.bound_seconds(*work.attention_work(4, 8192, 64))
    dense = sum(work.bound_seconds(*work.dense_work(*s))
                for s in work.sequence_dense_shapes(cfg, 2, 8192))
    # Ten calls: the forward kernel at a quarter of its bound, the dense
    # kernel at a tenth.
    kernels = {"flash_attention_fwd_kernel<64>": {"seconds": 10 * 2 * att * 4, "count": 20},
               "dense_fixed_kernel<true>": {"seconds": 10 * dense * 10, "count": 100}}
    run = {"trace": {"kernels": kernels}, "config": cfg, "steps": 10, "batch": 2, "seq_len": 8192}
    assert harness.metric_reader("attn_roofline.score")(run) == pytest.approx(25.0)
    assert harness.metric_reader("dense_f32_roofline.score")(run) == pytest.approx(10.0)
    empty = {**run, "trace": {"kernels": {}}}
    assert harness.metric_reader("attn_roofline.score")(empty) is None
    assert harness.metric_reader("dense_f32_roofline.score")(empty) is None
