"""The device timeline's reduction: busy time is the union of operations
(overlaps count once), idle the rest of the traced window, gaps named by the
host operation around them."""

import pytest

from benchmark.harness.trace import NO_OP, Summary, canonical, union


def test_union_merges_overlaps_and_keeps_gaps():
    assert union([(0, 2), (1, 3), (5, 6), (6, 7), (8, 8.5)]) == [(0, 3), (5, 7), (8, 8.5)]


def test_busy_and_idle_on_a_timeline_with_overlaps_and_gaps():
    s = Summary()
    requests = [(0.0, 4.0), (4.0, 10.0)]
    device = [("void k_a<1>(float*)", 1.0, 3.0),  # overlaps the next
              ("k_b", 2.0, 4.0),
              ("k_a", 6.0, 7.0),
              ("k_c", 9.5, 11.0)]  # runs past the window: clipped to 10
    host = [("aten::mm", 0.0, 1.5), ("aten::item", 4.0, 6.0), ("cudaLaunchKernel", 4.5, 5.5)]
    s.add_cycle(requests, device, host)
    assert s.window_s == 10.0
    assert s.busy_s == pytest.approx(3.0 + 1.0 + 0.5)
    assert s.idle_share == pytest.approx(1 - 4.5 / 10)
    assert s.ops["k_a"] == [2, 3.0]
    assert s.ops["k_c"] == [1, pytest.approx(0.5)]
    gaps = s.breakdown()["idle_gaps"]
    # gaps: [0, 1] under aten::mm, [4, 6] (middle 5: innermost cudaLaunchKernel),
    # [7, 9.5] outside any op
    assert gaps[0] == [NO_OP, 2.5]
    assert gaps[1] == ["cudaLaunchKernel", 2.0]
    assert gaps[2] == ["aten::mm", 1.0]


def test_cycles_add_up():
    s = Summary()
    s.add_cycle([(0.0, 1.0)], [("k", 0.0, 0.5)], [])
    s.add_cycle([(5.0, 7.0)], [("k", 5.0, 6.0)], [])
    assert s.window_s == 3.0 and s.busy_s == 1.5 and s.requests == 2
    assert s.seconds_of(["k"]) == 1.5 and s.launches_of(["k"]) == 2


def test_breakdown_keeps_ten_of_each_with_all_digits():
    s = Summary()
    device = [(f"k{i}", float(i), i + 0.5 + i / 1000) for i in range(12)]
    s.add_cycle([(0.0, 12.0)], device, [])
    b = s.breakdown()
    assert len(b["device_ops"]) == 10 and len(b["idle_gaps"]) == 10
    assert b["device_ops"][0] == ["k11", pytest.approx(0.511)]


def test_canonical_names():
    assert canonical("void (anonymous namespace)::masked_attention_kernel<64, 3>(CUtensorMap)") \
        == "masked_attention_kernel"
    assert canonical("ampere_bf16_s16816gemm_bf16_128x128_tn") == \
        "ampere_bf16_s16816gemm_bf16_128x128_tn"
    assert canonical("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
    assert canonical("void at::native::(anonymous namespace)::softmax_warp_forward<float, 4>"
                     "(float*, float const*, int)") == "softmax_warp_forward"
    assert canonical("void at::native::elementwise_kernel<128, 2>(int)") == "elementwise_kernel"
