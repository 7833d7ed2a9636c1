"""The benchmark's FLOP count against the recipe's published figures."""

from benchmark import flops


def test_t1_step_flops():
    assert flops.source_step(8, 256) == 940_775_897_088


def test_adapt_step_flops_at_plug_rm3():
    assert flops.adapt_step(8, 256, "rm3") == 979_431_498_752


def test_serving_forward_flops():
    # valid taps over the whole forward; the 19 fused sites alone take
    # 338.7 GFLOP counting every tap (test_bench_roofline)
    assert flops.serve_forward(8, 256, "bfloat16") == 313_805_089_792
    assert flops.serve_forward(16, 256, "bfloat16") == 2 * 313_805_089_792


def test_valid_taps_drop_the_padding():
    # 3 taps over 4 outputs with one pad on each side: 12 - 2
    assert flops.valid_taps(4, 4, 3, 1, 1, 1) == 10
    assert flops.valid_taps(4, 4, 3, 1, 2, 2) == 8
