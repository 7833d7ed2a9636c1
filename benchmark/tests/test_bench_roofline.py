"""The roofline arithmetic against the kernel table's bounds (every tap,
as today's kernels compute) and the least time of the work (valid taps)."""

import pytest

from benchmark import roofline


def test_conv_stats_bound_of_15_sites():
    sites = roofline.conv_stats_sites(8, 256)
    assert len(sites) == 15
    assert roofline.ops_seconds(sites, every_tap=True) * 1e3 == \
        pytest.approx(2.006, abs=5e-4)
    # the padding's zero taps are 11.7% of the products at these sites
    assert roofline.ops_seconds(sites) * 1e3 == pytest.approx(1.771, abs=5e-4)
    # every site is bound by its operations
    assert roofline.bound_seconds(sites) == roofline.ops_seconds(sites)


@pytest.mark.parametrize("batch,ms,valid_ms", [(8, 2.038, 1.803),
                                               (16, 4.076, 3.606)])
def test_conv_bn_act_bound(batch, ms, valid_ms):
    sites = roofline.conv_bn_act_sites(batch, 256, bf16=True)
    assert len(sites) == 19
    assert roofline.ops_seconds(sites, every_tap=True) * 1e3 == \
        pytest.approx(ms, abs=5e-4)
    assert roofline.ops_seconds(sites) * 1e3 == \
        pytest.approx(valid_ms, abs=5e-4)
    # the stem is bound by its bytes, so the least time is a little more
    assert roofline.bound_seconds(sites) > roofline.ops_seconds(sites)
    bf16_sites = [s.name for s in sites if s.products == 2]
    assert bf16_sites == ["rm1.b1.conv1", "rm2.b1.conv1", "rm3.b1.conv1"]


def test_fused_sites_take_339_gflop_per_batch_of_8():
    sites = roofline.conv_bn_act_sites(8, 256, bf16=True)
    assert 2 * sum(s.every_tap_macs for s in sites) == 338_681_659_392
    # valid taps: fewer; a 4 x 4 image keeps 10 of 12 (row, tap) pairs a side
    assert 2 * sum(s.macs for s in sites) < 338_681_659_392
    site = roofline.Site("x", 1, 4, 4, 1, 1, 1, 4, 3)
    assert site.macs == 10 * 10 and site.every_tap_macs == 9 * 16


def test_f32_serving_takes_three_products_everywhere():
    sites = roofline.conv_bn_act_sites(8, 256, bf16=False)
    assert {s.products for s in sites} == {3}
