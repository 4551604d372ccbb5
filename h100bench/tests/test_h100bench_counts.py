"""The frozen counts against hand sums at a tiny size."""

import pytest

from h100bench import counts
from h100bench.counts import gat, gcn

V, E = 10, 40


def by_name(terms):
    return {t["name"]: t for t in terms}


def test_gcn_terms_by_hand():
    cfg = {"cfg": {"layer_string": "6-4-3", "precision": "bfloat16"}}
    t = by_name(gcn.epoch_terms(cfg, V, E))
    assert set(t) == {"agg_fwd_0", "bn_stats_0", "mm_fwd_0", "mm_dw_0", "mm_dx_0",
                      "agg_fwd_1", "mm_fwd_1", "mm_dw_1", "mm_dx_1", "agg_bwd_1", "loss", "adam"}
    assert t["agg_fwd_0"]["ops"] == 2 * 40 * 6
    assert t["agg_fwd_0"]["bytes"] == 40 * 8 + 11 * 4 + 2 * 10 * 6 * 2
    assert t["agg_bwd_1"]["ops"] == 2 * 40 * 4
    assert t["mm_fwd_0"]["ops"] == 2 * 10 * 6 * 4 and t["mm_fwd_0"]["peak"] == "bfloat16"
    assert t["mm_fwd_0"]["bytes"] == 2 * (10 * 6 + 6 * 4 + 10 * 4)
    assert t["loss"]["bytes"] == 4 * 10 * 3
    assert t["adam"]["bytes"] == 28 * (6 * 4 + 2 * 6 + 4 * 3)


def test_gat_terms_by_hand():
    cfg = {"cfg": {"layer_string": "6-4-3"}}
    t = by_name(gat.epoch_terms(cfg, V, E))
    assert "mm_dx_0" not in t and "mm_dx_1" in t
    assert t["agg_fwd_1"]["ops"] == 2 * 40 * 3
    assert t["agg_fwd_1"]["bytes"] == 40 * 8 + 11 * 4 + 2 * 10 * 3 * 4
    assert t["grad_alpha_0"]["ops"] == 2 * 40 * 4
    assert t["edge_softmax_0"]["bytes"] == 0.0
    assert t["adam"]["bytes"] == 28 * (6 * 4 + 2 * 4 + 4 * 3 + 2 * 3)


def test_least_time_is_the_larger_bound_summed():
    terms = [counts.term("a", "x", 67e9, 0.0, "float32"),
             counts.term("b", "y", 0.0, 3.35e9, "float32"),
             counts.term("c", "x", 989e9, 3.35e9, "bfloat16")]
    assert counts.least_ms(terms) == pytest.approx(1.0 + 1.0 + 1.0)
    assert counts.least_ms(terms, ["x"]) == pytest.approx(2.0)


def test_reddit_aggregation_bound_matches_the_ports_roofline():
    # the ELL kernel's bound the port's PERF.md records at Reddit's size
    cfg = {"cfg": {"layer_string": "602-128-41", "precision": "bfloat16"}}
    t = gcn.epoch_terms(cfg, 232965, 114615892)
    assert counts.least_ms(t, ["aggregation"]) == pytest.approx(2.9355, abs=1e-3)
    t = gat.epoch_terms({"cfg": {"layer_string": "602-128-41"}}, 232965, 114615892)
    assert counts.least_ms(t, ["aggregation"]) == pytest.approx(1.4695, abs=1e-3)
