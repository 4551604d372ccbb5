"""The port's data-prep tool and planted-partition generator against the
JAX package's: the same files byte for byte, the same draws bitwise."""

from __future__ import annotations

import os

import numpy as np
import pytest

from neutronstarlite_tpu.graph import prep as j_prep
from neutronstarlite_tpu.graph import synthetic as j_synthetic

from neutronstarlite_torch.graph import prep as t_prep
from neutronstarlite_torch.graph import synthetic as t_synthetic
from neutronstarlite_torch.graph.dataset import GNNDatum
from neutronstarlite_torch.graph.storage import load_edges

FILES = ("edge.bin", "featuretable.npy", "labeltable", "mask")


def _same_files(a: str, b: str, name: str) -> None:
    for suffix in FILES:
        with open(os.path.join(a, name, f"{name}.{suffix}"), "rb") as fa, \
                open(os.path.join(b, name, f"{name}.{suffix}"), "rb") as fb:
            assert fa.read() == fb.read(), suffix


@pytest.mark.parametrize("kw", [
    dict(v_num=500, classes=7, avg_degree=4.0),
    dict(v_num=1000, classes=41, avg_degree=10.0, feature_size=33, p_in=0.7, seed=5),
    dict(v_num=64, classes=3, avg_degree=0.5, feature_noise=0.0, seed=2),
])
def test_planted_partition_graph_is_bitwise_jax(kw):
    got = t_synthetic.planted_partition_graph(**kw)
    want = j_synthetic.planted_partition_graph(**kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def test_prep_citeseer_is_byte_equal_to_jax(tmp_path):
    """citeseer (3,327 vertices, 3,703 features, seed 0) from both tools."""
    t_info = t_prep.prepare("citeseer", str(tmp_path / "t"))
    j_info = j_prep.prepare("citeseer", str(tmp_path / "j"))
    assert (t_info["v_num"], t_info["e_num"]) == (j_info["v_num"], j_info["e_num"])
    _same_files(str(tmp_path / "t"), str(tmp_path / "j"), "citeseer")


def test_prep_cli_writes_what_the_loader_reads(tmp_path, capsys):
    """pubmed through the CLI at another degree and seed, read back by the
    port's loaders: the split sizes, the planted labels, the self loops."""
    argv = ["--dataset", "pubmed", "--out", str(tmp_path), "--avg-degree", "3",
            "--seed", "4"]
    assert t_prep.main(argv) == 0
    assert "e_num: " in capsys.readouterr().out
    j_prep.main(argv[:3] + [str(tmp_path / "j")] + argv[4:])
    _same_files(str(tmp_path), str(tmp_path / "j"), "pubmed")
    base = os.path.join(tmp_path, "pubmed", "pubmed")
    v, f = 19717, 500
    src, dst = load_edges(base + ".edge.bin")
    assert len(src) == int(v * 3) + 2 * v  # the generator's loops and prep's
    d = GNNDatum.read_feature_label_mask(base + ".featuretable.npy", base + ".labeltable",
                                         base + ".mask", v, f)
    assert d.feature.shape == (v, f)
    assert np.bincount(d.mask, minlength=3).tolist() == [60, 500, v - 560]
    want = t_synthetic.planted_partition_graph(v, 3, 3.0, feature_size=f, seed=4)[3]
    assert np.array_equal(d.label, want)


@pytest.mark.skipif(not os.path.isdir(j_prep.REFERENCE_DATA),
                    reason=f"the cora branch converts {j_prep.REFERENCE_DATA}, "
                    "which this machine does not have")
def test_prep_cora_is_byte_equal_to_jax(tmp_path):
    """The port is given the directory the JAX tool reads."""
    t_prep.prepare("cora", str(tmp_path / "t"), reference_data=j_prep.REFERENCE_DATA)
    j_prep.prepare("cora", str(tmp_path / "j"))
    _same_files(str(tmp_path / "t"), str(tmp_path / "j"), "cora")


def test_prep_cora_needs_its_reference_directory(tmp_path):
    with pytest.raises(ValueError, match="--reference-data"):
        t_prep.prepare("cora", str(tmp_path))
    with pytest.raises(SystemExit):
        t_prep.main(["--dataset", "cora", "--out", str(tmp_path), "--reference-data"])
    with pytest.raises(ValueError, match="--reference-data"):
        t_prep.main(["--dataset", "cora", "--out", str(tmp_path)])


def test_prep_refuses_an_unknown_dataset(tmp_path):
    with pytest.raises(KeyError, match="unknown dataset"):
        t_prep.prepare("ogbn", str(tmp_path))
