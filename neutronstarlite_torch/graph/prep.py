"""Dataset preparation — port of ``neutronstarlite_tpu/graph/prep.py``.

Writes the nts file formats of a dataset under ``<out>/<name>/``: a binary
edge list (8 bytes per edge, little-endian uint32 pairs),
``<name>.featuretable`` (``ID f0 .. f_{d-1}`` lines, or ``.npy`` when
large), ``<name>.labeltable`` (``ID label``) and ``<name>.mask``
(``ID train|val|test``); the files are byte for byte those of the JAX tool.

- **cora** converts the reference checkout's files (binary edges, label
  and mask tables) from the directory given as ``--reference-data``, which
  cora requires; the feature table, which is not shipped, is drawn from
  the seed.
- **citeseer, pubmed, reddit** are synthesized from the seed with no
  download: a planted-partition graph (``graph/synthetic.py``) at the
  dataset's vertex count, feature width and class count, self loops
  appended, and a random split of the dataset's train / val sizes. Reddit
  is 232,965 vertices at mean degree 50 (``--avg-degree`` to change it)
  with its real split sizes; its features are written as ``.npy``.

Usage: ``python -m neutronstarlite_torch.graph.prep --dataset reddit --out data``
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# (v_num, feature_size, classes, default avg_degree, train/val counts)
DATASETS = {
    "cora": (2708, 1433, 7, None, (140, 500)),
    "citeseer": (3327, 3703, 6, 10, (120, 500)),
    "pubmed": (19717, 500, 3, 10, (60, 500)),
    "reddit": (232965, 602, 41, 50, (153431, 23831)),  # real split sizes
}

def _write_edges_binary(path: str, src: np.ndarray, dst: np.ndarray) -> None:
    np.stack([src.astype("<u4"), dst.astype("<u4")], axis=1).tofile(path)


def _write_feature_table(path: str, feature: np.ndarray, text: bool) -> str:
    if not text:
        path = path + ".npy"
        np.save(path, feature.astype(np.float32))
        return path
    ids = np.arange(feature.shape[0])[:, None].astype(np.float32)
    np.savetxt(path, np.concatenate([ids, feature], axis=1), fmt="%.6g")
    return path


def _write_label_table(path: str, label: np.ndarray) -> None:
    ids = np.arange(len(label))
    np.savetxt(path, np.stack([ids, label], axis=1), fmt="%d")


def _write_mask(path: str, mask: np.ndarray) -> None:
    names = np.array(["train", "val", "test"])
    with open(path, "w") as fh:
        for i, m in enumerate(mask):
            fh.write(f"{i} {names[m]}\n")


def _split_mask(v_num: int, n_train: int, n_val: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    order = rng.permutation(v_num)
    mask = np.full(v_num, 2, dtype=np.int32)
    mask[order[:n_train]] = 0
    mask[order[n_train : n_train + n_val]] = 1
    return mask


def prepare(
    dataset: str,
    out_dir: str,
    avg_degree: float | None = None,
    self_loop: bool = True,
    seed: int = 0,
    text_features: bool = False,
    reference_data: str | None = None,
) -> dict:
    """Write the four nts files for ``dataset`` under ``out_dir/dataset/``;
    cora reads the reference checkout's files from ``reference_data``.

    Returns {edge_file, feature_file, label_file, mask_file, v_num, e_num}.
    """
    if dataset not in DATASETS:
        raise KeyError(f"unknown dataset {dataset!r}; known: {sorted(DATASETS)}")
    if dataset == "cora" and not reference_data:
        raise ValueError("cora converts the reference checkout's data directory: "
                         "give it as --reference-data")
    v_num, f_dim, classes, default_deg, (n_train, n_val) = DATASETS[dataset]
    d = os.path.join(out_dir, dataset)
    os.makedirs(d, exist_ok=True)
    base = os.path.join(d, dataset)

    if dataset == "cora":
        from neutronstarlite_torch.graph.dataset import _read_mask_table
        from neutronstarlite_torch.graph.storage import load_edges_binary

        name = "cora.2708.edge.self" if self_loop else "cora.2708.edge"
        src, dst = load_edges_binary(os.path.join(reference_data, name))
        label = np.zeros(v_num, dtype=np.int64)
        raw = np.loadtxt(os.path.join(reference_data, "cora.labeltable"), dtype=np.int64)
        label[raw[:, 0]] = raw[:, 1]
        mask = _read_mask_table(os.path.join(reference_data, "cora.mask"), v_num)
        rng = np.random.default_rng(seed)
        # class-correlated features (the feature table is not shipped)
        centers = rng.standard_normal((classes, f_dim)).astype(np.float32)
        feature = centers[label] * 0.5 + rng.standard_normal(
            (v_num, f_dim), dtype=np.float32
        )
    else:
        from neutronstarlite_torch.graph.synthetic import planted_partition_graph

        deg = avg_degree if avg_degree is not None else default_deg
        src, dst, feature, label = planted_partition_graph(
            v_num, classes, avg_degree=deg, feature_size=f_dim, seed=seed
        )
        if self_loop:
            loops = np.arange(v_num, dtype=np.uint32)
            src = np.concatenate([src, loops])
            dst = np.concatenate([dst, loops])
        mask = _split_mask(v_num, n_train, n_val, seed)

    edge_file = f"{base}.edge.bin"
    _write_edges_binary(edge_file, src, dst)
    feature_file = _write_feature_table(f"{base}.featuretable", feature, text_features)
    label_file = f"{base}.labeltable"
    _write_label_table(label_file, label)
    mask_file = f"{base}.mask"
    _write_mask(mask_file, mask)
    return {
        "edge_file": edge_file,
        "feature_file": feature_file,
        "label_file": label_file,
        "mask_file": mask_file,
        "v_num": v_num,
        "e_num": len(src),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", required=True, choices=sorted(DATASETS))
    ap.add_argument("--out", default="data")
    ap.add_argument("--avg-degree", type=float, default=None,
                    help="synthetic datasets: edges per vertex "
                    "(reddit real scale is ~492; default 50 keeps prep fast)")
    ap.add_argument("--no-self-loop", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--text-features", action="store_true",
                    help="write the featuretable as text even when large")
    ap.add_argument("--reference-data", default=None,
                    help="cora (required there): the reference checkout's data directory")
    a = ap.parse_args(argv)
    info = prepare(
        a.dataset,
        a.out,
        avg_degree=a.avg_degree,
        self_loop=not a.no_self_loop,
        seed=a.seed,
        text_features=a.text_features,
        reference_data=a.reference_data,
    )
    for k, v in info.items():
        print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
