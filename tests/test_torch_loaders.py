"""The port's raw-format dataset loaders against the JAX package's.

Tiny raw files in each loader's exact on-disk format (the DGL Reddit npz
pair; the GraphSAINT directory of Yelp and AmazonProducts; the OGB csv
layout of ogbn-products) go through both packages' loaders, which must
give the same graph array by array: edges with their self-loops,
features (Yelp's scaled by the training rows' statistics), labels, masks,
degrees, and AmazonProducts' reverse Cuthill-McKee relabelling. A missing
file raises the port's error, which names the dataset. Then a short K=1
SAGE run on the Yelp-format files through ``RunConfig.from_yaml("yelp")``
learns.
"""
import gzip
import json

import numpy as np
import pytest
import scipy.sparse as sp

N = 120
LOADERS = {
    "reddit": "load_reddit",
    "yelp": "load_yelp",
    "amazonProducts": "load_amazon_products",
    "ogbn-products": "load_ogbn_products",
}
FORMAT = {"reddit": "reddit", "yelp": "saint", "amazonProducts": "saint",
          "ogbn-products": "ogb"}


def _random_adj(rng, n, avg_deg=6, symmetric=True):
    e = n * avg_deg
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    if symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    a = sp.coo_matrix((np.ones(len(src), np.float32), (src, dst)), shape=(n, n))
    a.sum_duplicates()
    return a.tocsr()


def _write_reddit(d, rng):
    # DGL raw format: reddit_data.npz (feature/label/node_types) +
    # reddit_graph.npz (scipy sparse adjacency)
    d.mkdir()
    feats = rng.normal(size=(N, 20)).astype(np.float32)
    labels = rng.integers(0, 41, N).astype(np.int64)
    types = rng.choice([1, 2, 3], N, p=[0.66, 0.1, 0.24])
    np.savez(d / "reddit_data.npz", feature=feats, label=labels, node_types=types)
    sp.save_npz(str(d / "reddit_graph.npz"), _random_adj(rng, N))
    return str(d)


def _write_saint(d, rng):
    # GraphSAINT raw format: adj_full.npz, feats.npy, class_map.json, role.json
    d.mkdir()
    sp.save_npz(str(d / "adj_full.npz"), _random_adj(rng, N))
    np.save(d / "feats.npy", rng.normal(size=(N, 12)).astype(np.float32))
    class_map = {str(i): rng.integers(0, 2, 5).tolist() for i in range(N)}
    with open(d / "class_map.json", "w") as f:
        json.dump(class_map, f)
    perm = rng.permutation(N)
    role = {
        "tr": perm[: int(0.6 * N)].tolist(),
        "va": perm[int(0.6 * N): int(0.8 * N)].tolist(),
        "te": perm[int(0.8 * N):].tolist(),
    }
    with open(d / "role.json", "w") as f:
        json.dump(role, f)
    return str(d)


def _write_ogb(d, rng):
    # OGB raw csv layout: <root>/ogbn_products/raw/*.csv.gz +
    # split/sales_ranking/{train,valid,test}.csv.gz
    base = d / "ogbn_products"
    (base / "raw").mkdir(parents=True)
    (base / "split" / "sales_ranking").mkdir(parents=True)

    def put(relpath, arr, fmt):
        with gzip.open(str(base / relpath), "wt") as f:
            np.savetxt(f, arr, delimiter=",", fmt=fmt)

    adj = _random_adj(rng, N).tocoo()
    put("raw/num-node-list.csv.gz", np.array([[N]]), "%d")
    put("raw/edge.csv.gz", np.stack([adj.row, adj.col], 1), "%d")
    put("raw/node-feat.csv.gz", rng.normal(size=(N, 10)).astype(np.float32), "%.6f")
    put("raw/node-label.csv.gz", rng.integers(0, 47, (N, 1)), "%d")
    perm = rng.permutation(N)
    put("split/sales_ranking/train.csv.gz", perm[: int(0.6 * N)][:, None], "%d")
    put("split/sales_ranking/valid.csv.gz", perm[int(0.6 * N): int(0.8 * N)][:, None], "%d")
    put("split/sales_ranking/test.csv.gz", perm[int(0.8 * N):][:, None], "%d")
    return str(d)


@pytest.fixture(scope="module")
def raw_dirs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(0)
    return {"reddit": _write_reddit(tmp / "reddit", rng),
            "saint": _write_saint(tmp / "saint", rng),
            "ogb": _write_ogb(tmp / "ogb", rng)}


FIELDS = ("src", "dst", "feats", "labels", "train_mask", "val_mask", "test_mask",
          "in_degrees", "out_degrees")


def _same_graph(got, want):
    assert (got.num_nodes, got.num_classes, got.multilabel, got.name) == \
        (want.num_nodes, want.num_classes, want.multilabel, want.name)
    for field in FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("name", list(LOADERS))
def test_loader_matches_jax(raw_dirs, name):
    from adaqp_tpu.helper import dataset as jdataset
    from adaqp_tpu_torch.helper import dataset

    raw = raw_dirs[FORMAT[name]]
    got = getattr(dataset, LOADERS[name])(raw)
    _same_graph(got, getattr(jdataset, LOADERS[name])(raw))
    _same_graph(dataset.load_dataset(name, raw), got)
    assert got.num_nodes == N and (got.src == got.dst).sum() == N  # one self-loop a node
    assert (got.train_mask | got.val_mask | got.test_mask).all()
    assert not (got.train_mask & got.val_mask).any()
    assert got.is_bidirected
    assert got.multilabel == (FORMAT[name] == "saint")


def test_amazon_products_is_yelp_relabelled(raw_dirs):
    from adaqp_tpu_torch.helper import dataset

    yelp = dataset.load_yelp(raw_dirs["saint"])
    amazon = dataset.load_amazon_products(raw_dirs["saint"])
    # the relabelling is a permutation of the nodes: find it from the
    # features (random rows, all distinct) and check every array through it
    rows = {row.tobytes(): i for i, row in enumerate(yelp.feats)}
    perm = np.array([rows[row.tobytes()] for row in amazon.feats])
    assert not np.array_equal(perm, np.arange(N))
    np.testing.assert_array_equal(np.sort(perm), np.arange(N))
    for field in ("labels", "train_mask", "val_mask", "test_mask", "in_degrees"):
        np.testing.assert_array_equal(getattr(amazon, field), getattr(yelp, field)[perm])
    inv = np.empty(N, np.int64)
    inv[perm] = np.arange(N)
    edges = set(zip(inv[yelp.src].tolist(), inv[yelp.dst].tolist()))
    assert edges == set(zip(amazon.src.tolist(), amazon.dst.tolist()))
    # Yelp's features are scaled by the training rows' statistics
    tr = yelp.feats[yelp.train_mask]
    np.testing.assert_allclose(tr.mean(0), 0.0, atol=1e-4)
    np.testing.assert_allclose(tr.std(0), 1.0, atol=1e-2)


@pytest.mark.parametrize("name", list(LOADERS))
def test_missing_raw_files_raise(tmp_path, name):
    from adaqp_tpu_torch.helper.dataset import load_dataset

    with pytest.raises(FileNotFoundError, match=name):
        load_dataset(name, str(tmp_path / "nope"))


def test_yelp_format_sage_run_learns(raw_dirs, tmp_path):
    from adaqp_tpu_torch.trainer import RunConfig, Trainer

    cfg = RunConfig.from_yaml("yelp", {
        "raw_dir": raw_dirs["saint"], "num_parts": 1, "num_epochs": 8, "hidden_dim": 16,
        "num_layers": 2, "mode": "Vanilla", "log_steps": 100, "measure_breakdown": False,
        "logger_level": "WARNING", "partition_dir": str(tmp_path / "parts"),
        "exp_path": str(tmp_path / "exp"),
    })
    assert (cfg.model_name, cfg.aggregator_type, cfg.agg_dtype) == ("sage", "mean", "bfloat16")
    t = Trainer(cfg, device="cpu")
    assert t.static.multilabel and t.static.num_classes == 5 and t.static.f_true == 12
    rec = t.train()
    losses = rec["loss_curve"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    _, train_f1, val_f1, _ = rec["best"]  # micro-F1
    assert 0.0 < val_f1 <= 1.0 and 0.0 < train_f1 <= 1.0
