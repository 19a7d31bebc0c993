"""The generators: sizes, degrees, determinism from the data seed."""
import numpy as np
import pytest

from benchmark import graphs


@pytest.fixture(scope="module")
def banded():
    return graphs.banded(3000, 3000 * 25, 12, 5, data_seed=7, device="cpu")


@pytest.fixture(scope="module")
def rmat():
    return graphs.rmat(4096, 11, 40, 16, data_seed=7, device="cpu")


def test_banded_sizes(banded):
    g = banded
    assert g.num_nodes == 3000 and g.num_edges == 3000 * 25
    key = g.src.astype(np.int64) * g.num_nodes + g.dst
    assert len(np.unique(key)) == g.num_edges  # unique directed pairs
    loops = g.src == g.dst
    assert loops.sum() == g.num_nodes and len(np.unique(g.src[loops])) == g.num_nodes
    assert g.feats.shape == (3000, 12) and g.labels.max() < 5
    assert not (g.train_mask & g.val_mask).any()
    assert (g.train_mask | g.val_mask | g.test_mask).all()
    assert 0.6 < g.train_mask.mean() < 0.72


def test_rmat_sizes(rmat):
    g = rmat
    key = set((g.src.astype(np.int64) * g.num_nodes + g.dst).tolist())
    assert len(key) == g.num_edges
    assert all(d * g.num_nodes + s in key for s, d in zip(g.src[:500], g.dst[:500]))  # symmetric
    assert (g.src == g.dst).sum() == g.num_nodes
    assert 15 < g.num_edges / g.num_nodes < 24  # about Yelp's mean degree
    assert g.multilabel and set(g.labels.sum(1).tolist()) <= {1.0, 2.0}
    assert np.abs(g.feats[g.train_mask].mean(0)).max() < 1e-4
    assert round(g.train_mask.mean(), 2) == 0.6


def test_rmat_keeps_the_pairs_asked_for(rmat):
    g = graphs.rmat(4096, 11, 40, 16, data_seed=7, device="cpu", pairs=30000)
    assert g.num_edges == 2 * 30000 + 4096 < rmat.num_edges
    key = g.src.astype(np.int64) * g.num_nodes + g.dst
    assert len(np.unique(key)) == g.num_edges
    assert set(key.tolist()) == set((g.dst.astype(np.int64) * g.num_nodes + g.src).tolist())
    assert (g.src == g.dst).sum() == g.num_nodes
    with pytest.raises(ValueError):
        graphs.rmat(512, 2, 8, 4, data_seed=7, device="cpu", pairs=512 * 4)


@pytest.mark.parametrize("gen", ["banded", "rmat"])
def test_same_seed_same_arrays(gen):
    make = {"banded": lambda s: graphs.banded(500, 500 * 10, 4, 3, s, "cpu"),
            "rmat": lambda s: graphs.rmat(512, 11, 8, 4, s, "cpu")}[gen]
    a, b, c = make(3), make(3), make(4)
    assert a.digest == b.digest
    assert np.array_equal(a.src, b.src) and np.array_equal(a.feats, b.feats)
    assert a.digest != c.digest


def test_configuration_files_make_their_graphs():
    from benchmark import harness

    for cell in harness.manifest()["workloads"]:
        conf = harness.load_cell(cell["name"])["configuration"]
        assert conf["graph"]["generator"] in graphs.GENERATORS
        assert conf["num_nodes"] >= conf["published"]["num_nodes"] // 4
        if "num_edges" not in conf["reduced"] and conf["graph"]["generator"] == "rmat":
            # the source's directed edges, each pair both ways, self-loops aside
            assert 2 * conf["graph"]["pairs"] == conf["published"]["num_edges"]
