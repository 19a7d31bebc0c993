"""The port's Reddit-scale banded generator, on the CPU.

The generator draws with torch (on the card in ``chip_smoke.py``), so its
graph is not the numpy original's edge for edge: what must carry over is
the law of its band widths and the shape of the graph it returns.
"""
import numpy as np
import pytest
import torch

from adaqp_tpu_torch.helper.dataset import synth_reddit, zipf_clipped


@pytest.mark.parametrize("cap", [1, 40, 5000])
def test_zipf_clipped_has_numpys_law(cap):
    m = 400_000
    got = zipf_clipped(m, cap, torch.Generator().manual_seed(0)).numpy()
    want = np.minimum(np.random.default_rng(0).zipf(1.3, m), cap)
    assert got.min() >= 1 and got.max() <= cap
    ks = np.arange(1, min(cap, 60) + 1)
    p_got = np.array([(got == k).mean() for k in ks])
    p_want = np.array([(want == k).mean() for k in ks])
    # two samples of 400k draws: each frequency within ~5 sigma (<= 0.005)
    np.testing.assert_allclose(p_got, p_want, atol=0.005)
    np.testing.assert_allclose((got == cap).mean(), (want == cap).mean(), atol=0.005)


def test_synth_reddit_shape():
    n, e = 4096, 4096 * 60
    g = synth_reddit(n, e, f=24, c=5, seed=3)
    assert (g.num_nodes, g.num_edges, g.num_feats, g.num_classes) == (n, e, 24, 5)
    assert g.src.dtype == g.dst.dtype == np.int32 and g.feats.dtype == np.float32
    keys = g.src.astype(np.int64) * n + g.dst
    assert len(np.unique(keys)) == e  # unique directed pairs
    assert (np.diff(g.dst) >= 0).all()  # sorted by destination
    loops = g.src == g.dst
    assert loops.sum() == n and set(g.src[loops]) == set(range(n))
    # banded: most edges stay near the diagonal (zipf widths), some do not
    delta = np.abs(g.src - g.dst)[~loops]
    delta = np.minimum(delta, n - delta)
    assert 0.5 < (delta <= 64).mean() < 0.95 and delta.max() > n // 4
    masks = np.stack([g.train_mask, g.val_mask, g.test_mask]).astype(int)
    assert (masks.sum(0) == 1).all() and 0.6 < g.train_mask.mean() < 0.72
    assert set(np.unique(g.labels)) == set(range(5))
    again = synth_reddit(n, e, f=24, c=5, seed=3)
    np.testing.assert_array_equal(again.src, g.src)
    np.testing.assert_array_equal(again.feats, g.feats)
    assert not np.array_equal(synth_reddit(n, e, f=24, c=5, seed=4).src, g.src)
