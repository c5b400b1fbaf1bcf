"""The f32 re-search's cuBLAS calls (``ops/similarity._f32_scores``):
every product is one ``torch.matmul`` of one shape, F32_RESEARCH_MIN_ROWS
query rows by ``_research_cols(n_refs)`` corpus rows, its column blocks cut
at the same corpus rows whether the corpus is one tensor or shards in
separate allocations (one a card). So the sharded searcher's re-searched
scores are the single-device searcher's, bit for bit."""

import numpy as np
import pytest
import torch

from vsc2022_torch.ops import similarity
from vsc2022_torch.ops.similarity import COLLECTION_ENV, SimilaritySearcher
from vsc2022_torch.parallel import Mesh
from vsc2022_torch.parallel import sharded_search
from vsc2022_torch.parallel.sharded_search import ShardedSimilaritySearcher


@pytest.mark.parametrize("n_refs,base,n", [(1000, 0, 1000), (1000, 300, 500),
                                           (20000, 8000, 9000), (20000, 16384, 3616),
                                           (140000, 60000, 80000)])
def test_f32_scores_are_the_product_of_any_run_of_rows(n_refs, base, n):
    rng = np.random.RandomState(n)
    rows = torch.from_numpy(rng.randint(-3, 4, size=(37, 24)).astype(np.float32))
    refs = torch.from_numpy(rng.randint(-3, 4, size=(n_refs, 24)).astype(np.float32))
    got = similarity._f32_scores(rows, refs[base : base + n], n_refs, base)
    assert got.shape == (37, n)
    np.testing.assert_array_equal(got.numpy(), (rows @ refs[base : base + n].T).numpy())


def _unit(rng, n, d):
    x = rng.randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("metric", ["IP", "L2"])
@pytest.mark.parametrize("n,shards,col_block", [(7000, 2, 8192), (3000, 3, 256)])
def test_sharded_f32_research_is_single_device_bit_for_bit(monkeypatch, metric, n,
                                                           shards, col_block):
    # Each shard its own allocation, as on separate cards: the re-search
    # runs per allocation, on calls of the single-device searcher's shape.
    monkeypatch.setattr(ShardedSimilaritySearcher, "_allocations",
                        lambda self: [[s] for s in range(self.n_dev)])
    shapes = []
    real_scores, real_matmul = similarity._f32_scores, torch.matmul
    in_research = []

    def scores(*args, **kw):
        in_research.append(True)
        try:
            return real_scores(*args, **kw)
        finally:
            in_research.pop()

    def matmul(a, b):
        if in_research:
            shapes.append((tuple(a.shape), tuple(b.shape)))
        return real_matmul(a, b)

    monkeypatch.setattr(similarity, "_f32_scores", scores)
    monkeypatch.setattr(sharded_search, "_f32_scores", scores)
    monkeypatch.setattr(similarity.torch, "matmul", matmul)
    rng = np.random.RandomState(n)
    r, q = _unit(rng, n, 24), _unit(rng, 45, 24)
    single = SimilaritySearcher(r, metric=metric, device="cpu")
    sharded = ShardedSimilaritySearcher(r, Mesh([torch.device("cpu")] * shards),
                                        metric=metric, col_block=col_block)
    assert sharded.shard_rows % similarity._research_cols(n)  # shards straddle blocks
    for mode in ("stream", "pooled"):
        monkeypatch.setenv(COLLECTION_ENV, mode)
        for k in (600, 45 * 16 + 1):
            want = single.global_topk(q, k, kappa=16)
            got = sharded.global_topk(q, k, kappa=16)
            assert sharded.last_stats["corpus_rows"] > 0
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    for g, w in zip(sharded.row_topk(q, 20), single.row_topk(q, 20)):
        np.testing.assert_array_equal(g, w)
    w = similarity._research_cols(n)
    assert shapes and set(shapes) == {((similarity.F32_RESEARCH_MIN_ROWS, 24), (24, w))}
