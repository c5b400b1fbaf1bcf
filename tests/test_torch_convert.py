"""convert.py: the port's searcher and TN parameters built from the JAX
package's state."""

import numpy as np
import pytest
import torch

from vsc2022_torch.convert import searcher_from_arrays, tn_params_from_jax
from vsc2022_torch.ops.tn_align import TNParams
from vsc2022_tpu.ops.similarity import SimilaritySearcher as JaxSearcher
from vsc2022_tpu.ops.tn_align import TNParams as JaxTNParams


def test_searcher_from_jax_staging():
    rng = np.random.RandomState(0)
    r = rng.randint(-3, 4, size=(300, 12)).astype(np.float32)
    q = rng.randint(-3, 4, size=(10, 12)).astype(np.float32)
    js = JaxSearcher(r)
    staged = np.asarray(js._refs)
    assert staged.shape[0] > r.shape[0]  # padded by the JAX searcher
    ts = searcher_from_arrays(
        staged, int(js._n_valid), np.asarray(js._ref_sq), device="cpu"
    )
    assert ts.n_refs == 300 and ts.dim == 12
    np.testing.assert_array_equal(ts._refs[:300].numpy(), r)
    for a, b in zip(js.global_topk(q, 200), ts.global_topk(q, 200)):
        np.testing.assert_array_equal(b, a)


def test_searcher_from_arrays_rejects_unported_corpora():
    r = np.ones((8, 4), np.float32)
    # A non-zero ref_sq beside f32 rows is an L2 corpus: it needs
    # metric="L2" (tests/test_torch_l2.py carries one across).
    with pytest.raises(ValueError, match="L2"):
        searcher_from_arrays(r, 8, ref_sq=np.ones(8, np.float32), device="cpu")
    # An int8 corpus is ported: its codes and the scales in the ref_sq slot
    # stage as they are; without its scales it is refused.
    ts = searcher_from_arrays(r.astype(np.int8), 8, ref_sq=np.full(8, 0.5, np.float32),
                              device="cpu")
    assert ts.dtype == "int8" and ts.n_refs == 8
    assert ts._refs.dtype == torch.int8 and float(ts._scale[0]) == 0.5
    with pytest.raises(ValueError):
        searcher_from_arrays(r.astype(np.int8), 8, device="cpu")
    with pytest.raises(ValueError):
        searcher_from_arrays(r, 9, device="cpu")


@pytest.mark.parametrize("params", [
    JaxTNParams(), JaxTNParams.vcsl_faithful(),
    JaxTNParams(max_step=3, min_length=2, max_paths=4, min_sim=0.1,
                top_k_per_row=3, adaptive_sigma=1.5),
])
def test_tn_params_from_jax(params):
    got = tn_params_from_jax(params._asdict())
    assert isinstance(got, TNParams)
    assert got._asdict() == params._asdict()
    assert TNParams._fields == JaxTNParams._fields


def test_tn_params_rejects_unknown_fields():
    with pytest.raises(ValueError, match="unknown"):
        tn_params_from_jax({"max_step": 5, "window": 3})
