"""The space-to-depth stem of the port's ResNet-50 against the JAX
package's: ``fold.s2d_stem`` relabels the 7×7/2 stem kernel onto a VALID
4×4 conv over the 2×2 space-to-depth input, and ``stem_s2d=True`` models
run it. The relabelled arrays must equal JAX's exactly; the models' outputs
agree with JAX's and with the standard stem to f32 reassociation."""

import numpy as np
import pytest
import torch

from vsc2022_torch import convert
from vsc2022_torch.models import fold as torch_fold
from vsc2022_torch.models.sscd import SSCDModel as TorchSSCD
from vsc2022_tpu.models import fold as jax_fold
from vsc2022_tpu.models.sscd import SSCDModel as JaxSSCD

SMALL = dict(dims=64, stage_sizes=(1, 1, 1, 1), stage_features=(16, 32, 64, 128))


def _model(**kw):
    """A small SSCD of the port in eval mode, BatchNorm statistics drawn."""
    torch.manual_seed(5)
    model = TorchSSCD(**SMALL, **kw)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return model.eval()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def test_s2d_stem_on_flax_variables_is_jax():
    variables = convert.sscd_to_jax(_model().state_dict())
    want, got = _leaves(jax_fold.s2d_stem(variables)), _leaves(torch_fold.s2d_stem(variables))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["params/backbone/conv1/kernel"].shape == (4, 4, 12, 64)
    # On a port state dict: the same kernel, OIHW.
    state = torch_fold.s2d_stem(_model().state_dict())
    np.testing.assert_array_equal(
        state["backbone.conv1.weight"].numpy().transpose(2, 3, 1, 0),
        want["params/backbone/conv1/kernel"])


@pytest.mark.parametrize("fold_bn", [False, True])
def test_s2d_model_matches_jax_and_the_standard_stem(fold_bn):
    model = _model()
    state = torch_fold.s2d_stem(model.state_dict())
    if fold_bn:
        state = torch_fold.fold_batchnorm(state)
    s2d = TorchSSCD(**SMALL, stem_s2d=True, fold_bn=fold_bn).eval()
    s2d.load_state_dict(state)
    x = np.random.RandomState(6).randn(2, 3, 64, 64).astype(np.float32)
    with torch.no_grad():
        standard = model(torch.from_numpy(x)).numpy()
        got = s2d(torch.from_numpy(x)).numpy()
    jax_vars = jax_fold.s2d_stem(convert.sscd_to_jax(model.state_dict()))
    if fold_bn:
        jax_vars = jax_fold.fold_batchnorm(jax_vars)
    want = np.asarray(JaxSSCD(**SMALL, stem_s2d=True, fold_bn=fold_bn).apply(
        jax_vars, np.transpose(x, (0, 2, 3, 1))))
    scale = np.abs(standard).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(got - standard).max() <= 1e-5 * scale


@pytest.mark.parametrize("hw", [(63, 64), (64, 63)])
def test_s2d_stem_needs_even_sides(hw):
    model = TorchSSCD(**SMALL, stem_s2d=True).eval()
    with pytest.raises(ValueError, match="even"):
        model(torch.zeros(1, 3, *hw))
    with pytest.raises(ValueError, match="inference-only"):
        model.train()(torch.zeros(1, 3, 64, 64))
