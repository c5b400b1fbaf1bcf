"""The port's descriptor models against the JAX package's Flax models on
the same weights (carried across by ``vsc2022_torch.convert``'s
``*_from_jax``) and the same numpy inputs: the ResNet trunk, SSCD (its
BatchNorm folding and its bf16 forward too), DINO ViT (the position
embedding resampled by JAX's cubic resize), the 3×3 region max and the
L3-iMAC extractor, and the TorchScript key rules of ``--torchscript_path``.

Tolerances: f32 outputs within 1e-5 of JAX's (XLA-CPU and torch sum the
f32 products in other orders; the largest seen is 8.4e-7 on outputs of
magnitude up to 2.9); the region max is exact (a max of the same
values); folded ≡ unfolded within 1e-5 (the fold is f64, cast to f32);
bf16 ≡ f32 to cosine 0.99 per descriptor.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vsc2022_torch import convert
from vsc2022_torch.inference.cli import build_model, parser as cli_parser
from vsc2022_torch.models import fold as torch_fold
from vsc2022_torch.models.dns import L3iMACExtractor, _region_mac
from vsc2022_torch.models.init import init_flax_like
from vsc2022_torch.models.resnet import ResNet50
from vsc2022_torch.models.sscd import SSCDModel
from vsc2022_torch.models.vit import DinoViT, interpolate_pos_embed
from vsc2022_tpu.models import DinoViT as JaxDinoViT
from vsc2022_tpu.models import SSCDModel as JaxSSCD
from vsc2022_tpu.models import convert as jax_convert
from vsc2022_tpu.models.dns import L3iMACExtractor as JaxL3iMAC
from vsc2022_tpu.models.dns import _region_mac as jax_region_mac
from vsc2022_tpu.models.fold import fold_batchnorm as jax_fold
from vsc2022_tpu.models.resnet import ResNet50 as JaxResNet50

ATOL = 1e-5
SMALL = dict(stage_sizes=(1, 1, 1, 1), stage_features=(8, 16, 32, 64))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb_norms(variables, rng):
    """Randomized BatchNorm statistics and affines, so that every norm (and
    its fold) does real work."""
    def stat(path, a):
        name = str(path[-1])
        if "mean" in name:
            return (rng.randn(*a.shape) * 0.1).astype(np.float32)
        if "var" in name:
            return (rng.rand(*a.shape) + 0.5).astype(np.float32)
        return a

    def param(path, a):
        if str(path[-1]) in ("['scale']", "['bias']"):
            return (a + rng.randn(*a.shape) * 0.1).astype(np.float32)
        return a

    out = dict(variables)
    out["batch_stats"] = jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])
    out["params"] = jax.tree_util.tree_map_with_path(param, variables["params"])
    return out


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _forward(model, x):
    with torch.no_grad():
        return model.eval()(_nchw(x))


@pytest.fixture(scope="module")
def sscd_pair():
    """A small SSCD in both packages on the same (perturbed) weights."""
    rng = np.random.RandomState(0)
    jax_model = JaxSSCD(dims=32, **SMALL)
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    variables = _perturb_norms(
        _np_tree(jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng)
    model = convert.load_into(SSCDModel(dims=32, **SMALL), convert.sscd_from_jax(variables))
    return jax_model, variables, model.eval(), x


def test_resnet_trunk_and_stages_match_jax(sscd_pair):
    _, variables, _, x = sscd_pair
    jax_trunk = JaxResNet50(return_intermediates=True, **SMALL)
    trunk_vars = {"params": variables["params"]["backbone"],
                  "batch_stats": variables["batch_stats"]["backbone"]}
    want, want_stages = jax_trunk.apply(trunk_vars, jnp.asarray(x))
    trunk = ResNet50(return_intermediates=True, **SMALL)
    convert.load_into(trunk, {k[len("backbone."):]: v for k, v in
                              convert.sscd_from_jax(variables).items()})
    got, got_stages = _forward(trunk, x)
    assert len(got_stages) == 4
    for g, w in zip((got,) + tuple(got_stages), (want,) + tuple(want_stages)):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), atol=ATOL)


def test_load_into_names_the_closest_keys():
    state = convert.sscd_from_jax(_np_tree(JaxSSCD(dims=8, **SMALL).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))))
    del state["backbone.layer2.0.conv2.weight"]
    with pytest.raises(convert.ConversionKeyError, match="layer2.0.conv1.weight"):
        convert.load_into(SSCDModel(dims=8, **SMALL), state)


@pytest.mark.parametrize("l2_normalize", [False, True])
def test_sscd_matches_jax(sscd_pair, l2_normalize):
    jax_model, variables, model, x = sscd_pair
    model = copy.deepcopy(model)
    model.l2_normalize = l2_normalize
    want = JaxSSCD(dims=32, l2_normalize=l2_normalize, **SMALL).apply(variables, jnp.asarray(x))
    got = _forward(model, x).numpy()
    assert got.shape == (2, 32)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_fold_bn_matches_unfolded_and_jax_fold(sscd_pair):
    _, variables, model, x = sscd_pair
    folded = SSCDModel(dims=32, fold_bn=True, **SMALL)
    folded.load_state_dict(torch_fold.fold_batchnorm(model.state_dict()))
    assert not any("bn" in k or "downsample.1" in k for k in folded.state_dict())
    np.testing.assert_allclose(_forward(folded, x).numpy(), _forward(model, x).numpy(),
                               atol=ATOL)
    # The JAX package's folded tree loads into the folded model and gives
    # JAX's folded output.
    jax_folded = jax_fold(variables)
    want = JaxSSCD(dims=32, fold_bn=True, **SMALL).apply(jax_folded, jnp.asarray(x))
    from_jax = convert.load_into(SSCDModel(dims=32, fold_bn=True, **SMALL),
                                 convert.sscd_from_jax(jax_folded))
    np.testing.assert_allclose(_forward(from_jax, x).numpy(), np.asarray(want), atol=ATOL)


def test_fold_without_a_conv_raises():
    state = SSCDModel(dims=8, **SMALL).state_dict()
    state["head_bn.running_mean"] = torch.zeros(3)
    with pytest.raises(ValueError, match="head_bn"):
        torch_fold.fold_batchnorm(state)


def test_bf16_forward_close_to_f32(sscd_pair):
    _, _, model, x = sscd_pair
    f32 = _forward(model, x)
    with torch.no_grad():
        bf16 = copy.deepcopy(model).to(torch.bfloat16)(_nchw(x).to(torch.bfloat16)).float()
    cos = torch.nn.functional.cosine_similarity(f32, bf16, dim=1)
    assert bool((cos > 0.99).all()), cos


@pytest.mark.parametrize("hw", [224, 32, 48])
def test_dino_matches_jax(hw):
    # 224 px keeps the 14×14 position grid; 32 and 48 px resample it to
    # 2×2 and 3×3 with JAX's antialiased cubic.
    rng = np.random.RandomState(hw)
    jax_model = JaxDinoViT(dim=64, depth=2, num_heads=4)
    x = rng.rand(2, hw, hw, 3).astype(np.float32)
    variables = _np_tree(jax_model.init(jax.random.PRNGKey(hw), jnp.asarray(x)))
    model = convert.load_into(DinoViT(dim=64, depth=2, num_heads=4),
                              convert.dino_vit_from_jax(variables))
    got = _forward(model, x).numpy()
    assert got.shape == (2, 128)
    np.testing.assert_allclose(got, np.asarray(jax_model.apply(variables, jnp.asarray(x))),
                               atol=ATOL)


def test_dino_pads_as_flax_same():
    # 40 px is no multiple of the 16 px patch: Flax's SAME padding makes a
    # 3×3 grid (9 patches) of the padded image.
    rng = np.random.RandomState(3)
    jax_model = JaxDinoViT(dim=32, depth=1, num_heads=2)
    x = rng.rand(1, 40, 40, 3).astype(np.float32)
    variables = _np_tree(jax_model.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    model = convert.load_into(DinoViT(dim=32, depth=1, num_heads=2),
                              convert.dino_vit_from_jax(variables))
    np.testing.assert_allclose(_forward(model, x).numpy(),
                               np.asarray(jax_model.apply(variables, jnp.asarray(x))),
                               atol=ATOL)


def test_pos_embed_resample_is_jax_cubic():
    # Keys' cubic at a = -0.5 with JAX's edge weighting: torch's bicubic
    # (a = -0.75) lands far off; the port's resample within f32 roundoff.
    rng = np.random.RandomState(0)
    pos = rng.randn(1, 197, 16).astype(np.float32)
    got = interpolate_pos_embed(torch.from_numpy(pos), 400).numpy()
    grid = jax.image.resize(jnp.asarray(pos[:, 1:].reshape(1, 14, 14, 16)),
                            (1, 20, 20, 16), method="cubic")
    want = np.concatenate([pos[:, :1], np.asarray(grid).reshape(1, 400, 16)], axis=1)
    np.testing.assert_allclose(got, want, atol=ATOL)
    bicubic = torch.nn.functional.interpolate(
        torch.from_numpy(pos[:, 1:].reshape(1, 14, 14, 16)).permute(0, 3, 1, 2),
        size=(20, 20), mode="bicubic", align_corners=False)
    assert np.abs(bicubic.permute(0, 2, 3, 1).reshape(1, 400, 16).numpy()
                  - want[:, 1:]).max() > 0.05


def test_pos_embed_needs_a_square_patch_count():
    with pytest.raises(ValueError, match="square"):
        interpolate_pos_embed(torch.zeros(1, 197, 8), 18)
    model = DinoViT(dim=32, depth=1, num_heads=2)
    with pytest.raises(ValueError, match="square"):
        model(torch.zeros(1, 3, 32, 48))  # a 2×3 grid


@pytest.mark.parametrize("h,w", [(7, 7), (10, 10), (20, 20), (7, 20), (10, 7),
                                  (5, 13), (2, 2), (1, 4)])
def test_region_mac_matches_jax(h, w):
    rng = np.random.RandomState(h * 31 + w)
    x = rng.randn(2, h, w, 6).astype(np.float32)
    got = _region_mac(_nchw(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_region_mac(jnp.asarray(x))))


def test_l3imac_matches_jax():
    # The full ResNet-50 trunk (the JAX extractor has no smaller one) at
    # 64 px: stage grids 16, 8, 4 and 2.
    rng = np.random.RandomState(5)
    jax_model = JaxL3iMAC()
    x = rng.rand(1, 64, 64, 3).astype(np.float32)
    variables = _perturb_norms(
        _np_tree(jax.jit(jax_model.init)(jax.random.PRNGKey(5), jnp.asarray(x))), rng)
    model = convert.load_into(L3iMACExtractor(), convert.l3imac_from_jax(variables))
    got = _forward(model, x).numpy()
    assert got.shape == (1, 9, 3840)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    want = jax.jit(jax_model.apply)(variables, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_from_jax_covers_every_parameter():
    # Each converter fills exactly the model's parameters and buffers
    # (BatchNorm's step counters aside).
    def keys(model):
        return {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}

    probe = jnp.zeros((1, 32, 32, 3))
    sscd = _np_tree(JaxSSCD(dims=8, **SMALL).init(jax.random.PRNGKey(0), probe))
    assert set(convert.sscd_from_jax(sscd)) == keys(SSCDModel(dims=8, **SMALL))
    folded = set(convert.sscd_from_jax(jax_fold(sscd)))
    assert folded == keys(SSCDModel(dims=8, fold_bn=True, **SMALL))
    dino = _np_tree(JaxDinoViT(dim=32, depth=2, num_heads=2).init(
        jax.random.PRNGKey(0), probe))
    assert set(convert.dino_vit_from_jax(dino)) == keys(DinoViT(dim=32, depth=2, num_heads=2))


def test_torchscript_sscd_takes_the_jax_key_rules(tmp_path):
    # A TorchScript SSCD under the DataParallel prefix and the unadapted
    # torchvision head (module.backbone.* + module.embeddings.1.*): the
    # port's key rules load the weights JAX's --torchscript_path
    # conversion reads, bit for bit.
    torch.manual_seed(0)
    model = SSCDModel()
    init_flax_like(model, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)

    class Published(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.module = torch.nn.Module()
            self.module.backbone = model.backbone
            self.module.embeddings = torch.nn.Sequential(torch.nn.Identity(), model.project)

        def forward(self, x):
            y = self.module.backbone(x).clamp(min=1e-6).pow(3).mean(dim=(2, 3)).pow(1 / 3)
            return self.module.embeddings(y)

    path = str(tmp_path / "sscd.pt")
    torch.jit.save(torch.jit.trace(Published().eval(), torch.zeros(1, 3, 32, 32)), path)
    got = convert.load_into(SSCDModel(), convert.sscd_from_torch(
        convert.load_torchscript_state(path))).state_dict()
    want = convert.sscd_from_jax(jax_convert.sscd_from_torch(
        jax_convert.load_torchscript_state(path)))
    assert set(want) <= set(got)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    for key, value in model.state_dict().items():
        np.testing.assert_array_equal(got[key].numpy(), value.numpy(), err_msg=key)


def test_torchscript_dino_takes_the_jax_key_rules(tmp_path):
    model = DinoViT(dim=64, depth=2, num_heads=4)
    model.init_weights(torch.Generator().manual_seed(2))

    class Published(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = model

        def forward(self, x):
            return self.backbone(x)

    path = str(tmp_path / "dino.pt")
    torch.jit.save(torch.jit.trace(Published().eval(), torch.zeros(1, 3, 224, 224)), path)
    got = convert.load_into(DinoViT(dim=64, depth=2, num_heads=4), convert.dino_vit_from_torch(
        convert.load_torchscript_state(path))).state_dict()
    want = convert.dino_vit_from_jax(jax_convert.dino_vit_from_torch(
        jax_convert.load_torchscript_state(path), dim=64, heads=4))
    assert set(want) == set(got)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value, rtol=0, atol=0, err_msg=key)


def test_key_rules_match_jax():
    state = {"module.trunk.layer1.0.conv1.weight": np.zeros(1),
             "module.embedding_projection.weight": np.zeros(1)}
    got = convert.apply_aliases(convert.normalize_state_keys(state), "sscd")
    want = jax_convert.apply_aliases(jax_convert.normalize_state_keys(state), "sscd")
    assert list(got) == list(want) == ["backbone.layer1.0.conv1.weight", "project.weight"]
    for family in ("sscd", "dino"):
        assert convert.ALIAS_RULES[family] == jax_convert.ALIAS_RULES[family]


@pytest.mark.parametrize("baseline,width", [("sscd", 512), ("dino", 768), ("dns", 9 * 3840)])
def test_random_init_is_seeded(baseline, width, caplog):
    argv = ["--baseline", baseline, "--dataset_path", "v", "--output_file", "o.npz"]
    args = cli_parser.parse_args(argv)
    first, second = build_model(args), build_model(args)
    assert "random init" in caplog.text
    for (k, a), b in zip(first.state_dict().items(), second.state_dict().values()):
        assert torch.equal(a, b), k
    image = torch.from_numpy(np.random.RandomState(0).rand(1, 3, 224, 224).astype(np.float32))
    with torch.no_grad():
        out = first(image)
    assert out.shape == (1, width) and bool(torch.isfinite(out).all())
