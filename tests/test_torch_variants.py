"""Port parity: DeepFNet's solver variants with carried weights.

`if_learn_offsets` (the 4-output `update_offsets` ErrorEstimator moves the
matches, and the residual's point gradient carries it), `if_tri_depth`
(each layer's triangulated depth as a feature), `if_goodCorresArch`
(GoodCorresNet for both weight nets) and `if_img_w` (weights times
'weights_im'), each against the JAX package in float64 on SyntheticPairs
(N = 64, B = 2, depth 3, sign-canonical null vectors), the JAX parameters
(norm affines and biases randomized) carried by `deepfnet_state_from_flax`:

- the forward: every layer's F (unit Frobenius), weights, logits and
  epipolar residuals, and the variant's own output (offsets, depths), to
  1e-10 relative (measured at most 2e-13);
- the F-loss to 1e-10 relative and its gradient with respect to every
  parameter, each leaf to 1e-6 of its largest entry (measured at most
  6e-8; a leaf that is zero in exact arithmetic, under 1e-4 of the net's
  largest, to 1e-10 of that).

The carried parameters are float32 values (as `deepfnet_state_from_flax`
carries them): with float64 values rounded on the way, the untrained
MLPs' leaky ReLUs, whose inputs come within 1e-7 of 0, put a unit on the
other side in one package and moved a learned-offsets gradient leaf by
2% (with `_randomize` drawing float64 values).

Then: both packages fail alike without 'weights_im'; the reference-layout
checkpoints round-trip (and the JAX package's `export_deepf_state` loads
with strict=True where it has reference keys: not for GoodCorresNet, whose
parameters keep the JAX package's names); and the CLI trains each variant
for 2 steps on the CPU and evaluates its checkpoint.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfepe_tpu.data.synthetic import SyntheticPairs
from deepfepe_tpu.losses import f_loss as jf_loss
from deepfepe_tpu.models.deepfnet import DeepFNet as JDeepFNet
from deepfepe_tpu.utils.torch_import import export_deepf_state
from deepfepe_tpu_torch import cli
from deepfepe_tpu_torch.losses import f_loss
from deepfepe_tpu_torch.models import DeepFNet, GoodCorresNet
from deepfepe_tpu_torch.train import config_from_dict, load_checkpoint, save_checkpoint
from deepfepe_tpu_torch.loader import model_loader
from deepfepe_tpu_torch.utils.weights import deepfnet_state_from_flax
from _torch_threads import one_torch_thread  # noqa: F401

SIZE = (376, 1241)
B, N, DEPTH = 2, 64, 3
VARIANTS = ("if_learn_offsets", "if_tri_depth", "if_goodCorresArch", "if_img_w")
EXTRA = {"if_learn_offsets": "offsets", "if_tri_depth": "tri_depths"}
CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "synthetic_baseline.yaml")


def _batch(seed=3):
    b = SyntheticPairs(image_size=SIZE, good_num=N, seed=seed).batch(B)
    b = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in b.items()}
    b["weights_im"] = np.random.RandomState(seed).uniform(0.5, 1.5, (B, N))
    return b


def _randomize(params, seed=1):
    """Norm affines and biases randomized, every value a float32 (as
    `deepfnet_state_from_flax` carries them), held in float64."""
    rng = np.random.RandomState(seed)

    def f(path, x):
        name = getattr(path[-1], "key", "")
        if name == "scale":
            x = rng.uniform(0.5, 1.5, x.shape)
        elif name == "bias":
            x = rng.uniform(-0.2, 0.2, x.shape)
        return jnp.asarray(np.asarray(x, np.float32), jnp.float64)

    return jax.tree_util.tree_map_with_path(f, params)


_JAX_RUNS = {}


def _jax_run(flag, jb):
    """The JAX net of `flag`, its parameters, and in one compiled call its
    forward outputs, F-loss and parameter gradients; computed once a flag
    for the forward and gradient tests."""
    if flag not in _JAX_RUNS:
        jnet = JDeepFNet(depth=DEPTH, image_size=SIZE, if_quality=True, sign_canonical=True,
                         mlp_dtype=jnp.float64, **{flag: True})
        params = _randomize(jax.jit(jnet.init)(jax.random.PRNGKey(0), jb))

        def jloss(p):
            out = jnet.apply(p, jb)
            return jf_loss(out, jb["pts1_virt"], jb["pts2_virt"], jb["Ks"], 0.02)["loss_F"], out

        (jl, oj), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
        _JAX_RUNS[flag] = jnet, params, oj, jl, jg
    return _JAX_RUNS[flag]


def _nets(flag, jb):
    jnet, params = _jax_run(flag, jb)[:2]
    net = DeepFNet(depth=DEPTH, image_size=SIZE, if_quality=True, sign_canonical=True,
                   mlp_dtype=torch.float64, **{flag: True}).double()
    net.load_state_dict(deepfnet_state_from_flax(params), strict=True)
    return jnet, params, net


def _unit(F):
    F = np.asarray(F, np.float64)
    return F / np.linalg.norm(F, axis=(-1, -2), keepdims=True)


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.mark.parametrize("flag", VARIANTS)
def test_variant_forward_matches_jax_f64(flag, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jnet, params, net = _nets(flag, jb)
    oj = _jax_run(flag, jb)[2]
    with torch.no_grad():
        ot = net({k: torch.from_numpy(v) for k, v in batch.items()})
    tol = 1e-10
    np.testing.assert_allclose(_unit(ot["out_layers"]), _unit(oj["out_layers"]), atol=tol)
    keys = ["weights_layers", "logits_layers", "epi_res_layers"]
    keys += [EXTRA[flag]] if flag in EXTRA else []
    for k in keys:
        ref = np.asarray(oj[k])
        np.testing.assert_allclose(ot[k].numpy(), ref, rtol=tol, atol=tol * np.abs(ref).max(),
                                   err_msg=k)
    if flag == "if_tri_depth":
        assert np.ptp(np.asarray(oj["tri_depths"])) > 1.0  # a feature, not a constant
    if flag == "if_learn_offsets":
        np.testing.assert_allclose(ot["pts1"].numpy(), np.asarray(oj["pts1"]), rtol=1e-10)


@pytest.mark.parametrize("flag", VARIANTS)
def test_variant_gradients_match_jax_f64(flag, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jnet, params, net = _nets(flag, jb)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = f_loss(net(tb), tb["pts1_virt"], tb["pts2_virt"], tb["Ks"], 0.02)["loss_F"]
    loss.backward()
    jl, jg = _jax_run(flag, jb)[3:]
    assert abs(float(loss) - float(jl)) <= 1e-10 * abs(float(jl))
    ref = {k: v.numpy() for k, v in deepfnet_state_from_flax(jg).items()}
    grads = dict(net.named_parameters())
    assert set(ref) == set(grads)
    scale = max(np.abs(r).max() for r in ref.values())
    for k, r in ref.items():
        g = grads[k].grad.numpy()
        own = np.abs(r).max()
        atol = 1e-6 * own if own >= 1e-4 * scale else 1e-10 * scale
        np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=k)
    if flag == "if_learn_offsets":
        assert np.abs(ref["update_offsets.fw.0.weight"]).max() > 0  # the offsets learn


def test_img_w_without_weights_im_fails_alike(batch):
    """No dataset of either package supplies 'weights_im'."""
    b = {k: v for k, v in batch.items() if k != "weights_im"}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jnet = JDeepFNet(depth=DEPTH, image_size=SIZE, if_quality=True, if_img_w=True)
    with pytest.raises(KeyError, match="weights_im"):
        jnet.init(jax.random.PRNGKey(0), jb)
    net = DeepFNet(depth=DEPTH, image_size=SIZE, if_quality=True, if_img_w=True)
    with pytest.raises(KeyError, match="weights_im"):
        net({k: torch.from_numpy(v).float() for k, v in b.items()})


@pytest.mark.parametrize("flag", VARIANTS[:3])
def test_variant_checkpoint_round_trips(flag, tmp_path, batch):
    cfg = config_from_dict({"model": {"if_quality": True, "depth": DEPTH, flag: True,
                                      "mlp_dtype": "float32"}})
    a = model_loader(cfg, torch.device("cpu"), torch.Generator().manual_seed(4))
    b = model_loader(cfg, torch.device("cpu"), torch.Generator().manual_seed(5))
    path = str(tmp_path / "ckpt.pth.tar")
    save_checkpoint(path, a, None, n_iter=7)
    assert load_checkpoint(path, b) == 7
    tb = {k: torch.from_numpy(v).float() if v.dtype == np.float64 else torch.from_numpy(v)
          for k, v in batch.items()}
    with torch.no_grad():
        assert torch.equal(a(tb)["logits_layers"], b(tb)["logits_layers"])
    if flag == "if_goodCorresArch":
        assert isinstance(a.input_weights, GoodCorresNet)
        assert "input_weights.local1_conv.weight" in a.state_dict()
        assert a.update_weights.seg0_conv.in_features == 64 + 128 + 128 + 512 + 2048 + 2048


def test_export_deepf_state_carries_update_offsets(batch):
    """The JAX package's reference-layout export has `update_offsets.fw.*`
    keys; they load with strict=True and give the flax route's outputs."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, params, net = _nets("if_learn_offsets", jb)
    exported = {k: torch.from_numpy(np.asarray(v)) for k, v in export_deepf_state(params).items()}
    assert "update_offsets.fw.15.weight" in exported
    other = DeepFNet(depth=DEPTH, image_size=SIZE, if_quality=True, sign_canonical=True,
                     mlp_dtype=torch.float64, if_learn_offsets=True).double()
    other.load_state_dict(exported, strict=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        assert torch.equal(net(tb)["offsets"], other(tb)["offsets"])


@pytest.mark.parametrize("flag", VARIANTS[:3])
def test_cli_trains_and_evaluates_variant(flag, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    text = Path(CONFIG).read_text()
    for a, b in (("batch_size: 8", "batch_size: 2"), ("good_num: 1000", "good_num: 64"),
                 ("depth: 5", "depth: 2"),
                 ("if_qt_loss: false", f"if_qt_loss: false\n    {flag}: true")):
        text = text.replace(a, b)
    cfg = tmp_path / "v.yaml"
    cfg.write_text(text)
    last = cli.main(["train_good", str(cfg), "v", "--train_iter", "2", "--device", "cpu"])
    assert last["n_iter"] == 2 and last["nonfinite"] == 0.0 and np.isfinite(last["loss"])
    ckpt = tmp_path / "logs" / "v" / "checkpoints" / "deepFNet_2_checkpoint.pth.tar"
    capsys.readouterr()
    out = cli.main(["eval_good", str(cfg), "e", "--max_batches", "1", "--device", "cpu",
                    "--pretrained", str(ckpt)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["pairs"] == 2 and out["median_err_q_gt"] < 1e-3 and np.isfinite(out["median_err_q"])
