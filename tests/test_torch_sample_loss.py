"""Port parity: the sample loss (`models/sample_fit.py`, DeepFNet's
`if_sample_loss`, the F-loss's sample auxiliary) and the float32 Gram
matrix of the weighted 8-point fit.

Weights are carried with `deepfnet_state_from_flax`; inputs come from
numpy seeds. The port draws its subsets from a torch.Generator, so the
draws cannot equal jax.random's: the comparisons replay the JAX package's
indices (`sample_loss_fits(idx=...)`, or a wrapper around the JAX
package's `sample_loss_fits` that records them; DeepFNet imports that
function at call time and `apply` runs un-jitted).

- The Gram matrix. Near-degenerate weighted fits go through the port's
  float32 solver on the CPU: tests/_torch_joint_setup.py's plain-net batch
  (untrained SuperPoint matches, DeepFNet depth 2, F-loss), and sampled
  20-point subsets with repeated indices (at least 9 distinct points).
  Each float32 gradient's distance from float64 (the largest over the
  leaves, relative, Frobenius) is at most GRAM_FACTOR = 1 times the JAX
  package's float32 distance. Measured by tests/_torch_gram_probe.py:
  the plain-net batch 1.16% with the Gram summed in float32, 0.11%
  summed in float64 (`weighted_eight_point`), the JAX package 0.62%; the
  subsets 0.21%, 0.19% and 0.22%.
- `sample_loss_fits` with JAX's indices: F_samples (unit Frobenius,
  sign-free) and scores in float64 to 1e-8; the
  score overflow case (concentrated weights) and a near-one-hot softmax
  (tests/test_ops.py:166, 256): finite scores summing to 1 and finite
  gradients, equal to JAX's.
- One sample-loss train step (F-loss + 0.1 x loss_selected_F, depth 2) in
  float64 against JAX's `compute_losses`: the loss and loss_selected_F to
  1e-9 relative, each gradient to 1e-6 of its largest entry.
- The CLI: a 2-step `train_good` with the sample loss on the CPU, whose
  checkpoint loads into `eval_good --pretrained`.
"""

import copy
import importlib
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_joint_setup as joint
from deepfepe_tpu.data.synthetic import SyntheticPairs as JSyntheticPairs
from deepfepe_tpu.losses import f_loss as jf_loss
from deepfepe_tpu.models.deepfnet import DeepFNet as JDeepFNet
from deepfepe_tpu.ops.fmatrix import weighted_eight_point as j_w8p
from deepfepe_tpu.train.config import config_from_dict as jconfig_from_dict
from deepfepe_tpu.train.engine import compute_losses as j_compute_losses
from deepfepe_tpu.utils.torch_import import convert_deepf_state
from deepfepe_tpu_torch import cli
from deepfepe_tpu_torch.frontend import FrontendParams, get_matches_from_sp
from deepfepe_tpu_torch.losses import f_loss
from deepfepe_tpu_torch.models import DeepFNet
from deepfepe_tpu_torch.ops.fmatrix import weighted_eight_point
from deepfepe_tpu_torch.train import config_from_dict, make_optimizer, train_step
from deepfepe_tpu_torch.train.joint import build_solver_batch
from deepfepe_tpu_torch.utils.weights import deepfnet_state_from_flax, to_reference_layout

j_sample_fit = importlib.import_module("deepfepe_tpu.models.sample_fit")
sample_fit = importlib.import_module("deepfepe_tpu_torch.models.sample_fit")

SIZE = (376, 1241)
GRAM_FACTOR = 1.0
CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "synthetic_baseline.yaml")


def _dist(g, ref):
    """The largest relative Frobenius distance over the leaves whose float64
    gradient is not zero."""
    return max(np.linalg.norm(g[k] - r) / np.linalg.norm(r) for k, r in ref.items()
               if np.abs(r).max() > 1e-8)


def plain_net_inputs():
    """tests/_torch_joint_setup.py's plain-net batch through the port's
    float32 frontend: the joint step's solver and its inputs."""
    sp, deepf = joint.port_nets("plain")
    tb = {k: torch.from_numpy(v) for k, v in joint.batch().items()}
    with torch.no_grad():
        out = get_matches_from_sp(sp, (tb["imgs_grey"][:, 0], tb["imgs_grey"][:, 1]),
                                  FrontendParams(**joint.FP))
    db = build_solver_batch(out, tb)
    return deepf, {k: v.numpy() for k, v in db.items() if k != "imgs_grey"}


def plain_net_gradient_distances(deepf, db):
    """The float32 F-loss gradient's distance from the port's float64 one
    (`_dist`), for the port and for the JAX package."""
    jvars = convert_deepf_state({k: v.numpy() for k, v in
                                 to_reference_layout(deepf.state_dict()).items()})

    def port(dt):
        net = copy.deepcopy(deepf).to(dt)
        net.input_weights.dtype = net.update_weights.dtype = dt
        t = {k: torch.from_numpy(v).to(dt) if v.dtype.kind == "f" else torch.from_numpy(v)
             for k, v in db.items()}
        f_loss(net(t), t["pts1_virt"], t["pts2_virt"], t["Ks"], 0.02)["loss_F"].backward()
        return {k: p.grad.double().numpy() for k, p in net.named_parameters()}

    def jax_f32():
        net = JDeepFNet(depth=joint.DEPTH, image_size=joint.SIZE, if_quality=True,
                        sign_canonical=True, mlp_dtype=jnp.float32)
        jb = {k: jnp.asarray(v) for k, v in db.items()}
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), jvars)
        g = jax.grad(lambda p: jf_loss(net.apply(p, jb), jb["pts1_virt"], jb["pts2_virt"],
                                       jb["Ks"], 0.02)["loss_F"])(p)
        return {k: v.numpy().astype(np.float64) for k, v in deepfnet_state_from_flax(g).items()}

    g64 = port(torch.float64)
    return {"port": _dist(port(torch.float32), g64), "jax": _dist(jax_f32(), g64)}


@pytest.fixture(scope="module")
def plain_net_solver_batch():
    return plain_net_inputs()


def test_gram_plain_net_batch_no_farther_from_f64_than_jax(plain_net_solver_batch):
    d = plain_net_gradient_distances(*plain_net_solver_batch)
    assert d["port"] <= GRAM_FACTOR * d["jax"], d


def _normalized_pairs(B, n, seed):
    """SyntheticPairs' matches in the solver's [-1, 1] frame, homogeneous."""
    b = JSyntheticPairs(image_size=SIZE, good_num=n, seed=seed).batch(B)
    T = np.array([[2.0 / SIZE[1], 0, -1], [0, 2.0 / SIZE[0], -1], [0, 0, 1]])
    ones = np.ones((B, n, 1))
    return (np.concatenate([b["matches_xy_ori"][..., :2], ones], -1) @ T.T,
            np.concatenate([b["matches_xy_ori"][..., 2:], ones], -1) @ T.T)


def sampled_subset_gradient_distances():
    """20-point subsets drawn with replacement in proportion to softmax
    weights, as the sample loss draws them: most repeat an index, each
    keeps at least 9 distinct points (a unique null vector; with fewer
    neither package's F is defined). The loss sums the unit F and the
    residuals under fixed random cotangents; the gradient with respect to
    the weights and both point sets, its float32 distance from float64
    (`_dist`) for the port and the JAX package."""
    rng = np.random.RandomState(0)
    n, B, S, K = 64, 2, 16, 20
    p1, p2 = _normalized_pairs(B, n, seed=5)
    logits = rng.randn(B, n)
    w = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    idx = np.stack([rng.choice(n, (S, K), p=w[i]) for i in range(B)])
    distinct = [len(set(r)) for r in idx.reshape(-1, K)]
    assert min(distinct) >= 9 and np.mean([d < K for d in distinct]) > 0.9
    cF, cr = rng.randn(B, S, 3, 3), rng.randn(B, S, K)
    bi = np.arange(B)[:, None, None]

    def port(dt):
        ts = [torch.tensor(a, dtype=dt, requires_grad=True) for a in (p1, p2, w)]
        fit = weighted_eight_point(*(t[bi, idx] for t in ts))
        F = fit.F / (fit.F ** 2).sum((-1, -2), keepdim=True) ** 0.5
        loss = (F * torch.tensor(cF, dtype=dt)).sum() + (fit.residual * torch.tensor(
            cr, dtype=dt)).sum()
        return {k: g.double().numpy() for k, g in zip(("p1", "p2", "w"),
                                                      torch.autograd.grad(loss, ts))}

    def jloss(*ts):
        fit = j_w8p(*(t[bi, idx] for t in ts))
        F = fit.F / (fit.F ** 2).sum((-1, -2), keepdims=True) ** 0.5
        return (F * cF.astype(np.float32)).sum() + (fit.residual * cr.astype(np.float32)).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a, jnp.float32) for a in (p1, p2, w)))
    g64 = port(torch.float64)
    return {"port": _dist(port(torch.float32), g64),
            "jax": _dist({k: np.asarray(g, np.float64)
                          for k, g in zip(("p1", "p2", "w"), jg)}, g64)}


def test_gram_sampled_subsets_no_farther_from_f64_than_jax():
    """The subsets of `sampled_subset_gradient_distances`: the port's
    float32 gradient no farther from float64 than the JAX package's (both
    about 0.2%, tests/_torch_gram_probe.py)."""
    d = sampled_subset_gradient_distances()
    assert d["port"] <= GRAM_FACTOR * d["jax"], d


def _points(B, n, seed, concentrated=False):
    p1, p2 = _normalized_pairs(B, n, seed)
    logits = np.random.RandomState(seed).randn(B, n)
    if concentrated:
        logits = np.full((B, n), -8.0)
        logits[:, :5] = 2.0
    return p1, p2, logits


def _unit_abs(F):
    F = np.asarray(F, np.float64)
    return np.abs(F / np.linalg.norm(F, axis=(-1, -2), keepdims=True))


@pytest.mark.parametrize("case", ["generic", "concentrated", "one_hot"])
def test_sample_loss_fits_replay_jax_indices(case):
    """float64, the JAX draw replayed. The concentrated case is the score
    overflow of tests/test_ops.py:166 (prod(w x 1000) is inf in float32),
    the one-hot case that of :256 (every subset ~20 copies of one point):
    there the subsets have fewer than 8 distinct points, the null space of
    each fit is a subspace and neither package's F is unique, so the
    scores and their gradient are compared and the fits held finite; the
    generic case compares the fits and their gradient too."""
    B, n, K, S = 2, 64, 20, 16
    p1, p2, logits = _points(B, n, seed=1, concentrated=case == "concentrated")
    if case == "one_hot":
        logits = np.zeros((B, n))
        logits[:, 0] = 40.0
    unique = np.array([n, n - 10])
    key = jax.random.PRNGKey(3)
    cs = np.random.RandomState(2).randn(B, S)
    with_F = case == "generic"

    def jrun(lg):
        w = jax.nn.softmax(lg, axis=-1)
        return j_sample_fit.sample_loss_fits(jnp.asarray(p1), jnp.asarray(p2), w,
                                             jnp.asarray(unique), key, topk=K, selects=S)

    def jloss(lg):
        o = jrun(lg)
        F = o["F_samples"]
        fit = jnp.sum(F ** 2 * cs[..., None, None]) / jnp.sum(F ** 2) if with_F else 0.0
        return jnp.sum(o["sample_scores"] * cs) + fit

    jo = jrun(jnp.asarray(logits))
    idx = np.asarray(jo["sample_idx"])
    assert idx[1].max() < n - 10  # draws only among the unique matches
    jg = np.asarray(jax.grad(jloss)(jnp.asarray(logits)))

    lt = torch.tensor(logits, requires_grad=True)
    w = torch.softmax(lt, dim=-1)
    args = (torch.from_numpy(p1), torch.from_numpy(p2), w, torch.from_numpy(unique))
    po = sample_fit.sample_loss_fits(*args, topk=K, selects=S, idx=torch.from_numpy(idx))
    assert torch.equal(po["sample_idx"], torch.from_numpy(idx).long())
    scores = po["sample_scores"].detach().numpy()
    assert np.isfinite(scores).all() and np.allclose(scores.sum(-1), 1.0)
    np.testing.assert_allclose(scores, np.asarray(jo["sample_scores"]), rtol=0, atol=1e-8)
    F = po["F_samples"]
    assert torch.isfinite(F).all()
    loss = (po["sample_scores"] * torch.from_numpy(cs)).sum()
    if with_F:
        np.testing.assert_allclose(_unit_abs(F.detach()), _unit_abs(jo["F_samples"]), atol=1e-8)
        loss = loss + (F ** 2 * torch.from_numpy(cs)[..., None, None]).sum() / (F ** 2).sum()
    (g,) = torch.autograd.grad(loss, lt)
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-7 * max(np.abs(jg).max(), 1e-12))


def test_draws_follow_the_weights_among_unique_matches():
    g = torch.Generator().manual_seed(0)
    w = torch.tensor([[0.5, 0.3, 0.2, 0.0, 0.0], [0.1, 0.1, 0.1, 0.1, 0.6]])
    idx = sample_fit.draw_subsets(w, torch.tensor([3, 4]), selects=200, topk=50, generator=g)
    assert idx.shape == (2, 200, 50)
    freq = [torch.bincount(idx[i].flatten(), minlength=5).double() / idx[i].numel()
            for i in range(2)]
    np.testing.assert_allclose(freq[0][:3].numpy(), [0.5, 0.3, 0.2], atol=0.01)
    np.testing.assert_allclose(freq[1][:4].numpy(), [0.25] * 4, atol=0.01)  # renormalized
    assert freq[0][3:].sum() == 0 and freq[1][4] == 0
    again = sample_fit.draw_subsets(w, torch.tensor([3, 4]), 200, 50,
                                    torch.Generator().manual_seed(0))
    assert torch.equal(idx, again)
    nan = sample_fit.draw_subsets(torch.full((1, 5), float("nan")), torch.tensor([5]), 2, 3, g)
    assert nan.shape == (1, 2, 3)  # non-finite weights still draw (the step is then skipped)


class _RecordJaxDraws:
    """Wraps the JAX package's `sample_loss_fits` in its module, recording
    every call's indices."""

    def __enter__(self):
        self.idx, self.saved = [], j_sample_fit.sample_loss_fits

        def wrapped(*a, **k):
            out = self.saved(*a, **k)
            self.idx.append(np.asarray(out["sample_idx"]))
            return out

        j_sample_fit.sample_loss_fits = wrapped
        return self

    def __exit__(self, *exc):
        j_sample_fit.sample_loss_fits = self.saved


class _ReplayDraws:
    """Makes the port's DeepFNet draw the given indices, call by call."""

    def __init__(self, idx):
        self.idx = list(idx)

    def __enter__(self):
        self.saved = sample_fit.sample_loss_fits

        def replay(*a, **k):
            return self.saved(*a, **k, idx=torch.from_numpy(self.idx.pop(0)))

        sample_fit.sample_loss_fits = replay
        return self

    def __exit__(self, *exc):
        sample_fit.sample_loss_fits = self.saved
        assert not self.idx


RAW = {"data": {"batch_size": 2, "good_num": 64},
       "model": {"depth": 2, "clamp_at": 0.02, "if_quality": True, "if_sample_loss": True,
                 "mlp_dtype": "float32"}}


def test_sample_loss_train_step_matches_jax_f64():
    B, n, depth = 2, 64, 2
    b = JSyntheticPairs(image_size=SIZE, good_num=n, seed=7).batch(B)
    b = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in b.items()}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jnet = JDeepFNet(depth=depth, image_size=SIZE, if_quality=True, sign_canonical=True,
                     if_sample_loss=True, mlp_dtype=jnp.float64)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64),
        jax.jit(jnet.init)({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                           jb))
    jcfg = jconfig_from_dict(RAW)
    key = jax.random.PRNGKey(9)

    def jloss(p):
        return j_compute_losses(jnet, p, jb, jcfg, 0.1, 0.5, rng=key)

    with _RecordJaxDraws() as rec:
        jloss(params)  # un-jitted forward: records the draws the gradient below takes
    assert len(rec.idx) == depth
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    cfg = config_from_dict(RAW)
    net = DeepFNet(depth=depth, image_size=SIZE, if_quality=True, sign_canonical=True,
                   if_sample_loss=True, mlp_dtype=torch.float64).double()
    net.load_state_dict(deepfnet_state_from_flax(params), strict=True)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    opt = make_optimizer(net, cfg)
    with _ReplayDraws(rec.idx):
        m = train_step(net, opt, tb, cfg, 0.1, 0.5)
    for k in ("loss", "loss_selected_F", "loss_F"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-9 * abs(float(jm[k])), k
    assert float(m["loss_selected_F"]) > 0 and float(m["nonfinite"]) == 0.0
    ref = {k: v.numpy() for k, v in deepfnet_state_from_flax(jg).items()}
    grads = {k: p.grad.numpy() for k, p in net.named_parameters()}
    scale = max(np.abs(r).max() for r in ref.values())
    for k, r in ref.items():
        np.testing.assert_allclose(grads[k], r, rtol=0, atol=1e-6 * max(np.abs(r).max(),
                                                                          1e-4 * scale),
                                   err_msg=k)


def test_cli_train_good_sample_loss_then_eval_pretrained(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    text = Path(CONFIG).read_text()
    for a, b_ in (("batch_size: 8", "batch_size: 2"), ("good_num: 1000", "good_num: 64"),
                  ("depth: 5", "depth: 2"), ("if_sample_loss: false", "if_sample_loss: true")):
        text = text.replace(a, b_)
    cfg_path = tmp_path / "sample.yaml"
    cfg_path.write_text(text)
    last = cli.main(["train_good", str(cfg_path), "s", "--train_iter", "2", "--device", "cpu"])
    assert last["n_iter"] == 2 and last["nonfinite"] == 0.0
    assert np.isfinite(last["loss_selected_F"]) and last["loss"] > last["loss_F"]
    ckpt = tmp_path / "logs" / "s" / "checkpoints" / "deepFNet_2_checkpoint.pth.tar"
    assert ckpt.exists()
    capsys.readouterr()
    out = cli.main(["eval_good", str(cfg_path), "e", "--max_batches", "1", "--device", "cpu",
                    "--pretrained", str(ckpt)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out and out["pairs"] == 2 and np.isfinite(out["median_err_q"])
    assert out["median_err_q_gt"] < 1e-3
    assert os.path.exists(tmp_path / "logs" / "s" / "metrics.jsonl")
