"""Port parity: the SuperPoint frontend (nets, fused forward, keypoint
processing, matching pipeline).

Weights are the JAX nets' flax variables, carried across by
`superpoint_state_from_flax`, with randomized running statistics: variance
|1 + 0.3 N| + 0.05 as tests/test_conv_pallas.py makes it, mean 0.1 N.
That test's mean, |0.3 N| + 0.05, is positive everywhere and zeroes every
activation of the untrained gauss2 net after its ReLUs (its descriptors
came out constant, one match a pair), which would leave the matching
nothing to match. Inputs come from numpy seeds.

- Both nets against flax, module and fused forward: atol 2e-6, the bar of
  tests/test_conv_pallas.py for two routes through the same net (measured
  2.4e-7: float32 conv sums in another order).
- The gauss2 state also loads from the JAX package's own exporter
  (`export_superpoint_gauss2_state`) with strict=True, to the same tensors.
- NMS, top-k and `flatten_detection` equal JAX exactly (no arithmetic but
  compares and one softmax); soft-argmax offsets and sampled descriptors
  within 1e-5 (float32 contractions in another order). NMS keeps ties and
  a border maximum; top-k breaks equal scores to the lower index.
- `get_matches_from_sp` against the JAX one on the same frames and
  weights: the same keypoints (xy, valid) and match sets, the
  correspondences within 1e-4 px and quality (1 - distance) within 5e-5:
  the distance sqrt(2 - 2 d1.d2) of a close match amplifies the
  similarity's float32 rounding by about 1 / distance (measured 1.1e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfepe_tpu.frontend import (FrontendParams as JFrontendParams, flatten_detection as
                                   jflatten, get_matches_from_sp as jget_matches,
                                   nms_heatmap as jnms, sample_descriptors as jsample,
                                   soft_argmax_refine as jsoftargmax, topk_keypoints as jtopk)
from deepfepe_tpu.frontend.superpoint import (SuperPointNet as JSuperPointNet,
                                              SuperPointNetGauss2 as JSuperPointNetGauss2)
from deepfepe_tpu.utils.torch_import import export_superpoint_gauss2_state
from deepfepe_tpu_torch.frontend import (FrontendParams, Keypoints, SuperPointNet,
                                         SuperPointNetGauss2, ValModelHeatmap, flatten_detection,
                                         get_matches_from_sp, nms_heatmap, run_superpoint,
                                         sample_descriptors, soft_argmax_refine, topk_keypoints)
from deepfepe_tpu_torch.frontend.sp_fused import superpoint_forward_fused
from deepfepe_tpu_torch.utils.weights import superpoint_state_from_flax
from _torch_threads import one_torch_thread  # noqa: F401

NETS = {"plain": (JSuperPointNet, SuperPointNet), "gauss2": (JSuperPointNetGauss2,
                                                             SuperPointNetGauss2)}


def flax_variables(jnet, shape, seed=2):
    """The JAX net's initial variables as numpy, running statistics
    randomized (module docstring)."""
    v = jax.tree_util.tree_map(np.asarray,
                               jnet.init(jax.random.PRNGKey(1), jnp.zeros(shape, jnp.float32)))
    if "batch_stats" in v:
        rng = np.random.RandomState(seed)
        v = dict(v)
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, a: ((0.1 * rng.randn(*a.shape)) if path[-1].key == "mean"
                             else np.abs(1 + 0.3 * rng.randn(*a.shape)) + 0.05).astype(np.float32),
            v["batch_stats"])
    return v


@pytest.fixture(scope="module", params=list(NETS))
def nets(request):
    jcls, tcls = NETS[request.param]
    jnet = jcls(dtype=jnp.float32)
    v = flax_variables(jnet, (1, 48, 64, 1))
    net = tcls().eval()
    net.load_state_dict(superpoint_state_from_flax(v), strict=True)
    return request.param, jnet, v, net


def test_nets_match_flax_module_and_fused_forward(nets):
    name, jnet, v, net = nets
    x = np.random.RandomState(0).rand(2, 48, 64, 1).astype(np.float32)
    want = jnet.apply(v, jnp.asarray(x))
    with torch.no_grad():
        outs = {"module": net(torch.from_numpy(x)),
                **{f"fused_{impl}": superpoint_forward_fused(net, torch.from_numpy(x), impl)
                   for impl in ("xla", "pallas")}}
    for route, out in outs.items():
        for k in ("semi", "desc"):
            assert out[k].shape == want[k].shape, (route, k)
            np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]), atol=2e-6,
                                       err_msg=f"{name} {route} {k}")
    np.testing.assert_allclose(outs["module"]["desc"].norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_gauss2_state_from_the_jax_exporter_loads_strictly():
    v = flax_variables(JSuperPointNetGauss2(dtype=jnp.float32), (1, 16, 16, 1))
    sd = {k: torch.tensor(np.asarray(a)) for k, a in export_superpoint_gauss2_state(v).items()}
    exported, mapped = SuperPointNetGauss2(), SuperPointNetGauss2()
    exported.load_state_dict(sd, strict=True)
    mapped.load_state_dict(superpoint_state_from_flax(v), strict=True)
    for k, t in exported.state_dict().items():
        assert torch.equal(t, mapped.state_dict()[k]), k


def test_gauss2_refuses_train_mode_batchnorm():
    """Train-mode BatchNorm never takes the fused forward, whose BatchNorm
    is folded from the running statistics (the JAX routing); it needs a
    net with BatchNorm."""
    net = SuperPointNetGauss2().train()
    with pytest.raises(ValueError, match="train mode"):
        superpoint_forward_fused(net, torch.zeros(1, 16, 16, 1), "xla")
    with pytest.raises(ValueError, match="BatchNorm"):
        run_superpoint(SuperPointNet(), torch.zeros(1, 16, 16), FrontendParams(), bn_train=True)
    with pytest.raises(ValueError, match="conv implementation"):
        superpoint_forward_fused(net.eval(), torch.zeros(1, 16, 16, 1), "winograd")


def test_flatten_detection_and_nms_equal_jax():
    rng = np.random.RandomState(0)
    semi = rng.randn(2, 4, 5, 65).astype(np.float32)
    np.testing.assert_allclose(flatten_detection(torch.from_numpy(semi)).numpy(),
                               np.asarray(jflatten(jnp.asarray(semi))), rtol=1e-6, atol=1e-9)
    hm = rng.rand(2, 32, 40).astype(np.float32)
    hm[0, 10, 10] = hm[0, 10, 12] = 2.0      # a tie inside one window: both kept
    hm[1, 0, 39] = 3.0                        # a border maximum: kept (-inf padding)
    for d in (2, 4):
        got = nms_heatmap(torch.from_numpy(hm), d).numpy()
        np.testing.assert_array_equal(got, np.asarray(jnms(jnp.asarray(hm), d)))
    got = nms_heatmap(torch.from_numpy(hm), 4).numpy()
    assert got[0, 10, 10] == got[0, 10, 12] == 2.0 and got[1, 0, 39] == 3.0


def test_topk_breaks_equal_scores_to_the_lower_index():
    rng = np.random.RandomState(1)
    nms = np.where(rng.rand(2, 24, 30) < 0.1, rng.choice([0.2, 0.5, 0.9], (2, 24, 30)), 0.0)
    nms = nms.astype(np.float32)  # many equal scores, and zeros for the padding slots
    for k in (40, 200):
        got = topk_keypoints(torch.from_numpy(nms), k, conf_thresh=0.1)
        want = jtopk(jnp.asarray(nms), k, conf_thresh=0.1)
        for a, b in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < int(got.valid.sum()) < got.valid.numel()  # k = 200 pads with zero scores


def test_soft_argmax_and_descriptor_sampling_match_jax():
    rng = np.random.RandomState(2)
    hm = rng.rand(2, 40, 48).astype(np.float32)
    nms = np.asarray(jnms(jnp.asarray(hm), 4))
    jk = jtopk(jnp.asarray(nms), 30, conf_thresh=0.5)
    tk = topk_keypoints(nms_heatmap(torch.from_numpy(hm), 4), 30, conf_thresh=0.5)
    got = soft_argmax_refine(torch.from_numpy(hm), tk, patch_size=5)
    want = jsoftargmax(jnp.asarray(hm), jk, patch_size=5)
    np.testing.assert_allclose(got.offsets.numpy(), np.asarray(want.offsets), atol=1e-5)
    assert np.abs(got.offsets.numpy()).max() > 0.05
    dm = rng.randn(2, 5, 6, 16).astype(np.float32)
    xy = got.xy + got.offsets
    np.testing.assert_allclose(sample_descriptors(torch.from_numpy(dm), xy).numpy(),
                               np.asarray(jsample(jnp.asarray(dm), jnp.asarray(xy.numpy()))),
                               atol=1e-5)
    with pytest.raises(ValueError, match="gather"):  # the softmax variant is gather-only
        soft_argmax_refine(torch.from_numpy(hm), tk, temperature=0.5, impl="matmul")


def test_get_matches_from_sp_matches_jax(nets):
    name, jnet, v, net = nets
    rng = np.random.RandomState(4)
    frame = rng.rand(2, 64, 100).astype(np.float32)
    imgs = np.stack([frame[..., :96], frame[..., 3:99]])  # the second view moved by 3 px
    kw = dict(out_num_points=128, conf_thresh=1e-4)
    want = jget_matches(jnet, v, (jnp.asarray(imgs[0]), jnp.asarray(imgs[1])),
                        JFrontendParams(**kw, conv_backend="flax"))
    with torch.no_grad():
        got = get_matches_from_sp(net, (torch.from_numpy(imgs[0]), torch.from_numpy(imgs[1])),
                                  FrontendParams(**kw))
    for kk in ("kpts1", "kpts2"):
        np.testing.assert_array_equal(got[kk].xy.numpy(), np.asarray(want[kk].xy))
        np.testing.assert_array_equal(got[kk].valid.numpy(), np.asarray(want[kk].valid))
        np.testing.assert_allclose(got[kk].desc.numpy(), np.asarray(want[kk].desc), atol=1e-5)
    gm, wm = got["matches"], want["matches"]
    pairs = lambda m: {(b, int(i), int(j)) for b in range(2)  # noqa: E731
                       for i, j, ok in zip(np.asarray(m.idx1[b]), np.asarray(m.idx2[b]),
                                           np.asarray(m.valid[b])) if ok}
    assert pairs(gm) == pairs(wm) and len(pairs(gm)) > 10, len(pairs(gm))
    np.testing.assert_allclose(got["matches_xy_ori"].numpy(), np.asarray(want["matches_xy_ori"]),
                               atol=1e-4)
    np.testing.assert_allclose(got["quality"].numpy(), np.asarray(want["quality"]), atol=5e-5)
    assert int(got["valid"].sum(-1).min()) < 128   # padding slots exist and were filled
    assert torch.all(got["matches_xy_ori"].abs().sum(-1) > 0)


def test_val_model_heatmap_wrapper():
    net = SuperPointNet().eval()
    vm = ValModelHeatmap(net, {"top_k": 32, "conf_thresh": 1e-4})
    kpts = vm.run(torch.rand(1, 64, 96, generator=torch.Generator().manual_seed(0)))
    assert isinstance(kpts, Keypoints)
    assert vm.heatmap_to_pts().shape == (1, 32, 3)
    assert vm.desc_to_sparse_desc().shape == (1, 32, 256)


def test_frontend_params_from_config_reads_sp_params():
    from deepfepe_tpu_torch.frontend import frontend_params_from_config
    from deepfepe_tpu_torch.train.config import config_from_dict

    cfg = config_from_dict({"training": {"SP_params": {"out_num_points": 500, "nms_dist": 2,
                                                       "conf_thresh": 0.01}}})
    fp = frontend_params_from_config(cfg)
    assert (fp.out_num_points, fp.nms_dist, fp.conf_thresh, fp.patch_size) == (500, 2, 0.01, 5)
    assert fp.conv_backend == "auto" and fp.conv_impl is None
    with pytest.raises(ValueError, match="unknown SP_params"):
        frontend_params_from_config(config_from_dict({"training": {"SP_params": {"k": 1}}}))
    with pytest.raises(ValueError, match="conv_backend"):
        FrontendParams(conv_backend="cuda")


def _border_keypoints(rng, B, H, W, K):
    """Keypoints [B, K, 2] at integer positions, a third of them within two
    pixels of a border, a few invalid."""
    xs = rng.randint(0, W, (B, K)).astype(np.float32)
    ys = rng.randint(0, H, (B, K)).astype(np.float32)
    edge = rng.rand(B, K) < 0.35
    xs = np.where(edge & (rng.rand(B, K) < 0.5), rng.choice([0, 1, W - 2, W - 1], (B, K)), xs)
    ys = np.where(edge, rng.choice([0, 1, H - 2, H - 1], (B, K)), ys)
    valid = rng.rand(B, K) > 0.1
    return np.stack([xs, ys], -1).astype(np.float32), valid


@pytest.mark.parametrize("impl,temperature", [("matmul", None), ("conv", None), ("gather", None),
                                              ("gather", 0.05), ("auto", 0.05)])
def test_soft_argmax_forms_match_jax(impl, temperature):
    """Each form's offsets and heatmap gradient against the JAX package's,
    border keypoints included (the centred forms zero-pad the window there,
    'gather' shifts it inward). Offsets within 1e-5 px, the gradient of a
    random weighting of them within 1e-5 of its largest entry (float32
    sums in another order)."""
    from deepfepe_tpu.frontend.process import Keypoints as JKeypoints

    rng = np.random.RandomState(7)
    B, H, W, K = 2, 24, 30, 40
    hm = (rng.rand(B, H, W) ** 3).astype(np.float32)
    xy, valid = _border_keypoints(rng, B, H, W, K)
    g = rng.randn(B, K, 2).astype(np.float32)
    zero = np.zeros((B, K), np.float32)
    jk = JKeypoints(jnp.asarray(xy), jnp.zeros_like(jnp.asarray(xy)), jnp.asarray(zero),
                    jnp.asarray(valid))

    def jloss(h):
        return jnp.sum(jsoftargmax(h, jk, patch_size=5, temperature=temperature,
                                   impl=impl).offsets * g)

    want = np.asarray(jsoftargmax(jnp.asarray(hm), jk, patch_size=5, temperature=temperature,
                                  impl=impl).offsets)
    want_grad = np.asarray(jax.grad(jloss)(jnp.asarray(hm)))
    h = torch.from_numpy(hm).requires_grad_()
    tk = Keypoints(torch.from_numpy(xy), torch.zeros(B, K, 2), torch.from_numpy(zero),
                   torch.from_numpy(valid))
    got = soft_argmax_refine(h, tk, patch_size=5, temperature=temperature, impl=impl).offsets
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    assert np.abs(want).max() > 0.3  # border windows move the offsets
    np.testing.assert_allclose(h.grad.numpy(), want_grad, atol=1e-5 * np.abs(want_grad).max())


def test_s2d_helpers_match_jax():
    """The space-to-depth helpers against conv_pallas's: the weight pack,
    the reshapes and the s2d max pool exactly (data movement); the s2d
    conv, on an s2d input and on NHWC, within 5e-6 (float32 sums of 1,152
    products of unit size in another order: 2.9e-6 seen), and its input
    and weight gradients within 1e-5 of their largest entry."""
    from deepfepe_tpu.ops.pallas import conv_pallas as jconv
    from deepfepe_tpu_torch.ops import conv_s2d

    rng = np.random.RandomState(3)
    x = rng.randn(2, 10, 12, 64).astype(np.float32)
    w = (0.1 * rng.randn(3, 3, 64, 32)).astype(np.float32)
    s = (1 + 0.2 * rng.randn(32)).astype(np.float32)
    t = (0.1 * rng.randn(32)).astype(np.float32)
    np.testing.assert_array_equal(conv_s2d._pack_w_s2d(torch.from_numpy(w), torch.float32).numpy(),
                                  np.asarray(jconv._pack_w_s2d(jnp.asarray(w), jnp.float32)))
    xs = conv_s2d.to_s2d(torch.from_numpy(x))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jconv.to_s2d(jnp.asarray(x))))
    np.testing.assert_array_equal(conv_s2d.from_s2d(xs).numpy(), x)
    np.testing.assert_array_equal(conv_s2d.max_pool_2x2_s2d(xs).numpy(),
                                  np.asarray(jconv.max_pool_2x2_s2d(jconv.to_s2d(jnp.asarray(x)))))
    args = [torch.from_numpy(a) for a in (w, s, t)]
    jargs = [jnp.asarray(a) for a in (w, s, t)]
    np.testing.assert_allclose(
        conv_s2d.conv3x3_affine_relu_s2d_pre(xs, *args).numpy(),
        np.asarray(jconv.conv3x3_affine_relu_s2d_pre(jconv.to_s2d(jnp.asarray(x)), *jargs)),
        atol=5e-6)
    g = rng.randn(2, 10, 12, 32).astype(np.float32)
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    y = conv_s2d.conv3x3_affine_relu_s2d(xt, wt, args[1], args[2])
    (y * torch.from_numpy(g)).sum().backward()
    jy, jvjp = jax.vjp(lambda a, b: jconv.conv3x3_affine_relu_s2d(a, b, *jargs[1:]),
                       jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=5e-6)
    for got, want in zip((xt.grad, wt.grad), jvjp(jnp.asarray(g))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="even width"):
        conv_s2d.conv3x3_affine_relu_s2d(torch.zeros(1, 4, 5, 64), *args)


def test_gauss2_s2d_route_matches_jax(monkeypatch):
    """The gauss2 fused forward under conv_impl='s2d' at 128x128 (inc's
    second conv, 64 channels at 16,384 px, takes the s2d form; every other
    layer the plain route) against the JAX package's with
    sp_pallas.CONV_IMPL = 's2d': within 2e-6, the bar of the other fused
    routes; and against the port's plain route within the same bar."""
    from deepfepe_tpu.frontend import sp_pallas
    from deepfepe_tpu_torch.frontend import sp_fused

    jnet = JSuperPointNetGauss2(dtype=jnp.float32)
    v = flax_variables(jnet, (1, 128, 128, 1))
    net = SuperPointNetGauss2().eval()
    net.load_state_dict(superpoint_state_from_flax(v), strict=True)
    x = np.random.RandomState(4).rand(2, 128, 128, 1).astype(np.float32)
    monkeypatch.setattr(sp_pallas, "CONV_IMPL", "s2d")
    want = sp_pallas.superpoint_forward_fused(jnet, v, jnp.asarray(x))
    routes = []
    real = sp_fused._backend
    monkeypatch.setattr(sp_fused, "_backend", lambda y, impl: routes.append(real(y, impl))
                        or routes[-1])
    with torch.no_grad():
        got = superpoint_forward_fused(net, torch.from_numpy(x), "s2d")
        plain = superpoint_forward_fused(net, torch.from_numpy(x), "xla")
    assert routes[:len(routes) // 2].count("s2d") == 1 and "kernel" not in routes
    for k in ("semi", "desc"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-6, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), plain[k].numpy(), atol=2e-6, err_msg=k)


# The bars `chip_smoke.py` holds val_feature (b) under 's2d' to against the
# plain route on the card: the two routes sum the same float32 convs in
# another order, so keypoints can swap only at near-equal scores.
S2D_VF_BARS = {"num_matches_rel": 0.005, "num_matches_abs": 1.0, "ratio_matches": 2.0}


def test_val_feature_s2d_route_matches_the_plain_route(tmp_path, monkeypatch):
    """val_feature with a seeded gauss2 at 128x160 (inc's second conv takes
    the s2d form) through the fused forward, 's2d' against 'xla': launches
    none, num_matches within S2D_VF_BARS (1 + 0.5% of the plain route's;
    measured here: equal) and every ratio within 2 / num_matches."""
    from deepfepe_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    v = flax_variables(JSuperPointNetGauss2(dtype=jnp.float32), (1, 128, 160, 1))
    ckpt = tmp_path / "g2.pth.tar"
    torch.save({"n_iter": 0, "model_state_dict": superpoint_state_from_flax(v)}, ckpt)
    out = {}
    for impl in ("s2d", "xla"):
        fp = FrontendParams(out_num_points=300, conf_thresh=1e-3, conv_backend="fused",
                            conv_impl=impl)
        out[impl] = cli.val_feature(f"vf_{impl}", max_batches=2, pretrained=str(ckpt), fp=fp,
                                    image_size=(128, 160), batch_size=2, device="cpu")
    a, b = out["s2d"], out["xla"]
    assert b["num_matches"] > 10
    assert abs(a["num_matches"] - b["num_matches"]) <= (S2D_VF_BARS["num_matches_abs"]
                                                         + S2D_VF_BARS["num_matches_rel"]
                                                         * b["num_matches"])
    for k in ("ratio@0.1", "ratio@0.5", "ratio@1.0", "ratio@2.0"):
        assert abs(a[k] - b[k]) <= S2D_VF_BARS["ratio_matches"] / b["num_matches"], k
