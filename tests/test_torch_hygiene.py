"""The port's boundaries: no JAX, no silent CPU fallback, a chip smoke
that fails where it cannot run."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import deepfepe_tpu_torch
from deepfepe_tpu_torch import cli
from deepfepe_tpu_torch.train.config import config_from_dict
from deepfepe_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "deepfepe_tpu_torch"
# The port reads flax checkpoints with its own decoder (utils/msgpack_io.py):
# the card's machine has neither flax nor the msgpack package.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "deepfepe_tpu")
# The card's machine has no OpenCV and no Pillow: the port reads and writes
# its frames with utils/image_io.py.
NO_IMAGE_LIBS = ("cv2", "PIL")


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _module_level_imports(tree):
    """Modules imported by the statements a module runs on import (its
    body, and the bodies of top-level if/try blocks), not inside functions."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, (ast.If, ast.Try)):
            stack += [*node.body, *node.orelse, *getattr(node, "finalbody", []),
                      *(s for h in getattr(node, "handlers", []) for s in h.body)]


def _has_cuda_mark(tree):
    return any(isinstance(n, ast.Attribute) and n.attr == "cuda"
               and isinstance(n.value, ast.Attribute) and n.value.attr == "mark"
               for n in ast.walk(tree))


def _env_without_cuda():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_importing_the_port_loads_no_jax():
    mods = [m.name for m in pkgutil.walk_packages([str(PKG)], "deepfepe_tpu_torch.")]
    assert "deepfepe_tpu_torch.cli" in mods and "deepfepe_tpu_torch.ops.eigh9" in mods
    for m in ("ops.conv", "ops.matcher", "frontend.pipeline", "frontend.sp_fused",
              "data.synthetic_images", "eval.frontend_eval", "train.joint", "loader",
              "utils.weights", "ops.epi_residual", "models.sample_fit",
              "ops.conv_formulations", "tools.bench_conv_formulations", "tools.profile_mlp",
              "tools.xconv_variants", "data.kitti", "data.native_loader", "data.dump_kitti",
              "data.synthetic_dump", "utils.image_io", "geometry.fivepoint",
              "eval.metrics_summary", "utils.msgpack_io", "data.synthetic_sequence",
              "eval.vo", "eval.kitti_odometry", "eval.tum", "eval.results",
              "eval.opencv_baseline", "run_eval", "utils.io", "utils.logging",
              "utils.profiling", "utils.warp", "geometry.homography", "frontend.train_sp",
              "tools.train_sp_full", "tools.finetune_sp_corners", "tools.train_joint_full",
              "tools.eval_joint_ckpts", "tools.vo_superpoint", "tools.sp_pipeline",
              "models.dsac", "utils.jpeg", "ops.conv_s2d", "eval.val_pipeline", "utils.vis",
              "utils.video", "frontend.sift", "ops.sift", "ops.knn2", "utils.native_build",
              "tools.dump_workflow", "tools.sift_blur_study"):
        assert f"deepfepe_tpu_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + NO_IMAGE_LIBS!r})\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env_without_cuda(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO))
                                        for p in [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]))
def test_no_source_imports_jax(path):
    bad = [m for m in _imports(REPO / path) if m.split(".")[0] in FORBIDDEN + NO_IMAGE_LIBS]
    assert not bad, f"{path} imports {bad}"


CARD_TEST_FILES = sorted(str(p.relative_to(REPO)) for p in (REPO / "tests").glob("test_torch_*.py")
                         if _has_cuda_mark(ast.parse(p.read_text())))


def test_the_card_tests_are_found():
    assert {"tests/test_torch_cuda_kernels.py", "tests/test_torch_eigh_card.py",
            "tests/test_torch_matcher_card.py", "tests/test_torch_mlp_card.py",
            "tests/test_torch_sift_card.py"} <= set(CARD_TEST_FILES)


@pytest.mark.parametrize("path", CARD_TEST_FILES)
def test_card_tests_import_no_jax_at_module_level(path):
    """The card's machine has no flax: a test file with `cuda` cases that
    imported JAX or the JAX package on import would never collect there."""
    bad = [m for m in _module_level_imports(ast.parse((REPO / path).read_text()))
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} has cuda cases and imports {bad} at module level"


def test_entry_points_default_to_the_card_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    cfg = config_from_dict({"data": {"batch_size": 1, "good_num": 20}})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.eval_good(cfg, 1, device=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["eval_good", str(REPO / "configs" / "synthetic_baseline.yaml"), "x"])
    assert deepfepe_tpu_torch.resolve_device is resolve_device


@pytest.mark.parametrize("tool,argv", [
    ("train_joint_full", ["--stage1_iters", "0", "--stage2_iters", "0"]),
    ("eval_joint_ckpts", ["--dir", "."]),
    ("vo_superpoint", ["--sp", "x.msgpack", "--cpu"]),
])
def test_joint_tools_need_the_card_unless_asked_for_the_cpu(monkeypatch, tmp_path, tool, argv):
    """Without a card the tools refuse before they read a file or draw a
    batch; `--cpu` is vo_superpoint's spelling of `--device cpu`."""
    import importlib

    mod = importlib.import_module(f"deepfepe_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in argv if a != "--cpu"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([*argv, "--out", str(tmp_path)] if tool != "eval_joint_ckpts" else argv)
    if tool == "vo_superpoint":
        with pytest.raises(FileNotFoundError):  # the CPU path reaches the checkpoint
            mod.main([*argv, "--out", str(tmp_path), "--cpu"])


def test_sift_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    import numpy as np

    from deepfepe_tpu_torch.data import dump_kitti
    from deepfepe_tpu_torch.tools import dump_workflow

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((32, 40), np.uint8)
    for call in (lambda: dump_kitti.sift_detect(img),
                 lambda: dump_kitti.knn_match(np.zeros((2, 128), np.float32),
                                              np.zeros((3, 128), np.float32)),
                 lambda: dump_kitti.match_pair(img, img),
                 lambda: dump_workflow.main(["--out", str(tmp_path / "dw")]),
                 lambda: cli.infer("a.png", "b.png", "x.msgpack")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert dump_kitti.sift_detect(img, device="cpu")[0].shape == (0, 2)


def test_train_good_needs_the_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    cfg = config_from_dict({"data": {"batch_size": 1, "good_num": 20}})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.train_good(cfg, "x", train_iter=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train_good", str(REPO / "configs" / "synthetic_baseline.yaml"), "x",
                  "--train_iter", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["eval_good", str(REPO / "configs" / "synthetic_baseline.yaml"), "x",
                  "--pretrained", "missing.pth.tar"])
    joint = config_from_dict({"data": {"dataset": "synthetic_images", "batch_size": 1},
                              "model": {"if_SP": True, "mlp_dtype": "float32"}})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.train_good(joint, "x", train_iter=1)
    assert not (tmp_path / "logs").exists()


def test_val_feature_needs_the_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.val_feature("x", max_batches=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["val_feature", "x", "--max_batches", "1"])
    assert not (tmp_path / "logs").exists()
    summary = cli.val_feature("x", max_batches=1, device="cpu")
    assert summary["device"] == "cpu" and summary["pairs"] == 2
    assert (tmp_path / "logs" / "x" / "result_dict_all.npz").exists()


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         env=_env_without_cuda(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "no CUDA device" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=_env_without_cuda(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "deepfepe_tpu_torch" in out.stderr


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("fault", ["c1_next_item", "c2_next_item", "stats_straddle_next_item",
                                   "epi_unsafe_norm_grad", "epi_tie_blocked",
                                   "epi_cluster_drop_rank", "xconv_tap_shift",
                                   "matcher_fold_last_index", "eigh9_warp_skip_rotation",
                                   "xconv_halo_top_row", "xconv_s2d_next_ky",
                                   "xconv_strip_halo_column", "xconv_tile_next_halo"])
def test_chip_smoke_kernel_faults_name_one_source_line(fault):
    """Each `--plant` kernel fault changes a line that occurs once in its
    module's CUDA source, and the module can bind the faulty build."""
    import importlib

    smoke = _chip_smoke()
    assert fault in smoke.FAULTS
    name, line, changed = smoke.SOURCE_FAULTS[fault]
    mod = importlib.import_module(f"deepfepe_tpu_torch.ops.{name}")
    src = (PKG / "csrc" / mod.SOURCE).read_text()
    assert src.count(line) == 1 and changed not in src
    assert callable(mod.bind)
