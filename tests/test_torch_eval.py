"""Port parity, the evaluation harnesses (``fvsrn_tpu_torch/eval/sweep.py``,
its six sweep scripts and ``eval/eval_volumetric_features.py``): the port
against the JAX package on the same seeds. Sweep rows (final loss and the
held-out world L1/L2, whose samples are JAX's draws bit for bit) agree
within the 1e-4 relative that ``test_torch_world.py`` holds the trainer's
history to; the scripts' entries and the CSV's columns are JAX's; the
render arm runs on the CPU through the plain versions. The harness's JSON
at 32^2 is JAX's but for the times (SSIM within 1e-4; LPIPS within 1e-5
relative given weights written here, null without). CPU only; no JAX
FUSED render (its interpret mode takes ~45 s at 32^2)."""
import argparse
import contextlib
import csv
import functools
import io
import json

import numpy as np
import pytest
import torch

from fvsrn_tpu.eval import eval_volumetric_features as jevf
from fvsrn_tpu.eval import sweep as jsweep
from fvsrn_tpu_torch.eval import eval_volumetric_features as evf
from fvsrn_tpu_torch.eval import sweep
from fvsrn_tpu_torch.utils import timer

torch.set_num_threads(1)

TRAIN_RTOL = 1e-4
# test_eval_sweep.py's world entries and an rgbo one
WORLD_CONFIGS = [
    ("relu", {"activation": "ReLU", "outputmode": "density"}),
    ("snake", {"activation": "SnakeAlt:2", "outputmode": "density"}),
    ("rgbo", {"outputmode": "rgbo"}),
]
WORLD_BASE = {"epochs": 3, "samples": 1024, "batch_size": 512, "lr": 0.01}
SCRIPTS = ["eval_network_configs", "eval_activation_functions",
           "eval_density_vs_color", "eval_fourier", "eval_importance",
           "eval_screen_vs_world"]
# the harness at 32^2, stepsize 1/32, 2 cameras, 2 quick-fit epochs
EVF_ARGV = ["--width", "32", "--height", "32", "--stepsize", "0.03125",
            "--cameras", "2", "--train-epochs", "2"]
SSIM_TOL = 1e-4
# FUSED (bf16 table, the lattice march) against PLAIN32 in SSIM: JAX's own
# harness reads 0.7684 against 0.7680 at this size
MODE_SSIM_TOL = 1e-3
TIME_KEYS = ("frame_ms_mean", "frame_ms_std", "mrays_per_s")


def header(path):
    with open(path, newline="") as f:
        return next(csv.reader(f))


def assert_rows(got, want):
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in ("final_loss", "world_l1", "world_l2"):
            np.testing.assert_allclose(g[key], w[key], rtol=TRAIN_RTOL,
                                       err_msg=f"{g['name']} {key}")


def test_run_sweep_world(tmp_path):
    """``run_sweep`` trains and scores JAX's rows: final loss and world
    L1/L2 within 1e-4 relative, the same CSV columns, one run file a
    row; ``networks`` receives the trained networks."""
    want = jsweep.run_sweep(WORLD_CONFIGS, base=WORLD_BASE,
                            scene="IMPLICIT:SPHERE",
                            out_dir=str(tmp_path / "jax"),
                            out_csv=str(tmp_path / "jax.csv"),
                            eval_samples=1024)
    nets = {}
    got = sweep.run_sweep(WORLD_CONFIGS, base=WORLD_BASE,
                          scene="IMPLICIT:SPHERE",
                          out_dir=str(tmp_path / "port"),
                          out_csv=str(tmp_path / "port.csv"),
                          eval_samples=1024, device="cpu", networks=nets)
    assert_rows(got, want)
    assert header(tmp_path / "port.csv") == header(tmp_path / "jax.csv")
    assert list(nets) == [n for n, _ in WORLD_CONFIGS]
    assert nets["rgbo"].output_mode == "rgbo"
    for name, _ in WORLD_CONFIGS:
        assert (tmp_path / "port" / f"{name}.npz").exists()


def test_sweep_main_csv(tmp_path):
    """``sweep_main``'s CSV has JAX's columns and rows (``--device cpu``);
    the default device is the card, which raises here."""
    def configs(args):
        return [("tiny", {"layers": "16", "fouriercount": 0,
                          "batch_size": 256})]
    argv = ["--scene", "IMPLICIT:SPHERE", "--epochs", "1", "--samples",
            "512"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert jsweep.sweep_main(configs, "jax", argv + [
            "--csv", str(tmp_path / "jax.csv"),
            "--out-dir", str(tmp_path / "jax")]) == 0
        assert sweep.sweep_main(configs, "port", argv + [
            "--csv", str(tmp_path / "port.csv"),
            "--out-dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert header(tmp_path / "port.csv") == header(tmp_path / "jax.csv")
    with open(tmp_path / "jax.csv") as f:
        want = list(csv.DictReader(f))
    with open(tmp_path / "port.csv") as f:
        got = list(csv.DictReader(f))
    assert_rows([{k: (float(v) if k != "name" else v) for k, v in r.items()}
                 for r in got],
                [{k: (float(v) if k != "name" else v) for k, v in r.items()}
                 for r in want])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sweep.sweep_main(configs, "port", argv + [
                "--out-dir", str(tmp_path / "card")])


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("script", SCRIPTS)
def test_script_configs(script, grid):
    """Each sweep script's entries equal JAX's, with ``--grid`` on and
    off (only ``eval_fourier`` reads it)."""
    import importlib
    jmod = importlib.import_module(f"fvsrn_tpu.eval.{script}")
    mod = importlib.import_module(f"fvsrn_tpu_torch.eval.{script}")
    args = argparse.Namespace(grid=grid)
    assert mod.configs(args) == jmod.configs(args)
    assert len(mod.configs(args)) >= 2


def test_render_arm_on_cpu(tmp_path, monkeypatch):
    """``render=True`` times one FUSED render of each trained net (at
    32x32 here, the sweeps' 128x128 on the card); on the CPU the render is
    the kernels' plain versions, density and rgbo heads alike."""
    monkeypatch.setattr(sweep, "_render_ms", functools.partial(
        sweep._render_ms, width=32))
    rows = sweep.run_sweep(
        [("density", {"outputmode": "density:direct",
                      "volumetric_features_channels": 4,
                      "volumetric_features_resolution": 8}),
         ("rgbo", {"outputmode": "rgbo",
                   "volumetric_features_channels": 4,
                   "volumetric_features_resolution": 8})],
        base={"epochs": 2, "samples": 1024, "batch_size": 512, "lr": 0.01},
        scene="IMPLICIT:SPHERE", out_dir=str(tmp_path), eval_samples=512,
        render=True, device="cpu")
    for r in rows:
        assert np.isfinite(r["render_ms"]) and r["render_ms"] > 0


def write_alex_weights(tmp_path, seed=5):
    """Torchvision- and v0.1-shaped AlexNet state dicts of seeded
    weights: (backbone path, linear path)."""
    rng = np.random.default_rng(seed)
    plan = [(64, 3, 11), (192, 64, 5), (384, 192, 3), (256, 384, 3),
            (256, 256, 3)]
    backbone, linear = {}, {}
    for i, (idx, (o, cin, k)) in enumerate(zip([0, 3, 6, 8, 10], plan)):
        backbone[f"features.{idx}.weight"] = torch.tensor(
            rng.normal(0, 0.1, (o, cin, k, k)).astype(np.float32))
        backbone[f"features.{idx}.bias"] = torch.tensor(
            rng.normal(0, 0.05, (o,)).astype(np.float32))
        linear[f"lin{i}.model.1.weight"] = torch.tensor(
            rng.uniform(0, 0.02, (1, o, 1, 1)).astype(np.float32))
    bpath, lpath = tmp_path / "alex.pth", tmp_path / "alex_lin.pth"
    torch.save(backbone, bpath)
    torch.save(linear, lpath)
    return str(bpath), str(lpath)


def test_eval_volumetric_features(tmp_path, monkeypatch):
    """The harness at 32^2, 1/32, 2 cameras, 2 quick-fit epochs. Without
    LPIPS weights the port's FUSED and PLAIN32 rows report LPIPS null with
    the note, and their SSIMs agree within 1e-3; given weights (the env
    fallbacks), the port's ``--modes PLAIN32`` JSON equals JAX's but for
    the times, SSIM within 1e-4 and LPIPS within 1e-5 relative."""
    monkeypatch.delenv("FVSRN_LPIPS_BACKBONE", raising=False)
    monkeypatch.delenv("FVSRN_LPIPS_LINEAR", raising=False)
    args = evf.parse_args(EVF_ARGV + ["--device", "cpu"])
    assert args.modes == ["FUSED", "PLAIN32"]
    model = evf.load_model(args)
    images = {}
    both = evf.evaluate(model, args, images=images)
    for mode in ("FUSED", "PLAIN32"):
        assert both[mode]["lpips_vs_reference"] is None
        assert "LPIPS weights" in both[mode]["lpips_note"]
        assert images[mode].shape == (32, 32, 4)
    assert abs(both["FUSED"]["ssim_vs_reference"]
               - both["PLAIN32"]["ssim_vs_reference"]) <= MODE_SSIM_TOL

    bpath, lpath = write_alex_weights(tmp_path)
    monkeypatch.setenv("FVSRN_LPIPS_BACKBONE", bpath)
    monkeypatch.setenv("FVSRN_LPIPS_LINEAR", lpath)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jevf.main(EVF_ARGV + ["--modes", "PLAIN32"])
    want = json.loads(buf.getvalue())
    args = evf.parse_args(EVF_ARGV + ["--modes", "PLAIN32", "--device",
                                      "cpu"])
    got = evf.evaluate(model, args)
    assert list(got) == list(want) == ["protocol", "PLAIN32"]
    assert got["protocol"] == want["protocol"]
    g, w = got["PLAIN32"], want["PLAIN32"]
    assert list(g) == list(w)
    assert abs(g["ssim_vs_reference"] - w["ssim_vs_reference"]) <= SSIM_TOL
    assert w["lpips_vs_reference"] is not None
    np.testing.assert_allclose(g["lpips_vs_reference"],
                               w["lpips_vs_reference"], rtol=1e-5,
                               atol=1e-4)   # both rounded to 4 decimals
    assert all(g[k] > 0 for k in TIME_KEYS if k != "frame_ms_std")


def test_timer_devices():
    """``GPUTimer`` and ``sync`` on an explicit CPU device use the host
    clock; a timer stopped before it starts raises; the default device is
    the card, which raises without one."""
    import time
    t = timer.GPUTimer("cpu")
    with pytest.raises(RuntimeError, match="not started"):
        t.stop()
    t.start()
    time.sleep(0.01)
    timer.sync("cpu")
    assert t.stop() >= 10.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            timer.GPUTimer()
        with pytest.raises(RuntimeError, match="CUDA"):
            timer.sync()
