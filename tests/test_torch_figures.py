"""Port parity, figure generation (``fvsrn_tpu_torch/eval/figures.py``
against ``fvsrn_tpu/eval/figures.py``): from the same JSONs written by
the test under ``tmp_path`` (the JAX files' names and schemas), both
packages write the same three file names, and the port's are valid PNGs;
the bench history's title names the input's device, or none; ``main``
without ``--root`` stops with an argparse error (no default root: the
repository's JSONs are the TPU package's)."""
import json
import os

import pytest
from PIL import Image

from fvsrn_tpu.eval import figures as jfigures
from fvsrn_tpu_torch.eval import figures

CHARTS = ("fig_compression", "fig_bench_history", "fig_scaling")
NAMES = ["bench_history.png", "compression_rd.png", "scaling.png"]


def write_inputs(root, device=None):
    comp = {f"{codec}@{q}": {"bytes": 1000 * (i + 1) * (j + 1),
                             "psnr": 20.0 + 5 * i + j}
            for j, codec in enumerate(("tthresh", "dwt", "quantize",
                                       "tucker"))
            for i, q in enumerate(("a", "b", "c"))}
    comp["network"] = {"bytes": 2500, "psnr": 31.0}
    with open(os.path.join(root, "COMPRESSION_R05.json"), "w") as f:
        json.dump(comp, f)
    rounds = [{"value": 1.5, "forward_mrays": 4.0},
              {"parsed": {"value": 3.0, "train_fwd_bwd_mrays": 2.0}},
              {"value": 2.5, "forward_mrays": 9.0,
               "sparse_fwd_bwd_mrays": 5.0, "sparse_forward_mrays": 14.0}]
    for r, blob in enumerate(rounds, 1):
        if device and r == len(rounds):
            blob = dict(blob, device=device)
        with open(os.path.join(root, f"BENCH_r{r:02d}.json"), "w") as f:
            json.dump(blob, f)
    with open(os.path.join(root, "BENCH_r03_old.json"), "w") as f:
        json.dump({"value": 99.0}, f)     # skipped: not a round's file
    scaling = {"virtual_cpu_mesh_pinned": {"results": {
        "1": {"rays_per_s": 100.0, "efficiency_vs_linear": 1.0},
        "2": {"rays_per_s": 180.0, "efficiency_vs_linear": 0.9},
        "4": {"rays_per_s": 300.0, "efficiency_vs_linear": 0.75}}}}
    with open(os.path.join(root, "SCALING_r02.json"), "w") as f:
        json.dump(scaling, f)


def test_same_files_as_jax(tmp_path):
    root = tmp_path / "in"
    root.mkdir()
    write_inputs(str(root), device="NVIDIA H100 80GB HBM3")
    jout, pout = tmp_path / "jax", tmp_path / "port"
    jout.mkdir()
    import matplotlib
    matplotlib.use("Agg")
    made = [getattr(jfigures, c)(str(root), str(jout)) for c in CHARTS]
    assert all(made)
    assert figures.main(["--root", str(root), "--out", str(pout)]) == 0
    assert sorted(os.listdir(jout)) == sorted(os.listdir(pout)) == NAMES
    for name in NAMES:
        with Image.open(pout / name) as im:
            im.verify()
        with Image.open(pout / name) as im:
            assert im.format == "PNG" and min(im.size) > 100


def test_missing_inputs_make_no_chart(tmp_path):
    assert figures.main(["--root", str(tmp_path),
                         "--out", str(tmp_path / "o")]) == 0
    assert os.listdir(tmp_path / "o") == []


@pytest.mark.parametrize("device", ["NVIDIA H100 80GB HBM3", None])
def test_bench_title_names_the_device(tmp_path, monkeypatch, device):
    write_inputs(str(tmp_path), device=device)
    titles = []
    real = figures._style

    def spy(ax, title, *a):
        titles.append(title)
        return real(ax, title, *a)

    monkeypatch.setattr(figures, "_style", spy)
    import matplotlib
    matplotlib.use("Agg")
    assert figures.fig_bench_history(str(tmp_path), str(tmp_path))
    assert titles == ["Fused SRN DVR throughput by round (512², stepsize "
                      "1/512" + (f", {device}" if device else "") + ")"]
    assert "v5e" not in titles[0]


def test_root_is_required(capsys):
    with pytest.raises(SystemExit) as err:
        figures.main(["--out", "x"])
    assert err.value.code == 2
    assert "--root" in capsys.readouterr().err
