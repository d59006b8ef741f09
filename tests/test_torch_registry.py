"""Port parity, scene files and training on a voxel volume
(``fvsrn_tpu_torch/modules/registry.py``, ``train/main.py``'s scene JSON
files, ``train/{world,importance,screen}.py`` with a grid as ground
truth): the port against the JAX package on the same files and seeds.

- ``load_from_json``: every module resolved from the JAX package's own
  test scene (``tests/test_registry.py``'s ``_SCENE``) and from a scene
  with a ``"Grid"`` ``.cvol`` volume, texture and gradient-scaled TFs, a
  shading BRDF, voxel stepsizes, a Rayleigh phase function, equal to
  JAX's within 1e-7.
- World data on a grid: positions exact, densities within 1e-6, colors
  within the TF's slope times that; importance-sampled positions exact;
  the loss grid within 1e-6; the screen dataset's targets within 1e-5.
- ``train.main.run`` on a scene JSON with a 16^3 grid, 2 epochs, in world
  mode and in screen mode at 16x16 (the fused route): losses within 1e-4
  relative, as tests/test_torch_world.py and tests/test_torch_train.py
  hold them.

CPU only, small sizes."""
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.network_volume import VolumeInterpolationNetwork as JVol
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.modules.registry import load_from_json as jload
from fvsrn_tpu.train import importance as jimp
from fvsrn_tpu.train import main as jmain
from fvsrn_tpu.train import world as jworld
from fvsrn_tpu.train.screen import build_screen_dataset as jbuild_screen
from fvsrn_tpu.volume.volume import Volume as JVolume
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.models.network_volume import VolumeInterpolationNetwork
from fvsrn_tpu_torch.modules.registry import load_from_json
from fvsrn_tpu_torch.train import importance, main, world
from fvsrn_tpu_torch.train.screen import build_screen_dataset
from fvsrn_tpu_torch.utils import prng
from fvsrn_tpu_torch.volume.grid import VolumeInterpolationGrid
from fvsrn_tpu_torch.volume.volume import Volume
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)
CPU = "cpu"
HERE = os.path.dirname(os.path.abspath(__file__))
# densities within 1e-6; the TF's steepest slope is 20 per unit density
DENSITY_ATOL = 1e-6
COLOR_ATOL = 20 * DENSITY_ATOL


def jax_test_scene() -> dict:
    """``_SCENE`` of the JAX package's registry test."""
    spec = importlib.util.spec_from_file_location(
        "jax_registry_test", os.path.join(HERE, "test_registry.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._SCENE


def smooth_grid(shape=(16, 16, 16), seed=0):
    """(X, Y, Z) float32 densities in [0, 1], seeded, no symmetry."""
    rng = np.random.default_rng(seed)
    axes = [np.linspace(-1, 1, n) for n in shape]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    f = 0.55 + 0.35 * np.sin(2.3 * x + 1.1 * y ** 2 - 0.7 * z + 0.3) \
        * np.cos(1.4 * z + 0.6 * x) + 0.05 * rng.random(shape)
    return np.clip(f, 0, 1).astype(np.float32)


def grid_scene(tmp_path, shape=(16, 16, 16), world_size=(1.0, 1.0, 1.0),
               rich=False) -> str:
    """A scene JSON beside a ``.cvol`` grid (relative path); ``rich``
    adds a texture and a gradient-scaled Gaussian TF, a shading BRDF,
    voxel stepsizes, tricubic sampling, MC with Rayleigh."""
    v = Volume(world_size=world_size)
    v.add_feature("density", smooth_grid(shape))
    v.save(str(tmp_path / "grid.cvol"), compression=1)
    scene = {
        "ImageEvaluator": {"Simple": {
            "selectedCamera": "Sphere", "selectedRayEvaluator": "DVR",
            "selectedVolume": "Grid"}},
        "RayEvaluation": {"DVR": {"stepsize": 0.03125, "minDensity": 0.0,
                                  "maxDensity": 1.0,
                                  "selectedTF": "Piecewise"}},
        "camera": {"Sphere": {"center": [0.0, 0.0, 0.0], "distance": 1.7,
                              "pitch": 0.4, "yaw": 0.7}},
        "tf": {"Piecewise": {
            "absorptionScaling": 20.0,
            "colorPoints": [[0.0, 0.9, 0.4, 0.1], [1.0, 1.0, 1.0, 0.6]],
            "opacityPoints": [[0.0, 0.0], [1.0, 1.0]]}},
        "volume": {"Grid": {"source": "VOLUME", "volumePath": "grid.cvol",
                            "interpolation": "TRILINEAR"}},
    }
    if rich:
        scene["ImageEvaluator"]["Simple"]["samplesPerIterationLog2"] = 2
        scene["RayEvaluation"] = {
            "DVR": {"stepsize": 2.0, "stepsizeIsObjectSpace": True,
                    "minDensity": 0.1, "maxDensity": 0.9, "earlyOut": False,
                    "selectedTF": "Texture"},
            "Iso": {"isovalue": 0.4, "stepsize": 0.002},
            "MonteCarlo": {"numBounces": 4, "lightRadius": 0.2,
                           "selectedPhaseFunction": "Rayleigh"}}
        scene["blending"] = {"blending": {"blending": "Alpha"}}
        scene["brdf"] = {"Lambert": {
            "enablePhong": True, "ambient": 0.2, "specular": 0.3,
            "magnitudeCenter": 0.4, "magnitudeRadius": 0.2,
            "lightType": "Point", "lightPosition": [0.3, 1.2, -0.4],
            "specularExponent": 12}}
        scene["tf"]["Texture"] = {
            "absorptionScaling": 7.0,
            "colorPoints": [[0.0, 0.1, 0.2, 0.9], [0.6, 0.8, 0.3, 0.1],
                            [1.0, 1.0, 1.0, 1.0]],
            "opacityPoints": [0.0, 0.1, 0.5, 0.2, 0.9, 1.0]}
        scene["tf"]["Gaussian"] = {
            "absorptionScaling": 3.0,
            "points": [[1.0, 0.2, 0.2, 0.6, 0.7, 0.05],
                       [0.2, 0.9, 0.4, 0.3, 0.3, 0.1]],
            "scaleWithGradient": True,
            "usePiecewiseAnalyticIntegration": True}
        scene["tf"]["Identity"] = {"absorptionScaling": 4.0,
                                   "emissionScaling": 0.5}
        scene["volume"]["Grid"]["interpolation"] = "TRICUBIC"
        scene["volume"]["Implicit"] = {"function": "MarschnerLobb"}
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(scene))
    return str(path)


def _arr(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def assert_same(got, want, what):
    """A port module against the JAX module: every field within 1e-7."""
    kind = type(want).__name__
    assert type(got).__name__ == kind, what
    close = dict(rtol=0, atol=1e-7, err_msg=what)
    if kind == "CameraOnASphere":
        for f in ("center", "pitch_yaw_distance"):
            np.testing.assert_allclose(_arr(getattr(got, f)),
                                       _arr(getattr(want, f)), **close)
        assert got.orientation == want.orientation
        assert got.fov_y_radians == pytest.approx(want.fov_y_radians,
                                                  abs=1e-7)
    elif kind == "TransferFunctionIdentity":
        np.testing.assert_allclose(_arr(got.scale_absorption_emission),
                                   _arr(want.scale_absorption_emission),
                                   **close)
    elif kind.startswith("TransferFunction"):
        np.testing.assert_allclose(_arr(got.tensor), _arr(want.tensor),
                                   **close)
        for f in ("analytic", "scale_with_gradient",
                  "preintegration_mode"):
            assert getattr(got, f, None) == getattr(want, f, None), what
    elif kind == "VolumeInterpolationImplicit":
        assert got.equation == want.equation
        for f in ("box_min", "box_size"):
            np.testing.assert_allclose(_arr(getattr(got, f)),
                                       _arr(getattr(want, f)), **close)
    elif kind == "VolumeInterpolationGrid":
        for f in ("data", "box_min", "box_size"):
            np.testing.assert_allclose(_arr(getattr(got, f)),
                                       _arr(getattr(want, f)), **close)
        assert got.interpolation == want.interpolation
        assert got.old_resolution_behavior == want.old_resolution_behavior
    elif kind in ("RayEvaluationSteppingDvr", "RayEvaluationSteppingIso",
                  "RayEvaluationMonteCarlo", "BRDFLambert",
                  "PhaseFunctionHenyeyGreenstein"):
        fields = {
            "RayEvaluationSteppingDvr": (
                "stepsize", "alpha_early_out", "density_min", "density_max",
                "blend_mode", "enable_early_out", "need_normals"),
            "RayEvaluationSteppingIso": (
                "stepsize", "isovalue", "binary_search_steps",
                "surface_feature"),
            "RayEvaluationMonteCarlo": (
                "density_min", "density_max", "light_position",
                "light_radius", "light_intensity", "color_scaling",
                "num_bounces", "max_iterations"),
            "BRDFLambert": (
                "magnitude_scaling", "ambient", "specular",
                "magnitude_center", "magnitude_radius", "specular_exponent",
                "enable_magnitude_scaling", "enable_phong", "light_type"),
            "PhaseFunctionHenyeyGreenstein": ("g",)}[kind]
        for f in fields:
            g, w = getattr(got, f), getattr(want, f)
            if isinstance(w, (str, bool)):
                assert g == w, (what, f)
            else:
                np.testing.assert_allclose(np.asarray(g, np.float64),
                                           np.asarray(w, np.float64),
                                           rtol=0, atol=1e-7,
                                           err_msg=f"{what}.{f}")
        if kind == "BRDFLambert":
            np.testing.assert_allclose(np.asarray(got.light),
                                       _arr(want.light_parameter), **close)
    elif kind != "PhaseFunctionRayleigh":
        raise AssertionError(f"{what}: no comparison for {kind}")


def assert_scene_same(got, want):
    for name in ("cameras", "volumes", "tfs", "ray_evaluators"):
        g, w = getattr(got, name), getattr(want, name)
        assert sorted(g) == sorted(w), name
        for key in w:
            assert_same(g[key], w[key], f"{name}[{key}]")
    for name in ("brdf", "phase", "mc_config"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            assert_same(g, w, name)
    assert got.selected == want.selected and got.raw == want.raw
    ev, jev = got.evaluator, want.evaluator
    for name in ("camera", "volume", "tf", "ray_config", "brdf"):
        g, w = getattr(ev, name), getattr(jev, name)
        assert (g is None) == (w is None), name
        if w is not None:
            assert_same(g, w, f"evaluator.{name}")
    assert (ev.samples, ev.ray_mode) == (jev.samples, jev.ray_mode)


def test_registry_jax_test_scene_matches_jax():
    scene = jax_test_scene()
    got, want = load_from_json(scene), jload(scene)
    assert want.evaluator.volume.equation == "BARTH"
    assert "Iso" in got.ray_evaluators and got.mc_config.num_bounces == 3
    assert_scene_same(got, want)


@pytest.mark.parametrize("rich", [False, True])
def test_registry_grid_scene_matches_jax(tmp_path, rich):
    """A ``"Grid"`` volume read from a ``.cvol`` beside the scene file,
    with (``rich``) every TF kind, a shading BRDF (so the DVR evaluator
    needs normals), a stepsize of 2 voxels and a Rayleigh phase."""
    path = grid_scene(tmp_path, shape=(12, 16, 10),
                      world_size=(1.2, 1.6, 1.0), rich=rich)
    got, want = load_from_json(path), jload(path)
    assert_scene_same(got, want)
    grid = got.volumes["Grid"]
    assert isinstance(grid, VolumeInterpolationGrid)
    assert grid.resolution == (12, 16, 10)
    np.testing.assert_allclose(grid.box_size.numpy(), [0.75, 1.0, 0.625],
                               rtol=1e-6)
    if rich:
        dvr = got.ray_evaluators["DVR"]
        assert dvr.need_normals and dvr.stepsize == pytest.approx(2 / 16)
        assert got.evaluator.brdf is not None
        assert got.evaluator.tf is got.tfs["Texture"]


def test_registry_volume_override_and_missing_file(tmp_path):
    path = grid_scene(tmp_path)
    os.remove(str(tmp_path / "grid.cvol"))
    got, want = load_from_json(path), jload(path)
    assert got.volumes == {} and want.volumes == {}
    assert got.evaluator.volume is None
    grid = VolumeInterpolationGrid.from_grid(smooth_grid((4, 5, 6)))
    assert load_from_json(path, volume_override=grid).evaluator.volume \
        is grid
    with pytest.raises(ValueError, match="no loadable volume"):
        main._resolve_scene(path)
    with pytest.raises(ValueError, match="no loadable volume"):
        jmain._resolve_scene(path)


def test_registry_grid_loads_jax_written_file(tmp_path):
    """The scene's ``.cvol`` written by the JAX package resolves to the
    same grid in both packages."""
    path = grid_scene(tmp_path, shape=(9, 8, 7))
    v = JVolume(world_size=(0.9, 0.8, 0.7))
    v.add_feature("density", smooth_grid((9, 8, 7), seed=3))
    v.save(str(tmp_path / "grid.cvol"), compression=1)
    assert_same(load_from_json(path).volumes["Grid"],
                jload(path).volumes["Grid"], "grid")


TF_KW = dict(rgb=[[0.9, 0.4, 0.1], [1.0, 1.0, 0.6]], opacity=[0.0, 20.0],
             positions=[0.0, 1.0])


def grids(tmp_path):
    path = grid_scene(tmp_path, shape=(12, 14, 16), world_size=(1, 1, 1))
    return jload(path), load_from_json(path)


@pytest.mark.parametrize("with_tf", [False, True])
def test_build_world_dataset_on_grid(tmp_path, with_tf):
    jsc, sc = grids(tmp_path)
    want = jworld.build_world_dataset(
        jsc.evaluator.volume, 2000, sampler="halton",
        tf=jsc.evaluator.tf if with_tf else None, stepsize=0.5)
    got = world.build_world_dataset(
        sc.evaluator.volume, 2000, sampler="halton",
        tf=sc.evaluator.tf if with_tf else None, stepsize=0.5, device=CPU)
    np.testing.assert_array_equal(got.positions.numpy(),
                                  np.asarray(want.positions))
    np.testing.assert_allclose(got.targets.numpy(), np.asarray(want.targets),
                               rtol=0,
                               atol=COLOR_ATOL if with_tf else DENSITY_ATOL)


def test_importance_sampling_on_grid(tmp_path):
    """Positions accepted by the TF's absorption of the grid's densities
    (exact), their densities (1e-6) and colors."""
    jsc, sc = grids(tmp_path)
    want = jimp.importance_sampling(jax.random.PRNGKey(2),
                                    jsc.evaluator.volume, 400,
                                    tf=jsc.evaluator.tf, min_prob=0.05,
                                    oversample=2)
    got = importance.importance_sampling(prng.prng_key(2),
                                         sc.evaluator.volume, 400,
                                         tf=sc.evaluator.tf, min_prob=0.05,
                                         oversample=2, device=CPU)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=DENSITY_ATOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0,
                               atol=COLOR_ATOL)


def test_loss_probability_grid_on_grid(tmp_path):
    """|network - grid| at the 8^3 voxel centers (1e-6), then positions
    accepted against it (exact)."""
    jsc, sc = grids(tmp_path)
    jnet = JSRN.make(layers="16:16", activation="SnakeAlt:2", num_fourier=4,
                     latent=JLatent(static_grid=(np.random.default_rng(3)
                                                 .standard_normal(
                                                     (4, 8, 8, 8)) * 0.3)
                                    .astype(np.float32)), seed=3)
    net = srn_from_arrays(*network_arrays(jnet))
    jgrid = np.asarray(jimp.loss_probability_grid(
        JVol.make(jnet), jsc.evaluator.volume, resolution=8, chunk=200))
    grid = importance.loss_probability_grid(
        VolumeInterpolationNetwork(net), sc.evaluator.volume, resolution=8,
        chunk=200, device=CPU)
    np.testing.assert_allclose(grid.detach().numpy(), jgrid, rtol=0,
                               atol=1e-6)
    want = jimp.importance_sampling_with_probability_grid(
        jax.random.PRNGKey(8), jsc.evaluator.volume, jgrid, 300,
        min_prob=0.05)
    got = importance.importance_sampling_with_probability_grid(
        prng.prng_key(8), sc.evaluator.volume, torch.from_numpy(jgrid.copy()),
        300, min_prob=0.05, device=CPU)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=DENSITY_ATOL)


def test_build_screen_dataset_on_grid(tmp_path):
    """Ground-truth renders of the grid by the plain march: 2 cameras at
    16x16, 1/64, targets within 1e-5."""
    jsc, sc = grids(tmp_path)
    jcfg = jsc.evaluator.ray_config.replace(stepsize=np.float32(1 / 64))
    from fvsrn_tpu_torch.raytracer.dvr import RayEvaluationSteppingDvr
    cfg = RayEvaluationSteppingDvr.make(
        **dict(sc.evaluator.ray_config.__dict__, stepsize=1 / 64))
    want = jbuild_screen(jsc.evaluator.volume, jsc.evaluator.tf, jcfg,
                         num_cameras=2, width=16, height=16)
    got = build_screen_dataset(sc.evaluator.volume, sc.evaluator.tf, cfg,
                               num_cameras=2, width=16, height=16,
                               device=CPU)
    assert float(got.targets[..., 3].max()) > 0.5
    np.testing.assert_allclose(got.targets.numpy(), np.asarray(want.targets),
                               rtol=0, atol=1e-5)


WORLD = ["--mode", "world", "--layers", "16:16", "--fouriercount", "4",
         "--volumetric_features_channels", "4",
         "--volumetric_features_resolution", "8",
         "--volumetric_features_std", "0.3", "--samples", "1024",
         "--batch_size", "256", "-lr", "0.01", "--seed", "6", "-i", "2"]
SCREEN = ["--mode", "screen", "--screen_cameras", "1", "--screen_size", "16",
          "--stepsize", "0.03125", "--layers", "32:32:32",
          "--volumetric_features_channels", "4",
          "--volumetric_features_resolution", "8",
          "--volumetric_features_std", "0.3", "-i", "2", "-lr", "0.001",
          "--seed", "5"]


@pytest.mark.parametrize("mode", ["world", "screen"])
def test_trainer_on_grid_scene_matches_jax(tmp_path, mode):
    """``train.main.run`` on a scene JSON whose volume is a 16^3 ``.cvol``
    grid, 2 epochs (screen: one 16x16 camera through the fused route):
    losses within 1e-4 relative of the JAX ``run``, falling."""
    scene = grid_scene(tmp_path)
    args = WORLD if mode == "world" else SCREEN
    want = jmain.run(vars(jmain.init_parser().parse_args(
        [scene, str(tmp_path / "jax.hdf5")] + args)))
    got = main.run(vars(main.init_parser().parse_args(
        [scene, str(tmp_path / "port.npz")] + args + ["--device", "cpu"])))
    assert len(got["history"]) == 2
    assert got["history"][1] < got["history"][0]
    if mode == "screen":
        assert want["fused"] and got["fused"]
    np.testing.assert_allclose(got["history"], want["history"], rtol=1e-4)
