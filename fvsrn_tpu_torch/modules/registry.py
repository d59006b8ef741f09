"""Scene files: resolve a scene JSON into the port's modules.

Counterpart of ``fvsrn_tpu/modules/registry.py``: the reference's
scene-config JSON (cameras, TFs, volumes, blending, BRDF, ray
evaluators, phase functions, the image evaluator's selection) resolves
into camera, TF, volume, BRDF and ray-evaluator modules and an
``ImageEvaluatorSimple``. An "Implicit" volume is an analytic field; a
"Grid" volume is a ``.cvol`` file (its first feature), a missing file
giving no volume. Modules are built on the host; the entry points that
render or train move them to their device.
"""
from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..brdf import BRDFLambert
from ..camera import CameraOnASphere
from ..phase import PhaseFunctionHenyeyGreenstein, PhaseFunctionRayleigh
from ..raytracer.dvr import RayEvaluationSteppingDvr
from ..raytracer.evaluator import ImageEvaluatorSimple
from ..raytracer.iso import RayEvaluationSteppingIso
from ..raytracer.montecarlo import RayEvaluationMonteCarlo
from ..transfer import (TransferFunctionGaussian, TransferFunctionIdentity,
                        TransferFunctionPiecewiseLinear,
                        TransferFunctionTexture)
from ..volume.grid import VolumeInterpolationGrid
from ..volume.implicit import IMPLICIT_EQUATIONS, VolumeInterpolationImplicit
from ..volume.volume import Volume

GRID_INTERPOLATION = {"NEAREST_NEIGHBOR": "nearest",
                      "TRILINEAR": "trilinear",
                      "TRICUBIC": "tricubic"}


@dataclass
class SceneConfig:
    """The resolved modules of one scene JSON."""
    evaluator: ImageEvaluatorSimple
    cameras: dict
    volumes: dict
    tfs: dict
    ray_evaluators: dict
    brdf: Any = None
    phase: Any = None
    mc_config: Optional[RayEvaluationMonteCarlo] = None
    raw: dict = field(default_factory=dict)
    selected: dict = field(default_factory=dict)


def _camel_to_const(name: str) -> str:
    return re.sub(r"(?<=[a-z0-9])(?=[A-Z])", "_", name).upper()


def _load_camera(j: dict) -> CameraOnASphere:
    return CameraOnASphere.make(
        center=tuple(j.get("center", (0, 0, 0))),
        pitch=j.get("pitch", 0.0), yaw=j.get("yaw", 0.0),
        distance=j.get("distance", 1.0),
        orientation=j.get("orientation", "Ym"),
        fov_y_radians=j.get("fovY", 0.7853981633974483))


def _load_tf(kind: str, j: dict):
    """The TF of kind ``kind``, or None when it has no points."""
    scale = j.get("absorptionScaling", 1.0)
    if kind == "Identity":
        return TransferFunctionIdentity.make(
            absorption=scale, emission=j.get("emissionScaling", 1.0))
    if kind == "Gaussian":
        pts = np.asarray(j.get("points", []), np.float32)
        if pts.size == 0:
            return None
        # rows (r, g, b, opacity, mean, variance); opacity scaled
        tensor = pts.copy()
        tensor[:, 3] *= scale
        return TransferFunctionGaussian(
            torch.from_numpy(tensor),
            analytic=j.get("usePiecewiseAnalyticIntegration", False),
            scale_with_gradient=j.get("scaleWithGradient", False))
    if kind == "Piecewise":
        color_pts = np.asarray(j.get("colorPoints", []), np.float32)
        opacity_pts = np.asarray(j.get("opacityPoints", []), np.float32)
        if color_pts.size == 0 or opacity_pts.size == 0:
            return None
        # colorPoints rows (pos, r, g, b), opacityPoints rows (pos, o),
        # merged on the union of positions
        pos = np.unique(np.concatenate([color_pts[:, 0],
                                        opacity_pts[:, 0]]))
        rgb = np.stack([np.interp(pos, color_pts[:, 0], color_pts[:, k])
                        for k in (1, 2, 3)], axis=1)
        opacity = np.interp(pos, opacity_pts[:, 0],
                            opacity_pts[:, 1]) * scale
        return TransferFunctionPiecewiseLinear.make(
            rgb.tolist(), opacity.tolist(), pos.tolist())
    if kind == "Texture":
        color_pts = np.asarray(j.get("colorPoints", []), np.float32)
        opacity = np.asarray(j.get("opacityPoints", []), np.float32)
        if color_pts.size == 0 or opacity.size == 0:
            return None
        r = len(opacity)
        centers = (np.arange(r) + 0.5) / r
        rgb = np.stack([np.interp(centers, color_pts[:, 0],
                                  color_pts[:, k]) for k in (1, 2, 3)],
                       axis=1)
        tensor = np.concatenate(
            [rgb, (opacity * scale)[:, None]], axis=1).astype(np.float32)
        return TransferFunctionTexture(torch.from_numpy(tensor))
    return None


def _load_volume(kind: str, j: dict, base_dir: str):
    if kind == "Implicit":
        fn = j.get("function", "Sphere")
        const = _camel_to_const(fn)
        if const not in IMPLICIT_EQUATIONS:
            raise ValueError(f"unknown implicit function {fn}")
        return VolumeInterpolationImplicit.make(const)
    if kind == "Grid":
        if j.get("source") != "VOLUME":
            return None
        path = j.get("volumePath", "")
        if not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        if not os.path.exists(path):
            return None
        vol = Volume.load(path)
        ws = vol.world_size
        return VolumeInterpolationGrid.from_grid(
            vol.density,
            interpolation=GRID_INTERPOLATION.get(
                j.get("interpolation", "TRILINEAR"), "trilinear"),
            box_size=np.asarray(ws, np.float64) / max(max(ws), 1e-8))
    return None


def load_from_json(path_or_dict, volume_override=None) -> SceneConfig:
    """Resolve a scene JSON (a path, or its dict with paths relative to
    the working directory). ``volume_override`` replaces the selected
    volume."""
    if isinstance(path_or_dict, dict):
        j = path_or_dict
        base_dir = os.getcwd()
    else:
        with open(path_or_dict) as f:
            j = json.load(f)
        base_dir = os.path.dirname(os.path.abspath(path_or_dict))

    cameras = {name: _load_camera(cj)
               for name, cj in j.get("camera", {}).items()}
    tfs = {}
    for name, tj in j.get("tf", {}).items():
        tf = _load_tf(name, tj)
        if tf is not None:
            tfs[name] = tf
    volumes = {}
    for name, vj in j.get("volume", {}).items():
        try:
            v = _load_volume(name, vj, base_dir)
        except ValueError:
            v = None
        if v is not None:
            volumes[name] = v

    blend = j.get("blending", {}).get("blending", {}) \
        .get("blending", "BeerLambert")
    blend_mode = "beer_lambert" if blend == "BeerLambert" else "alpha"

    brdf_j = j.get("brdf", {}).get("Lambert", {})
    directional = brdf_j.get("lightType", "Directional") == "Directional"
    brdf = BRDFLambert.make(
        enable_phong=brdf_j.get("enablePhong", False),
        enable_magnitude_scaling=brdf_j.get("enableMagnitudeScaling",
                                            False),
        magnitude_scaling=brdf_j.get("magnitudeScaling", 1.0),
        ambient=brdf_j.get("ambient", 0.0),
        specular=brdf_j.get("specular", 0.0),
        magnitude_center=brdf_j.get("magnitudeCenter", 0.0),
        magnitude_radius=brdf_j.get("magnitudeRadius", 0.0),
        light=tuple(brdf_j.get("lightDirection", (0, 0, -1))) if directional
        else tuple(brdf_j.get("lightPosition", (0, 0, 1))),
        light_type="direction" if directional else "point",
        specular_exponent=int(brdf_j.get("specularExponent", 8)))

    # normals where the BRDF shades or scales by the gradient, or a TF is
    # gradient-scaled
    need_normals = bool(brdf.enable_phong
                        or brdf.enable_magnitude_scaling
                        or any(getattr(tf, "scale_with_gradient", False)
                               for tf in tfs.values()))

    ray_evaluators = {}
    rj = j.get("RayEvaluation", {})

    def _world_step(d, default=1 / 256):
        """Object-space stepsizes above 1 count voxels: divided by the
        largest resolution of the grid volumes (256 without one)."""
        s = d.get("stepsize", default)
        if d.get("stepsizeIsObjectSpace", False):
            res = 256
            for v in volumes.values():
                if hasattr(v, "resolution"):
                    res = max(v.resolution)
            s = s / res if s > 1 else s
        return s

    if "DVR" in rj:
        d = rj["DVR"]
        ray_evaluators["DVR"] = RayEvaluationSteppingDvr.make(
            stepsize=_world_step(d),
            density_min=d.get("minDensity", 0.0),
            density_max=d.get("maxDensity", 1.0),
            enable_early_out=d.get("earlyOut", True),
            blend_mode=blend_mode,
            need_normals=need_normals)
    if "Iso" in rj:
        d = rj["Iso"]
        ray_evaluators["Iso"] = RayEvaluationSteppingIso.make(
            stepsize=d.get("stepsize", 1 / 256),
            isovalue=d.get("isovalue", 0.5))
    mc_config = None
    phase = None
    if "MonteCarlo" in rj:
        d = rj["MonteCarlo"]
        mc_config = RayEvaluationMonteCarlo.make(
            density_min=d.get("minDensity", 0.0),
            density_max=d.get("maxDensity", 1.0),
            light_radius=d.get("lightRadius", 0.5),
            light_intensity=d.get("lightIntensity", 1.0),
            color_scaling=d.get("colorScaling", 1.0),
            num_bounces=d.get("numBounces", 2))
        pj = j.get("phase", {})
        if d.get("selectedPhaseFunction", "") == "Rayleigh":
            phase = PhaseFunctionRayleigh.make()
        else:
            phase = PhaseFunctionHenyeyGreenstein.make(
                g=pj.get("Henyey-Greenstein", {}).get("g", 0.0))

    simple = j.get("ImageEvaluator", {}).get("Simple", {})
    sel_cam = simple.get("selectedCamera", "Sphere")
    sel_ray = simple.get("selectedRayEvaluator", "DVR")
    sel_vol = simple.get("selectedVolume", "")
    sel_tf = rj.get(sel_ray, {}).get("selectedTF", "")

    camera = cameras.get(sel_cam) or next(iter(cameras.values()), None)
    volume = volume_override or volumes.get(sel_vol) \
        or next(iter(volumes.values()), None)
    tf = tfs.get(sel_tf) or next(iter(tfs.values()), None)
    ray_config = ray_evaluators.get(sel_ray) \
        or next(iter(ray_evaluators.values()), None)
    log2 = simple.get("samplesPerIterationLog2", 0)
    evaluator = ImageEvaluatorSimple(
        camera=camera, volume=volume, tf=tf, ray_config=ray_config,
        brdf=brdf if (brdf.enable_phong
                      or brdf.enable_magnitude_scaling) else None,
        samples=1, ray_mode="iso" if sel_ray == "Iso" else "dvr")
    return SceneConfig(
        evaluator=evaluator, cameras=cameras, volumes=volumes, tfs=tfs,
        ray_evaluators=ray_evaluators, brdf=brdf, phase=phase,
        mc_config=mc_config, raw=j,
        selected={"camera": sel_cam, "volume": sel_vol, "tf": sel_tf,
                  "ray": sel_ray, "samples": 2 ** log2 if log2 > 0 else 1})
