"""fvsrn_tpu_torch: the PyTorch and CUDA port of ``fvsrn_tpu`` for NVIDIA
Hopper (H100).

The JAX package stays the reference; module names here mirror it. This
package imports ``torch`` and ``numpy`` only. Entry points run on
``device="cuda"`` unless the caller asks for the CPU, where every CUDA
kernel is replaced by its plain PyTorch version.
"""
from .camera import CameraOnASphere, camera_matrix, generate_rays
from .inference import LoadedModel
from .models.network_volume import VolumeInterpolationNetwork
from .models.srn import SceneRepresentationNetwork
from .raytracer.dvr import RayEvaluationSteppingDvr, max_steps_bound, trace_dvr
from .raytracer.montecarlo import RayEvaluationMonteCarlo, trace_mc
from .transfer import TransferFunctionPiecewiseLinear

__all__ = [
    "CameraOnASphere", "camera_matrix", "generate_rays", "LoadedModel",
    "VolumeInterpolationNetwork", "SceneRepresentationNetwork",
    "RayEvaluationSteppingDvr", "max_steps_bound", "trace_dvr",
    "RayEvaluationMonteCarlo", "trace_mc",
    "TransferFunctionPiecewiseLinear",
]
