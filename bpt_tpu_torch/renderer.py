"""Progressive renderer: explicit accumulation state + the counter FSM.

Port of ``bpt_tpu.renderer``.  Still camera → sample_counter += 1; any motion
→ sample_counter resets to 1 and the first moving frame sets
frame_counter = 1, which clears the accumulation history.  The counters are
Python floats on the host, so reading them never waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from bpt_tpu_torch.camera import Camera
from bpt_tpu_torch.core.rng import blue_noise_table
from bpt_tpu_torch.device import default_device
from bpt_tpu_torch.integrator.config import IntegratorConfig
from bpt_tpu_torch.integrator.frame import finish_frame
from bpt_tpu_torch.kernels.megakernel import trace_image_fused
from bpt_tpu_torch.postprocess import screen_output
from bpt_tpu_torch.scenes.types import Scene
from bpt_tpu_torch.utils.profiling import span, spanned


class RenderState(NamedTuple):
    """Everything progressive rendering needs to resume."""

    accum: torch.Tensor  # (H, W, 4) running radiance sum + alpha edge flags
    sample_counter: float  # uSampleCounter
    frame_counter: float  # uFrameCounter


def init_state(height: int, width: int, device=None, dtype=torch.float32) -> RenderState:
    return RenderState(accum=torch.zeros((height, width, 4), dtype=dtype, device=device),
                       sample_counter=0.0, frame_counter=0.0)


def next_counters(state: RenderState, camera_is_moving: bool) -> tuple[float, float]:
    """(frame_counter, sample_counter) of the next frame.  While moving the
    sample counter pins to 1, and the frame counter resets to 1 only on the
    first moving frame (detected by sample_counter != 1)."""
    was_still = state.sample_counter != 1.0
    frame_counter = 1.0 if (camera_is_moving and was_still) else state.frame_counter + 1.0
    sample_counter = 1.0 if camera_is_moving else state.sample_counter + 1.0
    return frame_counter, sample_counter


def step_state(scene: Scene, camera: Camera, cfg: IntegratorConfig, state: RenderState,
               camera_is_moving: bool, rand_vec2, blue_noise: torch.Tensor,
               fast_quads: bool | None = None) -> RenderState:
    """One progressive frame: the radiance pass ``trace_image_fused`` (the
    CUDA kernel on CUDA tensors, its plain version on CPU ones; its
    ``fast_quads``), then edge detection and accumulation in
    ``finish_frame``."""
    frame_counter, sample_counter = next_counters(state, camera_is_moving)
    height, width = state.accum.shape[0], state.accum.shape[1]
    result = trace_image_fused(scene, camera, cfg, width, height, frame_counter, rand_vec2, blue_noise,
                               fast_quads=fast_quads)
    with span("bpt.renderer.finish"):
        accum = finish_frame(result, state.accum, frame_counter, camera_is_moving)
    return RenderState(accum=accum, sample_counter=sample_counter, frame_counter=frame_counter)


class ProgressiveRenderer:
    """Host-side render loop: owns the scene on its device, the config and the
    accumulation state, and detects camera motion.

    Every frame compares the camera's 16-float world matrix with the last
    one's, as the reference does, so a camera edited in place
    (``cam.position.add_(...)``) counts as moving just as a new one does.

    It runs on the card: ``device=None`` means ``"cuda"`` and raises where
    there is none.  The radiance pass is ``trace_image_fused``: the CUDA
    kernel on a CUDA device, its plain version (``trace_image``) on
    ``device="cpu"``.

    ``fast_quads`` is the radiance pass's quad test: None (decided per quad
    geometry) unless ``attach_cuda_path`` decided it for the scene.
    ``batch_step``, None unless installed (``kernels.integration``
    ``attach_cuda_path(reorder=True)``), traces several still-camera frames
    at once: ``batch_step(scene, camera, cfg, state, rand_vec2s,
    blue_noise) -> RenderState`` for the (k, 2) float32 offsets of k frames,
    equal to k single steps.
    """

    def __init__(self, scene: Scene, cfg: IntegratorConfig, height: int, width: int,
                 blue_noise=None, seed: int = 0, device=None):
        self.device = default_device(device)
        self.scene = scene.to(self.device)
        self.cfg = cfg
        self.height = height
        self.width = width
        bn = blue_noise if blue_noise is not None else blue_noise_table()
        self.blue_noise = torch.as_tensor(bn, dtype=torch.float32).to(self.device).contiguous()
        self.state = init_state(height, width, self.device)
        self._np_rng = np.random.default_rng(seed)
        self._last_cam_matrix: Optional[np.ndarray] = None
        self._cam_on_device: tuple = (None, None)
        self.fast_quads: bool | None = None
        self.batch_step = None

    def camera_moved(self, camera: Camera) -> bool:
        """Whether the world matrix differs from the last frame's (always
        True on the first frame)."""
        m = camera.world_matrix().cpu().numpy()
        moved = self._last_cam_matrix is None or not np.array_equal(m, self._last_cam_matrix)
        self._last_cam_matrix = m
        return moved

    def _device_camera(self, camera: Camera) -> Camera:
        """The camera on the renderer's device.  A camera already there is
        used as it is; another one is copied once per distinct set of values
        (keyed on its values, not on the object, so an edit in place makes
        a new copy): a copy from pageable host memory waits for the stream."""
        if all(t.device == self.blue_noise.device for t in camera):  # the resolved device ("cuda:0")
            return camera
        key = torch.cat([t.detach().reshape(-1).cpu() for t in camera])
        if self._cam_on_device[0] is None or not torch.equal(self._cam_on_device[0], key):
            self._cam_on_device = (key, camera.to(self.device))
        return self._cam_on_device[1]

    def _step(self, camera: Camera, moving: bool, rand_vec2) -> RenderState:
        self.state = step_state(self.scene, self._device_camera(camera), self.cfg, self.state,
                                moving, np.asarray(rand_vec2, np.float32), self.blue_noise, self.fast_quads)
        return self.state

    @spanned("bpt.renderer.frame")
    def render_sample(self, camera: Camera, force_reset: bool = False) -> RenderState:
        """Advance one frame; returns the new state (also stored)."""
        with span("bpt.renderer.camera"):
            moving = self.camera_moved(camera) or force_reset
            camera = self._device_camera(camera)
        return self._step(camera, moving, self._np_rng.random(2))

    def render(self, camera: Camera, spp: int, batch: int = 8) -> torch.Tensor:
        """Render spp progressive samples from scratch and return display rgb.

        The first sample goes through ``render_sample`` (the reset
        protocol); the others are drawn ``batch`` at a time as
        ``random((k, 2))`` of the renderer's numpy generator, the same
        stream as k draws of ``random(2)``, and go through ``batch_step``
        when one is installed (one staged pool of k frames), else one frame
        at a time.  Either way the accumulation is bit-equal to
        sample-at-a-time stepping.
        """
        self.state = init_state(self.height, self.width, self.device)
        self._last_cam_matrix = None
        self.render_sample(camera)  # the first sample handles the reset protocol
        done = 1
        while done < spp:
            k = min(max(batch, 1), spp - done)
            rand_vec2s = self._np_rng.random((k, 2)).astype(np.float32)
            if self.batch_step is None:
                for rand_vec2 in rand_vec2s:
                    self._step(camera, False, rand_vec2)
            else:
                self.state = self.batch_step(self.scene, self._device_camera(camera), self.cfg, self.state,
                                             rand_vec2s, self.blue_noise)
            done += k
        return self.display()

    @spanned("bpt.renderer.display")
    def display(self, apply_denoise: bool = True, exposure: float = 1.0) -> torch.Tensor:
        inv_n = np.float32(1.0) / np.float32(max(self.state.sample_counter, 1.0))
        return screen_output(self.state.accum, float(inv_n), exposure, apply_denoise)
