"""The one traffic generator: drives the port as a traffic mix's data file
says (``benchmark/traffic/<mix>.json``), and replays a sample of what it
produced on the plain reference.

A mix names its ``kind`` and that kind's parameters:

- ``train``: inverse-rendering jobs back to back, each the target render
  from the true parameters (no gradient) and then ``diff.inverse.optimize``
  from the initial ones, on the configuration's inverse problem
  (``train`` in its file: the parameter, frames a step, steps, lr, clip),
  on the fused route (``render_avg(fused=True)``, unsorted).  Job j traces
  the frame counters f_j .. f_j + frames - 1, f_j drawn from the seed, so
  no two jobs trace the same rays.  Set-up runs job 0's first three steps
  through the window's own call, and the check follows them, read from
  Adam as it takes them: each step's loss, the first gradient (the first
  moment after one step over 1 - beta1) and the parameters that step 4
  would start from.
- ``render``: a closed loop of one viewer; each request a view of the
  orbit, ``ProgressiveRenderer.render(camera, spp, batch)`` (display
  included) and a sync, on the staged batch step
  (``attach_cuda_path(reorder=True)``).
- ``interactive``: a closed loop of one user dragging the view; each
  request ``render_sample`` of the next camera of a closed drag over the
  orbit, ``display()`` and a sync, on the renderer's CUDA path
  (``attach_cuda_path``, no batch step).

The views are a fixed set: ``views`` cameras on the configuration's orbit
(around ``orbit_center`` at the base camera's distance, yaw and pitch
spread over the mix's ranges).  The seed orders them (render: a
permutation, cycled; interactive: the start and direction of the drag), so
every seed does the same work in another order.  Render checks compare the
display at the inner pixels of ``patches`` 8x8 patches of ``checks``
requests drawn from the seed (reservoir sampling over the window) against
``benchmark.reference.render``.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time

import numpy as np
import torch
from torch.optim import optimizer

from benchmark import sides

STEP_HISTORY = 24  # interactive checks replay this many earlier frames: 0.5**25 of the history is below float32's reach
OFF_TOLERANCE = 1e-4  # a display value further than this from the reference's counts as off


def sync(device) -> None:
    """Wait for the card's queue (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize()


class Spans:
    """The benchmark's host spans: (name, start, end) by ``perf_counter``,
    and, while a profiler runs, a ``record_function`` range of the same name."""

    def __init__(self):
        self.records: list = []
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = torch.profiler.record_function(name) if self.profiling else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
        self.records.append((name, t0, time.perf_counter()))

    def total(self, name: str) -> tuple[float, int]:
        """(seconds, count) of the spans named ``name``."""
        ends = [b - a for n, a, b in self.records if n == name]
        return sum(ends), len(ends)


def orbit_views(spec: dict, mix: dict) -> list[tuple]:
    """The mix's fixed set of views: (position, yaw, pitch) on the
    configuration's orbit."""
    cam, center = spec["camera"], np.asarray(spec["orbit_center"], np.float64)
    radius = float(np.linalg.norm(np.asarray(cam["position"], np.float64) - center))
    n = int(mix["views"])
    out = []
    for i in range(n):
        s = (i + 0.5) / n
        yaw = mix["yaw"][0] + (mix["yaw"][1] - mix["yaw"][0]) * s
        pitch = mix["pitch"][0] + (mix["pitch"][1] - mix["pitch"][0]) * (0.5 + 0.5 * math.sin(2 * math.pi * s))
        forward = np.array([math.sin(yaw) * math.cos(pitch), -math.sin(pitch), math.cos(yaw) * math.cos(pitch)])
        out.append((tuple(float(x) for x in center - radius * forward), float(yaw), float(pitch)))
    return out


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``rng``."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def wants(self) -> int | None:
        """The slot the next item goes to, or None; counts it as offered."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = int(self.rng.integers(0, self.seen))
        return j if j < self.k else None


class Kind:
    """One traffic kind on one cell: ``setup`` (warm-up, and for train the
    check's steps), ``unit`` (one job or request of the window), ``release``
    (frees the program's state), ``check`` (the reference's comparison)."""

    def __init__(self, cell):
        self.cell = cell
        self.spec, self.mix, self.config = cell.spec, cell.mix, cell.config
        self.device = cell.device
        self.size = int(self.spec["size"])
        self.bounces = int(self.spec["integrator"]["bounces"])
        self.rng = np.random.default_rng([cell.seed, 7])
        self.spans = cell.spans

    def ref_blue_noise(self) -> torch.Tensor:
        from benchmark.reference.core.rng import blue_noise_table

        return torch.as_tensor(blue_noise_table()).to(self.device)


class Train(Kind):
    def setup(self):
        from bpt_tpu_torch.camera import Camera
        from bpt_tpu_torch.integrator.config import IntegratorConfig

        train = self.spec["train"]
        self.steps, self.lr, self.n_frames = int(train["steps"]), float(train["lr"]), int(train["frames"])
        self.clip = train["clip"]
        self.inputs = self.cell.inputs
        self.true, self.init = self.config.train_values(self.spec, self.inputs, self.device)
        self.base = self.config.program_scene(self.inputs, self.device)
        self.camera = sides.camera(Camera, self.spec["camera"]).to(self.device)
        self.cfg = sides.integrator(IntegratorConfig, self.spec)
        self.bn = self.ref_blue_noise()
        self.frame_starts = self.rng.integers(1, 1 << 20, size=1 << 16)
        self.jobs = 0
        self.cell.mark("the program's scene")
        self.record = self._check_job()

    def _frames(self, j: int) -> tuple:
        f0 = float(self.frame_starts[j % len(self.frame_starts)])
        return tuple(f0 + i for i in range(self.n_frames))

    def _target(self, frames) -> torch.Tensor:
        from bpt_tpu_torch.diff.inverse import render_avg

        with torch.no_grad():
            return render_avg(self.config.apply(self.base, self.true), self.camera, self.cfg, self.size, frames,
                              np.array([0.3, 0.7], np.float32), self.bn, fused=True)

    def _fit(self, frames, target, steps: int):
        from bpt_tpu_torch.diff.inverse import optimize

        apply, base, camera = self.config.apply, self.base, self.camera
        clip = None if self.clip is None else (
            lambda p, lo=self.clip[0], hi=self.clip[1]: {k: torch.clamp(v, lo, hi) for k, v in p.items()})
        return optimize(lambda p: (apply(base, p), camera), self.init, target, self.cfg, self.size,
                        steps=steps, lr=self.lr, frames=frames, param_clip=clip, fused=True, device=self.device)

    def _check_job(self) -> dict:
        """The first three steps of job 0, with Adam's read as it takes them;
        the parameters they leave (step 3's update and clip) are those step
        4 would start from."""
        seen: dict = {"step": 0}

        def pre(opt, args, kwargs):
            seen["step"] += 1
            if seen["step"] == 1:
                self.cell.mark("job 0: step 1's forward and backward")

        def post(opt, args, kwargs):
            if seen["step"] == 1:
                beta1 = opt.param_groups[0]["betas"][0]
                seen["grad"] = [opt.state[p]["exp_avg"].detach().clone() / (1.0 - beta1)
                                for p in opt.param_groups[0]["params"]]
                self.cell.mark("job 0: step 1's Adam update")

        hooks = [optimizer.register_optimizer_step_pre_hook(pre),
                 optimizer.register_optimizer_step_post_hook(post)]
        try:
            frames = self._frames(0)
            target = self._target(frames)
            self.cell.mark("job 0: the target (the first launch loads the kernels)")
            result = self._fit(frames, target, 3)
            self.jobs = 1
        finally:
            for h in hooks:
                h.remove()
        self.cell.mark("job 0: steps 2 and 3")
        return {"frames": frames, "losses": [float(x) for x in result.losses],
                "grad": dict(zip(self.init, seen["grad"])), "params": {k: v.clone() for k, v in result.params.items()}}

    def unit(self) -> dict:
        frames = self._frames(self.jobs)
        with self.spans("job"):
            self._fit(frames, self._target(frames), self.steps)
        with self.spans("sync"):
            sync(self.device)
        self.jobs += 1
        return {"steps": self.steps}

    def release(self):
        self.base = None

    def first_view(self) -> None:
        """The view of the window's first unit: a train job has the base camera alone."""
        return None

    def check(self, control: bool = False) -> dict:
        """{number: value}: the worst step's loss gap, and the gaps of the
        first gradient's norm and of the parameters' change after three
        steps, each relative to the reference's (one leaf: its own norm).
        ``control``: the reference in bfloat16 in the program's place."""
        from benchmark.reference import train as ref_train
        from benchmark.reference.camera import Camera
        from benchmark.reference.integrator.config import IntegratorConfig

        scene = self.config.reference_scene(self.inputs, self.device)
        camera = sides.camera(Camera, self.spec["camera"]).to(self.device)
        cfg = sides.integrator(IntegratorConfig, self.spec)

        def follow(lowp):
            return ref_train.follow(scene, camera, cfg, self.size, self.record["frames"],
                                    np.array([0.3, 0.7], np.float32), self.bn, self.config.apply, self.true, self.init,
                                    self.lr, None if self.clip is None else tuple(self.clip), steps=3, lowp=lowp)

        ref = follow(False)
        rec = follow(True) if control else self.record
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"], ref["losses"]))
        grad_gap = change_gap = 0.0
        for k in self.init:
            g_ref = float(torch.linalg.vector_norm(ref["grad"][k]))
            g_prog = float(torch.linalg.vector_norm(rec["grad"][k]))
            grad_gap = max(grad_gap, abs(g_prog - g_ref) / g_ref)
            init = torch.as_tensor(self.init[k], device=self.device)
            c_ref = float(torch.linalg.vector_norm(ref["params"][k] - init))
            c_prog = float(torch.linalg.vector_norm(rec["params"][k] - init))
            change_gap = max(change_gap, abs(c_prog - c_ref) / c_ref)
            print(f"{k}: losses {rec['losses']} against {ref['losses']}; first gradient's norm {g_prog!r} against "
                  f"{g_ref!r}; change's norm after three steps {c_prog!r} against {c_ref!r}", file=sys.stderr)
        return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


class _Viewer(Kind):
    """What the render kinds share: the renderer, the views, the sampled
    displays and their replay on the reference.  ``REORDER``: whether the
    renderer's CUDA path takes the staged batch step."""

    REORDER = False

    def __init__(self, cell):
        super().__init__(cell)
        self.views = orbit_views(self.spec, self.mix)
        self.renderer_seed = int(self.rng.integers(0, 1 << 31))
        self.order = self._order()

    def first_view(self) -> int:
        """The view of the window's first request, the one after the warm-up's."""
        return self.order[int(self.mix["warmup"]) % len(self.order)]

    def setup(self):
        from bpt_tpu_torch.camera import Camera
        from bpt_tpu_torch.integrator.config import IntegratorConfig
        from bpt_tpu_torch.kernels.integration import attach_cuda_path
        from bpt_tpu_torch.renderer import ProgressiveRenderer

        self.inputs = self.cell.inputs
        self.cfg = sides.integrator(IntegratorConfig, self.spec)
        self.cameras = [sides.camera(Camera, self.spec["camera"], *v) for v in self.views]
        self.bn = self.ref_blue_noise()
        self.renderer = ProgressiveRenderer(self.config.program_scene(self.inputs, self.device), self.cfg, self.size,
                                            self.size, blue_noise=self.bn, seed=self.renderer_seed,
                                            device=self.device)
        if self.device.type == "cuda":
            attach_cuda_path(self.renderer, reorder=self.REORDER)
        if self.cell.trace and isinstance(self, Render):  # spans around the renderer's own calls, for the breakdown
            r = self.renderer
            for name in ("render_sample", "display") + (("batch_step",) if r.batch_step is not None else ()):
                setattr(r, name, self._spanned(name, getattr(r, name)))
        self.frames_drawn = 0  # the renderer's draws of random(2), one per frame
        self.requests = 0
        self.sample = Reservoir(int(self.mix["checks"]), np.random.default_rng([self.cell.seed, 11]))
        self.cell.mark("the program's scene and renderer")
        for _ in range(int(self.mix["warmup"])):
            self.unit(keep=False)
        self.sample = Reservoir(self.sample.k, self.sample.rng)

    def _spanned(self, name: str, fn):
        def call(*args, **kwargs):
            with self.spans(name):
                return fn(*args, **kwargs)

        return call

    def _keep(self, image: torch.Tensor, meta: dict) -> None:
        slot = self.sample.wants()
        if slot is not None:
            self.sample.items[slot] = (image.clone(), meta)

    def release(self):
        self.renderer = None

    def rand_vec2(self, frame: int) -> np.ndarray:
        """The renderer's blue-noise offset of its ``frame``-th frame: draws
        2 frame and 2 frame + 1 of its numpy generator, as float32."""
        draws = np.random.default_rng(self.renderer_seed).random(2 * (frame + 1))
        return draws[2 * frame: 2 * frame + 2].astype(np.float32)

    def check(self, control: bool = False) -> dict:
        """{number: value}: the share of compared display values further
        than OFF_TOLERANCE from the reference's, over the sampled requests.
        ``control``: the reference in bfloat16 in the program's place."""
        from benchmark.reference.camera import Camera
        from benchmark.reference.integrator.config import IntegratorConfig
        from benchmark.reference.render import PATCH, display_patches

        scene = self.config.reference_scene(self.inputs, self.device)
        cfg = sides.integrator(IntegratorConfig, self.spec)
        cameras = [sides.camera(Camera, self.spec["camera"], *v).to(self.device) for v in self.views]
        rng = np.random.default_rng([self.cell.seed, 13])
        n_patches = int(self.mix["patches"])
        off = total = 0
        for image, meta in [item for item in self.sample.items if item is not None]:
            xy = rng.integers(0, (self.size - PATCH) // 2 + 1, size=(n_patches, 2)) * 2
            origins = torch.as_tensor(xy, dtype=torch.int64)
            frames = self.replay(meta, cameras)
            ref = display_patches(scene, cfg, self.size, self.size, frames, origins, self.bn)
            if control:
                got = display_patches(scene, cfg, self.size, self.size, frames, origins, self.bn, lowp=True)
            else:
                got = torch.stack([image[y + 2: y + 6, x + 2: x + 6] for x, y in xy.tolist()])
            off += int((torch.abs(got - ref) > OFF_TOLERANCE).sum())
            total += got.numel()
        print(f"{off} of {total} display values off by more than {OFF_TOLERANCE} over "
              f"{len([i for i in self.sample.items if i is not None])} requests", file=sys.stderr)
        return {"off_share": off / max(total, 1)}


class Render(_Viewer):
    REORDER = True

    def _order(self) -> list:
        return [int(i) for i in self.rng.permutation(len(self.views))]

    def unit(self, keep: bool = True) -> dict:
        spp, batch = int(self.mix["spp"]), int(self.mix["batch"])
        v = self.order[self.requests % len(self.order)]
        first = self.frames_drawn
        t0 = time.perf_counter()
        with self.spans("request"):
            image = self.renderer.render(self.cameras[v], spp=spp, batch=batch)
            sync(self.device)
        latency = time.perf_counter() - t0
        self.frames_drawn += spp
        self.requests += 1
        if keep:
            self._keep(image, {"view": v, "first": first, "spp": spp})
        return {"latency_s": latency, "rays": self.size * self.size * self.bounces * spp, "view": v}

    def replay(self, meta: dict, cameras) -> list:
        from benchmark.reference.render import Frame, next_counters

        frames, sample, frame = [], 0.0, 0.0
        for k in range(meta["spp"]):
            moving = k == 0  # render() resets the state and the last camera: its first sample moves
            frame, sample = next_counters(sample, frame, moving)
            frames.append(Frame(cameras[meta["view"]], frame, sample, self.rand_vec2(meta["first"] + k), moving))
        return frames


class Interactive(_Viewer):
    def _order(self) -> list:
        """A closed drag over the views: out along the orbit and back, from
        a seeded start, in a seeded direction."""
        n = len(self.views)
        loop = list(range(n)) + list(range(n - 2, 0, -1))
        start, step = int(self.rng.integers(0, len(loop))), 1 if self.rng.random() < 0.5 else -1
        return [loop[(start + step * i) % len(loop)] for i in range(len(loop))]

    def unit(self, keep: bool = True) -> dict:
        v = self.order[self.requests % len(self.order)]
        t0 = time.perf_counter()
        with self.spans("request"):
            with self.spans("render_sample"):
                self.renderer.render_sample(self.cameras[v])
            with self.spans("display"):
                image = self.renderer.display()
            sync(self.device)
        latency = time.perf_counter() - t0
        self.frames_drawn += 1
        self.requests += 1
        if keep:
            self._keep(image, {"frame": self.frames_drawn - 1})
        return {"latency_s": latency, "rays": self.size * self.size * self.bounces, "view": v}

    def replay(self, meta: dict, cameras) -> list:
        """The frame's last STEP_HISTORY + 1 frames (or all since the first):
        every frame moves, so the history is halved at each."""
        from benchmark.reference.render import Frame

        last = meta["frame"]
        first = max(0, last - STEP_HISTORY)
        return [Frame(cameras[self.order[g % len(self.order)]], float(g + 1), 1.0, self.rand_vec2(g), True)
                for g in range(first, last + 1)]


KINDS = {"train": Train, "render": Render, "interactive": Interactive}
