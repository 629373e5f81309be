"""The staged multi-frame path: K2's wrapper, its plain version and the
driver that sorts lanes between phases.

Port of ``bpt_tpu.kernels.megakernel``'s staged mode: ``_state_layout``,
``_sort_key``, ``_trace_staged`` (and, through
``megakernel._PathReplay``, ``_prb_staged_fn``).  A pool holds F
progressive frames of H x W pixels as F·H·W lanes; lane i of phase 0 is
pixel (fslot, py, px) with i = (fslot·H + py)·W + px, its home.  The bounces
run in phases [lo, hi); between phases a key orders the lanes (dead ones
last) and ``torch.sort`` gives the permutation the next phase reads its
state through.  Every per-pixel output is written to the lane's home pixel
of the pool's (F, H, W) planes as it happens, so nothing is scattered home
at the end.

On CUDA tensors a phase launches the kernel of ``csrc/staged.cu``
(``launch_phase``) and the key the kernel of ``csrc/sort_key.cu``
(``launch_key``); on CPU tensors a phase runs ``trace_phase_reference``, the
plain version (``integrator.radiance.run_bounces`` on the pool, with the
same state in and out), and the key ``sort_key``, the key kernel's plain
version.  The sort and the permutations are real on both.  There is no
fallback: a failed build or launch raises.

The state between phases is an (F·H·W, 16) int32 tensor, one row per lane,
key-first: the words the key reads fill the row's first 32 bytes.  Words
0-2 ro and 3-5 rd (float32 bits), 6 the flags word (bit 0 alive, 1 spec, 2
sample_light, 3 coat_hit, bits 8-15 d_count, 16-31 prev_mat as int16), 7
the home index, 8-10 mask and 11 sharp (float32 bits), 12-13 the two RNG
words (uint32 bits), 14-15 zero.  A dead lane's row is zero in words 4-7
(so its flags say dead); the rest of it is unspecified.  With the rows the
kernel writes each warp's box of the origins (``phase_boxes``), from which
the key kernel's first pass takes the pool's box without reading the rows.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from bpt_tpu_torch.camera import generate_rays
from bpt_tpu_torch.core.rng import BlueNoise, RngState, blue_noise_offsets, frame_to_u32
from bpt_tpu_torch.geometry.triangles import resolve_fast_quads
from bpt_tpu_torch.integrator.radiance import PathState, check_supported, deferred_layout, init_paths, run_bounces
from bpt_tpu_torch.kernels import build, launch_args
from bpt_tpu_torch.scenes.types import is_textured
from bpt_tpu_torch.utils.profiling import span, spanned

KERNEL = "staged"
KEY_KERNEL = "sort_key"
STATE_WORDS = 16
#: The state row's words (see the module docstring): ro, rd, flags and home
#: in the first 32 bytes, then mask, sharp and the RNG pair.
RO_WORD, RD_WORD, FLAGS_WORD, HOME_WORD, MASK_WORD, SHARP_WORD, RNG_WORD = 0, 3, 6, 7, 8, 11, 12
_U32 = 0xFFFFFFFF
_ALIVE, _SPEC, _SAMPLE_LIGHT, _COAT = 1, 2, 4, 8
_DEAD_KEY = 1 << 30
KEY_MODES = ("oct-morton", "morton-oct", "dir-morton")
#: Launches of the phase kernel, one per phase, per configuration
#: (``launch_args.configuration``), forward and grads mode; also reached as
#: ``megakernel.STAGED_LAUNCHES``, zeroed by ``megakernel.reset_launches``.
STAGED_LAUNCHES = dict.fromkeys(launch_args.CONFIGURATIONS, 0)
STAGED_GRAD_LAUNCHES = dict.fromkeys(launch_args.CONFIGURATIONS, 0)
#: Launches of the key kernel, one per key (its two passes), per mode.
KEY_LAUNCHES = dict.fromkeys(KEY_MODES, 0)


class Pool(NamedTuple):
    """A pool's geometry and per-frame tables.  ``tables`` is one int32
    tensor on the pool's device: the F frame counters as uint32, their
    float32 bits, then each frame's blue-noise offset (ox, oy)."""

    width: int
    height: int  # rows per frame
    frames: int
    full_height: int  # rows of the film the rows belong to
    row_offset: int  # absolute row of the pool's first row
    tables: torch.Tensor

    @property
    def lanes(self) -> int:
        return self.frames * self.height * self.width


def make_pool(width: int, height: int, frame_counters, rand_vec2s, device, full_height: int | None = None,
              row_offset: int = 0) -> Pool:
    """The pool of ``len(frame_counters)`` frames of ``height`` rows starting
    at absolute row ``row_offset`` of a ``full_height``-row film.  Raises
    where the lanes would overflow a 32-bit index."""
    frames = [float(f) for f in frame_counters]
    offsets = [blue_noise_offsets(rv) for rv in rand_vec2s]
    if not frames or len(offsets) != len(frames):
        raise ValueError(f"{len(frames)} frame counters and {len(offsets)} rand_vec2 pairs: one pair per frame")
    full_height = height if full_height is None else full_height
    if width <= 0 or height <= 0 or row_offset < 0 or row_offset + height > full_height:
        raise ValueError(f"rows [{row_offset}, {row_offset + height}) of a {width}x{full_height} film")
    lanes = len(frames) * height * width
    if lanes >= 2 ** 31:
        raise ValueError(f"a pool of {lanes} lanes overflows the 32-bit lane index; trace fewer frames per pool")
    table = np.concatenate([np.array([frame_to_u32(f) for f in frames], np.uint32).view(np.int32),
                            np.array(frames, np.float32).view(np.int32),
                            np.array(offsets, np.int32).reshape(-1)])
    host = torch.from_numpy(table)
    device = torch.device(device)
    if device.type == "cuda":  # pinned, so that the copy does not wait for the stream
        tables = host.pin_memory().to(device, non_blocking=True)
    else:
        tables = host.to(device)
    return Pool(width, height, len(frames), full_height, row_offset, tables)


def phase_bounds(bounces: int, splits=None) -> list[int]:
    """[0, *splits, bounces]: the phases' bounce ranges.  ``splits`` None
    means one phase per bounce, as JAX's default."""
    splits = list(range(1, bounces)) if splits is None else [int(s) for s in splits]
    bounds = [0] + splits + [bounces]
    if any(b <= a for a, b in zip(bounds, bounds[1:])) and bounces > 0:
        raise ValueError(f"reorder_splits {splits} must increase strictly inside (0, {bounces})")
    return bounds if bounces > 0 else [0, 0]


# ---------------------------------------------------------------------------
# the sort key
# ---------------------------------------------------------------------------

#: bit k of a 6-bit value moved to bit 3k (the Morton spread), by value
_SPREAD = [sum(((q >> k) & 1) << (3 * k) for k in range(6)) for q in range(64)]


def _check_mode(mode: str) -> None:
    if mode not in KEY_MODES:
        raise ValueError(f"reorder_key {mode!r} is not one of {KEY_MODES}")


def _alive(state) -> torch.Tensor:
    return (state[:, FLAGS_WORD] & _ALIVE) != 0


def key_box(state) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi): the min and max of the live lanes' origins per axis, with
    a dead lane counted as +1e9 in the min and -1e9 in the max, as JAX's
    masked min and max (a pool with no live lane gets (1e9, -1e9)).  The
    key kernel's pass 1, in plain torch."""
    ro = state[:, RO_WORD:RO_WORD + 3].view(torch.float32)
    alive = _alive(state)[:, None]
    return torch.where(alive, ro, 1e9).amin(0), torch.where(alive, ro, -1e9).amax(0)


def key_from_box(state, lo, hi, mode: str = "oct-morton") -> torch.Tensor:
    """The key of every lane, its origin quantised over the box ``lo``,
    ``hi``: the key kernel's pass 2, in plain torch.  A live lane's origin
    goes to 64 cells per axis, clamp((ro - lo) / max(hi - lo, 1e-6) * 64, 0,
    63) truncated, the three axes spread through a 64-entry table into an
    18-bit Morton code (the same values as JAX's per-axis code, in a few
    passes over the pool); a dead lane gets 2^30."""
    _check_mode(mode)
    rays = state[:, RO_WORD:RD_WORD + 3].view(torch.float32).contiguous()  # one strided copy of ro, rd
    alive = _alive(state)
    ro, rd = rays[:, 0:3], rays[:, 3:6]
    q = torch.clamp((ro - lo) / torch.clamp(hi - lo, min=1e-6) * 64.0, 0.0, 63.0)
    q = torch.where(alive[:, None], q, 0.0).to(torch.int64)  # a dead row's words are unspecified: maybe NaN
    spread = torch.tensor(_SPREAD, dtype=torch.int32, device=ro.device)[q]
    morton = (spread[:, 0] << 2) | (spread[:, 1] << 1) | spread[:, 2]
    if mode == "dir-morton":
        qd = torch.clamp((rd * 0.5 + 0.5) * 4.0, 0.0, 3.0).to(torch.int32)
        key = (((qd[:, 0] << 4) | (qd[:, 1] << 2) | qd[:, 2]) << 18) | morton
    else:
        positive = (rd > 0).to(torch.int32)
        octant = (positive[:, 0] << 2) | (positive[:, 1] << 1) | positive[:, 2]
        key = (morton << 3) | octant if mode == "morton-oct" else (octant << 18) | morton
    return torch.where(alive, key, _DEAD_KEY).to(torch.int32)


def sort_key(state, mode: str = "oct-morton") -> torch.Tensor:
    """Per-lane int32 reorder key, the port of ``_sort_key`` and the plain
    version of the key kernel (``launch_key``): dead lanes last (key 2^30),
    live lanes by the direction octant and an 18-bit Morton code of the
    origin quantised to 64 cells per axis over the live lanes' box,
    ``key_from_box(state, *key_box(state), mode)``.

    ``mode``: "oct-morton" (octant, then Morton), "morton-oct" (Morton, then
    octant) or "dir-morton" (the direction quantised to 4 cells per axis,
    then Morton).  ``state`` is a phase's packed state.  A pool with no live
    lane gets the all-dead key."""
    return key_from_box(state, *key_box(state), mode)


# ---------------------------------------------------------------------------
# the plain phase
# ---------------------------------------------------------------------------

def _identity(pool: Pool, home: torch.Tensor):
    """(fslot, px, absolute py) of home indices."""
    hw = pool.height * pool.width
    return home // hw, home % pool.width, (home // pool.width) % pool.height + pool.row_offset


def _blue_noise(table: torch.Tensor, pool: Pool, fslot, px, py, count: int) -> BlueNoise:
    offsets = pool.tables[2 * pool.frames:].reshape(-1, 2).to(torch.int64)
    ix = torch.remainder(px + offsets[fslot, 0], table.shape[1])
    iy = torch.remainder(py + offsets[fslot, 1], table.shape[0])
    texel = torch.remainder(table[iy, ix], 1.0)
    return BlueNoise(r=texel[..., 0], g=texel[..., 1], b=texel[..., 2], a=texel[..., 3], count=count)


def _rows(outputs: dict, key: str) -> torch.Tensor | None:
    """An output plane as one row per pixel ((F·H·W, 3) or (F·H·W,)), or
    for the sg and deferred planes one column per pixel ((n, F·H·W)): a
    view."""
    t = outputs[key]
    if t is None:
        return None
    if key in ("out_sg", "out_def"):
        return t.view(t.shape[0], -1)
    return t.view(-1, 3) if t.shape[-1] == 3 and t.dim() == 4 else t.view(-1)


def trace_phase_reference(scene, camera, cfg, pool: Pool, blue_noise: torch.Tensor, state_in, perm, lo: int,
                          hi: int, outputs: dict, lane_counts: list | None = None, fast_quads: bool | None = None):
    """The plain version of one K2 launch: bounces [lo, hi) of every lane of
    ``pool``, reading lane i's state from row ``perm[i]`` of ``state_in``
    (phase 0: None, None; a fresh path per lane).  It writes the lanes'
    records, ended paths' color and sharpness and the grads mode's planes
    home into ``outputs`` (``launch_args.empty_outputs`` of (F, H, W), in
    place) and returns the state after the phase (None after the last).
    The mesh walk is the plain one; ``fast_quads`` the quad test, decided as
    the kernel's wrapper decides it."""
    fast_quads = resolve_fast_quads(scene.quads, fast_quads)
    dev = blue_noise.device
    lanes = pool.lanes
    last = hi >= cfg.bounces
    grads = outputs["out_sg"] is not None
    layout = deferred_layout(cfg, is_textured(scene.mesh)) if grads else {}
    if lo == 0:
        home = torch.arange(lanes, device=dev)
        alive0 = torch.ones(lanes, dtype=torch.bool, device=dev)
    else:
        rows = state_in.index_select(0, perm)
        alive0 = _alive(rows)
        rows = torch.where(alive0[:, None], rows, 0)  # a dead row's unspecified words stay out of the arithmetic
        home = rows[:, HOME_WORD].to(torch.int64)
    fslot, px, py = _identity(pool, home)
    frame = pool.tables[pool.frames:2 * pool.frames].view(torch.float32)[fslot]
    bn = _blue_noise(blue_noise, pool, fslot, px, py, 2 * lo)
    if lo == 0:
        fu = pool.tables[:pool.frames].to(torch.int64)[fslot] & _U32
        rng = RngState(sx=(px * fu) & _U32, sy=(py * ((fu + 1) & _U32)) & _U32)
        ro, rd, rng = generate_rays(camera, px, py, pool.width, pool.full_height, rng)
        state = init_paths(scene, cfg, ro, rd, rng, bn, frame, param_grads=grads)
    else:
        f = rows.view(torch.float32)
        flags = rows[:, FLAGS_WORD].to(torch.int64) & _U32
        prev_mat = (flags >> 16) & 0xFFFF
        rng = RngState(rows[:, RNG_WORD].to(torch.int64) & _U32, rows[:, RNG_WORD + 1].to(torch.int64) & _U32)
        state = init_paths(scene, cfg, f[:, RO_WORD:RO_WORD + 3], f[:, RD_WORD:RD_WORD + 3], rng, bn, frame,
                           param_grads=grads)
        state = state._replace(
            mask=f[:, MASK_WORD:MASK_WORD + 3], sharp=f[:, SHARP_WORD], alive=alive0, spec=(flags & _SPEC) != 0,
            sample_light=(flags & _SAMPLE_LIGHT) != 0, coat_hit=(flags & _COAT) != 0,
            d_count=((flags >> 8) & 0xFF).to(torch.int32),
            prev_mat=torch.where(prev_mat >= 0x8000, prev_mat - 0x10000, prev_mat).to(torch.int32),
            obj_normal=_rows(outputs, "out_normal")[home], obj_color=_rows(outputs, "out_ocolor")[home],
            obj_id=_rows(outputs, "out_oid")[home])
        if grads:
            sg = _rows(outputs, "out_sg")[:, home]
            n_lin = state.sg_lin.shape[0]
            state = state._replace(sg_lin=sg[:n_lin], sg_beer=None if state.sg_beer is None else sg[n_lin:])
        if layout:
            deferred = _rows(outputs, "out_def")[:, home]
            part = {name: deferred[first:first + count].T for name, (first, count) in layout.items()}
            uv = part.get("albedo_uv")
            state = state._replace(mw=part.get("mw"), mdir=part.get("mdir"), emw=part.get("emw"),
                                   em_uv=part.get("em_uv"),
                                   albedo_uv=None if uv is None else tuple(uv[:, 2 * b:2 * b + 2]
                                                                           for b in range(cfg.bounces)))
    state = run_bounces(scene, cfg, state, lo, hi, lane_counts=lane_counts, plain_walk=True, fast_quads=fast_quads)

    # ---- home writes: records and grads planes of the lanes that ran, ended paths' color and flag
    idx = home[alive0]
    _rows(outputs, "out_normal")[idx] = state.obj_normal[alive0]
    _rows(outputs, "out_ocolor")[idx] = state.obj_color[alive0]
    _rows(outputs, "out_oid")[idx] = state.obj_id[alive0]
    if grads:
        sg = state.sg_lin if state.sg_beer is None else torch.cat([state.sg_lin, state.sg_beer])
        _rows(outputs, "out_sg")[:, idx] = sg[:, alive0]
    if layout:  # the planes in the layout's order, as finish_paths writes them
        part = dict(mw=state.mw, mdir=state.mdir, emw=state.emw, em_uv=state.em_uv,
                    albedo_uv=None if state.albedo_uv is None else torch.cat(state.albedo_uv, dim=-1))
        deferred = torch.cat([part[name].T for name in layout])
        _rows(outputs, "out_def")[:, idx] = deferred[:, alive0]
    ended = alive0 & (~state.alive | last)
    _rows(outputs, "out_color")[home[ended]] = torch.clamp(state.accum[ended], min=0.0)
    _rows(outputs, "out_sharp")[home[ended]] = state.sharp[ended]
    return None if last else pack_state(state, home)


def pack_state(state: PathState, home: torch.Tensor) -> torch.Tensor:
    """The (lanes, 16) int32 rows of a phase's state (see the module
    docstring); dead lanes' rows are zero."""
    lanes = home.shape[0]
    out = torch.zeros((lanes, STATE_WORDS), dtype=torch.int32, device=home.device)
    f = out.view(torch.float32)
    f[:, RO_WORD:RO_WORD + 3], f[:, RD_WORD:RD_WORD + 3] = state.ro, state.rd
    f[:, MASK_WORD:MASK_WORD + 3], f[:, SHARP_WORD] = state.mask, state.sharp
    flags = (state.alive.to(torch.int64) * _ALIVE | state.spec.to(torch.int64) * _SPEC
             | state.sample_light.to(torch.int64) * _SAMPLE_LIGHT | state.coat_hit.to(torch.int64) * _COAT
             | ((state.d_count.to(torch.int64) & 0xFF) << 8) | ((state.prev_mat.to(torch.int64) & 0xFFFF) << 16))
    out[:, FLAGS_WORD] = flags.to(torch.int32)  # int64 -> int32 keeps the low 32 bits
    out[:, HOME_WORD] = home.to(torch.int32)
    out[:, RNG_WORD] = state.rng.sx.to(torch.int32)
    out[:, RNG_WORD + 1] = state.rng.sy.to(torch.int32)
    return torch.where(state.alive[:, None], out, 0)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

class _StagedArgs(ctypes.Structure):
    """``StagedArgs`` of csrc/staged.cu: K1's argument block, then the
    pool's pointers and integers (the C side reports its size)."""

    _fields_ = ([("t", launch_args.TraceArgs)]
                + [(name, ctypes.c_void_p) for name in ("state_in", "state_out", "boxes", "perm", "frame_u",
                                                        "frame_f", "bn_off")]
                + [("lanes", ctypes.c_longlong)]
                + [(name, ctypes.c_int) for name in ("frames", "lo", "hi", "row_offset", "full_height")])


def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    lib.bpt_trace_phase.argtypes = [ctypes.POINTER(_StagedArgs), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]
    lib.bpt_trace_phase.restype = ctypes.c_int
    lib.bpt_staged_args_size.restype = ctypes.c_int
    if lib.bpt_staged_args_size() != ctypes.sizeof(_StagedArgs):
        raise RuntimeError(f"StagedArgs is {lib.bpt_staged_args_size()} bytes in the kernel and "
                           f"{ctypes.sizeof(_StagedArgs)} in the wrapper")
    return lib


def phase_boxes(pool: Pool, lo: int, device) -> torch.Tensor:
    """An empty (warps, 6) float32 tensor for the boxes of the K2 launch of
    the phase starting at bounce ``lo``: one a warp of its grid (phase 0
    in 16x16 tiles of each frame, later phases 256 lanes a block)."""
    if lo == 0:
        blocks = -(-pool.width // 16) * -(-pool.height // 16) * pool.frames
    else:
        blocks = -(-pool.lanes // 256)
    return torch.empty((blocks * 8, 6), dtype=torch.float32, device=device)


@spanned("bpt.kernels.k2")
def launch_phase(scene, camera, cfg, pool: Pool, blue_noise: torch.Tensor, state_in, perm, lo: int, hi: int,
                 outputs: dict, boxes: torch.Tensor | None = None, fast_quads: bool | None = None):
    """One K2 launch on the current stream, with ``trace_phase_reference``'s
    arguments and result.  CUDA tensors only.  ``boxes`` (``phase_boxes``;
    not in the last phase): where the kernel also writes, for each warp,
    the min and max of the origins of the rows it wrote (a dead row counted
    as +-1e9), which ``launch_key`` reduces instead of reading the rows."""
    device = blue_noise.device
    grads = outputs["out_sg"] is not None
    lanes = pool.lanes
    if boxes is not None and (hi >= cfg.bounces or boxes.shape != phase_boxes(pool, lo, "meta").shape
                              or boxes.dtype != torch.float32 or boxes.device != device
                              or not boxes.is_contiguous()):
        raise ValueError(f"phase {lo}: boxes must be phase_boxes(pool, {lo}) on {device}, and no last phase's")
    if lo > 0 and (state_in is None or perm is None or tuple(state_in.shape) != (lanes, STATE_WORDS)
                   or state_in.dtype != torch.int32 or perm.dtype != torch.int64 or tuple(perm.shape) != (lanes,)
                   or state_in.device != device or perm.device != device
                   or not (state_in.is_contiguous() and perm.is_contiguous())):
        raise ValueError(f"phase {lo}: state_in must be a contiguous ({lanes}, {STATE_WORDS}) int32 tensor and "
                         f"perm a ({lanes},) int64 one on {device}")
    state_out = None if hi >= cfg.bounces else torch.empty((lanes, STATE_WORDS), dtype=torch.int32, device=device)
    args, mesh_arg, _keep = launch_args.trace_args(scene, camera, cfg, pool.width, pool.height, blue_noise, outputs,
                                                   film_height=pool.full_height, fast_quads=fast_quads)
    table = pool.tables.data_ptr()
    sargs = _StagedArgs(t=args, state_in=0 if lo == 0 else state_in.data_ptr(),
                        state_out=0 if state_out is None else state_out.data_ptr(),
                        boxes=0 if boxes is None else boxes.data_ptr(),
                        perm=0 if lo == 0 else perm.data_ptr(), frame_u=table, frame_f=table + 4 * pool.frames,
                        bn_off=table + 8 * pool.frames, lanes=lanes, frames=pool.frames, lo=lo, hi=hi,
                        row_offset=pool.row_offset, full_height=pool.full_height)
    name = launch_args.configuration(scene, cfg)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.bpt_trace_phase(ctypes.byref(sargs), int(grads), launch_args.ENVS[cfg.env],
                                  launch_args.NEES[cfg.nee], mesh_arg, stream)
    if err != 0:
        raise RuntimeError(f"phase_kernel ({name}{', grads' if grads else ''}, bounces [{lo}, {hi})) launch failed: "
                           f"CUDA error {err}")
    (STAGED_GRAD_LAUNCHES if grads else STAGED_LAUNCHES)[name] += 1
    return state_out


def _key_library() -> ctypes.CDLL:
    lib = build.load(KEY_KERNEL)
    lib.bpt_sort_key.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p]
    lib.bpt_sort_key.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _key_grid(device: torch.device) -> int:
    """The key kernel's fixed grid: 4 blocks of 256 threads an SM."""
    return 4 * torch.cuda.get_device_properties(device).multi_processor_count


@spanned("bpt.kernels.key")
def launch_key(state, mode: str = "oct-morton", boxes: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The key kernel (``csrc/sort_key.cu``) on the current stream:
    ``(key, lo, hi)``, ``sort_key(state, mode)`` and the box ``key_box``
    gives.  Its first pass reduces the rows, or the (n, 6) float32 ``boxes``
    (lo xyz, hi xyz each) where they are given: the boxes K2 wrote with the
    state (``launch_phase``), or one box, so that the second pass runs from
    it (``key_from_box``).  CUDA tensors only."""
    _check_mode(mode)
    device = state.device
    if (device.type != "cuda" or state.dtype != torch.int32 or state.dim() != 2 or state.shape[1] != STATE_WORDS
            or state.shape[0] == 0 or not state.is_contiguous()):
        raise ValueError(f"the key kernel takes a contiguous (lanes, {STATE_WORDS}) int32 CUDA tensor, not "
                         f"{tuple(state.shape)} {state.dtype} on {device}")
    if boxes is not None and (boxes.dim() != 2 or boxes.shape[1] != 6 or boxes.shape[0] == 0
                              or boxes.dtype != torch.float32 or boxes.device != device or not boxes.is_contiguous()):
        raise ValueError(f"boxes must be a contiguous (n, 6) float32 tensor on {device}")
    lanes = state.shape[0]
    blocks = min((lanes + 255) // 256, _key_grid(device))
    keys = torch.empty(lanes, dtype=torch.int32, device=device)
    box_out = torch.empty(6, dtype=torch.float32, device=device)
    partials = torch.empty((blocks, 6), dtype=torch.float32, device=device)
    lib = _key_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.bpt_sort_key(state.data_ptr(), lanes, KEY_MODES.index(mode),
                               0 if boxes is None else boxes.data_ptr(), 0 if boxes is None else boxes.shape[0],
                               partials.data_ptr(), blocks, keys.data_ptr(), box_out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sort key kernel ({mode}, {lanes} lanes) launch failed: CUDA error {err}")
    KEY_LAUNCHES[mode] += 1
    return keys, box_out[:3], box_out[3:]


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

@spanned("bpt.staged.pool")
def trace_staged(scene, camera, cfg, width: int, height: int, frame_counters, rand_vec2s, blue_noise: torch.Tensor,
                 splits=None, key_mode: str = "oct-morton", row_offset: int = 0, full_height: int | None = None,
                 grads: bool = False, lane_counts: list | None = None, record: list | None = None,
                 fast_quads: bool | None = None):
    """The pool of the F frames ``frame_counters`` / ``rand_vec2s`` traced in
    phases (``phase_bounds(cfg.bounces, splits)``), the lanes sorted by
    ``key_mode`` between phases: ``(RadianceResult, sg, deferred)`` with a
    leading F axis (sg and deferred None unless ``grads``), the port of
    ``_trace_staged``.  CUDA tensors launch K2 (with the warp boxes) and the
    key kernel, CPU tensors run the plain phase and ``sort_key``.  For
    measurement: ``lane_counts`` makes every phase the plain one, on either
    device, and receives the ``LaneCounts`` of every bounce of the pool
    (the key kernel then reads the rows); ``record`` receives (label, CUDA
    event) after each key, sort and phase.  ``fast_quads``: the quad test of
    every phase (``geometry.triangles.resolve_fast_quads``), decided once
    here."""
    device = blue_noise.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the staged path runs on CPU or CUDA tensors, not {device}")
    check_supported(scene, cfg)
    _check_mode(key_mode)
    fast_quads = resolve_fast_quads(scene.quads, fast_quads)
    pool = make_pool(width, height, frame_counters, rand_vec2s, device, full_height, row_offset)
    bounds = phase_bounds(cfg.bounces, splits)
    lead = (pool.frames, height, width)
    outputs = launch_args.empty_outputs(scene, cfg, lead, grads, device)
    kernel = device.type == "cuda" and lane_counts is None

    def mark(label):
        if record is not None:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            record.append((label, event))

    state = perm = boxes = None
    mark("start")
    for lo, hi in zip(bounds, bounds[1:]):
        if lo > 0:
            key = launch_key(state, key_mode, boxes)[0] if device.type == "cuda" else sort_key(state, key_mode)
            mark(f"key {lo}")
            with span("bpt.staged.sort"):
                perm = torch.sort(key, stable=True).indices
            mark(f"sort {lo}")
        if kernel:
            boxes = None if hi >= cfg.bounces else phase_boxes(pool, lo, device)
            state = launch_phase(scene, camera, cfg, pool, blue_noise, state, perm, lo, hi, outputs, boxes,
                                 fast_quads)
        else:
            state = trace_phase_reference(scene, camera, cfg, pool, blue_noise, state, perm, lo, hi, outputs,
                                          lane_counts, fast_quads)
        mark(f"phase {lo}")
    return launch_args.outputs_result(outputs, scene, cfg, lead, grads)
